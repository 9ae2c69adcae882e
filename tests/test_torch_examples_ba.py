"""The port's bundle adjustment example scripts against the JAX package's
with the same arguments on the CPU: simple_bundle_adjuster.py at its
default (16 cameras, 1,000 points, SPARSE_SCHUR), libmv_bundle_adjuster.py
on a file the test writes (the libmv bundle adjuster's model on a
5-camera BAL geometry, chip_smoke.libmv_instance and
chip_smoke.write_libmv_file), and bundle_adjuster.py at 200 points and 10
iterations under SPARSE_SCHUR, DENSE_SCHUR and ITERATIVE_SCHUR, with
--robustify and with --inner_iterations. Held as in
test_torch_examples_small.py, but bundle adjustment has gauge freedom, so
the residuals at the two solutions are held (within 1e-8 x max(1, their
largest magnitude)) where the other scripts hold the parameters."""
import pytest

import chip_smoke
from ceres_tpu_torch.models import bal as tbal
from torch_examples import assert_pair, assert_same_lines, run_pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SMALL_BA = ["--num_points", "200", "--num_iterations", "10"]
BA = [
    ("simple_bundle_adjuster", []),
    ("bundle_adjuster", SMALL_BA),
    ("bundle_adjuster", SMALL_BA + ["--linear_solver", "DENSE_SCHUR"]),
    ("bundle_adjuster", SMALL_BA + ["--robustify"]),
    ("bundle_adjuster", SMALL_BA + ["--inner_iterations"]),
]


@pytest.mark.parametrize("name,argv", BA, ids=[" ".join([n] + a) for n, a in BA])
def test_ba_example_matches_jax(monkeypatch, capsys, name, argv):
    calls_j, calls_t, out = run_pair(monkeypatch, name, argv, capsys)
    assert_pair(calls_j, calls_t, gauge=True)
    assert_same_lines(*out)


def test_iterative_schur_example_parts_at_rounding(monkeypatch, capsys):
    """bundle_adjuster.py at 200 points, 10 iterations, ITERATIVE_SCHUR
    (the CG of each step stops at eta = 1e-2, which carries rounding into
    the step). Witness: the rows agree within 2.4e-11 relative through row
    7, with the same CG counts; rows 8 and 9, steps both packages reject,
    differ by 1.1e-6 and 3.2e-7; both end in NO_CONVERGENCE after 11 rows
    at the best iterate, row 7's, 6.7e-14 apart, with residuals up to
    3.8e-8 apart. So the rows are held up to row 8, the final cost to
    1e-8, and the residuals not."""
    calls_j, calls_t, out = run_pair(
        monkeypatch, "bundle_adjuster", SMALL_BA + ["--linear_solver", "ITERATIVE_SCHUR"],
        capsys)
    assert_pair(calls_j, calls_t, gauge=True, parts=[8])
    assert [r.linear_solver_iterations for r in calls_t[0][0].iterations] == \
        [r.linear_solver_iterations for r in calls_j[0][0].iterations]
    assert_same_lines(*out)


@pytest.mark.parametrize("refine", [[], ["--refine_intrinsics", "0"]],
                         ids=["default", "constant_intrinsics"])
def test_libmv_example_matches_jax(monkeypatch, capsys, tmp_path, refine):
    b = tbal.synthetic_bal(num_cameras=5, num_points=120, visibility=1.0, seed=0)
    lp = chip_smoke.libmv_instance(b, tbal.perturb(b, 0.02, 0.2, 0.2, seed=1))
    path = tmp_path / "problem.bin"
    chip_smoke.write_libmv_file(path, lp)
    calls_j, calls_t, out = run_pair(monkeypatch, "libmv_bundle_adjuster",
                                     [str(path)] + refine, capsys)
    assert_pair(calls_j, calls_t, gauge=True)
    assert_same_lines(*out)
