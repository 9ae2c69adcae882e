"""ceres_tpu_torch.models.nist and .denoising (and their example scripts)
against the JAX package's, on the CPU, on files the tests write: the StRD
layout (chip_smoke.write_nist_file: the five shapes of
tests/test_nist.py's fast subset, synthetic data, two starts each), an FoE
model (chip_smoke.write_foe_file) and a PGM image. The StRD files and the
reference's 2x2.foe and ceres_noisy.pgm are not in the repository.
Twins of tests/test_nist.py's parser, fast-subset and LRE tests and of
tests/test_misc_components.py's FoE-loss (:16), small-crop denoising
(:30) and PGM (:44) tests."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.models import denoising as jden
from ceres_tpu.models import nist as jnist

import ceres_tpu_torch as ctt
from ceres_tpu_torch.examples import denoising as den_example
from ceres_tpu_torch.examples import nist as nist_example
from ceres_tpu_torch.models import denoising as tden
from ceres_tpu_torch.models import nist as tnist

import chip_smoke
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def nist_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("nist")
    for name in chip_smoke.NIST_SHAPES:
        chip_smoke.write_nist_file(d / f"{name}.dat", name)
    return d


def test_parser_matches_jax(nist_dir):
    for name, (_, truth, x, starts, _) in chip_smoke.NIST_SHAPES.items():
        p = tnist.parse_nist_file(nist_dir / f"{name}.dat")
        q = jnist.parse_nist_file(nist_dir / f"{name}.dat")
        assert p.name == q.name == name
        for f in ("predictors", "response", "initial_parameters", "certified_parameters"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f))
        assert p.certified_cost == q.certified_cost
        assert p.response.shape == (len(x),)
        np.testing.assert_array_equal(p.initial_parameters, np.asarray(starts))
        np.testing.assert_array_equal(p.predictors[:, 0], x)


def test_lre_computation():
    for e, a in (([1.0], [1.0]), ([1.0], [1.1]), ([1.0], [2.0]), ([0.0], [1e-5]),
                 ([2.0, 3.0], [2.0001, 3.0])):
        assert tnist.compute_lre(np.asarray(e), np.asarray(a)) == \
            jnist.compute_lre(np.asarray(e), np.asarray(a))
    assert tnist.compute_lre(np.asarray([1.0]), np.asarray([1.0])) == 11.0
    assert tnist.compute_lre(np.asarray([1.0]), np.asarray([1.1])) == pytest.approx(1.0)


@pytest.mark.parametrize("file,model,n", [(f, m.__name__, n) for f, m, n, _ in tnist.SUITE])
def test_model_functions_match_jax(file, model, n):
    """Every model of the SUITE table (and Nelson's residual) at random b, x
    against the JAX function (1e-12)."""
    rng = np.random.default_rng(abs(hash(file)) % 1000)
    b = rng.uniform(0.5, 1.5, n)
    if model == "nelson_residual":
        x = np.concatenate([rng.uniform(1.0, 2.0, (7, 2)), rng.uniform(1.0, 3.0, (7, 1))], 1)
    else:
        x = rng.uniform(0.5, 3.0, 7)
    out = getattr(tnist, model)(torch.as_tensor(b), torch.as_tensor(x)).numpy()
    ref = np.asarray(getattr(jnist, model)(jnp.asarray(b), jnp.asarray(x)))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-300)
    assert [(f, n) for f, _, n, _ in tnist.SUITE] == [(f, n) for f, _, n, _ in jnist.SUITE]


@pytest.mark.parametrize("name", list(chip_smoke.NIST_SHAPES))
def test_fast_subset_matches_jax(nist_dir, name):
    """Each start of each of the five files succeeds (LRE > 4); the first
    start's final cost within 1e-10 of the JAX package's solve (the second's
    is held on the card against the JAX golden, NIST_GOLDEN)."""
    model = chip_smoke.NIST_SHAPES[name][0]
    n = len(chip_smoke.NIST_SHAPES[name][1])
    out = tnist.run_problem(nist_dir, f"{name}.dat", getattr(tnist, model), n, device="cpu")
    assert len(out) == 2 and all(ok for _, ok, _ in out), [lre for lre, _, _ in out]
    problem = jnist.parse_nist_file(nist_dir / f"{name}.dat")
    b = problem.initial_parameters[0].copy()
    s_j = ct.solve(jnist.default_options(), jnist.make_problem(problem, getattr(jnist, model), b))
    assert jnist.compute_lre(problem.certified_parameters, b) > 4.0
    assert abs(out[0][2].final_cost - s_j.final_cost) <= 1e-10 * s_j.final_cost
    assert str(out[0][2].termination_type) == s_j.termination_type.name


def test_nist_example_runs_the_suite_on_files(nist_dir, capsys):
    summaries = nist_example.main(["--nist_data_dir", str(nist_dir), "--problem",
                                   "DanWood.dat", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(summaries) == 2 and "Total: 2/2" in out and "easy: 2/2" in out


def test_pgm_roundtrip_matches_jax(tmp_path):
    img = np.arange(42, dtype=np.float64).reshape(6, 7)
    tden.write_pgm(tmp_path / "t.pgm", img)
    np.testing.assert_allclose(tden.read_pgm(tmp_path / "t.pgm"), img)
    np.testing.assert_array_equal(jden.read_pgm(tmp_path / "t.pgm"), img)
    (tmp_path / "p2.pgm").write_text("P2\n# a comment\n3 2\n255\n1 2 3\n4 5 6\n")
    np.testing.assert_array_equal(tden.read_pgm(tmp_path / "p2.pgm"),
                                  jden.read_pgm(tmp_path / "p2.pgm"))
    (tmp_path / "bad.pgm").write_bytes(b"P6\n")
    with pytest.raises(ValueError):
        tden.read_pgm(tmp_path / "bad.pgm")


def test_foe_file_and_loss_match_jax(tmp_path):
    """The twin of test_foe_file_and_loss on a 2x2, 3-filter file the test
    writes: the same model read, rho and its derivatives at several s the
    JAX loss's (1e-14), rho' the central difference of rho, and clamped
    at float64's smallest normal number."""
    chip_smoke.write_foe_file(tmp_path / "m.foe")
    foe = tden.read_foe_file(tmp_path / "m.foe")
    foe_j = jden.read_foe_file(tmp_path / "m.foe")
    assert foe.size == 2 and foe.num_filters == 3 and foe.num_variables == 4
    for f in ("x_delta", "y_delta", "alpha", "filters"):
        np.testing.assert_array_equal(getattr(foe, f), getattr(foe_j, f))
    loss, loss_j = tden.FoELoss(foe.alpha[0]), jden.FoELoss(foe_j.alpha[0])
    s = np.array([0.0, 0.5, 2.0, 1e3, 1e300])
    for a, b in zip(loss.evaluate(torch.as_tensor(s)), loss_j.evaluate(jnp.asarray(s))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14, atol=0)
    r0 = loss.evaluate(torch.tensor(2.0, dtype=torch.float64))[0]
    np.testing.assert_allclose(float(r0), foe.alpha[0] * np.log(2.0))
    eps = 1e-6
    fd = (float(loss.evaluate(torch.tensor(2.0 + eps, dtype=torch.float64))[0])
          - float(loss.evaluate(torch.tensor(2.0 - eps, dtype=torch.float64))[0])) / (2 * eps)
    np.testing.assert_allclose(float(loss.evaluate(torch.tensor(2.0, dtype=torch.float64))[1]),
                               fd, rtol=1e-5)


def test_denoising_small_crop_matches_jax(tmp_path):
    """The twin of test_denoising_small_crop through examples/denoising.py
    on files the test writes: a 12x12 crop of chip_smoke.noisy_image, 10
    CGNR iterations; every row's cost within 1e-10 of the JAX solve's and
    its CG iterations the same, the written image the pixels' values."""
    chip_smoke.write_foe_file(tmp_path / "m.foe")
    tden.write_pgm(tmp_path / "n.pgm", chip_smoke.noisy_image(16))
    s = den_example.main(["--input", str(tmp_path / "n.pgm"), "--foe_file",
                          str(tmp_path / "m.foe"), "--output", str(tmp_path / "out.pgm"),
                          "--crop", "12", "--num_iterations", "10", "--device", "cpu"])
    assert s.final_cost < s.initial_cost
    out = tden.read_pgm(tmp_path / "out.pgm")
    assert out.shape == (12, 12)
    foe = jden.read_foe_file(tmp_path / "m.foe")
    crop = jden.read_pgm(tmp_path / "n.pgm")[:12, :12].copy()
    p, pixels = jden.create_problem(foe, crop, sigma=20.0)
    sj = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.CGNR,
                             max_num_iterations=10), p)
    assert len(s.iterations) == len(sj.iterations)
    for r, rj in zip(s.iterations, sj.iterations):
        assert abs(r.cost - rj.cost) <= 1e-10 * sj.initial_cost
        assert r.linear_solver_iterations == rj.linear_solver_iterations
    np.testing.assert_array_equal(out, np.clip(np.round(jden.pixels_to_image(pixels)), 0, 255))


def test_denoising_problem_layout_matches_jax():
    """create_problem builds the JAX package's blocks in its order: one data
    term per pixel, then per patch one block per filter."""
    foe = tden.FieldsOfExperts(2, np.array([0, 1, 0, 1]), np.array([0, 0, 1, 1]),
                               np.array([1.0, 0.5]), np.eye(2, 4))
    img = chip_smoke.noisy_image(5)
    p, pixels = tden.create_problem(foe, img, 20.0)
    pj, _ = jden.create_problem(jden.FieldsOfExperts(foe.size, foe.x_delta, foe.y_delta,
                                                     foe.alpha, foe.filters), img, 20.0)
    assert p.num_residual_blocks() == pj.num_residual_blocks() == 25 + 2 * 16
    assert p.num_parameter_blocks() == pj.num_parameter_blocks() == 25
    cost = p.evaluate(device="cpu")
    assert abs(cost - pj.evaluate()) <= 1e-12 * abs(pj.evaluate())
    assert isinstance(p.residual_blocks()[-1].loss, tden.FoELoss)
    assert ctt.Problem is type(p)
