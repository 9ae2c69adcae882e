"""Summary.full_report of the port against the JAX package's, line by
line, on the same problems solved on the CPU: Powell's function with
DENSE_QR, a small BAL problem with DENSE_SCHUR (the Schur structure's
line), ITERATIVE_SCHUR in the fused loop and SPARSE_SCHUR, and a curve
fit with LINE_SEARCH, whose report has no trust-region lines. Only the
version line, the Device line, the times and the port's line of host
syncs, just before Termination:, may differ."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _powell(pkg, xp):
    xs = [np.array([3.0]), np.array([-1.0]), np.array([0.0]), np.array([1.0])]
    p = pkg.Problem()
    for f, (i, j) in [(lambda a, b: a[0] + 10 * b[0], (0, 1)),
                      (lambda a, b: 5.0 ** 0.5 * (a[0] - b[0]), (2, 3)),
                      (lambda a, b: (a[0] - 2 * b[0]) ** 2, (1, 2)),
                      (lambda a, b: 10.0 ** 0.5 * (a[0] - b[0]) ** 2, (0, 3))]:
        p.add_residual_block(pkg.AutoDiffCostFunction(f, 1, [1, 1]), None, [xs[i], xs[j]])
    return p, dict(linear_solver_type=pkg.LinearSolverType.DENSE_QR, max_num_iterations=100)


def _curve(pkg, xp):
    rng = np.random.default_rng(0)
    xs = np.linspace(0.0, 5.0, 67)
    ys = np.exp(0.3 * xs + 0.1) + 0.2 * rng.standard_normal(67)
    mc = np.zeros(2)
    p = pkg.Problem()
    cost = pkg.AutoDiffCostFunction(lambda m, d: d[1] - xp.exp(m[0] * d[0] + m[1]), 1, [2])
    for x, y in zip(xs, ys):
        p.add_residual_block(cost, None, [mc], data=(np.float64(x), np.float64(y)))
    return p, dict(minimizer_type=pkg.MinimizerType.LINE_SEARCH, max_num_iterations=50)


def _bal(linear_solver, **kw):
    def build(pkg, xp):
        m = jbal if pkg is ct else tbal
        b = m.perturb(m.synthetic_bal(num_cameras=6, num_points=80, visibility=0.5, seed=3),
                      0.01, 0.05, 0.05, seed=4)
        return (m.build_problem_batched(b)[0],
                dict(linear_solver_type=getattr(pkg.LinearSolverType, linear_solver), **kw))
    return build


CASES = {
    "powell_dense_qr": _powell,
    "bal_dense_schur": _bal("DENSE_SCHUR"),
    "bal_iterative_schur_fused": _bal("ITERATIVE_SCHUR", fused_loop="ALWAYS"),
    "bal_sparse_schur": _bal("SPARSE_SCHUR"),
    "curve_line_search": _curve,
}

TIME_LABELS = ("  Preprocessor", "  Residual evaluation", "  Jacobian evaluation",
               "  Linear solver", "  Minimizer", "  Postprocessor", "  Total")


def _differing(line_j, line_t):
    """Whether line_t may stand where the JAX report has line_j: the
    version, the Device line and the times with their labels."""
    if line_j == "Solver Summary (v ceres_tpu)":
        return line_t == "Solver Summary (v ceres_tpu_torch)"
    if line_j.startswith("Device "):
        return line_t.startswith("Device ")
    label = next((t for t in TIME_LABELS if line_j.startswith(t)), None)
    if label is not None:
        return line_t.startswith(label)
    return False


@pytest.mark.parametrize("case", list(CASES))
def test_full_report_matches_jax(case):
    pj, oj = CASES[case](ct, jnp)
    pt, ot = CASES[case](ctt, torch)
    sj = ct.solve(ct.Options(**oj), pj)
    st = ctt.solve(ctt.Options(**ot), pt, device="cpu")
    lines_j, lines_t = sj.full_report().splitlines(), st.full_report().splitlines()
    assert lines_t[-2] == f"Host syncs                {st.num_host_syncs}"
    assert lines_t[-1].startswith("Termination:")
    del lines_t[-2]
    assert len(lines_t) == len(lines_j)
    for a, b in zip(lines_j, lines_t):
        assert a == b or _differing(a, b), (a, b)
    if case == "curve_line_search":
        assert not any(a.startswith("Trust region strategy") for a in lines_t)
    if case == "bal_dense_schur":
        assert any(a.startswith("Schur structure (given/used) 2,3,9") for a in lines_t)
    assert "Device                    cpu x1" in lines_t
