"""The JAX package's answers on the paths of the host trust-region loop,
the goldens that chip_smoke.py's host-loop phase holds the port to,
solved on the CPU with the JAX host loop (TrustRegionMinimizer):

  (a) BAL-16 (cgnr16_golden.bal16) with fused_loop="NEVER": DENSE_SCHUR
      in float64 and float32, ITERATIVE_SCHUR + SCHUR_JACOBI in float64 and
      float32, CGNR + JACOBI in float64;
  (b) BAL-16 DENSE_SCHUR under an IterationCallback that returns
      SOLVER_TERMINATE_SUCCESSFULLY at iteration 5, with an
      EvaluationCallback that counts its calls and
      update_state_every_iteration; and one that returns SOLVER_ABORT at
      iteration 2;
  (c) BAL-16 with TRADITIONAL and SUBSPACE dogleg over ITERATIVE_SCHUR +
      SCHUR_JACOBI, the host minimizer built over BlockTrustRegionKernels
      (Options.is_valid refuses DOGLEG with an iterative solver in solve());
  (d) the More-Garbow-Hillstrom problems 1-19 with DENSE_QR and
      DENSE_NORMAL_CHOLESKY and the default fused_loop (AUTO takes the host
      loop): the problems missed;
  (e) the three small manifold problems of chip_smoke.py (MANIFOLD_CASES):
      a unit-vector fit on SphereManifold(3), a 3-D line fit on
      LineManifold(3), a rotation fit on QuaternionManifold; DENSE_QR,
      default fused_loop (the host loop).

    JAX_PLATFORMS=cpu python scripts/hostloop16_golden.py [a b c d e]

runs the paths named (all by default). Prints one line per solve: path,
termination, final cost, summary rows, CG iterations (with (b) the message
and the evaluation callback's calls; with (e) the answer). Takes about
three minutes on a CPU.
"""
import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import ceres_tpu as ct  # noqa: E402
from ceres_tpu.models import bal, mgh  # noqa: E402
from cgnr16_golden import bal16  # noqa: E402

DS, IS = ct.LinearSolverType.DENSE_SCHUR, ct.LinearSolverType.ITERATIVE_SCHUR
SJ = ct.PreconditionerType.SCHUR_JACOBI


def show(path, s, extra=""):
    print(path, s.termination_type.name, repr(s.final_cost), len(s.iterations),
          [r.linear_solver_iterations for r in s.iterations], extra, flush=True)


def run_a():
    for path, kw in [
            ("dense_f64", dict(linear_solver_type=DS)),
            ("dense_f32", dict(linear_solver_type=DS, evaluation_dtype="float32")),
            ("iterative_f64", dict(linear_solver_type=IS, preconditioner_type=SJ)),
            ("iterative_f32", dict(linear_solver_type=IS, preconditioner_type=SJ,
                                   evaluation_dtype="float32")),
            ("cgnr_f64", dict(linear_solver_type=ct.LinearSolverType.CGNR))]:
        s = ct.solve(ct.Options(fused_loop="NEVER", **kw), bal.build_problem_batched(bal16())[0])
        show("a " + path, s)


class Counting(ct.EvaluationCallback):
    def __init__(self):
        self.calls = 0

    def prepare_for_evaluation(self, evaluate_jacobians, new_evaluation_point):
        self.calls += 1


def run_b():
    for ret, at in (("SOLVER_TERMINATE_SUCCESSFULLY", 5), ("SOLVER_ABORT", 2)):
        ev = Counting()

        def cb(it, ret=ret, at=at):
            if it.iteration == at:
                return ct.CallbackReturnType[ret]
            return ct.CallbackReturnType.SOLVER_CONTINUE

        s = ct.solve(ct.Options(linear_solver_type=DS, callbacks=[cb], evaluation_callback=ev,
                                update_state_every_iteration=True),
                     bal.build_problem_batched(bal16())[0])
        show("b " + ret, s, f"message={s.message!r} evaluation_callback_calls={ev.calls}")


def run_c():
    from ceres_tpu.program import CompiledProgram
    from ceres_tpu.solvers.bsr_kernels import BlockTrustRegionKernels
    from ceres_tpu.solvers.trust_region import TrustRegionMinimizer
    from ceres_tpu.utils import ordering

    for dogleg in ("TRADITIONAL_DOGLEG", "SUBSPACE_DOGLEG"):
        prog = CompiledProgram(bal.build_problem_batched(bal16())[0], sort_rows=True)
        opts = ct.Options(linear_solver_type=IS, preconditioner_type=SJ,
                          trust_region_strategy_type=ct.TrustRegionStrategyType.DOGLEG,
                          dogleg_type=ct.DoglegType[dogleg])
        s = ct.Summary()
        kern = BlockTrustRegionKernels(prog, opts, "ITERATIVE_SCHUR",
                                       e_families=ordering.eligible_e_sets(prog))
        m = TrustRegionMinimizer(prog, kern, opts, s)
        m.minimize(prog.initial_state())
        s.final_cost = m.x_cost
        show("c " + dogleg, s)


def run_d():
    for lst in ("DENSE_QR", "DENSE_NORMAL_CHOLESKY"):
        misses = []
        for p in mgh.PROBLEMS:
            ok, achieved, s = mgh.solve_problem(
                p, options_overrides={"linear_solver_type": ct.LinearSolverType[lst]})
            if not ok:
                misses.append(p.number)
        print("d", lst, "misses", misses, flush=True)


# -- (e): the manifold problems, in the JAX package's terms ------------------

def sphere_case():
    """40 noisy unit vectors around (1, 2, 2) / 3; fit x on the sphere."""
    rng = np.random.default_rng(21)
    u = np.array([1.0, 2.0, 2.0]) / 3.0
    v = u + 0.1 * rng.standard_normal((40, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    x0 = np.array([1.0, 0.0, 0.2]) / np.linalg.norm([1.0, 0.0, 0.2])
    return v, x0


def line_case():
    """30 noisy points along a line in R^3; fit (origin, direction)."""
    rng = np.random.default_rng(22)
    o = np.array([1.0, -1.0, 0.5])
    d = np.array([1.0, 2.0, 3.0]) / np.linalg.norm([1.0, 2.0, 3.0])
    t = np.linspace(-2.0, 2.0, 30)
    p = o + t[:, None] * d + 0.05 * rng.standard_normal((30, 3))
    d0 = np.array([1.0, 0.5, 0.2]) / np.linalg.norm([1.0, 0.5, 0.2])
    return p, np.concatenate([np.zeros(3), d0])


def rotation_case():
    """20 vectors rotated by a unit quaternion [w, x, y, z], with noise."""
    rng = np.random.default_rng(23)
    q = np.array([0.9, 0.2, -0.3, 0.25])
    q /= np.linalg.norm(q)
    a = rng.standard_normal((20, 3))
    b = np.array([rotate_np(q, ai) for ai in a]) + 0.01 * rng.standard_normal((20, 3))
    q0 = np.array([1.0, 0.1, -0.2, 0.3]) / np.linalg.norm([1.0, 0.1, -0.2, 0.3])
    return a, b, q0


def rotate_np(q, a):
    w, v = q[0], q[1:]
    t = 2.0 * np.cross(v, a)
    return a + w * t + np.cross(v, t)


def _cross(u, v, stack):
    return stack([u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                  u[0] * v[1] - u[1] * v[0]])


def rotate(q, a, stack):
    """R(q) a for a unit quaternion q = [w, x, y, z], in any array module."""
    v = q[1:]
    t = 2.0 * _cross(v, a, stack)
    return a + q[0] * t + _cross(v, t, stack)


def line_residual(x, p, stack):
    o, d = x[:3], x[3:]
    d = d / (d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) ** 0.5
    r = p - o
    dot = r[0] * d[0] + r[1] * d[1] + r[2] * d[2]
    return r - dot * d


def run_e():
    v, x0 = sphere_case()
    x = x0.copy()
    pr = ct.Problem()
    cost = ct.AutoDiffCostFunction(lambda x, vi: x - vi, 3, [3])
    for vi in v:
        pr.add_residual_block(cost, None, [x], data=vi)
    pr.set_manifold(x, ct.SphereManifold(3))
    s = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.DENSE_QR), pr)
    show("e sphere", s, f"x={x.tolist()!r}")

    p, x0 = line_case()
    x = x0.copy()
    pr = ct.Problem()
    cost = ct.AutoDiffCostFunction(lambda x, pi: line_residual(x, pi, jnp.stack), 3, [6])
    for pi in p:
        pr.add_residual_block(cost, None, [x], data=pi)
    pr.set_manifold(x, ct.LineManifold(3))
    s = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.DENSE_QR), pr)
    show("e line", s, f"x={x.tolist()!r}")

    a, b, q0 = rotation_case()
    q = q0.copy()
    pr = ct.Problem()
    cost = ct.AutoDiffCostFunction(
        lambda q, ab: rotate(q, ab[:3], jnp.stack) - ab[3:], 3, [4])
    for ai, bi in zip(a, b):
        pr.add_residual_block(cost, None, [q], data=np.concatenate([ai, bi]))
    pr.set_manifold(q, ct.QuaternionManifold())
    s = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.DENSE_QR), pr)
    show("e quaternion", s, f"x={q.tolist()!r}")


def main():
    which = sys.argv[1:] or ["a", "b", "c", "d", "e"]
    for name in which:
        globals()["run_" + name]()


if __name__ == "__main__":
    main()
