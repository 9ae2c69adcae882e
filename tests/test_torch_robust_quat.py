"""Robust losses and quaternion cameras through the port's jt path (the
eval_fused kernel's plain version with its loss and manifold branches)
and its flat path, against ceres_tpu on the same numpy inputs: a
6-camera, 80-point BAL instance (the sizes of tests/test_fused_lm.py:405-519)
with the angle-axis and the quaternion camera model.

- float64: the jt evaluation (cost, corrected residuals, gradient) against
  the JAX program's `_eval_core`, to 1e-12;
- float32: against the JAX package's eval_fused kernel in interpret mode,
  cost to 1e-5 and gradient to 1e-4, here for the quaternion model
  (tests/test_torch_robust_interpret.py: the angle-axis model);
- the flat path with a loss (libmv, CauchyLoss(0.5)) against `_eval_core`
  to 1e-12;
- DENSE_SCHUR float64 solves against the JAX package's fused loop: the
  final cost to 1e-10 and the same iteration count;
- the routing: what the kernel does not compute goes to the flat path."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal
from ceres_tpu.models import libmv as jlibmv
from ceres_tpu.ops import bsr as jbsr
from ceres_tpu.ops import flatops as jfo
from ceres_tpu.ops import partition as jpt
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.utils import ordering as jom

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import libmv as tlibmv
from ceres_tpu_torch.ops import bsr, partition
from ceres_tpu_torch.ops import flatops as fo
from ceres_tpu_torch.ops import kernels as kn
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers import fused_lm
from ceres_tpu_torch.utils import ordering


def loss_pair(name):
    """(JAX loss, port loss)."""
    if name == "trivial":
        return None, None
    if name == "composed":
        return (ct.ComposedLoss(ct.HuberLoss(1.1), ct.SoftLOneLoss(0.5)),
                ctt.ComposedLoss(ctt.HuberLoss(1.1), ctt.SoftLOneLoss(0.5)))
    cls, a = {"huber": ("HuberLoss", 1.0), "cauchy": ("CauchyLoss", 0.5),
              "tukey": ("TukeyLoss", 2.0)}[name]
    return getattr(ct, cls)(a), getattr(ctt, cls)(a)


def bal_instance():
    """6 cameras, 80 points (tests/test_fused_lm.py:422), rows sorted by
    point, as both packages' programs order them."""
    b = jbal.synthetic_bal(num_cameras=6, num_points=80, visibility=0.4, noise=1.0,
                           seed=0)
    return jbal.perturb(b, 0.02, 0.1, 0.1, seed=1)


def problems(model, loss_name, b=None):
    """(JAX problem, port problem) of one configuration, on copies of the
    arrays (a solve writes into them)."""
    b = bal_instance() if b is None else b
    jl, tl = loss_pair(loss_name)
    jb = jbal.BALProblem(b.cameras.copy(), b.points.copy(), b.camera_index,
                         b.point_index, b.observations)
    tb = tbal.from_arrays(b.cameras, b.points, b.camera_index, b.point_index,
                          b.observations)
    if model == "quat":
        return (jbal.build_problem_batched_quat(jb, jl)[0],
                tbal.build_problem_batched_quat(tb, tl)[0])
    return jbal.build_problem_batched(jb, loss=jl)[0], tbal.build_problem_batched(tb, tl)[0]


def port_jt_evaluation(problem, dtype):
    """(cost, residuals (N,), gradient (T,)) of the port's jt path at the
    initial state, through the plain versions of eval_fused and
    post_eval_fused."""
    prog = CompiledProgram(problem, dtype, device="cpu")
    ops = fused_lm.DenseSchurStepOps(
        prog, ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR),
        ordering.eligible_e_sets(prog))
    cost, vrep = ops.evaluate(prog.initial_state())
    g, _, _ = ops.post_eval(vrep)
    return float(cost), vrep.rt.T.reshape(-1).double().numpy(), g.double().numpy()


def jax_interpret_evaluation(problem):
    """(cost, gradient) of the JAX package's fused evaluation kernel in
    interpret mode, float32 (tests/test_fused_lm.py:488-519)."""
    prog = JaxProgram(problem, compute_dtype="float32")
    pm = jpt.build_partition(jbsr.build_meta(prog), jom.eligible_e_sets(prog))
    old = jfo.PALLAS_MODE
    jfo.PALLAS_MODE = "interpret"
    try:
        fl = jfo.FlatSchurOps(pm)
        q = fl.eval_kernel_qual(prog)
        assert q is not None
        inv = fl.eval_invariants(prog, q)
        cost, rt, jt = fl.eval_fused_x(prog, q, inv, prog.initial_state())
        g_e, _, _, g_f, _ = fl.post_eval_kernel_jt(jt, rt, inv["ids_T"],
                                                   masks=inv["masks"])
        g = jpt.combine(pm, jnp.asarray(g_e), jnp.asarray(g_f))
    finally:
        jfo.PALLAS_MODE = old
    return float(cost), np.asarray(g, np.float64)


def rel_err(out, ref):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / np.abs(ref).max()


def check_interpret(model, loss_name):
    jp, tp = problems(model, loss_name)
    cost_ref, g_ref = jax_interpret_evaluation(jp)
    cost, _, g = port_jt_evaluation(tp, "float32")
    assert cost == pytest.approx(cost_ref, rel=1e-5)
    assert rel_err(g, g_ref) <= 1e-4


LOSSES = ["huber", "cauchy", "tukey", "composed"]


@pytest.mark.parametrize("loss_name", LOSSES)
def test_quat_jt_evaluation_f32_matches_interpret_kernel(loss_name):
    check_interpret("quat", loss_name)


@pytest.mark.parametrize("model", ["angle_axis", "quat"])
@pytest.mark.parametrize("loss_name", ["trivial"] + LOSSES)
def test_jt_evaluation_f64_matches_eval_core(model, loss_name):
    """Cost, corrected residuals and gradient of the jt path against the
    JAX `_eval_core` (J_ambient PlusJacobian, then the corrector), to 1e-12
    relative; each path clamps as its own reference does (the kernel's
    rho' >= 1e-30 leaves Tukey's outliers at ~1e-15 of their raw values)."""
    jp, tp = problems(model, loss_name)
    jprog = JaxProgram(jp)
    cost_ref, r_ref, g_ref = (np.asarray(a) for a in jprog.evaluate_grad(
        jprog.initial_state()))
    cost, r, g = port_jt_evaluation(tp, "float64")
    assert cost == pytest.approx(float(cost_ref), rel=1e-12)
    assert rel_err(r, r_ref) <= 1e-12
    assert rel_err(g, g_ref) <= 1e-12


def libmv_with_loss(P, loss):
    """The libmv model (5 cameras, 120 points) with a loss on its markers:
    two camera-side families, so the flat path."""
    import chip_smoke

    b = tbal.synthetic_bal(num_cameras=5, num_points=120, visibility=1.0, seed=0)
    lp = chip_smoke.libmv_instance(b, tbal.perturb(b, 0.02, 0.2, 0.2, seed=1))
    p = P.Problem()
    cams = p.add_parameter_block_array(lp.cameras.copy())
    pts = p.add_parameter_block_array(lp.points.copy())
    intr = p.add_parameter_block_array(lp.intrinsics.reshape(1, 8).copy())
    cost = (tlibmv.LIBMV_COST if P is ctt else
            ct.AutoDiffCostFunction(jlibmv.libmv_reprojection_residual, 2, [6, 3, 8]))
    p.add_residual_block_batch(
        cost, loss, [(cams, lp.marker_cam), (pts, lp.marker_pt),
                     (intr, np.zeros(len(lp.marker_cam), np.int64))],
        data=lp.markers)
    return p


def test_flat_path_with_a_loss_matches_eval_core():
    """libmv with CauchyLoss(0.5): the port's `_eval_core` (cost,
    residuals, block Jacobians) and the flat path's gradient against the
    JAX `_eval_core`, 1e-12 relative."""
    jprog = JaxProgram(libmv_with_loss(ct, ct.CauchyLoss(0.5)))
    o_ref = jprog._eval_core(jprog.initial_state(), True, False)
    prog = CompiledProgram(libmv_with_loss(ctt, ctt.CauchyLoss(0.5)), "float64",
                           device="cpu")
    o = prog._eval_core(prog.initial_state())
    assert float(o["cost"]) == pytest.approx(float(o_ref["cost"]), rel=1e-12)
    assert rel_err(o["residuals"], o_ref["residuals"]) <= 1e-12
    for J, J_ref in zip(o["block_jacs"][0], o_ref["block_jacs"][0]):
        assert rel_err(J, J_ref) <= 1e-12
    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR)
    minimizer = fused_lm.build_fused_minimizer(prog, opts, "schur_dense",
                                               ordering.eligible_e_sets(prog))
    assert isinstance(minimizer.ops, fused_lm.FlatDenseSchurStepOps)
    _, vrep = minimizer.ops.evaluate(prog.initial_state())
    g, _, _ = minimizer.ops.post_eval(vrep)
    assert rel_err(g, o_ref["gradient"]) <= 1e-12


def solve_pair(model, loss_name, dtype="float64"):
    jp, tp = problems(model, loss_name)
    ref = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.DENSE_SCHUR,
                              fused_loop="ALWAYS"), jp)
    kn.reset_counts()
    out = ctt.solve(ctt.Options(fused_loop="ALWAYS",
                                linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                                evaluation_dtype=dtype), tp, device="cpu")
    counts = {k.__name__: k.plain_calls for k in kn.KERNELS}
    return ref, out, counts


@pytest.mark.parametrize("model,loss_name,variant", [
    ("angle_axis", "huber", "eval_fused_loss"),
    ("quat", "trivial", "eval_fused_quat"),
    ("quat", "cauchy", "eval_fused_quat")])
def test_dense_schur_solve_matches_jax(model, loss_name, variant):
    """The final cost to 1e-10 relative and the same rows and termination;
    the evaluation ran as its variant, once per row."""
    ref, out, counts = solve_pair(model, loss_name)
    assert out.termination_type.name == ref.termination_type.name == "CONVERGENCE"
    assert len(out.iterations) == len(ref.iterations)
    assert out.final_cost == pytest.approx(ref.final_cost, rel=1e-10)
    assert counts[variant] == len(out.iterations)
    assert all(n == 0 for k, n in counts.items()
               if k.startswith("eval_fused") and k != variant)


def test_quaternion_solve_keeps_unit_quaternions_and_writes_back():
    b = bal_instance()
    tb = tbal.from_arrays(b.cameras, b.points, b.camera_index, b.point_index,
                          b.observations)
    p, cams, pts = tbal.build_problem_batched_quat(tb, ctt.HuberLoss(1.0))
    start = cams.copy()
    s = ctt.solve(ctt.Options(fused_loop="ALWAYS",
                              linear_solver_type=ctt.LinearSolverType.ITERATIVE_SCHUR),
                  p, device="cpu")
    assert s.termination_type.name == "CONVERGENCE"
    assert s.num_effective_parameters_reduced == 9 * 6 + 3 * b.num_points
    assert s.num_parameters_reduced == 10 * 6 + 3 * b.num_points
    assert not np.array_equal(cams, start)
    np.testing.assert_allclose(np.linalg.norm(cams[:, :4], axis=1), 1.0, atol=1e-12)
    # the written-back state evaluates, in ceres_tpu, to the final cost
    sol = jbal.BALProblem(b.cameras, pts, b.camera_index, b.point_index, b.observations)
    jp, jcams, _ = jbal.build_problem_batched_quat(sol, ct.HuberLoss(1.0))
    jcams[...] = cams
    assert jp.evaluate() == pytest.approx(s.final_cost, rel=1e-10)


def test_float32_robust_solve_reaches_the_float64_cost():
    """float32 through the same variant: within 5e-3 of the float64 final
    cost, the JAX package's own float32 trajectory bound for Huber
    (tests/test_fused_lm.py:462-464)."""
    _, out64, _ = solve_pair("angle_axis", "huber")
    _, tp = problems("angle_axis", "huber")
    out32 = ctt.solve(ctt.Options(fused_loop="ALWAYS",
                                  linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                                  evaluation_dtype="float32"), tp, device="cpu")
    assert out32.is_solution_usable()
    assert out32.final_cost == pytest.approx(out64.final_cost, rel=5e-3)


# -- the routing ---------------------------------------------------------------


def _refusal(problem):
    prog = CompiledProgram(problem, "float64", device="cpu")
    pm = partition.build_partition(bsr.build_meta(prog), ordering.eligible_e_sets(prog))
    return fo.jt_refusal(pm, prog)


def _copied_snavely_cost():
    """The Snavely cost with residual_rows another function: the same
    residual, which the kernel does not recognise."""
    cost = ctt.AutoDiffCostFunction(tbal.snavely_reprojection_residual, 2, [9, 3])
    cost.residual_rows = lambda cam, pt, obs: tbal.snavely_residual_rows(cam, pt, obs)
    return cost


def _custom_problem(cost=None, loss=None, cam_manifold=None, quat=False):
    b = bal_instance()
    cams = tbal.cameras_to_quaternion(b.cameras) if quat else b.cameras.copy()
    p = ctt.Problem()
    ca = p.add_parameter_block_array(cams, manifold=cam_manifold)
    pa = p.add_parameter_block_array(b.points.copy())
    cost = cost or (tbal.SNAVELY_QUAT_COST if quat else tbal.SNAVELY_COST)
    p.add_residual_block_batch(cost, loss, [(ca, b.camera_index), (pa, b.point_index)],
                               data=b.observations)
    return p


class _MyLoss(ctt.LossFunction):
    """A user's own loss: Cauchy(1) written out."""

    def evaluate(self, s):
        return torch.log1p(s), 1.0 / (1.0 + s), -1.0 / (1.0 + s) ** 2


@pytest.mark.parametrize("case,reason", [
    ("copied_residual_rows", "a cost without the residual_rows of a kernel model"),
    ("user_loss", "a loss the kernel's loss chain does not take"),
    ("eigen_quaternion", "quaternion cameras not of 10 under the quaternion camera "
                         "manifold"),
    ("subset_cameras", "residual/camera/point sizes (2, 8, 3)"),
    ("euclidean_manifold", None),
    ("quat", None),
    ("composed_loss", None)])
def test_jt_refusal_admits_what_the_kernel_computes(case, reason):
    problem = {
        "copied_residual_rows": lambda: _custom_problem(cost=_copied_snavely_cost()),
        "user_loss": lambda: _custom_problem(loss=_MyLoss()),
        "eigen_quaternion": lambda: _custom_problem(quat=True, cam_manifold=ctt.ProductManifold(
            ctt.EigenQuaternionManifold(), ctt.EuclideanManifold(6))),
        "subset_cameras": lambda: _custom_problem(
            cam_manifold=ctt.SubsetManifold(9, [8])),
        "euclidean_manifold": lambda: _custom_problem(
            cam_manifold=ctt.EuclideanManifold(9)),
        "quat": lambda: _custom_problem(quat=True, cam_manifold=tbal.quaternion_camera_manifold()),
        "composed_loss": lambda: _custom_problem(loss=ctt.LossFunctionWrapper(
            ctt.ScaledLoss(ctt.ComposedLoss(ctt.CauchyLoss(1.0), ctt.HuberLoss(2.0)), 0.5))),
    }[case]()
    assert _refusal(problem) == reason


@pytest.mark.parametrize("case", ["copied_residual_rows", "user_loss"])
def test_refused_programs_take_the_flat_path_and_solve(case):
    """A copy of the Snavely cost with another residual_rows, or a user's
    own loss (Cauchy's, written out), is solved on the flat path (no
    eval_fused at all), row for row as the same problem on the jt path:
    each row's cost to 1e-9. The robust problem converges slowly, so its
    solves stop after 10 iterations."""
    cost, loss = ((_copied_snavely_cost(), None) if case == "copied_residual_rows"
                  else (None, _MyLoss()))
    opts = ctt.Options(fused_loop="ALWAYS", linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR,
                       max_num_iterations=10)
    kn.reset_counts()
    flat = ctt.solve(opts, _custom_problem(cost=cost, loss=loss), device="cpu")
    counts = {k.__name__: k.plain_calls for k in kn.KERNELS}
    assert all(n == 0 for k, n in counts.items() if k.startswith("eval_fused"))
    assert counts["segment_block_sum"] > 0
    assert flat.is_solution_usable()
    assert flat.final_cost < flat.initial_cost
    jt = ctt.solve(opts, _custom_problem(loss=None if loss is None else ctt.CauchyLoss(1.0)),
                   device="cpu")
    assert len(flat.iterations) == len(jt.iterations)
    for a, c in zip(jt.iterations, flat.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-9)
