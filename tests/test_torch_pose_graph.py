"""The port's pose-graph models (ceres_tpu_torch/models/pose_graph.py), the
twin of tests/test_pose_graph.py (all but its inner-iterations case, which
waits for the port's coordinate descent): the 2D and 3D graphs converge
and close their loops, the angle manifold wraps, the g2o readers round
trip on text the test writes. Against the JAX package on the CPU: the
residuals (1e-13), the synthetic graphs (1e-14), and SPARSE_NORMAL_CHOLESKY
solves in both host loops, the same rows with each cost within 1e-10
relative, and against the port's own DENSE_QR solve (1e-10)."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.models import pose_graph as jpg

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import pose_graph as pg
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SNC = ctt.LinearSolverType.SPARSE_NORMAL_CHOLESKY


def test_2d_slam_converges_and_closes_loops():
    poses, cons, gt = pg.synthetic_2d(num_poses=60, loop_closures=10, noise=0.02, seed=1)
    err0 = np.mean([np.hypot(poses[i].x - gt[i].x, poses[i].y - gt[i].y) for i in range(60)])
    p, arrays = pg.build_problem_2d(poses, cons)
    s = ctt.solve(ctt.Options(linear_solver_type=SNC, max_num_iterations=100), p, device="cpu")
    assert s.termination_type == ctt.TerminationType.CONVERGENCE
    assert s.linear_solver_type_used == SNC
    err1 = np.mean([np.hypot(arrays[i][0][0] - gt[i].x, arrays[i][1][0] - gt[i].y)
                    for i in range(60)])
    assert err1 < err0 / 5  # the loop closures pulled the drift back
    assert arrays[0][0][0] == pytest.approx(gt[0].x)  # the first pose is fixed


def test_2d_angle_manifold_wraps():
    m = pg.angle_manifold()
    y = m.plus(torch.tensor([3.0], dtype=torch.float64), torch.tensor([0.5], dtype=torch.float64))
    assert -np.pi <= float(y[0]) < np.pi
    assert float(y[0]) == pytest.approx(3.5 - 2 * np.pi)


def test_3d_slam_converges_unit_quaternions():
    poses, cons, gt = pg.synthetic_3d(num_poses=40, loop_closures=8, noise=0.01, seed=1)
    p, arrays = pg.build_problem_3d(poses, cons, loss=ctt.HuberLoss(1.0))
    s = ctt.solve(ctt.Options(linear_solver_type=SNC, max_num_iterations=100), p, device="cpu")
    assert s.termination_type == ctt.TerminationType.CONVERGENCE
    assert s.final_cost < s.initial_cost / 5
    for i in range(40):
        assert np.linalg.norm(arrays[i][1]) == pytest.approx(1.0, abs=1e-9)


def test_g2o_2d_roundtrip(tmp_path):
    path = tmp_path / "test.g2o"
    path.write_text("VERTEX_SE2 0 0.0 0.0 0.0\n"
                    "VERTEX_SE2 1 1.0 0.1 0.05\n"
                    "EDGE_SE2 0 1 1.0 0.0 0.0 100 0 0 100 0 400\n")
    poses, cons = pg.read_g2o_2d(path)
    jposes, jcons = jpg.read_g2o_2d(path)
    assert len(poses) == 2 and len(cons) == 1
    assert cons[0].information[0, 0] == 100 and cons[0].information[2, 2] == 400
    np.testing.assert_array_equal(cons[0].information, jcons[0].information)
    assert poses == {k: pg.Pose2(v.x, v.y, v.yaw) for k, v in jposes.items()}
    p, _ = pg.build_problem_2d(poses, cons)
    s = ctt.solve(ctt.Options(max_num_iterations=20), p, device="cpu")
    assert s.final_cost < 1e-12  # one edge, fully satisfiable


def test_g2o_3d_roundtrip(tmp_path):
    path = tmp_path / "t3.g2o"
    info = np.diag([100.0] * 3 + [400.0] * 3)
    info[0, 4] = info[4, 0] = 3.0
    info21 = " ".join(str(v) for v in info[np.triu_indices(6)])
    path.write_text("VERTEX_SE3:QUAT 0 0 0 0 0 0 0 1\n"
                    "VERTEX_SE3:QUAT 1 1 0 0 0 0 0 1\n"
                    f"EDGE_SE3:QUAT 0 1 1 0 0 0 0 0 1 {info21}\n")
    poses, cons = pg.read_g2o_3d(path)
    jposes, jcons = jpg.read_g2o_3d(path)
    assert len(poses) == 2 and len(cons) == 1
    np.testing.assert_array_equal(cons[0].information, info)
    np.testing.assert_array_equal(cons[0].information, jcons[0].information)
    for k in poses:
        np.testing.assert_array_equal(poses[k][0], jposes[k][0])
        np.testing.assert_array_equal(poses[k][1], jposes[k][1])
    p, _ = pg.build_problem_3d(poses, cons)
    s = ctt.solve(ctt.Options(max_num_iterations=20), p, device="cpu")
    assert s.final_cost < 1e-12


def test_residuals_match_jax():
    """Each residual against the JAX function on random poses and edges,
    1e-13 relative."""
    rng = np.random.default_rng(0)
    for _ in range(5):
        xs = rng.uniform(-3, 3, 6)
        data = (rng.standard_normal(2), np.float64(rng.uniform(-3, 3)),
                np.linalg.cholesky(np.diag(rng.uniform(1, 100, 3))).T)
        ref = np.asarray(jpg.pose_graph_2d_residual(*[jnp.asarray(xs[i:i + 1]) for i in range(6)],
                                                    tuple(jnp.asarray(d) for d in data)))
        out = pg.pose_graph_2d_residual(*[torch.as_tensor(xs[i:i + 1]) for i in range(6)],
                                        tuple(torch.as_tensor(d) for d in data)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-13, atol=1e-13 * np.abs(ref).max())
        q = [v / np.linalg.norm(v) for v in rng.standard_normal((3, 4))]
        pa, pb = rng.standard_normal(3), rng.standard_normal(3)
        info = rng.standard_normal((6, 6))
        data3 = (rng.standard_normal(3), q[2], np.linalg.cholesky(info @ info.T + np.eye(6)).T)
        ref = np.asarray(jpg.pose_graph_3d_residual(
            *[jnp.asarray(a) for a in (pa, q[0], pb, q[1])], tuple(jnp.asarray(d) for d in data3)))
        out = pg.pose_graph_3d_residual(*[torch.as_tensor(a) for a in (pa, q[0], pb, q[1])],
                                        tuple(torch.as_tensor(d) for d in data3)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-13, atol=1e-13 * np.abs(ref).max())


def test_synthetic_graphs_match_jax():
    """The same poses, edges and ground truth from the same seed (1e-14)."""
    p2, c2, g2 = pg.synthetic_2d(num_poses=30, loop_closures=6, noise=0.02, seed=3)
    jp2, jc2, jg2 = jpg.synthetic_2d(num_poses=30, loop_closures=6, noise=0.02, seed=3)
    assert len(c2) == len(jc2)
    for a, b in zip(list(p2.values()) + g2, list(jp2.values()) + jg2):
        assert np.allclose([a.x, a.y, a.yaw], [b.x, b.y, b.yaw], rtol=0, atol=1e-14)
    for a, b in zip(c2, jc2):
        assert (a.id_begin, a.id_end) == (b.id_begin, b.id_end)
        assert np.allclose([a.x, a.y, a.yaw], [b.x, b.y, b.yaw], rtol=0, atol=1e-14)
    p3, c3, g3 = pg.synthetic_3d(num_poses=20, loop_closures=5, noise=0.01, seed=3)
    jp3, jc3, jg3 = jpg.synthetic_3d(num_poses=20, loop_closures=5, noise=0.01, seed=3)
    assert len(c3) == len(jc3)
    for a, b in zip(list(p3.values()) + g3, list(jp3.values()) + jg3):
        assert np.abs(a[0] - b[0]).max() <= 1e-14 * 10 and np.abs(a[1] - b[1]).max() <= 1e-14
    for a, b in zip(c3, jc3):
        assert (a.id_begin, a.id_end) == (b.id_begin, b.id_end)
        assert np.abs(a.t - b.t).max() <= 1e-14 and np.abs(a.q - b.q).max() <= 1e-14


@pytest.mark.parametrize("dim", [2, 3])
def test_sparse_normal_cholesky_matches_jax_and_dense_qr(dim):
    """SPARSE_NORMAL_CHOLESKY on the JAX package's synthetic graph (3D with
    HuberLoss(1.0)) in both packages' host loops: the same rows, each cost
    within 1e-10 relative, the same answer (1e-8); and the port's DENSE_QR
    solve within 1e-10 of the same final cost."""
    if dim == 2:
        poses, cons, _ = jpg.synthetic_2d(num_poses=50, loop_closures=8, noise=0.02, seed=7)

        def build(mod, loss):
            return mod.build_problem_2d(copy.deepcopy(poses), cons)
    else:
        poses, cons, _ = jpg.synthetic_3d(num_poses=30, loop_closures=6, noise=0.01, seed=7)

        def build(mod, loss):
            return mod.build_problem_3d(copy.deepcopy(poses), cons, loss=loss)

    jp, jarr = build(jpg, ct.HuberLoss(1.0))
    ref = ct.solve(ct.Options(linear_solver_type=ct.LinearSolverType.SPARSE_NORMAL_CHOLESKY,
                              max_num_iterations=100), jp)
    tp, tarr = build(pg, ctt.HuberLoss(1.0))
    s = ctt.solve(ctt.Options(linear_solver_type=SNC, max_num_iterations=100), tp, device="cpu")
    assert s.termination_type.name == ref.termination_type.name == "CONVERGENCE"
    assert len(s.iterations) == len(ref.iterations)
    for a, c in zip(ref.iterations, s.iterations):
        assert c.cost == pytest.approx(a.cost, rel=1e-10, abs=1e-30)
    for k in jarr:
        for a, c in zip(jarr[k], tarr[k]):
            np.testing.assert_allclose(c, a, rtol=1e-8, atol=1e-8)
    qr = ctt.solve(ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_QR,
                               max_num_iterations=100), build(pg, ctt.HuberLoss(1.0))[0],
                   device="cpu")
    assert qr.final_cost == pytest.approx(s.final_cost, rel=1e-10)
