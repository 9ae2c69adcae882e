"""ceres_tpu_torch.covariance against ceres_tpu.covariance on the same
numpy inputs, on the CPU: the twins of tests/test_satellite_apis.py's
covariance tests (:30-150, :287, :352, and under `slow` :319 and :387),
the same bool from compute() and blocks within 1e-9 relative (max |diff|
over max |C|), with a 100-pose graph and a 32-camera bundle adjustment
(its camera core taken by the Schur tail at schur_tail_min_cols lowered)
at reduced sizes. The JAX package's Schur tail compiles its dense-Schur
step once (~20 s of XLA on a CPU): tier-1 holds the port's tail to the
JAX QR, which agrees with the JAX tail to ~1e-14 on these well
conditioned problems; the slow twin holds it to the JAX tail itself. Also
the QR library's keyed build and the port's own copy of its source."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal
from ceres_tpu.models import pose_graph as jpg

import ceres_tpu_torch as ctt
from ceres_tpu_torch import native
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import pose_graph as tpg
from ceres_tpu_torch.ops import kernels as kn

from torch_threads import one_torch_thread  # noqa: F401

REL = 1e-9
ALG = {"DENSE_SVD": (ct.CovarianceAlgorithmType.DENSE_SVD,
                     ctt.CovarianceAlgorithmType.DENSE_SVD),
       "SPARSE_QR": (ct.CovarianceAlgorithmType.SPARSE_QR,
                     ctt.CovarianceAlgorithmType.SPARSE_QR)}


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


def both(problems, blocks, alg="SPARSE_QR", **kw):
    """(port Covariance, ok), (JAX Covariance, ok) on twin problems."""
    pt, pj = problems
    bt, bj = blocks
    t = ctt.Covariance(ctt.CovarianceOptions(algorithm_type=ALG[alg][1], **kw))
    j = ct.Covariance(ct.CovarianceOptions(algorithm_type=ALG[alg][0], **kw))
    return (t, t.compute(bt, pt, device="cpu")), (j, j.compute(bj, pj))


def linear_problems(A, b):
    At, bt, Aj, bj = torch.as_tensor(A), torch.as_tensor(b), jnp.asarray(A), jnp.asarray(b)
    xt, xj = np.zeros(A.shape[1]), np.zeros(A.shape[1])
    pt, pj = ctt.Problem(), ct.Problem()
    pt.add_residual_block(ctt.AutoDiffCostFunction(lambda v: At @ v - bt, len(b),
                                                   [A.shape[1]]), None, [xt])
    pj.add_residual_block(ct.AutoDiffCostFunction(lambda v: Aj @ v - bj, len(b),
                                                  [A.shape[1]]), None, [xj])
    return (pt, pj), (xt, xj)


@pytest.mark.parametrize("alg", ["DENSE_SVD", "SPARSE_QR"])
def test_covariance_linear(alg):
    """r = A x - b: (A'A)^{-1}, the JAX answer (the JAX test solves first;
    the covariance of a linear problem does not depend on x)."""
    rng = np.random.default_rng(0)
    A, b = rng.standard_normal((10, 3)), rng.standard_normal(10)
    (pt, pj), (xt, xj) = linear_problems(A, b)
    (t, ok), (j, okj) = both((pt, pj), ([(xt, xt)], [(xj, xj)]), alg)
    assert ok and okj
    C = t.get_covariance_block(xt, xt)
    np.testing.assert_allclose(C, np.linalg.inv(A.T @ A), rtol=1e-8)
    assert rel(C, j.get_covariance_block(xj, xj)) <= REL
    np.testing.assert_array_equal(t.get_covariance_matrix([xt]), C)


def test_covariance_rank_deficient():
    """Two identical columns: SPARSE_QR (and the normal equations) return
    False, DENSE_SVD with null_space_rank=1 the pseudo-inverse, as in the
    JAX package."""
    xt, xj = np.zeros(2), np.zeros(2)
    pt, pj = ctt.Problem(), ct.Problem()
    pt.add_residual_block(ctt.AutoDiffCostFunction(lambda v: (v[0] + v[1])[None], 1, [2]),
                          None, [xt])
    pj.add_residual_block(ct.AutoDiffCostFunction(lambda v: jnp.asarray([v[0] + v[1]]), 1,
                                                  [2]), None, [xj])
    for kw in ({}, {"use_normal_equations": True}):
        (_, ok), (_, okj) = both((pt, pj), ([(xt, xt)], [(xj, xj)]), **kw)
        assert ok is okj is False
    (t, ok), (j, okj) = both((pt, pj), ([(xt, xt)], [(xj, xj)]), "DENSE_SVD",
                             null_space_rank=1)
    assert ok and okj
    C = t.get_covariance_block(xt, xt)
    assert np.all(np.isfinite(C))
    np.testing.assert_allclose(C, j.get_covariance_block(xj, xj), rtol=0, atol=1e-15)


def test_covariance_ill_conditioned_qr_vs_normal_equations():
    """cond(J) ~ 1e8: the QR matches (A'A)^{-1} to 1e-6 and the JAX QR to
    1e-9; the normal equations return the JAX package's bool and, where
    they succeed, lose the answer as the JAX ones do."""
    rng = np.random.default_rng(3)
    Q1, _ = np.linalg.qr(rng.standard_normal((12, 3)))
    Q2, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    s = np.asarray([1.0, 1e-4, 1e-8])
    A = Q1 @ np.diag(s) @ Q2
    (pt, pj), (xt, xj) = linear_problems(A, np.zeros(12))
    ref = Q2.T @ np.diag(1.0 / (s * s)) @ Q2
    (t, ok), (j, okj) = both((pt, pj), ([(xt, xt)], [(xj, xj)]),
                             min_reciprocal_condition_number=1e-18)
    assert ok and okj
    C = t.get_covariance_block(xt, xt)
    np.testing.assert_allclose(C, ref, rtol=1e-6)
    assert rel(C, j.get_covariance_block(xj, xj)) <= REL
    (t, ok), (j, okj) = both((pt, pj), ([(xt, xt)], [(xj, xj)]),
                             min_reciprocal_condition_number=1e-18, use_normal_equations=True)
    assert ok == okj
    if ok:
        assert rel(t.get_covariance_block(xt, xt), ref) > 1e-4


def test_covariance_qr_multi_block_matches_svd_and_jax():
    """Three blocks, one constant: SPARSE_QR against the JAX package's and
    against DENSE_SVD (1e-8, as the JAX test), on every requested pair and
    its transpose."""
    rng = np.random.default_rng(5)
    x0 = [rng.standard_normal(2), rng.standard_normal(3), rng.standard_normal(2)]
    A1, A2, A3 = (rng.standard_normal((4, 5)), rng.standard_normal((5, 5)),
                  rng.standard_normal((3, 2)))
    pt, pj = ctt.Problem(), ct.Problem()
    xt, xj = [x.copy() for x in x0], [x.copy() for x in x0]
    T1, T2, T3 = (torch.as_tensor(A) for A in (A1, A2, A3))
    pt.add_residual_block(ctt.AutoDiffCostFunction(
        lambda a, b: T1 @ torch.cat([a, b]) - 1.0, 4, [2, 3]), None, [xt[0], xt[1]])
    pt.add_residual_block(ctt.AutoDiffCostFunction(
        lambda b, c: T2 @ torch.cat([b, c]), 5, [3, 2]), None, [xt[1], xt[2]])
    pt.add_residual_block(ctt.AutoDiffCostFunction(lambda c: T3 @ c - 0.5, 3, [2]), None,
                          [xt[2]])
    pj.add_residual_block(ct.AutoDiffCostFunction(
        lambda a, b: jnp.asarray(A1) @ jnp.concatenate([a, b]) - 1.0, 4, [2, 3]), None,
        [xj[0], xj[1]])
    pj.add_residual_block(ct.AutoDiffCostFunction(
        lambda b, c: jnp.asarray(A2) @ jnp.concatenate([b, c]), 5, [3, 2]), None,
        [xj[1], xj[2]])
    pj.add_residual_block(ct.AutoDiffCostFunction(lambda c: jnp.asarray(A3) @ c - 0.5, 3,
                                                  [2]), None, [xj[2]])
    pt.set_parameter_block_constant(xt[0])
    pj.set_parameter_block_constant(xj[0])
    pairs_t = [(xt[1], xt[1]), (xt[1], xt[2]), (xt[2], xt[2])]
    pairs_j = [(xj[1], xj[1]), (xj[1], xj[2]), (xj[2], xj[2])]
    (qr, ok1), (qr_j, ok2) = both((pt, pj), (pairs_t, pairs_j))
    svd = ctt.Covariance(ctt.CovarianceOptions(algorithm_type=ALG["DENSE_SVD"][1]))
    assert ok1 and ok2 and svd.compute(pairs_t, pt, device="cpu")
    for (a, b), (aj, bj) in zip(pairs_t + [(xt[2], xt[1])], pairs_j + [(xj[2], xj[1])]):
        C = qr.get_covariance_block(a, b)
        np.testing.assert_allclose(C, svd.get_covariance_block(a, b), rtol=1e-8, atol=1e-12)
        assert rel(C, qr_j.get_covariance_block(aj, bj)) <= REL
    with pytest.raises(KeyError):
        qr.get_covariance_block(xt[0], xt[1])  # a constant block


def test_covariance_tangent_space_quaternion():
    """A QuaternionManifold block: the (3, 3) tangent covariance and its
    (4, 4) ambient lift by the PlusJacobian, as the JAX package's."""
    qt, qj = np.asarray([1.0, 0.0, 0.0, 0.0]), np.asarray([1.0, 0.0, 0.0, 0.0])
    pt, pj = ctt.Problem(), ct.Problem()
    pt.add_parameter_block(qt, manifold=ctt.QuaternionManifold())
    pj.add_parameter_block(qj, manifold=ct.QuaternionManifold())
    e = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float64)
    pt.add_residual_block(ctt.AutoDiffCostFunction(lambda v: 2.0 * v - e, 4, [4]), None, [qt])
    pj.add_residual_block(ct.AutoDiffCostFunction(
        lambda v: 2.0 * v - jnp.asarray([1.0, 0, 0, 0]), 4, [4]), None, [qj])
    (t, ok), (j, okj) = both((pt, pj), ([(qt, qt)], [(qj, qj)]))
    assert ok and okj
    Ct = t.get_covariance_block(qt, qt, lift_to_ambient=False)
    Ca = t.get_covariance_block(qt, qt, lift_to_ambient=True)
    assert Ct.shape == (3, 3) and Ca.shape == (4, 4)
    assert rel(Ct, j.get_covariance_block(qj, qj, lift_to_ambient=False)) <= REL
    assert rel(Ca, j.get_covariance_block(qj, qj)) <= REL
    assert rel(t.get_covariance_matrix([qt], lift_to_ambient=True),
               j.get_covariance_matrix([qj], lift_to_ambient=True)) <= REL


def ba_problems(b_t, b_j):
    """BAL problems built one block at a time, camera 0 and point 0 held
    constant (the 7-dof gauge)."""
    pt, ct_, ptt = tbal.build_problem(b_t)
    pj, cj, ptj = jbal.build_problem(b_j)
    for p, c, q in ((pt, ct_, ptt), (pj, cj, ptj)):
        p.set_parameter_block_constant(c[0])
        p.set_parameter_block_constant(q[0])
    return (pt, pj), (ct_, cj), (ptt, ptj)


def test_covariance_selected_blocks_match_jax():
    """The requested block columns only, on a gauge-fixed BA: the port's
    SPARSE_QR, its normal equations and its Schur tail (schur_tail_min_cols
    lowered to the 27 camera columns) against the JAX QR; DENSE_SVD
    against the QR to 1e-6, as the JAX test holds it; an unrequested pair
    raises."""
    kw = dict(num_cameras=4, num_points=30, visibility=1.0, noise=0.1, seed=21)
    (pt, pj), (ct_, cj), (ptt, ptj) = ba_problems(tbal.synthetic_bal(**kw),
                                                 jbal.synthetic_bal(**kw))
    sel_t = [(ct_[2], ct_[2]), (ct_[3], ct_[2]), (ptt[3], ptt[3])]
    sel_j = [(cj[2], cj[2]), (cj[3], cj[2]), (ptj[3], ptj[3])]
    j = ct.Covariance(ct.CovarianceOptions())
    assert j.compute(sel_j, pj)
    out = {}
    for name, alg, kw in (("qr", "SPARSE_QR", {}),
                          ("normal_equations", "SPARSE_QR", {"use_normal_equations": True}),
                          ("schur_tail", "SPARSE_QR", {"schur_tail_min_cols": 27}),
                          ("dense_svd", "DENSE_SVD", {})):
        t = ctt.Covariance(ctt.CovarianceOptions(algorithm_type=ALG[alg][1], **kw))
        assert t.compute(sel_t, pt, device="cpu"), name
        assert t.stats["path"] == name
        out[name] = t
    for (a, b), (aj, bj) in zip(sel_t + [(ct_[2], ct_[3])], sel_j + [(cj[2], cj[3])]):
        ref = j.get_covariance_block(aj, bj)
        for name in ("qr", "normal_equations", "schur_tail"):
            assert rel(out[name].get_covariance_block(a, b), ref) <= REL, name
        np.testing.assert_allclose(out["dense_svd"].get_covariance_block(a, b), ref,
                                   rtol=1e-6, atol=1e-9)
    with pytest.raises(KeyError):
        out["qr"].get_covariance_block(ptt[4], ptt[5])


def anchored_ba(mod, ctm, w, C=32, P=150):
    """The JAX Schur-tail test's problem (test_satellite_apis.py:352-374) at
    C cameras and P points: batched BA with Tikhonov anchors of weight w on
    every camera and point (the gauge)."""
    b = mod.synthetic_bal(num_cameras=C, num_points=P, visibility=0.15, noise=0.5, seed=0)
    prob, cams, pts = mod.build_problem_batched(b)
    anchor_c = ctm.AutoDiffCostFunction(lambda c, d: w * (c - d), 9, [9])
    anchor_p = ctm.AutoDiffCostFunction(lambda p, d: w * (p - d), 3, [3])
    arr_c, arr_p = prob._block_arrays
    prob.add_residual_block_batch(anchor_c, None, [(arr_c, np.arange(b.num_cameras))],
                                  data=cams.copy())
    prob.add_residual_block_batch(anchor_p, None, [(arr_p, np.arange(b.num_points))],
                                  data=pts.copy())
    return prob


def test_covariance_schur_tail_parity():
    """32 cameras with schur_tail_min_cols lowered to 128 (288 camera
    columns), anchors of weight 1 (well conditioned): the port's Schur
    tail against its pure QR (also where the core is one column too
    narrow for the tail) and its normal equations (1e-9), the Schur
    assembly's rows called (their plain versions on the CPU), S exactly
    symmetric."""
    pt = anchored_ba(tbal, ctt, 1.0)
    ref = ctt.Covariance(ctt.CovarianceOptions(schur_tail_min_cols=0))
    assert ref.compute([], pt, device="cpu") and ref.stats["path"] == "qr"
    for kw, path in ((dict(schur_tail_min_cols=128), "schur_tail"),
                     (dict(schur_tail_min_cols=289), "qr"),
                     (dict(use_normal_equations=True), "normal_equations")):
        kn.reset_counts()
        t = ctt.Covariance(ctt.CovarianceOptions(**kw))
        assert t.compute([], pt, device="cpu")
        assert t.stats["path"] == path
        assert rel(t._cov, ref._cov) <= REL, kw
        plain = {k.__name__: k.plain_calls for k in kn.KERNELS}
        if path == "schur_tail":
            assert t.stats["schur_columns"] == 288 and t.stats["schur_asymmetry"] == 0.0
            assert all(plain[k] > 0 for k in ("segment_block_sum", "segment_block_expand",
                                              "segment_spread_sum", "unsorted_segment_sum"))
        if path == "normal_equations":
            assert plain["segment_block_sum"] > 0 and plain["segment_block_expand"] > 0


def test_covariance_pose_graph_parity():
    """A 100-pose 2D graph (the SLAM test's model at an eighth of its
    poses): the port's QR against the JAX QR and the port's normal
    equations, every column."""
    args = dict(num_poses=100, loop_closures=6, noise=0.02, seed=3)
    poses_t, cons_t, _ = tpg.synthetic_2d(**args)
    poses_j, cons_j, _ = jpg.synthetic_2d(**args)
    pt, _ = tpg.build_problem_2d(poses_t, cons_t)
    pj, _ = jpg.build_problem_2d(poses_j, cons_j)
    t = ctt.Covariance(ctt.CovarianceOptions())
    j = ct.Covariance(ct.CovarianceOptions())
    assert t.compute([], pt, device="cpu") and j.compute([], pj)
    assert t._cov.shape == (297, 297) and rel(t._cov, j._cov) <= REL
    ne = ctt.Covariance(ctt.CovarianceOptions(use_normal_equations=True))
    assert ne.compute([], pt, device="cpu")
    assert np.linalg.norm(t._cov - ne._cov) / np.linalg.norm(ne._cov) < 1e-6


def test_covariance_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rng = np.random.default_rng(0)
    (pt, _), (xt, _) = linear_problems(rng.standard_normal((4, 2)), np.zeros(4))
    with pytest.raises(RuntimeError):
        ctt.Covariance().compute([(xt, xt)], pt)


def test_qr_library_build_key_follows_source_and_flags():
    """The QR library's build directory: keyed on its own source and the
    flags (unlike the JAX package's, keyed on the source alone), under
    build/native/; the port's copy, not the JAX package's file."""
    k = native.library_key(native.SRC_QR)
    assert native.library_key(native.SRC_QR, source=native.SRC_QR.read_bytes() + b"//") != k
    assert native.library_key(native.SRC_QR, flags=native.FLAGS + ["-DNDEBUG"]) != k
    assert native.library_key(native.SRC) != k
    path = native.build(native.SRC_QR, native.QR_LIB_NAME)
    assert path.parent == native.BUILD_ROOT / k and path.is_file()
    assert native.SRC_QR.parent.name == "native"
    assert native.SRC_QR.parent.parent.name == "ceres_tpu_torch"


def test_sparse_qr_one_live_factor_and_solve_multi():
    """SparseQR's (A'A)^{-1} B against numpy, the factor invalidated by the
    next one, and SparseCholesky.solve_multi against its solve."""
    import scipy.sparse as sp

    A = sp.random(40, 12, density=0.3, random_state=1, format="csr") + sp.eye(40, 12,
                                                                                format="csr")
    A.sort_indices()
    B = np.random.default_rng(0).standard_normal((12, 3))
    qr = native.SparseQR(40, 12, A.indptr, A.indices, A.data)
    X = qr.solve_normal_multi(B)
    np.testing.assert_allclose((A.T @ A).toarray() @ X, B, atol=1e-12)
    assert qr.nnz_R > 0 and np.all(qr.diag() > 0)
    qr2 = native.SparseQR(40, 12, A.indptr, A.indices, A.data)
    with pytest.raises(RuntimeError):
        qr.diag()
    np.testing.assert_array_equal(qr2.solve_normal_multi(B), X)
    qr2.free()
    M = sp.csr_matrix((A.T @ A).toarray())
    chol = native.SparseCholesky(12, M.indptr, M.indices)
    assert chol.factorize(M.data)
    Y = chol.solve_multi(B)
    for c in range(3):
        np.testing.assert_array_equal(Y[:, c], chol.solve(B[:, c]))
    np.testing.assert_allclose(Y, X, atol=1e-12)


@pytest.mark.slow
def test_covariance_sparse_qr_slam_scale():
    """The twin of test_covariance_sparse_qr_slam_scale: an 800-pose 2D
    graph (2,397 columns), the QR within 120 s, against the normal
    equations (1e-6) and the JAX QR (1e-9)."""
    import time

    args = dict(num_poses=800, loop_closures=30, noise=0.02, seed=3)
    pt, _ = tpg.build_problem_2d(*tpg.synthetic_2d(**args)[:2])
    pj, _ = jpg.build_problem_2d(*jpg.synthetic_2d(**args)[:2])
    t0 = time.time()
    t = ctt.Covariance(ctt.CovarianceOptions())
    assert t.compute([], pt, device="cpu")
    assert time.time() - t0 < 120.0
    ne = ctt.Covariance(ctt.CovarianceOptions(use_normal_equations=True))
    assert ne.compute([], pt, device="cpu")
    assert np.linalg.norm(t._cov - ne._cov) / np.linalg.norm(ne._cov) < 1e-6
    j = ct.Covariance(ct.CovarianceOptions())
    assert j.compute([], pj)
    assert rel(t._cov, j._cov) <= REL


@pytest.mark.slow
def test_covariance_schur_tail_full_ba_scale():
    """The twin of test_covariance_schur_tail_full_ba_scale: 400 cameras
    (a 3,600-column core) with the JAX test's anchors at the default
    options (the Schur tail), within 300 s, against the normal equations
    (1e-6) and the JAX Schur tail; and the 32-camera tail against the JAX
    tail itself (1e-9)."""
    import time

    def large(mod, ctm):
        b = mod.synthetic_bal_large(num_cameras=400, num_points=2500, mean_track=6.0,
                                    cam_window=40, seed=0)
        prob, cams, pts = mod.build_problem_batched(b)
        w = 1e-2
        arr_c, arr_p = prob._block_arrays
        prob.add_residual_block_batch(ctm.AutoDiffCostFunction(lambda c, d: w * (c - d), 9, [9]),
                                      None, [(arr_c, np.arange(b.num_cameras))], data=cams.copy())
        prob.add_residual_block_batch(ctm.AutoDiffCostFunction(lambda p, d: w * (p - d), 3, [3]),
                                      None, [(arr_p, np.arange(b.num_points))], data=pts.copy())
        return prob

    pt = large(tbal, ctt)
    t0 = time.time()
    t = ctt.Covariance(ctt.CovarianceOptions())
    assert t.compute([], pt, device="cpu")
    assert time.time() - t0 < 300.0 and t.stats["path"] == "schur_tail"
    ne = ctt.Covariance(ctt.CovarianceOptions(use_normal_equations=True))
    assert ne.compute([], pt, device="cpu")
    assert np.linalg.norm(t._cov - ne._cov) / np.linalg.norm(ne._cov) < 1e-6
    j = ct.Covariance(ct.CovarianceOptions())
    assert j.compute([], large(jbal, ct))
    assert np.linalg.norm(t._cov - j._cov) / np.linalg.norm(j._cov) < 1e-6
    small_t, small_j = anchored_ba(tbal, ctt, 1.0), anchored_ba(jbal, ct, 1.0)
    t = ctt.Covariance(ctt.CovarianceOptions(schur_tail_min_cols=128))
    j = ct.Covariance(ct.CovarianceOptions(schur_tail_min_cols=128))
    assert t.compute([], small_t, device="cpu") and j.compute([], small_j)
    assert rel(t._cov, j._cov) <= REL


def test_pair_groups_of_kinds_of_unequal_sizes():
    """The host loop's dense-Schur W = E'F and F'F and the inner product J'J
    on a program whose kinds hold different numbers of rows (observations
    and the two anchor kinds): each the dense Jacobian's blocks (1e-12).
    Pairing a slot of one kind with a slot of another once compared their
    block ids elementwise and raised."""
    from ceres_tpu_torch.ops import bsr
    from ceres_tpu_torch.ops import flatops as fo
    from ceres_tpu_torch.ops import partition as pt
    from ceres_tpu_torch.ops.inner_product import InnerProductComputer
    from ceres_tpu_torch.program import CompiledProgram
    from ceres_tpu_torch.solvers.linear.dense_schur import DenseSchurOps

    prog = CompiledProgram(anchored_ba(tbal, ctt, 1.0, C=6, P=40), device="cpu")
    o = prog._eval_core(prog.initial_state(), dense_jac=True)
    vflat = tuple(tuple(J.reshape(J.shape[0], -1) for J in jacs) for jacs in o["block_jacs"])
    J = o["jacobian"].numpy()
    H = J.T @ J
    meta = bsr.build_meta(prog)
    pm = pt.build_partition(meta, [1])
    ops = DenseSchurOps(pm, fo.FlatSchurOps(pm, prog))
    e = slice(prog.families[1].tangent_offset, prog.tangent_size)
    f = slice(0, prog.families[1].tangent_offset)
    np.testing.assert_allclose(ops.assemble_w(vflat).numpy(), H[e, f], rtol=0,
                               atol=1e-12 * np.abs(H).max())
    np.testing.assert_allclose(ops.assemble_ftf(vflat).numpy(), H[f, f], rtol=0,
                               atol=1e-12 * np.abs(H).max())
    ipc = InnerProductComputer(meta, "cpu")
    vals = ipc.compute(vflat).numpy()
    rows = np.repeat(np.arange(ipc.n), np.diff(ipc.indptr))
    np.testing.assert_allclose(vals, H[rows, ipc.indices], rtol=0, atol=1e-12 * np.abs(H).max())
