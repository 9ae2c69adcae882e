"""The host loop's Schur pieces against ceres_tpu's (the twins of
tests/test_schur.py:44-127) on the CPU: the partitioned products E y,
F z, E'u, F'u and the E'E and F'F blocks (the port's are
ops/flatops.FlatSchurOps's, over kernels 6, 7 and 9); the implicit Schur
complement S z and its right-hand side against the JAX package's and the
explicit dense S; DENSE_SCHUR's dense W and F'F (summed by kernel 6 over
solvers/linear/dense_schur.DenseSchurOps's pair plans) and
dense_schur_solve against the JAX functions and the normal equations;
schur_jacobi_blocks against the JAX function and the diagonal blocks of
the explicit S. On the JAX package's block Jacobian of two small
problems: BAL built one block at a time with camera 0 constant (the
sentinel), and the libmv bundle adjuster's markers split over two
residual kinds (two f families, the shared intrinsics block in every
row). Each tolerance is stated where it is used."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ceres_tpu as ct
from ceres_tpu.models import bal as jbal
from ceres_tpu.models import libmv as jlibmv
from ceres_tpu.ops import bsr as jbsr
from ceres_tpu.ops import partition as jpt
from ceres_tpu.program import CompiledProgram as JaxProgram
from ceres_tpu.solvers.linear import dense_schur as jds
from ceres_tpu.solvers.linear import implicit_schur as jis
from ceres_tpu.utils import ordering as jordering

import ceres_tpu_torch as ctt
import chip_smoke
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.models import libmv as tlibmv
from ceres_tpu_torch.ops import bsr
from ceres_tpu_torch.ops import flatops as fo
from ceres_tpu_torch.ops import partition as pt
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.linear import dense_schur as tds
from ceres_tpu_torch.solvers.linear import implicit_schur as tis
from ceres_tpu_torch.utils import ordering

TOL = 1e-12


def _bal_problems():
    b = jbal.perturb(jbal.synthetic_bal(num_cameras=4, num_points=40, visibility=0.5,
                                        noise=0.3, seed=5), 0.05, 0.2, 0.2)
    jp, jcams, _ = jbal.build_problem(b)
    jp.set_parameter_block_constant(jcams[0])
    tp, tcams, _ = tbal.build_problem(tbal.from_arrays(
        b.cameras, b.points, b.camera_index, b.point_index, b.observations))
    tp.set_parameter_block_constant(tcams[0])
    return jp, tp


def _libmv_problem(lp, P):
    """The markers split over two batched adds of one cost: even and odd."""
    p = P.Problem()
    cams = p.add_parameter_block_array(lp.cameras.copy())
    pts = p.add_parameter_block_array(lp.points.copy())
    intr = p.add_parameter_block_array(lp.intrinsics.reshape(1, 8).copy())
    cost = (tlibmv.LIBMV_COST if P is ctt else
            ct.AutoDiffCostFunction(jlibmv.libmv_reprojection_residual, 2, [6, 3, 8]))
    for half in (slice(0, None, 2), slice(1, None, 2)):
        n = lp.marker_cam[half].shape[0]
        p.add_residual_block_batch(
            cost, None, [(cams, lp.marker_cam[half]), (pts, lp.marker_pt[half]),
                         (intr, np.zeros(n, np.int64))], data=lp.markers[half])
    return p


def _libmv_problems():
    b = tbal.synthetic_bal(num_cameras=4, num_points=40, visibility=1.0, seed=0)
    lp = chip_smoke.libmv_instance(b, tbal.perturb(b, 0.02, 0.2, 0.2, seed=1))
    return _libmv_problem(lp, ct), _libmv_problem(lp, ctt)


@pytest.fixture(scope="module", params=["bal", "libmv"])
def setup(request):
    jp, tp = {"bal": _bal_problems, "libmv": _libmv_problems}[request.param]()
    jprog = JaxProgram(jp, sort_rows=True)
    _, res, _, jvalues = jprog.evaluate_bsr(jprog.initial_state())
    jmeta = jbsr.build_meta(jprog)
    jpm = jpt.build_partition(jmeta, jordering.eligible_e_sets(jprog))
    prog = CompiledProgram(tp, device="cpu")
    pm = pt.build_partition(bsr.build_meta(prog), ordering.eligible_e_sets(prog))
    values = [[torch.as_tensor(np.array(V)) for V in slots] for slots in jvalues]
    J = np.asarray(jbsr.to_dense(jmeta, jvalues))
    e_cols = np.zeros(J.shape[1], bool)
    for fi in jpm.e_family_indices:
        f = jmeta.families[fi]
        e_cols[f.tangent_offset:f.tangent_offset + f.num_var * f.t] = True
    # BAL: each (point, camera) pair shares one row, where the SCHUR_JACOBI
    # blocks are exact; libmv's intrinsics block shares every row of a point
    one_row_pairs = request.param == "bal"
    return jpm, jvalues, pm, values, J, np.array(res), e_cols, one_row_pairs


def _flat(pm, values):
    fl = fo.FlatSchurOps(pm, "cpu")
    return fl, fl.flatten(values)


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= tol * max(np.abs(ref).max(), 1.0)


def _explicit_S(J, e_cols, D_e, D_f):
    E, F = J[:, e_cols], J[:, ~e_cols]
    M = E.T @ E + np.diag(D_e ** 2)
    return F.T @ F + np.diag(D_f ** 2) - F.T @ E @ np.linalg.solve(M, E.T @ F), E, F, M


def _D(pm, J, seed):
    D = np.random.default_rng(seed).uniform(0.1, 1.0, J.shape[1])
    return D, pt.extract_e(pm, torch.as_tensor(D)), pt.extract_f(pm, torch.as_tensor(D))


@pytest.mark.parametrize("op", ["right_e", "right_f", "left_e", "left_f"])
def test_partitioned_products_match_jax_and_dense(setup, op):
    """Each product 1e-12 relative against the JAX function and the dense
    E or F."""
    jpm, jvalues, pm, values, J, res, e_cols, _ = setup
    assert (pm.e_size, pm.f_size) == (jpm.e_size, jpm.f_size)
    rng = np.random.default_rng(0)
    E, F = J[:, e_cols], J[:, ~e_cols]
    arg = {"right_e": rng.standard_normal(pm.e_size), "right_f": rng.standard_normal(pm.f_size),
           "left_e": rng.standard_normal(J.shape[0]), "left_f": rng.standard_normal(J.shape[0])}[op]
    fl, vflat = _flat(pm, values)
    out = getattr(fl, op)(vflat, torch.as_tensor(arg))
    jfn = getattr(jpt, op[:-2] + "_multiply_" + op[-1])
    _close(out, jfn(jpm, jvalues, jnp.asarray(arg)))
    dense = {"right_e": lambda: E @ arg, "right_f": lambda: F @ arg,
             "left_e": lambda: E.T @ arg, "left_f": lambda: F.T @ arg}[op]()
    _close(out, dense)


def test_block_diag_ete_ftf_match_jax(setup):
    """The E'E and F'F blocks, plus D^2, against the JAX functions, 1e-12."""
    jpm, jvalues, pm, values, J, res, e_cols, _ = setup
    D, D_e, D_f = _D(pm, J, 6)
    fl, vflat = _flat(pm, values)
    for blocks, jfn, fams, Dp in [(fl.block_ete(vflat), jpt.block_diag_ete, pm.e_fams, D_e),
                                  (fl.block_ftf(vflat), jpt.block_diag_ftf, pm.f_fams, D_f)]:
        refs = jfn(jpm, jvalues, jnp.asarray(Dp.numpy()))
        for (off, nv, t, _), blk, ref in zip(fams, blocks, refs):
            d2 = (Dp[off:off + nv * t] ** 2).reshape(nv, t)
            _close(blk.reshape(nv, t, t) + torch.diag_embed(d2), ref)


def test_implicit_schur_multiply_matches_jax_and_explicit(setup):
    """S z and the right-hand side F'b - F'E M^-1 E'b, 1e-12 relative
    against the JAX functions and 1e-10 against the explicit dense S
    (numpy's solve of M adds its own rounding)."""
    jpm, jvalues, pm, values, J, res, e_cols, _ = setup
    D, D_e, D_f = _D(pm, J, 1)
    sys = tis.build_schur_system(pm, values, torch.as_tensor(res), D_e)
    jsys = jis.build_schur_system(jpm, jvalues, jnp.asarray(res), jnp.asarray(D_e.numpy()))
    z = np.random.default_rng(1).standard_normal(pm.f_size)
    out = tis.schur_multiply(pm, values, sys, D_f, torch.as_tensor(z))
    _close(out, jis.schur_multiply(jpm, jvalues, jsys, jnp.asarray(D_f.numpy()), jnp.asarray(z)))
    _close(sys.rhs, jsys.rhs)
    S, E, F, M = _explicit_S(J, e_cols, D_e.numpy(), D_f.numpy())
    _close(out, S @ z, 1e-10)
    _close(sys.rhs, F.T @ res - F.T @ E @ np.linalg.solve(M, E.T @ res), 1e-10)
    # the back substitution y = M^-1 (E'b - E'F z)
    _close(tis.back_substitute(pm, values, sys, torch.as_tensor(z)),
           jis.back_substitute(jpm, jvalues, jsys, jnp.asarray(z)))


def test_dense_w_and_ftf_match_jax(setup):
    """DENSE_SCHUR's dense W = E'F and F'F + D_f^2 against the JAX
    functions, 1e-12 relative; a second assembly bit for bit the first."""
    jpm, jvalues, pm, values, J, res, e_cols, _ = setup
    D, D_e, D_f = _D(pm, J, 5)
    fl, vflat = _flat(pm, values)
    ops = tds.DenseSchurOps(pm, fl)
    W = ops.assemble_w(vflat)
    _close(W, jds.assemble_w_dense(jpm, jvalues))
    _close(ops.assemble_ftf(vflat) + torch.diag(D_f * D_f),
           jds.assemble_ftf_dense(jpm, jvalues, jnp.asarray(D_f.numpy())))
    assert torch.equal(W, ops.assemble_w(vflat))


def test_dense_schur_solve_matches_jax_and_normal_equations(setup):
    """y of (J'J + D^2) y = J'b: 1e-11 relative against the JAX function
    (the products agree to 1e-12; the solve amplifies their rounding by
    the reduced system's condition), 1e-9 against numpy's
    solve of the full normal equations."""
    jpm, jvalues, pm, values, J, res, e_cols, _ = setup
    D = np.random.default_rng(2).uniform(0.1, 1.0, J.shape[1])
    fl, vflat = _flat(pm, values)
    y = tds.dense_schur_solve(tds.DenseSchurOps(pm, fl), vflat, torch.as_tensor(res),
                              torch.as_tensor(D))
    _close(y, jds.dense_schur_solve(jpm, jvalues, jnp.asarray(res), jnp.asarray(D)), 1e-11)
    y_true = np.linalg.solve(J.T @ J + np.diag(D * D), J.T @ res)
    _close(y, y_true, 1e-9)


def test_schur_jacobi_blocks_match_jax_and_explicit(setup):
    """The diagonal blocks of S, 1e-12 relative against the JAX function
    and, where each (e, f) block pair shares at most one row (the blocks
    are exact only there, implicit_schur.py:70), 1e-10 against the
    explicit S."""
    jpm, jvalues, pm, values, J, res, e_cols, one_row_pairs = setup
    D, D_e, D_f = _D(pm, J, 3)
    sys = tis.build_schur_system(pm, values, torch.as_tensor(res), D_e)
    jsys = jis.build_schur_system(jpm, jvalues, jnp.asarray(res), jnp.asarray(D_e.numpy()))
    blocks = tis.schur_jacobi_blocks(pm, values, sys, D_f)
    jblocks = jis.schur_jacobi_blocks(jpm, jvalues, jsys, jnp.asarray(D_f.numpy()))
    S = _explicit_S(J, e_cols, D_e.numpy(), D_f.numpy())[0]
    for (off, nv, t, _), blk, jblk in zip(pm.f_fams, blocks, jblocks):
        _close(blk, jblk)
        for i in range(nv if one_row_pairs else 0):
            o = off + i * t
            _close(blk[i], S[o:o + t, o:o + t], 1e-10)
