"""The plain PyTorch version of each of the port's four kernels (what the
CUDA kernels are held against on the card) against ceres_tpu on the same
inputs: the JAX program's evaluation and sums over its dense Jacobian.
float64 on the CPU; each tolerance is stated where it is used."""
import numpy as np
import pytest
import torch

from ceres_tpu.models import bal as jbal
from ceres_tpu.program import CompiledProgram as JaxProgram

import ceres_tpu_torch as ctt
from ceres_tpu_torch.models import bal as tbal
from ceres_tpu_torch.ops import kernels as kn
from ceres_tpu_torch.program import CompiledProgram
from ceres_tpu_torch.solvers.fused_lm import DenseSchurStepOps


@pytest.fixture(scope="module")
def setup():
    b = jbal.perturb(jbal.synthetic_bal(num_cameras=4, num_points=300,
                                        visibility=0.5, seed=0),
                     0.01, 0.05, 0.05, seed=1)
    jprog = JaxProgram(jbal.build_problem_batched(b)[0], sort_rows=True)
    cost, r, g, J = (np.asarray(a) for a in jprog.evaluate_dense(jprog.initial_state()))
    prog = CompiledProgram(tbal.build_problem_batched(tbal.from_arrays(
        b.cameras, b.points, b.camera_index, b.point_index, b.observations))[0],
        "float64", device="cpu")
    opts = ctt.Options(linear_solver_type=ctt.LinearSolverType.DENSE_SCHUR)
    ops = DenseSchurStepOps(prog, opts, [1])
    x = prog.initial_state()
    cost_t, vrep = ops.evaluate(x)
    rT = vrep.rt
    C, P = b.num_cameras, b.num_points
    return dict(b=b, cost=float(cost), r=r, g=g, J=J, C=C, P=P, ops=ops,
                cost_t=cost_t, rT=rT, JT=vrep.jt, vrep=vrep, nf=9 * C)


def rel_err(out, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(out, np.float64) - ref).max() / np.abs(ref).max()


def test_eval_fused_plain_matches_jax(setup):
    """Residuals, J_f, J_e and cost of the rows-form kernel function vs the
    JAX program's dense evaluation (branchy rotation): 1e-12 relative."""
    s = setup
    C, nf = s["C"], s["nf"]
    J = s["J"]
    B = s["rT"].shape[1]
    assert rel_err(s["rT"].T.reshape(-1).numpy(), s["r"]) <= 1e-12
    assert float(s["cost_t"]) == pytest.approx(s["cost"], rel=1e-12)
    cam = s["ops"].flat.plan.cam_idx.long().numpy()
    pt = s["ops"].flat.plan.pt_idx.long().numpy()
    rows = np.arange(B)
    Jd = J.reshape(B, 2, -1)
    Jf_ref = np.stack([Jd[rows, :, 9 * cam + a] for a in range(9)], axis=2)
    Je_ref = np.stack([Jd[rows, :, nf + 3 * pt + k] for k in range(3)], axis=2)
    Jf, Je = kn._split_jt(s["JT"])
    assert rel_err(Jf.numpy(), Jf_ref) <= 1e-12
    assert rel_err(Je.numpy(), Je_ref) <= 1e-12


def test_post_eval_fused_plain_matches_dense_jacobian(setup):
    """g = J'r, diag(J'J) and the per-point E'E blocks from the dense JAX
    Jacobian: 1e-12 relative (sums of a few thousand terms)."""
    s = setup
    J, r, nf, P = s["J"], s["r"], s["nf"], s["P"]
    ptab, cam = kn.post_eval_fused(s["JT"], s["rT"], s["ops"].flat.plan)
    g_ref = J.T @ r
    sqn_ref = np.sum(J * J, axis=0)
    Je = J[:, nf:].reshape(-1, P, 3)
    ete_ref = np.einsum("npk,npm->pkm", Je, Je).reshape(P, 9)
    assert rel_err(ptab[:, :3].reshape(-1), g_ref[nf:]) <= 1e-12
    assert rel_err(ptab[:, 3:6].reshape(-1), sqn_ref[nf:]) <= 1e-12
    assert rel_err(ptab[:, 6:], ete_ref) <= 1e-12
    assert rel_err(cam[:, :9].reshape(-1), g_ref[:nf]) <= 1e-12
    assert rel_err(cam[:, 9:].reshape(-1), sqn_ref[:nf]) <= 1e-12
    # and through the step adapter, in the tangent layout
    gt, sqnt, _ = s["ops"].post_eval(s["vrep"])
    assert rel_err(gt.numpy(), s["g"]) <= 1e-12


def test_schur_assembly_plain_matches_explicit_schur_complement(setup):
    """S = blockdiag(FtF) + D_f^2 - A'A and rhs = b_f - U against the
    Schur complement of the dense scaled normal equations,
    H = (J s)'(J s) + D^2: S = H_ff - H_fe H_ee^{-1} H_ef,
    rhs = b_f - H_fe H_ee^{-1} b_e. float64, 1e-10 relative."""
    s = setup
    ops, J, nf, C, P = s["ops"], s["J"], s["nf"], s["C"], s["P"]
    g, sqn, aux = ops.post_eval(s["vrep"])
    scale = 1.0 / (1.0 + torch.sqrt(sqn))
    D2 = torch.clamp(scale * scale * sqn, 1e-6, 1e32) / 1e2
    b, se, sf, d2f, K, u = ops.schur_inputs(aux, g, scale, D2)
    ata, ftf, U = kn.schur_assembly(s["JT"], sf.reshape(C, 9), se.reshape(P, 3),
                                    K, u.reshape(P, 3), ops.flat.plan)
    S = torch.block_diag(*ftf.reshape(C, 9, 9)) + torch.diag(d2f) - ata
    sv = scale.numpy()
    Js = J * sv[None, :]
    H = Js.T @ Js + np.diag(D2.numpy())
    Hff, Hfe, Hee = H[:nf, :nf], H[:nf, nf:], H[nf:, nf:]
    bn = b.numpy()
    S_ref = Hff - Hfe @ np.linalg.solve(Hee, Hfe.T)
    rhs_ref = bn[:nf] - Hfe @ np.linalg.solve(Hee, bn[nf:])
    assert rel_err(S.numpy(), S_ref) <= 1e-10
    assert rel_err((b[:nf] - U).numpy(), rhs_ref) <= 1e-10
    assert torch.equal(ata, ata.T)


def test_normal_matvec_plain_matches_dense_jacobian(setup):
    """(J'J) x from the dense JAX Jacobian: 1e-12 relative."""
    s = setup
    J, nf, C, P = s["J"], s["nf"], s["C"], s["P"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal(J.shape[1])
    xc = torch.as_tensor(x[:nf].reshape(C, 9))
    xp = torch.as_tensor(x[nf:].reshape(P, 3))
    cam, pt = kn.normal_matvec(s["JT"], xc, xp, s["ops"].flat.plan)
    ref = J.T @ (J @ x)
    assert rel_err(cam.reshape(-1).numpy(), ref[:nf]) <= 1e-12
    assert rel_err(pt.reshape(-1).numpy(), ref[nf:]) <= 1e-12


def test_row_plan_covers_every_row_and_pair(setup):
    """The camera chunks partition the rows, each within one camera, and
    the pair plan holds each pair of two rows of each point once, a from
    the lower camera, ordered by camera-pair key; each key's level-0 chunks
    hold its pairs only."""
    plan = setup["ops"].flat.plan
    cam = plan.cam_idx.long().numpy()
    pt = plan.pt_idx.long().numpy()
    rows = plan.cam_rows.long().numpy()
    assert sorted(rows.tolist()) == list(range(plan.B))
    cs = plan.cam_chunk_start.long().numpy()
    cf = plan.cam_chunk_first.long().numpy()
    for c in range(plan.C):
        for k in range(cf[c], cf[c + 1]):
            assert 0 < cs[k + 1] - cs[k] <= kn.CHUNK
            assert np.all(cam[rows[cs[k]:cs[k + 1]]] == c)
    pairs = plan.ensure_pairs()
    a = pairs.pair_a.long().numpy()
    bb = pairs.pair_b.long().numpy()
    counts = np.bincount(pt, minlength=plan.P)
    assert a.shape[0] == int(np.sum(counts * (counts - 1) // 2))
    assert np.all(pt[a] == pt[bb])
    assert np.all((cam[a] < cam[bb]) | ((cam[a] == cam[bb]) & (a < bb)))
    got = {(min(x, y), max(x, y)) for x, y in zip(a.tolist(), bb.tolist())}
    assert len(got) == a.shape[0]
    key_cams = pairs.key_cams.long().numpy()
    assert pairs.n_keys == plan.C * (plan.C + 1) // 2
    pair_key = cam[a] * plan.C + cam[bb]
    key = np.searchsorted(key_cams, pair_key)
    assert np.all(key_cams[key] == pair_key) and np.all(np.diff(key) >= 0)
    pcs = pairs.pair_levels[0].long().numpy()
    assert pcs[0] == 0 and pcs[-1] == a.shape[0]
    assert np.all(key[pcs[:-1]] == key[pcs[1:] - 1])
