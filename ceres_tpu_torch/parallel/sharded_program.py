"""The halo tier for a compiled program (counterpart of
ceres_tpu/parallel/sharded_program.py).

Lifts the Ceres-semantics halo step (sharded_ba.lm_step_camera_halo_ceres)
from the Snavely arrays to any CompiledProgram of one kind with two slots
in two families: the f family ("cameras") sharded over the ranks with its
observations, the e family ("points") owner-sharded, every point-side sum
closed through the cut-sized halo all-to-alls (plan_camera_halo does not
look at the arrays' widths).

What generalizes:
 - evaluation: the kind's cost function over the rank's rows, forward-mode
   Jacobians (CostFunction.batched_residuals_and_jacobians, torch.func's
   jacfwd under vmap) taken to the tangent space through each family's
   PlusJacobian (residual_block.cc:70-196), so quaternion-camera BA
   shards too;
 - the state update: each family's manifold plus instead of x + step;
 - observation data: the kind's data leaves, flattened to a (B, d) table
   for the plan and split back inside the evaluation.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import sharded_ba as sb
from ..utils.tree import tree_leaves, tree_map


def qualify_program_halo(program, e_families=None):
    """The halo tier's gate: one kind, two slots in two distinct families,
    both fully variable, a trivial loss, manifolds the row-wise chain rule
    covers. Returns (kind, fam_f, fam_e, slot_f, slot_e) or None. fam_e
    (owner-sharded, eliminated) comes from the Schur e-set, else the
    larger family (sharded_program.py:35)."""
    from ..loss import TrivialLoss

    if len(program.kinds) != 1:
        return None
    kind = program.kinds[0]
    if len(kind.slots) != 2:
        return None
    if kind.loss is not None and not isinstance(kind.loss, TrivialLoss):
        return None
    fam_a, fam_b = kind.slots[0].family, kind.slots[1].family
    if fam_a is fam_b:
        return None
    for fam in (fam_a, fam_b):
        if fam.num_var != fam.count:  # constant blocks
            return None
        if not fam.euclidean and not getattr(fam.manifold, "supports_rows_columns", False):
            return None
    if e_families is None:
        from ..utils.ordering import eligible_e_sets

        e_families = eligible_e_sets(program)
    e_set = {id(program.families[fi]) for fi in e_families}
    if id(fam_a) in e_set and id(fam_b) not in e_set:
        return kind, fam_b, fam_a, 1, 0
    if id(fam_b) in e_set and id(fam_a) not in e_set:
        return kind, fam_a, fam_b, 0, 1
    if fam_a.count >= fam_b.count:
        return kind, fam_b, fam_a, 1, 0
    return kind, fam_a, fam_b, 0, 1


def _flat_data(kind):
    """((B, d) float64 numpy table of the kind's data leaves, a splitter of
    (n, d) table rows back to the data tree)."""
    leaves = tree_leaves(kind.data)
    B = kind.B
    shapes, cols = [], []
    for lf in leaves:
        a = lf.detach().cpu().numpy() if isinstance(lf, torch.Tensor) else np.asarray(lf)
        if a.shape[0] != B:
            raise ValueError("the halo tier needs per-observation data")
        shapes.append(a.shape[1:])
        cols.append(np.asarray(a, np.float64).reshape(B, -1))
    table = np.concatenate(cols, axis=1) if cols else np.zeros((B, 1), np.float64)
    widths = [int(np.prod(sh)) if sh else 1 for sh in shapes]

    def split_rows(rows):
        out, off = [], 0
        for wd, sh in zip(widths, shapes):
            piece = rows[:, off:off + wd]
            out.append(piece.reshape((rows.shape[0],) + tuple(sh)) if sh else piece[:, 0])
            off += wd
        pieces = iter(out)
        return tree_map(lambda _: next(pieces), kind.data)

    return table, split_rows


def build_halo_fns(program, kind, fam_f, fam_e, slot_f, slot_e):
    """(evaluate, cost_fn, plus_c, plus_e) of the generalized halo step:
    evaluate returns the tangent-space blocks (B, r, tf), (B, r, te)."""
    cost = kind.cost
    _, split_rows = _flat_data(kind)
    dt = program.compute_dtype

    def params_of(cams_l, halo_pts, cam_local, pt_halo):
        params = [None, None]
        params[slot_f] = cams_l[cam_local]
        params[slot_e] = halo_pts[pt_halo]
        return params

    def chain(J, fam, x_rows):
        if fam.euclidean:
            return J
        return torch.einsum("bra,bat->brt", J, torch.func.vmap(fam.manifold.plus_jacobian)(
            x_rows))

    def evaluate(cams_l, halo_pts, cam_local, pt_halo, obs, w):
        params = params_of(cams_l, halo_pts, cam_local, pt_halo)
        r, jacs = cost.batched_residuals_and_jacobians(params, split_rows(obs))
        Jc = chain(jacs[slot_f], fam_f, params[slot_f])
        Jp = chain(jacs[slot_e], fam_e, params[slot_e])
        if w is not None:
            r = r * w[:, None]
            Jc = Jc * w[:, None, None]
            Jp = Jp * w[:, None, None]
        return r, Jc.to(dt), Jp.to(dt)

    def cost_fn(cams_l, halo_pts, cam_local, pt_halo, obs, w):
        params = params_of(cams_l, halo_pts, cam_local, pt_halo)
        r = torch.func.vmap(lambda ps, d: cost.residuals(list(ps), d))(
            tuple(params), split_rows(obs))
        if w is not None:
            r = r * w[:, None]
        return 0.5 * torch.sum(r * r)

    def make_plus(fam):
        return None if fam.euclidean else torch.func.vmap(fam.manifold.plus)

    return evaluate, cost_fn, make_plus(fam_f), make_plus(fam_e)


def solve_program_camera_halo(program, options=None, mesh=None, k=4, radius0=1e4,
                              max_num_iterations: Optional[int] = None, e_families=None):
    """The halo-sharded LM over a program (sharded_program.py:164):
    qualification, plan, the loop, the solution written back into the
    program's arrays on every rank. Returns (x (numpy state vector),
    {"final_cost", "iterations", "termination"}, TerminationType). The
    program must live on the mesh's device."""
    from .mesh import make_mesh

    q = qualify_program_halo(program, e_families)
    if q is None:
        raise ValueError("program does not qualify for the halo tier")
    kind, fam_f, fam_e, slot_f, slot_e = q
    opts, max_iters = sb._sharded_lm_options(options, max_num_iterations)
    mesh = mesh or make_mesh(axis="cam")
    x0 = program.initial_state().cpu().numpy()

    def table(fam):
        return x0[fam.state_offset:fam.state_offset + fam.count * fam.asize].reshape(
            fam.count, fam.asize)

    data_table, _ = _flat_data(kind)
    plan = sb.plan_camera_halo(kind.slots[slot_f].pos_in_family,
                               kind.slots[slot_e].pos_in_family, table(fam_f), table(fam_e),
                               data_table, mesh.size)
    evaluate, cost_fn, plus_c, plus_e = build_halo_fns(program, kind, fam_f, fam_e,
                                                       slot_f, slot_e)
    c = sb.run_halo_ceres(mesh, plan, plan.cams, plan.pts, opts, max_iters, k, radius0,
                          torch.float64, evaluate=evaluate, cost_fn=cost_fn,
                          plus_c=plus_c, plus_e=plus_e)
    # unpad through the plan's slot maps, the tables gathered on every rank
    cams = mesh.all_gather_tiled(c.cams).cpu().numpy()[plan.camera_slot]
    pts = mesh.all_gather_tiled(c.pts).cpu().numpy()[plan.point_slot]
    x = np.array(x0)
    for fam, tab in ((fam_f, cams), (fam_e, pts)):
        x[fam.state_offset:fam.state_offset + fam.count * fam.asize] = tab.reshape(-1)
    program.write_state(torch.as_tensor(x))
    term = sb._halo_terminal(c.term)
    return x, {"final_cost": float(c.cost), "iterations": c.it, "termination": term}, term
