"""Inner iterations: batched coordinate descent over independent sets
(counterpart of ceres_tpu/solvers/coordinate_descent.py;
coordinate_descent_minimizer.cc:130, Ruhe and Wedin's Algorithm II,
solver.h:634-715).

An independent set is a family that no residual kind touches twice (for
bundle adjustment: the points, the cameras), or one colour of a family
that a kind touches twice (a pose graph's poses), coloured by
utils/ordering.color_family_blocks. Sets are visited largest first. Each
takes `num_lm_steps` batched, LM-regularized Gauss-Newton steps: every
block's J'J and J'r assembled at once from the plain evaluation's block
Jacobians (the scatter targets from the ops/bsr meta, summed in a fixed
order), a batched Cholesky solve, and a per-block accept or reject on the block's own
residual cost, with a per-block radius. It runs on the device and reads
nothing back: the fused loop calls it between a candidate's evaluation and
its fetch, the host loop on each candidate.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops import bsr
from ..options import Options
from ..program import scatter_add_rows
from ..utils.ordering import color_family_blocks


class CoordinateDescentMinimizer:
    def __init__(self, program, options: Options, num_lm_steps: int = 3):
        self.program = program
        self.options = options
        self.num_lm_steps = num_lm_steps
        self.meta = bsr.build_meta(program)
        self.sets: List[tuple] = []  # (family index, colour mask (num_var,) or None)
        for fi, fam in enumerate(program.families):
            if fam.num_var == 0:
                continue
            if all(sum(1 for s in kind.slots if s.family is fam) <= 1
                   for kind in program.kinds):
                self.sets.append((fi, None))
            else:
                colors, nc = color_family_blocks(program, fi)
                for c in range(nc):
                    self.sets.append((fi, colors == c))

        def set_size(entry):
            fi, mask = entry
            fam = program.families[fi]
            return (fam.num_var if mask is None else int(mask.sum())) * fam.tsize

        self.sets.sort(key=set_size, reverse=True)
        self._targets = {}
        self._masks = {}

    def _family_targets(self, fi: int):
        """[(kind, slot, (B,) target block or num_var for a constant one)]
        of the slots of family fi, on the device."""
        if fi not in self._targets:
            fm = self.meta.families[fi]
            out = []
            for k, (kind, km) in enumerate(zip(self.program.kinds, self.meta.kinds)):
                for s, (slot, sm) in enumerate(zip(kind.slots, km.slots)):
                    if slot.family_index != fi or not slot.any_variable:
                        continue
                    local = sm.block_ids - fm.block_id_offset
                    tgt = np.where(local < fm.num_var, local, fm.num_var)
                    out.append((k, s, torch.as_tensor(tgt, device=self.program.device)))
            self._targets[fi] = out
        return self._targets[fi]

    def _per_block(self, x, fi: int, with_jac: bool = True):
        """(J'r (nv, t), J'J (nv, t, t), the cost of each block's residuals
        (nv,)) in float64, the products in the compute dtype
        (coordinate_descent.py:72-93); cost only without `with_jac`."""
        prog = self.program
        fam = prog.families[fi]
        nv, t = fam.num_var, fam.tsize
        o = prog._eval_core(x, with_jac=with_jac)
        f64 = dict(dtype=torch.float64, device=x.device)
        g = torch.zeros((nv + 1, t), **f64) if with_jac else None
        A = torch.zeros((nv + 1, t, t), **f64) if with_jac else None
        c = torch.zeros((nv + 1,), **f64)
        for k, s, tgt in self._family_targets(fi):
            kind = prog.kinds[k]
            rows = o["residuals"][kind.row_offset:kind.row_offset + kind.B * kind.r].reshape(
                kind.B, kind.r)
            scatter_add_rows(c, tgt, (0.5 * torch.sum(rows * rows, dim=1)).to(torch.float64))
            if with_jac:
                V = o["block_jacs"][k][s]
                scatter_add_rows(g, tgt, torch.einsum("brt,br->bt", V, rows).to(torch.float64))
                scatter_add_rows(A, tgt, torch.einsum("brc,brd->bcd", V, V).to(torch.float64))
        return (g[:nv] if with_jac else None), (A[:nv] if with_jac else None), c[:nv]

    def _apply(self, x, fi: int, delta):
        fam = self.program.families[fi]
        full = torch.zeros((self.program.tangent_size,), dtype=torch.float64, device=x.device)
        full[fam.tangent_offset:fam.tangent_offset + delta.numel()] = delta.reshape(-1)
        return self.program.plus(x, full)

    def _family_step(self, x, fi: int, mask):
        """num_lm_steps LM-regularized Gauss-Newton steps of every block of
        the set at once, each accepted where it lowers its block's cost
        (coordinate_descent.py:107-139)."""
        nv = self.program.families[fi].num_var
        radius = torch.full((nv,), 1e4, dtype=torch.float64, device=x.device)
        for _ in range(self.num_lm_steps):
            g, A, c = self._per_block(x, fi)
            diag = torch.clamp(torch.diagonal(A, dim1=1, dim2=2), 1e-6, 1e32)
            L, info = torch.linalg.cholesky_ex(A + torch.diag_embed(diag) / radius[:, None, None])
            delta = -torch.cholesky_solve(g[:, :, None], L)[:, :, 0]
            ok = mask & (info == 0) & torch.isfinite(delta).all(dim=1)
            delta = torch.where(ok[:, None], delta, 0.0)
            _, _, c_new = self._per_block(self._apply(x, fi, delta), fi, with_jac=False)
            accept = ok & (c_new < c)
            x = self._apply(x, fi, torch.where(accept[:, None], delta, 0.0))
            radius = torch.where(mask, torch.where(accept, radius * 2.0, radius * 0.25),
                                 radius)
        return x

    def minimize(self, x):
        for i, (fi, mask) in enumerate(self.sets):
            if i not in self._masks:
                nv = self.program.families[fi].num_var
                self._masks[i] = torch.as_tensor(
                    np.ones(nv, bool) if mask is None else mask, device=x.device)
            x = self._family_step(x, fi, self._masks[i])
        return x
