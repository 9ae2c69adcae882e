"""The block-sparse trust-region kernels of the host loop (counterpart of
ceres_tpu/solvers/bsr_kernels.py:62): the entry points of
DenseTrustRegionKernels (solvers/trust_region.py) over the block
Jacobian, for CGNR (JACOBI or IDENTITY), DENSE_SCHUR and ITERATIVE_SCHUR
(implicit, SCHUR_JACOBI or IDENTITY).

The evaluation is the plain one (`program._eval_core`), as the JAX host
loop's; its gradient and column norms, every product of the steps and the
model cost change run through the flat ops of ops/flatops.py on the
blocks flattened once per evaluation, as the JAX code takes its flat route
(bsr_kernels.py:229, :347): FlatSchurOps for the Schur solvers,
FlatJacobianOps for CGNR. On the card they launch segment_block_expand
(kernel 7) for every gather, segment_block_sum (kernel 6) for the sorted
point ids, unsorted_segment_sum (kernel 9) for the camera ids, and on a
BAL-shaped program CGNR's product is normal_matvec (kernel 4). The
DENSE_SCHUR step sums the blocks of its reduced system by
segment_block_sum (kernel 6) over the pair plans of
solvers/linear/dense_schur.DenseSchurOps, built with the program's. The
sparse solvers, the explicit Schur complement and the other
preconditioners are ROADMAP.md port slice 6.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import bsr
from ..ops import flatops as fo
from ..ops import partition as pt
from ..options import Options
from ..types import PreconditionerType, not_ported
from .linear.cgnr import cgnr_solve
from .linear.dense_schur import DenseSchurOps, dense_schur_solve
from .linear.implicit_schur import iterative_schur_solve
from .trust_region import _CandidateMixin, grad_norms


class BlockJacobian(NamedTuple):
    """The Jacobian of one evaluation: the block values [kind][slot]
    (B, r, t), their flat views (B, r*t), and diag(J'J)."""

    values: list
    vflat: tuple
    sqn: torch.Tensor


class BlockTrustRegionKernels(_CandidateMixin):
    """step_solver: "CGNR", "DENSE_SCHUR" or "ITERATIVE_SCHUR"; the Schur
    solvers need e_families (utils/ordering.py)."""

    def __init__(self, program, options: Options, step_solver: str = "CGNR",
                 e_families=None):
        self.program = program
        self.options = options
        self.step_solver = step_solver
        self.meta = bsr.build_meta(program)
        if step_solver in ("DENSE_SCHUR", "ITERATIVE_SCHUR"):
            self.pm = pt.build_partition(self.meta, e_families)
            self.flat = fo.FlatSchurOps(self.pm, program)
            if step_solver == "DENSE_SCHUR":
                self.dense = DenseSchurOps(self.pm, self.flat)
        elif step_solver == "CGNR":
            self.flat = fo.FlatJacobianOps(self.meta, program)
        else:
            raise not_ported(f"the {step_solver} step", 6)
        prec = options.preconditioner_type
        if step_solver == "ITERATIVE_SCHUR":
            if options.use_explicit_schur_complement:
                raise not_ported("use_explicit_schur_complement", 6)
            if prec == PreconditionerType.JACOBI:
                prec = PreconditionerType.SCHUR_JACOBI  # block-diag(S), as JAX's
            self.precond = prec.name
        else:
            # CGNR: block Jacobi of J'J for JACOBI and SCHUR_JACOBI
            self.precond = ("JACOBI" if prec in (PreconditionerType.JACOBI,
                                                 PreconditionerType.SCHUR_JACOBI)
                            else "IDENTITY")

    def eval_full(self, x):
        """(cost, residuals, gradient f64, BlockJacobian, |gradient|,
        max |gradient|)."""
        o = self.program._eval_core(x)
        values, r = o["block_jacs"], o["residuals"]
        vflat = self.flat.flatten(values)
        g, sqn = self.flat.gradient_and_norms(vflat, r)
        g = g.to(torch.float64)
        gnorm, gmax = grad_norms(self.program, x, g)
        return o["cost"], r, g, BlockJacobian(values, vflat, sqn), gnorm, gmax

    @staticmethod
    def jacobi_scale(J: BlockJacobian):
        return 1.0 / (1.0 + torch.sqrt(J.sqn))

    def lm_diagonal(self, J: BlockJacobian, scale):
        """diag((J diag(scale))' (J diag(scale))), clamped."""
        return torch.clamp(scale * scale * J.sqn, self.options.min_lm_diagonal,
                           self.options.max_lm_diagonal)

    def compute_step(self, J: BlockJacobian, residuals, scale, diagonal, radius, fetch):
        """(step, delta = step * scale, model cost change, linear
        iterations) of (J_s'J_s + D^2) y = J_s'r, J_s = J diag(scale),
        D = sqrt(diagonal / radius), step = -y."""
        opts = self.options
        vflat_s = self.flat.scale_columns(J.vflat, scale)
        D = torch.sqrt(diagonal / radius)
        iters = 1
        if self.step_solver == "DENSE_SCHUR":
            y = dense_schur_solve(self.dense, vflat_s, residuals, D)
        elif self.step_solver == "ITERATIVE_SCHUR":
            values_s = [[V.reshape(V.shape[0], J.values[k][s].shape[1], -1)
                         for s, V in enumerate(jacs)] for k, jacs in enumerate(vflat_s)]
            y, res = iterative_schur_solve(
                self.pm, values_s, residuals, D, fetch=fetch, q_tolerance=opts.eta,
                max_num_iterations=opts.max_linear_solver_iterations,
                min_num_iterations=opts.min_linear_solver_iterations,
                preconditioner=self.precond, flat_ops=self.flat)
            iters = res.num_iterations
        else:
            res = cgnr_solve(
                self.flat, vflat_s, residuals, D, fetch=fetch, q_tolerance=opts.eta,
                r_tolerance=-1.0, max_num_iterations=opts.max_linear_solver_iterations,
                min_num_iterations=opts.min_linear_solver_iterations,
                preconditioner=self.precond)
            y, iters = res.x, res.num_iterations
        step = -y
        mr = self.flat.right(vflat_s, step)
        return step, step * scale, -torch.dot(mr, residuals + mr / 2.0), iters

    def right_multiply(self, J: BlockJacobian, v):
        """J v."""
        return self.flat.right(J.vflat, v)

    def left_multiply(self, J: BlockJacobian, u):
        """J'u."""
        return self.flat.left(J.vflat, u)

    def dense_jacobian(self, J: BlockJacobian):
        """The dense (N, tangent) float64 Jacobian, for the dumps."""
        return self.program.dense_jacobian(J.values)
