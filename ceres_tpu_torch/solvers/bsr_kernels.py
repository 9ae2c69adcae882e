"""The block-sparse trust-region kernels of the host loop (counterpart of
ceres_tpu/solvers/bsr_kernels.py:62): the entry points of
DenseTrustRegionKernels (solvers/trust_region.py) over the block
Jacobian, for CGNR (JACOBI, IDENTITY, or SUBSET with its residual
blocks), DENSE_SCHUR, ITERATIVE_SCHUR (implicit, SCHUR_JACOBI or
IDENTITY), SPARSE_NORMAL_CHOLESKY (static, dynamic sparsity, mixed
precision) and SPARSE_SCHUR.

The evaluation is the plain one (`program._eval_core`), as the JAX host
loop's; its gradient and column norms, every product of the steps and the
model cost change run through the flat ops of ops/flatops.py on the
blocks flattened once per evaluation, as the JAX code takes its flat route
(bsr_kernels.py:229, :347): FlatSchurOps for the Schur solvers,
FlatJacobianOps for CGNR and SPARSE_NORMAL_CHOLESKY. On the card they
launch segment_block_expand (kernel 7) for every gather,
segment_block_sum (kernel 6) for the sorted point ids,
unsorted_segment_sum (kernel 9) for the camera ids, and on a BAL-shaped
program CGNR's product is normal_matvec (kernel 4). The DENSE_SCHUR step
sums the blocks of its reduced system by segment_block_sum (kernel 6)
over the pair plans of solvers/linear/dense_schur.DenseSchurOps, built
with the program's; the sparse steps form the values of J'J or S the same
way (ops/inner_product.py) and factor them on the host
(ceres_tpu_torch/native), bringing the values to the host through the
minimizer's counted `to_host`; SUBSET's preconditioner is applied on the
host once per CG iteration. Where a sparse factorization fails the step
is NaN, as the JAX package's, and the loop counts it invalid. As in the
JAX host loop, SUBSET runs as IDENTITY on ITERATIVE_SCHUR and on CGNR
without its residual blocks, and CGNR runs the power series and the
cluster preconditioners as IDENTITY. With use_explicit_schur_complement,
S is formed on the card as SPARSE_SCHUR forms it (float64) and CG runs
over it (sparse_schur.CSRMatvec: kernels 7 and 6) with SCHUR_JACOBI,
whatever preconditioner is asked for, as the JAX host loop runs it
(bsr_kernels.py:128-168). The cluster preconditioners' clusters are
formed once, with the kernels (preconditioners.build_cluster).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import bsr
from ..ops import flatops as fo
from ..ops import partition as pt
from ..options import Options
from ..types import PreconditionerType
from .linear.cg import conjugate_gradients, conjugate_gradients_host
from .linear.cgnr import cgnr_solve
from .linear.dense_schur import DenseSchurOps, dense_schur_solve
from .linear.implicit_schur import (back_substitute, build_schur_system,
                                    iterative_schur_solve, make_schur_jacobi_preconditioner)
from .linear.preconditioners import SubsetPreconditioner, build_cluster
from .linear.sparse_normal import SparseNormalCholeskySolver
from .linear.sparse_schur import SparseSchurSolver
from .trust_region import _CandidateMixin, grad_norms


class BlockJacobian(NamedTuple):
    """The Jacobian of one evaluation: the block values [kind][slot]
    (B, r, t), their flat views (B, r*t), and diag(J'J)."""

    values: list
    vflat: tuple
    sqn: torch.Tensor


class BlockTrustRegionKernels(_CandidateMixin):
    """step_solver: "CGNR", "DENSE_SCHUR", "ITERATIVE_SCHUR",
    "SPARSE_NORMAL_CHOLESKY" or "SPARSE_SCHUR"; the Schur solvers need
    e_families (utils/ordering.py). The minimizer that drives it lends its
    counted transfer to the host as `to_host`."""

    def __init__(self, program, options: Options, step_solver: str = "CGNR",
                 e_families=None):
        self.program = program
        self.options = options
        self.step_solver = step_solver
        self.meta = bsr.build_meta(program)
        self.to_host = None
        self.subset = None
        self.explicit = (step_solver == "ITERATIVE_SCHUR"
                         and options.use_explicit_schur_complement)
        self.cluster_structure = self.cluster_assembler = None
        prec = options.preconditioner_type
        if step_solver in ("DENSE_SCHUR", "ITERATIVE_SCHUR", "SPARSE_SCHUR"):
            self.pm = pt.build_partition(self.meta, e_families)
            self.flat = fo.FlatSchurOps(self.pm, program)
            if step_solver == "DENSE_SCHUR":
                self.dense = DenseSchurOps(self.pm, self.flat)
            elif step_solver == "SPARSE_SCHUR" or self.explicit:
                self.sparse = SparseSchurSolver(self.pm, self.flat, factor=not self.explicit)
                self.matvec = self.sparse.csr_matvec_fn() if self.explicit else None
        elif step_solver in ("CGNR", "SPARSE_NORMAL_CHOLESKY"):
            self.flat = fo.FlatJacobianOps(self.meta, program)
            if step_solver == "SPARSE_NORMAL_CHOLESKY":
                self.sparse = SparseNormalCholeskySolver(
                    self.meta, self.flat, options.use_mixed_precision_solves,
                    options.max_num_refinement_iterations, options.dynamic_sparsity)
            elif (prec == PreconditionerType.SUBSET
                  and options.residual_blocks_for_subset_preconditioner):
                self.subset = SubsetPreconditioner(self.meta, self.flat.device,
                                                   [True] * len(self.meta.kinds))
                self.subset_masks = _subset_masks(
                    program, options.residual_blocks_for_subset_preconditioner)
        else:
            raise ValueError(f"unknown step solver {step_solver!r}")
        if step_solver == "ITERATIVE_SCHUR":
            if prec == PreconditionerType.JACOBI:
                prec = PreconditionerType.SCHUR_JACOBI  # block-diag(S), as JAX's
            if prec == PreconditionerType.SUBSET:
                prec = PreconditionerType.IDENTITY  # none, as the JAX host loop's
            self.precond = prec.name
            if not self.explicit and prec in (PreconditionerType.CLUSTER_JACOBI,
                                              PreconditionerType.CLUSTER_TRIDIAGONAL):
                self.cluster_structure, self.cluster_assembler = build_cluster(
                    self.pm, self.flat, options.visibility_clustering_type,
                    prec == PreconditionerType.CLUSTER_TRIDIAGONAL)
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
        D = sqrt(diagonal / radius), step = -y; a NaN step and model cost
        change where a sparse factorization fails."""
        opts = self.options
        vflat_s = self.flat.scale_columns(J.vflat, scale)
        D = torch.sqrt(diagonal / radius)
        iters = 1
        cg = dict(q_tolerance=opts.eta, max_num_iterations=opts.max_linear_solver_iterations,
                  min_num_iterations=opts.min_linear_solver_iterations)
        if self.step_solver == "DENSE_SCHUR":
            y = dense_schur_solve(self.dense, vflat_s, residuals, D)
        elif self.step_solver in ("SPARSE_SCHUR", "SPARSE_NORMAL_CHOLESKY"):
            y, _ = self.sparse.solve(vflat_s, residuals, D, self.to_host)
            if y is None:
                nan = torch.full((self.meta.tangent_size,), float("nan"),
                                 dtype=torch.float64, device=residuals.device)
                return nan, nan, nan[0], 1
        elif self.explicit:
            y, iters = self._explicit_schur(vflat_s, residuals, D, fetch, cg)
        elif self.step_solver == "ITERATIVE_SCHUR":
            values_s = [[V.reshape(V.shape[0], J.values[k][s].shape[1], -1)
                         for s, V in enumerate(jacs)] for k, jacs in enumerate(vflat_s)]
            y, res = iterative_schur_solve(
                self.pm, values_s, residuals, D, fetch=fetch,
                preconditioner=self.precond, spse_terms=opts.max_num_spse_iterations,
                cluster_assembler=self.cluster_assembler,
                cluster_structure=self.cluster_structure,
                use_spse_initialization=opts.use_spse_initialization,
                spse_init_terms=opts.max_num_spse_iterations, flat_ops=self.flat, **cg)
            iters = res.num_iterations
        elif self.subset is not None:
            y, iters = self._subset_cgnr(vflat_s, residuals, D, fetch, cg)
        else:
            res = cgnr_solve(self.flat, vflat_s, residuals, D, fetch=fetch, r_tolerance=-1.0,
                             preconditioner=self.precond, **cg)
            y, iters = res.x, res.num_iterations
        step = -y
        mr = self.flat.right(vflat_s, step)
        return step, step * scale, -torch.dot(mr, residuals + mr / 2.0), iters

    def _explicit_schur(self, vflat_s, residuals, D, fetch, cg):
        """CG over the explicit S (bsr_kernels.py:128-168): S's CSR values
        formed in float64 by SPARSE_SCHUR's plan, its product by kernels 7
        and 6, SCHUR_JACOBI; the whole step in float64, as S is."""
        pm = self.pm
        vflat = tuple(tuple(V.to(torch.float64) for V in jacs) for jacs in vflat_s)
        b, D = residuals.to(torch.float64), D.to(torch.float64)
        D_e, D_f = pt.extract_e(pm, D), pt.extract_f(pm, D)
        sys = build_schur_system(pm, vflat, b, D_e, self.flat)
        svals = self.sparse.values(vflat, sys.minv, D_f)
        res = conjugate_gradients(
            lambda z: self.matvec(svals, z), sys.rhs, torch.zeros_like(sys.rhs),
            make_schur_jacobi_preconditioner(pm, vflat, sys, D_f), fetch=fetch,
            r_tolerance=-1.0, **cg)
        y_e = back_substitute(pm, vflat, sys, res.x)
        return pt.combine(pm, y_e, res.x), res.num_iterations

    def _subset_cgnr(self, vflat_s, residuals, D, fetch, cg):
        """CGNR preconditioned by SUBSET (bsr_kernels.py:269-325): Q'Q + D^2
        factored on the host, CG with the host apply."""
        masked = tuple(tuple(V * m[:, None] for V in jacs)
                       for jacs, m in zip(vflat_s, self.subset_masks))
        self.subset.update(masked, D, self.to_host)
        fl = self.flat
        kern = fl.make_kernel_matvec(fl.kernel_lanes(vflat_s), torch.ones_like(D))
        if kern is not None:
            def lhs(x):
                return kern(x) + (D * D) * x
        else:
            def lhs(x):
                return fl.normal_multiply(vflat_s, D, x)
        rhs = fl.left(vflat_s, residuals)
        res = conjugate_gradients_host(lhs, rhs, torch.zeros_like(rhs),
                                       self.subset.make_apply(self.to_host), fetch=fetch,
                                       r_tolerance=-1.0, **cg)
        return res.x, res.num_iterations

    def right_multiply(self, J: BlockJacobian, v):
        """J v."""
        return self.flat.right(J.vflat, v)

    def left_multiply(self, J: BlockJacobian, u):
        """J'u."""
        return self.flat.left(J.vflat, u)

    def dense_jacobian(self, J: BlockJacobian):
        """The dense (N, tangent) float64 Jacobian, for the dumps."""
        return self.program.dense_jacobian(J.values)


def _subset_masks(program, rb_ids):
    """Per kind, (B,) 1 for the rows of the residual blocks listed, else 0,
    in the compute dtype on the program's device (bsr_kernels.py:281-287)."""
    keep = set(rb_ids)
    out = []
    for kind in program.kinds:
        if kind.rb_ids is None:
            raise ValueError("the SUBSET preconditioner selects residual blocks added "
                             "one at a time; a batch of residual blocks has no ids")
        m = np.fromiter((i in keep for i in kind.rb_ids.tolist()), bool, kind.B)
        out.append(torch.as_tensor(m, device=program.device).to(program.compute_dtype))
    return out
