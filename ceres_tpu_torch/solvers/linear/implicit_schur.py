"""The implicit Schur complement and the ITERATIVE_SCHUR step (counterpart
of ceres_tpu/solvers/linear/implicit_schur.py;
implicit_schur_complement.{h,cc}, iterative_schur_complement_solver.cc:64,
schur_jacobi_preconditioner.h:78).

    S = F'F + D_f^2 - F'E (E'E + D_e^2)^{-1} E'F

is never formed: each CG iteration runs the four products of
`schur_multiply`. Every product and reduction runs through
ops/flatops.FlatSchurOps: E and F products gather a row's block by
segment_block_expand (kernel 7) and sum by segment_block_sum (kernel 6,
the sorted point ids) or unsorted_segment_sum (kernel 9, the camera ids).
The host loop passes its FlatSchurOps, built once per program; without
one the functions build their own. The step takes every preconditioner
of the JAX function: SCHUR_JACOBI, IDENTITY, the power series and the
cluster ones (preconditioners.py), and the power series' initial guess.
Where the JAX module inverts E'E + D_e^2 and the SCHUR_JACOBI blocks by
Cholesky solves, the inverse blocks
are formed once per solve (flatops.spd_inverse_flat, t = 3 in closed
form) and applied as block products.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ...ops import flatops as fo
from ...ops import partition as pt
from .cg import CGResult, conjugate_gradients


class SchurSystem(NamedTuple):
    """The per-solve state (ImplicitSchurComplement::Init)."""

    minv: list  # per e family (nv, t*t): (E'E + D_e^2)^{-1} blocks
    rhs: torch.Tensor  # F'b - F'E (E'E + D_e^2)^{-1} E'b
    etb: torch.Tensor  # E'b, for the back substitution
    flat: fo.FlatSchurOps
    vflat: tuple  # the values flattened (B, r*t)


def build_schur_system(pm: pt.PartitionedMeta, values, b: torch.Tensor,
                       D_e: torch.Tensor, flat_ops=None) -> SchurSystem:
    fl = flat_ops if flat_ops is not None else fo.FlatSchurOps(pm, b.device)
    vflat = fl.flatten(values)
    minv = fl.inverse_flats(pm.e_fams, fl.block_ete(vflat), D_e)
    etb = fl.left_e(vflat, b)
    tmp = fl.right_e(vflat, fl.minv_apply(minv, etb))
    rhs = fl.left_f(vflat, b - tmp)
    return SchurSystem(minv, rhs, etb, fl, vflat)


def schur_multiply(pm: pt.PartitionedMeta, values, sys: SchurSystem,
                   D_f: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """S z, matrix-free (implicit_schur_complement.cc:106)."""
    return sys.flat.schur_multiply(sys.vflat, sys.minv, D_f, z)


def back_substitute(pm: pt.PartitionedMeta, values, sys: SchurSystem,
                    z: torch.Tensor) -> torch.Tensor:
    """y = (E'E + D_e^2)^{-1} (E'b - E'F z) (the eliminator's BackSubstitute)."""
    fl = sys.flat
    etfz = fl.left_e(sys.vflat, fl.right_f(sys.vflat, z))
    return fl.minv_apply(sys.minv, sys.etb - etfz)


def schur_jacobi_blocks(pm: pt.PartitionedMeta, values, sys: SchurSystem, D_f: torch.Tensor):
    """Per f family (nv, t, t): the diagonal blocks of S (implicit_schur.py:70)."""
    return [blk.reshape(nv, t, t) for blk, (_, nv, t, _) in zip(
        sys.flat.schur_jacobi_blocks(sys.vflat, sys.minv, D_f), pm.f_fams)]


def make_schur_jacobi_preconditioner(pm: pt.PartitionedMeta, values, sys: SchurSystem,
                                     D_f: torch.Tensor):
    """v -> block-diag(S)^{-1} v (implicit_schur.py:160)."""
    fl = sys.flat
    invs = [fo.spd_inverse_flat(blk, t) for blk, (_, _, t, _) in zip(
        fl.schur_jacobi_blocks(sys.vflat, sys.minv, D_f), pm.f_fams)]

    def apply(v):
        return fl.apply_inverse_rows(pm.f_fams, invs, v)

    return apply


def iterative_schur_solve(pm: pt.PartitionedMeta, values, b: torch.Tensor, D: torch.Tensor, *,
                          fetch: Callable, q_tolerance: float, max_num_iterations: int = 500,
                          min_num_iterations: int = 0, preconditioner: str = "SCHUR_JACOBI",
                          spse_terms: int = 5, cluster_assembler=None, cluster_structure=None,
                          use_spse_initialization: bool = False, spse_init_terms: int = 5,
                          flat_ops=None):
    """Eliminate, PCG on S, back-substitute
    (iterative_schur_complement_solver.cc:64, implicit_schur.py:166-235),
    with the preconditioner named (SCHUR_JACOBI, IDENTITY,
    SCHUR_POWER_SERIES_EXPANSION over `spse_terms` terms, CLUSTER_JACOBI or
    CLUSTER_TRIDIAGONAL over `cluster_structure` and `cluster_assembler`)
    and, with use_spse_initialization, CG started from the power series'
    S^{-1} rhs (linear_solver.h:174-183). Returns (y in the global tangent
    layout, CGResult)."""
    from .preconditioners import (make_cluster_preconditioner,
                                  make_cluster_tridiagonal_preconditioner, power_series)

    D_e = pt.extract_e(pm, D)
    D_f = pt.extract_f(pm, D)
    sys = build_schur_system(pm, values, b, D_e, flat_ops)
    fl = sys.flat

    def lhs(z):
        return fl.schur_multiply(sys.vflat, sys.minv, D_f, z)

    p_inv = None
    if preconditioner in ("SCHUR_JACOBI", "SCHUR_POWER_SERIES_EXPANSION") or \
            use_spse_initialization:
        p_inv = make_schur_jacobi_preconditioner(pm, values, sys, D_f)
    precond = None
    if preconditioner == "SCHUR_JACOBI":
        precond = p_inv
    elif preconditioner == "SCHUR_POWER_SERIES_EXPANSION":
        precond = power_series(p_inv, lhs, spse_terms)
    elif preconditioner in ("CLUSTER_JACOBI", "CLUSTER_TRIDIAGONAL"):
        make = (make_cluster_tridiagonal_preconditioner if cluster_structure.chains is not None
                else make_cluster_preconditioner)
        precond = make(cluster_structure, lambda: cluster_assembler(sys.vflat, D_e, D_f))
    x0 = torch.zeros_like(sys.rhs)
    if use_spse_initialization:
        x0 = power_series(p_inv, lhs, spse_init_terms)(sys.rhs)

    res: CGResult = conjugate_gradients(
        lhs, sys.rhs, x0, precond, fetch=fetch,
        min_num_iterations=min_num_iterations, max_num_iterations=max_num_iterations,
        residual_reset_period=10, r_tolerance=-1.0, q_tolerance=q_tolerance)
    y = back_substitute(pm, values, sys, res.x)
    return pt.combine(pm, y, res.x), res
