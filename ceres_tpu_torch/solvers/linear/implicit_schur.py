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
one the functions build their own. Where the JAX module inverts E'E +
D_e^2 and the SCHUR_JACOBI blocks by Cholesky solves, the inverse blocks
are formed once per solve (flatops.spd_inverse_flat, t = 3 in closed
form) and applied as block products.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ...ops import flatops as fo
from ...ops import partition as pt
from ...types import not_ported
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


def iterative_schur_solve(pm: pt.PartitionedMeta, values, b: torch.Tensor, D: torch.Tensor, *,
                          fetch: Callable, q_tolerance: float, max_num_iterations: int = 500,
                          min_num_iterations: int = 0, preconditioner: str = "SCHUR_JACOBI",
                          flat_ops=None):
    """Eliminate, PCG on S, back-substitute
    (iterative_schur_complement_solver.cc:64). Returns (y in the global
    tangent layout, CGResult). SCHUR_JACOBI or IDENTITY; the others raise
    naming the slice that brings them."""
    if preconditioner not in ("SCHUR_JACOBI", "IDENTITY"):
        raise not_ported(f"ITERATIVE_SCHUR with preconditioner {preconditioner}", 6)
    D_e = pt.extract_e(pm, D)
    D_f = pt.extract_f(pm, D)
    sys = build_schur_system(pm, values, b, D_e, flat_ops)
    fl = sys.flat

    def lhs(z):
        return fl.schur_multiply(sys.vflat, sys.minv, D_f, z)

    precond = None
    if preconditioner == "SCHUR_JACOBI":
        invs = [fo.spd_inverse_flat(blk, t) for blk, (_, _, t, _) in zip(
            fl.schur_jacobi_blocks(sys.vflat, sys.minv, D_f), pm.f_fams)]

        def precond(v):
            return fl.apply_inverse_rows(pm.f_fams, invs, v)

    res: CGResult = conjugate_gradients(
        lhs, sys.rhs, torch.zeros_like(sys.rhs), precond, fetch=fetch,
        min_num_iterations=min_num_iterations, max_num_iterations=max_num_iterations,
        residual_reset_period=10, r_tolerance=-1.0, q_tolerance=q_tolerance)
    y = back_substitute(pm, values, sys, res.x)
    return pt.combine(pm, y, res.x), res
