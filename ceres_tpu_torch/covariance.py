"""Covariance: blocks of (J'J)^{-1} after a solve (counterpart of
ceres_tpu/covariance.py; covariance.h:202, covariance_impl.cc).

The algorithms, as the JAX package runs them:

 - DENSE_SVD: the pseudo-inverse from the SVD of the dense Jacobian, with
   the min_reciprocal_condition_number and null_space_rank rules
   (covariance_impl.cc's DENSE_SVD branch). J is evaluated on the
   program's device, the SVD runs on the host.
 - SPARSE_QR: a QR of J itself, so the conditioning is that of J and not
   of J'J (covariance_impl.cc:539). R is accumulated from J's CSR rows by
   row-Givens with sparse R rows (native/sparse_qr.cc) after an AMD
   ordering of the A'A pattern; the requested columns of R^{-1} R^{-T} come
   from two triangular solves each. J's blocks are evaluated on the device
   and their triplets assembled on the host.
 - The Schur tail (SPARSE_QR where an eligible e/f partition has a camera
   core of at least `schur_tail_min_cols` columns): with the columns
   ordered [e | f], R_cc'R_cc = S, the Schur complement, exactly. S is
   assembled on the card by the flat dense-Schur step
   (solvers/fused_lm.FlatDenseSchurStepOps: rows 6, 7, 8 and 9) at scale 1
   and D = 0, symmetrized and factored there by torch.linalg.cholesky;
   R_cc goes to the host, where the row-Givens factor only the e columns.
 - use_normal_equations: the Cholesky of J'J (its values by the
   inner-product computer on the card, rows 6 and 7; the factorization and
   the column solves by the native Cholesky on the host). It squares the
   condition number.

A rank test on R's (or L's) diagonal makes `compute` return False where
the JAX package's does. Blocks of a manifold are computed in its tangent
space and lifted to the ambient one by the PlusJacobian unless
lift_to_ambient=False (covariance_impl.cc:132). Results are numpy arrays.
`stats` holds the last compute's path and its host and device seconds.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .problem import Problem
from .program import CompiledProgram, resolve_device
from .types import CovarianceAlgorithmType


@dataclasses.dataclass
class CovarianceOptions:
    """covariance.h Covariance::Options, with the JAX package's two
    extensions."""

    algorithm_type: CovarianceAlgorithmType = CovarianceAlgorithmType.SPARSE_QR
    min_reciprocal_condition_number: float = 1e-14
    null_space_rank: int = 0
    apply_loss_function: bool = True
    num_threads: int = 1  # API parity
    # the Cholesky of J'J in place of the QR of J: much faster, but it
    # squares the condition number
    use_normal_equations: bool = False
    # SPARSE_QR: the camera core's R from chol(S) on the card when an
    # eligible partition's core is at least this wide; <= 0 disables it
    schur_tail_min_cols: int = 512


def _rank_deficient(d: np.ndarray, rcond: float) -> bool:
    """True where the smallest squared pivot is at most rcond times the
    largest (covariance_impl.cc's reciprocal-condition test)."""
    d2 = d * d
    return (d2.min() if d2.size else 0.0) <= rcond * (d2.max() if d2.size else 1.0)


class Covariance:
    def __init__(self, options: Optional[CovarianceOptions] = None):
        self.options = options or CovarianceOptions()
        self._cov = None
        self._program = None
        self._block_info = None
        self.stats = {}

    def compute(self, covariance_blocks: Sequence[Tuple], problem: Problem,
                device=None) -> bool:
        """Computes the requested columns of the tangent-space covariance
        once (Covariance::Compute); blocks are read out of them afterwards.
        Evaluates on the card unless device="cpu"."""
        dev = resolve_device(device)
        o = self.options
        t0 = time.perf_counter()
        prog = CompiledProgram.cached(problem, apply_loss=o.apply_loss_function,
                                      sort_rows=True, device=dev)
        self._program = prog
        self.stats = {"device": str(dev), "program_s": time.perf_counter() - t0}
        x = prog.initial_state()
        if o.algorithm_type == CovarianceAlgorithmType.DENSE_SVD:
            self._dense_svd(prog, x)
        elif not self._compute_sparse(prog, x, covariance_blocks):
            return False
        self._block_info = {}
        for fam in prog.families:
            for i, b in enumerate(fam.blocks[:fam.num_var]):
                self._block_info[id(b)] = (fam.tangent_offset + i * fam.tsize, fam.tsize, b)
        self._requested = covariance_blocks
        return True

    def _dense_svd(self, prog, x):
        o = self.options
        t0 = time.perf_counter()
        J = prog.evaluate_dense(x)[3].cpu().numpy()
        t1 = time.perf_counter()
        _, s, Vt = np.linalg.svd(J, full_matrices=False)
        # singular values of J; the eigenvalues of J'J are s^2
        if o.null_space_rank < 0:
            keep = s > 0
        elif o.null_space_rank == 0:
            max_s = s[0] if s.size else 0.0
            keep = (s * s) > o.min_reciprocal_condition_number * max_s * max_s
        else:
            keep = np.ones_like(s, dtype=bool)
            keep[len(s) - o.null_space_rank:] = False
        inv = np.where(keep, 1.0 / np.maximum(s * s, 1e-300), 0.0)
        self._cov = (Vt.T * inv[None, :]) @ Vt
        self.stats.update(path="dense_svd", evaluate_s=t1 - t0,
                          host_s=time.perf_counter() - t1)

    def _compute_sparse(self, prog, x, covariance_blocks) -> bool:
        """SPARSE_QR (or the normal equations): the requested columns of
        (J'J)^{-1} by two triangular solves each."""
        T = prog.tangent_size
        t0 = time.perf_counter()
        out = prog._eval_core(x)
        vflat = tuple(tuple(J.reshape(J.shape[0], -1) for J in jacs)
                      for jacs in out["block_jacs"])
        self.stats["evaluate_s"] = time.perf_counter() - t0
        if self.options.use_normal_equations:
            solver = self._normal_equation_solver(prog, vflat)
        else:
            solver = self._qr_solver(prog, vflat)
        if solver is None:
            return False
        solve_cols, close = solver
        # the columns of every block named in covariance_blocks (symmetry
        # covers (i, j) against (j, i)); all of them if none is named
        offsets = {}
        for fam in prog.families:
            for i, b in enumerate(fam.blocks[:fam.num_var]):
                offsets[id(b)] = (fam.tangent_offset + i * fam.tsize, fam.tsize)
        cols: List[int] = []
        if covariance_blocks:
            seen = set()
            for pair in covariance_blocks:
                for v in pair:
                    info = offsets.get(id(prog.problem.parameter_block_for(v)))
                    if info is None:
                        continue  # a constant block
                    if info[0] not in seen:
                        seen.add(info[0])
                        cols.extend(range(info[0], info[0] + info[1]))
            cols = sorted(cols)
        else:
            cols = list(range(T))
        E = np.zeros((T, len(cols)))
        E[cols, np.arange(len(cols))] = 1.0
        t0 = time.perf_counter()
        try:
            sol = solve_cols(E)  # (T, k) columns of (J'J)^{-1}
        finally:
            close()  # the QR's factor is the library's global state
        self.stats.update(solve_s=time.perf_counter() - t0, columns=len(cols))
        if len(cols) == T:
            self._cov = sol
        else:
            self._cov = None
            self._cov_cols = sol
            self._colmap = {c: k for k, c in enumerate(cols)}
        return True

    def _normal_equation_solver(self, prog, vflat):
        """(solve(E), close) from the Cholesky of J'J, or None where it is
        rank deficient."""
        from . import native
        from .ops import bsr
        from .ops.inner_product import InnerProductComputer

        t0 = time.perf_counter()
        ipc = InnerProductComputer(bsr.build_meta(prog), prog.device)
        vals = ipc.compute(vflat).to("cpu", torch.float64).numpy()
        t1 = time.perf_counter()
        chol = native.SparseCholesky(ipc.n, ipc.indptr, ipc.indices)
        ok = chol.factorize(vals)
        self.stats.update(path="normal_equations", inner_product_s=t1 - t0,
                          factor_s=time.perf_counter() - t1)
        if not ok:
            return None  # rank deficient: the reference returns failure
        dl = np.abs(chol.Lx[chol.Lp[:-1]])  # pivots of J'J ~ the squared diagonal of R
        if _rank_deficient(dl, self.options.min_reciprocal_condition_number):
            return None
        return chol.solve_multi, lambda: None

    def _qr_solver(self, prog, vflat):
        """(solve(E) = R^{-1} R^{-T} E, close) from the sparse QR of J, or
        None where R is rank deficient."""
        from . import native
        from .ops import bsr

        T = prog.tangent_size
        t0 = time.perf_counter()
        meta = bsr.build_meta(prog)
        # J's CSR triplets; a constant block's column (T) is dropped, and the
        # row order does not matter to R
        trip_r, trip_c, trip_v, pat_enc = [], [], [], []
        for kind, jacs in zip(meta.kinds, vflat):
            cols = np.concatenate([bsr._block_columns(meta, s) for s in kind.slots],
                                  axis=1)  # (B, m)
            data = np.concatenate(
                [J.to("cpu", torch.float64).numpy().reshape(kind.B, kind.r, -1)
                 for J in jacs], axis=2)  # (B, r, m)
            B, r, m = data.shape
            rowids = (kind.row_offset + np.arange(B * r)).reshape(B, r)
            rr = np.broadcast_to(rowids[:, :, None], (B, r, m))
            cc = np.broadcast_to(cols[:, None, :], (B, r, m))
            keep = cc < T
            trip_r.append(rr[keep])
            trip_c.append(cc[keep])
            trip_v.append(data[keep])
            ii = np.broadcast_to(cols[:, :, None], (B, m, m))
            jj = np.broadcast_to(cols[:, None, :], (B, m, m))
            kp = (ii < T) & (jj < T)
            pat_enc.append(ii[kp].astype(np.int64) * T + jj[kp])
        if not trip_r:
            return None
        rows = np.concatenate(trip_r)
        colsA = np.concatenate(trip_c).astype(np.int64)
        vals = np.concatenate(trip_v)
        self.stats["triplets_s"] = time.perf_counter() - t0

        tail = self._schur_tail_solver(prog, vflat, rows, colsA, vals)
        if tail is not None:
            return tail

        # minimum degree on the A'A pattern, the QR's fill-reducing
        # pre-ordering (the JAX package's AMD role), over supervariables
        t0 = time.perf_counter()
        perm = np.arange(T, dtype=np.int32)
        if T > 2:
            enc = np.unique(np.concatenate(pat_enc))
            pi = (enc // T).astype(np.int32)
            pj = (enc % T).astype(np.int32)
            indptr_p = np.zeros(T + 1, np.int64)
            np.cumsum(np.bincount(pi, minlength=T), out=indptr_p[1:])
            perm = native.minimum_degree_ordering(T, indptr_p, pj)
        self.stats["ordering_s"] = time.perf_counter() - t0
        return self._factor(prog, perm.astype(np.int64), rows, colsA, vals, "qr")

    def _factor(self, prog, perm, rows, colsA, vals, path, split=None, Rcc=None):
        """The QR of J with its columns in the order perm (new -> old): the
        row-Givens over all columns, or over [0, split) with Rcc installed
        as the trailing block. (solve, close), or None where R is rank
        deficient."""
        from . import native

        t0 = time.perf_counter()
        iperm = np.argsort(perm).astype(np.int64)  # old column -> new
        newc = iperm[colsA]
        order = np.lexsort((newc, rows))
        rows_s, cols_s, vals_s = rows[order], newc[order], vals[order]
        nrows = int(prog.num_residuals)
        indptr = np.zeros(nrows + 1, np.int64)
        np.cumsum(np.bincount(rows_s, minlength=nrows), out=indptr[1:])
        qr = native.SparseQR(nrows, prog.tangent_size, indptr, cols_s.astype(np.int32),
                             vals_s, schur_tail_split=split)
        if Rcc is not None:
            qr.set_dense(Rcc)
        d = qr.diag()
        self.stats.update(path=path, factor_s=time.perf_counter() - t0,
                          qr_native_s=qr.factor_s, nnz_R=qr.nnz_R)
        if _rank_deficient(d, self.options.min_reciprocal_condition_number):
            qr.free()
            return None  # rank deficient (QR rank < columns: failure)

        def solve(E):
            Ep = np.asarray(E, np.float64)[perm, :]
            return qr.solve_normal_multi(Ep)[iperm, :]

        return solve, qr.free

    def _schur_tail_solver(self, prog, vflat, rows, colsA, vals):
        """The hybrid QR: row-Givens on the e columns, R_cc = chol(S)' from
        the Schur complement assembled on the program's device. Exact: with
        the columns ordered [e | f], R_ec = R_ee^{-T} H_ec, so
        R_cc'R_cc = H_cc - H_ce H_ee^{-1} H_ec = S. None where the
        structure does not qualify or S is not positive definite (the pure
        QR runs then), as in the JAX package."""
        from .ops import bsr
        from .ops import partition as pt
        from .options import Options
        from .solvers.fused_lm import FlatDenseSchurStepOps, FlatForm
        from .types import LinearSolverType
        from .utils import ordering as om

        T = prog.tangent_size
        min_core = self.options.schur_tail_min_cols
        if min_core <= 0:
            return None
        try:
            e_sets = om.eligible_e_sets(prog)
            if not e_sets:
                return None
            pm = pt.build_partition(bsr.build_meta(prog), e_sets)
            if pm.f_size < min_core or pm.e_size == 0 or pm.e_size + pm.f_size != T:
                return None
            ops = FlatDenseSchurStepOps(
                prog, Options(linear_solver_type=LinearSolverType.DENSE_SCHUR), e_sets)
        except (ValueError, KeyError):
            return None
        pm = ops.pm

        def span(fi):
            fam = pm.base.families[fi]
            return np.arange(fam.tangent_offset, fam.tangent_offset + fam.num_var * fam.t)

        perm = np.concatenate([span(fi) for fi in pm.e_family_indices]
                              + [span(fi) for fi in pm.f_family_indices]).astype(np.int64)

        # S (f_size x f_size) at scale 1 and D = 0 (schur_complement_solver.cc:101)
        t0 = time.perf_counter()
        zeros_r = torch.zeros((prog.num_residuals,), dtype=torch.float64, device=prog.device)
        _, _, ete = ops.flat.fused_post_eval_e(vflat, zeros_r)
        _, _, ftf = ops.flat.fused_post_eval_f(vflat, zeros_r)
        ones_c = torch.ones((T,), dtype=torch.float64, device=prog.device)
        _, _, S = ops._assemble(FlatForm(vflat, zeros_r), (ete, ftf), ones_c,
                                torch.zeros_like(ones_c))
        # symmetrized as jnp.linalg.cholesky symmetrizes its input
        asym = (S - S.T).abs().max() / S.abs().max().clamp_min(1e-300)
        S = 0.5 * (S + S.T)
        L, info = torch.linalg.cholesky_ex(S)
        L = L.cpu().numpy()
        self.stats.update(schur_s=time.perf_counter() - t0, schur_columns=pm.f_size,
                          schur_asymmetry=float(asym))
        if int(info) != 0 or not np.all(np.isfinite(L)):
            return None  # a semidefinite core: the full QR runs
        return self._factor(prog, perm, rows, colsA, vals, "schur_tail", split=pm.e_size,
                            Rcc=np.ascontiguousarray(L.T))

    # -------------------------------------------------------------- results

    def _cov_block(self, o1, t1, o2, t2) -> np.ndarray:
        if self._cov is not None:
            return self._cov[o1:o1 + t1, o2:o2 + t2]
        m = self._colmap
        if all((o2 + j) in m for j in range(t2)):
            return self._cov_cols[o1:o1 + t1][:, [m[o2 + j] for j in range(t2)]]
        if all((o1 + j) in m for j in range(t1)):
            return self._cov_cols[o2:o2 + t2][:, [m[o1 + j] for j in range(t1)]].T
        raise KeyError("covariance block was not in the covariance_blocks passed to compute()")

    def _resolve(self, values):
        blk = self._program.problem.parameter_block_for(values)
        info = self._block_info.get(id(blk))
        if info is None:
            raise KeyError("parameter block is constant or not in the program")
        return info

    @staticmethod
    def _plus_jacobian(b) -> np.ndarray:
        return b.effective_manifold().plus_jacobian(
            torch.as_tensor(b.values, dtype=torch.float64)).numpy()

    def get_covariance_block(self, x1, x2, lift_to_ambient: bool = True) -> np.ndarray:
        """The covariance block of (x1, x2): ambient (lifted) by default, as
        GetCovarianceBlock; in the tangent space with lift_to_ambient=False
        (GetCovarianceBlockInTangentSpace)."""
        o1, t1, b1 = self._resolve(x1)
        o2, t2, b2 = self._resolve(x2)
        C = self._cov_block(o1, t1, o2, t2)
        if not lift_to_ambient:
            return C
        if b1.manifold is not None:
            C = self._plus_jacobian(b1) @ C
        if b2.manifold is not None:
            C = C @ self._plus_jacobian(b2).T
        return C

    def get_covariance_matrix(self, blocks: Sequence, lift_to_ambient: bool = False):
        """The dense joint covariance of a list of blocks
        (GetCovarianceMatrixInTangentOrAmbientSpace)."""
        infos = [self._resolve(b) for b in blocks]
        if self._cov is not None:
            idx = np.concatenate([np.arange(o, o + t) for o, t, _ in infos])
            C = self._cov[np.ix_(idx, idx)]
        else:
            C = np.block([[self._cov_block(o1, t1, o2, t2) for (o2, t2, _) in infos]
                          for (o1, t1, _) in infos])
        if lift_to_ambient:
            import scipy.linalg as sl

            P = sl.block_diag(*[self._plus_jacobian(b) if b.manifold is not None
                                else np.eye(t) for _, t, b in infos])
            C = P @ C @ P.T
        return C
