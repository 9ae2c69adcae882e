// Sparse QR of a CSR matrix by George-Heath row-Givens rotations with
// SPARSE R rows and a DENSE trailing block: the host backend of Covariance
// SPARSE_QR (ceres_tpu_torch/covariance.py), in the role SuiteSparseQR
// plays in Ceres Solver's covariance (internal/ceres/covariance_impl.cc:539).
// The port's own copy of the JAX package's native source, unchanged in its
// algorithm; bound through ctypes (ceres_tpu_torch/native/__init__.py) and
// built with g++ at first use into build/native/<key>/.
//
// Only R is formed (Q is discarded): rows of A are rotated into an
// upper-triangular R held as per-row sparse (index, value) vectors, so the
// cost is bounded by R's fill, not by a dense T x T update. A
// fill-reducing column pre-ordering (AMD on the A'A pattern) is the
// caller's job: this file factors the matrix it is given.
//
// Dense trailing block: under any fill-reducing ordering the last columns
// form a (near-)dense clique (the root supernode); merging sparse rows
// through it costs |row|^2 per insertion. When a column k with
// (ncols - k) <= DENSE_MAX sees a sparse R row at >= 1/4 density, columns
// [k, ncols) switch to a dense upper-triangular buffer and subsequent
// rows reaching the region insert via contiguous (vectorizable) Givens
// updates: the scalar-frontier/dense-core split of multifrontal QR.
//
// State model: one factorization lives in module-global storage between
// ct_qr_factor and ct_qr_free (single-threaded host use, matching the
// binding's one-live-factor rule). Solves run directly against the
// stored factor: R'y = b forward (scatter form), R x = y backward (row
// dot form), O(nnz(R)) per right-hand side.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t DENSE_MAX = 8192;  // widest dense trailing block (512 MB)

struct SparseRow {
  std::vector<int32_t> idx;  // sorted, idx[0] == row number (the diagonal)
  std::vector<double> val;
};

std::vector<SparseRow> g_R;  // rows < g_split; empty == structurally zero
int32_t g_ncols = 0;
int32_t g_split = 0;           // dense region start column (== ncols: none)
std::vector<double> g_D;       // dense rows, (ncols-g_split)^2 row-major
std::vector<uint8_t> g_Dused;  // dense row occupancy
int32_t g_discard = 0;         // Schur-tail mode: drop dense-region rows
int64_t g_rot = 0, g_ops = 0;  // diagnostics: rotations, merge work

// Rotate sparse row `w` (indices >= k sorted, w.idx[0] == k) against R[k]
// (same leading index). Produces the updated R[k] (c*Rk + s*w) and the
// remainder of w (-s*Rk + c*w with index k eliminated). Single merge pass.
void givens_merge(SparseRow& Rk, std::vector<int32_t>& widx,
                  std::vector<double>& wval) {
  g_rot++;
  g_ops += Rk.idx.size() + widx.size();
  const double a = Rk.val[0];
  const double b = wval[0];
  const double r = std::sqrt(a * a + b * b);
  const double c = a / r, s = b / r;

  static thread_local std::vector<int32_t> nidx_r, nidx_w;
  static thread_local std::vector<double> nval_r, nval_w;
  nidx_r.clear(); nval_r.clear();
  nidx_w.clear(); nval_w.clear();
  const size_t nr = Rk.idx.size(), nw = widx.size();
  nidx_r.reserve(nr + nw); nval_r.reserve(nr + nw);
  nidx_w.reserve(nr + nw); nval_w.reserve(nr + nw);

  size_t i = 0, j = 0;
  nidx_r.push_back(Rk.idx[0]);
  nval_r.push_back(r);
  ++i; ++j;
  while (i < nr || j < nw) {
    int32_t ci = i < nr ? Rk.idx[i] : INT32_MAX;
    int32_t cj = j < nw ? widx[j] : INT32_MAX;
    if (ci < cj) {
      nidx_r.push_back(ci); nval_r.push_back(c * Rk.val[i]);
      nidx_w.push_back(ci); nval_w.push_back(-s * Rk.val[i]);
      ++i;
    } else if (cj < ci) {
      nidx_r.push_back(cj); nval_r.push_back(s * wval[j]);
      nidx_w.push_back(cj); nval_w.push_back(c * wval[j]);
      ++j;
    } else {
      double rv = c * Rk.val[i] + s * wval[j];
      double wv = -s * Rk.val[i] + c * wval[j];
      nidx_r.push_back(ci); nval_r.push_back(rv);
      if (wv != 0.0) { nidx_w.push_back(ci); nval_w.push_back(wv); }
      ++i; ++j;
    }
  }
  Rk.idx.swap(nidx_r);
  Rk.val.swap(nval_r);
  widx.swap(nidx_w);
  wval.swap(nval_w);
}

// Insert the dense vector wd (length m = ncols - g_split, leading nonzero
// at local index l) into the dense triangular block by contiguous Givens.
void dense_insert(double* wd, int32_t l) {
  const int32_t m = g_ncols - g_split;
  for (int32_t k = l; k < m; ++k) {
    if (wd[k] == 0.0) continue;
    double* Dk = g_D.data() + (int64_t)k * m;
    if (!g_Dused[k]) {
      std::memcpy(Dk + k, wd + k, (m - k) * sizeof(double));
      g_Dused[k] = 1;
      return;
    }
    const double a = Dk[k], b = wd[k];
    const double r = std::sqrt(a * a + b * b);
    const double c = a / r, s = b / r;
    g_rot++;
    g_ops += m - k;
    Dk[k] = r;
    wd[k] = 0.0;
    for (int32_t j = k + 1; j < m; ++j) {
      const double dv = Dk[j], wv = wd[j];
      Dk[j] = c * dv + s * wv;
      wd[j] = c * wv - s * dv;
    }
  }
}

// Activate the dense region at column s, or EXTEND it leftward if one
// already exists at g_split > s (the density trigger can fire again for
// a column left of the current region — the old block's contents shift
// into the wider buffer). Existing sparse rows in [s, old split) migrate.
void activate_dense(int32_t s) {
  const int32_t old_split = g_split;
  const int32_t m_new = g_ncols - s;
  std::vector<double> Dn((int64_t)m_new * m_new, 0.0);
  std::vector<uint8_t> Un(m_new, 0);
  if (old_split < g_ncols) {
    const int32_t m_old = g_ncols - old_split;
    const int32_t d = old_split - s;
    for (int32_t k = 0; k < m_old; ++k) {
      if (!g_Dused[k]) continue;
      std::memcpy(Dn.data() + (int64_t)(k + d) * m_new + (k + d),
                  g_D.data() + (int64_t)k * m_old + k,
                  (m_old - k) * sizeof(double));
      Un[k + d] = 1;
    }
  }
  g_D.swap(Dn);
  g_Dused.swap(Un);
  g_split = s;
  for (int32_t k = s; k < old_split; ++k) {
    SparseRow& r = g_R[k];
    if (r.idx.empty()) continue;
    double* Dk = g_D.data() + (int64_t)(k - s) * m_new;
    for (size_t p = 0; p < r.idx.size(); ++p) Dk[r.idx[p] - s] = r.val[p];
    g_Dused[k - s] = 1;
    SparseRow{}.idx.swap(r.idx);
    SparseRow{}.val.swap(r.val);
  }
}

}  // namespace

extern "C" {

void ct_qr_stats(int64_t* out) {
  out[0] = g_rot;
  out[1] = g_ops;
  out[2] = g_split;
}

// Factor the nrows x ncols CSR matrix (indptr int64[nrows+1], indices
// int32[nnz] sorted within each row, data f64[nnz]); zero-valued entries
// are skipped. Returns nnz(R) (>= 0) on success. split0 < ncols forces
// the dense region at split0 from the start; discard drops dense-region
// remainders (Schur-tail mode, see ct_qr_factor_split).
static int64_t factor_impl(int32_t nrows, int32_t ncols,
                           const int64_t* indptr, const int32_t* indices,
                           const double* data, int32_t split0,
                           int32_t discard) {
  g_R.assign(ncols, SparseRow{});
  g_ncols = ncols;
  g_split = ncols;
  g_discard = discard;
  g_D.clear();
  g_Dused.clear();
  g_rot = g_ops = 0;
  if (split0 < ncols) {
    const int32_t m = ncols - split0;
    g_split = split0;
    g_D.assign((int64_t)m * m, 0.0);
    g_Dused.assign(m, 0);
  }
  // George & Heath row ordering: process rows by ascending leading column
  // (bucket sort) — keeps intermediate fill low.
  std::vector<int32_t> lead(nrows);
  std::vector<int64_t> bucket(ncols + 2, 0);
  for (int32_t row = 0; row < nrows; ++row) {
    int32_t l = ncols;  // empty-row sentinel
    for (int64_t p = indptr[row]; p < indptr[row + 1]; ++p) {
      if (data[p] != 0.0) { l = indices[p]; break; }
    }
    lead[row] = l;
    ++bucket[l + 1];
  }
  for (int32_t k = 0; k <= ncols; ++k) bucket[k + 1] += bucket[k];
  std::vector<int32_t> order(nrows);
  {
    std::vector<int64_t> pos(bucket.begin(), bucket.end());
    for (int32_t row = 0; row < nrows; ++row) order[pos[lead[row]]++] = row;
  }
  std::vector<int32_t> widx;
  std::vector<double> wval;
  std::vector<double> wd;
  for (int32_t oi = 0; oi < nrows; ++oi) {
    const int32_t row = order[oi];
    if (lead[row] == ncols) continue;  // all-zero row
    widx.clear();
    wval.clear();
    for (int64_t p = indptr[row]; p < indptr[row + 1]; ++p) {
      if (data[p] != 0.0) {
        widx.push_back(indices[p]);
        wval.push_back(data[p]);
      }
    }
    while (!widx.empty()) {
      int32_t k = widx[0];
      if (k >= g_split) {
        if (g_discard) break;  // Schur-tail mode: R_cc comes from chol(S)
        // hand the remainder to the dense trailing block
        const int32_t m = g_ncols - g_split;
        wd.assign(m, 0.0);
        for (size_t p = 0; p < widx.size(); ++p)
          wd[widx[p] - g_split] = wval[p];
        dense_insert(wd.data(), k - g_split);
        break;
      }
      SparseRow& Rk = g_R[k];
      if (Rk.idx.empty()) {
        Rk.idx = widx;
        Rk.val = wval;
        break;
      }
      // Root-supernode switch: a dense-ish sparse row this deep means
      // every later merge here pays |row|^2 — flip to the dense block.
      const int32_t rem = g_ncols - k;
      if (!g_discard && rem <= DENSE_MAX &&
          (int32_t)Rk.idx.size() >= (rem >> 2) + 8) {
        activate_dense(k);
        continue;  // re-dispatch this row into the dense path
      }
      givens_merge(Rk, widx, wval);
    }
  }
  int64_t nnz = 0;
  for (const auto& r : g_R) nnz += static_cast<int64_t>(r.idx.size());
  if (g_split < g_ncols) {
    const int32_t m = g_ncols - g_split;
    for (int32_t k = 0; k < m; ++k)
      if (g_Dused[k]) nnz += m - k;
  }
  return nnz;
}

int64_t ct_qr_factor(int32_t nrows, int32_t ncols, const int64_t* indptr,
                     const int32_t* indices, const double* data) {
  return factor_impl(nrows, ncols, indptr, indices, data, ncols, 0);
}

// |R[k,k]| per column; 0.0 where the row is structurally empty (rank
// deficiency marker for the caller's reciprocal-condition check).
void ct_qr_diag(double* d) {
  const int32_t m = g_ncols - g_split;
  for (int32_t k = 0; k < g_split; ++k)
    d[k] = g_R[k].idx.empty() ? 0.0 : std::fabs(g_R[k].val[0]);
  for (int32_t k = 0; k < m; ++k)
    d[g_split + k] =
        g_Dused[k] ? std::fabs(g_D[(int64_t)k * m + k]) : 0.0;
}

// Solve (R'R) X = B for k right-hand sides: forward R'y = b (scatter
// form over R's rows), then backward R x = y (row-dot form). B and X are
// (ncols, k) row-major; B is preserved.
int32_t ct_qr_solve_multi(int32_t k, const double* B, double* X) {
  const int32_t n = g_ncols;
  const int32_t m = n - g_split;
  std::vector<double> y(n);
  for (int32_t c = 0; c < k; ++c) {
    for (int32_t i = 0; i < n; ++i) y[i] = B[(int64_t)i * k + c];
    // forward: R' y = b
    for (int32_t j = 0; j < g_split; ++j) {
      const SparseRow& r = g_R[j];
      if (r.idx.empty()) return -1;
      double v = y[j] / r.val[0];
      y[j] = v;
      for (size_t p = 1; p < r.idx.size(); ++p) y[r.idx[p]] -= r.val[p] * v;
    }
    for (int32_t j = 0; j < m; ++j) {
      if (!g_Dused[j]) return -1;
      const double* Dj = g_D.data() + (int64_t)j * m;
      double v = y[g_split + j] / Dj[j];
      y[g_split + j] = v;
      double* yt = y.data() + g_split;
      for (int32_t p = j + 1; p < m; ++p) yt[p] -= Dj[p] * v;
    }
    // backward: R x = y
    for (int32_t j = m - 1; j >= 0; --j) {
      const double* Dj = g_D.data() + (int64_t)j * m;
      double acc = y[g_split + j];
      const double* yt = y.data() + g_split;
      for (int32_t p = j + 1; p < m; ++p) acc -= Dj[p] * yt[p];
      y[g_split + j] = acc / Dj[j];
    }
    for (int32_t j = g_split - 1; j >= 0; --j) {
      const SparseRow& r = g_R[j];
      double acc = y[j];
      for (size_t p = 1; p < r.idx.size(); ++p) acc -= r.val[p] * y[r.idx[p]];
      y[j] = acc / r.val[0];
    }
    for (int32_t i = 0; i < n; ++i) X[(int64_t)i * k + c] = y[i];
  }
  return 0;
}

// Schur-tail factorization (the SuiteSparseQR role with the camera core
// offloaded to the device): factor ONLY the sparse
// columns [0, split) — rows whose remainder reaches the trailing block
// are DISCARDED, because R_cc is determined analytically:
//   R'R = J'J  =>  R_cc' R_cc = H_cc - H_ce H_ee^{-1} H_ec = S,
// the camera Schur complement (R_ec = R_ee^{-T} H_ec makes the cross
// term H_ce H_ee^{-1} H_ec exactly), and S and its Cholesky factor come
// from the Schur assembly on the card. The caller pushes chol(S)' back with
// ct_qr_set_dense before diag()/solve_multi().
int64_t ct_qr_factor_split(int32_t nrows, int32_t ncols,
                           const int64_t* indptr, const int32_t* indices,
                           const double* data, int32_t split) {
  return factor_impl(nrows, ncols, indptr, indices, data, split, 1);
}

// Install the dense trailing block: Rcc is (m, m) row-major upper
// triangular with m == ncols - split.
void ct_qr_set_dense(const double* Rcc) {
  const int32_t m = g_ncols - g_split;
  g_D.assign((int64_t)m * m, 0.0);
  g_Dused.assign(m, 1);
  for (int32_t k = 0; k < m; ++k)
    std::memcpy(g_D.data() + (int64_t)k * m + k,
                Rcc + (int64_t)k * m + k, (m - k) * sizeof(double));
}

void ct_qr_free() {
  std::vector<SparseRow>().swap(g_R);
  std::vector<double>().swap(g_D);
  std::vector<uint8_t>().swap(g_Dused);
  g_ncols = 0;
  g_split = 0;
}

}  // extern "C"
