// isc_matvec: the implicit Schur product of the ITERATIVE_SCHUR CG, once
// per CG iteration, without its D_f^2 term:
//   fz_b = J_f,b z[cam_b]                      (2 values per row)
//   u_p  = minv_p sum_{rows b of p} J_e,b' fz_b (3 values per point)
//   q_b  = fz_b - J_e,b u_{pt_b}
//   cam[c] = sum_{rows of c} J_f,b' q_b         (C, 9)
// and, when asked, u (P, 3) for the back-substitution of the step.
//
// Replaces the Pallas kernel implicit_schur_matvec in mode="isc", as
// isc_matvec calls it (ceres_tpu/ops/pallas_kernels.py:781 and :1716,
// pallas_call at :1258 / :1270), and its per-tile M^{-1} table
// (build_minv_tile_table, :1657), which only served the TPU's layout.
//
// What bounds it on an H100: bytes. Per row it needs J (24 values), the
// gathered z (9, from L2: the camera table is small) and ~130 flops; per
// point minv (9) and u (3); per camera 9 outputs. That is far below the
// card's flop-per-byte balance.
// Design: the point side is a segment sum, since rows are sorted by
// point: pass 1 runs one thread per point, which walks its rows twice,
// first for fz (kept in q) and E'fz, then, once u is known, for
// q = fz - J_e u. The camera side has the C-way contention of
// post_eval_fused and the same answer: pass 2 stages each camera chunk's
// J_f and q in shared memory and 9 lanes sum them in order; pass 3 sums
// each camera's chunk partials in order (common.cuh). J_f is read twice
// (passes 1 and 2), J_e twice inside pass 1: 48 values per row where the
// JAX kernel reads 24. No atomics: every sum has a fixed order.
#include "common.cuh"

namespace {

using ct::kEOff;
using ct::kTE;
using ct::kTF;

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
isc_point_kernel(const T* __restrict__ JT, int B, int P,
                 const int* __restrict__ cam_idx,
                 const int* __restrict__ pt_start, const T* __restrict__ z,
                 const T* __restrict__ minv, int emit_u, T* __restrict__ q,
                 T* __restrict__ u) {
  int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= P) return;
  int b0 = pt_start[p], b1 = pt_start[p + 1];
  T e[kTE] = {};
  for (int b = b0; b < b1; ++b) {
    const T* zc = z + (long long)cam_idx[b] * kTF;
    T fz[2];
    for (int i = 0; i < 2; ++i) {
      T acc = T(0);
      for (int a = 0; a < kTF; ++a) acc += JT[(long long)(i * kTF + a) * B + b] * zc[a];
      fz[i] = acc;
      q[(long long)i * B + b] = acc;
    }
    for (int k = 0; k < kTE; ++k) {
      e[k] += JT[(long long)(kEOff + k) * B + b] * fz[0] +
              JT[(long long)(kEOff + kTE + k) * B + b] * fz[1];
    }
  }
  const T* m = minv + (long long)p * kTE * kTE;
  T up[kTE];
  for (int i = 0; i < kTE; ++i)
    up[i] = m[i * kTE] * e[0] + m[i * kTE + 1] * e[1] + m[i * kTE + 2] * e[2];
  if (emit_u) {
    for (int i = 0; i < kTE; ++i) u[(long long)p * kTE + i] = up[i];
  }
  for (int b = b0; b < b1; ++b) {
    for (int i = 0; i < 2; ++i) {
      T eu = T(0);
      for (int k = 0; k < kTE; ++k) eu += JT[(long long)(kEOff + i * kTE + k) * B + b] * up[k];
      q[(long long)i * B + b] -= eu;
    }
  }
}

// one camera chunk: stage J_f (18) and q (2) of its rows, then 9 lanes
template <typename T>
__global__ void __launch_bounds__(kThreads)
isc_camera_kernel(const T* __restrict__ JT, const T* __restrict__ q, int B,
                  const int* __restrict__ cam_rows,
                  const int* __restrict__ chunk_start,
                  T* __restrict__ cam_partial) {
  constexpr int kW = 2 * kTF + 2;
  __shared__ T rows[CT_CHUNK][kW];
  int chunk = blockIdx.x;
  int s = chunk_start[chunk], n = chunk_start[chunk + 1] - s;
  for (int idx = threadIdx.x; idx < n * kW; idx += kThreads) {
    int i = idx / kW, l = idx % kW;
    int b = cam_rows[s + i];
    rows[i][l] = l < 2 * kTF ? JT[(long long)l * B + b]
                             : q[(long long)(l - 2 * kTF) * B + b];
  }
  __syncthreads();
  int l = threadIdx.x;
  if (l >= kTF) return;
  T acc = T(0);
  for (int i = 0; i < n; ++i)
    acc += rows[i][l] * rows[i][2 * kTF] + rows[i][kTF + l] * rows[i][2 * kTF + 1];
  cam_partial[(long long)chunk * kTF + l] = acc;
}

template <typename T>
int launch(const T* JT, int B, int P, int C, const int* cam_idx,
           const int* pt_start, const int* cam_rows, const int* chunk_start,
           int n_chunks, const int* chunk_first, const T* z, const T* minv,
           int emit_u, T* q, T* u, T* cam_partial, T* cam_out,
           cudaStream_t stream) {
  if (P > 0) {
    CT_LAUNCH(isc_point_kernel<T>, ct::ceil_div(P, kThreads), kThreads, stream,
              JT, B, P, cam_idx, pt_start, z, minv, emit_u, q, u);
  }
  if (n_chunks > 0) {
    CT_LAUNCH(isc_camera_kernel<T>, n_chunks, kThreads, stream, JT, q, B,
              cam_rows, chunk_start, cam_partial);
  }
  int outs = C * kTF;
  if (outs > 0) {
    CT_LAUNCH(ct::camera_finalize_kernel<T>, ct::ceil_div(outs, 256), 256,
              stream, cam_partial, chunk_first, C, kTF, cam_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// z (C, 9), minv (P, 9) row-major -> cam_out (C, 9) and, when emit_u,
// u (P, 3). Workspace: q (2, B), cam_partial (n_chunks, 9). Every point
// of a row must own its row (rows sorted by point, pt_start covers B).
#define CT_ISC_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* JT, int B, int P, int C, const int* cam_idx,   \
                      const int* pt_start, const int* cam_rows,               \
                      const int* chunk_start, int n_chunks,                   \
                      const int* chunk_first, const T* z, const T* minv,      \
                      int emit_u, T* q, T* u, T* cam_partial, T* cam_out,     \
                      cudaStream_t stream) {                                  \
    return launch<T>(JT, B, P, C, cam_idx, pt_start, cam_rows, chunk_start,   \
                     n_chunks, chunk_first, z, minv, emit_u, q, u,            \
                     cam_partial, cam_out, stream);                           \
  }

CT_ISC_ENTRY(ct_isc_matvec_f64, double)
CT_ISC_ENTRY(ct_isc_matvec_f32, float)
