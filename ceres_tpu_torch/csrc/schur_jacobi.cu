// schur_jacobi: the camera blocks of the Schur complement, the
// SCHUR_JACOBI preconditioner of the ITERATIVE_SCHUR step, once per LM
// iteration, before scales and D_f^2:
//   out[c] = sum_{rows b of c} J_f,b' J_f,b - W_b' minv[pt_b] W_b   (9 x 9)
//   W_b    = diag(se[pt_b]) J_e,b' J_f,b                           (3 x 9)
// The caller applies sf (x) sf, adds D_f^2 and inverts
// (ceres_tpu/ops/flatops.py:1014-1123).
//
// Replaces two Pallas kernels that compute this one function:
// schur_assembly in mode="schur_jacobi" (ceres_tpu/ops/pallas_kernels.py
// :1281, its correction at :1321-1326), which the JAX package takes up to
// 1024 cameras, and sj_assembly_windowed (:2682), which it takes above, only
// because a global camera one-hot would not fit the TPU's VMEM there. The
// camera plan sums rows by camera at any camera count, so one kernel serves
// both.
//
// What bounds it on an H100: bytes at small camera counts and operations
// close behind. Per row it reads J (24 values) and gathers se and minv of
// the row's point (12); it does ~700 flops (W 54, minv W 162, W' Y and
// J_f'J_f on the upper triangle ~430). The output is C x 81 values.
// Design: one block per camera chunk of the camera plan (common.cuh). Its
// first 64 threads take one row each, compute W and Y = minv W in
// registers and stage J_f, W and Y (72 values) in shared memory; then 81
// lanes each sum one entry over the chunk's rows in order, and a finalize
// pass sums each camera's chunk partials in order. A lane (a, c) computes
// the entry (min, max) of its two indices, so the blocks come out exactly
// symmetric. No atomics: every sum has a fixed order.
#include "common.cuh"

namespace {

using ct::kEOff;
using ct::kTE;
using ct::kTF;

constexpr int kThreads = 128;
constexpr int kBlk = kTF * kTF;          // 81 values per camera block
constexpr int kW = 2 * kTF + 2 * kTE * kTF;  // 72 staged values per row: J_f, W, Y

template <typename T>
__global__ void __launch_bounds__(kThreads)
schur_jacobi_kernel(const T* __restrict__ JT, int B,
                    const int* __restrict__ pt_idx, const T* __restrict__ se,
                    const T* __restrict__ minv,
                    const int* __restrict__ cam_rows,
                    const int* __restrict__ chunk_start,
                    T* __restrict__ cam_partial) {
  __shared__ T rows[CT_CHUNK][kW];
  int chunk = blockIdx.x;
  int s = chunk_start[chunk], n = chunk_start[chunk + 1] - s;
  int t = threadIdx.x;
  if (t < n) {
    int b = cam_rows[s + t];
    long long p = pt_idx[b];
    T* r = rows[t];
    T je[2][kTE];
    for (int i = 0; i < 2; ++i) {
      for (int a = 0; a < kTF; ++a) r[i * kTF + a] = JT[(long long)(i * kTF + a) * B + b];
      for (int k = 0; k < kTE; ++k) je[i][k] = JT[(long long)(kEOff + i * kTE + k) * B + b];
    }
    T* W = r + 2 * kTF;
    T* Y = W + kTE * kTF;
    const T* sp = se + p * kTE;
    for (int k = 0; k < kTE; ++k)
      for (int a = 0; a < kTF; ++a)
        W[k * kTF + a] = sp[k] * (je[0][k] * r[a] + je[1][k] * r[kTF + a]);
    const T* m = minv + p * kTE * kTE;
    for (int i = 0; i < kTE; ++i)
      for (int a = 0; a < kTF; ++a)
        Y[i * kTF + a] = m[i * kTE] * W[a] + m[i * kTE + 1] * W[kTF + a] +
                         m[i * kTE + 2] * W[2 * kTF + a];
  }
  __syncthreads();
  if (t >= kBlk) return;
  int a = t / kTF, c = t % kTF;
  int lo = a < c ? a : c, hi = a < c ? c : a;
  T acc = T(0);
  for (int i = 0; i < n; ++i) {
    const T* r = rows[i];
    const T* W = r + 2 * kTF;
    const T* Y = W + kTE * kTF;
    T ftf = r[lo] * r[hi] + r[kTF + lo] * r[kTF + hi];
    T corr = W[lo] * Y[hi] + W[kTF + lo] * Y[kTF + hi] + W[2 * kTF + lo] * Y[2 * kTF + hi];
    acc += ftf - corr;
  }
  cam_partial[(long long)chunk * kBlk + t] = acc;
}

template <typename T>
int launch(const T* JT, int B, int P, int C, const int* pt_idx, const T* se,
           const T* minv, const int* cam_rows, const int* chunk_start,
           int n_chunks, const int* chunk_first, T* cam_partial, T* out,
           cudaStream_t stream) {
  static_assert(CT_CHUNK <= kThreads && kBlk <= kThreads,
                "one thread per chunk row and per output lane");
  (void)P;
  if (n_chunks > 0) {
    CT_LAUNCH(schur_jacobi_kernel<T>, n_chunks, kThreads, stream, JT, B,
              pt_idx, se, minv, cam_rows, chunk_start, cam_partial);
  }
  long long outs = (long long)C * kBlk;
  if (outs > 0) {
    CT_LAUNCH(ct::camera_finalize_kernel<T>, ct::ceil_div(outs, 256), 256,
              stream, cam_partial, chunk_first, C, kBlk, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// se (P, 3), minv (P, 9) row-major -> out (C, 81) row-major blocks.
// Workspace: cam_partial (n_chunks, 81).
#define CT_SJ_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const T* JT, int B, int P, int C, const int* pt_idx,     \
                      const T* se, const T* minv, const int* cam_rows,         \
                      const int* chunk_start, int n_chunks,                    \
                      const int* chunk_first, T* cam_partial, T* out,          \
                      cudaStream_t stream) {                                   \
    return launch<T>(JT, B, P, C, pt_idx, se, minv, cam_rows, chunk_start,     \
                     n_chunks, chunk_first, cam_partial, out, stream);         \
  }

CT_SJ_ENTRY(ct_schur_jacobi_f64, double)
CT_SJ_ENTRY(ct_schur_jacobi_f32, float)
