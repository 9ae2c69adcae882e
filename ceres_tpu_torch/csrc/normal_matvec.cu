// normal_matvec: (J'J) x for the e/f split, one pass over J.
//   jv_b = J_f,b x_c[cam_b] + J_e,b x_p[pt_b]       (2 values per row)
//   cam[c] = sum_{rows of c} J_f' jv   (C, 9)
//   pt[p]  = sum_{rows of p} J_e' jv   (P, 3)
//
// Replaces the Pallas kernel implicit_schur_matvec in mode="normal", as
// normal_matvec calls it (ceres_tpu/ops/pallas_kernels.py:781 and :1759,
// pallas_call at :1258 / :1270). The dense-Schur step uses the point
// output for its back-substitution (ceres_tpu/solvers/fused_lm.py:963-966).
//
// What bounds it on an H100: bytes. It reads J once (24 values per row)
// and gathers x; ~100 flops per row. The point output is a segment sum over
// rows sorted by point: one thread per point. The camera output has the
// same C-way contention as post_eval_fused, and the same answer: camera
// chunks staged in shared memory (jv computed once per row there), summed
// by 9 lanes in order, then a finalize pass over each camera's chunks.
#include "common.cuh"

namespace {

using ct::kEOff;
using ct::kTE;
using ct::kTF;

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ void row_jv(const T* __restrict__ JT, int B, int b,
                                       const T* __restrict__ xc,
                                       const T* __restrict__ xp, T jf[2][kTF],
                                       T je[2][kTE], T jv[2]) {
  for (int i = 0; i < 2; ++i) {
    T acc = T(0);
    for (int a = 0; a < kTF; ++a) {
      jf[i][a] = JT[(long long)(i * kTF + a) * B + b];
      acc += jf[i][a] * xc[a];
    }
    for (int k = 0; k < kTE; ++k) {
      je[i][k] = JT[(long long)(kEOff + i * kTE + k) * B + b];
      acc += je[i][k] * xp[k];
    }
    jv[i] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
normal_matvec_kernel(const T* __restrict__ JT, int B, int P, int pt_blocks,
                     const int* __restrict__ cam_idx,
                     const int* __restrict__ pt_idx,
                     const int* __restrict__ pt_start,
                     const int* __restrict__ cam_rows,
                     const int* __restrict__ chunk_start,
                     const T* __restrict__ xc, const T* __restrict__ xp,
                     T* __restrict__ pt_out, T* __restrict__ cam_partial) {
  T jf[2][kTF], je[2][kTE], jv[2];
  if ((int)blockIdx.x < pt_blocks) {
    int p = blockIdx.x * kThreads + threadIdx.x;
    if (p >= P) return;
    T acc[kTE] = {};
    const T* xpp = xp + (long long)p * kTE;
    for (int b = pt_start[p]; b < pt_start[p + 1]; ++b) {
      row_jv(JT, B, b, xc + (long long)cam_idx[b] * kTF, xpp, jf, je, jv);
      for (int k = 0; k < kTE; ++k) acc[k] += je[0][k] * jv[0] + je[1][k] * jv[1];
    }
    for (int k = 0; k < kTE; ++k) pt_out[(long long)p * kTE + k] = acc[k];
    return;
  }
  constexpr int kW = 2 * kTF + 2;
  __shared__ T rows[CT_CHUNK][kW];
  int chunk = blockIdx.x - pt_blocks;
  int s = chunk_start[chunk], n = chunk_start[chunk + 1] - s;
  if ((int)threadIdx.x < n) {
    int b = cam_rows[s + threadIdx.x];
    row_jv(JT, B, b, xc + (long long)cam_idx[b] * kTF,
           xp + (long long)pt_idx[b] * kTE, jf, je, jv);
    for (int i = 0; i < 2; ++i)
      for (int a = 0; a < kTF; ++a) rows[threadIdx.x][i * kTF + a] = jf[i][a];
    rows[threadIdx.x][2 * kTF] = jv[0];
    rows[threadIdx.x][2 * kTF + 1] = jv[1];
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
           const int* pt_idx, const int* pt_start, const int* cam_rows,
           const int* chunk_start, int n_chunks, const int* chunk_first,
           const T* xc, const T* xp, T* pt_out, T* cam_partial, T* cam_out,
           cudaStream_t stream) {
  static_assert(CT_CHUNK <= kThreads, "one thread per chunk row");
  int pt_blocks = ct::ceil_div(P, kThreads);
  if (pt_blocks + n_chunks > 0) {
    CT_LAUNCH(normal_matvec_kernel<T>, pt_blocks + n_chunks, kThreads, stream,
              JT, B, P, pt_blocks, cam_idx, pt_idx, pt_start, cam_rows,
              chunk_start, xc, xp, pt_out, cam_partial);
  }
  int outs = C * kTF;
  if (outs > 0) {
    CT_LAUNCH(ct::camera_finalize_kernel<T>, ct::ceil_div(outs, 256), 256,
              stream, cam_partial, chunk_first, C, kTF, cam_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// xc (C, 9), xp (P, 3) -> cam_out (C, 9), pt_out (P, 3); cam_partial is
// workspace of (n_chunks, 9).
extern "C" int ct_normal_matvec_f64(const double* JT, int B, int P, int C,
                                    const int* cam_idx, const int* pt_idx,
                                    const int* pt_start, const int* cam_rows,
                                    const int* chunk_start, int n_chunks,
                                    const int* chunk_first, const double* xc,
                                    const double* xp, double* pt_out,
                                    double* cam_partial, double* cam_out,
                                    cudaStream_t stream) {
  return launch<double>(JT, B, P, C, cam_idx, pt_idx, pt_start, cam_rows,
                        chunk_start, n_chunks, chunk_first, xc, xp, pt_out,
                        cam_partial, cam_out, stream);
}

extern "C" int ct_normal_matvec_f32(const float* JT, int B, int P, int C,
                                    const int* cam_idx, const int* pt_idx,
                                    const int* pt_start, const int* cam_rows,
                                    const int* chunk_start, int n_chunks,
                                    const int* chunk_first, const float* xc,
                                    const float* xp, float* pt_out,
                                    float* cam_partial, float* cam_out,
                                    cudaStream_t stream) {
  return launch<float>(JT, B, P, C, cam_idx, pt_idx, pt_start, cam_rows,
                       chunk_start, n_chunks, chunk_first, xc, xp, pt_out,
                       cam_partial, cam_out, stream);
}
