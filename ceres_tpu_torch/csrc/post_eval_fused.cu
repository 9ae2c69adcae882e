// post_eval_fused: the per-iteration reduce over J and r.
//   per point p:  g_e = sum J_e' r (3), sqn_e = sum J_e^2 (3), E'E (3x3)
//   per camera c: g_f = sum J_f' r (9), sqn_f = sum J_f^2 (9)
//
// Replaces the Pallas kernel post_eval_fused
// (ceres_tpu/ops/pallas_kernels.py:1780, pallas_call at :2052).
//
// What bounds it on an H100: bytes. It reads J and r once (26 values per
// observation) for ~100 flops per observation and writes per-point and
// per-camera tables that are small next to J.
// The point sums are contiguous segments, because rows are sorted by point
// (about 3.8 rows per point at BAL-16): one thread per point walks its
// segment. The camera sums reduce every row into only C cameras (16 at
// BAL-16), which as global atomics would serialise on 16 addresses and,
// in float64, make runs differ. Instead the camera plan (common.cuh) cuts
// the rows of each camera into chunks of at most CT_CHUNK rows: one block
// stages a chunk's rows in shared memory and 18 lanes sum them in order;
// a finalize pass sums each camera's chunk partials in order. Point
// blocks and chunk blocks share one launch.
#include "common.cuh"

namespace {

using ct::kEOff;
using ct::kTE;
using ct::kTF;

constexpr int kThreads = 128;
constexpr int kPtOut = 2 * kTE + kTE * kTE;  // 15 values per point
constexpr int kCamOut = 2 * kTF;             // 18 values per camera

template <typename T>
__global__ void __launch_bounds__(kThreads)
post_eval_kernel(const T* __restrict__ JT, const T* __restrict__ rT, int B,
                 int P, int pt_blocks, const int* __restrict__ pt_start,
                 const int* __restrict__ cam_rows,
                 const int* __restrict__ chunk_start, T* __restrict__ ptab,
                 T* __restrict__ cam_partial) {
  if ((int)blockIdx.x < pt_blocks) {
    int p = blockIdx.x * kThreads + threadIdx.x;
    if (p >= P) return;
    T g[kTE] = {}, sq[kTE] = {}, ete[kTE][kTE] = {};
    for (int b = pt_start[p]; b < pt_start[p + 1]; ++b) {
      T r[2] = {rT[b], rT[(long long)B + b]};
      T je[2][kTE];
      for (int i = 0; i < 2; ++i)
        for (int k = 0; k < kTE; ++k)
          je[i][k] = JT[(long long)(kEOff + i * kTE + k) * B + b];
      for (int k = 0; k < kTE; ++k) {
        g[k] += je[0][k] * r[0] + je[1][k] * r[1];
        sq[k] += je[0][k] * je[0][k] + je[1][k] * je[1][k];
        for (int m = 0; m < kTE; ++m)
          ete[k][m] += je[0][k] * je[0][m] + je[1][k] * je[1][m];
      }
    }
    T* out = ptab + (long long)p * kPtOut;
    for (int k = 0; k < kTE; ++k) {
      out[k] = g[k];
      out[kTE + k] = sq[k];
      for (int m = 0; m < kTE; ++m) out[2 * kTE + k * kTE + m] = ete[k][m];
    }
    return;
  }
  // one camera chunk: stage J_f (18) and r (2) of its rows, then lanes
  constexpr int kW = 2 * kTF + 2;
  __shared__ T rows[CT_CHUNK][kW];
  int chunk = blockIdx.x - pt_blocks;
  int s = chunk_start[chunk], n = chunk_start[chunk + 1] - s;
  for (int idx = threadIdx.x; idx < n * kW; idx += kThreads) {
    int i = idx / kW, l = idx % kW;
    int b = cam_rows[s + i];
    rows[i][l] = l < 2 * kTF ? JT[(long long)l * B + b]
                             : rT[(long long)(l - 2 * kTF) * B + b];
  }
  __syncthreads();
  int l = threadIdx.x;
  if (l >= kCamOut) return;
  T acc = T(0);
  if (l < kTF) {
    for (int i = 0; i < n; ++i)
      acc += rows[i][l] * rows[i][2 * kTF] + rows[i][kTF + l] * rows[i][2 * kTF + 1];
  } else {
    int a = l - kTF;
    for (int i = 0; i < n; ++i)
      acc += rows[i][a] * rows[i][a] + rows[i][kTF + a] * rows[i][kTF + a];
  }
  cam_partial[(long long)chunk * kCamOut + l] = acc;
}

template <typename T>
int launch(const T* JT, const T* rT, int B, int P, int C, const int* pt_start,
           const int* cam_rows, const int* chunk_start, int n_chunks,
           const int* chunk_first, T* ptab, T* cam_partial, T* cam,
           cudaStream_t stream) {
  int pt_blocks = ct::ceil_div(P, kThreads);
  if (pt_blocks + n_chunks > 0) {
    CT_LAUNCH(post_eval_kernel<T>, pt_blocks + n_chunks, kThreads, stream, JT,
              rT, B, P, pt_blocks, pt_start, cam_rows, chunk_start, ptab,
              cam_partial);
  }
  int outs = C * kCamOut;
  if (outs > 0) {
    CT_LAUNCH(ct::camera_finalize_kernel<T>, ct::ceil_div(outs, 256), 256,
              stream, cam_partial, chunk_first, C, kCamOut, cam);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// ptab (P, 15) = [g_e | sqn_e | E'E]; cam (C, 18) = [g_f | sqn_f];
// cam_partial is workspace of (n_chunks, 18).
extern "C" int ct_post_eval_fused_f64(const double* JT, const double* rT, int B,
                                      int P, int C, const int* pt_start,
                                      const int* cam_rows,
                                      const int* chunk_start, int n_chunks,
                                      const int* chunk_first, double* ptab,
                                      double* cam_partial, double* cam,
                                      cudaStream_t stream) {
  return launch<double>(JT, rT, B, P, C, pt_start, cam_rows, chunk_start,
                        n_chunks, chunk_first, ptab, cam_partial, cam, stream);
}

extern "C" int ct_post_eval_fused_f32(const float* JT, const float* rT, int B,
                                      int P, int C, const int* pt_start,
                                      const int* cam_rows,
                                      const int* chunk_start, int n_chunks,
                                      const int* chunk_first, float* ptab,
                                      float* cam_partial, float* cam,
                                      cudaStream_t stream) {
  return launch<float>(JT, rT, B, P, C, pt_start, cam_rows, chunk_start,
                       n_chunks, chunk_first, ptab, cam_partial, cam, stream);
}
