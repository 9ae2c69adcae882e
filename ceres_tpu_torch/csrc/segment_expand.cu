// segment_block_expand: the gather of per-block rows back to the rows of
// the generic flat Schur path (ops/flatops.py, _FlatOpsBase._expand):
//   out[i * t + l] = vals[ids[i] * t + l]
// for a table vals (K, t), whose last row is the zero row of the sentinel
// id, and ids (N,) in any order.
//
// Replaces segment_block_expand (ceres_tpu/ops/pallas_kernels.py:354),
// which expands a 128-row tile as the product of the values with a one-hot
// on the MXU, because a per-row gather is slow on the TPU. On the H100 a
// gather is a plain load.
//
// What bounds it on an H100: bytes. One thread per output value; a warp
// writes 32 neighbouring values and reads the rows of its ids, which for
// sorted ids repeat across neighbouring rows and stay in L1/L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
expand_kernel(const T* __restrict__ vals, const int* __restrict__ ids, int N,
              int t, T* __restrict__ out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)N * t) return;
  long long i = idx / t;
  int l = (int)(idx % t);
  out[idx] = vals[(long long)ids[i] * t + l];
}

template <typename T>
int launch(const T* vals, int K, int t, const int* ids, int N, T* out,
           cudaStream_t stream) {
  (void)K;
  long long n = (long long)N * t;
  if (n > 0) {
    CT_LAUNCH(expand_kernel<T>, ct::ceil_div(n, kThreads), kThreads, stream, vals,
              ids, N, t, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// vals (K, t), ids (N,) in [0, K) -> out (N, t).
#define CT_EXPAND_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const T* vals, int K, int t, const int* ids, int N,      \
                      T* out, cudaStream_t stream) {                           \
    return launch<T>(vals, K, t, ids, N, out, stream);                         \
  }

CT_EXPAND_ENTRY(ct_segment_block_expand_f64, double)
CT_EXPAND_ENTRY(ct_segment_block_expand_f32, float)
