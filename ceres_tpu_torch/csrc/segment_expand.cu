// segment_block_expand: the gather of per-block rows back to the rows of
// the generic flat Schur path (ops/flatops.py, _FlatOpsBase._expand) and
// of the specialized pipeline's point gather (parallel/sharded_ba.py):
//   out[i * t + l] = vals[ids[i] * t + l]
// for a table vals (K, t), whose last row is the zero row of the sentinel
// id, and ids (N,) in any order.
//
// Replaces segment_block_expand (ceres_tpu/ops/pallas_kernels.py:354),
// which expands a 128-row tile as the product of the values with a one-hot
// on the MXU, because a per-row gather is slow on the TPU. On the H100 a
// gather is a plain load.
//
// What bounds it on an H100: bytes, once the instructions per value are
// few. The output (N, t) is the large stream; the ids are the next; the
// table is small (13,696 x 6 camera values) or, read in id order, fits the
// 50 MB L2 (the 1M x 3 points). The first design ran one thread per output
// value, with a 64-bit division and remainder by a run-time t per value,
// t loads of each id and a 4- or 8-byte store per value: bound by
// instructions, it lost to torch.index_select in float32.
// Design: a block owns kRows consecutive rows. It loads their ids once,
// coalesced, into shared memory. For the widths the port launches (t = 3,
// 6, 8: libmv's point, camera and intrinsics blocks; t = 9: the 3 x 3 point
// blocks) t is a template parameter: each thread forms one 16-byte group
// of the block's contiguous output span at a time, finds each value's row
// and column by a division by the constant t (a multiply and a shift),
// reads the value through the read-only path and writes the group with
// one 16-byte store. Any other t takes a second variant of the same
// kernel: one value per thread and step, coalesced scalar stores, the row
// and column carried from step to step by an add (no division per value).
// Within a block the value index is 32-bit (at most kRows t); only the
// offsets of a row into vals and of the block into out are 64-bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 1024;  // rows per block; kRows t values are 16-byte whole

// The block's ids, once, coalesced; returns its row count.
__device__ __forceinline__ int load_ids(const int* __restrict__ ids, int N,
                                        long long row0, int* sid) {
  long long left = N - row0;
  int rows = left < kRows ? (int)left : kRows;
  for (int i = threadIdx.x; i < rows; i += kThreads) sid[i] = __ldg(ids + row0 + i);
  __syncthreads();
  return rows;
}

template <typename T, int TW>
__global__ void __launch_bounds__(kThreads)
expand_fixed_kernel(const T* __restrict__ vals, const int* __restrict__ ids, int N,
                    T* __restrict__ out) {
  constexpr int V = ct::Vec16<T>::kN;
  static_assert((kRows * TW) % V == 0, "a full block is whole 16-byte groups");
  __shared__ int sid[kRows];
  long long row0 = (long long)blockIdx.x * kRows;
  int rows = load_ids(ids, N, row0, sid);
  unsigned n = rows * TW;  // values of this block, at most kRows * TW
  T* dst = out + row0 * TW;  // 16-byte aligned: out is, and kRows t values are whole groups
  unsigned nvec = n / V;
  for (unsigned v = threadIdx.x; v < nvec; v += kThreads) {
    T x[V];
#pragma unroll
    for (unsigned e = 0; e < V; ++e) {
      unsigned j = v * V + e, r = j / TW;
      x[e] = __ldg(vals + (long long)sid[r] * TW + (j - r * TW));
    }
    ct::Vec16<T>::store(dst + v * V, x);
  }
  // the last block's ragged tail
  for (unsigned j = nvec * V + threadIdx.x; j < n; j += kThreads) {
    unsigned r = j / TW;
    dst[j] = __ldg(vals + (long long)sid[r] * TW + (j - r * TW));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
expand_any_kernel(const T* __restrict__ vals, const int* __restrict__ ids, int N,
                  int t, T* __restrict__ out) {
  __shared__ int sid[kRows];
  long long row0 = (long long)blockIdx.x * kRows;
  int rows = load_ids(ids, N, row0, sid);
  int n = rows * t;
  T* dst = out + row0 * t;
  // value j = threadIdx.x + s kThreads sits at row r, column l; a step of
  // kThreads values moves (r, l) by (dr, dl), carried when l passes t
  int r = (int)threadIdx.x / t, l = (int)threadIdx.x - r * t;
  const int dr = kThreads / t, dl = kThreads - dr * t;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    dst[j] = __ldg(vals + (long long)sid[r] * t + l);
    r += dr;
    l += dl;
    if (l >= t) {
      l -= t;
      ++r;
    }
  }
}

template <typename T>
int launch(const T* vals, int K, int t, const int* ids, int N, T* out,
           cudaStream_t stream) {
  (void)K;
  if (N <= 0 || t <= 0) return (int)cudaGetLastError();
  if ((reinterpret_cast<unsigned long long>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  int grid = ct::ceil_div((long long)N, kRows);
  switch (t) {
#define CT_EXPAND_WIDTH(W)                                              \
    case W: {                                                           \
      auto kernel = expand_fixed_kernel<T, W>;                          \
      CT_LAUNCH(kernel, grid, kThreads, stream, vals, ids, N, out);     \
      break;                                                            \
    }
    CT_EXPAND_WIDTH(3)
    CT_EXPAND_WIDTH(6)
    CT_EXPAND_WIDTH(8)
    CT_EXPAND_WIDTH(9)
#undef CT_EXPAND_WIDTH
    default: {
      auto kernel = expand_any_kernel<T>;
      CT_LAUNCH(kernel, grid, kThreads, stream, vals, ids, N, t, out);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// vals (K, t), ids (N,) in [0, K) -> out (N, t), 16-byte aligned.
#define CT_EXPAND_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const T* vals, int K, int t, const int* ids, int N,      \
                      T* out, cudaStream_t stream) {                           \
    return launch<T>(vals, K, t, ids, N, out, stream);                         \
  }

CT_EXPAND_ENTRY(ct_segment_block_expand_f64, double)
CT_EXPAND_ENTRY(ct_segment_block_expand_f32, float)
