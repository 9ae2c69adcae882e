// segment_block_sum and unsorted_segment_sum: the segment sums of the
// generic flat Schur path (ops/flatops.py, _FlatOpsBase._reduce_rows):
//   out[k * w + l] = sum over the rows b with ids[b] = k of contrib[b * w + l]
// for contrib (B, w) and K keys, w from 3 (a point's J'u) to 832 (a cross
// term of the dense-Schur assembly).
//
// Replaces two Pallas kernels: segment_block_sum
// (ceres_tpu/ops/pallas_kernels.py:228, sorted ids) and windowed_segment_sum
// (:2563, unsorted ids). Both reduce a 128-row tile with a one-hot MXU dot;
// the second plans id windows per fixed row tile so that a one-hot fits
// VMEM. Neither device carries over: here both are one design, two entry
// points, and the unsorted one reads its rows through the plan's stable
// order of the rows by id.
//
// What bounds it on an H100: bytes (one add per value read). The plan
// (flatops.SegmentPlan) cuts each key's rows into chunks of at most
// CT_CHUNK rows; level 0 sums each chunk with one thread per (chunk,
// column), so neighbouring threads read neighbouring columns and, for
// sorted ids, the next chunk's rows. A key may hold every row (the shared
// intrinsics block of the libmv model: 4.4M rows at the Venice shape):
// while a key owns more than CT_CHUNK chunks, a further level sums its
// partials in chunks of CT_CHUNK, so such a key is summed by a fixed tree
// of depth log_64(rows), not by one thread. A finalize pass sums each key's
// last-level partials in chunk order. No atomics: every output is summed
// in a fixed order, so a solve repeats bit for bit.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Level kernel: one thread per (chunk, column); a chunk's items are rows
// order[i] (level 0 of unsorted ids) or i.
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_sum_kernel(const T* __restrict__ in, const int* __restrict__ order,
                 const int* __restrict__ chunk_start, int n_chunks, int w,
                 T* __restrict__ out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_chunks * w) return;
  long long k = idx / w;
  int l = (int)(idx % w);
  int s = chunk_start[k], e = chunk_start[k + 1];
  T acc = T(0);
  for (int i = s; i < e; ++i) {
    long long row = order != nullptr ? (long long)order[i] : (long long)i;
    acc += in[row * w + l];
  }
  out[idx] = acc;
}

// levels[lv] (sizes[lv] + 1,) device chunk offsets of level lv; level 0
// chunks rows (through `order` when it is given), level lv > 0 chunks the
// partials of level lv - 1. work holds every level's partials in turn.
template <typename T>
int launch(const T* contrib, int B, int w, const int* order, int n_levels,
           const int* const* levels, const int* sizes, const int* key_first,
           int K, T* work, T* out, cudaStream_t stream) {
  (void)B;
  const T* in = contrib;
  T* dst = work;
  for (int lv = 0; lv < n_levels; ++lv) {
    long long n = (long long)sizes[lv] * w;
    const int* rows = lv == 0 ? order : nullptr;
    if (n > 0) {
      CT_LAUNCH(chunk_sum_kernel<T>, ct::ceil_div(n, kThreads), kThreads, stream,
                in, rows, levels[lv], sizes[lv], w, dst);
    }
    in = dst;
    dst += n;
  }
  long long outs = (long long)K * w;
  if (outs > 0) {
    CT_LAUNCH(ct::camera_finalize_kernel<T>, ct::ceil_div(outs, kThreads), kThreads,
              stream, in, key_first, K, w, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// contrib (B, w) -> out (K, w). levels and sizes are host arrays of
// n_levels entries; key_first (K + 1,) is a device array. Workspace: work
// (sum of sizes, w).
#define CT_SEGMENT_SUM_ENTRY(NAME, T)                                           \
  extern "C" int NAME(const T* contrib, int B, int w, int n_levels,            \
                      const int* const* levels, const int* sizes,              \
                      const int* key_first, int K, T* work, T* out,            \
                      cudaStream_t stream) {                                   \
    return launch<T>(contrib, B, w, nullptr, n_levels, levels, sizes,          \
                     key_first, K, work, out, stream);                         \
  }

// The same with order (B,): the rows by id, stable.
#define CT_UNSORTED_SUM_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const T* contrib, int B, int w, const int* order,        \
                      int n_levels, const int* const* levels,                  \
                      const int* sizes, const int* key_first, int K, T* work,  \
                      T* out, cudaStream_t stream) {                           \
    return launch<T>(contrib, B, w, order, n_levels, levels, sizes,            \
                     key_first, K, work, out, stream);                         \
  }

CT_SEGMENT_SUM_ENTRY(ct_segment_block_sum_f64, double)
CT_SEGMENT_SUM_ENTRY(ct_segment_block_sum_f32, float)
CT_UNSORTED_SUM_ENTRY(ct_unsorted_segment_sum_f64, double)
CT_UNSORTED_SUM_ENTRY(ct_unsorted_segment_sum_f32, float)
