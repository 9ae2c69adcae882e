// segment_block_sum and unsorted_segment_sum: the segment sums of the
// generic flat Schur path (ops/flatops.py, _FlatOpsBase._reduce_rows) and of
// the specialized pipeline's point sums (parallel/sharded_ba.py):
//   out[k * w + l] = sum over the rows b with ids[b] = k of contrib[b * w + l]
// for contrib (B, w) and K keys, w from 3 (a point's J'u) to 832 (a cross
// term of the dense-Schur assembly).
//
// Replaces two Pallas kernels: segment_block_sum
// (ceres_tpu/ops/pallas_kernels.py:228, sorted ids) and windowed_segment_sum
// (:2563, unsorted ids). Both reduce a 128-row tile with a one-hot MXU dot;
// the second plans id windows per fixed row tile so that a one-hot fits
// VMEM. Neither device carries over.
//
// What bounds it on an H100: bytes (one add per value read). The first
// port ran both through one thread per (chunk of at most 64 rows of a key,
// column), a serial loop of loads, and a last pass that read every chunk
// partial back to write out: 1.2x-3.7x its bound at the libmv-Venice shape.
//
// Sorted ids (segment_block_sum): a tile-and-run reduction that reads
// contrib in its stored order and writes most keys once.
// 1. Tiles and runs: block t owns the tile of kTile consecutive rows from
//    t kTile (kn.SEG_TILE). A key whose rows end at most kHalo rows
//    (kn.SEG_HALO) past the end of the tile of its first row is one run of
//    that tile, so a point at a tile's edge is not cut; a longer key has a
//    run in each tile its rows meet (flatops.SegmentPlan: tile_run,
//    run_start, run_dest; runs are contiguous, in row order). Rows of at
//    most 64 bytes (kStageWidth) are staged, kStagedTiles tiles a block and
//    the halo: each thread issues its 16-byte loads of the block's
//    contiguous span first, the plan's loads next, then waits once, and a
//    thread per (run, column) sums each run in row order from shared memory
//    (at w = 3 a warp's direct loads fetch ten scattered 24-byte rows: 2.1x
//    slower at libmv-Venice, same-card A/B, PERF.md). Wider rows (15, 48 and
//    80 doubles, 48 and 80 floats), and rows of a grid too small to fill
//    the card where each thread would sum more than two items in turn
//    (kn.staged: libmv16's 15 floats, 9% faster so), are summed straight
//    from device memory, a tile a block: neighbouring threads take
//    neighbouring columns of one row. Tiles of 128 rows against 512: the
//    staged pass 1.5x faster at 512 rows a block, the direct one faster at
//    128 (a tile of one key gives its w items 128 rows each). A tile of
//    fewer (run, column) items than threads (one key holding every row:
//    libmv's intrinsics block, 4.4M rows at the Venice shape) spreads each
//    item over up to kMaxParts interleaved parts of its rows, summed in
//    order.
// 2. One write for single-run keys: a key of one run writes its sum
//    straight into out (run_dest >= n_partials), and the tile pass writes
//    the zeros of the keys of no row (empty_keys), so where no key is
//    longer than a tile and its halo (libmv16's points) the tile pass is
//    the call's one launch. The other keys' run partials go to a table in
//    key order, summed by a fixed tree of levels (run_levels: chunks of at
//    most CT_CHUNK partials, a key of more than CT_CHUNK chunks cut again;
//    none where no key has more than CT_CHUNK partials) and the last
//    level's chunks of each of those keys (fin_first, fin_keys): for the
//    templated widths through point_blocks.cuh's level_sums (a block stages
//    a few chunks' items with coalesced loads; 8% [18%] faster for the one
//    key at w = 8), else, and for a last pass without levels, a thread per
//    (chunk or key, column).
//
// Unsorted ids (unsorted_segment_sum): a gather, each key's rows through the
// plan's stable order of the rows by id, chunked as the first port's
// (level_starts, key_first). Rows of at most kGatherWarpBytes (64 bytes:
// libmv's 6 camera values of a CG iteration): a warp takes a chunk, stages
// its row ids with one coalesced load, and its lanes take whole units of
// 16, 8 or 4 bytes of a row in RP >= 2 row phases summed in order (10 rows
// in flight a warp at w = 6 in float64, where the first port's warp covered
// five scattered rows with a dependent pair of loads each). Wider rows (36
// and 48: the SCHUR_JACOBI and post-evaluation sums) keep the first port's
// thread per (chunk, column), whose warps read stretches of one row: a warp
// or a block per chunk measured 2-41% slower there in float64. The tile-and-run design
// of sorted ids, with each row's place in its tile's key order, lost to the
// warp gather at w = 6, 8, 12 and 16 in both dtypes on an H100 (PERF.md),
// with tiles of 512 rows: such a tile of rows by point meets ~120 of
// libmv-Venice's cameras, so the run partials cost 0.23 of a row each way
// on top of the rows (0.42 at 256 rows, 0.12 at 1,024).
//
// Widths: 3, 6, 8 (libmv's point, camera and intrinsics blocks in a CG
// iteration) and 15, 48, 80 (their post-evaluation sums; 15 and 3 are also
// the specialized pipeline's) are template parameters of the sorted pass,
// so a value's row and column come from a division by a constant; any other
// width takes a runtime-w instance of the same kernels.
// No atomics: every output is summed in a fixed order set by the plan and
// the width, so a solve repeats bit for bit.
#include <type_traits>

#include "point_blocks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;            // rows of a tile: kn.SEG_TILE
constexpr int kHalo = 64;             // rows a run may reach past its tile: kn.SEG_HALO
constexpr int kStagedTiles = 4;       // tiles a block of the staged pass takes, at most
constexpr int kStagedRows = kStagedTiles * kTile;
constexpr int kMaxParts = 32;         // interleaved parts of a (run, column) sum, at most
constexpr int kGatherWarpBytes = 64;  // rows the gather takes a warp per chunk for, at most

// values a row, at most, that a tile stages: 64 bytes, 8 doubles or 16
// floats (a runtime width's stage: 36 KB of shared memory a block with the
// halo; a templated width stages its own)
template <typename T>
constexpr int kStageWidth = 64 / (int)sizeof(T);

// The two entry points' kernels, named apart in a profile.
struct SegmentBlockSum {};
struct UnsortedSegmentSum {};

// f(std::integral_constant<int, W>{}) for w's templated width W (W = 0: any
// other width, read at run time)
template <class F>
int by_width(int w, F f) {
  switch (w) {
    case 3: return f(std::integral_constant<int, 3>{});
    case 6: return f(std::integral_constant<int, 6>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 15: return f(std::integral_constant<int, 15>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 80: return f(std::integral_constant<int, 80>{});
    default: return f(std::integral_constant<int, 0>{});
  }
}

// Where a run's sums go: value l of partial d (d < n_partials) or of the
// key d - n_partials of out, w values a row.
template <typename T>
__device__ __forceinline__ void put_run(T* __restrict__ partial, T* __restrict__ out,
                                        int n_partials, int d, int w, int l, T v) {
  if (d < n_partials) partial[(long long)d * w + l] = v;
  else out[(long long)(d - n_partials) * w + l] = v;
}

// The zeros of the n keys of no row (empty_keys), a grid-stride loop over
// (key, column).
template <typename T>
__device__ __forceinline__ void zero_keys(const int* __restrict__ keys, int n, int w,
                                          T* __restrict__ out) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < (long long)n * w;
       i += step)
    out[(long long)__ldg(keys + i / w) * w + i % w] = T(0);
}

// The runs q < nq of a tile: each (run, column l) sums its run's rows r =
// rs[q] .. rs[q+1] of base (value l of row r at base[r w + l], shared or
// device memory) in row order, or, where the items are fewer than the
// threads, in G interleaved parts summed in order; neighbouring threads
// take neighbouring columns. Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void sum_runs(const T* base, int w, int nq, const short* rs,
                                         const int* rd, int n_partials, T* part,
                                         T* __restrict__ partial, T* __restrict__ out) {
  const int tid = threadIdx.x, items = nq * w;
  if (items == 0) return;  // a last tile that a run of the tile before covers
  // block-uniform: G follows from the tile's runs and the width
  const int G = items >= kThreads ? 1 : kThreads / items < kMaxParts ? kThreads / items
                                                                      : kMaxParts;
  if (G == 1) {
    for (int it = tid; it < items; it += kThreads) {
      const int q = it / w, l = it - q * w;
      T acc = T(0);
      for (int r = rs[q]; r < rs[q + 1]; ++r) acc += base[r * w + l];
      put_run(partial, out, n_partials, rd[q], w, l, acc);
    }
    return;
  }
  const int g = tid / items, it = tid - g * items;  // part g of item it
  if (g < G) {
    const int q = it / w, l = it - q * w;
    T acc = T(0);
#pragma unroll 8
    for (int r = rs[q] + g; r < rs[q + 1]; r += G) acc += base[r * w + l];
    part[tid] = acc;
  }
  __syncthreads();
  if (tid < items) {
    T acc = T(0);
    for (int k = 0; k < G; ++k) acc += part[k * items + tid];
    const int q = tid / w;
    put_run(partial, out, n_partials, rd[q], w, tid - q * w, acc);
  }
}

// The runs of tiles t0 .. t1 (tile_run, run_start, run_dest) in shared
// memory, their starts from row r0; returns their number, and in *end the
// row after their last, from r0.
__device__ __forceinline__ int load_runs(const int* __restrict__ tile_run,
                                         const int* __restrict__ run_start,
                                         const int* __restrict__ run_dest, int t0, int t1,
                                         long long r0, short* rs, int* rd, int* end) {
  const int q0 = __ldg(tile_run + t0);
  const int nq = __ldg(tile_run + t1) - q0;
  for (int i = threadIdx.x; i <= nq; i += kThreads) {
    rs[i] = (short)(__ldg(run_start + q0 + i) - r0);
    if (i < nq) rd[i] = __ldg(run_dest + q0 + i);
  }
  *end = (int)(__ldg(run_start + q0 + nq) - r0);
  return nq;
}

// Tile pass for rows of at most kStageWidth values (1. above): block b
// stages kStagedTiles tiles, rows b kStagedRows .. + kStagedRows (fewer
// would leave a block too little to load between its waits), and the rows
// of its last run past them, kHalo at most. W > 0 fixes the width; W = 0
// reads it from w_arg. vec: contrib is 16-byte aligned (the wrapper's
// tensors are; a view may not be), so the span of r0 w values is.
template <typename T, int W, class Tag>
__global__ void __launch_bounds__(kThreads)
segment_runs_kernel(const T* __restrict__ in, int B, int w_arg, bool vec, int n_tiles,
                    const int* __restrict__ tile_run, const int* __restrict__ run_start,
                    const int* __restrict__ run_dest, int n_partials,
                    const int* __restrict__ empty_keys, int n_empty,
                    T* __restrict__ partial, T* __restrict__ out) {
  constexpr int V = ct::Vec16<T>::kN;
  constexpr int S = kStageWidth<T>;
  static_assert(W <= S, "rows of at most kStageWidth values");
  // the thread's 16-byte loads of the span, at most
  constexpr int NL = ((W > 0 ? W : S) * kStagedRows / V + kThreads - 1) / kThreads;
  const int w = W > 0 ? W : w_arg;
  __shared__ T stage[(kStagedRows + kHalo) * (W > 0 ? W : S)];
  __shared__ T part[kThreads];
  __shared__ short rs[kStagedRows + 1];  // the runs' starts from the block's first row
  __shared__ int rd[kStagedRows];        // the runs' run_dest
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kStagedRows;
  const int n = (B - r0 < kStagedRows ? (int)(B - r0) : kStagedRows) * w;
  const T* src = in + r0 * w;
  const int nv = vec ? n / V : 0;
  T x[NL * V];
#pragma unroll
  for (int k = 0; k < NL; ++k)
    if (tid + k * kThreads < nv) ct::Vec16<T>::load(src + (tid + k * kThreads) * V, x + k * V);
  zero_keys(empty_keys, n_empty, w, out);
  const int t0 = blockIdx.x * kStagedTiles;
  int end;
  const int nq = load_runs(tile_run, run_start, run_dest, t0,
                           n_tiles - t0 < kStagedTiles ? n_tiles : t0 + kStagedTiles, r0,
                           rs, rd, &end);
#pragma unroll
  for (int k = 0; k < NL; ++k)
    if (tid + k * kThreads < nv)
#pragma unroll
      for (int e = 0; e < V; ++e) stage[(tid + k * kThreads) * V + e] = x[k * V + e];
  // a ragged span, and the halo
  for (int j = nv * V + tid; j < end * w; j += kThreads) stage[j] = __ldg(src + j);
  __syncthreads();
  sum_runs<T>(stage, w, nq, rs, rd, n_partials, part, partial, out);
}

// Tile pass for rows of more than kStageWidth values (1. above): block t
// takes tile t, and each (run, column) sums its run's rows straight from
// device memory (a block of more tiles would leave a tile of one key, w
// items, to as many threads as a tile's).
template <typename T, int W, class Tag>
__global__ void __launch_bounds__(kThreads)
segment_rows_kernel(const T* __restrict__ in, int w_arg, int n_tiles,
                    const int* __restrict__ tile_run, const int* __restrict__ run_start,
                    const int* __restrict__ run_dest, int n_partials,
                    const int* __restrict__ empty_keys, int n_empty,
                    T* __restrict__ partial, T* __restrict__ out) {
  const int w = W > 0 ? W : w_arg;
  __shared__ T part[kThreads];
  __shared__ short rs[kTile + 1];
  __shared__ int rd[kTile];
  zero_keys(empty_keys, n_empty, w, out);
  const int t = blockIdx.x;
  const long long r0 = (long long)t * kTile;
  int end;
  const int nq = load_runs(tile_run, run_start, run_dest, t < n_tiles ? t : n_tiles,
                           t < n_tiles ? t + 1 : n_tiles, r0, rs, rd, &end);
  __syncthreads();
  sum_runs<T>(in + r0 * w, w, nq, rs, rd, n_partials, part, partial, out);
}

// A level of a runtime width: one thread per (chunk, column) sums the
// chunk's items in order, rows order[i] (the gather's level 0 of wide rows)
// or items i.
template <typename T, class Tag>
__global__ void __launch_bounds__(kThreads)
chunk_sum_kernel(const T* __restrict__ in, const int* __restrict__ order,
                 const int* __restrict__ chunk_start, int n_chunks, int w,
                 T* __restrict__ out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)n_chunks * w) return;
  long long k = idx / w;
  int l = (int)(idx % w);
  T acc = T(0);
  for (int i = chunk_start[k]; i < chunk_start[k + 1]; ++i) {
    long long row = order != nullptr ? (long long)order[i] : (long long)i;
    acc += in[row * w + l];
  }
  out[idx] = acc;
}

// in (items of w values; level 0 reads rows order[i] when order is given)
// through the levels (chunk offsets levels[lv], sizes[lv] chunks; host
// arrays), then the last level's chunks of each of n_keys keys (key_first)
// into out (key keys[k], or k without keys); the levels' partials go to
// work in turn.
template <typename T, class Tag>
void levels_any(const T* in, const int* order, int w, int n_levels,
                const int* const* levels, const int* sizes, const int* key_first,
                const int* keys, int n_keys, T* work, T* out, cudaStream_t stream) {
  const T* src = in;
  T* dst = work;
  for (int lv = 0; lv < n_levels; ++lv) {
    long long n = (long long)sizes[lv] * w;
    if (n > 0) {
      auto kernel = chunk_sum_kernel<T, Tag>;
      CT_LAUNCH(kernel, ct::ceil_div(n, kThreads), kThreads, stream, src,
                lv == 0 ? order : nullptr, levels[lv], sizes[lv], w, dst);
    }
    src = dst;
    dst += n;
  }
  long long outs = (long long)n_keys * w;
  if (outs > 0) {
    auto kernel = ct::camera_finalize_kernel<T, Tag>;
    CT_LAUNCH(kernel, ct::ceil_div(outs, kThreads), kThreads, stream, src, key_first, keys,
              n_keys, w, out);
  }
}

// the last level's store of a templated width: key keys[k] of out
template <typename T, int W>
struct KeyStore {
  T* out;
  const int* keys;
  __device__ __forceinline__ void put(long long k, int l, T v) const {
    out[(long long)keys[k] * W + l] = v;
  }
};

// Sorted ids: the tile pass, staged or in place (staged: kn.staged, rows of
// at most kStageWidth values; a grid of one block where there are no rows,
// for the zeros), then the levels over the n_partials run partials, which
// work holds first, then the levels' partials.
template <typename T, int W>
int runs_sum(const T* contrib, int B, int w, bool staged, const int* tile_run,
             const int* run_start, const int* run_dest, int n_partials,
             const int* empty_keys, int n_empty, int n_levels, const int* const* levels,
             const int* sizes, const int* fin_first, const int* fin_keys, int n_fin,
             T* work, T* out, cudaStream_t stream) {
  using Tag = SegmentBlockSum;
  const int n_tiles = ct::ceil_div(B, kTile);
  if (staged && w > kStageWidth<T>) return (int)cudaErrorInvalidValue;
  if (staged) {
    if constexpr (W <= kStageWidth<T>) {
      auto kernel = segment_runs_kernel<T, W, Tag>;
      const int grid = n_tiles > 0 ? ct::ceil_div(n_tiles, kStagedTiles) : 1;
      CT_LAUNCH(kernel, grid, kThreads, stream, contrib, B, w, ct::aligned16(contrib),
                n_tiles, tile_run, run_start, run_dest, n_partials, empty_keys, n_empty,
                work, out);
    }
  } else {
    auto kernel = segment_rows_kernel<T, W, Tag>;
    CT_LAUNCH(kernel, n_tiles > 0 ? n_tiles : 1, kThreads, stream, contrib, w, n_tiles,
              tile_run, run_start, run_dest, n_partials, empty_keys, n_empty, work, out);
  }
  T* lv_work = work + (long long)n_partials * w;
  // A templated width's levels go through point_blocks.cuh's level_sums (a
  // block stages a few chunks' items with coalesced loads): one key at
  // w = 8, 0.1096 [0.0643] ms at libmv-Venice and 0.0106 [0.0097] at libmv16
  // against 0.1187 [0.0761] and 0.0143 [0.0134] through levels_any's thread
  // per (chunk, column); w = 80 even (same-card A/B, PERF.md: ab6).
  if constexpr (W > 0) {
    if (n_levels > 0) {
      ct::level_sums<T, Tag, W, W>(work, n_fin, n_levels, levels, sizes, fin_first, lv_work,
                                   KeyStore<T, W>{out, fin_keys}, stream);
      return (int)cudaGetLastError();
    }
  }
  levels_any<T, Tag>(work, nullptr, w, n_levels, levels, sizes, fin_first, fin_keys, n_fin,
                     lv_work, out, stream);
  return (int)cudaGetLastError();
}

template <typename T>
int runs_any_width(const T* contrib, int B, int w, bool staged, const int* tile_run,
                   const int* run_start, const int* run_dest, int n_partials,
                   const int* empty_keys, int n_empty, int n_levels,
                   const int* const* levels, const int* sizes, const int* fin_first,
                   const int* fin_keys, int n_fin, T* work, T* out, cudaStream_t stream) {
  if (w <= 0) return (int)cudaErrorInvalidValue;
  return by_width(w, [&](auto width) {
    return runs_sum<T, decltype(width)::value>(
        contrib, B, w, staged, tile_run, run_start, run_dest, n_partials, empty_keys,
        n_empty, n_levels, levels, sizes, fin_first, fin_keys, n_fin, work, out, stream);
  });
}

// The blocks of the staged tile pass at width w that device `device` holds
// at once: its multiprocessors times the blocks of that kernel one holds
// (kn.staged); 0 for a width the staged pass does not take.
template <typename T>
int staged_resident(int device, int w, int* blocks) {
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (w > 0 && w <= kStageWidth<T>)
    by_width(w, [&](auto width) {
      constexpr int W = decltype(width)::value;
      if constexpr (W <= kStageWidth<T>)
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, segment_runs_kernel<T, W, SegmentBlockSum>, kThreads, 0);
      return 0;
    });
  *blocks = sms * per_sm;
  return (int)cudaGetLastError();
}

// U values of a row from p (a 16-byte group, or 8 bytes of floats, or one
// value), added to acc.
template <typename T>
__device__ __forceinline__ void add_unit(const T* __restrict__ p, int U, T* acc) {
  constexpr int V = ct::Vec16<T>::kN;
  if (U == V) {
    T x[V];
    ct::Vec16<T>::load(p, x);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] += x[e];
  } else if (U == 2) {  // floats only: V = 2 is a double's 16-byte group
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    acc[0] += x.x;
    acc[1] += x.y;
  } else {
    acc[0] += __ldg(p);
  }
}

// The gather's level 0 for rows of at most kGatherWarpBytes (unsorted ids,
// above): a warp per chunk c of at most CT_CHUNK rows of one key, rows
// order[cs[c]] .. order[cs[c+1] - 1], their ids staged with one coalesced
// load. A row is NG units of U values (a 16-byte group, 8 bytes of floats,
// or one value, as the row allows), at most 16 units; lane (j, u) sums unit
// u of rows j, j + RP, ... (RP = 32 / NG >= 2 row phases), and the phases
// are summed in order.
template <typename T, class Tag>
__global__ void __launch_bounds__(kThreads)
gather_chunks_kernel(const T* __restrict__ in, const int* __restrict__ order,
                     const int* __restrict__ cs, int n_chunks, int w, int U,
                     T* __restrict__ out) {
  constexpr int V = ct::Vec16<T>::kN, kWarps = kThreads / 32;
  __shared__ int rows[kWarps][CT_CHUNK];
  __shared__ T part[kWarps][32 * V];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c = blockIdx.x * kWarps + warp;
  const int s = c < n_chunks ? cs[c] : 0, n = c < n_chunks ? cs[c + 1] - s : 0;
  for (int i = lane; i < n; i += 32) rows[warp][i] = __ldg(order + s + i);
  __syncthreads();
  const int NG = w / U, RP = 32 / NG;
  const int j = lane / NG, u = lane - j * NG;
  if (j < RP) {
    T acc[V] = {};
#pragma unroll 4
    for (int r = j; r < n; r += RP) add_unit(in + (long long)rows[warp][r] * w + u * U, U, acc);
    for (int e = 0; e < U; ++e) part[warp][lane * U + e] = acc[e];
  }
  __syncthreads();
  if (c < n_chunks && lane < NG)
    for (int e = 0; e < U; ++e) {
      T sum = T(0);
      for (int k = 0; k < RP; ++k) sum += part[warp][(k * NG + lane) * U + e];
      out[(long long)c * w + lane * U + e] = sum;
    }
}

// Unsorted ids: level 0 by gather_chunks_kernel for rows of at most
// kGatherWarpBytes, by the first port's thread per (chunk, column) for wider
// ones (see above), then the further levels and the last by levels_any.
template <typename T>
int gather_sum(const T* contrib, int w, const int* order, int n_levels,
               const int* const* levels, const int* sizes, const int* key_first, int K,
               T* work, T* out, cudaStream_t stream) {
  using Tag = UnsortedSegmentSum;
  constexpr int V = ct::Vec16<T>::kN;
  if (w <= 0 || n_levels < 1) return (int)cudaErrorInvalidValue;
  const T* in = contrib;
  const int* rows = order;
  if (w * (int)sizeof(T) <= kGatherWarpBytes) {
    const bool vec = ct::aligned16(contrib);
    const int U = vec && w % V == 0 ? V : (vec && V == 4 && w % 2 == 0 ? 2 : 1);
    if (sizes[0] > 0) {
      auto kernel = gather_chunks_kernel<T, Tag>;
      CT_LAUNCH(kernel, ct::ceil_div(sizes[0], kThreads / 32), kThreads, stream, contrib,
                order, levels[0], sizes[0], w, U, work);
    }
    in = work;  // the levels go on from level 0's partials
    rows = nullptr;
    work += (long long)sizes[0] * w;
    ++levels;
    ++sizes;
    --n_levels;
  }
  levels_any<T, Tag>(in, rows, w, n_levels, levels, sizes, key_first, nullptr, K, work,
                     out, stream);
  return (int)cudaGetLastError();
}

}  // namespace

// Sorted ids: contrib (B, w) -> out (K, w) through the run plan, tile_run
// (n_tiles + 1,), run_start (n_runs + 1,) and run_dest (n_runs,), by the
// staged tile pass if `staged` (rows of at most 64 bytes) or in place;
// empty_keys (n_empty,) the keys of no row; the levels over the n_partials
// run partials (host arrays levels and sizes of n_levels entries),
// fin_first (n_fin + 1,) and fin_keys (n_fin,). Workspace: work (n_partials
// + sum of sizes, w).
#define CT_SEGMENT_SUM_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* contrib, int B, int w, int staged,                  \
                      const int* tile_run, const int* run_start,                   \
                      const int* run_dest, int n_partials, const int* empty_keys,  \
                      int n_empty, int n_levels, const int* const* levels,         \
                      const int* sizes, const int* fin_first, const int* fin_keys, \
                      int n_fin, T* work, T* out, cudaStream_t stream) {           \
    return runs_any_width<T>(contrib, B, w, staged != 0, tile_run, run_start,      \
                             run_dest, n_partials, empty_keys, n_empty, n_levels,  \
                             levels, sizes, fin_first, fin_keys, n_fin, work, out, \
                             stream);                                              \
  }

// The staged tile pass's blocks that fill device `device` at width w
// (kn.staged): its multiprocessors times the blocks one holds at once.
#define CT_STAGED_RESIDENT_ENTRY(NAME, T)                                           \
  extern "C" int NAME(int device, int w, int* blocks) {                            \
    return staged_resident<T>(device, w, blocks);                                  \
  }

// Unsorted ids: order (B,) the rows by id (stable); levels (host arrays of
// n_levels) chunk them, then each key's chunk partials; key_first (K + 1,)
// each key's chunks of the last level. Workspace: work (sum of sizes, w).
#define CT_UNSORTED_SUM_ENTRY(NAME, T)                                              \
  extern "C" int NAME(const T* contrib, int B, int w, const int* order,            \
                      int n_levels, const int* const* levels, const int* sizes,    \
                      const int* key_first, int K, T* work, T* out,                \
                      cudaStream_t stream) {                                       \
    (void)B;                                                                       \
    return gather_sum<T>(contrib, w, order, n_levels, levels, sizes, key_first, K, \
                         work, out, stream);                                       \
  }

CT_SEGMENT_SUM_ENTRY(ct_segment_block_sum_f64, double)
CT_SEGMENT_SUM_ENTRY(ct_segment_block_sum_f32, float)
CT_STAGED_RESIDENT_ENTRY(ct_segment_block_sum_resident_f64, double)
CT_STAGED_RESIDENT_ENTRY(ct_segment_block_sum_resident_f32, float)
CT_UNSORTED_SUM_ENTRY(ct_unsorted_segment_sum_f64, double)
CT_UNSORTED_SUM_ENTRY(ct_unsorted_segment_sum_f32, float)
