// The row-parallel point-block design that isc_matvec (row 4b),
// normal_matvec (row 4), post_eval_fused (row 2), schur_jacobi (rows 3b
// and 5) and schur_assembly (row 3) share: each reads the 24 lanes of J
// once per row, sums per-row values per point and sums per-row values per
// camera. 8J's F'F blocks (segment_spread.cu) take its camera sums by runs
// over the rows of Jc. Each source keeps its entry point and its own
// per-row body; this header holds the rest.
//
// What bounds them on an H100: bytes (~100 to ~700 flops per row against
// 24 values of J read). So neighbouring threads read neighbouring rows of
// JT's lanes, and nothing of J is read twice (but for a point longer than
// a block):
// 1. Point pass, one thread per row. A block owns the rows of whole points
//    (RowPlan.pt_block: at most kBlock rows and points), loads each row's
//    lanes coalesced into registers (the body's load), puts the row's
//    per-point values in shared memory, and sums them per point in row
//    order: one thread per (point, value) writes a coalesced point table,
//    or, for a body that needs its point's sum back (isc_matvec's u), one
//    thread per point passes the sums through the body's finish and hands
//    the result to the point's rows. Each row then forms its per-camera
//    values from its registers and writes them, padded to whole 16-byte
//    groups, at its place in camera order (RowPlan.cam_pos). A body with
//    wide camera values (post_eval_fused's 18, schur_jacobi's 45,
//    schur_assembly's 99) instead stages kStage values per row in shared
//    memory, sums each camera value over each run of one camera within the
//    block's rows (RowPlan.run_*: 0.42 runs per row at the Venice shape;
//    the body's run_put forms values from the run's staged rows, so 45
//    entries of J_f'H J_f come from 21 staged values), and writes one row
//    per run at the run's place in camera order. The block
//    stages its points' row starts and its runs' starts and places in
//    shared memory first: what bounds it beside the bytes is the latency
//    of its phases between syncs, not their arithmetic. A point with more
//    rows than a block holds owns a block that loops over tiles of kBlock
//    rows (a body with finish reads its J twice).
// 2. Camera pass: the rows (or runs) in camera order are a sorted segment
//    sum through the fixed tree of levels of the row plan (cam_levels or
//    run_levels): a block stages the items of a few consecutive chunks with
//    coalesced loads, sums each (chunk, value) in interleaved parts and the
//    parts in order (items wider than 36 values: in order, straight from
//    device memory, or in a body's kWideParts interleaved parts, each from
//    device memory, and the parts in order); the last level sums each
//    camera's chunks and hands each sum to a store (a camera table, or a
//    body's own layout: the mirrored 9 x 9 blocks of rows 3, 5 and 8J).
//    Row 3's camera-pair sums go through the same levels.
// No atomics anywhere: every sum has a fixed order, so a solve repeats bit
// for bit, and each point's values are summed in row order.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace ct {

constexpr int kBlock = 256;  // rows and points of a point block: kn.POINT_BLOCK
constexpr int kSub = 7;      // parts of a (chunk, value) sum of the camera pass

// W values padded to whole 16-byte groups: the row stride of a padded table
template <typename T, int W>
constexpr int kPad = (W + Vec16<T>::kN - 1) / Vec16<T>::kN * Vec16<T>::kN;

// the row stride of a table of runs: padded for the camera pass's 16-byte
// loads up to 36 values, unpadded above (the pass reads wide items by value)
template <typename T, int W>
constexpr int kRunStride = W > 36 ? W : kPad<T, W>;

template <typename T>
struct Row {
  T f[2 * kTF];  // J_f, residual row i at i * 9
  T e[2 * kTE];  // J_e, residual row i at i * 3
};

// row b's 24 lanes: neighbouring threads, neighbouring rows of each lane
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ JT, long long B,
                                         long long b, Row<T>& j) {
#pragma unroll
  for (int i = 0; i < 2 * kTF; ++i) j.f[i] = __ldg(JT + i * B + b);
#pragma unroll
  for (int i = 0; i < 2 * kTE; ++i) j.e[i] = __ldg(JT + (kEOff + i) * B + b);
}

// v (kPad<T, W> values, the tail zero) in whole 16-byte stores
template <typename T, int W>
__device__ __forceinline__ void store_padded(T* __restrict__ dst, const T* v) {
  constexpr int V = Vec16<T>::kN;
#pragma unroll
  for (int a = 0; a < kPad<T, W>; a += V) Vec16<T>::store(dst + a, v + a);
}

// a padded table's row (kPad<T, W> values) in whole 16-byte loads
template <typename T, int W>
__device__ __forceinline__ void load_padded(const T* __restrict__ src, T* v) {
  constexpr int V = Vec16<T>::kN;
#pragma unroll
  for (int a = 0; a < kPad<T, W>; a += V) Vec16<T>::load(src + a, v + a);
}

// in (n, W) -> out (n, kPad<T, W>): a camera table the rows gather padded
// (Body only names the kernel in a profile)
template <typename T, class Body>
__global__ void pad_kernel(const T* __restrict__ in, int n, T* __restrict__ out) {
  constexpr int W = Body::kCam, S = kPad<T, W>;
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n * S) return;
  int c = idx / S, l = idx - c * S;
  out[idx] = l < W ? in[c * W + l] : T(0);
}

// Where the per-camera values go: at each row's place in camera order
// (RowPlan.cam_pos), or summed over each run of one camera within a tile of
// rows and written at the run's place in camera order (RowPlan.run_*).
template <typename T>
struct CamRows {
  const int* cam_pos;  // (B,)
  T* w;                // (B, kPad)
};
template <typename T>
struct CamRuns {
  const int* tile_first;  // (n_pt_blocks + 1,) first tile of each point block
  const int* tile_run;    // (n_tiles + 1,) first run of each tile
  const int* run_start;   // (n_runs + 1,) each run's first place in run order
  const int* run_slot;    // (B,) each row's place in run order: (tile, camera, row)
  const int* run_pos;     // (n_runs,) each run's place in camera order
  T* w;                   // (n_runs, kPad)
};

// A body (one per kernel) provides:
//   kPt, kCam             per-row values summed per point / per camera
//   kFinish               whether rows need their point's sums back
//   kRuns                 whether its camera values go by runs (CamRuns)
//   kStage                (kRuns) values a row stages for its run's sums
//   kRunItems             (kRuns) items a run's camera values are formed in
//   entry(a)              (kRuns) what run_put needs of item a
//   run_put(r, n, a, e, w) (kRuns) item a (e = entry(a)) of a run from its
//                         n rows' staged values at r (stride kStage, in row
//                         order), written to its camera values at w
//   kRowsOut              (kRuns) whether it writes a table by rows:
//   rows_out(g, r0, m, sh) (kRowsOut) called by every thread after the
//                         tile's loads; sh is free on entry and on return
//   kMinBlocks            blocks per SM the point pass keeps its registers for
//   Reg                   what a row keeps in registers
//   load(b, g)            row b into g
//   point_values(g, v)    kPt values of the row
//   point_out(i, s)       (no kFinish) value i of the flat (P, kPt) point
//                         table, s the sum over the point's rows
//   finish(p, s, u)       (kFinish) point p's kPt sums -> kPt values its rows read
//   camera_values(g, u, v) kCam values of the row (u: finish's, or null), or
//                         (kRuns) its kStage staged values
//   cam                   its CamRows or CamRuns

// the values a row stages in shared memory for its run's sums
template <class Body>
__host__ __device__ constexpr int kStageOf() {
  if constexpr (Body::kRuns) return Body::kStage;
  else return 0;
}

constexpr int kUpper = kTF * (kTF + 1) / 2;  // 45 entries of a 9 x 9 upper triangle

// an entry (i, j) of a 9 x 9 block
struct Entry {
  int i, j;
};

// the (i, j), i <= j, of entry e of a 9 x 9 block's upper triangle, row by
// row: e = 0 .. 44
__host__ __device__ inline Entry upper_entry(int e) {
  int i = 0;
  while (e >= kTF - i) e -= kTF - i++;
  return {i, i + e};
}

// the last camera level's store of a sum of 9 x 9 blocks by their upper
// triangles (rows 3b/5 and 8J): entry e of camera c's upper triangle to
// both of its places in the camera's 9 x 9 block
template <typename T>
struct MirrorStore {
  T* out;  // (C, 81)
  __device__ __forceinline__ void put(long long c, int e, T v) const {
    const Entry ab = upper_entry(e);
    out[c * kTF * kTF + ab.i * kTF + ab.j] = v;
    out[c * kTF * kTF + ab.j * kTF + ab.i] = v;
  }
};

// Rows r0 .. r0 + m (thread tid < m holds row r0 + tid in g) write their
// camera values, padded, at their places in camera order.
template <typename T, class Body>
__device__ __forceinline__ void camera_rows(const Body& body, long long r0, int m,
                                            const typename Body::Reg& g, const T* u) {
  constexpr int NC = Body::kCam, S = kPad<T, NC>;
  const int tid = threadIdx.x;
  if (tid < m) {
    T v[S];
    body.camera_values(g, u, v);
#pragma unroll
    for (int a = NC; a < S; ++a) v[a] = T(0);
    store_padded<T, NC>(body.cam.w + (long long)__ldg(body.cam.cam_pos + r0 + tid) * S, v);
  }
}

// The rows of tile `tile` (r0 .. r0 + m, m <= kBlock): thread tid < m loads
// row r0 + tid into g and puts its point values in sh. A body by runs first
// writes its table by rows (kRowsOut), stages the row's kStage values at its
// place in the tile's run order in sh, forms each (run, item) from the
// run's rows (contiguous there, in row order) and writes the run's row:
// its J_f is dead before the block waits, and only what its point values
// need stays in registers. Every thread of the block calls it; sh is free
// on entry.
template <typename T, class Body>
__device__ __forceinline__ void tile_rows(const Body& body, int tile, long long r0, int m,
                                          typename Body::Reg& g, T* sh) {
  const int tid = threadIdx.x;
  if (tid < m) body.load(r0 + tid, g);
  if constexpr (Body::kRuns) {
    if constexpr (Body::kRowsOut) body.rows_out(g, r0, m, sh);
    constexpr int NI = Body::kRunItems, NS = Body::kStage, S = kRunStride<T, Body::kCam>;
    if (tid < m) {
      T v[NS];
      body.camera_values(g, nullptr, v);
      T* dst = sh + (__ldg(body.cam.run_slot + r0 + tid) - r0) * NS;
#pragma unroll
      for (int a = 0; a < NS; ++a) dst[a] = v[a];
    }
    __shared__ short rs[kBlock + 1];  // the tile's runs: starts from r0, places
    __shared__ int rp[kBlock];
    const int q0 = __ldg(body.cam.tile_run + tile);
    const int nq = __ldg(body.cam.tile_run + tile + 1) - q0;
    for (int i = tid; i <= nq; i += kBlock) {
      rs[i] = (short)(__ldg(body.cam.run_start + q0 + i) - r0);
      if (i < nq) rp[i] = __ldg(body.cam.run_pos + q0 + i);
    }
    __syncthreads();
    // thread (run q, item a): runs q = tid / NI, + QS, ...; a and what
    // run_put needs of it fixed
    constexpr int QS = kBlock / NI;
    static_assert(QS >= 1, "a thread per item of a run");
    if (tid < QS * NI) {
      const int a = tid % NI;
      const auto e = body.entry(a);
      for (int q = tid / NI; q < nq; q += QS)
        body.run_put(sh + rs[q] * NS, rs[q + 1] - rs[q], a, e,
                     body.cam.w + (long long)rp[q] * S);
    }
    __syncthreads();
  }
  if (tid < m) body.point_values(g, sh + tid * Body::kPt);
}

// The block of one point p of n > kBlock rows from row r0: tiles of kBlock
// rows in turn; thread k < kPt sums value k over the rows in row order.
template <typename T, class Body>
__device__ void long_point(const Body& body, int blk, int p, long long r0, int n,
                           T* sh) {
  constexpr int NP = Body::kPt;
  const int tid = threadIdx.x;
  int tile = 0;
  if constexpr (Body::kRuns) tile = __ldg(body.cam.tile_first + blk);
  T acc = T(0);
  for (int c = 0; c < n; c += kBlock, ++tile) {
    const int m = n - c < kBlock ? n - c : kBlock;
    typename Body::Reg g;
    tile_rows<T>(body, tile, r0 + c, m, g, sh);
    __syncthreads();
    if (tid < NP)
      for (int r = 0; r < m; ++r) acc += sh[r * NP + tid];
    if constexpr (!Body::kFinish && !Body::kRuns) camera_rows<T>(body, r0 + c, m, g, nullptr);
    __syncthreads();
  }
  if constexpr (!Body::kFinish) {
    if (tid < NP) body.point_out((long long)p * NP + tid, acc);
  } else {
    if (tid < NP) sh[tid] = acc;
    __syncthreads();
    if (tid == 0) body.finish(p, sh, sh + NP);
    __syncthreads();
    for (int c = 0; c < n; c += kBlock) {
      const int m = n - c < kBlock ? n - c : kBlock;
      typename Body::Reg g;
      if (tid < m) body.load(r0 + c + tid, g);
      camera_rows<T>(body, r0 + c, m, g, sh + NP);
    }
  }
}

template <typename T, class Body>
__global__ void __launch_bounds__(kBlock, Body::kMinBlocks)
point_pass_kernel(const Body body, const int* __restrict__ pt_start,
                  const int* __restrict__ pt_block) {
  constexpr int NP = Body::kPt, NS = kStageOf<Body>();
  static_assert(!(Body::kFinish && Body::kRuns), "finish hands values through sh");
  __shared__ T sh[kBlock * (NS > NP ? NS : NP)];
  const int tid = threadIdx.x;
  const int p0 = pt_block[blockIdx.x], p1 = pt_block[blockIdx.x + 1];
  const long long r0 = pt_start[p0];
  const int n = (int)(pt_start[p1] - r0);
  if (n > kBlock) {  // the block's one point (block-uniform)
    long_point<T>(body, blockIdx.x, p0, r0, n, sh);
    return;
  }
  int tile = 0;
  if constexpr (Body::kRuns) tile = __ldg(body.cam.tile_first + blockIdx.x);
  __shared__ int ps[Body::kFinish || NP == 0 ? 1 : kBlock + 1];  // point starts, from r0
  if constexpr (!Body::kFinish && NP > 0)
    for (int i = tid; i <= p1 - p0; i += kBlock) ps[i] = (int)(pt_start[p0 + i] - r0);
  typename Body::Reg g;
  tile_rows<T>(body, tile, r0, n, g, sh);
  __syncthreads();
  if constexpr (Body::kFinish) {
    // one thread per point: its rows' values in row order, through finish,
    // handed back to its rows' slots
    const int p = p0 + tid;
    if (p < p1) {
      const int a = (int)(pt_start[p] - r0), e = (int)(pt_start[p + 1] - r0);
      T s[NP] = {};
      for (int r = a; r < e; ++r)
#pragma unroll
        for (int k = 0; k < NP; ++k) s[k] += sh[r * NP + k];
      T u[NP];
      body.finish(p, s, u);
      for (int r = a; r < e; ++r)
#pragma unroll
        for (int k = 0; k < NP; ++k) sh[r * NP + k] = u[k];
    }
    __syncthreads();
    camera_rows<T>(body, r0, n, g, sh + tid * NP);
  } else {
    // one thread per (point, value): its rows in row order, written to the
    // point table coalesced
    if constexpr (NP > 0) {
      const int nv = (p1 - p0) * NP;
      for (int i = tid; i < nv; i += kBlock) {
        const int q = i / NP, k = i % NP;
        T s = T(0);
        for (int r = ps[q]; r < ps[q + 1]; ++r) s += sh[r * NP + k];
        body.point_out((long long)p0 * NP + i, s);
      }
    }
    if constexpr (!Body::kRuns) camera_rows<T>(body, r0, n, g, nullptr);
  }
}

// The parts a (chunk, value) sum of wide items (more than 36 values) is cut
// into, interleaved, and then summed in order: a body's kWideParts, or 1
// (the chunk's items in order).
template <class Tag, class = void>
struct WideParts {
  static constexpr int value = 1;
};
template <class Tag>
struct WideParts<Tag, std::void_t<decltype(Tag::kWideParts)>> {
  static constexpr int value = Tag::kWideParts;
};

// chunks of W-wide items that a block of the camera pass sums
template <int W, int NP = 1>
constexpr int kTileChunks = W <= 36 ? 36 / W : kBlock / (W * NP);

// Where a level's sums go: value l of key k of a (n, W) table. The last
// level of a body with its own output layout hands its sums to the body's
// store instead.
template <typename T, int W>
struct TableStore {
  T* out;
  __device__ __forceinline__ void put(long long k, int l, T v) const { out[k * W + l] = v; }
};

// One level of a sum by keys: block k sums chunks [k kTileChunks, ...) of
// `in` (items of W values at stride IS in key order; chunk c covers items
// cs[c] .. cs[c+1], at most CT_CHUNK, never across a key) and hands each
// chunk's sums to st. Tag (a body) only names the kernel in a profile.
// Items of up to 36 values: the block stages its chunks' items with
// coalesced loads (level 0 of the camera pass reads the padded rows with
// 16-byte loads) and sums each (chunk, value) in kSub interleaved parts and
// the parts in order. Wider items (45, 54, 81 values): a thread per (chunk,
// value) sums the chunk's items in order straight from device memory, a
// warp reading a stretch of one item's values.
template <typename T, class Tag, int W, int IS, class Store>
__global__ void __launch_bounds__(kBlock)
camera_level_kernel(const T* __restrict__ in, const int* __restrict__ cs, int n_chunks,
                    const Store st) {
  constexpr int NP = WideParts<Tag>::value;
  constexpr int TC = kTileChunks<W, NP>, V = Vec16<T>::kN;
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * TC;
  const int nc = n_chunks - c0 < TC ? n_chunks - c0 : TC;
  if constexpr (W > 36 && NP == 1) {
    const int c = tid / W, l = tid % W;
    if (c < nc) {
      T acc = T(0);
      for (int r = cs[c0 + c]; r < cs[c0 + c + 1]; ++r) acc += __ldg(in + (long long)r * IS + l);
      st.put(c0 + c, l, acc);
    }
    return;
  } else if constexpr (W > 36) {
    // part (chunk c, part g, value l): items g, g + NP, ... of the chunk
    static_assert(TC >= 1, "a thread per part");
    __shared__ T part[TC * NP * W];
    const int c = tid / (NP * W), g = (tid / W) % NP, l = tid % W;
    if (c < nc) {
      const int r1 = cs[c0 + c + 1];
      T acc = T(0);
      for (int r = cs[c0 + c] + g; r < r1; r += NP) acc += __ldg(in + (long long)r * IS + l);
      part[tid] = acc;
    }
    __syncthreads();
    if (tid < nc * W) {
      const int cc = tid / W, ll = tid % W;
      T acc = T(0);
      for (int gg = 0; gg < NP; ++gg) acc += part[(cc * NP + gg) * W + ll];
      st.put(c0 + cc, ll, acc);
    }
    return;
  } else {
    static_assert(TC >= 1 && TC * W * kSub <= kBlock, "a thread per part");
    __shared__ T rows[TC * CT_CHUNK * W];
    __shared__ T part[TC * kSub * W];
    const int s = cs[c0];
    const int nv = (cs[c0 + nc] - s) * IS;
    const T* src = in + (long long)s * IS;
    if constexpr (IS % V == 0) {
      for (int k = tid * V; k < nv; k += kBlock * V) {
        T x[V];
        Vec16<T>::load(src + k, x);
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const int r = (k + q) / IS, l = k + q - r * IS;
          if (l < W) rows[r * W + l] = x[q];
        }
      }
    } else {
      for (int i = tid; i < nv; i += kBlock) rows[i] = __ldg(src + i);
    }
    __syncthreads();
    // part (chunk c, value l, part g): items g, g + kSub, ... of the chunk
    const int c = tid / (kSub * W), l = tid % W, g = (tid / W) % kSub;
    if (c < nc) {
      const int r1 = cs[c0 + c + 1] - s;
      T acc = T(0);
      for (int r = cs[c0 + c] - s + g; r < r1; r += kSub) acc += rows[r * W + l];
      part[tid] = acc;
    }
    __syncthreads();
    if (tid < nc * W) {
      const int cc = tid / W, ll = tid % W;
      T acc = T(0);
      for (int gg = 0; gg < kSub; ++gg) acc += part[(cc * kSub + gg) * W + ll];
      st.put(c0 + cc, ll, acc);
    }
  }
}

// A sum by keys through a fixed tree of levels: `in` holds the items (W
// values at stride IS, in key order); levels[lv] (sizes[lv] + 1,) device
// chunk offsets of level lv (host arrays of n_levels), level 0 chunking the
// items, each further level the partials of the one before; key_first
// (n_keys + 1,) each key's chunks of the last level, whose sums go to
// `last`. work holds every level's partials in turn.
template <typename T, class Tag, int W, int IS, class Store>
void level_sums(const T* in, int n_keys, int n_levels, const int* const* levels,
                const int* sizes, const int* key_first, T* work, const Store& last,
                cudaStream_t stream) {
  const T* src = in;
  T* dst = work;
  for (int lv = 0; lv <= n_levels; ++lv) {
    const bool is_last = lv == n_levels;
    const int* cs = is_last ? key_first : levels[lv];
    const int n = is_last ? n_keys : sizes[lv];
    const int grid = ceil_div(n, kTileChunks<W, WideParts<Tag>::value>);
    if (n > 0 && is_last) {
      auto kernel = lv == 0 ? camera_level_kernel<T, Tag, W, IS, Store>
                            : camera_level_kernel<T, Tag, W, W, Store>;
      CT_LAUNCH(kernel, grid, kBlock, stream, src, cs, n, last);
    } else if (n > 0) {
      using Table = TableStore<T, W>;
      auto kernel = lv == 0 ? camera_level_kernel<T, Tag, W, IS, Table>
                            : camera_level_kernel<T, Tag, W, W, Table>;
      CT_LAUNCH(kernel, grid, kBlock, stream, src, cs, n, Table{dst});
    }
    src = dst;
    dst += (long long)n * W;
  }
}

// The camera pass over the padded items `in` (rows or runs in camera
// order) into the camera table cam_out (C, W): level_sums over the camera
// plan's levels (cam_levels or run_levels) and cam_first (C + 1,), its last
// level's chunks of each camera. A body with its own output layout calls
// level_sums with its store.
template <typename T, class Body>
void camera_levels(const T* in, int C, int n_levels, const int* const* levels,
                   const int* sizes, const int* cam_first, T* work, T* cam_out,
                   cudaStream_t stream) {
  constexpr int W = Body::kCam;
  level_sums<T, Body, W, kPad<T, W>>(in, C, n_levels, levels, sizes, cam_first, work,
                                      TableStore<T, W>{cam_out}, stream);
}

template <typename T>
inline bool aligned16(const T* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15) == 0;
}

}  // namespace ct
