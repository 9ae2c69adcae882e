// segment_spread_sum: the dense-Schur A of one camera-side slot, on the
// generic flat Schur path (solvers/fused_lm.py, FlatDenseSchurStepOps) and on
// the specialized BA pipeline (parallel/sharded_ba.py, lm_step_schur):
//   out[p, i*C*tf + c*tf + j] = sum over the rows b of point p with
//                               cam[b] = c of Y[b, i*tf + j]
// for Y (B, te*tf) = K_p W_b, rows sorted by point (pt_start gives each
// point's rows), C camera blocks of tf columns; a camera id outside [0, C)
// (a constant block) adds nothing.
//
// Replaces segment_spread_sum (ceres_tpu/ops/pallas_kernels.py:462) in both
// its forms. The TPU kernel builds the (rows, te*C*tf) spread of a 128-row
// tile in VMEM with two selector matmuls and reduces it to points with a
// one-hot dot, so that the spread never reaches HBM. Here the spread never
// exists at all.
//
// With Jc (B, 2*9), the scaled camera Jacobian rows (the form the TPU kernel
// calls at :734), the call also forms the camera Gram blocks
//   ftf[c, i*9 + j] = sum over the rows b of camera c of
//                     sum_{q<2} Jc[b, q*9 + i] Jc[b, q*9 + j].
// The TPU kernel accumulates them across its sequential grid as a
// Khatri-Rao masked Gram of hi/lo bf16 halves.
//
// What bounds it on an H100: bytes, dominated by the output A (P te C tf
// values, most of them zero: 76 MB at BAL-16 in float64, against 18 MB of
// Y and 12 MB of Jc). The first design gave each point a block that zeroed
// its slab in device memory and then added each row into it, a
// read-modify-write of 9 values at a time by 27 of 128 threads; its F'F
// took chunks of 64 rows of one camera and a serial pass over each
// camera's chunk partials. Design, no atomics (every sum has a fixed order):
// 1. The slab pass (both forms): a block forms a stretch of A of up to
//    24 KB in shared memory, the slabs of a tile of consecutive points (or
//    a piece of one point's slab, for a slab wider than that): it zeroes
//    the stretch, thread (point, i, j) adds the point's rows in row order
//    into the entry of each row's camera, and the block writes the stretch
//    out once, in whole 16-byte groups where the addresses allow (single
//    values at the stretch's edges). So each entry of A is written once and
//    never read back from device memory, and A holds exactly the first
//    design's sums: 0 plus the rows in row order. (A thread per 16-byte
//    group of A that walked its point's rows for each of its values, tried
//    first, was slower than the first design at BAL-16: 9.5M values each
//    scanning its point's rows, nearly all of them to find no row.)
// 2. The F'F blocks (the Jc form): the point-block passes of
//    point_blocks.cuh with the SpreadFtF body: each row stages its 18 Jc
//    values by its run, threads over (run, entry) form the 45 upper entries
//    of each run's Gram sum in row order (the runs of one camera within a
//    tile of rows, RowPlan.run_*), and the camera levels sum the runs, each
//    (chunk, entry) in 5 interleaved parts; the last level writes each
//    entry to both of its places in the 9 x 9 block.
// 3. The F'F passes wait on the latency of their phases, the slab pass on
//    device memory: the F'F passes run on a second stream of the highest
//    priority beside the slab pass (Side), and the call's stream waits for
//    them.
#include <mutex>

#include "point_blocks.cuh"

namespace ct {

constexpr int kSpreadThreads = 256;
constexpr int kSlabBytes = 24576;  // a block's stretch of A in shared memory

// The slab pass's shape: the points of a block's tile, or the pieces of a
// point's slab where one is wider than the block's stretch of shared
// memory (kCap values); and its blocks.
template <typename T>
struct Slab {
  const T* Y;
  const int* cam;
  const int* pt_start;
  int P, C, te, tf;
  int tile_points, pieces;
  T* out;
  static constexpr int kCap = kSlabBytes / sizeof(T);

  static Slab make(const T* Y, const int* cam, const int* pt_start, int P, int C, int te,
                   int tf, T* out) {
    const long long W = (long long)te * C * tf;
    const int pieces = W > kCap ? (int)((W + kCap - 1) / kCap) : 1;
    const int tile_points = W <= kCap && W > 0 ? (int)(kCap / W) : 1;
    return {Y, cam, pt_start, P, C, te, tf, tile_points, pieces, out};
  }
  long long blocks() const {
    const long long W = (long long)te * C * tf;
    if (P <= 0 || W <= 0) return 0;
    return pieces > 1 ? (long long)P * pieces : ceil_div(P, tile_points);
  }
  bool fits() const {  // a block's offsets in int
    return blocks() <= 0x7fffffff && (long long)te * C * tf <= 0x7fffffff;
  }

  // Block k forms the stretch [e0, e0 + len) of A in shared memory sh: the
  // slabs of tile_points whole points from point k * tile_points, or the
  // piece k % pieces of point k / pieces. Zero the stretch; thread (point,
  // i, j) adds the point's rows in row order into its camera's entry; then
  // write the stretch out, whole 16-byte groups where the addresses allow.
  // blockDim.x threads; every thread of the block calls it.
  __device__ void block(int k, T* sh) const {
    constexpr int V = Vec16<T>::kN;
    const int tid = threadIdx.x, nt = blockDim.x;
    const int ky = te * tf, ct = C * tf, W = te * ct;
    int p0, np, w0, len;  // first point, points, first entry in its slab, entries
    if (pieces > 1) {
      p0 = k / pieces, np = 1;
      w0 = (k % pieces) * kCap;
      len = W - w0 < kCap ? W - w0 : kCap;
    } else {
      p0 = k * tile_points;
      np = P - p0 < tile_points ? P - p0 : tile_points;
      w0 = 0, len = np * W;
    }
    for (int e = tid; e < len; e += nt) sh[e] = T(0);
    __syncthreads();
    for (int t = tid; t < np * ky; t += nt) {
      const int q = t / ky, ij = t % ky;
      const int at = q * W + ij / tf * ct + ij % tf - w0;  // entry (q, i, 0, j)
      const int b1 = __ldg(pt_start + p0 + q + 1);
      for (int b = __ldg(pt_start + p0 + q); b < b1; ++b) {
        const int c = __ldg(cam + b);
        const T y = __ldg(Y + (long long)b * ky + ij);
        // one test for the camera and the stretch, after both loads are in
        // flight (a branch on the camera first serialized them: slower)
        const int e = at + (int)((unsigned)c * (unsigned)tf);
        if (c >= 0 && c < C && e >= 0 && e < len) sh[e] += y;
      }
    }
    __syncthreads();
    const long long e0 = (long long)p0 * W + w0;
    const int h = (int)((V - e0 % V) % V) < len ? (int)((V - e0 % V) % V) : len;
    const int ng = (len - h) / V;
    for (int g = tid; g < ng; g += nt) {
      T x[V];
#pragma unroll
      for (int v = 0; v < V; ++v) x[v] = sh[h + g * V + v];
      Vec16<T>::store(out + e0 + h + g * V, x);
    }
    for (int e = tid; e < h; e += nt) out[e0 + e] = sh[e];
    for (int e = h + ng * V + tid; e < len; e += nt) out[e0 + e] = sh[e];
  }
};

template <typename T>
__global__ void __launch_bounds__(kSpreadThreads)
spread_slab_kernel(const Slab<T> slab) {
  __shared__ T sh[Slab<T>::kCap];
  slab.block(blockIdx.x, sh);
}

// The F'F body of the point-block passes: a row stages its two Jc rows; a
// run's item e is entry (a, c), a <= c, of the sum of its rows' outer
// products, in row order.
template <typename T>
struct SpreadFtF {
  static constexpr int kPt = 0, kCam = kUpper;
  static constexpr int kStage = kR * kTF;  // Jc's 18 values
  static constexpr int kRunItems = kUpper;
  static constexpr int kMinBlocks = sizeof(T) == 8 ? 3 : 5;
  static constexpr bool kFinish = false, kRuns = true, kRowsOut = false;
  // the camera levels' (chunk, entry) sums in 5 parts: their few blocks'
  // loads of the runs wait on device memory that the slab pass beside them
  // keeps busy
  static constexpr int kWideParts = 5;
  struct Reg {
    T s[kStage];
  };
  const T* Jc;  // (B, 18)
  CamRuns<T> cam;

  __device__ __forceinline__ void load(long long b, Reg& g) const {
    const T* src = Jc + b * kStage;
#pragma unroll
    for (int a = 0; a < kStage; ++a) g.s[a] = __ldg(src + a);
  }
  __device__ __forceinline__ void point_values(const Reg&, T*) const {}
  __device__ __forceinline__ void point_out(long long, T) const {}
  __device__ __forceinline__ void camera_values(const Reg& g, const T*, T* v) const {
#pragma unroll
    for (int a = 0; a < kStage; ++a) v[a] = g.s[a];
  }
  __device__ __forceinline__ Entry entry(int e) const { return upper_entry(e); }
  __device__ __forceinline__ void run_put(const T* r, int n, int i, Entry e, T* w) const {
    const int a = e.i, c = e.j;
    T s = T(0);
    for (int k = 0; k < n; ++k, r += kStage) {
      s += r[a] * r[c];
      s += r[kTF + a] * r[kTF + c];
    }
    w[i] = s;
  }
};

// A second stream of each device, of the highest priority, and two events:
// 8J forks its F'F passes (bound by the latency of their phases) onto it,
// so that they run beside the slab pass (bound by device memory), their
// blocks first whenever a multiprocessor frees, and joins them back before
// the call returns. Made at a device's first 8J call.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

inline int side_of_current_device(Side** side) {
  static std::mutex mu;
  static Side sides[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  Side& s = sides[dev];
  if (s.stream == nullptr) {
    int least = 0, greatest = 0;
    cudaDeviceGetStreamPriorityRange(&least, &greatest);
    cudaStreamCreateWithPriority(&s.stream, cudaStreamNonBlocking, greatest);
    cudaEventCreateWithFlags(&s.fork, cudaEventDisableTiming);
    cudaEventCreateWithFlags(&s.join, cudaEventDisableTiming);
  }
  *side = &s;
  return (int)cudaGetLastError();
}

template <typename T>
int spread_ftf(const T* Y, const int* cam, const int* pt_start, int P, int C, int te,
               int tf, T* out, const T* Jc, const int* plan_pt_start, const int* pt_block,
               int n_pt_blocks, const int* tile_first, const int* tile_run,
               const int* run_start, const int* run_slot, const int* run_pos, int n_levels,
               const int* const* levels, const int* sizes, const int* cam_first, T* w,
               T* work, T* ftf, cudaStream_t stream) {
  using Body = SpreadFtF<T>;
  const auto slab = Slab<T>::make(Y, cam, pt_start, P, C, te, tf, out);
  if (tf != kTF || !slab.fits()) return (int)cudaErrorInvalidValue;
  Side* side = nullptr;
  if (const int rc = side_of_current_device(&side)) return rc;
  cudaEventRecord(side->fork, stream);
  cudaStreamWaitEvent(side->stream, side->fork, 0);
  if (n_pt_blocks > 0) {
    const Body body{Jc, {tile_first, tile_run, run_start, run_slot, run_pos, w}};
    auto pass = point_pass_kernel<T, Body>;
    CT_LAUNCH(pass, n_pt_blocks, kBlock, side->stream, body, plan_pt_start, pt_block);
  }
  level_sums<T, Body, kUpper, kUpper>(w, C, n_levels, levels, sizes, cam_first, work,
                                      MirrorStore<T>{ftf}, side->stream);
  cudaEventRecord(side->join, side->stream);
  if (slab.blocks() > 0)
    CT_LAUNCH(spread_slab_kernel<T>, (int)slab.blocks(), kSpreadThreads, stream, slab);
  cudaStreamWaitEvent(stream, side->join, 0);
  return (int)cudaGetLastError();
}

}  // namespace ct

// Y (B, te*tf), cam (B,), pt_start (P+1,) -> out (P, te*C*tf).
#define CT_SPREAD_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* Y, const int* cam, const int* pt_start, int P,    \
                      int C, int te, int tf, T* out, cudaStream_t stream) {      \
    const auto slab = ct::Slab<T>::make(Y, cam, pt_start, P, C, te, tf, out);   \
    if (!slab.fits()) return (int)cudaErrorInvalidValue;                         \
    if (slab.blocks() > 0)                                                       \
      CT_LAUNCH(ct::spread_slab_kernel<T>, (int)slab.blocks(), ct::kSpreadThreads, \
                stream, slab);                                                   \
    return (int)cudaGetLastError();                                              \
  }

CT_SPREAD_ENTRY(ct_segment_spread_sum_f64, double)
CT_SPREAD_ENTRY(ct_segment_spread_sum_f32, float)

// The same, plus Jc (B, 18) (r = 2 rows of tf = 9 camera columns) -> ftf
// (C, 81) row-major blocks, through the row plan of these rows: its
// pt_start (covering B) and pt_block (n_pt_blocks + 1,), the runs
// (RowPlan.run_*: tile_first (n_pt_blocks + 1,), tile_run (n_tiles + 1,),
// run_start (n_runs + 1,), run_slot (B,), run_pos (n_runs,)), levels,
// sizes (host arrays of n_levels) and cam_first (C + 1,) the runs' camera
// levels. Workspace: w (n_runs, 45), work (sum of sizes, 45). The point
// pass and the camera levels run on the device's second stream (Side),
// beside the slab pass on `stream`, which waits for them before anything
// after the call.
#define CT_SPREAD_FTF_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* Y, const int* cam, const int* pt_start, int P, int C,  \
                      int te, int tf, T* out, const T* Jc, const int* plan_pt_start, \
                      const int* pt_block, int n_pt_blocks, const int* tile_first,   \
                      const int* tile_run, const int* run_start,                     \
                      const int* run_slot, const int* run_pos, int n_levels,         \
                      const int* const* levels, const int* sizes,                    \
                      const int* cam_first, T* w, T* work, T* ftf,                   \
                      cudaStream_t stream) {                                         \
    return ct::spread_ftf<T>(Y, cam, pt_start, P, C, te, tf, out, Jc, plan_pt_start, \
                             pt_block, n_pt_blocks, tile_first, tile_run, run_start, \
                             run_slot, run_pos, n_levels, levels, sizes, cam_first,  \
                             w, work, ftf, stream);                                  \
  }

CT_SPREAD_FTF_ENTRY(ct_segment_spread_ftf_f64, double)
CT_SPREAD_FTF_ENTRY(ct_segment_spread_ftf_f32, float)
