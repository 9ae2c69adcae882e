// post_eval_fused: the per-iteration reduce over J and r.
//   per point p:  g_e = sum J_e' r (3), sqn_e = sum J_e^2 (3), E'E (3x3)
//   per camera c: g_f = sum J_f' r (9), sqn_f = sum J_f^2 (9)
//
// Replaces the Pallas kernel post_eval_fused
// (ceres_tpu/ops/pallas_kernels.py:1780, pallas_call at :2052).
//
// What bounds it on an H100: bytes. It reads J and r once (26 values per
// row) for ~100 flops per row and writes per-point and per-camera tables
// that are small next to J. The first design walked each point's rows with
// one thread per point (neighbouring threads a track apart in J), then
// gathered every row's J_f again by camera chunk, one 32-byte sector per
// value.
// Design: the point-block passes of point_blocks.cuh with this body. Each
// row loads its 24 lanes and 2 residuals coalesced; its 15 point values go
// to shared memory, where one thread per (point, value) sums them in row
// order into ptab, written coalesced. Its 18 camera values are wider than
// the 9 of the matvecs: a padded row each, written and read back, would
// move 1.5 times J's own bytes. So they go by runs: summed in shared memory
// over the rows of each camera within the block's tile (0.42 runs per row at
// the Venice shape, 1/16 at BAL-16), one padded row per run at the run's
// place in camera order (RowPlan.run_*), which the camera pass sums by
// RowPlan.run_levels. The camera values come first, so that only J_e and r
// stay live across the block's syncs: 64 registers a thread, 4 blocks per
// SM in both dtypes.
#include "point_blocks.cuh"

namespace ct {

template <typename T>
struct PostEvalFused {
  static constexpr int kPt = 2 * kTE + kTE * kTE;  // g_e | sqn_e | E'E
  static constexpr int kCam = 2 * kTF;             // g_f | sqn_f
  static constexpr int kStage = kCam, kRunItems = kCam;  // a run's values: its rows' sums
  static constexpr int kMinBlocks = 4;
  static constexpr bool kFinish = false, kRuns = true, kRowsOut = false;
  struct Reg {
    Row<T> j;
    T r[2];
  };
  const T* JT;
  const T* rT;
  long long B;
  T* ptab;  // (P, 15)
  CamRuns<T> cam;

  __device__ __forceinline__ void load(long long b, Reg& g) const {
    load_row(JT, B, b, g.j);
    g.r[0] = __ldg(rT + b);
    g.r[1] = __ldg(rT + B + b);
  }
  __device__ __forceinline__ void point_values(const Reg& g, T* v) const {
    const T* e = g.j.e;
#pragma unroll
    for (int k = 0; k < kTE; ++k) {
      v[k] = e[k] * g.r[0] + e[kTE + k] * g.r[1];
      v[kTE + k] = e[k] * e[k] + e[kTE + k] * e[kTE + k];
#pragma unroll
      for (int m = 0; m < kTE; ++m)
        v[2 * kTE + k * kTE + m] = e[k] * e[m] + e[kTE + k] * e[kTE + m];
    }
  }
  __device__ __forceinline__ void point_out(long long i, T s) const { ptab[i] = s; }
  __device__ __forceinline__ void camera_values(const Reg& g, const T*, T* v) const {
    const T* f = g.j.f;
#pragma unroll
    for (int a = 0; a < kTF; ++a) {
      v[a] = f[a] * g.r[0] + f[kTF + a] * g.r[1];
      v[kTF + a] = f[a] * f[a] + f[kTF + a] * f[kTF + a];
    }
  }
  __device__ __forceinline__ int entry(int a) const { return a; }
  __device__ __forceinline__ void run_put(const T* r, int n, int a, int, T* w) const {
    T s = T(0);
    for (int k = 0; k < n; ++k) s += r[k * kStage + a];
    w[a] = s;
  }
};

template <typename T>
int post_eval_launch(const T* JT, const T* rT, int B, int C, const int* pt_start,
                     const int* pt_block, int n_pt_blocks, const int* tile_first,
                     const int* tile_run, const int* run_start, const int* run_slot,
                     const int* run_pos, int n_levels, const int* const* levels,
                     const int* sizes, const int* cam_first, T* ptab, T* w, T* work,
                     T* cam, cudaStream_t stream) {
  using Body = PostEvalFused<T>;
  if (!aligned16(w)) return (int)cudaErrorInvalidValue;
  if (n_pt_blocks > 0) {
    const Body body{JT, rT, B, ptab, {tile_first, tile_run, run_start, run_slot, run_pos, w}};
    auto pass = point_pass_kernel<T, Body>;
    CT_LAUNCH(pass, n_pt_blocks, kBlock, stream, body, pt_start, pt_block);
  }
  camera_levels<T, Body>(w, C, n_levels, levels, sizes, cam_first, work, cam, stream);
  return (int)cudaGetLastError();
}

}  // namespace ct

// ptab (P, 15) = [g_e | sqn_e | E'E]; cam (C, 18) = [g_f | sqn_f]. Rows
// sorted by point (pt_start covers B); pt_block (n_pt_blocks + 1,) the first
// point of each point block; the runs (RowPlan.run_*): tile_first
// (n_pt_blocks + 1,), tile_run (n_tiles + 1,), run_start (n_runs + 1,),
// run_slot (B,), run_pos (n_runs,); levels, sizes (host arrays of n_levels)
// and cam_first (C + 1,) the runs' camera levels. Workspace, 16-byte
// aligned: w (n_runs, s), s = 20 floats or 18 doubles; work (sum of sizes,
// 18).
#define CT_POST_EVAL_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const T* JT, const T* rT, int B, int C,                 \
                      const int* pt_start, const int* pt_block,               \
                      int n_pt_blocks, const int* tile_first,                 \
                      const int* tile_run, const int* run_start,              \
                      const int* run_slot, const int* run_pos, int n_levels,  \
                      const int* const* levels, const int* sizes,             \
                      const int* cam_first, T* ptab, T* w, T* work, T* cam,   \
                      cudaStream_t stream) {                                  \
    return ct::post_eval_launch<T>(JT, rT, B, C, pt_start, pt_block,          \
                                   n_pt_blocks, tile_first, tile_run,         \
                                   run_start, run_slot, run_pos, n_levels,    \
                                   levels, sizes, cam_first, ptab, w, work,   \
                                   cam, stream);                              \
  }

CT_POST_EVAL_ENTRY(ct_post_eval_fused_f64, double)
CT_POST_EVAL_ENTRY(ct_post_eval_fused_f32, float)
