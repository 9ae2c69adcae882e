// schur_jacobi: the camera blocks of the Schur complement, the
// SCHUR_JACOBI preconditioner of the ITERATIVE_SCHUR step, once per LM
// iteration, before scales and D_f^2:
//   out[c] = sum_{rows b of c} J_f,b' J_f,b - W_b' M[pt_b] W_b   (9 x 9)
//   W_b    = diag(se[pt_b]) J_e,b' J_f,b                        (3 x 9)
// The caller applies sf (x) sf, adds D_f^2 and inverts
// (ceres_tpu/ops/flatops.py:1014-1123).
//
// Replaces two Pallas kernels that compute this one function:
// schur_assembly in mode="schur_jacobi" (ceres_tpu/ops/pallas_kernels.py
// :1281, its correction at :1321-1326), which the JAX package takes up to
// 1024 cameras, and sj_assembly_windowed (:2682), which it takes above, only
// because a global camera one-hot would not fit the TPU's VMEM there. The
// camera sum by runs works at any camera count, so one kernel serves both.
//
// What bounds it on an H100: bytes. Per row it reads J (24 values) and its
// point's se and M (9 of 12 used: M is symmetric); ~400 flops. The output is
// C x 81 values. The first design took one block per 64-row camera chunk
// and gathered each row's J, se and M through the camera order, in which a
// camera's rows lie scattered over the point-sorted J: a 32-byte sector
// for each 4 or 8 bytes used, half the block idle while it gathered; then
// 81 lanes summed 81 entries of which 45 differ.
// Design: the point-block passes of point_blocks.cuh with this body, its
// camera values by runs. Since M is symmetric, W_b' M W_b = J_f' G_b J_f
// with the symmetric 2 x 2 G_b = J_e diag(se) M diag(se) J_e', so a row's
// block is J_f'(I - G_b) J_f: each row loads its J coalesced and its
// point's se and M through the read-only cache (a point's rows are
// neighbouring threads, so each point's values leave device memory once),
// forms H = I - G_b in float64 (formed in float32, its cancellation made the
// float32 blocks of a robust BAL-16 solve less accurate than the first
// design's, and the solve's CG far longer), and stages J_f and H, 21
// values, in shared memory; threads over
// (run, entry) then form the 45 entries of the upper triangle of each run's
// sum from the staged rows, written at the run's place in camera order
// (RowPlan.run_*). The camera levels sum the runs, and the last one
// writes each entry to both of its places in the 9 x 9 block, which so
// comes out exactly symmetric. No atomics: every sum has a fixed order.
#include "point_blocks.cuh"

namespace ct {

constexpr int kUpper = kTF * (kTF + 1) / 2;  // 45 entries of a 9 x 9 upper triangle

template <typename T>
struct SchurJacobi {
  static constexpr int kPt = 0, kCam = kUpper;
  static constexpr int kStage = 2 * kTF + 3;  // J_f and H's 3 entries
  static constexpr int kRunItems = kUpper;
  static constexpr int kMinBlocks = sizeof(T) == 8 ? 3 : 5;
  static constexpr bool kFinish = false, kRuns = true, kRowsOut = false;
  struct Reg {
    T s[kStage];
  };
  const T* JT;
  long long B;
  const int* pt_idx;
  const T* se;    // (P, 3)
  const T* minv;  // (P, 9), symmetric
  CamRuns<T> cam;

  __device__ __forceinline__ void load(long long b, Reg& g) const {
    Row<T> j;
    load_row(JT, B, b, j);
    const long long p = __ldg(pt_idx + b);
    const T* sp = se + p * kTE;
    const T* m = minv + p * kTE * kTE;
    // H = I - G in float64 whatever T: where G is close to I (a point seen
    // by few cameras) I - G cancels, and float32 would leave H, and so the
    // camera's block, indefinite by a rounding error
    const double s0 = __ldg(sp), s1 = __ldg(sp + 1), s2 = __ldg(sp + 2);
    // N = diag(se) M diag(se), its upper triangle
    const double n00 = s0 * s0 * __ldg(m), n01 = s0 * s1 * __ldg(m + 1),
                 n02 = s0 * s2 * __ldg(m + 2), n11 = s1 * s1 * __ldg(m + 4),
                 n12 = s1 * s2 * __ldg(m + 5), n22 = s2 * s2 * __ldg(m + 8);
    // t_i = N e_i for residual row i, then G_ij = e_i' t_j
    double e[2][kTE], t[2][kTE];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int k = 0; k < kTE; ++k) e[i][k] = j.e[i * kTE + k];
      t[i][0] = n00 * e[i][0] + n01 * e[i][1] + n02 * e[i][2];
      t[i][1] = n01 * e[i][0] + n11 * e[i][1] + n12 * e[i][2];
      t[i][2] = n02 * e[i][0] + n12 * e[i][1] + n22 * e[i][2];
    }
#pragma unroll
    for (int a = 0; a < 2 * kTF; ++a) g.s[a] = j.f[a];
    g.s[2 * kTF] = T(1.0 - (e[0][0] * t[0][0] + e[0][1] * t[0][1] + e[0][2] * t[0][2]));
    g.s[2 * kTF + 1] = T(-(e[0][0] * t[1][0] + e[0][1] * t[1][1] + e[0][2] * t[1][2]));
    g.s[2 * kTF + 2] = T(1.0 - (e[1][0] * t[1][0] + e[1][1] * t[1][1] + e[1][2] * t[1][2]));
  }
  __device__ __forceinline__ void point_values(const Reg&, T*) const {}
  __device__ __forceinline__ void point_out(long long, T) const {}
  __device__ __forceinline__ void camera_values(const Reg& g, const T*, T* v) const {
#pragma unroll
    for (int a = 0; a < kStage; ++a) v[a] = g.s[a];
  }
  __device__ __forceinline__ Entry entry(int e) const { return upper_entry(e); }
  // entry e = (a, c), a <= c, of sum_rows J_f'H J_f over a run's staged rows
  __device__ __forceinline__ void run_put(const T* r, int n, int i, Entry e, T* w) const {
    const int a = e.i, c = e.j;
    T s = T(0);
    for (int k = 0; k < n; ++k, r += kStage) {
      const T f0a = r[a], f0c = r[c], f1a = r[kTF + a], f1c = r[kTF + c];
      s += r[2 * kTF] * f0a * f0c + r[2 * kTF + 1] * (f0a * f1c + f1a * f0c) +
           r[2 * kTF + 2] * f1a * f1c;
    }
    w[i] = s;
  }
};

// the last camera level's store: entry e of camera c's upper triangle to
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

template <typename T>
int schur_jacobi_launch(const T* JT, int B, int C, const int* pt_idx, const T* se,
                        const T* minv, const int* pt_start, const int* pt_block,
                        int n_pt_blocks, const int* tile_first, const int* tile_run,
                        const int* run_start, const int* run_slot, const int* run_pos,
                        int n_levels, const int* const* levels, const int* sizes,
                        const int* cam_first, T* w, T* work, T* out,
                        cudaStream_t stream) {
  using Body = SchurJacobi<T>;
  if (n_pt_blocks > 0) {
    const Body body{JT, B, pt_idx, se, minv,
                    {tile_first, tile_run, run_start, run_slot, run_pos, w}};
    auto pass = point_pass_kernel<T, Body>;
    CT_LAUNCH(pass, n_pt_blocks, kBlock, stream, body, pt_start, pt_block);
  }
  level_sums<T, Body, kUpper, kUpper>(w, C, n_levels, levels, sizes, cam_first, work,
                                      MirrorStore<T>{out}, stream);
  return (int)cudaGetLastError();
}

}  // namespace ct

// se (P, 3), minv (P, 9) row-major symmetric -> out (C, 81) row-major
// blocks. Rows sorted by point (pt_start covers B); pt_block
// (n_pt_blocks + 1,) the first point of each point block; the runs
// (RowPlan.run_*): tile_first (n_pt_blocks + 1,), tile_run (n_tiles + 1,),
// run_start (n_runs + 1,), run_slot (B,), run_pos (n_runs,); levels, sizes
// (host arrays of n_levels) and cam_first (C + 1,) the runs' camera levels.
// Workspace: w (n_runs, 45), work (sum of sizes, 45).
#define CT_SJ_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(const T* JT, int B, int C, const int* pt_idx,            \
                      const T* se, const T* minv, const int* pt_start,         \
                      const int* pt_block, int n_pt_blocks,                    \
                      const int* tile_first, const int* tile_run,              \
                      const int* run_start, const int* run_slot,               \
                      const int* run_pos, int n_levels,                        \
                      const int* const* levels, const int* sizes,              \
                      const int* cam_first, T* w, T* work, T* out,             \
                      cudaStream_t stream) {                                   \
    return ct::schur_jacobi_launch<T>(JT, B, C, pt_idx, se, minv, pt_start,    \
                                      pt_block, n_pt_blocks, tile_first,       \
                                      tile_run, run_start, run_slot, run_pos,  \
                                      n_levels, levels, sizes, cam_first, w,   \
                                      work, out, stream);                      \
  }

CT_SJ_ENTRY(ct_schur_jacobi_f64, double)
CT_SJ_ENTRY(ct_schur_jacobi_f32, float)
