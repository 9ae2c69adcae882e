// normal_matvec: (J'J) x for the e/f split, one pass over J.
//   jv_b = J_f,b x_c[cam_b] + J_e,b x_p[pt_b]       (2 values per row)
//   (x_c[cam_b] = 0 for a row of a constant camera, cam_b >= C, whose
//   row adds to pt only)
//   cam[c] = sum_{rows of c} J_f' jv   (C, 9)
//   pt[p]  = sum_{rows of p} J_e' jv   (P, 3)
//
// Replaces the Pallas kernel implicit_schur_matvec in mode="normal", as
// normal_matvec calls it (ceres_tpu/ops/pallas_kernels.py:781 and :1759,
// pallas_call at :1258 / :1270). The dense-Schur step uses the point
// output for its back-substitution (ceres_tpu/solvers/fused_lm.py:963-966),
// the iterative step for its right-hand side.
//
// What bounds it on an H100: bytes. Per row it reads J (24 values) and
// gathers x_c (9, from L2: the camera table is small) and x_p (3) for ~100
// flops. The first design walked each point's rows with one thread per
// point (neighbouring threads a track apart in J: a 32-byte sector for 4
// or 8 useful bytes), then read all of J again, scattered, by camera chunk.
// Design: the point-block passes of point_blocks.cuh with this body, as
// isc_matvec without its M^{-1} step. Each row forms jv from J in registers,
// the padded row of x_c and its point's x_p; J_e'jv goes to shared memory,
// where one thread per (point, value) sums it in row order into pt; J_f'jv
// (9 values) goes at the row's place in camera order (RowPlan.cam_pos),
// which the camera pass sums by RowPlan.cam_levels. jv never reaches device
// memory. Traffic per row: J (24 values) read, J_f'jv (9, padded) written
// and read back. The point pass keeps at most 85 registers a thread (56
// [80] in float32 [float64]), 3 blocks per SM.
#include "point_blocks.cuh"

namespace ct {

template <typename T>
struct NormalMatvec {
  static constexpr int kPt = kTE, kCam = kTF;
  static constexpr int kMinBlocks = 3;
  static constexpr bool kFinish = false, kRuns = false;
  struct Reg {
    Row<T> j;
    T jv[2];
  };
  const T* JT;
  long long B;
  int C;
  const int* cam_idx;
  const int* pt_idx;
  const T* xcp;  // (C, kPad) x_c, padded
  const T* xp;   // (P, 3)
  T* pt_out;     // (P, 3)
  CamRows<T> cam;

  __device__ __forceinline__ void load(long long b, Reg& g) const {
    load_row(JT, B, b, g.j);
    T xv[kPad<T, kTF>] = {};
    const int c = __ldg(cam_idx + b);
    if (c < C) load_padded<T, kTF>(xcp + (long long)c * kPad<T, kTF>, xv);
    const T* x = xp + (long long)__ldg(pt_idx + b) * kTE;
    T xe[kTE] = {__ldg(x), __ldg(x + 1), __ldg(x + 2)};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      T acc = T(0);
#pragma unroll
      for (int a = 0; a < kTF; ++a) acc += g.j.f[i * kTF + a] * xv[a];
#pragma unroll
      for (int k = 0; k < kTE; ++k) acc += g.j.e[i * kTE + k] * xe[k];
      g.jv[i] = acc;
    }
  }
  // J_e'jv
  __device__ __forceinline__ void point_values(const Reg& g, T* v) const {
#pragma unroll
    for (int k = 0; k < kTE; ++k) v[k] = g.j.e[k] * g.jv[0] + g.j.e[kTE + k] * g.jv[1];
  }
  __device__ __forceinline__ void point_out(long long i, T s) const { pt_out[i] = s; }
  // J_f'jv
  __device__ __forceinline__ void camera_values(const Reg& g, const T*, T* v) const {
#pragma unroll
    for (int a = 0; a < kTF; ++a) v[a] = g.j.f[a] * g.jv[0] + g.j.f[kTF + a] * g.jv[1];
  }
};

template <typename T>
int normal_launch(const T* JT, int B, int C, const int* cam_idx, const int* pt_idx,
                  const int* cam_pos, const int* pt_start, const int* pt_block,
                  int n_pt_blocks, const T* xc, const T* xp, int n_levels,
                  const int* const* levels, const int* sizes, const int* cam_first,
                  T* pt_out, T* w, T* xcp, T* work, T* cam_out, cudaStream_t stream) {
  using Body = NormalMatvec<T>;
  if (!aligned16(w) || !aligned16(xcp)) return (int)cudaErrorInvalidValue;
  if (C > 0) {
    auto pad = pad_kernel<T, Body>;
    CT_LAUNCH(pad, ceil_div((long long)C * kPad<T, kTF>, 256), 256, stream, xc, C, xcp);
  }
  if (n_pt_blocks > 0) {
    const Body body{JT, B, C, cam_idx, pt_idx, xcp, xp, pt_out, {cam_pos, w}};
    auto pass = point_pass_kernel<T, Body>;
    CT_LAUNCH(pass, n_pt_blocks, kBlock, stream, body, pt_start, pt_block);
  }
  camera_levels<T, Body>(w, C, n_levels, levels, sizes, cam_first, work, cam_out, stream);
  return (int)cudaGetLastError();
}

}  // namespace ct

// xc (C, 9), xp (P, 3) -> cam_out (C, 9), pt_out (P, 3). Rows sorted by
// point (pt_start covers B); pt_block (n_pt_blocks + 1,) the first point of
// each point block; cam_idx (B,) each row's camera, C or more for a
// constant camera; cam_pos (B,) each row's place in camera order, -1 for a
// constant camera's; levels,
// sizes (host arrays of n_levels) and cam_first (C + 1,) the camera plan's
// levels. Workspace, 16-byte aligned: w (B, s) and xcp (C, s), s = 12
// floats or 10 doubles; work (sum of sizes, 9).
#define CT_NORMAL_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const T* JT, int B, int C, const int* cam_idx,          \
                      const int* pt_idx, const int* cam_pos,                  \
                      const int* pt_start, const int* pt_block,               \
                      int n_pt_blocks, const T* xc, const T* xp,              \
                      int n_levels, const int* const* levels,                 \
                      const int* sizes, const int* cam_first, T* pt_out,      \
                      T* w, T* xcp, T* work, T* cam_out,                      \
                      cudaStream_t stream) {                                  \
    return ct::normal_launch<T>(JT, B, C, cam_idx, pt_idx, cam_pos, pt_start, \
                                pt_block, n_pt_blocks, xc, xp, n_levels,      \
                                levels, sizes, cam_first, pt_out, w, xcp,     \
                                work, cam_out, stream);                       \
  }

CT_NORMAL_ENTRY(ct_normal_matvec_f64, double)
CT_NORMAL_ENTRY(ct_normal_matvec_f32, float)
