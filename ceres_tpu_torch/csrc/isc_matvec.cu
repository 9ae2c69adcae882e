// isc_matvec: the implicit Schur product of the ITERATIVE_SCHUR CG, once
// per CG iteration, without its D_f^2 term:
//   fz_b = J_f,b z[cam_b]                      (2 values per row; 0 for a
//                                               constant camera, cam_b >= C)
//   u_p  = minv_p sum_{rows b of p} J_e,b' fz_b (3 values per point)
//   q_b  = fz_b - J_e,b u_{pt_b}
//   cam[c] = sum_{rows of c} J_f,b' q_b         (C, 9)
// and, when asked, u (P, 3) for the back-substitution of the step.
//
// Replaces the Pallas kernel implicit_schur_matvec in mode="isc", as
// isc_matvec calls it (ceres_tpu/ops/pallas_kernels.py:781 and :1716,
// pallas_call at :1258 / :1270), and its per-tile M^{-1} table
// (build_minv_tile_table, :1657), which only served the TPU's layout.
//
// What bounds it on an H100: bytes. Per row it needs J (24 values), the
// gathered z (9, from L2: the camera table is small) and ~130 flops; per
// point minv (9) and u (3); per camera 9 outputs. That is far below the
// card's flop-per-byte balance, so what counts is that each value of J is
// read once, by a coalesced load. The first design walked each point's rows
// with one thread per point: neighbouring threads read J about a track
// apart, a 32-byte sector for every 4 or 8 bytes used, twice over, then
// gathered J_f once more by camera.
// Design: the point-block passes of point_blocks.cuh with this body. Each
// row forms fz from J in registers and z's padded row (from L2: the camera
// table is small), and J_e'fz; one thread per point sums its rows' J_e'fz
// in row order and applies minv (u, written out when asked); each row then
// forms q = fz - J_e u and w = J_f'q from its registers and writes the 9
// values of w at its place in camera order (RowPlan.cam_pos), which the
// camera pass sums by RowPlan.cam_levels. q never reaches device memory.
// Traffic per row: J (24 values) read, w (9) written and read back. The
// point pass keeps 48 [80] registers a thread in float32 [float64], 5 [3]
// blocks per SM: more registers cost a block and 7% of its time.
#include "point_blocks.cuh"

namespace ct {

template <typename T>
struct IscMatvec {
  static constexpr int kPt = kTE, kCam = kTF;
  static constexpr int kMinBlocks = sizeof(T) == 8 ? 3 : 5;
  static constexpr bool kFinish = true, kRuns = false;
  struct Reg {
    Row<T> j;
    T fz[2];
  };
  const T* JT;
  long long B;
  int C;
  const int* cam_idx;
  const T* zp;    // (C, kPad) z, padded
  const T* minv;  // (P, 9)
  int emit_u;
  T* u;  // (P, 3) when emit_u
  CamRows<T> cam;

  __device__ __forceinline__ void load(long long b, Reg& g) const {
    load_row(JT, B, b, g.j);
    T zv[kPad<T, kTF>] = {};
    const int c = __ldg(cam_idx + b);
    if (c < C) load_padded<T, kTF>(zp + (long long)c * kPad<T, kTF>, zv);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      T acc = T(0);
#pragma unroll
      for (int a = 0; a < kTF; ++a) acc += g.j.f[i * kTF + a] * zv[a];
      g.fz[i] = acc;
    }
  }
  // J_e'fz
  __device__ __forceinline__ void point_values(const Reg& g, T* v) const {
#pragma unroll
    for (int k = 0; k < kTE; ++k) v[k] = g.j.e[k] * g.fz[0] + g.j.e[kTE + k] * g.fz[1];
  }
  // u = minv_p sum J_e'fz
  __device__ __forceinline__ void finish(int p, const T* s, T* up) const {
    const T* m = minv + (long long)p * kTE * kTE;
#pragma unroll
    for (int i = 0; i < kTE; ++i)
      up[i] = __ldg(m + i * kTE) * s[0] + __ldg(m + i * kTE + 1) * s[1] +
              __ldg(m + i * kTE + 2) * s[2];
    if (emit_u)
      for (int i = 0; i < kTE; ++i) u[(long long)p * kTE + i] = up[i];
  }
  // w = J_f'(fz - J_e u)
  __device__ __forceinline__ void camera_values(const Reg& g, const T* up, T* v) const {
    T q[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      q[i] = g.fz[i] - (g.j.e[i * kTE] * up[0] + g.j.e[i * kTE + 1] * up[1] +
                        g.j.e[i * kTE + 2] * up[2]);
#pragma unroll
    for (int a = 0; a < kTF; ++a) v[a] = g.j.f[a] * q[0] + g.j.f[kTF + a] * q[1];
  }
};

template <typename T>
int isc_launch(const T* JT, int B, int C, const int* cam_idx, const int* cam_pos,
               const int* pt_start, const int* pt_block, int n_pt_blocks, const T* z,
               const T* minv, int emit_u, int n_levels, const int* const* levels,
               const int* sizes, const int* cam_first, T* u, T* w, T* zp, T* work,
               T* cam_out, cudaStream_t stream) {
  using Body = IscMatvec<T>;
  if (!aligned16(w) || !aligned16(zp)) return (int)cudaErrorInvalidValue;
  if (C > 0) {
    auto pad = pad_kernel<T, Body>;
    CT_LAUNCH(pad, ceil_div((long long)C * kPad<T, kTF>, 256), 256, stream, z, C, zp);
  }
  if (n_pt_blocks > 0) {
    const Body body{JT, B, C, cam_idx, zp, minv, emit_u, u, {cam_pos, w}};
    auto pass = point_pass_kernel<T, Body>;
    CT_LAUNCH(pass, n_pt_blocks, kBlock, stream, body, pt_start, pt_block);
  }
  camera_levels<T, Body>(w, C, n_levels, levels, sizes, cam_first, work, cam_out, stream);
  return (int)cudaGetLastError();
}

}  // namespace ct

// z (C, 9), minv (P, 9) row-major -> cam_out (C, 9) and, when emit_u,
// u (P, 3). Rows sorted by point (pt_start covers B); pt_block
// (n_pt_blocks + 1,) the first point of each point block; cam_idx (B,) each
// row's camera, C or more for a constant camera; cam_pos (B,) each row's
// place in camera order, -1 for a constant camera's; levels, sizes (host arrays of n_levels) and
// cam_first (C + 1,) the camera plan's levels. Workspace, 16-byte aligned:
// w (B, s) and zp (C, s), s = 12 floats or 10 doubles; work (sum of sizes, 9).
#define CT_ISC_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const T* JT, int B, int C, const int* cam_idx,          \
                      const int* cam_pos, const int* pt_start,                \
                      const int* pt_block, int n_pt_blocks, const T* z,       \
                      const T* minv, int emit_u, int n_levels,                \
                      const int* const* levels, const int* sizes,             \
                      const int* cam_first, T* u, T* w, T* zp, T* work,       \
                      T* cam_out, cudaStream_t stream) {                      \
    return ct::isc_launch<T>(JT, B, C, cam_idx, cam_pos, pt_start, pt_block,  \
                             n_pt_blocks, z, minv, emit_u, n_levels, levels,  \
                             sizes, cam_first, u, w, zp, work, cam_out,       \
                             stream);                                         \
  }

CT_ISC_ENTRY(ct_isc_matvec_f64, double)
CT_ISC_ENTRY(ct_isc_matvec_f32, float)
