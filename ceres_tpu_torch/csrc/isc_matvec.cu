// isc_matvec: the implicit Schur product of the ITERATIVE_SCHUR CG, once
// per CG iteration, without its D_f^2 term:
//   fz_b = J_f,b z[cam_b]                      (2 values per row)
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
// Design, two passes, no atomics, every sum in a fixed order:
// 1. Point pass, one thread per row. A block owns the rows of whole points
//    (RowPlan.pt_block, at most kThreads rows and points), so its threads
//    load J lane by lane, neighbouring rows at neighbouring addresses, and
//    keep the 24 values in registers. Each row forms fz and its J_e'fz in
//    shared memory; one thread per point sums its rows' J_e'fz in row order
//    and applies minv (u, written out when asked); each row then forms
//    q = fz - J_e u and w = J_f'q from its registers and writes the 9 values
//    of w at its place in camera order (RowPlan.cam_pos). q never reaches
//    device memory. A point with more rows than a block holds owns a block
//    that loops over them and reads its J twice.
// 2. Camera pass: w in camera order is a sorted segment sum over a (B, 9)
//    array, through the camera chunk plan and its fixed tree of levels
//    (RowPlan.cam_levels, as csrc/segment_sum.cu's plans): a block stages
//    the rows of kTileChunks consecutive chunks with coalesced loads, sums
//    each (chunk, column) in kSub interleaved parts and the parts in order.
//    The finalize is one more such level, one chunk per camera over its
//    partials of the last level (at most CT_CHUNK by the plan).
// Traffic per row: J (24 values) read, w (9) written and read back.
#include "common.cuh"

namespace {

using ct::kEOff;
using ct::kTE;
using ct::kTF;
using ct::Vec16;

constexpr int kThreads = 256;  // rows (and points) of a point block
constexpr int kTileChunks = 4;  // camera chunks per block of the camera pass
constexpr int kSub = 7;         // parts of a (chunk, column) sum
static_assert(kTileChunks * kTF * kSub <= kThreads, "a thread per part");

// The row stride of z and w: 9 values padded to whole 16-byte groups (12
// floats, 10 doubles), so that a row moves in 3 or 5 vector accesses.
template <typename T>
constexpr int kStride = (kTF + Vec16<T>::kN - 1) / Vec16<T>::kN * Vec16<T>::kN;

template <typename T>
struct Row {
  T f[2 * kTF];  // J_f, residual row i at i * 9
  T e[2 * kTE];  // J_e, residual row i at i * 3
};

template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ JT, long long B,
                                         long long b, Row<T>& j) {
#pragma unroll
  for (int i = 0; i < 2 * kTF; ++i) j.f[i] = __ldg(JT + i * B + b);
#pragma unroll
  for (int i = 0; i < 2 * kTE; ++i) j.e[i] = __ldg(JT + (kEOff + i) * B + b);
}

// fz = J_f z[cam_b] from the padded row zc; returns it in fz, and J_e'fz in e
template <typename T>
__device__ __forceinline__ void row_fz(const Row<T>& j, const T* __restrict__ zc,
                                       T (&fz)[2], T (&e)[kTE]) {
  constexpr int V = Vec16<T>::kN;
  T zv[kStride<T>];
#pragma unroll
  for (int a = 0; a < kStride<T>; a += V) Vec16<T>::load(zc + a, zv + a);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    T acc = T(0);
#pragma unroll
    for (int a = 0; a < kTF; ++a) acc += j.f[i * kTF + a] * zv[a];
    fz[i] = acc;
  }
#pragma unroll
  for (int k = 0; k < kTE; ++k) e[k] = j.e[k] * fz[0] + j.e[kTE + k] * fz[1];
}

// w = J_f'(fz - J_e u), written as the row's padded place in camera order
template <typename T>
__device__ __forceinline__ void row_w(const Row<T>& j, const T (&fz)[2],
                                      const T* up, T* __restrict__ wb) {
  constexpr int V = Vec16<T>::kN;
  T q[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    q[i] = fz[i] - (j.e[i * kTE] * up[0] + j.e[i * kTE + 1] * up[1] +
                    j.e[i * kTE + 2] * up[2]);
  T wv[kStride<T>];
#pragma unroll
  for (int a = 0; a < kStride<T>; ++a)
    wv[a] = a < kTF ? j.f[a] * q[0] + j.f[kTF + a] * q[1] : T(0);
#pragma unroll
  for (int a = 0; a < kStride<T>; a += V) Vec16<T>::store(wb + a, wv + a);
}

template <typename T>
__device__ __forceinline__ void point_u(const T* __restrict__ m, const T (&e)[kTE],
                                        T (&up)[kTE]) {
#pragma unroll
  for (int i = 0; i < kTE; ++i)
    up[i] = m[i * kTE] * e[0] + m[i * kTE + 1] * e[1] + m[i * kTE + 2] * e[2];
}

// z (C, 9) -> zp (C, kStride)
template <typename T>
__global__ void isc_pad_kernel(const T* __restrict__ z, int C, T* __restrict__ zp) {
  int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= C * kStride<T>) return;
  int c = idx / kStride<T>, l = idx - c * kStride<T>;
  zp[idx] = l < kTF ? z[c * kTF + l] : T(0);
}

// one point of n > kThreads rows from row r0: thread t sums rows t,
// t + kThreads, ... in order, the block its threads in a fixed tree; then
// every row again, with u
template <typename T>
__device__ void long_point(const T* __restrict__ JT, long long B, int p, int r0,
                           int n, const int* __restrict__ cam_idx,
                           const int* __restrict__ cam_pos, const T* __restrict__ zp,
                           const T* __restrict__ minv, int emit_u, T* __restrict__ u,
                           T* __restrict__ w, T (*sh)[kTE]) {
  const int tid = threadIdx.x;
  T acc[kTE] = {};
  for (int i = tid; i < n; i += kThreads) {
    long long b = r0 + i;
    Row<T> j;
    load_row(JT, B, b, j);
    T fz[2], e[kTE];
    row_fz(j, zp + (long long)__ldg(cam_idx + b) * kStride<T>, fz, e);
    for (int k = 0; k < kTE; ++k) acc[k] += e[k];
  }
  for (int k = 0; k < kTE; ++k) sh[tid][k] = acc[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s)
      for (int k = 0; k < kTE; ++k) sh[tid][k] += sh[tid + s][k];
    __syncthreads();
  }
  T up[kTE];
  T e[kTE] = {sh[0][0], sh[0][1], sh[0][2]};
  point_u(minv + (long long)p * kTE * kTE, e, up);
  if (emit_u && tid == 0)
    for (int k = 0; k < kTE; ++k) u[(long long)p * kTE + k] = up[k];
  for (int i = tid; i < n; i += kThreads) {
    long long b = r0 + i;
    Row<T> j;
    load_row(JT, B, b, j);
    T fz[2], e2[kTE];
    row_fz(j, zp + (long long)__ldg(cam_idx + b) * kStride<T>, fz, e2);
    row_w(j, fz, up, w + (long long)__ldg(cam_pos + b) * kStride<T>);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
isc_point_kernel(const T* __restrict__ JT, int B, const int* __restrict__ cam_idx,
                 const int* __restrict__ cam_pos, const int* __restrict__ pt_start,
                 const int* __restrict__ pt_block, const T* __restrict__ zp,
                 const T* __restrict__ minv, int emit_u, T* __restrict__ u,
                 T* __restrict__ w) {
  __shared__ T sh[kThreads][kTE];  // a row's J_e'fz, then its point's u
  const int tid = threadIdx.x;
  const int p0 = pt_block[blockIdx.x], p1 = pt_block[blockIdx.x + 1];
  const int r0 = pt_start[p0], n = pt_start[p1] - r0;
  if (n > kThreads) {  // the block's one point (block-uniform)
    long_point(JT, B, p0, r0, n, cam_idx, cam_pos, zp, minv, emit_u, u, w, sh);
    return;
  }
  // this thread's point, if any: its rows in the block and its minv
  const int p = p0 + tid;
  const bool has_pt = p < p1;
  int a = 0, e_end = 0;
  T m[kTE * kTE];
  if (has_pt) {
    a = pt_start[p] - r0;
    e_end = pt_start[p + 1] - r0;
#pragma unroll
    for (int i = 0; i < kTE * kTE; ++i) m[i] = __ldg(minv + (long long)p * kTE * kTE + i);
  }
  const bool active = tid < n;
  const long long b = (long long)r0 + tid;
  Row<T> j;
  T fz[2];
  if (active) {
    load_row(JT, B, b, j);
    T e[kTE];
    row_fz(j, zp + (long long)__ldg(cam_idx + b) * kStride<T>, fz, e);
    for (int k = 0; k < kTE; ++k) sh[tid][k] = e[k];
  }
  __syncthreads();
  if (has_pt) {
    T e[kTE] = {};
    for (int r = a; r < e_end; ++r)
      for (int k = 0; k < kTE; ++k) e[k] += sh[r][k];
    T up[kTE];
    point_u(m, e, up);
    if (emit_u)
      for (int k = 0; k < kTE; ++k) u[(long long)p * kTE + k] = up[k];
    for (int r = a; r < e_end; ++r)
      for (int k = 0; k < kTE; ++k) sh[r][k] = up[k];
  }
  __syncthreads();
  if (active) row_w(j, fz, sh[tid], w + (long long)__ldg(cam_pos + b) * kStride<T>);
}

// One level of the camera sum: block k sums chunks [k kTileChunks, ...)
// of `in` (rows of 9 values at stride IS in camera order; chunk c covers
// rows cs[c] .. cs[c+1], at most CT_CHUNK, never across a camera) into out
// (n_chunks, 9). Level 0 reads the padded w with 16-byte loads. The
// finalize is one more level, whose chunks are the cameras.
template <typename T, int IS>
__global__ void __launch_bounds__(kThreads)
isc_camera_kernel(const T* __restrict__ in, const int* __restrict__ cs, int n_chunks,
                  T* __restrict__ out) {
  constexpr int V = Vec16<T>::kN;
  __shared__ T rows[kTileChunks * CT_CHUNK * kTF];
  __shared__ T part[kTileChunks * kSub * kTF];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kTileChunks;
  const int nc = n_chunks - c0 < kTileChunks ? n_chunks - c0 : kTileChunks;
  const int s = cs[c0];
  const int nv = (cs[c0 + nc] - s) * IS;
  const T* src = in + (long long)s * IS;
  if (IS % V == 0) {
    for (int k = tid * V; k < nv; k += kThreads * V) {
      T x[V];
      Vec16<T>::load(src + k, x);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        const int r = (k + q) / IS, l = k + q - r * IS;
        if (l < kTF) rows[r * kTF + l] = x[q];
      }
    }
  } else {
    for (int i = tid; i < nv; i += kThreads) rows[i] = __ldg(src + i);
  }
  __syncthreads();
  // part (chunk c, column l, part g): rows g, g + kSub, ... of the chunk
  const int c = tid / (kSub * kTF), l = tid % kTF, g = (tid / kTF) % kSub;
  if (c < nc) {
    const int r1 = cs[c0 + c + 1] - s;
    T acc = T(0);
    for (int r = cs[c0 + c] - s + g; r < r1; r += kSub) acc += rows[r * kTF + l];
    part[tid] = acc;
  }
  __syncthreads();
  if (tid < nc * kTF) {
    const int cc = tid / kTF, ll = tid % kTF;
    T acc = T(0);
    for (int gg = 0; gg < kSub; ++gg) acc += part[(cc * kSub + gg) * kTF + ll];
    out[(long long)(c0 + cc) * kTF + ll] = acc;
  }
}

// levels[lv] (sizes[lv] + 1,) device chunk offsets of level lv; level 0
// chunks w, level lv > 0 the partials of level lv - 1; cam_first (C + 1,)
// each camera's chunks of the last level. work holds every level's
// partials in turn.
template <typename T>
int launch(const T* JT, int B, int C, const int* cam_idx, const int* cam_pos,
           const int* pt_start, const int* pt_block, int n_pt_blocks, const T* z,
           const T* minv, int emit_u, int n_levels, const int* const* levels,
           const int* sizes, const int* cam_first, T* u, T* w, T* zp, T* work,
           T* cam_out, cudaStream_t stream) {
  if ((reinterpret_cast<unsigned long long>(w) & 15) != 0 ||
      (reinterpret_cast<unsigned long long>(zp) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (C > 0) {
    CT_LAUNCH(isc_pad_kernel<T>, ct::ceil_div((long long)C * kStride<T>, 256), 256,
              stream, z, C, zp);
  }
  if (n_pt_blocks > 0) {
    CT_LAUNCH(isc_point_kernel<T>, n_pt_blocks, kThreads, stream, JT, B, cam_idx,
              cam_pos, pt_start, pt_block, zp, minv, emit_u, u, w);
  }
  const T* in = w;
  T* dst = work;
  for (int lv = 0; lv <= n_levels; ++lv) {
    const bool last = lv == n_levels;
    const int* cs = last ? cam_first : levels[lv];
    const int n = last ? C : sizes[lv];
    T* out = last ? cam_out : dst;
    if (n > 0) {
      auto kernel = lv == 0 ? isc_camera_kernel<T, kStride<T>> : isc_camera_kernel<T, kTF>;
      CT_LAUNCH(kernel, ct::ceil_div(n, kTileChunks), kThreads, stream, in, cs, n, out);
    }
    in = dst;
    dst += (long long)n * kTF;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// z (C, 9), minv (P, 9) row-major -> cam_out (C, 9) and, when emit_u,
// u (P, 3). Rows sorted by point (pt_start covers B); pt_block
// (n_pt_blocks + 1,) the first point of each point block; cam_pos (B,) each
// row's place in camera order; levels, sizes (host arrays of n_levels) and
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
    return launch<T>(JT, B, C, cam_idx, cam_pos, pt_start, pt_block,          \
                     n_pt_blocks, z, minv, emit_u, n_levels, levels, sizes,   \
                     cam_first, u, w, zp, work, cam_out, stream);             \
  }

CT_ISC_ENTRY(ct_isc_matvec_f64, double)
CT_ISC_ENTRY(ct_isc_matvec_f32, float)
