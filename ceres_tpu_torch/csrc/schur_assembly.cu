// schur_assembly (dense): the reduced camera system of the dense-Schur
// LM step, with the e-blocks (points) eliminated.
//
// Per observation b of point p and camera c, with scaled lanes
//   Jsf = J_f * sc[c] (2x9), Jsp = J_e * sp[p] (2x3),
//   W_b = Jsp' Jsf (3x9),  Y_b = K_p W_b (3x9),  K_p = L_p^{-1} (3x3),
// the kernel returns
//   AtA  (t_full x t_full), block (c_a, c_b) = sum_p sum_{a, b of p}
//        Y_a' Y_b over pairs of the point's observations in cameras c_a, c_b
//        (A = the point-reduce of the camera-spread Y never exists),
//   FtF  (C, 9x9)  = sum_{rows of c} Jsf' Jsf,
//   U    (t_full)  = A' u, i.e. U[c] = sum_{rows of c} Y_b' u[p_b],
// with t_full = 9 C. The caller forms S = blockdiag(FtF) + D_f^2 - AtA and
// rhs = b_f - U (ceres_tpu/solvers/fused_lm.py:938-946). A row of a
// constant camera (c >= C) has Jsf = 0: the pair plan holds no pair of
// it, its runs (run_pos -1) form nothing, and it reads no camera scale.
//
// Replaces the Pallas kernel schur_assembly in mode="dense"
// (ceres_tpu/ops/pallas_kernels.py:1281, pallas_call at :1546).
//
// What bounds it on an H100: bytes. At BAL-16 the function reads J, the
// scales, K, u and the row maps and writes AtA, FtF and U: ~20 MB in
// float64, ~6 us at 3.35 TB/s. Its arithmetic, each symmetric product
// counted once, is ~140 Mflop, ~2 us at the card's 67 TFLOP/s. The first
// design kept Y lane-major, gathered 54 lane-major values per pair of rows
// through a plan of every ordered pair (both (a, b) and (b, a), and a == b:
// half its work a transpose of the other half), summed each entry with 81
// of 128 threads in a serial loop, gathered the camera sums' 48 values per
// row through the camera order, and walked chunk partials serially: 46x
// its bound, the pair blocks most of it.
// Y has rank 2: Y_b = Z_b Jsf_b with Z_b = K_p Jsp_b' (3 x 2), so
// Y_a'Y_b = Jsf_a' (Z_a'Z_b) Jsf_b, with a 2 x 2 in the middle. Design,
// three parts, no atomics (every sum has a fixed order):
// 1. The point pass of point_blocks.cuh with this body: each row loads its
//    J coalesced and its camera's scales and its point's sp, K and u
//    through the read-only cache; the tile's rows of Y's factors, Jsf and
//    Z (24 values), go out through shared memory in coalesced 16-byte
//    stores (a thread's own row would cost a write transaction per 16
//    bytes); each row stages Jsf, v = Jsp K'u (so that Y'u = Jsf'v) and
//    Z'Z, 23 values, and threads over (run, item) form each run's 45
//    entries of Jsf'Jsf and of Jsf'(Z'Z)Jsf = Y'Y together, and 9 of Jsf'v.
//    A row's product with itself so goes by camera, not by pair.
// 2. Pair chunks: the pair plan (RowPlan.pairs) holds each pair of two
//    rows of one point once, a from the lower camera, ordered by
//    camera-pair key (c_a <= c_b), then by point, and cut into chunks of at
//    most CT_CHUNK pairs of one key. A 128-thread block stages its chunk's
//    rows of Y's factors (Y fits L2 at BAL-16: 1.9 MB a thousand rows in
//    float64) with every load in flight at once, then each pair's 2 x 2
//    G = Z_a'Z_b, and thread (part, tile) sums a 3 x 3 tile of the block,
//    Jsf_a' G Jsf_b, over a part of the pairs in registers: what bounds
//    this step in float64 is shared memory's bandwidth, so each thread
//    reads 16 values a pair for 27 entries' products. A key within one
//    camera (pairs of two rows of a point in one camera: none in BAL) adds
//    Y_a'Y_b + Y_b'Y_a, on and above the diagonal.
// 3. The pair levels (RowPlan.pairs.pair_levels) sum the chunk partials of
//    each key in a fixed tree, and the last one writes the block (c_a, c_b)
//    and its transpose at (c_b, c_a), the upper triangle of a diagonal
//    block to both places; then the run levels sum the runs, and the last
//    one writes FtF mirrored, U, and adds each camera's sum of Y_b'Y_b to
//    both places of its diagonal block's entries. AtA comes out exactly
//    symmetric, and every key of c_a <= c_b is written, those without
//    pairs as zeros. Nothing depends on the output fitting shared memory,
//    so the kernel stays right for any camera count (the JAX package takes
//    this path up to t_full = 1024); the pair plan grows as
//    sum_p m_p (m_p - 1) / 2.
#include "point_blocks.cuh"

namespace ct {

// a row's factors of Y = Z Jsf: Jsf (2 x 9) at 0, Z = K Jsp' (3 x 2), its
// column r at 18 + 3 r; 24 values, whole 16-byte groups
constexpr int kZ = 2 * kTF;
constexpr int kYS = kZ + 2 * kTE;
constexpr int kFtFUpper = kTF * (kTF + 1) / 2;     // 45
constexpr int kBlk = kTF * kTF;                    // 81 values of a 9 x 9 block
constexpr int kPairThreads = 128;                  // threads of a pair block
constexpr int kTiles = 9;                          // 3 x 3 tiles of a 9 x 9 block
constexpr int kPairParts = kPairThreads / kTiles;  // 14 interleaved parts of a pair sum

template <typename T>
struct SchurAssembly {
  // a run's camera values: FtF's upper triangle, 45 | the upper triangle of
  // the sum of Y_b'Y_b, 45 | U's 9; formed in 54 items, one for FtF's and
  // Y'Y's entry (i, j) together, one for each of U's
  static constexpr int kPt = 0, kCam = 2 * kFtFUpper + kTF, kRunItems = kFtFUpper + kTF;
  static constexpr int kStage = 2 * kTF + 2 + 3;  // Jsf | v | Z'Z's 3
  static constexpr int kMinBlocks = 3;
  static constexpr bool kFinish = false, kRuns = true, kRowsOut = true;
  static_assert(kYS % Vec16<T>::kN == 0, "Y's rows in 16-byte groups");
  struct Reg {
    T s[kStage];
    T z[2 * kTE];  // Z = K Jsp', column r at 3 r
  };
  const T* JT;
  long long B;
  int C;
  const int* cam_idx;
  const int* pt_idx;
  const T* sc;  // (C, 9)
  const T* sp;  // (P, 3)
  const T* K;   // (P, 9)
  const T* u;   // (P, 3)
  T* Y;         // (B, 24) the rows' factors of Y
  CamRuns<T> cam;

  __device__ __forceinline__ void load(long long b, Reg& g) const {
    Row<T> j;
    load_row(JT, B, b, j);
    const long long c = __ldg(cam_idx + b), p = __ldg(pt_idx + b);
    T scv[kTF] = {};
    if (c < C)
#pragma unroll
      for (int a = 0; a < kTF; ++a) scv[a] = __ldg(sc + c * kTF + a);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int a = 0; a < kTF; ++a) g.s[i * kTF + a] = j.f[i * kTF + a] * scv[a];
    T jsp[2][kTE], k[kTE * kTE], up[kTE];
#pragma unroll
    for (int q = 0; q < kTE; ++q) {
      const T s = __ldg(sp + p * kTE + q);
      jsp[0][q] = j.e[q] * s;
      jsp[1][q] = j.e[kTE + q] * s;
      up[q] = __ldg(u + p * kTE + q);
    }
#pragma unroll
    for (int q = 0; q < kTE * kTE; ++q) k[q] = __ldg(K + p * kTE * kTE + q);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int m = 0; m < kTE; ++m)
        g.z[r * kTE + m] = k[m * kTE] * jsp[r][0] + k[m * kTE + 1] * jsp[r][1] +
                           k[m * kTE + 2] * jsp[r][2];
    // v = Jsp K'u, so that Y'u = W'K'u = Jsf' v
    T ktu[kTE];
#pragma unroll
    for (int q = 0; q < kTE; ++q)
      ktu[q] = k[q] * up[0] + k[kTE + q] * up[1] + k[2 * kTE + q] * up[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      g.s[2 * kTF + i] = jsp[i][0] * ktu[0] + jsp[i][1] * ktu[1] + jsp[i][2] * ktu[2];
    // Z'Z, so that Y'Y = Jsf' (Z'Z) Jsf
    const T* z = g.z;
    g.s[2 * kTF + 2] = z[0] * z[0] + z[1] * z[1] + z[2] * z[2];
    g.s[2 * kTF + 3] = z[0] * z[3] + z[1] * z[4] + z[2] * z[5];
    g.s[2 * kTF + 4] = z[3] * z[3] + z[4] * z[4] + z[5] * z[5];
  }
  // values Q0 .. Q0 + NQ of the tile's rows of Y's factors, staged in sh
  // (stride NQ + 1) and written coalesced, whole 16-byte groups of a row each
  template <int Q0, int NQ>
  __device__ __forceinline__ void rows_part(const Reg& g, long long r0, int m, T* sh) const {
    constexpr int V = Vec16<T>::kN, NV = NQ / V;
    static_assert(NQ % V == 0, "whole 16-byte groups");
    const int tid = threadIdx.x;
    if (tid < m)
#pragma unroll
      for (int q = Q0; q < Q0 + NQ; ++q)
        sh[tid * (NQ + 1) + q - Q0] = q < kZ ? g.s[q] : g.z[q - kZ];
    __syncthreads();
    for (int i = tid; i < m * NV; i += kBlock) {
      const int r = i / NV, v = i % NV;
      T x[V];
#pragma unroll
      for (int k = 0; k < V; ++k) x[k] = sh[r * (NQ + 1) + v * V + k];
      Vec16<T>::store(Y + (r0 + r) * kYS + Q0 + v * V, x);
    }
    __syncthreads();
  }
  // the tile's rows of Y's factors, in two halves
  __device__ __forceinline__ void rows_out(const Reg& g, long long r0, int m, T* sh) const {
    rows_part<0, kYS / 2>(g, r0, m, sh);
    rows_part<kYS / 2, kYS / 2>(g, r0, m, sh);
  }
  __device__ __forceinline__ void point_values(const Reg&, T*) const {}
  __device__ __forceinline__ void point_out(long long, T) const {}
  __device__ __forceinline__ void camera_values(const Reg& g, const T*, T* v) const {
#pragma unroll
    for (int a = 0; a < kStage; ++a) v[a] = g.s[a];
  }
  // item a < 45: FtF's and Y'Y's upper entry (i, j); else U's entry a - 45
  __device__ __forceinline__ Entry entry(int a) const {
    return a < kFtFUpper ? upper_entry(a) : Entry{a - kFtFUpper, -1};
  }
  __device__ __forceinline__ void run_put(const T* r, int n, int a, Entry e, T* w) const {
    const int i = e.i, j = e.j;
    if (j >= 0) {
      T f = T(0), y = T(0);
      for (int k = 0; k < n; ++k, r += kStage) {
        const T f0i = r[i], f0j = r[j], f1i = r[kTF + i], f1j = r[kTF + j];
        const T p00 = f0i * f0j, p11 = f1i * f1j, p01 = f0i * f1j + f1i * f0j;
        f += p00 + p11;
        y += r[2 * kTF + 2] * p00 + r[2 * kTF + 3] * p01 + r[2 * kTF + 4] * p11;
      }
      w[a] = f;
      w[kFtFUpper + a] = y;
    } else {
      T s = T(0);
      for (int k = 0; k < n; ++k, r += kStage)
        s += r[i] * r[2 * kTF] + r[kTF + i] * r[2 * kTF + 1];
      w[2 * kFtFUpper + i] = s;
    }
  }
};

// the camera levels' last store: FtF's upper entries to both of their
// places, U's entries to U, and the sum of Y_b'Y_b over the camera's rows
// added to AtA's diagonal block at both places of each upper entry (after
// the pair levels wrote the block: a fixed order)
template <typename T>
struct CameraStore {
  T* ftf;  // (C, 81)
  T* U;    // (9C,)
  T* ata;  // (9C, 9C)
  int C;
  __device__ __forceinline__ void put(long long c, int e, T v) const {
    if (e < kFtFUpper) {
      const Entry ab = upper_entry(e);
      ftf[c * kBlk + ab.i * kTF + ab.j] = v;
      ftf[c * kBlk + ab.j * kTF + ab.i] = v;
    } else if (e < 2 * kFtFUpper) {
      const Entry ab = upper_entry(e - kFtFUpper);
      const long long t = (long long)C * kTF, d = c * kTF;
      ata[(d + ab.i) * t + d + ab.j] += v;
      if (ab.i != ab.j) ata[(d + ab.j) * t + d + ab.i] += v;
    } else {
      U[c * kTF + e - 2 * kFtFUpper] = v;
    }
  }
};

// the pair levels' last store: key (c_a, c_b), c_a <= c_b, entry l = (i, j)
// to AtA's block (c_a, c_b) at (i, j) and to its block (c_b, c_a) at (j, i);
// for c_a = c_b the upper triangle's entries only, each to both places
template <typename T>
struct AtaStore {
  T* ata;               // (9C, 9C)
  const int* key_cams;  // (n_keys,) c_a * C + c_b
  int C;
  __device__ __forceinline__ void put(long long key, int l, T v) const {
    const int kc = __ldg(key_cams + key), ca = kc / C, cb = kc % C;
    const int i = l / kTF, j = l % kTF;
    if (ca == cb && i > j) return;  // a key within one camera: its upper triangle
    const long long t = (long long)C * kTF;
    ata[(long long)(ca * kTF + i) * t + cb * kTF + j] = v;
    ata[(long long)(cb * kTF + j) * t + ca * kTF + i] = v;
  }
};

// Chunk k of the pair plan (pairs cs[k] .. cs[k+1] of one key, two rows
// each) -> its partial out[k] (81): sum over its pairs of Y_a'Y_b, or, for
// a key within one camera, Y_a'Y_b + Y_b'Y_a, of which the store reads the
// upper triangle. Y has rank 2, Y = Z Jsf, so Y_a'Y_b = Jsf_a' G Jsf_b
// with a 2 x 2 G = Z_a'Z_b. The block stages its pairs' rows first, then
// their rows of Y's factors with every load in flight at once, then each
// pair's G; thread (part g, tile t) sums a 3 x 3 tile of the block over
// pairs g, g + kPairParts, ... in registers, from 16 values of shared
// memory a pair; the parts are summed in order.
template <typename T, class Tag>
__global__ void __launch_bounds__(kPairThreads, 4)
pair_chunk_kernel(const T* __restrict__ Y, const int* __restrict__ cam_idx,
                  const int* __restrict__ pair_a, const int* __restrict__ pair_b,
                  const int* __restrict__ cs, T* __restrict__ out) {
  constexpr int V = Vec16<T>::kN, NV = kYS / V;
  constexpr int kLoads = (CT_CHUNK * 2 * NV + kPairThreads - 1) / kPairThreads;
  constexpr int kRows = CT_CHUNK * 2 * kYS, kParts = kPairParts * kBlk;
  __shared__ T buf[kRows > kParts ? kRows : kParts];  // the rows, then the parts
  __shared__ T gz[4 * CT_CHUNK];                       // pair q's G at 4q, row-major
  __shared__ int ab[2 * CT_CHUNK];                     // pair q's rows at 2q, 2q + 1
  __shared__ int one_camera;
  const int tid = threadIdx.x;
  const int s = cs[blockIdx.x], n = cs[blockIdx.x + 1] - s;
  for (int i = tid; i < 2 * n; i += kPairThreads)
    ab[i] = __ldg((i % 2 ? pair_b : pair_a) + s + i / 2);
  if (tid == 0)
    one_camera = __ldg(cam_idx + __ldg(pair_a + s)) == __ldg(cam_idx + __ldg(pair_b + s));
  __syncthreads();
  T x[kLoads][V];
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int i = tid + it * kPairThreads;
    if (i < n * 2 * NV) Vec16<T>::load(Y + (long long)ab[i / NV] * kYS + (i % NV) * V, x[it]);
  }
#pragma unroll
  for (int it = 0; it < kLoads; ++it) {
    const int i = tid + it * kPairThreads;
    if (i < n * 2 * NV)
#pragma unroll
      for (int k = 0; k < V; ++k) buf[i * V + k] = x[it][k];
  }
  __syncthreads();
  for (int i = tid; i < 4 * n; i += kPairThreads) {  // G[r][c] of pair q
    const int q = i / 4, r = (i / 2) % 2, c = i % 2;
    const T* za = buf + q * 2 * kYS + kZ + r * kTE;
    const T* zb = buf + (q * 2 + 1) * kYS + kZ + c * kTE;
    gz[i] = za[0] * zb[0] + za[1] * zb[1] + za[2] * zb[2];
  }
  __syncthreads();
  const int g = tid / kTiles, t = tid % kTiles, I = t / 3, J = t % 3;
  T acc[3][3] = {};
  // a key within one camera needs the tiles on and above the diagonal only
  if (g < kPairParts && !(one_camera && J < I)) {
    for (int q = g; q < n; q += kPairParts) {
      const T* G = gz + 4 * q;
      // Y_a'Y_b, and in one camera Y_b'Y_a = Jsf_b' G' Jsf_a after it
      for (int pass = 0; pass < (one_camera ? 2 : 1); ++pass) {
        const T* r0 = buf + (q * 2 + pass) * kYS;
        const T* r1 = buf + (q * 2 + 1 - pass) * kYS;
        const T g00 = G[0], g01 = G[pass ? 2 : 1], g10 = G[pass ? 1 : 2], g11 = G[3];
        T h[2][3];  // (G Jsf_1) at columns 3J .. 3J + 2
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const T f0 = r1[3 * J + v], f1 = r1[kTF + 3 * J + v];
          h[0][v] = g00 * f0 + g01 * f1;
          h[1][v] = g10 * f0 + g11 * f1;
        }
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          const T f0 = r0[3 * I + u], f1 = r0[kTF + 3 * I + u];
#pragma unroll
          for (int v = 0; v < 3; ++v) acc[u][v] += f0 * h[0][v] + f1 * h[1][v];
        }
      }
    }
  }
  __syncthreads();  // the rows are read: buf takes the parts
  if (g < kPairParts)
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int v = 0; v < 3; ++v) buf[g * kBlk + (3 * I + u) * kTF + 3 * J + v] = acc[u][v];
  __syncthreads();
  if (tid < kBlk) {
    T sum = T(0);
    for (int gg = 0; gg < kPairParts; ++gg) sum += buf[gg * kBlk + tid];
    out[(long long)blockIdx.x * kBlk + tid] = sum;
  }
}

template <typename T>
int schur_launch(const T* JT, int B, int C, const int* cam_idx, const int* pt_idx,
                 const T* sc, const T* sp, const T* K, const T* u, const int* pt_start,
                 const int* pt_block, int n_pt_blocks, const int* tile_first,
                 const int* tile_run, const int* run_start, const int* run_slot,
                 const int* run_pos, int n_run_levels, const int* const* run_levels,
                 const int* run_sizes, const int* run_first, const int* pair_a,
                 const int* pair_b, int n_pair_levels, const int* const* pair_levels,
                 const int* pair_sizes, const int* key_first, const int* key_cams,
                 T* Y, T* w, T* run_work, T* pair_partial, T* pair_work, T* ata,
                 T* ftf, T* U, cudaStream_t stream) {
  using Body = SchurAssembly<T>;
  if (!aligned16(Y) || n_pair_levels < 1) return (int)cudaErrorInvalidValue;
  if (n_pt_blocks > 0) {
    const Body body{JT, B, C, cam_idx, pt_idx, sc, sp, K, u, Y,
                    {tile_first, tile_run, run_start, run_slot, run_pos, w}};
    auto pass = point_pass_kernel<T, Body>;
    CT_LAUNCH(pass, n_pt_blocks, kBlock, stream, body, pt_start, pt_block);
  }
  if (pair_sizes[0] > 0) {
    auto pairs = pair_chunk_kernel<T, Body>;
    CT_LAUNCH(pairs, pair_sizes[0], kPairThreads, stream, Y, cam_idx, pair_a, pair_b,
              pair_levels[0], pair_partial);
  }
  const int n_keys = C * (C + 1) / 2;
  level_sums<T, Body, kBlk, kBlk>(pair_partial, n_keys, n_pair_levels - 1,
                                  pair_levels + 1, pair_sizes + 1, key_first, pair_work,
                                  AtaStore<T>{ata, key_cams, C}, stream);
  // after AtA's blocks are written: the run levels add Y'Y to its diagonal
  level_sums<T, Body, Body::kCam, Body::kCam>(w, C, n_run_levels, run_levels, run_sizes,
                                              run_first, run_work,
                                              CameraStore<T>{ftf, U, ata, C}, stream);
  return (int)cudaGetLastError();
}

}  // namespace ct

// sc (C, 9), sp (P, 3), K (P, 9) row-major L^{-1} blocks, u (P, 3) ->
// ata (9C, 9C), ftf (C, 81), U (9C). Rows sorted by point (pt_start covers
// B); pt_block (n_pt_blocks + 1,) the first point of each point block; the
// runs (RowPlan.run_*, as post_eval_fused takes them) with their camera
// levels run_levels, run_sizes (host arrays of n_run_levels) and run_first
// (C + 1,); the pair plan (RowPlan.pairs): pair_a, pair_b, its levels
// pair_levels, pair_sizes (host arrays of n_pair_levels >= 1, level 0
// chunking the pairs), key_first (C (C + 1) / 2 + 1,) and key_cams
// (C (C + 1) / 2,). Workspace: Y (B, 24), 16-byte aligned, the rows'
// factors of Y; w (n_runs, 99), run_work (sum of run_sizes, 99),
// pair_partial (pair_sizes[0], 81), pair_work (sum of pair_sizes[1:], 81).
#define CT_SCHUR_ENTRY(NAME, T)                                                \
  extern "C" int NAME(                                                         \
      const T* JT, int B, int C, const int* cam_idx, const int* pt_idx,        \
      const T* sc, const T* sp, const T* K, const T* u, const int* pt_start,   \
      const int* pt_block, int n_pt_blocks, const int* tile_first,             \
      const int* tile_run, const int* run_start, const int* run_slot,          \
      const int* run_pos, int n_run_levels, const int* const* run_levels,      \
      const int* run_sizes, const int* run_first, const int* pair_a,           \
      const int* pair_b, int n_pair_levels, const int* const* pair_levels,     \
      const int* pair_sizes, const int* key_first, const int* key_cams, T* Y,  \
      T* w, T* run_work, T* pair_partial, T* pair_work, T* ata, T* ftf, T* U,  \
      cudaStream_t stream) {                                                   \
    return ct::schur_launch<T>(                                                \
        JT, B, C, cam_idx, pt_idx, sc, sp, K, u, pt_start, pt_block,           \
        n_pt_blocks, tile_first, tile_run, run_start, run_slot, run_pos,       \
        n_run_levels, run_levels, run_sizes, run_first, pair_a, pair_b,        \
        n_pair_levels, pair_levels, pair_sizes, key_first, key_cams, Y, w,     \
        run_work, pair_partial, pair_work, ata, ftf, U, stream);               \
  }

CT_SCHUR_ENTRY(ct_schur_assembly_f64, double)
CT_SCHUR_ENTRY(ct_schur_assembly_f32, float)
