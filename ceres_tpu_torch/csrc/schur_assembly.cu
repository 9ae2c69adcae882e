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
// rhs = b_f - U (ceres_tpu/solvers/fused_lm.py:938-946).
//
// Replaces the Pallas kernel schur_assembly in mode="dense"
// (ceres_tpu/ops/pallas_kernels.py:1281, pallas_call at :1546).
//
// What bounds it on an H100: bytes. At BAL-16 the function reads J, the
// scales, K, u and the row maps and writes AtA, FtF and U: ~20 MB in
// float64, ~6 us at 3.35 TB/s. Its arithmetic, each symmetric product
// counted once, is ~140 Mflop, ~2 us at the card's 67 TFLOP/s (float64
// on the tensor cores, float32 outside them). This first version is far
// from that bound: see the pair blocks below.
// Design: pass 1, one thread per row, computes Y_b and keeps it in a
// (27, B) workspace. Pass 2 runs two kinds of blocks in one launch. Camera
// blocks take a chunk of one camera's rows (common.cuh camera plan) and
// sum FtF and U over it with 90 lanes. Pair blocks take a chunk of the
// pair plan: every (a, b) pair of rows of one point, ordered by camera
// pair (c_a, c_b), then by point, so a chunk belongs to one output block;
// 81 lanes sum Y_a' Y_b over the chunk in order. Pass 3 sums each output's
// chunk partials in order. Every sum has a fixed order: no atomics, and
// AtA comes out exactly symmetric. Nothing depends on the output fitting
// shared memory, so the kernel stays right for any camera count (the JAX
// package takes this path up to t_full = 1024); it is then slower, since
// the pair plan grows as sum_p m_p^2.
#include "common.cuh"

namespace {

using ct::kEOff;
using ct::kTE;
using ct::kTF;

constexpr int kThreads = 128;
constexpr int kY = kTE * kTF;            // 27 values of Y per row
constexpr int kFtF = kTF * kTF;          // 81
constexpr int kCamLanes = kFtF + kTF;    // 90: FtF and U
constexpr int kCamW = 2 * kTF + kY + kTE;  // 48 staged values per row
constexpr int kPairW = 2 * kY;             // 54 staged values per pair

template <typename T>
__global__ void __launch_bounds__(kThreads)
schur_rows_kernel(const T* __restrict__ JT, int B,
                  const int* __restrict__ cam_idx,
                  const int* __restrict__ pt_idx, const T* __restrict__ sc,
                  const T* __restrict__ sp, const T* __restrict__ K,
                  T* __restrict__ Y) {
  int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  const T* scc = sc + (long long)cam_idx[b] * kTF;
  long long p = pt_idx[b];
  const T* spp = sp + p * kTE;
  const T* Kp = K + p * kTE * kTE;
  T jsf[2][kTF], jsp[2][kTE];
  for (int i = 0; i < 2; ++i) {
    for (int a = 0; a < kTF; ++a)
      jsf[i][a] = JT[(long long)(i * kTF + a) * B + b] * scc[a];
    for (int k = 0; k < kTE; ++k)
      jsp[i][k] = JT[(long long)(kEOff + i * kTE + k) * B + b] * spp[k];
  }
  for (int a = 0; a < kTF; ++a) {
    T w[kTE];
    for (int k = 0; k < kTE; ++k) w[k] = jsp[0][k] * jsf[0][a] + jsp[1][k] * jsf[1][a];
    for (int m = 0; m < kTE; ++m) {
      T y = T(0);
      for (int k = 0; k < kTE; ++k) y += Kp[m * kTE + k] * w[k];
      Y[(long long)(m * kTF + a) * B + b] = y;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
schur_chunks_kernel(const T* __restrict__ JT, const T* __restrict__ Y, int B,
                    const int* __restrict__ cam_idx,
                    const int* __restrict__ pt_idx, const T* __restrict__ sc,
                    const T* __restrict__ u, const int* __restrict__ cam_rows,
                    const int* __restrict__ cam_chunk_start, int n_cam_chunks,
                    const int* __restrict__ pair_a,
                    const int* __restrict__ pair_b,
                    const int* __restrict__ pair_chunk_start,
                    T* __restrict__ cam_partial, T* __restrict__ pair_partial) {
  __shared__ T buf[CT_CHUNK * kPairW];
  int l = threadIdx.x;
  if ((int)blockIdx.x < n_cam_chunks) {
    int chunk = blockIdx.x;
    int s = cam_chunk_start[chunk], n = cam_chunk_start[chunk + 1] - s;
    for (int idx = l; idx < n * kCamW; idx += kThreads) {
      int i = idx / kCamW, q = idx % kCamW;
      int b = cam_rows[s + i];
      T v;
      if (q < 2 * kTF) {
        v = JT[(long long)q * B + b] * sc[(long long)cam_idx[b] * kTF + q % kTF];
      } else if (q < 2 * kTF + kY) {
        v = Y[(long long)(q - 2 * kTF) * B + b];
      } else {
        v = u[(long long)pt_idx[b] * kTE + (q - 2 * kTF - kY)];
      }
      buf[i * kCamW + q] = v;
    }
    __syncthreads();
    if (l >= kCamLanes) return;
    T acc = T(0);
    if (l < kFtF) {
      int a = l / kTF, c = l % kTF;
      for (int i = 0; i < n; ++i) {
        const T* r = buf + i * kCamW;
        acc += r[a] * r[c] + r[kTF + a] * r[kTF + c];
      }
    } else {
      int j = l - kFtF;
      for (int i = 0; i < n; ++i) {
        const T* r = buf + i * kCamW;
        for (int m = 0; m < kTE; ++m) acc += r[2 * kTF + m * kTF + j] * r[2 * kTF + kY + m];
      }
    }
    cam_partial[(long long)chunk * kCamLanes + l] = acc;
    return;
  }
  int chunk = blockIdx.x - n_cam_chunks;
  int s = pair_chunk_start[chunk], n = pair_chunk_start[chunk + 1] - s;
  for (int idx = l; idx < n * kPairW; idx += kThreads) {
    int i = idx / kPairW, q = idx % kPairW;
    int b = q < kY ? pair_a[s + i] : pair_b[s + i];
    buf[i * kPairW + q] = Y[(long long)(q % kY) * B + b];
  }
  __syncthreads();
  if (l >= kFtF) return;
  int ja = l / kTF, jb = l % kTF;
  T acc = T(0);
  for (int i = 0; i < n; ++i) {
    const T* r = buf + i * kPairW;
    for (int m = 0; m < kTE; ++m) acc += r[m * kTF + ja] * r[kY + m * kTF + jb];
  }
  pair_partial[(long long)chunk * kFtF + l] = acc;
}

template <typename T>
__global__ void schur_finalize_kernel(const T* __restrict__ cam_partial,
                                      const int* __restrict__ cam_chunk_first,
                                      const T* __restrict__ pair_partial,
                                      const int* __restrict__ pair_chunk_first,
                                      int C, T* __restrict__ ata,
                                      T* __restrict__ ftf, T* __restrict__ U) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long n_ata = (long long)C * C * kFtF;
  if (idx < n_ata) {
    int key = (int)(idx / kFtF), l = (int)(idx % kFtF);
    T acc = T(0);
    for (int k = pair_chunk_first[key]; k < pair_chunk_first[key + 1]; ++k)
      acc += pair_partial[(long long)k * kFtF + l];
    int ca = key / C, cb = key % C, ja = l / kTF, jb = l % kTF;
    long long t_full = (long long)C * kTF;
    ata[(long long)(ca * kTF + ja) * t_full + cb * kTF + jb] = acc;
    return;
  }
  idx -= n_ata;
  if (idx >= (long long)C * kCamLanes) return;
  int c = (int)(idx / kCamLanes), l = (int)(idx % kCamLanes);
  T acc = T(0);
  for (int k = cam_chunk_first[c]; k < cam_chunk_first[c + 1]; ++k)
    acc += cam_partial[(long long)k * kCamLanes + l];
  if (l < kFtF) {
    ftf[(long long)c * kFtF + l] = acc;
  } else {
    U[(long long)c * kTF + (l - kFtF)] = acc;
  }
}

template <typename T>
int launch(const T* JT, int B, int P, int C, const int* cam_idx,
           const int* pt_idx, const T* sc, const T* sp, const T* K, const T* u,
           const int* cam_rows, const int* cam_chunk_start, int n_cam_chunks,
           const int* cam_chunk_first, const int* pair_a, const int* pair_b,
           const int* pair_chunk_start, int n_pair_chunks,
           const int* pair_chunk_first, T* Y, T* cam_partial, T* pair_partial,
           T* ata, T* ftf, T* U, cudaStream_t stream) {
  (void)P;
  if (B > 0) {
    CT_LAUNCH(schur_rows_kernel<T>, ct::ceil_div(B, kThreads), kThreads, stream,
              JT, B, cam_idx, pt_idx, sc, sp, K, Y);
  }
  if (n_cam_chunks + n_pair_chunks > 0) {
    CT_LAUNCH(schur_chunks_kernel<T>, n_cam_chunks + n_pair_chunks, kThreads,
              stream, JT, Y, B, cam_idx, pt_idx, sc, u, cam_rows,
              cam_chunk_start, n_cam_chunks, pair_a, pair_b, pair_chunk_start,
              cam_partial, pair_partial);
  }
  long long outs = (long long)C * C * kFtF + (long long)C * kCamLanes;
  if (outs > 0) {
    CT_LAUNCH(schur_finalize_kernel<T>, ct::ceil_div(outs, 256), 256, stream,
              cam_partial, cam_chunk_first, pair_partial, pair_chunk_first, C,
              ata, ftf, U);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// sc (C, 9), sp (P, 3), K (P, 9) row-major L^{-1} blocks, u (P, 3) ->
// ata (9C, 9C), ftf (C, 81), U (9C). Workspace: Y (27, B), cam_partial
// (n_cam_chunks, 90), pair_partial (n_pair_chunks, 81).
#define CT_SCHUR_ENTRY(NAME, T)                                                \
  extern "C" int NAME(                                                         \
      const T* JT, int B, int P, int C, const int* cam_idx,                    \
      const int* pt_idx, const T* sc, const T* sp, const T* K, const T* u,     \
      const int* cam_rows, const int* cam_chunk_start, int n_cam_chunks,       \
      const int* cam_chunk_first, const int* pair_a, const int* pair_b,        \
      const int* pair_chunk_start, int n_pair_chunks,                          \
      const int* pair_chunk_first, T* Y, T* cam_partial, T* pair_partial,      \
      T* ata, T* ftf, T* U, cudaStream_t stream) {                             \
    return launch<T>(JT, B, P, C, cam_idx, pt_idx, sc, sp, K, u, cam_rows,     \
                     cam_chunk_start, n_cam_chunks, cam_chunk_first, pair_a,   \
                     pair_b, pair_chunk_start, n_pair_chunks,                  \
                     pair_chunk_first, Y, cam_partial, pair_partial, ata, ftf, \
                     U, stream);                                               \
  }

CT_SCHUR_ENTRY(ct_schur_assembly_f64, double)
CT_SCHUR_ENTRY(ct_schur_assembly_f32, float)
