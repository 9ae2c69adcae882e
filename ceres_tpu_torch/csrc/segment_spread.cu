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
// exists at all: each row adds its te*tf values into its camera's window of
// its point's slab.
//
// With Jc (B, r*tf), the scaled camera Jacobian rows (the form the TPU
// kernel calls at :734), the same launch also forms the camera Gram blocks
//   ftf[c, i*tf + j] = sum over the rows b of camera c of
//                      sum_{q<r} Jc[b, q*tf + i] Jc[b, q*tf + j].
// The TPU kernel accumulates them across its sequential grid as a
// Khatri-Rao masked Gram of hi/lo bf16 halves; here they follow the camera
// plan of the other camera sums (common.cuh): one block per camera chunk (at
// most CT_CHUNK rows of one camera, in the stable by-camera row order) stages
// the chunk's Jc rows in shared memory, thread (i, j) sums the chunk's r
// outer products in row order into one partial, and a finalize pass sums
// each camera's partials in chunk order. No (B, tf*tf) outer-product tensor
// reaches device memory, and no atomics: every sum has a fixed order.
//
// What bounds it on an H100: bytes, dominated by the output A (P te C tf
// values, most of them zero). One thread block per point zeroes the point's
// slab, then thread q = (i, j) adds the rows of the point in row order into
// entry (i, cam*tf + j): each slab is written by its block only, each entry
// by one thread, in a fixed order. The F'F blocks read Jc once (r*tf values
// a row) and write C*tf*tf values.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRowWidth = 32;  // r*tf values of one Jc row staged per chunk row

// One point's slab of A (the form without Jc).
template <typename T>
__device__ void spread_point(const T* __restrict__ Y, const int* __restrict__ cam,
                             const int* __restrict__ pt_start, int p, int C, int te,
                             int tf, T* __restrict__ out) {
  int ky = te * tf;
  long long width = (long long)te * C * tf;
  T* slab = out + (long long)p * width;
  for (long long k = threadIdx.x; k < width; k += blockDim.x) slab[k] = T(0);
  __syncthreads();
  int s = pt_start[p], e = pt_start[p + 1];
  for (int q = threadIdx.x; q < ky; q += blockDim.x) {
    long long base = (long long)(q / tf) * C * tf + q % tf;
    for (int b = s; b < e; ++b) {
      int c = cam[b];
      if (c < 0 || c >= C) continue;
      slab[base + (long long)c * tf] += Y[(long long)b * ky + q];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spread_kernel(const T* __restrict__ Y, const int* __restrict__ cam,
              const int* __restrict__ pt_start, int C, int te, int tf,
              T* __restrict__ out) {
  spread_point(Y, cam, pt_start, blockIdx.x, C, te, tf, out);
}

// Blocks [0, P) spread one point each; block P + k forms the F'F partial of
// camera chunk k.
template <typename T>
__global__ void __launch_bounds__(kThreads)
spread_ftf_kernel(const T* __restrict__ Y, const int* __restrict__ cam,
                  const int* __restrict__ pt_start, int P, int C, int te, int tf,
                  T* __restrict__ out, const T* __restrict__ Jc, int r,
                  const int* __restrict__ cam_rows,
                  const int* __restrict__ chunk_start,
                  T* __restrict__ cam_partial) {
  __shared__ T rows[CT_CHUNK * kMaxRowWidth];
  __shared__ int live[CT_CHUNK];
  if ((int)blockIdx.x < P) {
    spread_point(Y, cam, pt_start, blockIdx.x, C, te, tf, out);
    return;
  }
  int chunk = blockIdx.x - P;
  int w = r * tf;
  int s = chunk_start[chunk], n = chunk_start[chunk + 1] - s;
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    int c = cam[cam_rows[s + t]];
    live[t] = c >= 0 && c < C;
  }
  for (int k = threadIdx.x; k < n * w; k += blockDim.x) {
    int t = k / w;
    rows[k] = Jc[(long long)cam_rows[s + t] * w + k % w];
  }
  __syncthreads();
  int blk = tf * tf;
  for (int ij = threadIdx.x; ij < blk; ij += blockDim.x) {
    int i = ij / tf, j = ij % tf;
    T acc = T(0);
    for (int t = 0; t < n; ++t) {
      if (!live[t]) continue;
      const T* row = rows + t * w;
      for (int q = 0; q < r; ++q) acc += row[q * tf + i] * row[q * tf + j];
    }
    cam_partial[(long long)chunk * blk + ij] = acc;
  }
}

template <typename T>
int launch(const T* Y, const int* cam, const int* pt_start, int P, int C, int te,
           int tf, T* out, cudaStream_t stream) {
  if (P > 0) {
    CT_LAUNCH(spread_kernel<T>, P, kThreads, stream, Y, cam, pt_start, C, te, tf,
              out);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ftf(const T* Y, const int* cam, const int* pt_start, int P, int C, int te,
               int tf, T* out, const T* Jc, int r, const int* cam_rows,
               const int* chunk_start, int n_chunks, const int* chunk_first,
               T* cam_partial, T* ftf, cudaStream_t stream) {
  static_assert(CT_CHUNK <= kThreads, "one thread per chunk row");
  if (r * tf > kMaxRowWidth) return (int)cudaErrorInvalidValue;
  int grid = P + n_chunks;
  if (grid > 0) {
    CT_LAUNCH(spread_ftf_kernel<T>, grid, kThreads, stream, Y, cam, pt_start, P, C,
              te, tf, out, Jc, r, cam_rows, chunk_start, cam_partial);
  }
  long long outs = (long long)C * tf * tf;
  if (outs > 0) {
    CT_LAUNCH(ct::camera_finalize_kernel<T>, ct::ceil_div(outs, 256), 256, stream,
              cam_partial, chunk_first, nullptr, C, tf * tf, ftf);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Y (B, te*tf), cam (B,), pt_start (P+1,) -> out (P, te*C*tf).
#define CT_SPREAD_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const T* Y, const int* cam, const int* pt_start, int P,  \
                      int C, int te, int tf, T* out, cudaStream_t stream) {    \
    return launch<T>(Y, cam, pt_start, P, C, te, tf, out, stream);             \
  }

CT_SPREAD_ENTRY(ct_segment_spread_sum_f64, double)
CT_SPREAD_ENTRY(ct_segment_spread_sum_f32, float)

// The same, plus Jc (B, r*tf) with r*tf <= 32 and the camera plan (cam_rows
// (B,), chunk_start (n_chunks+1,), chunk_first (C+1,)) -> ftf (C, tf*tf).
// Workspace: cam_partial (n_chunks, tf*tf).
#define CT_SPREAD_FTF_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const T* Y, const int* cam, const int* pt_start, int P,  \
                      int C, int te, int tf, T* out, const T* Jc, int r,       \
                      const int* cam_rows, const int* chunk_start,             \
                      int n_chunks, const int* chunk_first, T* cam_partial,    \
                      T* ftf, cudaStream_t stream) {                           \
    return launch_ftf<T>(Y, cam, pt_start, P, C, te, tf, out, Jc, r, cam_rows, \
                         chunk_start, n_chunks, chunk_first, cam_partial, ftf, \
                         stream);                                              \
  }

CT_SPREAD_FTF_ENTRY(ct_segment_spread_ftf_f64, double)
CT_SPREAD_FTF_ENTRY(ct_segment_spread_ftf_f32, float)
