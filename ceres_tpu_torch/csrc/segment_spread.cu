// segment_spread_sum: the dense-Schur A of one camera-side slot on the
// generic flat Schur path (solvers/fused_lm.py, FlatDenseSchurStepOps):
//   out[p, i*C*tf + c*tf + j] = sum over the rows b of point p with
//                               cam[b] = c of Y[b, i*tf + j]
// for Y (B, te*tf) = K_p W_b, rows sorted by point (pt_start gives each
// point's rows), C camera blocks of tf columns; a camera id outside [0, C)
// (a constant block) adds nothing.
//
// Replaces segment_spread_sum (ceres_tpu/ops/pallas_kernels.py:462) in its
// form without Jc. The TPU kernel builds the (rows, te*C*tf) spread of a
// 128-row tile in VMEM with two selector matmuls and reduces it to points
// with a one-hot dot, so that the spread never reaches HBM. Here the spread
// never exists at all: each row adds its te*tf values into its camera's
// window of its point's slab.
//
// What bounds it on an H100: bytes, dominated by the output (P te C tf
// values, most of them zero) at the libmv shape. One thread block per
// point zeroes the point's slab, then thread q = (i, j) adds the rows of
// the point in row order into entry (i, cam*tf + j): each slab is written
// by its block only, each entry by one thread, in a fixed order, with no
// atomics.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
spread_kernel(const T* __restrict__ Y, const int* __restrict__ cam,
              const int* __restrict__ pt_start, int C, int te, int tf,
              T* __restrict__ out) {
  int p = blockIdx.x;
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
int launch(const T* Y, const int* cam, const int* pt_start, int P, int C, int te,
           int tf, T* out, cudaStream_t stream) {
  if (P > 0) {
    CT_LAUNCH(spread_kernel<T>, P, kThreads, stream, Y, cam, pt_start, C, te, tf,
              out);
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
