// Shared pieces of the port's CUDA kernels.
//
// Layouts every kernel agrees on (ops/kernels.py builds and checks them):
//   JT  (24, B)  unscaled Jacobian lanes, row-major: lane i*9+a is J_f[i][a]
//                (residual row i of 2, camera column a of 9), lane
//                18+i*3+k is J_e[i][k] (point column k of 3).
//   rT  (2, B)   residual rows.
// Rows are sorted by point, so a point's rows are one contiguous segment
// pt_start[p] .. pt_start[p+1]. Camera sums go through a camera plan: the
// rows ordered by camera (cam_rows), cut into chunks of at most CT_CHUNK
// rows that never cross a camera (chunk k covers cam_rows[cs[k] .. cs[k+1]),
// camera c owns chunks cf[c] .. cf[c+1]). A chunk kernel writes one partial
// per chunk and lane; a finalize pass sums a camera's partials in chunk
// order. No float atomics anywhere: every sum has a fixed order, so a solve
// repeats bit for bit from run to run.
#pragma once

#include <cuda_runtime.h>

// rows (or items) per chunk, kn.CHUNK; the tests' CPU build of the kernels
// may set it smaller, with kn.CHUNK, to reach deep level trees at small sizes
#ifndef CT_CHUNK
#define CT_CHUNK 64
#endif

#ifndef CT_LAUNCH
#define CT_LAUNCH(kernel, grid, block, stream, ...) \
  kernel<<<(grid), (block), 0, (stream)>>>(__VA_ARGS__)
#endif

namespace ct {

constexpr int kR = 2;    // residual rows per observation
constexpr int kTF = 9;   // camera tangent size
constexpr int kTE = 3;   // point tangent size
constexpr int kLanes = kR * (kTF + kTE);  // 24 lanes of JT
constexpr int kEOff = kR * kTF;           // first J_e lane

inline int ceil_div(long long a, int b) { return (int)((a + b - 1) / b); }

// 16 bytes of float or double, loaded through the read-only path or stored
// in one instruction; p must be 16-byte aligned.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* x) {
    float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <>
struct Vec16<double> {
  static constexpr int kN = 2;
  static __device__ __forceinline__ void load(const double* p, double* x) {
    double2 v = __ldg(reinterpret_cast<const double2*>(p));
    x[0] = v.x, x[1] = v.y;
  }
  static __device__ __forceinline__ void store(double* p, const double* x) {
    *reinterpret_cast<double2*>(p) = make_double2(x[0], x[1]);
  }
};

// Sum of the partials of each camera in chunk order:
// out[c * L + l] = sum_{k = cf[c]}^{cf[c+1]-1} partial[k * L + l].
template <typename T>
__global__ void camera_finalize_kernel(const T* __restrict__ partial,
                                       const int* __restrict__ cf, int C,
                                       int L, T* __restrict__ out) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)C * L) return;
  int c = (int)(idx / L), l = (int)(idx % L);
  T acc = T(0);
  for (int k = cf[c]; k < cf[c + 1]; ++k) acc += partial[(long long)k * L + l];
  out[idx] = acc;
}

// Block-wide sum of one double per thread, in a fixed tree order.
template <int NT>
__device__ double block_sum(double v, double* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  return sh[0];
}

}  // namespace ct
