// A CPU stand-in for the part of the CUDA runtime that the port's kernels
// use, so that tests/test_torch_kernels_emulated.py can compile
// ceres_tpu_torch/csrc/*.cu with a host C++ compiler and run them. Blocks
// run one after another; the threads of a block run as std::threads, with
// __syncthreads as a barrier that exited threads drop out of, and
// __shared__ arrays as function-local statics, shared by the block that is
// running. It checks what the kernels compute, not how fast or how the
// card schedules them.
#pragma once
#include <math.h>
#include <stddef.h>
#include <atomic>
#include <cmath>
#include <thread>
#include <barrier>
#include <vector>
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3e { unsigned x, y, z; };
inline thread_local uint3e threadIdx;
inline thread_local uint3e blockIdx;
inline thread_local dim3 blockDim;
inline thread_local dim3 gridDim;
inline thread_local std::barrier<>* ct_emu_barrier;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
typedef void* cudaStream_t;
typedef void* cudaEvent_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
// launches run to their end before they return, so streams and events
// order nothing: one device, and calls that do nothing
enum { cudaStreamNonBlocking = 1, cudaEventDisableTiming = 2 };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetStreamPriorityRange(int* least, int* greatest) {
  *least = *greatest = 0;
  return 0;
}
inline int cudaStreamCreateWithPriority(cudaStream_t* s, unsigned, int) { *s = s; return 0; }
inline int cudaEventCreateWithFlags(cudaEvent_t* e, unsigned) { *e = e; return 0; }
inline int cudaEventRecord(cudaEvent_t, cudaStream_t) { return 0; }
inline int cudaStreamWaitEvent(cudaStream_t, cudaEvent_t, unsigned) { return 0; }
// device queries: a stand-in of no multiprocessors (the tests give
// ceres_tpu_torch/ops/kernels.py the card's resident blocks themselves)
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 0; return 0; }
template <class K>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, unsigned long) {
  *n = 0;
  return 0;
}
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class K>
inline int cudaFuncGetAttributes(cudaFuncAttributes* a, K) {
  *a = {};
  return 0;
}
inline void __syncthreads() { ct_emu_barrier->arrive_and_wait(); }
// blocks run one after another, so a fence has nothing to order across
// them; an atomic is one within its block
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return std::atomic_ref<unsigned>(*p).fetch_add(v);
}
template <typename T>
inline T __ldg(const T* p) { return *p; }
template <typename T>
inline T __ldcg(const T* p) { return *p; }
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct alignas(16) double2 { double x, y; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
inline double2 make_double2(double x, double y) { return {x, y}; }
template <typename... KArgs, typename... Args>
void ct_emu_launch(void (*k)(KArgs...), int grid, int block, Args... args) {
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    std::vector<std::thread> ts;
    for (int t = 0; t < block; ++t)
      ts.emplace_back([&, t] {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)b, 0, 0};
        blockDim = dim3(block);
        gridDim = dim3(grid);
        ct_emu_barrier = &bar;
        k(args...);
        bar.arrive_and_drop();
      });
    for (auto& th : ts) th.join();
  }
}
#define CT_LAUNCH(kernel, grid, block, stream, ...) \
  ct_emu_launch(kernel, (int)(grid), (int)(block), __VA_ARGS__)
