// The heavy-first tile schedule shared by kernels A and B.
//
// One CTA per tile runs in blockIdx order, and the SMs take blocks as they
// free up, so a crowded tile that starts late sets the tail of the launch.
// Before its main kernel, each launch runs heavy_first_order on the same
// stream: one block that writes the tiles in descending class of their
// capped pair count min(tile_count, k_cap), by a counting sort in shared
// memory (a histogram, a scan from the heaviest class down, a scatter).
// The class is the capped count itself while k_cap < kOrderClasses, else
// the capped count in kOrderClasses equal bins. Within a class the order is
// that of the shared-memory cursors: the kernels' outputs do not depend on
// the schedule, so any order gives the same bits. The plain twin is
// ops/cuda/raster.py::tile_order.

#pragma once

#include <cuda_runtime.h>

constexpr int kOrderThreads = 1024;
constexpr int kOrderClasses = 2048;

__device__ __forceinline__ int order_class(int count, int k_cap) {
  const int c = min(max(count, 0), k_cap);
  return k_cap < kOrderClasses
             ? c
             : static_cast<int>(static_cast<long long>(c) *
                                (kOrderClasses - 1) / k_cap);
}

namespace {

__global__ void __launch_bounds__(kOrderThreads)
heavy_first_order(const int* __restrict__ tile_count, int num_tiles,
                  int k_cap, int* __restrict__ order) {
  __shared__ int s_base[kOrderClasses];
  for (int c = threadIdx.x; c < kOrderClasses; c += blockDim.x) s_base[c] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < num_tiles; t += blockDim.x)
    atomicAdd(&s_base[order_class(tile_count[t], k_cap)], 1);
  __syncthreads();
  // s_base[c] becomes the number of tiles in the classes above c: lane l of
  // warp 0 scans the l-th run of 64 classes from the top
  if (threadIdx.x < 32) {
    constexpr int kPer = kOrderClasses / 32;
    const int lane = threadIdx.x;
    const int top = kOrderClasses - lane * kPer;
    int sum = 0;
    for (int c = top - 1; c >= top - kPer; --c) sum += s_base[c];
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    int run = incl - sum;
    for (int c = top - 1; c >= top - kPer; --c) {
      const int h = s_base[c];
      s_base[c] = run;
      run += h;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < num_tiles; t += blockDim.x)
    order[atomicAdd(&s_base[order_class(tile_count[t], k_cap)], 1)] = t;
}

}  // namespace
