// The heavy-first tile schedule shared by kernels A, B, C and D.
//
// One CTA per tile runs in blockIdx order, and the SMs take blocks as they
// free up, so a crowded tile that starts late sets the tail of the launch.
// Before its main kernel, each launch runs heavy_first_order on the same
// stream: one block that writes the tiles in descending class of a
// per-tile weight capped at `cap`, by a counting sort in shared memory (a
// histogram, a scan from the heaviest class down, a scatter). The weight is
// a functor of the tile: A and B take the pair count (TileCount over
// tile_count, cap k_cap; ListCount over a tile list's positions), D the
// ordered list's length (TileCount over k_used), C the union positions its
// merge reads (anchor_fwd.cu). The class
// is the capped weight itself while cap < kOrderClasses, else the capped
// weight in kOrderClasses equal bins. Within a class the order is that of
// the shared-memory cursors: the kernels' outputs do not depend on the
// schedule, so any order gives the same bits. The plain twins are
// ops/cuda/raster.py::tile_order and anchor_tile_order.

#pragma once

#include <cuda_runtime.h>

constexpr int kOrderThreads = 1024;
constexpr int kOrderClasses = 2048;

__device__ __forceinline__ int order_class(int weight, int cap) {
  const int c = min(max(weight, 0), cap);
  return cap < kOrderClasses
             ? c
             : static_cast<int>(static_cast<long long>(c) *
                                (kOrderClasses - 1) / cap);
}

// the weight of tile t is count[t]
struct TileCount {
  const int* count;
  __device__ __forceinline__ int operator()(int t) const { return count[t]; }
};

// the weight of list position i is count[tile_ids[i]], 0 for the empty
// sentinel id num_tiles (A's and B's tile-list entries order positions)
struct ListCount {
  const int* count;
  const int* tile_ids;
  int num_tiles;
  __device__ __forceinline__ int operator()(int i) const {
    const int t = tile_ids[i];
    return t < num_tiles ? count[t] : 0;
  }
};

namespace {

template <class Weight>
__global__ void __launch_bounds__(kOrderThreads)
heavy_first_order(Weight weight, int num_tiles, int cap,
                  int* __restrict__ order) {
  __shared__ int s_base[kOrderClasses];
  for (int c = threadIdx.x; c < kOrderClasses; c += blockDim.x) s_base[c] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < num_tiles; t += blockDim.x)
    atomicAdd(&s_base[order_class(weight(t), cap)], 1);
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
    order[atomicAdd(&s_base[order_class(weight(t), cap)], 1)] = t;
}

}  // namespace
