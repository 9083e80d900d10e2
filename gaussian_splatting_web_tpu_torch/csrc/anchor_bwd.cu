// Kernel D: backward of the anchor compositor (kernel C) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel gaussian_splatting_web_tpu/ops/pallas/anchor.py::
// _bwd_kernel (launched by backward_anchor_grads) and computes what it
// computes in exact mode: per 16x16 pixel tile, walking the tile's ordered
// list back to front, the gradient of the loss with respect to every kept
// entry's compositor fields, 9 floats:
//   d mean2d (x, y), d conic (a, b, c), d rgb (r, g, b), d opacity,
// by kernel B's formulas (raster_bwd.cu). An entry can be kept by up to
// four tiles, so its rows go to one of four row groups, range row type
// (A 0, B 1) x tile column parity: the (up to) four tiles that keep one
// entry are (ax, ay), (ax+1, ay), (ax, ay+1), (ax+1, ay+1) for its anchor
// tile (ax, ay), and they fall in four distinct groups; a dup entry is
// kept only by its own tile. The groups are summed and folded onto the
// splats afterwards (ops/anchor.py::fold_anchor_grads).
// The TPU-only parts are left out: the redone merge (kernel C writes the
// ordered lists, their row groups and lengths, and D reads them), the
// one-hot transpose back to slab positions, the bf16 matmul splits and the
// boundary-block read-merge-write.
//
// Residual: C's per-pixel final log-T and last contributing index in the
// ordered list, as kernel B takes A's. A pixel walks k <= last_idx back to
// front and rebuilds its log-T by subtracting log1p(-alpha) of each pair
// that passed the cutoff.
//
// What bounds it on this card: kernel B's limits (raster_bwd.cu). A pair
// passes the cutoff at ~16 of a tile's 256 pixels, and device memory sees
// only the ordered lists, one 48-byte field row per kept pair and 36 bytes
// written per pair, so issue slots spent on pixels a pair cannot reach and
// load imbalance between tiles bound it, not bytes.
//
// Design: kernel B's walk (tile_walk.cuh::backward_tile) over the ordered
// list: warp w owns an 8x4 pixel block, each staged pair carries its
// footprint mask, each warp walks from its own largest last_idx and visits
// only the pairs whose bit it holds (32 at a time, one ballot), a visited
// pair's nine sums take the 14-shuffle transposing butterfly, and the
// thread that staged the pair adds the visiting warps' partials in warp
// order and stores the pair's row with plain stores at (group, sorted
// position) of a zeroed [4, M, 9] array. Each entry meets each group at
// most once: no atomics, and two runs give the same bits. Tiles run heavy
// first by their ordered-list length k_used (tile_order.cuh), written by a
// one-block kernel before the backward in the same launch.
//
// Numerics: power is recomputed with __fmul_rn / __fadd_rn in C's (and
// A's) order, so the cutoff and clamp decisions are C's. Build without
// -use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_order.cuh"
#include "tile_walk.cuh"

namespace {

__global__ void __launch_bounds__(kPix, kBwdBlocksPerSM)
anchor_bwd_kernel(const float* __restrict__ fields,
                  const int* __restrict__ sorted_gidx,
                  const int* __restrict__ ordered,
                  const int* __restrict__ k_used,
                  const int8_t* __restrict__ group,
                  const int* __restrict__ tile_order,
                  const float* __restrict__ final_log_t,
                  const int* __restrict__ last_idx,
                  const float* __restrict__ d_rgb,
                  const float* __restrict__ d_alpha,
                  int width, int height, int gx, int k_cap, int num_entries,
                  float log_cut, float alpha_max,
                  float* __restrict__ dpairs) {
  __shared__ BwdStage stage;
  const int tile = tile_order[blockIdx.x];
  const int* list = ordered + static_cast<size_t>(tile) * k_cap;
  const int8_t* groups = group + static_cast<size_t>(tile) * k_cap;
  backward_tile(
      fields, [=](int k) { return __ldg(sorted_gidx + __ldg(list + k)); },
      [=](int k) {
        return dpairs + (static_cast<size_t>(__ldg(groups + k)) * num_entries
                         + __ldg(list + k)) * kGrad;
      },
      k_used[tile], tile % gx, tile / gx, width, height,
      FrameIn{d_rgb, d_alpha, final_log_t, last_idx, width}, log_cut,
      alpha_max, stage);
}

}  // namespace

extern "C" {

// Launches kernel D on `stream` of `device` over gx * gy tiles: first the
// heavy-first schedule into `tile_order` (gx * gy ints of scratch), then
// the backward, block b walking tile tile_order[b]. Returns
// cudaGetLastError() (0 on success). Pointers are device pointers; `fields`
// must be 16-byte aligned with rows of 12 floats; `dpairs` [4, num_entries,
// 9] must be zeroed (only the rows of pairs some pixel reached are
// written).
int anchor_bwd(const float* fields, const int* sorted_gidx,
               const int* ordered, const int* k_used, const int8_t* group,
               int* tile_order, const float* final_log_t,
               const int* last_idx,
               const float* d_rgb, const float* d_alpha,
               int width, int height, int gx, int gy, int k_cap,
               int num_entries, float log_cut, float alpha_max,
               float* dpairs, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int num_tiles = gx * gy;
  if (num_tiles > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    heavy_first_order<<<1, kOrderThreads, 0, st>>>(
        TileCount{k_used}, num_tiles, k_cap, tile_order);
    anchor_bwd_kernel<<<num_tiles, kPix, 0, st>>>(
        fields, sorted_gidx, ordered, k_used, group, tile_order, final_log_t,
        last_idx, d_rgb, d_alpha, width, height, gx, k_cap, num_entries,
        log_cut, alpha_max, dpairs);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* anchor_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
