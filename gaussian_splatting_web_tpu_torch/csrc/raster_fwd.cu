// Kernel A: forward tile compositor for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussian_splatting_web_tpu/ops/pallas/raster.py::
// _kernel (launched by composite_tiles_pallas) and computes what it and the
// XLA compositor ops/rasterize.py::_composite_chunk compute in exact mode:
// per 16x16 pixel tile, walk the depth-sorted segment
// [tile_start, tile_start + min(tile_count, k_cap)) front to back with
//   power = log(op) - 1/2 (A dx^2 + 2B dx dy + C dy^2)   (tile-local coords)
//   alpha = min(exp(power), alpha_max) if power >= log(1/255) else 0
//   a pair contributes while the inclusive log-T stays >= log(1e-4);
//   the first violator and everything after it do not.
// The TPU-only parts are left out: bf16x2/x3 matmul splits, the
// triangular-matmul cumsum, 128-lane slab DMA, R-tile groups, LOG_PAD
// lane masking and the packed-payload decode. Of the packed modes, only
// pack_mean16 reaches the kernel (the `mean16` flag): each pair's
// tile-local mean is rounded to 1/32 px as the JAX package's packed mean
// payload rounds it (tile_walk.cuh::quantize_mean16); pack_fields' bf16
// fields arrive already rounded in `fields`.
//
// What bounds it on this card: per (pair, pixel) step the work is ~20 FP32
// operations and three transcendentals out of shared memory; device memory
// sees the 48-byte field row of each pair once per tile. The first port
// evaluated power at every pixel of the tile for every staged pair, but only
// ~7% of those steps pass the 1/255 cutoff (a pair covers ~16 of the 256
// pixels), and it ran the tiles in raster order, so a crowded tile that
// started late set the tail. So the kernel is bound by issue slots spent on
// steps that do no work and by load imbalance, not by bytes.
//
// Design (the walk is tile_walk.cuh::composite_tile, which kernel C runs
// too): one CTA per tile, 256 threads, one thread per pixel; warp w covers
// the 8x4 pixel block at column 8 (w & 1), row 4 (w >> 1) of the tile (round
// footprints touch fewer 8x4 blocks than 16x2 rows). The CTA walks its
// segment in batches of 256 pairs: each thread gathers one pair through
// sorted_gidx (one 48-byte row, three 16-byte loads), turns it into the six
// rows of the bilinear form once, and computes the pair's footprint mask
// (footprint.cuh): the 8x4 blocks its power can reach log(1/255) in. A warp
// then walks only the pairs whose bit it holds, 32 mask bytes at a time
// through one ballot, so a warp-uniform branch skips the rest. Each thread
// runs the sequential INRIA recurrence for its pixel, carrying its log-T; a
// block-wide vote stops the walk once every pixel is done. Tiles run heavy
// first: the launch first writes the tiles in descending order of their
// capped pair count (tile_order.cuh), and block b takes tile tile_order[b].
//
// The next batch's gather is not overlapped with the composite by cp.async:
// a batch gathers 256 rows (12 KB, mostly L2 hits) once per 256 pairs, and
// the SM's other resident CTAs (six, at 40 registers a thread) composite
// meanwhile; with room for eight the kernel ran no faster
// on an H100 (PERF.md, Findings), so waiting on memory is not what holds it
// back.
//
// Numerics: the six form rows and power are summed with __fmul_rn /
// __fadd_rn in the order of the plain PyTorch twin (ops/rasterize.py), so
// no FMA contraction changes power and the cutoff, clamp and early-exit
// decisions match the twin bit for bit; the footprint cull skips only
// pixels whose power, so rounded, is below the cutoff (footprint.cuh), so
// it changes no decision. Build without -use_fast_math.
//
// Outputs (row-major images): rgb [H, W, 3] premultiplied, alpha [H, W],
// and INRIA's per-pixel residual for the backward pass: final_log_t [H, W]
// (log-T after the last contributing pair) and last_idx [H, W] (the
// segment-local index of the last contributing pair, -1 if none). Kernel B
// walks each pixel back to front from last_idx, rebuilding T from
// final_log_t. Pixels past W or H are masked.

#include <cuda_runtime.h>

#include "tile_order.cuh"
#include "tile_walk.cuh"

namespace {

__global__ void __launch_bounds__(kPix)
raster_fwd_kernel(const float* __restrict__ fields,
                  const int* __restrict__ sorted_gidx,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_count,
                  const int* __restrict__ tile_order,
                  int width, int height, int gx, int k_cap, bool mean16,
                  float log_cut, float alpha_max, float log_eps,
                  float* __restrict__ rgb, float* __restrict__ alpha,
                  float* __restrict__ final_log_t,
                  int* __restrict__ last_idx) {
  __shared__ PairStage<kFwdBatch> stage;
  const int tile = tile_order[blockIdx.x];
  const int start = tile_start[tile];
  composite_tile(
      fields, [=](int k) { return __ldg(sorted_gidx + start + k); },
      min(tile_count[tile], k_cap), tile % gx, tile / gx, width, height,
      log_cut, alpha_max, log_eps, stage,
      FrameOut{rgb, alpha, final_log_t, last_idx, width}, mean16);
}

// The tile-list entry (replaces composite_tiles_pallas(..., tile_ids=)):
// block b composites the tile at list position order[b] into that
// position's slot of the tile-major outputs. The empty sentinel id
// num_tiles composites nothing and lies below the frame, so its slot gets
// zeros (rgba, log-T) and -1 (last index).
__global__ void __launch_bounds__(kPix)
raster_fwd_tiles_kernel(const float* __restrict__ fields,
                        const int* __restrict__ sorted_gidx,
                        const int* __restrict__ tile_start,
                        const int* __restrict__ tile_count,
                        const int* __restrict__ tile_ids,
                        const int* __restrict__ list_order, int num_tiles,
                        int width, int height, int gx, int k_cap,
                        bool mean16, float log_cut, float alpha_max,
                        float log_eps, float4* __restrict__ rgba,
                        float* __restrict__ final_log_t,
                        int* __restrict__ last_idx) {
  __shared__ PairStage<kFwdBatch> stage;
  const int pos = list_order[blockIdx.x];
  const int tile = tile_ids[pos];
  const bool real = tile < num_tiles;
  const int start = real ? tile_start[tile] : 0;
  const size_t slot = static_cast<size_t>(pos) * kPix;
  composite_tile(
      fields, [=](int k) { return __ldg(sorted_gidx + start + k); },
      real ? min(tile_count[tile], k_cap) : 0, tile % gx, tile / gx, width,
      height, log_cut, alpha_max, log_eps, stage,
      SlotOut{rgba + slot, final_log_t + slot, last_idx + slot}, mean16);
}

}  // namespace

extern "C" {

// Launches kernel A on `stream` of `device` over gx * gy tiles: first the
// heavy-first schedule into `tile_order` (gx * gy ints of scratch), then
// the compositor, block b compositing tile tile_order[b]; `mean16` != 0
// quantizes each pair's tile-local mean (pack_mean16). Returns
// cudaGetLastError() (0 on success). Pointers are device pointers;
// `fields` must be 16-byte aligned with rows of 12 floats.
int raster_fwd(const float* fields, const int* sorted_gidx,
               const int* tile_start, const int* tile_count, int* tile_order,
               int width, int height, int gx, int gy, int k_cap,
               int mean16, float log_cut, float alpha_max, float log_eps,
               float* rgb, float* alpha, float* final_log_t, int* last_idx,
               int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int num_tiles = gx * gy;
  if (num_tiles > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    heavy_first_order<<<1, kOrderThreads, 0, st>>>(
        TileCount{tile_count}, num_tiles, k_cap, tile_order);
    raster_fwd_kernel<<<num_tiles, kPix, 0, st>>>(
        fields, sorted_gidx, tile_start, tile_count, tile_order, width,
        height, gx, k_cap, mean16 != 0, log_cut, alpha_max, log_eps, rgb,
        alpha, final_log_t, last_idx);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches kernel A's tile-list entry on `stream` of `device` over the
// `num_ids` entries of `tile_ids` (ids in [0, gx * gy], gx * gy the empty
// sentinel, no real id twice): first the heavy-first schedule of the list
// positions into `list_order` (num_ids ints of scratch), then the
// compositor, writing position i's tile into slot i of rgba [num_ids, 256,
// 4], final_log_t and last_idx [num_ids, 256] (pixels row-major in the
// tile); `mean16` as in raster_fwd. Returns cudaGetLastError() (0 on
// success). Pointers are device
// pointers; `fields` and `rgba` must be 16-byte aligned.
int raster_fwd_tiles(const float* fields, const int* sorted_gidx,
                     const int* tile_start, const int* tile_count,
                     const int* tile_ids, int* list_order, int num_ids,
                     int width, int height, int gx, int gy, int k_cap,
                     int mean16, float log_cut, float alpha_max,
                     float log_eps, float* rgba, float* final_log_t,
                     int* last_idx,
                     int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int num_tiles = gx * gy;
  if (num_ids > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    heavy_first_order<<<1, kOrderThreads, 0, st>>>(
        ListCount{tile_count, tile_ids, num_tiles}, num_ids, k_cap,
        list_order);
    raster_fwd_tiles_kernel<<<num_ids, kPix, 0, st>>>(
        fields, sorted_gidx, tile_start, tile_count, tile_ids, list_order,
        num_tiles, width, height, gx, k_cap, mean16 != 0, log_cut, alpha_max,
        log_eps, reinterpret_cast<float4*>(rgba), final_log_t, last_idx);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* raster_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
