// Kernel B: backward of the tile compositor (kernel A) for Hopper (sm_90a).
//
// Replaces the TPU kernel gaussian_splatting_web_tpu/ops/pallas/raster_bwd.py::
// _bwd_kernel (launched by backward_pair_grads) and computes what it
// computes in exact mode: per 16x16 pixel tile, walking the segment back to
// front, the gradient of the loss with respect to every pair's compositor
// fields, one row of 9 floats per pair in sorted pair order:
//   d mean2d (x, y), d conic (a, b, c), d rgb (r, g, b), d opacity.
// With T_k the transmittance before pair k, w_k = alpha_k T_k its weight,
// r_k = g_rgb . c_k + g_alpha and the suffix S_k = sum_{j>k} r_j w_j:
//   d c_k = w_k g_rgb,   d alpha_k = T_k r_k - S_k / (1 - alpha_k)
// on the pairs that contributed; zero through the alpha_max clamp;
// d power = d alpha . exp(power). The geometry gradients come from the
// pixel moments of d power in tile-local coordinates (sum dpow, dpow px,
// dpow py, dpow px^2, dpow py^2, dpow px py), d op = sum dpow / op. The
// fold onto splats (ops/rasterize.py::fold_pair_grads) runs after it.
// The TPU-only parts are left out: the bf16x3 matmul splits, triangular
// matmul prefix and suffix sums, 128-lane slab DMA, R-tile row groups and
// the boundary-block read-merge-write.
//
// Residual: A's per-pixel final log-T and segment-local last contributing
// index replace the TPU kernel's fin (final carry + chunk count). A pixel
// walks pairs k <= last_idx back to front and rebuilds its log-T by
// subtracting log1p(-alpha) of each pair that contributed; a pair k <=
// last_idx contributed exactly when its power passes the cutoff.
//
// What bounds it on this card: one thread per pixel, so each pair's nine
// sums need a reduction over the tile's 256 pixels. The first port paid it
// block-wide for every pair: every warp evaluated power at its 32 pixels,
// ran nine five-step shuffle trees when any lane was hit (45 shuffles) or
// wrote nine zeros, and then 8 x 9 partials were summed in shared memory;
// a pair passes the cutoff at ~16 pixels, so ~6 of the 8 warps did that
// for nothing, and every warp walked to the block's largest last_idx. Device
// memory sees the 48-byte field row read and the 36-byte row written once
// per pair, so the kernel is bound by issue slots and by load imbalance
// between tiles, not by bytes.
//
// Design (the walk is tile_walk.cuh::backward_tile, which kernel D runs
// too): one CTA per tile, 256 threads, one thread per pixel; warp w covers
// the 8x4 pixel block at column 8 (w & 1), row 4 (w >> 1), as in kernel A.
// Tiles run heavy first, in the order the launch writes first
// (tile_order.cuh): block b takes tile tile_order[b]. Each warp walks
// back to front from its own largest last_idx, in batches of kBatch pairs
// staged in shared memory by the whole CTA (the six form rows exactly as A
// forms them, and A's footprint mask, footprint.cuh). A warp visits only
// the pairs whose footprint bit it holds, found 32 at a time with one
// ballot, so the branch is warp-uniform; a warp whose bit is clear neither
// evaluates nor reduces the pair and counts as a fixed zero. Where a warp
// visits a pair, its nine lane values are summed by a transposing butterfly:
// at each of five xor steps a lane keeps half of its values and trades the
// other half with its partner, so 8 + 1 values take 4 + 2 + 1 + 1 + 1 and
// 5 shuffles (14 in all, not 45) and lanes 4j..4j+3 end with value j. One
// store puts the warp's nine sums in shared memory. After the batch, the
// thread that staged a pair adds the partials of the warps that visited it
// in warp order 0..7, forms the pair's row and stores it: one plain store
// per row, into an array the wrapper zeroed (rows of pairs past every
// pixel's walk keep their zeros). No floating-point atomics; the order of
// every sum is fixed, so two runs give the same bits.
//
// Numerics: power is recomputed with __fmul_rn / __fadd_rn in A's order,
// so the 1/255 cutoff and 0.99 clamp decisions are A's, and the footprint
// cull skips only pixels whose power is below the cutoff. Build without
// -use_fast_math. Pixels past W or H take part with zeros.

#include <cuda_runtime.h>

#include "tile_order.cuh"
#include "tile_walk.cuh"

namespace {

__global__ void __launch_bounds__(kPix, kBwdBlocksPerSM)
raster_bwd_kernel(const float* __restrict__ fields,
                  const int* __restrict__ sorted_gidx,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_count,
                  const int* __restrict__ tile_order,
                  const float* __restrict__ final_log_t,
                  const int* __restrict__ last_idx,
                  const float* __restrict__ d_rgb,
                  const float* __restrict__ d_alpha,
                  int width, int height, int gx, int k_cap, bool mean16,
                  float log_cut, float alpha_max,
                  float* __restrict__ dpairs) {
  __shared__ BwdStage stage;
  const int tile = tile_order[blockIdx.x];
  const int start = tile_start[tile];
  backward_tile(
      fields, [=](int k) { return __ldg(sorted_gidx + start + k); },
      [=](int k) { return dpairs + static_cast<size_t>(start + k) * kGrad; },
      min(tile_count[tile], k_cap), tile % gx, tile / gx, width, height,
      FrameIn{d_rgb, d_alpha, final_log_t, last_idx, width}, log_cut,
      alpha_max, stage, mean16);
}

// The tile-list entry (replaces backward_pair_grads(..., tile_ids=)):
// block b walks the tile at list position order[b], reading the cotangent
// and the residual from that position's slot of tile-major arrays, and
// stores the rows of that tile's pairs; rows of unlisted tiles keep their
// zeros. The empty sentinel id num_tiles has no pairs and does nothing.
__global__ void __launch_bounds__(kPix, kBwdBlocksPerSM)
raster_bwd_tiles_kernel(const float* __restrict__ fields,
                        const int* __restrict__ sorted_gidx,
                        const int* __restrict__ tile_start,
                        const int* __restrict__ tile_count,
                        const int* __restrict__ tile_ids,
                        const int* __restrict__ list_order,
                        const float* __restrict__ final_log_t,
                        const int* __restrict__ last_idx,
                        const float* __restrict__ d_rgba, int num_tiles,
                        int width, int height, int gx, int k_cap,
                        bool mean16, float log_cut, float alpha_max,
                        float* __restrict__ dpairs) {
  __shared__ BwdStage stage;
  const int pos = list_order[blockIdx.x];
  const int tile = tile_ids[pos];
  const bool real = tile < num_tiles;
  const int start = real ? tile_start[tile] : 0;
  const size_t slot = static_cast<size_t>(pos) * kPix;
  backward_tile(
      fields, [=](int k) { return __ldg(sorted_gidx + start + k); },
      [=](int k) { return dpairs + static_cast<size_t>(start + k) * kGrad; },
      real ? min(tile_count[tile], k_cap) : 0, tile % gx, tile / gx, width,
      height, SlotIn{d_rgba + 4 * slot, final_log_t + slot, last_idx + slot},
      log_cut, alpha_max, stage, mean16);
}

}  // namespace

extern "C" {

// Launches kernel B on `stream` of `device` over gx * gy tiles: first the
// heavy-first schedule into `tile_order` (gx * gy ints of scratch), then
// the backward, block b walking tile tile_order[b]; `mean16` != 0
// quantizes each pair's tile-local mean as kernel A does. Returns
// cudaGetLastError() (0 on success). Pointers are device pointers; `fields`
// must be 16-byte aligned with rows of 12 floats; `dpairs` [M, 9] must be
// zeroed (rows of pairs past every pixel's walk and past k_cap are not
// written).
int raster_bwd(const float* fields, const int* sorted_gidx,
               const int* tile_start, const int* tile_count, int* tile_order,
               const float* final_log_t, const int* last_idx,
               const float* d_rgb, const float* d_alpha,
               int width, int height, int gx, int gy, int k_cap,
               int mean16, float log_cut, float alpha_max, float* dpairs,
               int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int num_tiles = gx * gy;
  if (num_tiles > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    heavy_first_order<<<1, kOrderThreads, 0, st>>>(
        TileCount{tile_count}, num_tiles, k_cap, tile_order);
    raster_bwd_kernel<<<num_tiles, kPix, 0, st>>>(
        fields, sorted_gidx, tile_start, tile_count, tile_order, final_log_t,
        last_idx, d_rgb, d_alpha, width, height, gx, k_cap, mean16 != 0,
        log_cut, alpha_max, dpairs);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches kernel B's tile-list entry on `stream` of `device` over the
// `num_ids` entries of `tile_ids` (ids in [0, gx * gy], gx * gy the empty
// sentinel, no real id twice, or two blocks would store the same rows):
// first the heavy-first schedule of the list positions into `list_order`
// (num_ids ints of scratch), then the backward, reading position i's
// cotangent from slot i of d_rgba [num_ids, 256, 4] and its residual from
// final_log_t and last_idx [num_ids, 256]; `mean16` as in raster_bwd.
// Returns cudaGetLastError() (0 on success). Pointers are device pointers; `fields` must be 16-byte aligned;
// `dpairs` [M, 9] must be zeroed (rows of unlisted tiles, of pairs past
// every pixel's walk and past k_cap are not written).
int raster_bwd_tiles(const float* fields, const int* sorted_gidx,
                     const int* tile_start, const int* tile_count,
                     const int* tile_ids, int* list_order,
                     const float* final_log_t, const int* last_idx,
                     const float* d_rgba, int num_ids, int width, int height,
                     int gx, int gy, int k_cap, int mean16, float log_cut,
                     float alpha_max, float* dpairs, int device,
                     void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int num_tiles = gx * gy;
  if (num_ids > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    heavy_first_order<<<1, kOrderThreads, 0, st>>>(
        ListCount{tile_count, tile_ids, num_tiles}, num_ids, k_cap,
        list_order);
    raster_bwd_tiles_kernel<<<num_ids, kPix, 0, st>>>(
        fields, sorted_gidx, tile_start, tile_count, tile_ids, list_order,
        final_log_t, last_idx, d_rgba, num_tiles, width, height, gx, k_cap,
        mean16 != 0, log_cut, alpha_max, dpairs);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* raster_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
