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
// lane masking and the packed-payload decode.
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
// Design: one CTA per tile, 256 threads, one thread per pixel; warp w covers
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

#include "footprint.cuh"
#include "tile_order.cuh"

namespace {

constexpr int kPix = kTile * kTile;  // threads per CTA, one per pixel
constexpr int kBatch = kPix;         // pairs staged per step, one per thread
constexpr int kRow = 12;             // floats per splat row of `fields`
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kPix)
raster_fwd_kernel(const float* __restrict__ fields,
                  const int* __restrict__ sorted_gidx,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_count,
                  const int* __restrict__ tile_order,
                  int width, int height, int gx, int k_cap,
                  float log_cut, float alpha_max, float log_eps,
                  float* __restrict__ rgb, float* __restrict__ alpha,
                  float* __restrict__ final_log_t,
                  int* __restrict__ last_idx) {
  __shared__ float4 s_v0123[kBatch];  // power rows v0..v3
  __shared__ float4 s_v45rg[kBatch];  // rows v4, v5 and colour r, g
  __shared__ float s_b[kBatch];       // colour b
  __shared__ unsigned char s_mask[kBatch];  // footprint block masks

  const int tile = tile_order[blockIdx.x];
  const int tx = tile % gx;
  const int ty = tile / gx;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int lx = block_x0(warp) + lane % kBlockW;
  const int ly = block_y0(warp) + lane / kBlockW;
  const int x = tx * kTile + lx;
  const int y = ty * kTile + ly;
  const bool inside = x < width && y < height;

  // tile-local pixel coordinates and their products: small integers, exact
  const float px = static_cast<float>(lx);
  const float py = static_cast<float>(ly);
  const float pxx = px * px, pyy = py * py, pxy = px * py;
  const float ox = static_cast<float>(tx * kTile);
  const float oy = static_cast<float>(ty * kTile);

  const int start = tile_start[tile];
  const int count = min(tile_count[tile], k_cap);

  float log_t = 0.f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_a = 0.f;
  int last = -1;
  bool done = !inside;

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    // also the barrier that lets this batch overwrite the previous one
    if (__syncthreads_count(done) == kPix) break;
    const int j = b0 + static_cast<int>(threadIdx.x);
    if (j < count) {
      const int g = sorted_gidx[start + j];
      const float4* row =
          reinterpret_cast<const float4*>(fields + static_cast<size_t>(g) * kRow);
      const float4 f0 = row[0];  // mx, my, conic a, conic b
      const float4 f1 = row[1];  // conic c, r, g, b
      const float4 f2 = row[2];  // opacity, 0, 0, 0
      const float mx = __fsub_rn(f0.x, ox);
      const float my = __fsub_rn(f0.y, oy);
      const float ca = f0.z, cb = f0.w, cc = f1.x;
      const float log_op = logf(fmaxf(f2.x, 1e-30f));
      // v0 = log(op) - ((0.5 ca mx mx + cb mx my) + 0.5 cc my my)
      const float qa = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, ca), mx), mx);
      const float qb = __fmul_rn(__fmul_rn(cb, mx), my);
      const float qc = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, cc), my), my);
      const float v0 = __fsub_rn(log_op, __fadd_rn(__fadd_rn(qa, qb), qc));
      const float v1 = __fadd_rn(__fmul_rn(ca, mx), __fmul_rn(cb, my));
      const float v2 = __fadd_rn(__fmul_rn(cc, my), __fmul_rn(cb, mx));
      s_v0123[threadIdx.x] = make_float4(v0, v1, v2, __fmul_rn(-0.5f, ca));
      s_v45rg[threadIdx.x] = make_float4(__fmul_rn(-0.5f, cc), -cb, f1.y, f1.z);
      s_b[threadIdx.x] = f1.w;
      s_mask[threadIdx.x] = static_cast<unsigned char>(
          footprint_blocks(mx, my, ca, cb, cc, log_op, log_cut));
    }
    __syncthreads();

    const int n = min(kBatch, count - b0);
    // warp-uniform: the warp walks while any of its pixels is not done
    for (int c0 = 0; c0 < n && !__all_sync(kFull, done); c0 += 32) {
      const int mine = c0 + lane;
      unsigned bits = __ballot_sync(
          kFull, mine < n && ((s_mask[mine] >> warp) & 1u));
      while (bits) {
        const int i = c0 + __ffs(bits) - 1;
        bits &= bits - 1;
        if (done) continue;
        const float4 va = s_v0123[i];
        const float4 vb = s_v45rg[i];
        float power = __fadd_rn(va.x, __fmul_rn(va.y, px));
        power = __fadd_rn(power, __fmul_rn(va.z, py));
        power = __fadd_rn(power, __fmul_rn(va.w, pxx));
        power = __fadd_rn(power, __fmul_rn(vb.x, pyy));
        power = __fadd_rn(power, __fmul_rn(vb.y, pxy));
        // alpha = 0 (also for a NaN power, as in the twin): log-T unchanged
        if (!(power >= log_cut)) continue;
        const float a = fminf(expf(power), alpha_max);
        const float log1m = log1pf(-a);
        const float log_t_incl = __fadd_rn(log_t, log1m);
        if (log_t_incl < log_eps) {
          done = true;
          continue;
        }
        const float w = __fmul_rn(a, expf(log_t));
        acc_r = __fadd_rn(acc_r, __fmul_rn(w, vb.z));
        acc_g = __fadd_rn(acc_g, __fmul_rn(w, vb.w));
        acc_b = __fadd_rn(acc_b, __fmul_rn(w, s_b[i]));
        acc_a = __fadd_rn(acc_a, w);
        log_t = log_t_incl;
        last = b0 + i;
      }
    }
  }

  if (inside) {
    const int pix = y * width + x;
    rgb[3 * pix + 0] = acc_r;
    rgb[3 * pix + 1] = acc_g;
    rgb[3 * pix + 2] = acc_b;
    alpha[pix] = acc_a;
    final_log_t[pix] = log_t;
    last_idx[pix] = last;
  }
}

}  // namespace

extern "C" {

// Launches kernel A on `stream` of `device` over gx * gy tiles: first the
// heavy-first schedule into `tile_order` (gx * gy ints of scratch), then
// the compositor, block b compositing tile tile_order[b]. Returns
// cudaGetLastError() (0 on success). Pointers are device pointers;
// `fields` must be 16-byte aligned with rows of 12 floats.
int raster_fwd(const float* fields, const int* sorted_gidx,
               const int* tile_start, const int* tile_count, int* tile_order,
               int width, int height, int gx, int gy, int k_cap,
               float log_cut, float alpha_max, float log_eps,
               float* rgb, float* alpha, float* final_log_t, int* last_idx,
               int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int num_tiles = gx * gy;
  if (num_tiles > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    heavy_first_order<<<1, kOrderThreads, 0, st>>>(tile_count, num_tiles,
                                                   k_cap, tile_order);
    raster_fwd_kernel<<<num_tiles, kPix, 0, st>>>(
        fields, sorted_gidx, tile_start, tile_count, tile_order, width,
        height, gx, k_cap, log_cut, alpha_max, log_eps, rgb, alpha,
        final_log_t, last_idx);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* raster_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
