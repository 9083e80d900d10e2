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
// Design: one CTA per tile, 256 threads, one thread per pixel; warp w covers
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

#include "footprint.cuh"
#include "tile_order.cuh"

namespace {

constexpr int kPix = kTile * kTile;  // threads per CTA, one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 64;           // pairs staged per step
// resident CTAs per SM the register budget is set for: 6 x 256 threads
// leave 40 registers a thread; unconstrained, B takes 55 and fits 4, and
// runs slower on an H100 (PERF.md, Findings)
constexpr int kBlocksPerSM = 6;
constexpr int kRow = 12;             // floats per splat row of `fields`
constexpr int kGrad = 9;             // floats per pair gradient row
constexpr unsigned kFull = 0xffffffffu;

// Sums p[0..8] over the warp in a fixed order: afterwards lanes 4j..4j+3
// hold the sum of p[j] (j < 8) in `part` and every lane holds the sum of
// p[8] in `last`.
__device__ __forceinline__ void warp_sum9(const float (&p)[kGrad], int lane,
                                          float& part, float& last) {
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
  float q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float give = hi16 ? p[j] : p[j + 4];
    q[j] = (hi16 ? p[j + 4] : p[j]) + __shfl_xor_sync(kFull, give, 16);
  }
  float r[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float give = hi8 ? q[j] : q[j + 2];
    r[j] = (hi8 ? q[j + 2] : q[j]) + __shfl_xor_sync(kFull, give, 8);
  }
  float t = (hi4 ? r[1] : r[0]) +
            __shfl_xor_sync(kFull, hi4 ? r[0] : r[1], 4);
  t += __shfl_xor_sync(kFull, t, 2);
  t += __shfl_xor_sync(kFull, t, 1);
  float e = p[8];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) e += __shfl_xor_sync(kFull, e, off);
  part = t;
  last = e;
}

__global__ void __launch_bounds__(kPix, kBlocksPerSM)
raster_bwd_kernel(const float* __restrict__ fields,
                  const int* __restrict__ sorted_gidx,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_count,
                  const int* __restrict__ tile_order,
                  const float* __restrict__ final_log_t,
                  const int* __restrict__ last_idx,
                  const float* __restrict__ d_rgb,
                  const float* __restrict__ d_alpha,
                  int width, int height, int gx, int k_cap,
                  float log_cut, float alpha_max,
                  float* __restrict__ dpairs) {
  __shared__ float4 s_v0123[kBatch];  // power rows v0..v3
  __shared__ float4 s_v45rg[kBatch];  // rows v4, v5 and colour r, g
  __shared__ float s_b[kBatch];       // colour b
  __shared__ unsigned char s_mask[kBatch];  // footprint block masks
  __shared__ float s_part[kWarps][kBatch][kGrad];
  __shared__ int s_wlast[kWarps];     // each warp's largest last_idx

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

  const float px = static_cast<float>(lx);
  const float py = static_cast<float>(ly);
  const float pxx = px * px, pyy = py * py, pxy = px * py;
  const float ox = static_cast<float>(tx * kTile);
  const float oy = static_cast<float>(ty * kTile);

  const int start = tile_start[tile];
  const int count = min(tile_count[tile], k_cap);

  float g_r = 0.f, g_g = 0.f, g_b = 0.f, g_a = 0.f;
  float log_t = 0.f;  // log-T after the pair being walked
  int last = -1;
  if (inside) {
    const int pix = y * width + x;
    g_r = d_rgb[3 * pix + 0];
    g_g = d_rgb[3 * pix + 1];
    g_b = d_rgb[3 * pix + 2];
    g_a = d_alpha[pix];
    log_t = final_log_t[pix];
    last = min(last_idx[pix], count - 1);
  }
  const int warp_last = __reduce_max_sync(kFull, last);
  if (lane == 0) s_wlast[warp] = warp_last;
  __syncthreads();
  int n_walk = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n_walk = max(n_walk, s_wlast[w] + 1);

  float suffix = 0.f;  // S: sum of r_j w_j over the pairs behind
  // the staged pair's own fields and mask, kept by the thread that staged it
  float mx = 0.f, my = 0.f, ca = 0.f, cb = 0.f, cc = 0.f, op = 0.f;
  unsigned mask = 0u;

  for (int b0 = ((n_walk - 1) / kBatch) * kBatch; n_walk > 0 && b0 >= 0;
       b0 -= kBatch) {
    __syncthreads();  // the previous batch's staging and partials are read
    const int n = min(kBatch, n_walk - b0);
    if (static_cast<int>(threadIdx.x) < n) {
      const int g = sorted_gidx[start + b0 + threadIdx.x];
      const float4* row =
          reinterpret_cast<const float4*>(fields + static_cast<size_t>(g) * kRow);
      const float4 f0 = row[0];  // mx, my, conic a, conic b
      const float4 f1 = row[1];  // conic c, r, g, b
      const float4 f2 = row[2];  // opacity, 0, 0, 0
      mx = __fsub_rn(f0.x, ox);
      my = __fsub_rn(f0.y, oy);
      ca = f0.z;
      cb = f0.w;
      cc = f1.x;
      op = f2.x;
      const float log_op = logf(fmaxf(op, 1e-30f));
      // the six rows exactly as kernel A forms them
      const float qa = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, ca), mx), mx);
      const float qb = __fmul_rn(__fmul_rn(cb, mx), my);
      const float qc = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, cc), my), my);
      const float v0 = __fsub_rn(log_op, __fadd_rn(__fadd_rn(qa, qb), qc));
      const float v1 = __fadd_rn(__fmul_rn(ca, mx), __fmul_rn(cb, my));
      const float v2 = __fadd_rn(__fmul_rn(cc, my), __fmul_rn(cb, mx));
      s_v0123[threadIdx.x] = make_float4(v0, v1, v2, __fmul_rn(-0.5f, ca));
      s_v45rg[threadIdx.x] = make_float4(__fmul_rn(-0.5f, cc), -cb, f1.y, f1.z);
      s_b[threadIdx.x] = f1.w;
      mask = footprint_blocks(mx, my, ca, cb, cc, log_op, log_cut);
      s_mask[threadIdx.x] = static_cast<unsigned char>(mask);
    }
    __syncthreads();

    // back to front, 32 pairs per ballot; the branch is warp-uniform
    for (int c0 = ((n - 1) / 32) * 32; c0 >= 0; c0 -= 32) {
      const int mine = c0 + lane;
      unsigned bits = __ballot_sync(
          kFull, mine < n && ((s_mask[mine] >> warp) & 1u) &&
                     b0 + mine <= warp_last);
      while (bits) {
        const int top = 31 - __clz(bits);
        bits &= ~(1u << top);
        const int i = c0 + top;
        float p[kGrad];
#pragma unroll
        for (int j = 0; j < kGrad; ++j) p[j] = 0.f;
        if (b0 + i <= last) {
          const float4 va = s_v0123[i];
          const float4 vb = s_v45rg[i];
          float power = __fadd_rn(va.x, __fmul_rn(va.y, px));
          power = __fadd_rn(power, __fmul_rn(va.z, py));
          power = __fadd_rn(power, __fmul_rn(va.w, pxx));
          power = __fadd_rn(power, __fmul_rn(vb.x, pyy));
          power = __fadd_rn(power, __fmul_rn(vb.y, pxy));
          if (power >= log_cut) {
            const float a_raw = expf(power);
            const float a = fminf(a_raw, alpha_max);
            log_t = log_t - log1pf(-a);  // log-T before this pair
            const float t = expf(log_t);
            const float w = a * t;
            const float r = g_r * vb.z + g_g * vb.w + g_b * s_b[i] + g_a;
            const float dalpha = t * r - suffix / (1.f - a);
            suffix += r * w;
            const float dpow = a_raw > alpha_max ? 0.f : dalpha * a_raw;
            p[0] = dpow;
            p[1] = dpow * px;
            p[2] = dpow * py;
            p[3] = dpow * pxx;
            p[4] = dpow * pyy;
            p[5] = dpow * pxy;
            p[6] = w * g_r;
            p[7] = w * g_g;
            p[8] = w * g_b;
          }
        }
        float part, part8;
        warp_sum9(p, lane, part, part8);
        if ((lane & 3) == 0) s_part[warp][i][lane >> 2] = part;
        else if (lane == 1) s_part[warp][i][8] = part8;
      }
    }
    __syncthreads();

    if (static_cast<int>(threadIdx.x) < n) {
      const int i = threadIdx.x;
      float m[kGrad];
#pragma unroll
      for (int j = 0; j < kGrad; ++j) m[j] = 0.f;
      // the warps that visited this pair, in warp order
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        if (((mask >> w) & 1u) && b0 + i <= s_wlast[w]) {
#pragma unroll
          for (int j = 0; j < kGrad; ++j) m[j] += s_part[w][i][j];
        }
      }
      const float m0 = m[0], m1x = m[1], m1y = m[2];
      const float m2xx = m[3], m2yy = m[4], m2xy = m[5];
      const float c1x = m1x - mx * m0;
      const float c1y = m1y - my * m0;
      float* out = dpairs + static_cast<size_t>(start + b0 + i) * kGrad;
      out[0] = ca * c1x + cb * c1y;
      out[1] = cc * c1y + cb * c1x;
      out[2] = -0.5f * (m2xx - 2.f * mx * m1x + mx * mx * m0);
      out[3] = -(m2xy - mx * m1y - my * m1x + mx * my * m0);
      out[4] = -0.5f * (m2yy - 2.f * my * m1y + my * my * m0);
      out[5] = m[6];
      out[6] = m[7];
      out[7] = m[8];
      out[8] = m0 / fmaxf(op, 1e-30f);
    }
  }
}

}  // namespace

extern "C" {

// Launches kernel B on `stream` of `device` over gx * gy tiles: first the
// heavy-first schedule into `tile_order` (gx * gy ints of scratch), then
// the backward, block b walking tile tile_order[b]. Returns
// cudaGetLastError() (0 on success). Pointers are device pointers; `fields`
// must be 16-byte aligned with rows of 12 floats; `dpairs` [M, 9] must be
// zeroed (rows of pairs past every pixel's walk and past k_cap are not
// written).
int raster_bwd(const float* fields, const int* sorted_gidx,
               const int* tile_start, const int* tile_count, int* tile_order,
               const float* final_log_t, const int* last_idx,
               const float* d_rgb, const float* d_alpha,
               int width, int height, int gx, int gy, int k_cap,
               float log_cut, float alpha_max, float* dpairs,
               int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int num_tiles = gx * gy;
  if (num_tiles > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    heavy_first_order<<<1, kOrderThreads, 0, st>>>(tile_count, num_tiles,
                                                   k_cap, tile_order);
    raster_bwd_kernel<<<num_tiles, kPix, 0, st>>>(
        fields, sorted_gidx, tile_start, tile_count, tile_order, final_log_t,
        last_idx, d_rgb, d_alpha, width, height, gx, k_cap, log_cut,
        alpha_max, dpairs);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* raster_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
