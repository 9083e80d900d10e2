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
// Design: one CTA per tile, 256 threads, one thread per pixel. The walk
// starts at the block's largest last_idx and goes back to front in batches
// of kBatch pairs; each batch is staged in shared memory (one pair per
// thread, the six rows of the bilinear form computed once, exactly as A
// computes them). For each pair every thread forms its 9 contributions;
// they are summed over the 256 pixels deterministically: a warp-shuffle
// tree in each warp (skipped when no lane of the warp hit the pair), then
// a fixed-order sum of the 8 warps' partials from shared memory by the
// thread that staged the pair, which turns the moments into the 9
// gradients and writes the pair's row. A pair belongs to exactly one tile,
// so every row is written once, with plain stores, into an array the
// wrapper zeroed: no atomics, and two runs give the same bits.
//
// Bounds on the card: per (pair, pixel) step the work is about twice A's
// FP32 work (the same power evaluation, then T, r, d alpha, d power and
// nine moment products) plus exp, log1p and exp on the special-function
// units, and the 9-value tree reduction per pair and warp; device memory
// sees 36 bytes written per pair and the 48-byte field row read once per
// pair, so the kernel is bound by FP32/SFU issue and by load imbalance
// between tiles, not by bytes. The design keeps each pixel's state in
// registers, skips pairs past a pixel's own last_idx, and skips a warp's
// reduction when the pair touched none of its pixels (most pairs cover a
// part of the tile only).
//
// Numerics: power is recomputed with __fmul_rn / __fadd_rn in A's order,
// so the 1/255 cutoff and 0.99 clamp decisions are A's. Build without
// -use_fast_math. Pixels past W or H take part in the reductions with
// zeros.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per CTA, one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 64;           // pairs staged per step
constexpr int kRow = 12;             // floats per splat row of `fields`
constexpr int kGrad = 9;             // floats per pair gradient row

__global__ void __launch_bounds__(kPix)
raster_bwd_kernel(const float* __restrict__ fields,
                  const int* __restrict__ sorted_gidx,
                  const int* __restrict__ tile_start,
                  const int* __restrict__ tile_count,
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
  __shared__ float s_part[kWarps][kBatch][kGrad];
  __shared__ int s_walk;

  const int tile = blockIdx.x;
  const int tx = tile % gx;
  const int ty = tile / gx;
  const int lx = threadIdx.x % kTile;
  const int ly = threadIdx.x / kTile;
  const int x = tx * kTile + lx;
  const int y = ty * kTile + ly;
  const bool inside = x < width && y < height;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

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
    last = last_idx[pix];
  }
  if (threadIdx.x == 0) s_walk = 0;
  __syncthreads();
  if (last >= 0) atomicMax(&s_walk, min(last + 1, count));
  __syncthreads();
  const int n_walk = s_walk;

  float suffix = 0.f;  // S: sum of r_j w_j over the pairs behind
  // the staged pair's own fields, kept by the thread that staged it
  float mx = 0.f, my = 0.f, ca = 0.f, cb = 0.f, cc = 0.f, op = 0.f;

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
      // the six rows exactly as kernel A forms them
      const float qa = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, ca), mx), mx);
      const float qb = __fmul_rn(__fmul_rn(cb, mx), my);
      const float qc = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, cc), my), my);
      const float v0 = __fsub_rn(logf(fmaxf(op, 1e-30f)),
                                 __fadd_rn(__fadd_rn(qa, qb), qc));
      const float v1 = __fadd_rn(__fmul_rn(ca, mx), __fmul_rn(cb, my));
      const float v2 = __fadd_rn(__fmul_rn(cc, my), __fmul_rn(cb, mx));
      s_v0123[threadIdx.x] = make_float4(v0, v1, v2, __fmul_rn(-0.5f, ca));
      s_v45rg[threadIdx.x] = make_float4(__fmul_rn(-0.5f, cc), -cb, f1.y, f1.z);
      s_b[threadIdx.x] = f1.w;
    }
    __syncthreads();

    for (int i = n - 1; i >= 0; --i) {
      float p[kGrad];
#pragma unroll
      for (int j = 0; j < kGrad; ++j) p[j] = 0.f;
      bool hit = false;
      if (b0 + i <= last) {
        const float4 va = s_v0123[i];
        const float4 vb = s_v45rg[i];
        float power = __fadd_rn(va.x, __fmul_rn(va.y, px));
        power = __fadd_rn(power, __fmul_rn(va.z, py));
        power = __fadd_rn(power, __fmul_rn(va.w, pxx));
        power = __fadd_rn(power, __fmul_rn(vb.x, pyy));
        power = __fadd_rn(power, __fmul_rn(vb.y, pxy));
        if (power >= log_cut) {
          hit = true;
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
      if (__any_sync(0xffffffffu, hit)) {
#pragma unroll
        for (int j = 0; j < kGrad; ++j) {
          float v = p[j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, off);
          if (lane == 0) s_part[warp][i][j] = v;
        }
      } else if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kGrad; ++j) s_part[warp][i][j] = 0.f;
      }
    }
    __syncthreads();

    if (static_cast<int>(threadIdx.x) < n) {
      const int i = threadIdx.x;
      float m[kGrad];
#pragma unroll
      for (int j = 0; j < kGrad; ++j) {
        float v = 0.f;
#pragma unroll
        for (int wp = 0; wp < kWarps; ++wp) v += s_part[wp][i][j];
        m[j] = v;
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

// Launches kernel B on `stream` of `device` over gx * gy tiles and returns
// the launch's cudaGetLastError() (0 on success). Pointers are device
// pointers; `fields` must be 16-byte aligned with rows of 12 floats;
// `dpairs` [M, 9] must be zeroed (only rows of pairs some pixel reached are
// written).
int raster_bwd(const float* fields, const int* sorted_gidx,
               const int* tile_start, const int* tile_count,
               const float* final_log_t, const int* last_idx,
               const float* d_rgb, const float* d_alpha,
               int width, int height, int gx, int gy, int k_cap,
               float log_cut, float alpha_max, float* dpairs,
               int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int num_tiles = gx * gy;
  if (num_tiles > 0) {
    raster_bwd_kernel<<<num_tiles, kPix, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        fields, sorted_gidx, tile_start, tile_count, final_log_t, last_idx,
        d_rgb, d_alpha, width, height, gx, k_cap, log_cut, alpha_max,
        dpairs);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* raster_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
