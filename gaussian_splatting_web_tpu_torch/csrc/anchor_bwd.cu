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
// Design: kernel B's, over the ordered list. One CTA per tile, 256 threads,
// one thread per pixel; batches of kBatch pairs staged in shared memory,
// each pair's field row gathered through its entry's gaussian id; per pair
// the 9 contributions are summed over the 256 pixels deterministically (a
// warp-shuffle tree, skipped when no lane of the warp hit the pair, then a
// fixed-order sum of the 8 warps' partials by the thread that staged the
// pair), and that thread stores the pair's row with plain stores at
// (group, sorted position) of a zeroed [4, M, 9] array. Each entry meets
// each group at most once: no atomics, and two runs give the same bits.
//
// Bounds on the card: kernel B's. Per (pair, pixel) step about twice A's
// FP32 work plus exp, log1p and exp, and the 9-value tree per pair and
// warp; device memory sees the ordered lists, one field row per pair and
// 36 bytes written per pair. FP32/SFU issue and load imbalance between
// tiles bound it, not bytes.
//
// Numerics: power is recomputed with __fmul_rn / __fadd_rn in C's (and
// A's) order, so the cutoff and clamp decisions are C's. Build without
// -use_fast_math. Pixels past W or H take part in the reductions with
// zeros.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per CTA, one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 64;           // pairs staged per step
constexpr int kRow = 12;             // floats per splat row of `fields`
constexpr int kGrad = 9;             // floats per pair gradient row

__global__ void __launch_bounds__(kPix)
anchor_bwd_kernel(const float* __restrict__ fields,
                  const int* __restrict__ sorted_gidx,
                  const int* __restrict__ ordered,
                  const int* __restrict__ k_used,
                  const int8_t* __restrict__ group,
                  const float* __restrict__ final_log_t,
                  const int* __restrict__ last_idx,
                  const float* __restrict__ d_rgb,
                  const float* __restrict__ d_alpha,
                  int width, int height, int gx, int k_cap, int num_entries,
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

  const int* list = ordered + static_cast<size_t>(tile) * k_cap;
  const int8_t* groups = group + static_cast<size_t>(tile) * k_cap;
  const int count = k_used[tile];

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
  // the staged pair's own fields and destination, kept by the thread that
  // staged it
  float mx = 0.f, my = 0.f, ca = 0.f, cb = 0.f, cc = 0.f, op = 0.f;
  size_t dst = 0;

  for (int b0 = ((n_walk - 1) / kBatch) * kBatch; n_walk > 0 && b0 >= 0;
       b0 -= kBatch) {
    __syncthreads();  // the previous batch's staging and partials are read
    const int n = min(kBatch, n_walk - b0);
    if (static_cast<int>(threadIdx.x) < n) {
      const int pos = list[b0 + threadIdx.x];
      dst = (static_cast<size_t>(groups[b0 + threadIdx.x]) * num_entries + pos)
            * kGrad;
      const int g = sorted_gidx[pos];
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
      // the six rows exactly as kernel C forms them
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
      float* out = dpairs + dst;
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

// Launches kernel D on `stream` of `device` over gx * gy tiles and returns
// the launch's cudaGetLastError() (0 on success). Pointers are device
// pointers; `fields` must be 16-byte aligned with rows of 12 floats;
// `dpairs` [4, num_entries, 9] must be zeroed (only the rows of pairs some
// pixel reached are written).
int anchor_bwd(const float* fields, const int* sorted_gidx,
               const int* ordered, const int* k_used, const int8_t* group,
               const float* final_log_t, const int* last_idx,
               const float* d_rgb, const float* d_alpha,
               int width, int height, int gx, int gy, int k_cap,
               int num_entries, float log_cut, float alpha_max,
               float* dpairs, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int num_tiles = gx * gy;
  if (num_tiles > 0) {
    anchor_bwd_kernel<<<num_tiles, kPix, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        fields, sorted_gidx, ordered, k_used, group, final_log_t, last_idx,
        d_rgb, d_alpha, width, height, gx, k_cap, num_entries, log_cut,
        alpha_max, dpairs);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* anchor_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
