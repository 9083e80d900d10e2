// The per-tile walks shared by the compositor kernels: kernel A's front-to-
// back composite (composite_tile, also kernel C's) and kernel B's back-to-
// front backward (backward_tile, also kernel D's). A kernel finds its tile
// and the tile's pair count, then calls a walk with functors that say where
// the tile's k-th pair lives:
//   gidx_of(k)  the gaussian id of the k-th pair (its row of `fields`):
//               A and B read sorted_gidx[start + k], C and D go through the
//               tile's ordered list;
//   row_of(k)   (backward only) the 9-float row the k-th pair's gradient is
//               stored to: B's row start + k, D's row (group, position).
// and a pixel functor that says where the tile's pixels keep their values:
// FrameOut / FrameIn, the frame's row-major images (A-D over the whole
// frame), or SlotOut / SlotIn, one slot of tile-major arrays (A's and B's
// tile-list entries, the slot of the tile's list position).
// The design of the walks (8x4 warp blocks, the footprint mask at staging,
// the ballot walk, the butterfly reduction) is described in raster_fwd.cu
// and raster_bwd.cu.
//
// Numerics: the six rows of the bilinear form and power are summed with
// __fmul_rn / __fadd_rn in the plain twin's order (ops/rasterize.py), so the
// cutoff, clamp and early-exit decisions are the twin's bit for bit, and
// the footprint cull (footprint.cuh) skips only pixels whose power, so
// rounded, is below the cutoff. Build without -use_fast_math. Pixels past
// W or H take no part in the forward and take part in the backward's sums
// with zeros.

#pragma once

#include <cuda_runtime.h>

#include "footprint.cuh"

constexpr int kPix = kTile * kTile;  // threads per CTA, one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kRow = 12;             // floats per splat row of `fields`
constexpr int kGrad = 9;             // floats per pair gradient row
constexpr int kFwdBatch = 256;       // forward: pairs staged per step
static_assert(kFwdBatch == kPix, "the forward stages one pair per thread");
constexpr int kBwdBatch = 64;        // backward: pairs staged per step
// resident CTAs per SM the backward's register budget is set for: 6 x 256
// threads leave 40 registers a thread (B and D then spill 40 bytes);
// unconstrained, B takes 55 and fits 4, and runs slower on an H100
// (PERF.md, Findings)
constexpr int kBwdBlocksPerSM = 6;
constexpr unsigned kFull = 0xffffffffu;

// A batch of pairs staged in shared memory: the six form rows, the colour
// and the footprint block mask of each.
template <int kN>
struct PairStage {
  float4 v0123[kN];        // power rows v0..v3
  float4 v45rg[kN];        // rows v4, v5 and colour r, g
  float b[kN];             // colour b
  unsigned char mask[kN];  // footprint block masks
};

struct BwdStage {
  PairStage<kBwdBatch> pair;
  float part[kWarps][kBwdBatch][kGrad];  // each warp's nine sums per pair
  int wlast[kWarps];                     // each warp's largest last_idx
};

// The per-splat values a staged pair needs in tile-local coordinates (the
// backward keeps them to form the pair's row).
struct PairForm {
  float mx, my, ca, cb, cc, op;
  unsigned mask;
};

// Forward outputs in the frame's row-major images, pixel (x, y) at
// y * width + x: rgb [H, W, 3], alpha, final_log_t [H, W], last_idx [H, W];
// pixels past W or H are not written.
struct FrameOut {
  float* rgb;
  float* alpha;
  float* final_log_t;
  int* last_idx;
  int width;
  __device__ __forceinline__ void operator()(bool inside, int x, int y, int,
                                             int, float r, float g, float b,
                                             float a, float log_t,
                                             int last) const {
    if (!inside) return;
    const int pix = y * width + x;
    rgb[3 * pix + 0] = r;
    rgb[3 * pix + 1] = g;
    rgb[3 * pix + 2] = b;
    alpha[pix] = a;
    final_log_t[pix] = log_t;
    last_idx[pix] = last;
  }
};

// Forward outputs in one tile's slot of tile-major arrays, pixel (lx, ly) at
// ly * kTile + lx: rgba [kPix] (float4), final_log_t, last_idx [kPix]. Every
// pixel is written; one past W or H takes no part and gets rgba 0, log-T 0
// and last index -1.
struct SlotOut {
  float4* rgba;
  float* final_log_t;
  int* last_idx;
  __device__ __forceinline__ void operator()(bool, int, int, int lx, int ly,
                                             float r, float g, float b,
                                             float a, float log_t,
                                             int last) const {
    const int p = ly * kTile + lx;
    rgba[p] = make_float4(r, g, b, a);
    final_log_t[p] = log_t;
    last_idx[p] = last;
  }
};

// Backward inputs (image cotangents and the forward's residual) in the
// frame's row-major images; read only for pixels inside the frame.
struct FrameIn {
  const float* d_rgb;
  const float* d_alpha;
  const float* final_log_t;
  const int* last_idx;
  int width;
  __device__ __forceinline__ void operator()(int x, int y, int, int,
                                             float& g_r, float& g_g,
                                             float& g_b, float& g_a,
                                             float& log_t, int& last) const {
    const int pix = y * width + x;
    g_r = d_rgb[3 * pix + 0];
    g_g = d_rgb[3 * pix + 1];
    g_b = d_rgb[3 * pix + 2];
    g_a = d_alpha[pix];
    log_t = final_log_t[pix];
    last = last_idx[pix];
  }
};

// Backward inputs in one tile's slot of tile-major arrays: the cotangent of
// rgba [kPix, 4] and the residual [kPix]; read only for pixels inside the
// frame.
struct SlotIn {
  const float* d_rgba;
  const float* final_log_t;
  const int* last_idx;
  __device__ __forceinline__ void operator()(int, int, int lx, int ly,
                                             float& g_r, float& g_g,
                                             float& g_b, float& g_a,
                                             float& log_t, int& last) const {
    const int p = ly * kTile + lx;
    g_r = d_rgba[4 * p + 0];
    g_g = d_rgba[4 * p + 1];
    g_b = d_rgba[4 * p + 2];
    g_a = d_rgba[4 * p + 3];
    log_t = final_log_t[p];
    last = last_idx[p];
  }
};

// pack_mean16's round trip of a tile-relative coordinate (the twin's
// ops/sort.py::quantize_mean16): clip(rint((rel + 1024) * 32), 0, 65535)
// / 32 - 1024, rounding half to even; the rounded steps keep nvcc from
// contracting them into an FMA, and a NaN stays NaN as in the twin.
__device__ __forceinline__ float quantize_mean16(float rel) {
  float q = rintf(__fmul_rn(__fadd_rn(rel, 1024.f), 32.f));
  q = q < 0.f ? 0.f : (q > 65535.f ? 65535.f : q);
  return __fsub_rn(__fmul_rn(q, 0.03125f), 1024.f);
}

// Gathers splat g's field row (three 16-byte loads), forms the six rows
// exactly as the twin does and the footprint mask, and stores them in slot
// i of `s`. With `mean16` the tile-local mean is quantized first, so the
// power and the footprint mask both see the mean the twin composites.
template <int kN>
__device__ __forceinline__ PairForm stage_pair(const float* fields, int g,
                                               float ox, float oy,
                                               float log_cut, bool mean16,
                                               PairStage<kN>& s, int i) {
  const float4* row =
      reinterpret_cast<const float4*>(fields + static_cast<size_t>(g) * kRow);
  const float4 f0 = __ldg(row + 0);  // mx, my, conic a, conic b
  const float4 f1 = __ldg(row + 1);  // conic c, r, g, b
  const float4 f2 = __ldg(row + 2);  // opacity, 0, 0, 0
  PairForm p;
  p.mx = __fsub_rn(f0.x, ox);
  p.my = __fsub_rn(f0.y, oy);
  if (mean16) {
    p.mx = quantize_mean16(p.mx);
    p.my = quantize_mean16(p.my);
  }
  p.ca = f0.z;
  p.cb = f0.w;
  p.cc = f1.x;
  p.op = f2.x;
  const float log_op = logf(fmaxf(p.op, 1e-30f));
  // v0 = log(op) - ((0.5 ca mx mx + cb mx my) + 0.5 cc my my)
  const float qa = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, p.ca), p.mx), p.mx);
  const float qb = __fmul_rn(__fmul_rn(p.cb, p.mx), p.my);
  const float qc = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, p.cc), p.my), p.my);
  const float v0 = __fsub_rn(log_op, __fadd_rn(__fadd_rn(qa, qb), qc));
  const float v1 = __fadd_rn(__fmul_rn(p.ca, p.mx), __fmul_rn(p.cb, p.my));
  const float v2 = __fadd_rn(__fmul_rn(p.cc, p.my), __fmul_rn(p.cb, p.mx));
  s.v0123[i] = make_float4(v0, v1, v2, __fmul_rn(-0.5f, p.ca));
  s.v45rg[i] = make_float4(__fmul_rn(-0.5f, p.cc), -p.cb, f1.y, f1.z);
  s.b[i] = f1.w;
  p.mask = footprint_blocks(p.mx, p.my, p.ca, p.cb, p.cc, log_op, log_cut);
  s.mask[i] = static_cast<unsigned char>(p.mask);
  return p;
}

// power at tile-local pixel (px, py) of the pair whose rows v0..v3 are va
// and v4, v5 are vb.x, vb.y, in the twin's order
__device__ __forceinline__ float pair_power(float4 va, float4 vb, float px,
                                            float py, float pxx, float pyy,
                                            float pxy) {
  float power = __fadd_rn(va.x, __fmul_rn(va.y, px));
  power = __fadd_rn(power, __fmul_rn(va.z, py));
  power = __fadd_rn(power, __fmul_rn(va.w, pxx));
  power = __fadd_rn(power, __fmul_rn(vb.x, pyy));
  return __fadd_rn(power, __fmul_rn(vb.y, pxy));
}

// Kernel A's composite of tile (tx, ty) over its `count` pairs, front to
// back, by the whole CTA; hands each pixel's outputs (rgb premultiplied,
// alpha, final log-T, last contributing index, -1 if none) to `out`.
// `mean16`: pack_mean16's tile-relative mean (A and its list entry only).
template <class GidxOf, class Out>
__device__ __forceinline__ void composite_tile(
    const float* __restrict__ fields, GidxOf gidx_of, int count, int tx,
    int ty, int width, int height, float log_cut, float alpha_max,
    float log_eps, PairStage<kFwdBatch>& s, Out out, bool mean16 = false) {
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

  float log_t = 0.f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_a = 0.f;
  int last = -1;
  bool done = !inside;

  for (int b0 = 0; b0 < count; b0 += kFwdBatch) {
    // also the barrier that lets this batch overwrite the previous one
    if (__syncthreads_count(done) == kPix) break;
    const int j = b0 + static_cast<int>(threadIdx.x);
    if (j < count) stage_pair(fields, gidx_of(j), ox, oy, log_cut, mean16,
                              s, threadIdx.x);
    __syncthreads();

    const int n = min(kFwdBatch, count - b0);
    // warp-uniform: the warp walks while any of its pixels is not done
    for (int c0 = 0; c0 < n && !__all_sync(kFull, done); c0 += 32) {
      const int mine = c0 + lane;
      unsigned bits = __ballot_sync(
          kFull, mine < n && ((s.mask[mine] >> warp) & 1u));
      while (bits) {
        const int i = c0 + __ffs(bits) - 1;
        bits &= bits - 1;
        if (done) continue;
        const float4 vb = s.v45rg[i];
        const float power = pair_power(s.v0123[i], vb, px, py, pxx, pyy, pxy);
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
        acc_b = __fadd_rn(acc_b, __fmul_rn(w, s.b[i]));
        acc_a = __fadd_rn(acc_a, w);
        log_t = log_t_incl;
        last = b0 + i;
      }
    }
  }

  out(inside, x, y, lx, ly, acc_r, acc_g, acc_b, acc_a, log_t, last);
}

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

// Kernel B's backward of tile (tx, ty) over its `count` pairs, back to
// front, by the whole CTA, from the forward's residual (final log-T, last
// contributing index) and the image cotangents, which `in` reads for each
// pixel inside the frame; stores each pair's row at row_of(k) with plain
// stores (rows of pairs past every pixel's walk are not written). `mean16`
// as in composite_tile; the mean rows are taken at the quantized mean and
// pass to the mean's gradient unchanged (the straight-through rule).
template <class GidxOf, class RowOf, class In>
__device__ __forceinline__ void backward_tile(
    const float* __restrict__ fields, GidxOf gidx_of, RowOf row_of, int count,
    int tx, int ty, int width, int height, In in, float log_cut,
    float alpha_max, BwdStage& s, bool mean16 = false) {
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

  float g_r = 0.f, g_g = 0.f, g_b = 0.f, g_a = 0.f;
  float log_t = 0.f;  // log-T after the pair being walked
  int last = -1;
  if (inside) {
    in(x, y, lx, ly, g_r, g_g, g_b, g_a, log_t, last);
    last = min(last, count - 1);
  }
  const int warp_last = __reduce_max_sync(kFull, last);
  if (lane == 0) s.wlast[warp] = warp_last;
  __syncthreads();
  int n_walk = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n_walk = max(n_walk, s.wlast[w] + 1);

  float suffix = 0.f;  // S: sum of r_j w_j over the pairs behind
  // the staged pair's own fields and mask, kept by the thread that staged it
  PairForm f = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0u};

  for (int b0 = ((n_walk - 1) / kBwdBatch) * kBwdBatch; n_walk > 0 && b0 >= 0;
       b0 -= kBwdBatch) {
    __syncthreads();  // the previous batch's staging and partials are read
    const int n = min(kBwdBatch, n_walk - b0);
    if (static_cast<int>(threadIdx.x) < n)
      f = stage_pair(fields, gidx_of(b0 + threadIdx.x), ox, oy, log_cut,
                     mean16, s.pair, threadIdx.x);
    __syncthreads();

    // back to front, 32 pairs per ballot; the branch is warp-uniform
    for (int c0 = ((n - 1) / 32) * 32; c0 >= 0; c0 -= 32) {
      const int mine = c0 + lane;
      unsigned bits = __ballot_sync(
          kFull, mine < n && ((s.pair.mask[mine] >> warp) & 1u) &&
                     b0 + mine <= warp_last);
      while (bits) {
        const int top = 31 - __clz(bits);
        bits &= ~(1u << top);
        const int i = c0 + top;
        float p[kGrad];
#pragma unroll
        for (int j = 0; j < kGrad; ++j) p[j] = 0.f;
        if (b0 + i <= last) {
          const float4 vb = s.pair.v45rg[i];
          const float power =
              pair_power(s.pair.v0123[i], vb, px, py, pxx, pyy, pxy);
          if (power >= log_cut) {
            const float a_raw = expf(power);
            const float a = fminf(a_raw, alpha_max);
            log_t = log_t - log1pf(-a);  // log-T before this pair
            const float t = expf(log_t);
            const float w = a * t;
            const float r = g_r * vb.z + g_g * vb.w + g_b * s.pair.b[i] + g_a;
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
        if ((lane & 3) == 0) s.part[warp][i][lane >> 2] = part;
        else if (lane == 1) s.part[warp][i][8] = part8;
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
        if (((f.mask >> w) & 1u) && b0 + i <= s.wlast[w]) {
#pragma unroll
          for (int j = 0; j < kGrad; ++j) m[j] += s.part[w][i][j];
        }
      }
      const float m0 = m[0], m1x = m[1], m1y = m[2];
      const float m2xx = m[3], m2yy = m[4], m2xy = m[5];
      const float c1x = m1x - f.mx * m0;
      const float c1y = m1y - f.my * m0;
      float* out = row_of(b0 + i);
      out[0] = f.ca * c1x + f.cb * c1y;
      out[1] = f.cc * c1y + f.cb * c1x;
      out[2] = -0.5f * (m2xx - 2.f * f.mx * m1x + f.mx * f.mx * m0);
      out[3] = -(m2xy - f.mx * m1y - f.my * m1x + f.mx * f.my * m0);
      out[4] = -0.5f * (m2yy - 2.f * f.my * m1y + f.my * f.my * m0);
      out[5] = m[6];
      out[6] = m[7];
      out[7] = m[8];
      out[8] = m0 / fmaxf(f.op, 1e-30f);
    }
  }
}
