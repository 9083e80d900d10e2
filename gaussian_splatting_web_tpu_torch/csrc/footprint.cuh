// The footprint cull shared by kernels A and B: which 8x4 pixel blocks of a
// 16x16 tile a staged pair's power can reach the cutoff in.
//
// A pair's power at tile-local pixel (px, py) is summed by the kernels, in
// the twin's order with every operation rounded to nearest, from
//   v0 = log_op - ((0.5 ca mx mx + cb mx my) + 0.5 cc my my),
//   v1 = ca mx + cb my,  v2 = cc my + cb mx,  v3 = -0.5 ca,  v4 = -0.5 cc,
//   v5 = -cb:  power = ((((v0 + v1 px) + v2 py) + v3 px^2) + v4 py^2) + v5 px py.
// In exact arithmetic on the same float inputs this is
//   P = log_op - Q(px - mx, py - my) / 2,  Q(dx, dy) = ca dx^2 + 2 cb dx dy + cc dy^2.
//
// Margin. Let u = 2^-24 and S the sum of the magnitudes of every term over
// the tile (0 <= px, py <= 15):
//   S = |log_op| + 0.5|ca| mx^2 + |cb mx my| + 0.5|cc| my^2
//       + 15 (|ca mx| + |cb my| + |cc my| + |cb mx|) + 225 (0.5|ca| + 0.5|cc| + |cb|).
// Every intermediate of the form is bounded by S. Each rounding adds at most
// u times the magnitude of its result: v0 gathers at most 5 u S (two
// products in each of qa, qb, qc, two adds, the subtract); v1 and v2 at most
// 2 u (|ca mx| + |cb my|) and 2 u (|cc my| + |cb mx|), amplified by px,
// py <= 15 to at most 2 u S together; the power sum's 5 products and 5 adds
// at most 5 u S and u S. So |power - P| <= E = 12 u S (to first order).
// The cull uses E' = 1e-5 (S + |log_cut|) (about 168 u S, fourteen times E,
// which also covers the roundings of S, of log_op - log_cut and of the
// test itself). A pixel can pass only if power >= log_cut, hence only if
//   Q(px - mx, py - my) <= r2 = 2 (log_op - log_cut + E').
// Rounding may lift power above log_op; E' covers that too, since the test
// bounds power - P and never assumes power <= log_op.
//
// When the conic is positive definite (ca > 0, det = ca cc - cb^2 > 0), the
// set Q <= r2 is an ellipse about (mx, my) with half-extents
// sqrt(r2 cc / det) in x and sqrt(r2 ca / det) in y; r2 < 0 leaves it empty.
// det is formed with cancellation, so it is replaced by the lower bound
// det_lo = det - 1e-5 (|ca cc| + cb^2) (its rounding error is below
// 3u (|ca cc| + cb^2)); the half-extents are widened by 0.1% (the roundings
// of the square root, product and quotient) and by 1e-3 pixel (the
// rounding of mx -+ h near a block edge, below 15u). A block is kept when
// its pixel rectangle meets the widened box. Pairs whose terms are not all
// finite, whose conic is not positive definite, or whose det_lo is not
// positive keep every block: the warp evaluates them as before.
//
// Every operation below is rounded to nearest without contraction
// (__fmul_rn, __fadd_rn, sqrtf, __fdiv_rn), so the plain PyTorch mirror
// (ops/cuda/raster.py::footprint_blocks) computes the same masks.

#pragma once

#include <cuda_runtime.h>

constexpr int kTile = 16;
constexpr int kBlockW = 8;                       // pixels per warp block, x
constexpr int kBlockH = 4;                       // and y
constexpr int kBlocksX = kTile / kBlockW;        // 2
constexpr int kBlocksY = kTile / kBlockH;        // 4
constexpr unsigned kAllBlocks = (1u << (kBlocksX * kBlocksY)) - 1u;
constexpr float kCullRel = 1e-5f;    // relative margin on power and det
constexpr float kCullWiden = 1.001f;  // relative widening of half-extents
constexpr float kCullPad = 1e-3f;     // absolute widening, pixels

// tile-local origin of warp w's pixel block
__device__ __forceinline__ int block_x0(int w) { return (w % kBlocksX) * kBlockW; }
__device__ __forceinline__ int block_y0(int w) { return (w / kBlocksX) * kBlockH; }

// Bit w set: the pair's power may reach log_cut in warp w's pixel block.
__device__ __forceinline__ unsigned footprint_blocks(float mx, float my,
                                                     float ca, float cb,
                                                     float cc, float log_op,
                                                     float log_cut) {
  const float amx = fabsf(mx), amy = fabsf(my);
  const float aa = fabsf(ca), ab = fabsf(cb), ac = fabsf(cc);
  float s = fabsf(log_op);
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(__fmul_rn(0.5f, aa), amx), amx));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(ab, amx), amy));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(__fmul_rn(0.5f, ac), amy), amy));
  const float lin = __fadd_rn(
      __fadd_rn(__fmul_rn(aa, amx), __fmul_rn(ab, amy)),
      __fadd_rn(__fmul_rn(ac, amy), __fmul_rn(ab, amx)));
  s = __fadd_rn(s, __fmul_rn(15.f, lin));
  const float quad = __fadd_rn(__fadd_rn(__fmul_rn(0.5f, aa),
                                         __fmul_rn(0.5f, ac)), ab);
  s = __fadd_rn(s, __fmul_rn(225.f, quad));
  const float det = __fsub_rn(__fmul_rn(ca, cc), __fmul_rn(cb, cb));
  const float det_lo = __fsub_rn(
      det, __fmul_rn(kCullRel, __fadd_rn(__fmul_rn(aa, ac),
                                         __fmul_rn(ab, ab))));
  // NaN and inf fail the first test; every input appears in s
  if (!(s <= 3.0e38f) || !(ca > 0.f) || !(det_lo > 0.f)) return kAllBlocks;
  const float margin = __fmul_rn(kCullRel, __fadd_rn(s, fabsf(log_cut)));
  const float r2 = __fmul_rn(2.f, __fadd_rn(__fsub_rn(log_op, log_cut),
                                            margin));
  if (r2 < 0.f) return 0u;
  const float hx = __fadd_rn(
      __fmul_rn(sqrtf(__fdiv_rn(__fmul_rn(r2, cc), det_lo)), kCullWiden),
      kCullPad);
  const float hy = __fadd_rn(
      __fmul_rn(sqrtf(__fdiv_rn(__fmul_rn(r2, ca), det_lo)), kCullWiden),
      kCullPad);
  const float x_lo = __fsub_rn(mx, hx), x_hi = __fadd_rn(mx, hx);
  const float y_lo = __fsub_rn(my, hy), y_hi = __fadd_rn(my, hy);
  unsigned mask = 0u;
#pragma unroll
  for (int w = 0; w < kBlocksX * kBlocksY; ++w) {
    const float x0 = static_cast<float>(block_x0(w));
    const float y0 = static_cast<float>(block_y0(w));
    const bool meets = x0 + (kBlockW - 1) >= x_lo && x0 <= x_hi &&
                       y0 + (kBlockH - 1) >= y_lo && y0 <= y_hi;
    mask |= static_cast<unsigned>(meets) << w;
  }
  return mask;
}
