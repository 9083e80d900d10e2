// Binning for Hopper (sm_90a): the CUDA path of ops/sort.py::bin_splats.
//
// Replaces no TPU kernel: the JAX package bins with XLA (gaussian_splatting_
// web_tpu/ops/sort.py::bin_splats, one lax.sort over every slot). The port's
// PyTorch path (ops/sort.py::bin_splats_plain, kept for CPU tensors and as the
// card tests' reference) lays out slot-major [max_dup, N] grids of tiles and
// live flags, compacts them with two nonzero calls (two host syncs), sorts
// int64 keys over all 64 bits and counts tiles with an atomic histogram (a
// third sync). This file computes the same TileBins, bit for bit, in four
// hand-written passes around one library sort, with one host read of M:
//
//  1. bin_count_kernel, four Gaussians a thread, 1024 a block: the footprint
//     rect of _footprints, the shrink of _shrink_oversized (its centring on
//     the clipped rect with a half-tile bias included), ntg and, with
//     tile_cull, _rect_quad_min's ellipse test for each slot. It writes each
//     Gaussian's live mask (max_dup bits) and (first tile, rect width), each
//     block's live count per slot row k (warp ballots) and its count of
//     shrunk Gaussians.
//  2. bin_scan_kernel, one block a slot row: the exclusive scan of the
//     [max_dup, blocks] counts along each row, the rows' totals, and into
//     meta the total M of live pairs and the shrunk count. The host reads M
//     (one sync) and sizes the sort's buffers by it. A slot's live
//     predecessors (slot id k N + g ascending) are the rows before k and the
//     blocks before g's in row k.
//  3. bin_emit_kernel: live slot (k, g) writes the key tile << shift | depth
//     bits and the value k N + g at its rank among the live slots, so the
//     pairs enter the sort in ascending slot order; dead slot s goes straight
//     to its place sorted_slot[M + s - (live slots before s)].
//  4. cub::DeviceRadixSort::SortPairs over bits [0, shift + bit_length(T)):
//     an LSD radix sort, stable, so tied keys keep slot order as
//     torch.sort(stable=True) keeps them.
//  5. bin_ranges_kernel, one thread a sorted pair: sorted_slot[:M], the
//     gather-capped sorted_gidx (slot mod N) and each tile's first position
//     (INRIA's identifyTileRanges; an empty tile gets the next tile's
//     start); bin_tiles_kernel: tile_start, tile_count, num_pairs and
//     overflow under the gather cap.
//
// Numerics: the PyTorch path's float operations run on the card one kernel
// each, rounded to nearest; here every one is written out in the same order
// with __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn (no contraction), IEEE
// logf, and PyTorch's CUDA rules: a tensor divided by a host scalar is
// multiplied by the scalar's float reciprocal, `d / t` is t.reciprocal() * d,
// clamp / minimum / maximum pass NaN through, and a float's cast to int
// truncates (NaN to 0).
//
// What bounds it: bytes. A Gaussian's fields are read once (33 B); the
// outputs are sorted_slot (8 B for every slot: 379 MB at 2.96M Gaussians and
// max_dup 16), sorted_gidx (4 B a kept pair) and two int32 per tile. The sort
// moves each live pair's 12 B (8 B key, 4 B slot) once a pass over 8 key
// bits: 6 passes for a 44-bit key, 4 for a packed 32-bit key.

#include <algorithm>
#include <cstdint>

#include <cub/cub.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                        // Gaussians a thread
constexpr int kPerBlock = kThreads * kItems;     // Gaussians a block
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kItems * kWarps;         // (item, warp) groups: 32
constexpr int kScanThreads = 1024;
constexpr int kTileThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kGroups == 32, "the emit pass scans a block's groups in a warp");

// Projected fields; row strides in floats (columns are contiguous).
struct Fields {
  const float* mean2d;
  const float* conic;
  const float* radius;
  const float* opacity;
  const bool* valid;
  int s_mean, s_conic, s_radius, s_opacity;
};

struct Frame {
  int n, d, gx, gy, ts;
  bool cull;    // tile_cull, with radius_sigma <= 0
  bool sigma;   // radius_sigma > 0
  float alpha_cutoff, inv_cutoff, inv_ts;
};

// A Gaussian's rect after the shrink, and the cull's inputs.
struct Foot {
  int x0, y0, rw, ntg, over;
  float mx, my, qa, qb, qc, tau;
};

// torch.clamp(v, min=lo) on the card
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float minimum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// torch.clamp(v, 0, n).to(torch.int32)
__device__ __forceinline__ int edge(float v, int n) {
  const float c = isnan(v) ? v : fminf(fmaxf(v, 0.f), static_cast<float>(n));
  return static_cast<int>(c);
}

__device__ __forceinline__ int floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// ops/sort.py::float_to_sortable_uint
__device__ __forceinline__ unsigned sortable(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u ^ 0x80000000u);
}

// ops/sort.py::_footprints and _shrink_oversized for Gaussian g.
__device__ Foot footprint(const Fields& f, const Frame& c, long long g) {
  Foot r;
  const bool valid = f.valid[g];
  r.mx = f.mean2d[g * f.s_mean];
  r.my = f.mean2d[g * f.s_mean + 1];
  r.qa = f.conic[g * f.s_conic];
  r.qb = f.conic[g * f.s_conic + 1];
  r.qc = f.conic[g * f.s_conic + 2];
  const float radius = f.radius[g * f.s_radius];
  // _cutoff_tau: log(clamp(opacity, min=cutoff) / cutoff)
  r.tau = logf(__fmul_rn(clamp_min(f.opacity[g * f.s_opacity],
                                   c.alpha_cutoff), c.inv_cutoff));
  float rx = radius, ry = radius;
  if (!c.sigma) {
    const float det = clamp_min(
        __fsub_rn(__fmul_rn(r.qa, r.qc), __fmul_rn(r.qb, r.qb)), 1e-24f);
    const float t2 = __fmul_rn(2.f, r.tau);
    rx = __fadd_rn(__fsqrt_rn(__fdiv_rn(__fmul_rn(t2, r.qc), det)), 0.5f);
    ry = __fadd_rn(__fsqrt_rn(__fdiv_rn(__fmul_rn(t2, r.qa), det)), 0.5f);
    rx = valid ? minimum(rx, radius) : 0.f;
    ry = valid ? minimum(ry, radius) : 0.f;
  }
  const float ex = valid ? r.mx : -1e6f, ey = valid ? r.my : -1e6f;
  int x0 = edge(floorf(__fmul_rn(__fsub_rn(ex, rx), c.inv_ts)), c.gx);
  int y0 = edge(floorf(__fmul_rn(__fsub_rn(ey, ry), c.inv_ts)), c.gy);
  const int x1 = edge(
      __fadd_rn(floorf(__fmul_rn(__fadd_rn(ex, rx), c.inv_ts)), 1.f), c.gx);
  const int y1 = edge(
      __fadd_rn(floorf(__fmul_rn(__fadd_rn(ey, ry), c.inv_ts)), 1.f), c.gy);
  int rw = valid ? x1 - x0 : 0;
  int rh = valid ? y1 - y0 : 0;

  const int d = c.d;
  const int ntg_raw = rw * rh;
  r.over = ntg_raw > d;
  if (r.over) {
    const float sf = __fsqrt_rn(__fmul_rn(
        __fdiv_rn(1.f, static_cast<float>(max(ntg_raw, 1))),
        static_cast<float>(d)));
    const int rw2 = min(max(static_cast<int>(floorf(
                                __fmul_rn(static_cast<float>(rw), sf))), 1),
                        d);
    const int rh_cap = max(floordiv(d, max(rw2, 1)), 1);
    const int rh2 = min(max(static_cast<int>(floorf(
                                __fmul_rn(static_cast<float>(rh), sf))), 1),
                        rh_cap);
    x0 += floordiv(rw - rw2, 2);
    y0 += floordiv(rh - rh2, 2);
    rw = rw2;
    rh = rh2;
  }
  r.x0 = x0;
  r.y0 = y0;
  r.rw = rw;
  r.ntg = rw * rh;
  return r;
}

// ops/sort.py::_rect_quad_min for one slot, in its f32 operation order.
__device__ float rect_quad_min(const Foot& r, float safe_a, float safe_c,
                               float dx0, float dx1, float dy0, float dy1) {
  const bool inside = dx0 <= 0.f && dx1 >= 0.f && dy0 <= 0.f && dy1 >= 0.f;
  const float nqb = -r.qb;
  auto edge_x = [&](float e) {   // dx fixed at e, minimise over dy
    const float y =
        minimum(maximum(__fdiv_rn(__fmul_rn(nqb, e), safe_c), dy0), dy1);
    return __fadd_rn(
        __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(0.5f, r.qa), e), e),
                  __fmul_rn(__fmul_rn(r.qb, e), y)),
        __fmul_rn(__fmul_rn(__fmul_rn(0.5f, r.qc), y), y));
  };
  auto edge_y = [&](float e) {   // dy fixed at e, minimise over dx
    const float x =
        minimum(maximum(__fdiv_rn(__fmul_rn(nqb, e), safe_a), dx0), dx1);
    return __fadd_rn(
        __fadd_rn(__fmul_rn(__fmul_rn(__fmul_rn(0.5f, r.qc), e), e),
                  __fmul_rn(__fmul_rn(r.qb, e), x)),
        __fmul_rn(__fmul_rn(__fmul_rn(0.5f, r.qa), x), x));
  };
  const float q = minimum(minimum(edge_x(dx0), edge_x(dx1)),
                          minimum(edge_y(dy0), edge_y(dy1)));
  return inside ? 0.f : q;
}

// Bit k - k0 set: slot k in [k0, k1) is live (ops/sort.py::
// candidate_slot_tiles).
__device__ unsigned live_bits(const Foot& r, const Frame& c, int k0, int k1) {
  const int kend = min(k1, r.ntg);
  if (k0 >= kend) return 0u;
  if (!c.cull) {
    const int w = kend - k0;
    return w >= 32 ? kFull : (1u << w) - 1u;
  }
  const float safe_a = clamp_min(r.qa, 1e-12f);
  const float safe_c = clamp_min(r.qc, 1e-12f);
  const float limit = __fadd_rn(r.tau, 1e-3f);     // tau + TAU_SLACK
  const float ts = static_cast<float>(c.ts);
  const float ts1 = static_cast<float>(c.ts - 1);
  unsigned m = 0u;
  for (int k = k0; k < kend; ++k) {
    const int ty = r.y0 + k / r.rw, tx = r.x0 + k % r.rw;   // rw >= 1 here
    const float dx0 = __fsub_rn(__fmul_rn(static_cast<float>(tx), ts), r.mx);
    const float dy0 = __fsub_rn(__fmul_rn(static_cast<float>(ty), ts), r.my);
    const float q = rect_quad_min(r, safe_a, safe_c, dx0, __fadd_rn(dx0, ts1),
                                  dy0, __fadd_rn(dy0, ts1));
    m |= static_cast<unsigned>(q <= limit) << (k - k0);
  }
  return m;
}

// Pass 1. counts is [d + 1, blocks]: row k < d the block's live slots of
// slot row k, row d its shrunk Gaussians. masks is [ceil(d / 32), n].
__global__ void __launch_bounds__(kThreads)
    bin_count_kernel(Fields f, Frame c, int2* geo, unsigned* masks,
                     int* counts, int blocks) {
  __shared__ int s_count[32];
  __shared__ int s_over;
  const int lane = threadIdx.x & 31;
  const long long first =
      static_cast<long long>(blockIdx.x) * kPerBlock + threadIdx.x;
  Foot r[kItems];
  int over = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long g = first + j * kThreads;
    r[j].ntg = 0;
    if (g < c.n) {
      r[j] = footprint(f, c, g);
      over += r[j].over;
      geo[g] = make_int2(r[j].y0 * c.gx + r[j].x0, max(r[j].rw, 1));
    }
  }
  if (threadIdx.x == 0) s_over = 0;
  __syncthreads();
  over = __reduce_add_sync(kFull, over);
  if (lane == 0) atomicAdd(&s_over, over);
  for (int k0 = 0; k0 < c.d; k0 += 32) {
    const int kn = min(32, c.d - k0);
    if (threadIdx.x < 32) s_count[threadIdx.x] = 0;
    __syncthreads();
    unsigned m[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long g = first + j * kThreads;
      m[j] = live_bits(r[j], c, k0, k0 + kn);
      if (g < c.n) masks[static_cast<long long>(k0 / 32) * c.n + g] = m[j];
    }
    int mine = 0;          // lane kl: this warp's live slots of row k0 + kl
    for (int kl = 0; kl < kn; ++kl) {
      int warp_count = 0;
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        warp_count += __popc(__ballot_sync(kFull, (m[j] >> kl) & 1u));
      if (lane == kl) mine = warp_count;
    }
    if (lane < kn) atomicAdd(&s_count[lane], mine);
    __syncthreads();
    if (threadIdx.x < kn)
      counts[static_cast<long long>(k0 + threadIdx.x) * blocks + blockIdx.x] =
          s_count[threadIdx.x];
    __syncthreads();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    counts[static_cast<long long>(c.d) * blocks + blockIdx.x] = s_over;
}

// Exclusive scan of v over a kScanThreads block; *total gets the sum.
__device__ long long block_scan(long long v, long long* s_warp,
                                long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  __syncthreads();                 // s_warp is free from an earlier call
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = s_warp[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  *total = s_warp[kScanThreads / 32 - 1];
  return (warp ? s_warp[warp - 1] : 0) + x - v;
}

// Pass 2, one block a row of counts: offsets[k, b] = live slots of row k
// in blocks before b, offsets[d, k] = row k's total; meta[0] (M) and
// meta[1] (shrunk Gaussians, row d), zeroed before pass 1, gather the rows'
// totals.
__global__ void __launch_bounds__(kScanThreads)
    bin_scan_kernel(const int* counts, long long* offsets, long long* meta,
                    int blocks, int d) {
  __shared__ long long s_warp[32];
  const int row = blockIdx.x;
  const int* in = counts + static_cast<long long>(row) * blocks;
  long long* out = offsets + static_cast<long long>(row) * blocks;
  const int chunk = (blocks + kScanThreads - 1) / kScanThreads;
  const int lo = min(blocks, static_cast<int>(threadIdx.x) * chunk);
  const int hi = min(blocks, lo + chunk);
  long long sum = 0;
  for (int i = lo; i < hi; ++i) sum += in[i];
  long long total;
  long long run = block_scan(sum, s_warp, &total);
  if (row < d) {
    for (int i = lo; i < hi; ++i) {
      out[i] = run;
      run += in[i];
    }
  }
  if (threadIdx.x == 0) {
    if (row < d) offsets[static_cast<long long>(d) * blocks + row] = total;
    atomicAdd(reinterpret_cast<unsigned long long*>(meta + (row < d ? 0 : 1)),
              static_cast<unsigned long long>(total));
  }
}

// Pass 3: the live pairs' (key, slot) in slot order, the dead slots into
// sorted_slot's tail.
template <typename K, typename V>
__global__ void __launch_bounds__(kThreads)
    bin_emit_kernel(const int2* geo, const unsigned* masks,
                    const long long* offsets, const float* depth, int s_depth,
                    int n, int d, int gx, int shift, int blocks, long long m,
                    K* keys, V* vals, long long* sorted_slot) {
  __shared__ int s_rank[32][kGroups + 1];
  __shared__ long long s_off[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const long long first =
      static_cast<long long>(blockIdx.x) * kPerBlock + threadIdx.x;
  int2 rect[kItems];
  unsigned dkey[kItems];
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const long long g = first + j * kThreads;
    rect[j] = make_int2(0, 1);
    dkey[j] = 0u;
    if (g < n) {
      rect[j] = geo[g];
      dkey[j] = sortable(depth[g * s_depth]) >> (32 - shift);
    }
  }
  for (int k0 = 0; k0 < d; k0 += 32) {
    const int kn = min(32, d - k0);
    unsigned mk[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long g = first + j * kThreads;
      mk[j] = g < n ? masks[static_cast<long long>(k0 / 32) * n + g] : 0u;
    }
    for (int kl = 0; kl < kn; ++kl) {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const unsigned b = __ballot_sync(kFull, (mk[j] >> kl) & 1u);
        if (lane == 0) s_rank[kl][j * kWarps + warp] = __popc(b);
      }
    }
    if (threadIdx.x < kn) {          // rows before k, then blocks before b
      const long long* totals = offsets + static_cast<long long>(d) * blocks;
      const int k = k0 + threadIdx.x;
      long long before = offsets[static_cast<long long>(k) * blocks +
                                 blockIdx.x];
      for (int q = 0; q < k; ++q) before += totals[q];
      s_off[threadIdx.x] = before;
    }
    __syncthreads();
    // groups in ascending Gaussian order: (item, warp)
    for (int kl = warp; kl < kn; kl += kWarps) {
      const int v = s_rank[kl][lane];
      int x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      s_rank[kl][lane] = x - v;
    }
    __syncthreads();
    for (int kl = 0; kl < kn; ++kl) {
      const int k = k0 + kl;
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const long long g = first + j * kThreads;
        const bool live = (mk[j] >> kl) & 1u;
        const unsigned b = __ballot_sync(kFull, live);
        if (g < n) {
          const long long before = s_off[kl] +
                                   s_rank[kl][j * kWarps + warp] +
                                   __popc(b & lower);
          const long long s = static_cast<long long>(k) * n + g;
          if (live) {
            const int tile =
                rect[j].x + (k / rect[j].y) * gx + k % rect[j].y;
            keys[before] = (static_cast<K>(tile) << shift) |
                           static_cast<K>(dkey[j]);
            vals[before] = static_cast<V>(s);
          } else {
            sorted_slot[m + s - before] = s;
          }
        }
      }
    }
    __syncthreads();
  }
}

// Pass 5a: sorted_slot[:m], sorted_gidx[:cap] and bounds[t] = the first
// position whose tile is >= t, for t <= num_tiles.
template <typename K, typename V>
__global__ void bin_ranges_kernel(const K* keys, const V* vals, int m,
                                  int cap, int n, int shift, int num_tiles,
                                  long long* sorted_slot, int* sorted_gidx,
                                  int* bounds) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const long long s = static_cast<long long>(vals[i]);
  sorted_slot[i] = s;
  if (i < cap) sorted_gidx[i] = static_cast<int>(s % n);
  const int tile = static_cast<int>(keys[i] >> shift);
  const int prev = i ? static_cast<int>(keys[i - 1] >> shift) : -1;
  for (int t = prev + 1; t <= tile; ++t) bounds[t] = i;
  if (i == m - 1)
    for (int t = tile + 1; t <= num_tiles; ++t) bounds[t] = m;
}

// Pass 5b: the tiles' segments under the gather cap (cap <= m), num_pairs
// (meta[2]) and overflow (meta[3]).
__global__ void bin_tiles_kernel(const int* bounds, int m, int cap,
                                 int num_tiles, int* tile_start,
                                 int* tile_count, long long* meta) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < num_tiles) {
    const int s = m ? min(bounds[t], cap) : 0;
    const int e = m ? min(bounds[t + 1], cap) : 0;
    tile_start[t] = s;
    tile_count[t] = e - s;
  }
  if (t == 0) {
    meta[2] = cap;
    meta[3] = meta[1] + (m - cap);
  }
}

template <typename K, typename V>
cudaError_t sort_pairs(void* temp, size_t& bytes, void* k0, void* k1,
                       void* v0, void* v1, int m, int end_bit,
                       cudaStream_t st, const K** keys, const V** vals) {
  cub::DoubleBuffer<K> kb(static_cast<K*>(k0), static_cast<K*>(k1));
  cub::DoubleBuffer<V> vb(static_cast<V*>(v0), static_cast<V*>(v1));
  const cudaError_t e = cub::DeviceRadixSort::SortPairs(
      temp, bytes, kb, vb, m, 0, end_bit, st);
  if (keys) *keys = kb.Current();
  if (vals) *vals = vb.Current();
  return e;
}

template <typename K, typename V>
cudaError_t emit_sort_ranges(const int* geo, const unsigned* masks,
                             const long long* offsets, const float* depth,
                             int n, int d, int gx, int num_tiles, int shift,
                             int end_bit, int m, int cap, int s_depth,
                             size_t temp_bytes, void* keys0, void* keys1,
                             void* vals0, void* vals1, void* temp,
                             long long* sorted_slot, int* sorted_gidx,
                             int* bounds, int* tile_start, int* tile_count,
                             long long* meta, cudaStream_t st) {
  const int blocks = (n + kPerBlock - 1) / kPerBlock;
  if (blocks > 0)
    bin_emit_kernel<K, V><<<blocks, kThreads, 0, st>>>(
        reinterpret_cast<const int2*>(geo), masks, offsets, depth, s_depth, n,
        d, gx, shift, blocks, m, static_cast<K*>(keys0),
        static_cast<V*>(vals0), sorted_slot);
  if (m > 0) {
    const K* keys = nullptr;
    const V* vals = nullptr;
    const cudaError_t e = sort_pairs<K, V>(temp, temp_bytes, keys0, keys1,
                                           vals0, vals1, m, end_bit, st,
                                           &keys, &vals);
    if (e != cudaSuccess) return e;
    bin_ranges_kernel<K, V><<<(m + 255) / 256, 256, 0, st>>>(
        keys, vals, m, cap, n, shift, num_tiles, sorted_slot, sorted_gidx,
        bounds);
  }
  const int tile_blocks =
      std::max(1, (num_tiles + kTileThreads - 1) / kTileThreads);
  bin_tiles_kernel<<<tile_blocks, kTileThreads, 0, st>>>(
      bounds, m, cap, num_tiles, tile_start, tile_count, meta);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches passes 1 and 2 on `stream` of `device` over n projected
// Gaussians: mean2d [n, 2], conic [n, 3], radius, opacity [n] (float32,
// columns contiguous, rows `s_*` floats apart) and valid [n] (bools,
// contiguous) in; geo [n, 2] int32 (first tile, rect width), masks
// [ceil(d / 32), n] uint32, counts [d + 1, blocks] int32, offsets
// [d blocks + d] int64 (blocks = ceil(n / 1024)) and meta [4] int64 (M and
// the shrunk count in meta[0], meta[1]) out. cull: tile_cull with
// radius_sigma <= 0; sigma: radius_sigma > 0. Returns cudaGetLastError().
int bin_count(const float* mean2d, const float* conic, const float* radius,
              const float* opacity, const bool* valid, int n, int d, int gx,
              int gy, int tile_size, int cull, int sigma, int s_mean,
              int s_conic, int s_radius, int s_opacity, float alpha_cutoff,
              int* geo, unsigned* masks, int* counts, long long* offsets,
              long long* meta, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kPerBlock - 1) / kPerBlock;
  // PyTorch divides a CUDA tensor by a host scalar as a product with the
  // scalar's reciprocal, computed in float on the host
  const Frame c{n, d, gx, gy, tile_size, cull != 0, sigma != 0, alpha_cutoff,
                1.0f / alpha_cutoff, 1.0f / static_cast<float>(tile_size)};
  const Fields f{mean2d, conic, radius, opacity, valid,
                 s_mean, s_conic, s_radius, s_opacity};
  const cudaError_t zero =
      cudaMemsetAsync(meta, 0, 2 * sizeof(long long), st);
  if (zero != cudaSuccess) return static_cast<int>(zero);
  if (blocks > 0) {
    bin_count_kernel<<<blocks, kThreads, 0, st>>>(
        f, c, reinterpret_cast<int2*>(geo), masks, counts, blocks);
    bin_scan_kernel<<<d + 1, kScanThreads, 0, st>>>(counts, offsets, meta,
                                                    blocks, d);
  }
  return static_cast<int>(cudaGetLastError());
}

// Bytes of the radix sort's temporary storage for m pairs of 64-bit
// (key64) or 32-bit keys and 64-bit (val64) or 32-bit values over bits
// [0, end_bit), into *bytes (host memory). Launches nothing.
int bin_sort_temp_bytes(int m, int key64, int val64, int end_bit,
                        long long* bytes) {
  size_t b = 0;
  cudaError_t e;
  if (key64)
    e = val64 ? sort_pairs<uint64_t, int64_t>(nullptr, b, nullptr, nullptr,
                                              nullptr, nullptr, m, end_bit,
                                              0, nullptr, nullptr)
              : sort_pairs<uint64_t, int32_t>(nullptr, b, nullptr, nullptr,
                                              nullptr, nullptr, m, end_bit,
                                              0, nullptr, nullptr);
  else
    e = val64 ? sort_pairs<uint32_t, int64_t>(nullptr, b, nullptr, nullptr,
                                              nullptr, nullptr, m, end_bit,
                                              0, nullptr, nullptr)
              : sort_pairs<uint32_t, int32_t>(nullptr, b, nullptr, nullptr,
                                              nullptr, nullptr, m, end_bit,
                                              0, nullptr, nullptr);
  *bytes = static_cast<long long>(b);
  return static_cast<int>(e);
}

// Launches passes 3-5 on `stream` of `device`, after bin_count and the
// host's read of m = meta[0]: geo, masks, offsets, depth [n] (float32,
// elements s_depth apart) in; keys0/keys1 [m] (uint64 if key64, else
// uint32), vals0/vals1 [m] (int64 if val64, else int32), temp
// (temp_bytes, from bin_sort_temp_bytes), sorted_slot [n d] int64,
// sorted_gidx [cap] int32, bounds [num_tiles + 1] int32, tile_start and
// tile_count [num_tiles] int32, meta out. cap = min(gather cap, m).
// Returns cudaGetLastError() or the sort's error.
int bin_emit_sort(const int* geo, const unsigned* masks,
                  const long long* offsets, const float* depth, int n, int d,
                  int gx, int num_tiles, int shift, int end_bit, int key64,
                  int val64, int m, int cap, int s_depth, int temp_bytes,
                  void* keys0, void* keys1, void* vals0, void* vals1,
                  void* temp, long long* sorted_slot, int* sorted_gidx,
                  int* bounds, int* tile_start, int* tile_count,
                  long long* meta, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t tb = static_cast<size_t>(temp_bytes);
  cudaError_t e;
  if (key64)
    e = val64 ? emit_sort_ranges<uint64_t, int64_t>(
                    geo, masks, offsets, depth, n, d, gx, num_tiles, shift,
                    end_bit, m, cap, s_depth, tb, keys0, keys1, vals0, vals1,
                    temp, sorted_slot, sorted_gidx, bounds, tile_start,
                    tile_count, meta, st)
              : emit_sort_ranges<uint64_t, int32_t>(
                    geo, masks, offsets, depth, n, d, gx, num_tiles, shift,
                    end_bit, m, cap, s_depth, tb, keys0, keys1, vals0, vals1,
                    temp, sorted_slot, sorted_gidx, bounds, tile_start,
                    tile_count, meta, st);
  else
    e = val64 ? emit_sort_ranges<uint32_t, int64_t>(
                    geo, masks, offsets, depth, n, d, gx, num_tiles, shift,
                    end_bit, m, cap, s_depth, tb, keys0, keys1, vals0, vals1,
                    temp, sorted_slot, sorted_gidx, bounds, tile_start,
                    tile_count, meta, st)
              : emit_sort_ranges<uint32_t, int32_t>(
                    geo, masks, offsets, depth, n, d, gx, num_tiles, shift,
                    end_bit, m, cap, s_depth, tb, keys0, keys1, vals0, vals1,
                    temp, sorted_slot, sorted_gidx, bounds, tile_start,
                    tile_count, meta, st);
  return static_cast<int>(e);
}

const char* bin_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
