// Kernel C: merge-in-kernel forward compositor of the anchor binning, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel gaussian_splatting_web_tpu/ops/pallas/anchor.py::
// _fwd_kernel (with _merge_tile and _TileScalars, launched by
// composite_tiles_anchor) and computes what it computes in exact mode. Per
// 16x16 pixel tile (tx, ty):
//   merge: read range A (anchor tiles tx-1..tx of row ty-1) and range B (the
//     same columns of row ty) of the (tile, depth)-sorted entries, each only
//     up to its aligned cover base + c_max * 256, base = first position
//     rounded down to 256; keep the entries that touch the tile (range B:
//     dup entries in column tx, anchors in column tx or wide; range A: tall
//     anchors in column tx or wide); order them by (sortable depth, union
//     lane), the union lane being the offset from the range's base, range B
//     after range A's c_max * 256 lanes; keep the first k_cap;
//   composite: kernel A's front-to-back INRIA walk over that ordered list.
// The TPU-only parts are left out: the 256-lane DMA covers, the rank by
// blocked compares and the bf16x3 one-hot permute matmuls, the R-tile groups
// and the log(op) fold with its clamp (the port keeps kernel A's power).
//
// Design: one CTA per tile, 256 threads; tiles run heavy first by the
// union positions their merge reads (CoverWeight below, tile_order.cuh),
// written by a one-block kernel before C in the same launch.
//   merge: the binning's sort is stable by (tile, depth), and a range holds
//     two tiles' runs, so each range is two runs (columns tx-1 and tx) that
//     are already ascending in the key (sortable depth << 32 | union lane):
//     the union lane grows with the position. The CTA compacts the touched
//     entries of both ranges in position order, 256 positions per step
//     (one coalesced 1-byte meta load per position, the 4-byte depth only
//     where touched): a warp ballot and popc place each key, the 8 warps'
//     counts in shared memory give each warp its offset (one barrier per
//     step). The compacted keys are then four ascending runs whose bounds
//     are binary searches on the lane. A key's rank in the merged order is
//     its index in its own run plus, for each other run, the number of keys
//     below it (a binary search in shared memory); the keys are unique, so
//     the ranks are a permutation and equal the plain merge's order. Ranks
//     below k_cap are scattered into the ordered list in shared memory,
//     which is written out with the row groups and k_used. So the merge
//     takes ceil(union / 256) + 2 barriers where a block-wide bitonic sort
//     of the keys padded to a power of two takes 45-66 at the default caps,
//     and shared memory holds the union unpadded.
//   composite: kernel A's walk (tile_walk.cuh::composite_tile) over the
//     ordered list: 8x4 warp blocks, the footprint mask at staging, the
//     ballot walk, the warp-uniform skip and the block-wide early exit. A
//     batch stage gathers each pair's 48-byte field row through its entry's
//     gaussian id; the stage reuses the keys' shared memory.
//
// Bounds on the card: the composite's per pair-pixel work is kernel A's, so
// FP32/SFU issue and load imbalance between tiles bound it as they bound A;
// the merge adds per tile a pass over the union (5 bytes per touched
// position, 1 per other) and ~3 log2(n) shared loads per key. Device
// memory sees the union loads, one field row per kept pair and the outputs.
//
// Numerics: power is summed with __fmul_rn / __fadd_rn in kernel A's order,
// so the cutoff, clamp and early-exit decisions match the plain version
// bit for bit. Build without -use_fast_math.
//
// Outputs: rgb [H, W, 3] premultiplied, alpha, final_log_t, last_idx (an
// index into the tile's ordered list, -1 if none), and for kernel D, which
// does not redo the merge: ordered [T, k_cap] (the kept entries' sorted
// positions, -1 past k_used), k_used [T] and group [T, k_cap] (the backward
// row group: range row type (A 0, B 1) * 2 + tx mod 2).

#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_order.cuh"
#include "tile_walk.cuh"

namespace {

constexpr int kChunk = 256;          // positions per cover chunk

// A range's positions [s0, end) split at sb into columns tx-1 and tx. The
// split is clipped to the end: where column tx-1 holds more entries than
// the cover has left, column tx is empty, and the lane bound of range A's
// column-tx run must not search on into range B's keys.
struct Range {
  int base, s0, sb, end;  // cover base, first position, column split, end
};

__device__ __forceinline__ Range tile_range(const int* starts, int row,
                                            int tx, int gx, int num_tiles,
                                            int c_max, bool present) {
  Range r = {0, 0, 0, 0};
  if (!present) return r;
  const int j = row * gx;
  r.s0 = starts[min(j + max(tx - 1, 0), num_tiles)];
  const int s1 = starts[min(j + tx + 1, num_tiles)];
  r.base = (r.s0 / kChunk) * kChunk;
  r.end = min(s1, r.base + c_max * kChunk);
  r.sb = min(starts[min(j + tx, num_tiles)], r.end);
  return r;
}

// The heavy-first weight of tile t: the union positions its merge reads,
// the clipped lengths of its two ranges.
struct CoverWeight {
  const int* starts;
  int gx, num_tiles, c_max;
  __device__ __forceinline__ int operator()(int t) const {
    const int tx = t % gx, ty = t / gx;
    const Range a = tile_range(starts, ty - 1, tx, gx, num_tiles, c_max,
                               ty > 0);
    const Range b = tile_range(starts, ty, tx, gx, num_tiles, c_max, true);
    return max(a.end - a.s0, 0) + max(b.end - b.s0, 0);
  }
};

// the first index in [lo, hi) of the ascending keys s whose key is >= key
__device__ __forceinline__ int key_bound(const unsigned long long* s, int lo,
                                         int hi, unsigned long long key) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < key) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the first index in [lo, hi) whose union lane (a key's low word; the lanes
// ascend in compaction order) is >= lane
__device__ __forceinline__ int lane_bound(const unsigned long long* s, int lo,
                                          int hi, int lane) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<int>(static_cast<uint32_t>(s[mid])) < lane) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kPix)
anchor_fwd_kernel(const float* __restrict__ fields,
                  const int* __restrict__ sorted_gidx,
                  const uint8_t* __restrict__ sorted_meta,
                  const uint32_t* __restrict__ sorted_depth,
                  const int* __restrict__ starts,
                  const int* __restrict__ tile_order,
                  int width, int height, int gx, int num_tiles, int c_max,
                  int k_cap, int key_bytes,
                  float log_cut, float alpha_max, float log_eps,
                  float* __restrict__ rgb, float* __restrict__ alpha,
                  float* __restrict__ final_log_t, int* __restrict__ last_idx,
                  int* __restrict__ ordered, int* __restrict__ k_used,
                  int8_t* __restrict__ group) {
  // the compacted keys, then (once ranked) the composite's batch stage
  extern __shared__ __align__(16) unsigned char s_raw[];
  unsigned long long* s_keys = reinterpret_cast<unsigned long long*>(s_raw);
  PairStage<kFwdBatch>& stage =
      *reinterpret_cast<PairStage<kFwdBatch>*>(s_raw);
  int* s_ord = reinterpret_cast<int*>(s_raw + key_bytes);  // k_cap lanes
  __shared__ int s_count[2][kWarps];  // touched per warp, double-buffered

  const int tile = tile_order[blockIdx.x];
  const int tx = tile % gx;
  const int ty = tile / gx;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int half = c_max * kChunk;  // union lanes of one range

  // --- merge 1: compact the touched entries of A then B in position order
  const Range ra = tile_range(starts, ty - 1, tx, gx, num_tiles, c_max,
                              ty > 0);
  const Range rb = tile_range(starts, ty, tx, gx, num_tiles, c_max, true);
  const int na = max(ra.end - ra.s0, 0);
  const int n_union = na + max(rb.end - rb.s0, 0);
  int n_live = 0;
  for (int v0 = 0, buf = 0; v0 < n_union; v0 += kPix, buf ^= 1) {
    const int v = v0 + tid;
    bool touch = false;
    int pos = 0, ulane = 0;
    if (v < n_union) {
      const bool q = v >= na;  // range B
      pos = q ? rb.s0 + (v - na) : ra.s0 + v;
      const int meta = sorted_meta[pos];
      const bool dup = meta & 4, wide = meta & 2, tall = meta & 1;
      const bool own_col = pos >= (q ? rb.sb : ra.sb);
      const bool ok_col = own_col || wide;
      touch = q ? (dup ? own_col : ok_col) : (!dup && ok_col && tall);
      ulane = q ? half + (pos - rb.base) : pos - ra.base;
    }
    const unsigned bal = __ballot_sync(kFull, touch);
    if (lane == 0) s_count[buf][warp] = __popc(bal);
    __syncthreads();
    int at = n_live;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_count[buf][w];
      at += w < warp ? c : 0;
      n_live += c;
    }
    if (touch)
      s_keys[at + __popc(bal & ((1u << lane) - 1u))] =
          (static_cast<unsigned long long>(sorted_depth[pos]) << 32) |
          static_cast<unsigned>(ulane);
  }
  __syncthreads();

  // --- merge 2: the four ascending runs, each key's rank, the scatter ----
  int run[5];
  run[0] = 0;
  run[1] = lane_bound(s_keys, 0, n_live, ra.sb - ra.base);  // A, column tx
  run[2] = lane_bound(s_keys, run[1], n_live, half);         // B
  run[3] = lane_bound(s_keys, run[2], n_live, half + rb.sb - rb.base);
  run[4] = n_live;
  for (int i = tid; i < n_live; i += kPix) {
    const unsigned long long key = s_keys[i];
    int rank = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      rank += (i >= run[r] && i < run[r + 1])
                  ? i - run[r]
                  : key_bound(s_keys, run[r], run[r + 1], key) - run[r];
    }
    if (rank < k_cap) s_ord[rank] = static_cast<int>(static_cast<uint32_t>(key));
  }
  __syncthreads();
  const int count = min(n_live, k_cap);
  for (int k = tid; k < k_cap; k += kPix) {
    int pos = -1, grp = 0;
    if (k < count) {
      const int ul = s_ord[k];
      const int q = ul >= half;
      pos = (q ? rb.base - half : ra.base) + ul;
      grp = q * 2 + (tx & 1);
    }
    ordered[static_cast<size_t>(tile) * k_cap + k] = pos;
    group[static_cast<size_t>(tile) * k_cap + k] = static_cast<int8_t>(grp);
  }
  if (tid == 0) k_used[tile] = count;

  // --- composite: kernel A's walk over the ordered list -----------------
  const int base_a = ra.base, base_b = rb.base - half;
  composite_tile(
      fields,
      [=](int k) {
        const int ul = s_ord[k];
        return __ldg(sorted_gidx + (ul >= half ? base_b : base_a) + ul);
      },
      count, tx, ty, width, height, log_cut, alpha_max, log_eps, stage,
      FrameOut{rgb, alpha, final_log_t, last_idx, width});
}

}  // namespace

extern "C" {

// Launches kernel C on `stream` of `device` over gx * gy tiles: first the
// heavy-first schedule into `tile_order` (gx * gy ints of scratch), then C
// with `smem` bytes of dynamic shared memory (8 bytes for each union lane,
// at least the 9,472-byte batch stage, then 4 bytes for each of the k_cap
// ordered-list lanes). Returns the first CUDA error (0 on success).
// Pointers are device pointers; `fields` must be 16-byte aligned with rows
// of 12 floats.
int anchor_fwd(const float* fields, const int* sorted_gidx,
               const uint8_t* sorted_meta, const uint32_t* sorted_depth,
               const int* starts, int* tile_order,
               int width, int height, int gx, int gy, int c_max, int k_cap,
               int smem, float log_cut, float alpha_max, float log_eps,
               float* rgb, float* alpha, float* final_log_t, int* last_idx,
               int* ordered, int* k_used, int8_t* group,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int union_lanes = 2 * c_max * kChunk;
  const int stage_bytes = static_cast<int>(sizeof(PairStage<kFwdBatch>));
  const int key_bytes =
      union_lanes * 8 > stage_bytes ? union_lanes * 8 : stage_bytes;
  if (smem != key_bytes + k_cap * 4)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(anchor_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_tiles = gx * gy;
  if (num_tiles > 0) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    heavy_first_order<<<1, kOrderThreads, 0, st>>>(
        CoverWeight{starts, gx, num_tiles, c_max}, num_tiles, union_lanes,
        tile_order);
    anchor_fwd_kernel<<<num_tiles, kPix, smem, st>>>(
        fields, sorted_gidx, sorted_meta, sorted_depth, starts, tile_order,
        width, height, gx, num_tiles, c_max, k_cap, key_bytes, log_cut,
        alpha_max, log_eps, rgb, alpha, final_log_t, last_idx, ordered,
        k_used, group);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* anchor_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
