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
// Design: one CTA per tile, 256 threads. The merge walks both ranges'
// covers with the threads strided over positions (coalesced 1- and 4-byte
// loads of meta and depth), and each touched entry appends a unique 64-bit
// key (depth << 32 | union lane) to shared memory through a shared counter.
// A block-wide bitonic sort orders the n_live keys, padded to the next
// power of two, so a tile sorts only what touches it. The keys are unique,
// so any correct sort gives the JAX rank's order, and the append order
// does not matter. The composite then runs kernel A's loop
// (raster_fwd.cu): batches of 256 pairs staged in shared memory, the six
// rows of the bilinear form per pair, one thread per pixel, a block-wide
// early exit. A batch stage gathers each pair's 48-byte field row through
// its entry's gaussian id.
//
// Bounds on the card: the composite's per pair-pixel work is kernel A's
// (~20 FP32 operations and three transcendentals out of shared memory), so
// FP32/SFU issue and load imbalance between tiles bound it as they bound A;
// the merge adds per tile a pass over the union (5 bytes per position) and
// a sort of n_live keys, log2(n)^2/2 barrier steps. Device memory sees the
// union loads, one field row per kept pair and the outputs.
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

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;  // threads per CTA, one per pixel
constexpr int kBatch = kPix;         // pairs staged per step, one per thread
constexpr int kRow = 12;             // floats per splat row of `fields`
constexpr int kChunk = 256;          // positions per cover chunk

struct Range {
  int base, s0, sb, end;  // cover base, first position, column split, end
};

__device__ Range tile_range(const int* starts, int row, int tx, int gx,
                            int num_tiles, int c_max, bool present) {
  Range r = {0, 0, 0, 0};
  if (!present) return r;
  const int j = row * gx;
  r.s0 = starts[min(j + max(tx - 1, 0), num_tiles)];
  r.sb = starts[min(j + tx, num_tiles)];
  const int s1 = starts[min(j + tx + 1, num_tiles)];
  r.base = (r.s0 / kChunk) * kChunk;
  r.end = min(s1, r.base + c_max * kChunk);
  return r;
}

__global__ void __launch_bounds__(kPix)
anchor_fwd_kernel(const float* __restrict__ fields,
                  const int* __restrict__ sorted_gidx,
                  const uint8_t* __restrict__ sorted_meta,
                  const uint32_t* __restrict__ sorted_depth,
                  const int* __restrict__ starts,
                  int width, int height, int gx, int num_tiles, int c_max,
                  int k_cap, int key_cap,
                  float log_cut, float alpha_max, float log_eps,
                  float* __restrict__ rgb, float* __restrict__ alpha,
                  float* __restrict__ final_log_t, int* __restrict__ last_idx,
                  int* __restrict__ ordered, int* __restrict__ k_used,
                  int8_t* __restrict__ group) {
  extern __shared__ __align__(16) unsigned long long s_keys[];  // key_cap
  float4* s_v0123 = reinterpret_cast<float4*>(s_keys + key_cap);  // v0..v3
  float4* s_v45rg = s_v0123 + kBatch;  // rows v4, v5 and colour r, g
  float* s_b = reinterpret_cast<float*>(s_v45rg + kBatch);  // colour b
  __shared__ int s_n;

  const int tile = blockIdx.x;
  const int tx = tile % gx;
  const int ty = tile / gx;
  const int tid = threadIdx.x;
  const int half = c_max * kChunk;  // union lanes of one range

  // --- merge: touched entries of both covers → unique keys --------------
  const Range ra = tile_range(starts, ty - 1, tx, gx, num_tiles, c_max, ty > 0);
  const Range rb = tile_range(starts, ty, tx, gx, num_tiles, c_max, true);
  if (tid == 0) s_n = 0;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const Range r = q ? rb : ra;
    for (int pos = r.s0 + tid; pos < r.end; pos += kPix) {
      const int meta = sorted_meta[pos];
      const bool dup = meta & 4, wide = meta & 2, tall = meta & 1;
      const bool own_col = pos >= r.sb;
      const bool ok_col = own_col || wide;
      const bool touch = q ? (dup ? own_col : ok_col) : (!dup && ok_col && tall);
      if (touch) {
        const unsigned lane = q * half + (pos - r.base);
        s_keys[atomicAdd(&s_n, 1)] =
            (static_cast<unsigned long long>(sorted_depth[pos]) << 32) | lane;
      }
    }
  }
  __syncthreads();
  const int n_live = s_n;
  int n_sort = 1;
  while (n_sort < n_live) n_sort <<= 1;
  for (int i = n_live + tid; i < n_sort; i += kPix) s_keys[i] = ~0ull;
  __syncthreads();
  // block-wide bitonic sort, ascending
  for (int k = 2; k <= n_sort; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < n_sort; i += kPix) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = s_keys[i], b = s_keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            s_keys[i] = b;
            s_keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const int count = min(n_live, k_cap);
  for (int k = tid; k < k_cap; k += kPix) {
    int pos = -1, grp = 0;
    if (k < count) {
      const int lane = static_cast<int>(static_cast<uint32_t>(s_keys[k]));
      const int q = lane >= half;
      pos = (q ? rb.base - half : ra.base) + lane;
      grp = q * 2 + (tx & 1);
    }
    ordered[static_cast<size_t>(tile) * k_cap + k] = pos;
    group[static_cast<size_t>(tile) * k_cap + k] = static_cast<int8_t>(grp);
  }
  if (tid == 0) k_used[tile] = count;

  // --- composite: kernel A's walk over the ordered list -----------------
  const int lx = tid % kTile;
  const int ly = tid / kTile;
  const int x = tx * kTile + lx;
  const int y = ty * kTile + ly;
  const bool inside = x < width && y < height;
  const float px = static_cast<float>(lx);
  const float py = static_cast<float>(ly);
  const float pxx = px * px, pyy = py * py, pxy = px * py;
  const float ox = static_cast<float>(tx * kTile);
  const float oy = static_cast<float>(ty * kTile);

  float log_t = 0.f;
  float acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_a = 0.f;
  int last = -1;
  bool done = !inside;

  for (int b0 = 0; b0 < count; b0 += kBatch) {
    // also the barrier that lets this batch overwrite the previous one
    if (__syncthreads_count(done) == kPix) break;
    const int j = b0 + tid;
    if (j < count) {
      const int lane = static_cast<int>(static_cast<uint32_t>(s_keys[j]));
      const int pos = lane >= half ? rb.base - half + lane : ra.base + lane;
      const int g = sorted_gidx[pos];
      const float4* row =
          reinterpret_cast<const float4*>(fields + static_cast<size_t>(g) * kRow);
      const float4 f0 = row[0];  // mx, my, conic a, conic b
      const float4 f1 = row[1];  // conic c, r, g, b
      const float4 f2 = row[2];  // opacity, 0, 0, 0
      const float mx = __fsub_rn(f0.x, ox);
      const float my = __fsub_rn(f0.y, oy);
      const float ca = f0.z, cb = f0.w, cc = f1.x;
      // v0 = log(op) - ((0.5 ca mx mx + cb mx my) + 0.5 cc my my)
      const float qa = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, ca), mx), mx);
      const float qb = __fmul_rn(__fmul_rn(cb, mx), my);
      const float qc = __fmul_rn(__fmul_rn(__fmul_rn(0.5f, cc), my), my);
      const float v0 = __fsub_rn(logf(fmaxf(f2.x, 1e-30f)),
                                 __fadd_rn(__fadd_rn(qa, qb), qc));
      const float v1 = __fadd_rn(__fmul_rn(ca, mx), __fmul_rn(cb, my));
      const float v2 = __fadd_rn(__fmul_rn(cc, my), __fmul_rn(cb, mx));
      s_v0123[tid] = make_float4(v0, v1, v2, __fmul_rn(-0.5f, ca));
      s_v45rg[tid] = make_float4(__fmul_rn(-0.5f, cc), -cb, f1.y, f1.z);
      s_b[tid] = f1.w;
    }
    __syncthreads();

    if (!done) {
      const int n = min(kBatch, count - b0);
      for (int i = 0; i < n; ++i) {
        const float4 va = s_v0123[i];
        const float4 vb = s_v45rg[i];
        float power = __fadd_rn(va.x, __fmul_rn(va.y, px));
        power = __fadd_rn(power, __fmul_rn(va.z, py));
        power = __fadd_rn(power, __fmul_rn(va.w, pxx));
        power = __fadd_rn(power, __fmul_rn(vb.x, pyy));
        power = __fadd_rn(power, __fmul_rn(vb.y, pxy));
        // alpha = 0 (also for a NaN power, as in the plain version)
        if (!(power >= log_cut)) continue;
        const float a = fminf(expf(power), alpha_max);
        const float log1m = log1pf(-a);
        const float log_t_incl = __fadd_rn(log_t, log1m);
        if (log_t_incl < log_eps) {
          done = true;
          break;
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

// Launches kernel C on `stream` of `device` over gx * gy tiles with `smem`
// bytes of dynamic shared memory (the sort keys, 8 bytes for each union
// lane padded to a power of two, then the 9,216-byte batch stage) and
// returns the first CUDA error (0 on success). Pointers are device
// pointers; `fields` must be 16-byte aligned with rows of 12 floats.
int anchor_fwd(const float* fields, const int* sorted_gidx,
               const uint8_t* sorted_meta, const uint32_t* sorted_depth,
               const int* starts,
               int width, int height, int gx, int gy, int c_max, int k_cap,
               int smem, float log_cut, float alpha_max, float log_eps,
               float* rgb, float* alpha, float* final_log_t, int* last_idx,
               int* ordered, int* k_used, int8_t* group,
               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int union_lanes = 2 * c_max * kChunk;
  int key_cap = 1;
  while (key_cap < union_lanes) key_cap <<= 1;
  const int need = key_cap * 8 + kBatch * 36;
  if (smem != need) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(anchor_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int num_tiles = gx * gy;
  if (num_tiles > 0) {
    anchor_fwd_kernel<<<num_tiles, kPix, smem,
                        static_cast<cudaStream_t>(stream)>>>(
        fields, sorted_gidx, sorted_meta, sorted_depth, starts, width, height,
        gx, num_tiles, c_max, k_cap, key_cap, log_cut, alpha_max, log_eps,
        rgb, alpha, final_log_t, last_idx, ordered, k_used, group);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* anchor_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
