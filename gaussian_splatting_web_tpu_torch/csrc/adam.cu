// The optimizer's kernel: one Adam update of up to eight leaves in one
// launch (Hopper, sm_90a).
//
// Replaces no TPU kernel: the JAX package's Adam is optax's, which XLA
// fuses. The port's first optimizer was torch.optim.Adam, whose CUDA path
// (_multi_tensor_adam) runs, for each parameter group, eight foreach
// passes over memory (lerp_ on m; mul_ and addcmul_ on v; sqrt and div_
// into a temporary; add_ of eps; addcdiv_ on p), some 84 bytes of traffic
// a parameter float and well over a hundred launches a step.
//
// What bounds it on this card: bytes. An update needs 28 B a float: read
// p, g, m and v, write p, m and v. The arithmetic, a dozen FP32 operations
// with one square root and two divisions, is a small fraction of what the
// card issues in that time.
//
// Design: the leaves arrive as a table passed by value (kernel parameter
// space, no host-to-device copy), each leaf with its pointers, its element
// count and its own step size and bias correction, which the host computes
// from the leaf's step count. Every leaf is cut into blocks of kPerBlock
// floats; the table holds the blocks' prefix offsets, and a block finds its
// leaf by walking them. A thread of a full block of a 16-byte aligned leaf
// issues all of its 16-byte loads of g, m, v and p before any arithmetic
// (kVecs float4s of each: 8 loads in flight), then writes p, m and v once.
// The last block of a leaf, and every block of a leaf whose four arrays are
// not all 16-byte aligned, walks its floats one at a time. No temporary, no
// allocation, no host sync.
//
// Numerics: float32 throughout, IEEE sqrtf and division (no
// -use_fast_math), in torch's order, so the result tracks torch's Adam to
// an ulp or two:
//   m = lerp(m, g, 1 - beta1)            (torch's lerp formula)
//   v = beta2 v + (1 - beta2) g^2        (mul_, then addcmul_)
//   p = p - step_size m / (sqrt(v) / sqrt(bc2) + eps)
// with step_size = lr / (1 - beta1^t) and bc2 = 1 - beta2^t, formed in
// double on the host and rounded to float, as torch passes its scalars.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

// One leaf of an update, as ops/cuda/adam.py::_Leaf lays it out.
struct AdamLeaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;            // floats in each of the four arrays
  float step_size;        // lr / (1 - beta1^t)
  float bc2_sqrt;         // sqrt(1 - beta2^t)
  float weight;           // 1 - beta1, the lerp weight
  float beta2;
  float one_minus_beta2;
  float eps;
};

namespace {

constexpr int kMaxLeaves = 8;
constexpr int kThreads = 256;
constexpr int kVecs = 2;                       // float4s a thread
constexpr long long kPerBlock = 4LL * kThreads * kVecs;   // 2048 floats

struct Table {
  AdamLeaf leaf[kMaxLeaves];
  long long first_block[kMaxLeaves + 1];   // prefix offsets in blocks
  int leaves;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const AdamLeaf& L) {
  // torch's lerp: self + w (end - self) for |w| < 0.5, else
  // end - (end - self) (1 - w)
  const float d = g - m;
  m = fabsf(L.weight) < 0.5f ? fmaf(L.weight, d, m)
                             : fmaf(-d, 1.0f - L.weight, g);
  v = fmaf(L.one_minus_beta2, __fmul_rn(g, g), __fmul_rn(v, L.beta2));
  const float denom = __fadd_rn(__fdiv_rn(sqrtf(v), L.bc2_sqrt), L.eps);
  p = fmaf(-L.step_size, __fdiv_rn(m, denom), p);
}

__device__ __forceinline__ void update4(float4& p, const float4& g,
                                        float4& m, float4& v,
                                        const AdamLeaf& L) {
  update(p.x, g.x, m.x, v.x, L);
  update(p.y, g.y, m.y, v.y, L);
  update(p.z, g.z, m.z, v.z, L);
  update(p.w, g.w, m.w, v.w, L);
}

__global__ void __launch_bounds__(kThreads)
    adam_kernel(const __grid_constant__ Table t) {
  const long long b = blockIdx.x;
  int s = 0;
  while (s + 1 < t.leaves && b >= t.first_block[s + 1]) ++s;
  const AdamLeaf& L = t.leaf[s];
  const long long base = (b - t.first_block[s]) * kPerBlock;
  const long long count = min(kPerBlock, L.n - base);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(L.p) | reinterpret_cast<uintptr_t>(L.g) |
        reinterpret_cast<uintptr_t>(L.m) | reinterpret_cast<uintptr_t>(L.v)) &
       15) == 0;
  if (aligned && count == kPerBlock) {
    const long long at = base / 4 + threadIdx.x;
    float4* p4 = reinterpret_cast<float4*>(L.p) + at;
    const float4* g4 = reinterpret_cast<const float4*>(L.g) + at;
    float4* m4 = reinterpret_cast<float4*>(L.m) + at;
    float4* v4 = reinterpret_cast<float4*>(L.v) + at;
    float4 p[kVecs], g[kVecs], m[kVecs], v[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      g[k] = __ldg(g4 + k * kThreads);
      m[k] = m4[k * kThreads];
      v[k] = v4[k * kThreads];
      p[k] = p4[k * kThreads];
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      update4(p[k], g[k], m[k], v[k], L);
      p4[k * kThreads] = p[k];
      m4[k * kThreads] = m[k];
      v4[k * kThreads] = v[k];
    }
    return;
  }
  for (long long i = base + threadIdx.x; i < base + count; i += kThreads) {
    float p = L.p[i], m = L.m[i], v = L.v[i];
    update(p, __ldg(L.g + i), m, v, L);
    L.p[i] = p;
    L.m[i] = m;
    L.v[i] = v;
  }
}

}  // namespace

extern "C" {

// Launches one Adam update on `stream` of `device` over the `num_leaves`
// (1 to 8) leaves of the host array `leaves`, read before the launch
// returns. Each leaf's p, g, m and v are device pointers to n contiguous
// float32s; p, m and v are updated in place. Returns cudaGetLastError() (0
// on success), cudaErrorInvalidValue for a count of leaves outside 1-8, a
// negative n or more blocks than a grid holds.
int adam(const AdamLeaf* leaves, int num_leaves, int device, void* stream) {
  if (num_leaves < 1 || num_leaves > kMaxLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Table t{};
  t.leaves = num_leaves;
  long long blocks = 0;
  for (int i = 0; i < num_leaves; ++i) {
    if (leaves[i].n < 0) return static_cast<int>(cudaErrorInvalidValue);
    t.leaf[i] = leaves[i];
    t.first_block[i] = blocks;
    blocks += (leaves[i].n + kPerBlock - 1) / kPerBlock;
  }
  t.first_block[num_leaves] = blocks;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  adam_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(t);
  return static_cast<int>(cudaGetLastError());
}

const char* adam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
