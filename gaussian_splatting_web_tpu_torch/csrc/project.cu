// Kernels P fwd and P bwd: the projection layer for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's projection (gaussian_splatting_
// web_tpu/ops/projection.py and ops/sh.py) is XLA, and the port's first
// version was an autograd graph of some 1,050 elementwise ops and 3x3
// batched GEMMs. P fwd computes, one thread per Gaussian, what the plain
// twin ops/projection.py::project_gaussians_plain computes: quaternion
// normalise, R S and Sigma_3D, the view and clip transform with the
// clip_w > 0.2 cull, the FOV clamp, J W Sigma W^T J^T with the low-pass
// term, the conic, SH colour of degree 0-3 (+0.5, clamped at 0), the
// sigmoid, the opacity-aware radius and the on-screen test. P bwd
// recomputes those intermediates from the same inputs and applies the chain
// rule by hand (its plain twin is ops/projection.py::project_backward_plain):
// gradient goes only to the taken branch of each select (the cull, det > 0),
// through each clamp on its closed interval, and not at all through the
// radius and `valid`. Every output row belongs to one Gaussian: no atomics.
//
// What bounds it on this card: bytes. A Gaussian reads 236 B (xyz,
// log-scale, quaternion, opacity logit and 16x3 SH) and writes 45 B
// forward; the backward reads the 236 B and 36 B of output gradients and
// writes 236 B. The arithmetic, some 600 FP32 operations a Gaussian
// backward, is a small fraction of what the card issues in that time.
//
// Design: the [N, K, 3] SH rows are most of the bytes (192 B a Gaussian at
// degree 3, and as much again for their gradient). A block of 128 threads
// copies its 128 rows, one contiguous chunk, with coalesced 16-byte loads
// into shared memory (a thread reading its own 192-byte row straight from
// device memory would touch 32 sectors per warp load and use half of each);
// rows whose length is a multiple of four floats are padded to an odd
// number of float4s there, so a thread's 16-byte reads of its own row hit
// distinct banks. The backward writes each gradient row into the thread's
// own slot and the block stores the chunk back with coalesced 16-byte
// stores. The 3x3 algebra stays in registers: no shared memory and no GEMM.
// The camera (view, proj @ view, position, focals, FOV tangents, scale
// modifier) arrives as 40 floats on the device, read into shared memory by
// each block, so no camera value is read on the host. The SH degree is a
// template on K in {1, 4, 9, 16}.
//
// Numerics: IEEE expf, logf, sqrtf and division (no -use_fast_math): the
// radius's ceil and the 1/255 cutoff depend on them. Sums are taken in
// another order than the twin's GEMMs, so values agree to float32 rounding,
// not bit for bit.

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kThreads = 128;   // Gaussians per block
constexpr int kBatch = 4;       // 16-byte loads a thread keeps in flight
// the packed camera (ops/projection.py::pack_camera)
constexpr int kCamFloats = 40;
constexpr int kView = 0;        // view [4, 4] row-major
constexpr int kViewProj = 16;   // proj @ view [4, 4] row-major
constexpr int kCamPos = 32;
constexpr int kFocal = 35;
constexpr int kTanFov = 37;
constexpr int kScaleMod = 39;

constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC20 = 1.0925484305920792f;
constexpr float kC21 = -1.0925484305920792f;
constexpr float kC22 = 0.31539156525252005f;
constexpr float kC23 = -1.0925484305920792f;
constexpr float kC24 = 0.5462742152960396f;
constexpr float kC30 = -0.5900435899266435f;
constexpr float kC31 = 2.890611442640554f;
constexpr float kC32 = -0.4570457994644658f;
constexpr float kC33 = 0.3731763325901154f;
constexpr float kC34 = -0.4570457994644658f;
constexpr float kC35 = 1.445305721320277f;
constexpr float kC36 = -0.5900435899266435f;

struct Consts {          // RenderConfig's floats and the frame size
  int width, height;
  float fov_clamp, lowpass, alpha_cutoff, radius_sigma, max_radius;
};

// Shared-memory row stride, in floats, of a K3-float SH row: a row of a
// multiple of four floats is padded to an odd number of float4s (eight
// threads' 16-byte reads of their own rows then hit distinct banks); an odd
// row length is kept (32 threads' scalar reads already do). Either way the
// four floats of every aligned group of the chunk land in four consecutive,
// 16-byte aligned slots.
template <int K3>
__host__ __device__ constexpr int row_stride() {
  return K3 % 4 == 0 ? 4 * ((K3 / 4) | 1) : K3;
}

template <int K3>
__device__ __forceinline__ int slot(int f) {
  constexpr int S = row_stride<K3>();
  return S == K3 ? f : (f / K3) * S + f % K3;
}

// The block's `count` floats of SH rows, starting 16-byte aligned at `src`,
// into shared memory at their slots.
template <int K3>
__device__ __forceinline__ void stage_in(const float* __restrict__ src,
                                         int count, float* dst) {
  const int n4 = count / 4;
  const float4* src4 = reinterpret_cast<const float4*>(src);
  for (int j0 = threadIdx.x; j0 < n4; j0 += kBatch * kThreads) {
    float4 v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = j0 + b * kThreads;
      if (j < n4) v[b] = __ldg(src4 + j);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int j = j0 + b * kThreads;
      if (j < n4) *reinterpret_cast<float4*>(dst + slot<K3>(4 * j)) = v[b];
    }
  }
  for (int f = 4 * n4 + threadIdx.x; f < count; f += kThreads)
    dst[slot<K3>(f)] = __ldg(src + f);
}

// The inverse of stage_in: shared slots to `count` floats at `dst`.
template <int K3>
__device__ __forceinline__ void stage_out(const float* src, int count,
                                          float* __restrict__ dst) {
  const int n4 = count / 4;
  float4* dst4 = reinterpret_cast<float4*>(dst);
  for (int j = threadIdx.x; j < n4; j += kThreads)
    dst4[j] = *reinterpret_cast<const float4*>(src + slot<K3>(4 * j));
  for (int f = 4 * n4 + threadIdx.x; f < count; f += kThreads)
    dst[f] = src[slot<K3>(f)];
}

template <int K3>
__device__ __forceinline__ void load_row(const float* row, float (&v)[K3]) {
  if constexpr (K3 % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K3 / 4; ++j) {
      const float4 q = reinterpret_cast<const float4*>(row)[j];
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K3; ++j) v[j] = row[j];
  }
}

template <int K3>
__device__ __forceinline__ void store_row(float* row, const float (&v)[K3]) {
  if constexpr (K3 % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K3 / 4; ++j)
      reinterpret_cast<float4*>(row)[j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < K3; ++j) row[j] = v[j];
  }
}

// One Gaussian's inputs other than SH.
struct Gaussian {
  float p[3], ls[3], q[4], ol;
};

__device__ __forceinline__ Gaussian load_gaussian(
    const float* __restrict__ xyz, const float* __restrict__ log_scale,
    const float* __restrict__ quat, const float* __restrict__ opacity_logit,
    int i) {
  Gaussian g;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g.p[a] = __ldg(xyz + 3 * static_cast<size_t>(i) + a);
    g.ls[a] = __ldg(log_scale + 3 * static_cast<size_t>(i) + a);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
    g.q[a] = __ldg(quat + 4 * static_cast<size_t>(i) + a);
  g.ol = __ldg(opacity_logit + i);
  return g;
}

// The forward's geometry of one Gaussian: everything up to the conic, kept
// for the backward's chain rule.
struct Geometry {
  float t[3];                 // camera space; depth = t[2]
  float clip[2], safe_w, ndc[2];
  bool in_front;
  float s[3];                 // exp(log_scale) * scale_modifier
  float qn[4], qnorm;         // normalised quaternion, its divisor
  bool q_ok;                  // |q|^2 passed the 1e-24 clamp
  float R[3][3];
  float cov[6];               // Sigma_3D: 00 01 02 11 12 22
  float tz, rx, ry, cx, cy, tx, ty, inv_z, inv_z2;
  bool x_in, y_in;            // the FOV clamp left t.x/tz, t.y/tz alone
  float u0[3], u1[3];         // rows of J W
  float su0[3], su1[3];       // Sigma u0, Sigma u1
  float a, b, c, det, inv_det;
  bool det_ok;
};

__device__ __forceinline__ float row_dot(const float* m, const float* p) {
  return fmaf(m[2], p[2], fmaf(m[1], p[1], m[0] * p[0])) + m[3];
}

__device__ __forceinline__ void sym_mul(const float* cov, const float* u,
                                        float* out) {
  out[0] = cov[0] * u[0] + cov[1] * u[1] + cov[2] * u[2];
  out[1] = cov[1] * u[0] + cov[3] * u[1] + cov[4] * u[2];
  out[2] = cov[2] * u[0] + cov[4] * u[1] + cov[5] * u[2];
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void geometry(const float* cam, const Gaussian& in,
                                         const Consts& k, Geometry& g) {
  const float* V = cam + kView;
  const float* PV = cam + kViewProj;
#pragma unroll
  for (int a = 0; a < 3; ++a) g.t[a] = row_dot(V + 4 * a, in.p);
  g.clip[0] = row_dot(PV, in.p);
  g.clip[1] = row_dot(PV + 4, in.p);
  const float clip_w = row_dot(PV + 12, in.p);
  g.in_front = clip_w > 0.2f;
  g.safe_w = g.in_front ? clip_w : 1.0f;
  g.ndc[0] = g.clip[0] / g.safe_w;
  g.ndc[1] = g.clip[1] / g.safe_w;

  const float sm = cam[kScaleMod];
#pragma unroll
  for (int a = 0; a < 3; ++a) g.s[a] = expf(in.ls[a]) * sm;
  const float q2 = in.q[0] * in.q[0] + in.q[1] * in.q[1] +
                   in.q[2] * in.q[2] + in.q[3] * in.q[3];
  g.q_ok = q2 >= 1e-24f;
  g.qnorm = sqrtf(fmaxf(q2, 1e-24f));
#pragma unroll
  for (int a = 0; a < 4; ++a) g.qn[a] = in.q[a] / g.qnorm;
  const float x = g.qn[0], y = g.qn[1], z = g.qn[2], w = g.qn[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  g.R[0][0] = 1.0f - 2.0f * (yy + zz);
  g.R[0][1] = 2.0f * (xy - wz);
  g.R[0][2] = 2.0f * (xz + wy);
  g.R[1][0] = 2.0f * (xy + wz);
  g.R[1][1] = 1.0f - 2.0f * (xx + zz);
  g.R[1][2] = 2.0f * (yz - wx);
  g.R[2][0] = 2.0f * (xz - wy);
  g.R[2][1] = 2.0f * (yz + wx);
  g.R[2][2] = 1.0f - 2.0f * (xx + yy);
  float M[3][3];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[r][j] = g.R[r][j] * g.s[j];
  g.cov[0] = dot3(M[0], M[0]);
  g.cov[1] = dot3(M[0], M[1]);
  g.cov[2] = dot3(M[0], M[2]);
  g.cov[3] = dot3(M[1], M[1]);
  g.cov[4] = dot3(M[1], M[2]);
  g.cov[5] = dot3(M[2], M[2]);

  g.tz = g.in_front ? g.t[2] : 1.0f;
  const float lim_x = k.fov_clamp * cam[kTanFov];
  const float lim_y = k.fov_clamp * cam[kTanFov + 1];
  g.rx = g.t[0] / g.tz;
  g.ry = g.t[1] / g.tz;
  g.x_in = g.rx >= -lim_x && g.rx <= lim_x;
  g.y_in = g.ry >= -lim_y && g.ry <= lim_y;
  g.cx = fminf(fmaxf(g.rx, -lim_x), lim_x);
  g.cy = fminf(fmaxf(g.ry, -lim_y), lim_y);
  g.tx = g.cx * g.tz;
  g.ty = g.cy * g.tz;
  const float fx = cam[kFocal], fy = cam[kFocal + 1];
  g.inv_z = 1.0f / g.tz;
  g.inv_z2 = g.inv_z * g.inv_z;
  const float j00 = fx * g.inv_z;
  const float j02 = -fx * g.tx * g.inv_z2;
  const float j11 = fy * g.inv_z;
  const float j12 = -fy * g.ty * g.inv_z2;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    g.u0[a] = j00 * V[a] + j02 * V[8 + a];
    g.u1[a] = j11 * V[4 + a] + j12 * V[8 + a];
  }
  sym_mul(g.cov, g.u0, g.su0);
  sym_mul(g.cov, g.u1, g.su1);
  g.a = dot3(g.u0, g.su0) + k.lowpass;
  g.b = dot3(g.u0, g.su1);
  g.c = dot3(g.u1, g.su1) + k.lowpass;
  g.det = g.a * g.c - g.b * g.b;
  g.det_ok = g.det > 0.0f;
  g.inv_det = 1.0f / (g.det_ok ? g.det : 1.0f);
}

// The unit view direction from the camera centre, and whether its norm
// passed the 1e-12 clamp.
__device__ __forceinline__ float direction(const float* cam, const float* p,
                                           float (&dir)[3], bool& ok) {
  float v[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) v[a] = p[a] - cam[kCamPos + a];
  const float norm = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  ok = norm >= 1e-12f;
  const float nv = fmaxf(norm, 1e-12f);
#pragma unroll
  for (int a = 0; a < 3; ++a) dir[a] = v[a] / nv;
  return nv;
}

template <int K>
__device__ __forceinline__ void sh_basis(const float (&d)[3], float (&B)[K]) {
  const float x = d[0], y = d[1], z = d[2];
  B[0] = kC0;
  if constexpr (K > 1) {
    B[1] = -kC1 * y;
    B[2] = kC1 * z;
    B[3] = -kC1 * x;
  }
  if constexpr (K > 4) {
    const float xx = x * x, yy = y * y, zz = z * z;
    B[4] = kC20 * (x * y);
    B[5] = kC21 * (y * z);
    B[6] = kC22 * (2.0f * zz - xx - yy);
    B[7] = kC23 * (x * z);
    B[8] = kC24 * (xx - yy);
    if constexpr (K > 9) {
      B[9] = kC30 * y * (3.0f * xx - yy);
      B[10] = kC31 * (x * y) * z;
      B[11] = kC32 * y * (4.0f * zz - xx - yy);
      B[12] = kC33 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      B[13] = kC34 * x * (4.0f * zz - xx - yy);
      B[14] = kC35 * z * (xx - yy);
      B[15] = kC36 * x * (xx - 3.0f * yy);
    }
  }
}

// d(colour)/d(dir) given e[k] = sum_c d_res[c] sh[k][c].
template <int K>
__device__ __forceinline__ void sh_dir_grad(const float (&d)[3],
                                            const float (&e)[K],
                                            float (&g)[3]) {
  const float x = d[0], y = d[1], z = d[2];
  g[0] = g[1] = g[2] = 0.0f;
  if constexpr (K > 1) {
    g[0] -= kC1 * e[3];
    g[1] -= kC1 * e[1];
    g[2] += kC1 * e[2];
  }
  if constexpr (K > 4) {
    g[0] += kC20 * y * e[4] - 2.0f * kC22 * x * e[6] + kC23 * z * e[7] +
            2.0f * kC24 * x * e[8];
    g[1] += kC20 * x * e[4] + kC21 * z * e[5] - 2.0f * kC22 * y * e[6] -
            2.0f * kC24 * y * e[8];
    g[2] += kC21 * y * e[5] + 4.0f * kC22 * z * e[6] + kC23 * x * e[7];
    if constexpr (K > 9) {
      const float xx = x * x, yy = y * y, zz = z * z;
      g[0] += kC30 * 6.0f * x * y * e[9] + kC31 * y * z * e[10] -
              kC32 * 2.0f * x * y * e[11] - kC33 * 6.0f * x * z * e[12] +
              kC34 * (4.0f * zz - 3.0f * xx - yy) * e[13] +
              kC35 * 2.0f * x * z * e[14] +
              kC36 * (3.0f * xx - 3.0f * yy) * e[15];
      g[1] += kC30 * (3.0f * xx - 3.0f * yy) * e[9] + kC31 * x * z * e[10] +
              kC32 * (4.0f * zz - xx - 3.0f * yy) * e[11] -
              kC33 * 6.0f * y * z * e[12] - kC34 * 2.0f * x * y * e[13] -
              kC35 * 2.0f * y * z * e[14] - kC36 * 6.0f * x * y * e[15];
      g[2] += kC31 * x * y * e[10] + kC32 * 8.0f * y * z * e[11] +
              kC33 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * e[12] +
              kC34 * 8.0f * x * z * e[13] + kC35 * (xx - yy) * e[14];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ log_scale,
                   const float* __restrict__ quat,
                   const float* __restrict__ opacity_logit,
                   const float* __restrict__ sh,
                   const float* __restrict__ cam_g, int n, Consts k,
                   float2* __restrict__ mean2d, float* __restrict__ conic,
                   float* __restrict__ depth, float* __restrict__ radius,
                   float* __restrict__ rgb, float* __restrict__ opacity,
                   bool* __restrict__ valid) {
  constexpr int K3 = 3 * K;
  __shared__ __align__(16) float rows[kThreads * row_stride<K3>()];
  __shared__ float cam[kCamFloats];
  const int base = blockIdx.x * kThreads;
  const int count = min(kThreads, n - base) * K3;
  if (threadIdx.x < kCamFloats) cam[threadIdx.x] = __ldg(cam_g + threadIdx.x);
  stage_in<K3>(sh + static_cast<size_t>(base) * K3, count, rows);
  __syncthreads();
  const int i = base + threadIdx.x;
  if (i >= n) return;

  const Gaussian in = load_gaussian(xyz, log_scale, quat, opacity_logit, i);
  Geometry g;
  geometry(cam, in, k, g);
  const float mx =
      ((g.ndc[0] + 1.0f) * static_cast<float>(k.width) - 1.0f) * 0.5f;
  const float my =
      ((g.ndc[1] + 1.0f) * static_cast<float>(k.height) - 1.0f) * 0.5f;
  mean2d[i] = make_float2(mx, my);
  conic[3 * static_cast<size_t>(i)] = g.c * g.inv_det;
  conic[3 * static_cast<size_t>(i) + 1] = -g.b * g.inv_det;
  conic[3 * static_cast<size_t>(i) + 2] = g.a * g.inv_det;
  depth[i] = g.t[2];

  float dir[3];
  bool dir_ok;
  direction(cam, in.p, dir, dir_ok);
  float B[K];
  sh_basis<K>(dir, B);
  float v[K3];
  load_row<K3>(rows + threadIdx.x * row_stride<K3>(), v);
  float res[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int c = 0; c < 3; ++c) res[c] = fmaf(B[j], v[3 * j + c], res[c]);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    rgb[3 * static_cast<size_t>(i) + c] = fmaxf(res[c] + 0.5f, 0.0f);
  const float op = 1.0f / (1.0f + expf(-in.ol));
  opacity[i] = op;

  const float mid = 0.5f * (g.a + g.c);
  const float lam1 = mid + sqrtf(fmaxf(mid * mid - g.det, 0.1f));
  float r;
  if (k.radius_sigma > 0.0f) {
    r = ceilf(k.radius_sigma * sqrtf(lam1));
  } else {
    const float log_ratio = logf(fmaxf(op, k.alpha_cutoff) / k.alpha_cutoff);
    r = ceilf(sqrtf(2.0f * lam1 * log_ratio));
  }
  r = fminf(r, k.max_radius);
  const bool on_screen = mx + r >= 0.0f && mx - r < k.width &&
                         my + r >= 0.0f && my - r < k.height;
  const bool ok = g.in_front && g.det_ok && r > 0.0f && on_screen;
  radius[i] = ok ? r : 0.0f;
  valid[i] = ok;
}

// The upstream gradient `d` at [i * w + c], or 0 when it is absent.
__device__ __forceinline__ float grad_at(const float* __restrict__ d,
                                         size_t at) {
  return d == nullptr ? 0.0f : __ldg(d + at);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(const float* __restrict__ xyz,
                   const float* __restrict__ log_scale,
                   const float* __restrict__ quat,
                   const float* __restrict__ opacity_logit,
                   const float* __restrict__ sh,
                   const float* __restrict__ cam_g,
                   const float* __restrict__ d_mean2d,
                   const float* __restrict__ d_conic,
                   const float* __restrict__ d_depth,
                   const float* __restrict__ d_rgb,
                   const float* __restrict__ d_opacity, int n, Consts k,
                   float* __restrict__ d_xyz, float* __restrict__ d_log_scale,
                   float* __restrict__ d_quat,
                   float* __restrict__ d_opacity_logit,
                   float* __restrict__ d_sh) {
  constexpr int K3 = 3 * K;
  __shared__ __align__(16) float rows[kThreads * row_stride<K3>()];
  __shared__ float cam[kCamFloats];
  const int base = blockIdx.x * kThreads;
  const int count = min(kThreads, n - base) * K3;
  if (threadIdx.x < kCamFloats) cam[threadIdx.x] = __ldg(cam_g + threadIdx.x);
  stage_in<K3>(sh + static_cast<size_t>(base) * K3, count, rows);
  __syncthreads();
  const int i = base + threadIdx.x;
  if (i < n) {
    const size_t i2 = 2 * static_cast<size_t>(i);
    const size_t i3 = 3 * static_cast<size_t>(i);
    const Gaussian in = load_gaussian(xyz, log_scale, quat, opacity_logit, i);
    Geometry g;
    geometry(cam, in, k, g);
    const float* V = cam + kView;
    const float* PV = cam + kViewProj;
    const float fx = cam[kFocal], fy = cam[kFocal + 1];

    // appearance: opacity, then SH colour (pass 1 forms the colour for its
    // clamp, pass 2 the gradients of the row and of the direction)
    const float op = 1.0f / (1.0f + expf(-in.ol));
    d_opacity_logit[i] = grad_at(d_opacity, i) * (1.0f - op) * op;
    float dir[3];
    bool dir_ok;
    const float nv = direction(cam, in.p, dir, dir_ok);
    float B[K];
    sh_basis<K>(dir, B);
    float* row = rows + threadIdx.x * row_stride<K3>();
    float v[K3];
    load_row<K3>(row, v);
    float d_res[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float res = 0.0f;
#pragma unroll
      for (int j = 0; j < K; ++j) res = fmaf(B[j], v[3 * j + c], res);
      d_res[c] = res + 0.5f >= 0.0f ? grad_at(d_rgb, i3 + c) : 0.0f;
    }
    float e[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      e[j] = d_res[0] * v[3 * j] + d_res[1] * v[3 * j + 1] +
             d_res[2] * v[3 * j + 2];
#pragma unroll
      for (int c = 0; c < 3; ++c) v[3 * j + c] = B[j] * d_res[c];
    }
    store_row<K3>(row, v);
    float d_dir[3];
    sh_dir_grad<K>(dir, e, d_dir);
    float d_p[3];
    const float dd = dir_ok ? dot3(d_dir, dir) : 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) d_p[a] = (d_dir[a] - dd * dir[a]) / nv;

    // conic (c, -b, a) / det
    const float gc0 = grad_at(d_conic, i3), gc1 = grad_at(d_conic, i3 + 1),
                gc2 = grad_at(d_conic, i3 + 2);
    float d_a = gc2 * g.inv_det, d_b = -gc1 * g.inv_det,
          d_c = gc0 * g.inv_det;
    const float d_inv = gc0 * g.c - gc1 * g.b + gc2 * g.a;
    const float d_det = g.det_ok ? -d_inv * g.inv_det * g.inv_det : 0.0f;
    d_a += d_det * g.c;
    d_c += d_det * g.a;
    d_b -= 2.0f * g.b * d_det;

    // a = u0 S u0, b = u0 S u1, c = u1 S u1
    float d_u0[3], d_u1[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      d_u0[a] = 2.0f * d_a * g.su0[a] + d_b * g.su1[a];
      d_u1[a] = 2.0f * d_c * g.su1[a] + d_b * g.su0[a];
    }
    const float* u0 = g.u0;
    const float* u1 = g.u1;
    // G = dSigma + dSigma^T of the packed upper triangle
    float G[3][3];
    G[0][0] = 2.0f * (d_a * u0[0] * u0[0] + d_b * u0[0] * u1[0] +
                      d_c * u1[0] * u1[0]);
    G[1][1] = 2.0f * (d_a * u0[1] * u0[1] + d_b * u0[1] * u1[1] +
                      d_c * u1[1] * u1[1]);
    G[2][2] = 2.0f * (d_a * u0[2] * u0[2] + d_b * u0[2] * u1[2] +
                      d_c * u1[2] * u1[2]);
    G[0][1] = G[1][0] = 2.0f * d_a * u0[0] * u0[1] +
                        d_b * (u0[0] * u1[1] + u0[1] * u1[0]) +
                        2.0f * d_c * u1[0] * u1[1];
    G[0][2] = G[2][0] = 2.0f * d_a * u0[0] * u0[2] +
                        d_b * (u0[0] * u1[2] + u0[2] * u1[0]) +
                        2.0f * d_c * u1[0] * u1[2];
    G[1][2] = G[2][1] = 2.0f * d_a * u0[1] * u0[2] +
                        d_b * (u0[1] * u1[2] + u0[2] * u1[1]) +
                        2.0f * d_c * u1[1] * u1[2];

    // u0 = j00 W0 + j02 W2, u1 = j11 W1 + j12 W2 (W the view's rotation)
    const float d_j00 = dot3(d_u0, V), d_j02 = dot3(d_u0, V + 8);
    const float d_j11 = dot3(d_u1, V + 4), d_j12 = dot3(d_u1, V + 8);
    float d_inv_z = fx * d_j00 + fy * d_j11;
    const float d_inv_z2 = -fx * g.tx * d_j02 - fy * g.ty * d_j12;
    const float d_tx = -fx * g.inv_z2 * d_j02;
    const float d_ty = -fy * g.inv_z2 * d_j12;
    d_inv_z += 2.0f * g.inv_z * d_inv_z2;
    float d_tz = -d_inv_z * g.inv_z * g.inv_z;
    d_tz += d_tx * g.cx + d_ty * g.cy;              // tx = clamp(rx) tz
    const float d_rx = g.x_in ? d_tx * g.tz : 0.0f;
    const float d_ry = g.y_in ? d_ty * g.tz : 0.0f;
    float d_t[3];
    d_t[0] = d_rx / g.tz;
    d_t[1] = d_ry / g.tz;
    d_tz -= (d_rx * g.rx + d_ry * g.ry) / g.tz;    // rx = t.x / tz
    d_t[2] = (g.in_front ? d_tz : 0.0f) + grad_at(d_depth, i);

    // mean2d = ((clip / w + 1) size - 1) / 2
    const float d_ndc0 = grad_at(d_mean2d, i2) * 0.5f * k.width;
    const float d_ndc1 = grad_at(d_mean2d, i2 + 1) * 0.5f * k.height;
    const float d_clip0 = d_ndc0 / g.safe_w, d_clip1 = d_ndc1 / g.safe_w;
    const float d_w = g.in_front
        ? -(d_ndc0 * g.ndc[0] + d_ndc1 * g.ndc[1]) / g.safe_w : 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      d_p[a] += V[a] * d_t[0] + V[4 + a] * d_t[1] + V[8 + a] * d_t[2] +
                PV[a] * d_clip0 + PV[4 + a] * d_clip1 + PV[12 + a] * d_w;
      d_xyz[i3 + a] = d_p[a];
    }

    // Sigma = M M^T, M = R diag(s)
    float dR[3][3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float d_s = 0.0f;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float d_m = G[r][0] * g.R[0][j] * g.s[j] +
                          G[r][1] * g.R[1][j] * g.s[j] +
                          G[r][2] * g.R[2][j] * g.s[j];
        dR[r][j] = d_m * g.s[j];
        d_s += d_m * g.R[r][j];
      }
      d_log_scale[i3 + j] = d_s * g.s[j];
    }
    const float x = g.qn[0], y = g.qn[1], z = g.qn[2], w = g.qn[3];
    float d_qn[4];
    d_qn[0] = 2.0f * (y * (dR[0][1] + dR[1][0]) + z * (dR[0][2] + dR[2][0]) +
                      w * (dR[2][1] - dR[1][2])) -
              4.0f * x * (dR[1][1] + dR[2][2]);
    d_qn[1] = 2.0f * (x * (dR[0][1] + dR[1][0]) + w * (dR[0][2] - dR[2][0]) +
                      z * (dR[1][2] + dR[2][1])) -
              4.0f * y * (dR[0][0] + dR[2][2]);
    d_qn[2] = 2.0f * (w * (dR[1][0] - dR[0][1]) + x * (dR[0][2] + dR[2][0]) +
                      y * (dR[1][2] + dR[2][1])) -
              4.0f * z * (dR[0][0] + dR[1][1]);
    d_qn[3] = 2.0f * (z * (dR[1][0] - dR[0][1]) + y * (dR[0][2] - dR[2][0]) +
                      x * (dR[2][1] - dR[1][2]));
    const float dq = g.q_ok ? d_qn[0] * x + d_qn[1] * y + d_qn[2] * z +
                                  d_qn[3] * w
                            : 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      d_quat[4 * static_cast<size_t>(i) + a] =
          (d_qn[a] - dq * g.qn[a]) / g.qnorm;
  }
  __syncthreads();
  stage_out<K3>(rows, count, d_sh + static_cast<size_t>(base) * K3);
}

// f(std::integral_constant<int, K>) for the SH coefficient count k.
template <typename F>
cudaError_t by_degree(int k, F&& f) {
  switch (k) {
    case 1: f(std::integral_constant<int, 1>{}); break;
    case 4: f(std::integral_constant<int, 4>{}); break;
    case 9: f(std::integral_constant<int, 9>{}); break;
    case 16: f(std::integral_constant<int, 16>{}); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launches P fwd on `stream` of `device` over n Gaussians whose SH rows hold
// k in {1, 4, 9, 16} coefficients: xyz [n, 3], log_scale [n, 3], quat
// [n, 4], opacity_logit [n], sh [n, k, 3] (16-byte aligned) and the packed
// camera cam [40] in, mean2d [n, 2], conic [n, 3], depth, radius, rgb
// [n, 3], opacity and valid [n] (bools) out. Returns cudaGetLastError() (0
// on success), cudaErrorInvalidValue for another k. Pointers are device
// pointers, every array float32 and contiguous.
int project_fwd(const float* xyz, const float* log_scale, const float* quat,
                const float* opacity_logit, const float* sh, const float* cam,
                int n, int k, int width, int height, float fov_clamp,
                float lowpass, float alpha_cutoff, float radius_sigma,
                float max_radius, float* mean2d, float* conic, float* depth,
                float* radius, float* rgb, float* opacity, bool* valid,
                int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Consts c{width, height, fov_clamp, lowpass, alpha_cutoff,
                 radius_sigma, max_radius};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaError_t bad = by_degree(k, [&](auto kk) {
    project_fwd_kernel<decltype(kk)::value><<<blocks, kThreads, 0, st>>>(
        xyz, log_scale, quat, opacity_logit, sh, cam, n, c,
        reinterpret_cast<float2*>(mean2d), conic, depth, radius, rgb,
        opacity, valid);
  });
  if (bad != cudaSuccess) return static_cast<int>(bad);
  return static_cast<int>(cudaGetLastError());
}

// Launches P bwd on `stream` of `device`: the inputs of project_fwd and the
// gradients of its outputs d_mean2d [n, 2], d_conic [n, 3], d_depth [n],
// d_rgb [n, 3], d_opacity [n] (any of them null: no gradient arrives there)
// in, the gradients of the inputs d_xyz [n, 3], d_log_scale [n, 3], d_quat
// [n, 4], d_opacity_logit [n] and d_sh [n, k, 3] (16-byte aligned) out,
// every element written. Returns as project_fwd.
int project_bwd(const float* xyz, const float* log_scale, const float* quat,
                const float* opacity_logit, const float* sh, const float* cam,
                const float* d_mean2d, const float* d_conic,
                const float* d_depth, const float* d_rgb,
                const float* d_opacity, int n, int k, int width, int height,
                float fov_clamp, float lowpass, float* d_xyz,
                float* d_log_scale, float* d_quat, float* d_opacity_logit,
                float* d_sh, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Consts c{width, height, fov_clamp, lowpass, 0.0f, 0.0f, 0.0f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (n + kThreads - 1) / kThreads;
  const cudaError_t bad = by_degree(k, [&](auto kk) {
    project_bwd_kernel<decltype(kk)::value><<<blocks, kThreads, 0, st>>>(
        xyz, log_scale, quat, opacity_logit, sh, cam, d_mean2d, d_conic,
        d_depth, d_rgb, d_opacity, n, c, d_xyz, d_log_scale, d_quat,
        d_opacity_logit, d_sh);
  });
  if (bad != cudaSuccess) return static_cast<int>(bad);
  return static_cast<int>(cudaGetLastError());
}

const char* project_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
