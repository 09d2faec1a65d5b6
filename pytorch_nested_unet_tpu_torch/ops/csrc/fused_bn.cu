// Training-mode BatchNorm + ReLU over the (rows, C) view of an NHWC tensor:
// the batch statistics (K1), the backward reduction (K2) and the backward dx
// pass (K3).
//
// Replaces: pytorch_nested_unet_tpu/ops/fused_bn.py
//   K1 bn_stats (pallas_call at :156, body _stats_kernel :87-97): per-channel
//      sum x and sum x^2 in f32;
//   K2 _bwd_rule (pallas_call at :260, body _bwd_reduce_kernel :114-124 with
//      _dz_common :100-111): recompute xhat = (x - mean) * inv and the ReLU
//      mask gamma*xhat + beta > 0 from x, then per-channel
//      [sum dz, sum dz*xhat] = [dbeta, dgamma];
//   K3 _bwd_rule (pallas_call at :284, body _bwd_dx_kernel :127-134):
//      dx = gamma*inv * (dz - dbeta/n - xhat*dgamma/n).
// Semantics: the plain versions in ops/fused_bn.py of this package.
//
// What bounds them on an H100: bytes. Each reads x (K1) or x and dy (K2, K3)
// once and K3 writes dx once, with a handful of operations per element, far
// below the card's ~295 operations per byte; at NestedUNet's full width
// (batch 16, 96x96) the 30 instances of one step move about 0.15 GB per pass
// in bf16, some 45-140 us at 3.35 TB/s, while the smallest instances (0.6 MB)
// are below a launch's latency.
//
// Design. The TPU kernels carry their sums from one sequential grid step to
// the next; on the card blocks run in parallel and in no order, so K1 and K2
// are two-stage reductions with no float atomics, and the same inputs give
// the same bits on every run:
//   stage 1: a grid of (row chunk, channel slice) blocks. Each thread owns a
//     fixed group of VEC neighbouring channels (16-byte loads when C allows:
//     8 bf16 or 4 float) and walks the chunk's rows with a stride of `lanes`;
//     neighbouring threads take neighbouring channel groups, and when a row
//     is narrower than a warp (C = 32 in bf16 is 64 bytes) one warp spans
//     several rows, so every warp reads contiguous memory. The block folds its
//     lanes in shared memory by a fixed tree and writes f32 partials [P][C].
//   stage 2: one warp per channel sums the P partials in a fixed order. K1's
//     stage 2 also finishes mean, biased var = max(sum x^2/n - mean^2, 0),
//     inv = rsqrt(var + eps) and, when given, the running-stat update
//     (decay `momentum`, unbiased variance), so a BN layer's forward costs two
//     launches before its normalize pass.
// K3 uses the same thread-to-channel map, so each thread keeps its channels'
// mean, inv, gamma, beta, dbeta/n and dgamma/n in registers for all its rows.
// Any C >= 1 and any row count work: a row chunk's edge and a channel slice's
// edge are masked, and a C that is not a multiple of VEC (or a pointer that is
// not 16-byte aligned) takes the scalar instantiation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kFinalWarps = 8;     // stage 2: channels per block
constexpr int kTargetBlocks = 1056;  // 132 SMs x 8 blocks of 256 threads
constexpr int kMinRowsPerLane = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "vector loads are 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f(e[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p, const float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    p[0] = from_f<T>(v[0]);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

// How the (rows, C) view is cut: groups of `vec` channels, `gpb` groups per
// block (a power of two), `lanes` = kThreads / gpb threads per group, each
// block `rows_per_block` rows; grid (nparts, gridy).
struct Layout {
  int vec, groups, gpb, lanes, gridy, nparts;
  long long rows_per_block;
};

Layout make_layout(long long rows, int C, int vec) {
  Layout L;
  L.vec = vec;
  L.groups = C / vec;
  L.gpb = 1;
  while (L.gpb < L.groups && L.gpb < kThreads) L.gpb *= 2;
  L.lanes = kThreads / L.gpb;
  L.gridy = (L.groups + L.gpb - 1) / L.gpb;
  const long long per_lane = (rows + L.lanes - 1) / L.lanes;
  const long long target = kTargetBlocks / L.gridy > 0 ? kTargetBlocks / L.gridy : 1;
  long long iters = (per_lane + target - 1) / target;
  if (iters < kMinRowsPerLane) iters = kMinRowsPerLane;
  L.rows_per_block = iters * L.lanes;
  L.nparts = (int)((rows + L.rows_per_block - 1) / L.rows_per_block);
  return L;
}

// Fold the `lanes` rows of sh[kThreads * VEC] (thread t's values at t*VEC) into
// the first gpb threads' slots by a fixed tree: lane l adds lane l + stride.
template <int VEC>
__device__ __forceinline__ void fold_lanes(float* sh, int lane, int lanes, int gpb) {
  for (int stride = lanes / 2; stride > 0; stride /= 2) {
    if (lane < stride) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        sh[threadIdx.x * VEC + i] += sh[(threadIdx.x + stride * gpb) * VEC + i];
    }
    __syncthreads();
  }
}

// K1 stage 1: part[0][p][c] = sum of x, part[1][p][c] = sum of x^2 over
// block p's rows.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
stats_partial_kernel(const T* __restrict__ x, float* __restrict__ part, long long rows,
                     int C, int gpb, long long rows_per_block) {
  __shared__ float sh_s[kThreads * VEC];
  __shared__ float sh_q[kThreads * VEC];
  const int lanes = kThreads / gpb;
  const int tg = threadIdx.x % gpb;
  const int lane = threadIdx.x / gpb;
  const int g = blockIdx.y * gpb + tg;
  const bool active = g * VEC < C;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);

  float s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
  if (active) {
    const T* src = x + (long long)g * VEC;
#pragma unroll 4
    for (long long r = r0 + lane; r < r1; r += lanes) {
      float v[VEC];
      load_vec<T, VEC>(src + r * C, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] += v[i];
        q[i] = fmaf(v[i], v[i], q[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sh_s[threadIdx.x * VEC + i] = s[i];
    sh_q[threadIdx.x * VEC + i] = q[i];
  }
  __syncthreads();
  fold_lanes<VEC>(sh_s, lane, lanes, gpb);
  fold_lanes<VEC>(sh_q, lane, lanes, gpb);
  if (lane == 0 && active) {
    const long long P = gridDim.x;
    float* ps = part + (long long)blockIdx.x * C + (long long)g * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      ps[i] = sh_s[tg * VEC + i];
      ps[P * C + i] = sh_q[tg * VEC + i];
    }
  }
}

// Sum the P partials of channel c in a fixed order: lane l takes p = l, l+32,
// ..., then a butterfly over the warp. Every lane ends with the total.
__device__ __forceinline__ float warp_total(const float* __restrict__ part, int P, int C,
                                            int c, int lane) {
  float s = 0.f;
  for (int p = lane; p < P; p += 32) s += part[(long long)p * C + c];
#pragma unroll
  for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

// K1 stage 2: out rows 0..4 = sum, sumsq, mean, biased var, inv; running
// stats updated in place when given.
__global__ void __launch_bounds__(kFinalWarps * 32)
stats_final_kernel(const float* __restrict__ part, int P, int C, long long rows, float eps,
                   float keep, float take, float unbias, float* __restrict__ out,
                   float* __restrict__ run_mean, float* __restrict__ run_var) {
  const int c = blockIdx.x * kFinalWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (c >= C) return;
  const float s = warp_total(part, P, C, c, lane);
  const float q = warp_total(part + (long long)P * C, P, C, c, lane);
  if (lane != 0) return;
  const float n = (float)rows;
  const float mean = s / n;
  const float var = fmaxf(__fsub_rn(q / n, __fmul_rn(mean, mean)), 0.f);
  out[c] = s;
  out[C + c] = q;
  out[2 * C + c] = mean;
  out[3 * C + c] = var;
  out[4 * C + c] = rsqrtf(var + eps);
  if (run_mean != nullptr) {
    run_mean[c] = keep * run_mean[c] + take * mean;
    run_var[c] = keep * run_var[c] + take * (var * unbias);
  }
}

// Per-channel parameters of one thread's VEC channels.
template <int VEC>
struct ChannelParams {
  float mean[VEC], inv[VEC], gamma[VEC], beta[VEC];
  __device__ __forceinline__ void load(const float* __restrict__ m, const float* __restrict__ iv,
                                       const float* __restrict__ gm,
                                       const float* __restrict__ bt, int c0) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mean[i] = m[c0 + i];
      inv[i] = iv[c0 + i];
      gamma[i] = gm[c0 + i];
      beta[i] = bt[c0 + i];
    }
  }
  // xhat and dz = (gamma*xhat + beta > 0) ? dy : 0, as _dz_common computes
  // them. Each step is rounded on its own (no fused multiply-add), as the
  // plain version's separate elementwise ops are, so the ReLU mask of an
  // element is the same bit in both.
  __device__ __forceinline__ void dz(int i, float x, float dy, float& xhat, float& d) const {
    xhat = __fmul_rn(__fsub_rn(x, mean[i]), inv[i]);
    d = __fadd_rn(__fmul_rn(gamma[i], xhat), beta[i]) > 0.f ? dy : 0.f;
  }
};

// K2 stage 1: part[0][p][c] = sum dz, part[1][p][c] = sum dz*xhat.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bwd_reduce_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const float* __restrict__ mean, const float* __restrict__ inv,
                          const float* __restrict__ gamma, const float* __restrict__ beta,
                          float* __restrict__ part, long long rows, int C, int gpb,
                          long long rows_per_block) {
  __shared__ float sh_b[kThreads * VEC];
  __shared__ float sh_g[kThreads * VEC];
  const int lanes = kThreads / gpb;
  const int tg = threadIdx.x % gpb;
  const int lane = threadIdx.x / gpb;
  const int g = blockIdx.y * gpb + tg;
  const bool active = g * VEC < C;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);

  float db[VEC], dg[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) db[i] = dg[i] = 0.f;
  if (active) {
    ChannelParams<VEC> cp;
    cp.load(mean, inv, gamma, beta, g * VEC);
    const long long off = (long long)g * VEC;
#pragma unroll 2
    for (long long r = r0 + lane; r < r1; r += lanes) {
      float xv[VEC], gv[VEC];
      load_vec<T, VEC>(x + r * C + off, xv);
      load_vec<T, VEC>(dy + r * C + off, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float xhat, d;
        cp.dz(i, xv[i], gv[i], xhat, d);
        db[i] += d;
        dg[i] = fmaf(d, xhat, dg[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    sh_b[threadIdx.x * VEC + i] = db[i];
    sh_g[threadIdx.x * VEC + i] = dg[i];
  }
  __syncthreads();
  fold_lanes<VEC>(sh_b, lane, lanes, gpb);
  fold_lanes<VEC>(sh_g, lane, lanes, gpb);
  if (lane == 0 && active) {
    const long long P = gridDim.x;
    float* pb = part + (long long)blockIdx.x * C + (long long)g * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      pb[i] = sh_b[tg * VEC + i];
      pb[P * C + i] = sh_g[tg * VEC + i];
    }
  }
}

// K2 stage 2: out rows 0, 1 = dbeta, dgamma.
__global__ void __launch_bounds__(kFinalWarps * 32)
bwd_reduce_final_kernel(const float* __restrict__ part, int P, int C,
                        float* __restrict__ out) {
  const int c = blockIdx.x * kFinalWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (c >= C) return;
  const float db = warp_total(part, P, C, c, lane);
  const float dg = warp_total(part + (long long)P * C, P, C, c, lane);
  if (lane == 0) {
    out[c] = db;
    out[C + c] = dg;
  }
}

// K3: dx = gamma*inv * (dz - dbeta/n - xhat*dgamma/n), in x's dtype.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const float* __restrict__ mean, const float* __restrict__ inv,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              const float* __restrict__ dbeta, const float* __restrict__ dgamma,
              T* __restrict__ dx, long long rows, int C, int gpb, long long rows_per_block) {
  const int lanes = kThreads / gpb;
  const int tg = threadIdx.x % gpb;
  const int lane = threadIdx.x / gpb;
  const int g = blockIdx.y * gpb + tg;
  if (g * VEC >= C) return;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  const int c0 = g * VEC;
  const float n = (float)rows;
  ChannelParams<VEC> cp;
  cp.load(mean, inv, gamma, beta, c0);
  float scale[VEC], db_n[VEC], dg_n[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    scale[i] = cp.gamma[i] * cp.inv[i];
    db_n[i] = dbeta[c0 + i] / n;
    dg_n[i] = dgamma[c0 + i] / n;
  }
#pragma unroll 2
  for (long long r = r0 + lane; r < r1; r += lanes) {
    float xv[VEC], gv[VEC], out[VEC];
    load_vec<T, VEC>(x + r * C + c0, xv);
    load_vec<T, VEC>(dy + r * C + c0, gv);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float xhat, d;
      cp.dz(i, xv[i], gv[i], xhat, d);
      out[i] = scale[i] * (d - db_n[i] - xhat * dg_n[i]);
    }
    store_vec<T, VEC>(dx + r * C + c0, out);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
int vec_for(int C, std::initializer_list<const void*> ptrs) {
  constexpr int V = 16 / sizeof(T);
  if (C % V != 0) return 1;
  for (const void* p : ptrs)
    if (!aligned16(p)) return 1;
  return V;
}

template <typename T, int VEC>
void launch_stats(const Layout& L, const void* x, float* work, long long rows, int C,
                  cudaStream_t s) {
  stats_partial_kernel<T, VEC><<<dim3(L.nparts, L.gridy), kThreads, 0, s>>>(
      static_cast<const T*>(x), work, rows, C, L.gpb, L.rows_per_block);
}

template <typename T, int VEC>
void launch_reduce(const Layout& L, const void* x, const void* dy, const float* mean,
                   const float* inv, const float* gamma, const float* beta, float* work,
                   long long rows, int C, cudaStream_t s) {
  bwd_reduce_partial_kernel<T, VEC><<<dim3(L.nparts, L.gridy), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv, gamma, beta, work,
      rows, C, L.gpb, L.rows_per_block);
}

template <typename T, int VEC>
void launch_dx(const Layout& L, const void* x, const void* dy, const float* mean,
               const float* inv, const float* gamma, const float* beta, const float* dbeta,
               const float* dgamma, void* dx, long long rows, int C, cudaStream_t s) {
  bwd_dx_kernel<T, VEC><<<dim3(L.nparts, L.gridy), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv, gamma, beta, dbeta,
      dgamma, static_cast<T*>(dx), rows, C, L.gpb, L.rows_per_block);
}

}  // namespace

// Every entry point: dtype 0 = float32, 1 = bfloat16; x (and dy, dx) are
// contiguous (rows, C) in that dtype; per-channel vectors are float32 [C];
// `work` is float32 scratch of `work_floats` floats: 2 * min(rows, 1056) * C
// always suffices (a layout has at most kTargetBlocks row chunks, and at most
// one per row).
// Kernels launch on `stream`; the return value is cudaGetLastError().

// K1. out: float32 [5, C] = sum, sumsq, mean, biased var, inv. With run_mean
// and run_var non-null: run = momentum*run + (1 - momentum)*stat, the variance
// taken unbiased (times rows/(rows-1)).
extern "C" int bn_stats(int dtype, const void* x, long long rows, int C, double eps,
                        double momentum, float* work, long long work_floats, float* out,
                        float* run_mean, float* run_var, void* stream) {
  if (rows < 1 || C < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 0 ? vec_for<float>(C, {x}) : vec_for<__nv_bfloat16>(C, {x});
  const Layout L = make_layout(rows, C, vec);
  if (2LL * L.nparts * C > work_floats) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (vec == 4) launch_stats<float, 4>(L, x, work, rows, C, s);
    else launch_stats<float, 1>(L, x, work, rows, C, s);
  } else {
    if (vec == 8) launch_stats<__nv_bfloat16, 8>(L, x, work, rows, C, s);
    else launch_stats<__nv_bfloat16, 1>(L, x, work, rows, C, s);
  }
  const double unbias = (double)rows / (double)(rows > 1 ? rows - 1 : 1);
  stats_final_kernel<<<(C + kFinalWarps - 1) / kFinalWarps, kFinalWarps * 32, 0, s>>>(
      work, L.nparts, C, rows, (float)eps, (float)momentum, (float)(1.0 - momentum),
      (float)unbias, out, run_mean, run_var);
  return (int)cudaGetLastError();
}

// K2. out: float32 [2, C] = dbeta, dgamma.
extern "C" int bn_bwd_reduce(int dtype, const void* x, const void* dy, long long rows, int C,
                             const float* mean, const float* inv, const float* gamma,
                             const float* beta, float* work, long long work_floats,
                             float* out, void* stream) {
  if (rows < 1 || C < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 0 ? vec_for<float>(C, {x, dy}) : vec_for<__nv_bfloat16>(C, {x, dy});
  const Layout L = make_layout(rows, C, vec);
  if (2LL * L.nparts * C > work_floats) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (vec == 4) launch_reduce<float, 4>(L, x, dy, mean, inv, gamma, beta, work, rows, C, s);
    else launch_reduce<float, 1>(L, x, dy, mean, inv, gamma, beta, work, rows, C, s);
  } else {
    if (vec == 8)
      launch_reduce<__nv_bfloat16, 8>(L, x, dy, mean, inv, gamma, beta, work, rows, C, s);
    else
      launch_reduce<__nv_bfloat16, 1>(L, x, dy, mean, inv, gamma, beta, work, rows, C, s);
  }
  bwd_reduce_final_kernel<<<(C + kFinalWarps - 1) / kFinalWarps, kFinalWarps * 32, 0, s>>>(
      work, L.nparts, C, out);
  return (int)cudaGetLastError();
}

// K3. dx: contiguous (rows, C) in x's dtype.
extern "C" int bn_bwd_dx(int dtype, const void* x, const void* dy, long long rows, int C,
                         const float* mean, const float* inv, const float* gamma,
                         const float* beta, const float* dbeta, const float* dgamma, void* dx,
                         void* stream) {
  if (rows < 1 || C < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 0 ? vec_for<float>(C, {x, dy, dx})
                             : vec_for<__nv_bfloat16>(C, {x, dy, dx});
  const Layout L = make_layout(rows, C, vec);
  if (dtype == 0) {
    if (vec == 4)
      launch_dx<float, 4>(L, x, dy, mean, inv, gamma, beta, dbeta, dgamma, dx, rows, C, s);
    else
      launch_dx<float, 1>(L, x, dy, mean, inv, gamma, beta, dbeta, dgamma, dx, rows, C, s);
  } else {
    if (vec == 8)
      launch_dx<__nv_bfloat16, 8>(L, x, dy, mean, inv, gamma, beta, dbeta, dgamma, dx, rows,
                                  C, s);
    else
      launch_dx<__nv_bfloat16, 1>(L, x, dy, mean, inv, gamma, beta, dbeta, dgamma, dx, rows,
                                  C, s);
  }
  return (int)cudaGetLastError();
}
