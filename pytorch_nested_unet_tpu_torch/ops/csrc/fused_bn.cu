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
// Data-parallel training splits K1: in its sums-only mode it writes the
// per-channel sums and stops, the caller all-reduces them across ranks, and
// bn_finish turns the global sums and the global row count into mean, var,
// inv and the running-stat update, through the same finishing arithmetic
// (finish_channel) as a single K1 call. K2's (2, C) output is all-reduced the
// same way, and K3 divides by the row count it is given (the global one).
//
// What bounds them on an H100: bytes. Each reads x (K1) or x and dy (K2, K3)
// once and K3 writes dx once, with a handful of operations per element, far
// below the card's ~295 operations per byte; at NestedUNet's full width
// (batch 16, 96x96) the 30 instances of one step move about 0.15 GB per pass
// in bf16, some 45-140 us at 3.35 TB/s, while the smallest instances (0.6 MB)
// are below a launch's latency.
//
// Design. Every kernel is one launch whose grid is sized to the card (a few
// blocks per SM), not to the rows, so each thread walks many rows with
// kUnroll rows of 16-byte loads in flight, all issued before their
// arithmetic. Channels are cut into slices of at most 128 bytes of a row:
// each thread owns a fixed group of VEC neighbouring channels (16-byte loads
// when C allows: 8 bf16 or 4 float), neighbouring threads take neighbouring
// groups, and when a row is narrower than a warp (C = 32 in bf16 is 64 bytes)
// one warp spans several rows, so every warp reads whole lines. A thread
// keeps its channels' per-channel values in registers for all its rows.
// The TPU kernels carry their sums from one sequential grid step to the
// next; on the card blocks run in parallel and in no order, so K1 and K2
// reduce across blocks with a last-block finish and no float atomics: each
// block folds its lanes (warp shuffles, one pass through shared memory) into
// one row of f32 partial sums, and the block that draws its slice's last
// ticket sums the slice's rows in the fixed order p = 0..P-1, finishes (K1:
// mean, biased var = max(sum x^2/n - mean^2, 0), inv = rsqrt(var + eps) and
// the running-stat update; K2: dbeta, dgamma) and resets the ticket. The
// same inputs give the same bits on every run. K3 has no reduction; its grid
// is the blocks the card holds at once.
// Any C >= 1 and any row count work: a row chunk's edge and a channel slice's
// edge are masked, and a C that is not a multiple of VEC (or a pointer that is
// not 16-byte aligned) takes the scalar instantiation.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;
constexpr int kReduceBlocksPerSm = 2;  // K1, K2
constexpr int kDxBlocksPerSm = 2;      // K3: up to 128 registers a thread
constexpr int kUnroll = 4;             // rows of loads in flight per thread
constexpr int kDxUnrollBf16 = 2;       // K3 at VEC 8: 4 rows spill at 128 registers
constexpr int kMinRowsPerLane = 4;     // K1, K2: rows a lane walks at least
constexpr int kSliceBytes = 128;
constexpr int kFinishLoads = 16;   // most float4 partials a finishing thread sums
constexpr int kFoldFloats = 1024;  // shared floats for the block fold and finish

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

// How a kernel cuts the (rows, C) view: `gridy` channel slices of `gpb`
// groups of `vec` channels (gpb a power of two, gpb * vec at most
// kSliceBytes of a row), `lanes` = kThreads / gpb threads per group; each
// slice `nparts` chunks of `rows_per_block` rows (a multiple of lanes);
// grid (nparts, gridy). A reduction's partial rows are `width` floats (the
// slice's gpb*vec first sums, then its second sums; at least 4).
struct Layout {
  int gpb, lanes, gridy, nparts, width;
  long long rows_per_block;
};

// The channel slices of C channels of `esz` bytes in groups of `vec`.
Layout slice_channels(int C, int vec, int esz) {
  Layout L;
  const int groups = C / vec;
  const int max_gpb = kSliceBytes / (vec * esz);
  L.gpb = 1;
  while (L.gpb < groups && L.gpb < max_gpb) L.gpb *= 2;
  L.lanes = kThreads / L.gpb;
  L.gridy = (groups + L.gpb - 1) / L.gpb;
  L.width = 2 * L.gpb * vec < 4 ? 4 : 2 * L.gpb * vec;
  return L;
}

// Row chunks for about `target` blocks per slice, each walking at least
// `min_iters` rows per lane.
void cut_rows(Layout& L, long long rows, long long target, long long min_iters) {
  if (target < 1) target = 1;
  long long rpb = (rows + target - 1) / target;
  rpb = (rpb + L.lanes - 1) / L.lanes * L.lanes;
  if (rpb < (long long)L.lanes * min_iters) rpb = (long long)L.lanes * min_iters;
  L.rows_per_block = rpb;
  // at least one block: 0 rows (an empty band) still launch and write zeros
  L.nparts = rows > 0 ? (int)((rows + rpb - 1) / rpb) : 1;
}

// K1 and K2: about kReduceBlocksPerSm blocks per SM, and few enough row
// chunks that a finishing thread sums at most kFinishLoads float4 partials.
Layout make_reduce_layout(long long rows, int C, int vec, int esz, int sms) {
  Layout L = slice_channels(C, vec, esz);
  long long target = (long long)sms * kReduceBlocksPerSm / L.gridy;
  const long long finish_cap = (long long)kFinishLoads * kThreads / (L.width / 4);
  if (target > finish_cap) target = finish_cap;
  cut_rows(L, rows, target, kMinRowsPerLane);
  return L;
}

// K3: the blocks the card holds at once (no finish; a lane may walk one row).
Layout make_dx_layout(long long rows, int C, int vec, int esz, int sms) {
  Layout L = slice_channels(C, vec, esz);
  cut_rows(L, rows, (long long)sms * kDxBlocksPerSm / L.gridy, 1);
  return L;
}

// Fold the block's per-thread sums a[VEC] and b[VEC] and write them as one
// row of `width` floats at prow: the slice's gpb*VEC channels of a, then of
// b (zeros after). The lanes of one group within a warp fold by a butterfly
// (xor by multiples of gpb keeps the group), then the 8 warp totals (or,
// when gpb >= 32, the kThreads / gpb lanes) through sh, in a fixed order.
template <int VEC>
__device__ __forceinline__ void write_partial_row(float (&a)[VEC], float (&b)[VEC], float* sh,
                                                  float* prow, int gpb, int width) {
  const int lanes = kThreads / gpb;
  const int tg = threadIdx.x % gpb;
  const int lane = threadIdx.x / gpb;
  const int wl = threadIdx.x % 32;
  if (gpb < 32) {
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      for (int off = 16; off >= gpb; off /= 2) {
        a[i] += __shfl_xor_sync(0xffffffffu, a[i], off);
        b[i] += __shfl_xor_sync(0xffffffffu, b[i], off);
      }
  }
  const int nrow = gpb < 32 ? kThreads / 32 : lanes;
  const int srow = gpb < 32 ? threadIdx.x / 32 : lane;
  const int half = gpb * VEC;  // floats of a (then of b) in a row
  if (gpb >= 32 || wl < gpb) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sh[srow * width + tg * VEC + i] = a[i];
      sh[srow * width + half + tg * VEC + i] = b[i];
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < width; j += kThreads) {
    float s = 0.f;
    if (j < 2 * half)
      for (int rr = 0; rr < nrow; ++rr) s += sh[rr * width + j];
    prow[j] = s;
  }
}

// The last-block handshake of a reduction whose blocks each wrote one row of
// partials: every thread fences its writes, thread 0 draws a ticket from
// tickets[slice], and the function returns true, in every thread, only in
// the block that drew the slice's last of P tickets, after a fence that
// makes the other blocks' partials visible to it. That block resets the
// ticket (to be read again only by a later kernel on the stream).
__device__ __forceinline__ bool last_block_of_slice(int* tickets, int slice, int P) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = atomicAdd(&tickets[slice], 1);
    is_last = t == P - 1;
    if (is_last) tickets[slice] = 0;
  }
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  return true;
}

// Column totals of the P rows of `width` floats (a multiple of 4, at most
// 4 * kThreads) at `part`, each summed in the fixed order p = 0..P-1, into
// sh[0..width). Thread t sums column group t % (width/4) over the rows
// p = j, j + J, ... (j = t / (width/4), J = kThreads / (width/4)) with
// 16-byte L2 reads, then the J subtotals fold in order j = 0..J-1. Needs
// sh of kThreads * 4 floats; ends with a __syncthreads.
__device__ __forceinline__ void sum_partial_rows(const float* part, int P, int width,
                                                 float* sh) {
  const int w4 = width / 4;
  const int J = kThreads / w4;
  const int col = threadIdx.x % w4;
  const int j = threadIdx.x / w4;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j < J) {
    const float4* src = reinterpret_cast<const float4*>(part) + col;
#pragma unroll 4
    for (int p = j; p < P; p += J) {
      const float4 v = __ldcg(src + (long long)p * w4);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    reinterpret_cast<float4*>(sh)[j * w4 + col] = s;
  }
  __syncthreads();
  float tot = 0.f;
  if (threadIdx.x < width)
    for (int jj = 0; jj < J; ++jj) tot += sh[jj * width + threadIdx.x];
  __syncthreads();
  if (threadIdx.x < width) sh[threadIdx.x] = tot;
  __syncthreads();
}

// One channel's statistics from its sums over n rows: mean, biased var =
// max(sum x^2/n - mean^2, 0) and inv = rsqrt(var + eps) into stat[0], stat[C]
// and stat[2C] (at channel c), and with run_mean non-null the running stats
// moved once. K1's finish and bn_finish both run it, so the split path gives
// the bits of one K1 call on the same sums.
__device__ __forceinline__ void finish_channel(float sum, float sumsq, float n, int c, int C,
                                               float eps, float keep, float take, float unbias,
                                               float* __restrict__ stat,
                                               float* __restrict__ run_mean,
                                               float* __restrict__ run_var) {
  const float mean = sum / n;
  const float var = fmaxf(__fsub_rn(sumsq / n, __fmul_rn(mean, mean)), 0.f);
  stat[c] = mean;
  stat[C + c] = var;
  stat[2 * C + c] = rsqrtf(var + eps);
  if (run_mean != nullptr) {
    run_mean[c] = keep * run_mean[c] + take * mean;
    run_var[c] = keep * run_var[c] + take * (var * unbias);
  }
}

// K1: out rows 0..4 = sum, sumsq, mean, biased var, inv; with run_mean and
// run_var non-null, run = keep*run + take*stat (the variance times unbias),
// once per call; with sums_only, rows 0..1 only (the running stats are left).
// part: [gridy][P][width] f32 scratch; tickets: [gridy] ints, 0 on entry and
// on exit. The kUnroll rows of a step are loaded (rows past the chunk's end
// as zeros) before any is added. The finish is the plain version's f32
// arithmetic, each step rounded on its own.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kReduceBlocksPerSm)
stats_kernel(const T* __restrict__ x, float* part, int* tickets, float* __restrict__ out,
             float* __restrict__ run_mean, float* __restrict__ run_var, long long rows, int C,
             int gpb, long long rows_per_block, int width, float eps, float keep, float take,
             float unbias, int sums_only) {
  __shared__ __align__(16) float sh[kFoldFloats];
  const int P = gridDim.x;
  const int slice = blockIdx.y;
  const int lanes = kThreads / gpb;
  const int g = slice * gpb + threadIdx.x % gpb;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);

  float s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.f;
  if (g * VEC < C) {
    const T* xs = x + (long long)g * VEC;
    for (long long r = r0 + threadIdx.x / gpb; r < r1; r += kUnroll * lanes) {
      float v[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * lanes < r1) {
          load_vec<T, VEC>(xs + (r + u * lanes) * C, v[u]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) v[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s[i] += v[u][i];
          q[i] = fmaf(v[u][i], v[u][i], q[i]);
        }
    }
  }
  write_partial_row<VEC>(s, q, sh, part + ((long long)slice * P + blockIdx.x) * width, gpb,
                         width);

  if (!last_block_of_slice(tickets, slice, P)) return;
  sum_partial_rows(part + (long long)slice * P * width, P, width, sh);
  const int half = gpb * VEC;
  for (int j = threadIdx.x; j < half; j += kThreads) {
    const int c = slice * half + j;
    if (c >= C) continue;
    const float sum = sh[j], sumsq = sh[half + j];
    out[c] = sum;
    out[C + c] = sumsq;
    if (!sums_only)
      finish_channel(sum, sumsq, (float)rows, c, C, eps, keep, take, unbias, out + 2 * C,
                     run_mean, run_var);
  }
}

// bn_finish: out rows 0..2 = mean, biased var, inv of the [2][C] sums over n
// rows (finish_channel), the running stats moved when given. One thread per
// channel.
__global__ void finish_kernel(const float* __restrict__ sums, float n, int C, float eps,
                              float keep, float take, float unbias, float* __restrict__ out,
                              float* __restrict__ run_mean, float* __restrict__ run_var) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < C)
    finish_channel(sums[c], sums[C + c], n, c, C, eps, keep, take, unbias, out, run_mean,
                   run_var);
}

// K2: out[0][c] = dbeta = sum dz, out[1][c] = dgamma = sum dz*xhat.
// part: [gridy][P][width] f32 scratch; tickets: [gridy] ints, 0 on entry
// and on exit. One accumulator per channel keeps the registers at 2 blocks
// per SM (its VEC channels are independent chains already).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kReduceBlocksPerSm)
bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                  const float* __restrict__ mean, const float* __restrict__ inv,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  float* part, int* tickets,
                  float* __restrict__ out, long long rows, int C, int gpb,
                  long long rows_per_block, int width) {
  __shared__ __align__(16) float sh[kFoldFloats];
  const int P = gridDim.x;
  const int slice = blockIdx.y;
  const int lanes = kThreads / gpb;
  const int lane = threadIdx.x / gpb;
  const int g = slice * gpb + threadIdx.x % gpb;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);

  float db[VEC], dg[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) db[i] = dg[i] = 0.f;
  if (g * VEC < C) {
    ChannelParams<VEC> cp;
    cp.load(mean, inv, gamma, beta, g * VEC);
    const T* xs = x + (long long)g * VEC;
    const T* gs = dy + (long long)g * VEC;
    long long r = r0 + lane;
    for (; r + (kUnroll - 1) * lanes < r1; r += kUnroll * lanes) {
      float xv[kUnroll][VEC], gv[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load_vec<T, VEC>(xs + (r + u * lanes) * C, xv[u]);
        load_vec<T, VEC>(gs + (r + u * lanes) * C, gv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float xhat, d;
          cp.dz(i, xv[u][i], gv[u][i], xhat, d);
          db[i] += d;
          dg[i] = fmaf(d, xhat, dg[i]);
        }
    }
    for (; r < r1; r += lanes) {
      float xv[VEC], gv[VEC];
      load_vec<T, VEC>(xs + r * C, xv);
      load_vec<T, VEC>(gs + r * C, gv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        float xhat, d;
        cp.dz(i, xv[i], gv[i], xhat, d);
        db[i] += d;
        dg[i] = fmaf(d, xhat, dg[i]);
      }
    }
  }
  write_partial_row<VEC>(db, dg, sh, part + ((long long)slice * P + blockIdx.x) * width, gpb,
                         width);

  if (!last_block_of_slice(tickets, slice, P)) return;
  sum_partial_rows(part + (long long)slice * P * width, P, width, sh);
  const int half = gpb * VEC;
  for (int j = threadIdx.x; j < 2 * half; j += kThreads) {
    const int c = slice * half + (j < half ? j : j - half);
    if (c < C) out[(j < half ? 0 : C) + c] = sh[j];
  }
}

// K3: dx = gamma*inv * (dz - dbeta/n - xhat*dgamma/n), in x's dtype, n the
// row count the statistics were taken over (the local rows, or all ranks'
// rows in data-parallel training). The
// U rows of a step are loaded (x and dy) before any is computed, and dx is
// written as 16-byte stores; rows past the chunk's end are skipped. U is
// kUnroll, or kDxUnrollBf16 for 8 bf16 channels a thread: their 56
// per-channel registers and 4 rows of loads spill at the 128 registers of 2
// blocks per SM, and 2 rows measured faster than 4.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kDxBlocksPerSm)
bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dy,
              const float* __restrict__ mean, const float* __restrict__ inv,
              const float* __restrict__ gamma, const float* __restrict__ beta,
              const float* __restrict__ dbeta, const float* __restrict__ dgamma,
              T* __restrict__ dx, long long rows, float n, int C, int gpb,
              long long rows_per_block) {
  constexpr int U = VEC == 8 ? kDxUnrollBf16 : kUnroll;
  const int lanes = kThreads / gpb;
  const int c0 = (blockIdx.y * gpb + threadIdx.x % gpb) * VEC;
  if (c0 >= C) return;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  ChannelParams<VEC> cp;
  cp.load(mean, inv, gamma, beta, c0);
  float scale[VEC], db_n[VEC], dg_n[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    scale[i] = cp.gamma[i] * cp.inv[i];
    db_n[i] = dbeta[c0 + i] / n;
    dg_n[i] = dgamma[c0 + i] / n;
  }
  const T* xs = x + c0;
  const T* gs = dy + c0;
  T* ds = dx + c0;
  for (long long r = r0 + threadIdx.x / gpb; r < r1; r += U * lanes) {
    float xv[U][VEC], gv[U][VEC];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * lanes < r1) {
        load_vec<T, VEC>(xs + (r + u * lanes) * C, xv[u]);
        load_vec<T, VEC>(gs + (r + u * lanes) * C, gv[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (r + u * lanes < r1) {
        float o[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          float xhat, d;
          cp.dz(i, xv[u][i], gv[u][i], xhat, d);
          o[i] = scale[i] * (d - db_n[i] - xhat * dg_n[i]);
        }
        store_vec<T, VEC>(ds + (r + u * lanes) * C, o);
      }
    }
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
void launch_stats(const Layout& L, const void* x, float* work, int* tickets, float* out,
                  float* run_mean, float* run_var, long long rows, int C, float eps, float keep,
                  float take, float unbias, int sums_only, cudaStream_t s) {
  stats_kernel<T, VEC><<<dim3(L.nparts, L.gridy), kThreads, 0, s>>>(
      static_cast<const T*>(x), work, tickets, out, run_mean, run_var, rows, C, L.gpb,
      L.rows_per_block, L.width, eps, keep, take, unbias, sums_only);
}

template <typename T, int VEC>
void launch_reduce(const Layout& L, const void* x, const void* dy, const float* mean,
                   const float* inv, const float* gamma, const float* beta, float* work,
                   int* tickets, float* out, long long rows, int C, cudaStream_t s) {
  bwd_reduce_kernel<T, VEC><<<dim3(L.nparts, L.gridy), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv, gamma, beta, work,
      tickets, out, rows, C, L.gpb, L.rows_per_block, L.width);
}

template <typename T, int VEC>
void launch_dx(const Layout& L, const void* x, const void* dy, const float* mean,
               const float* inv, const float* gamma, const float* beta, const float* dbeta,
               const float* dgamma, void* dx, long long rows, float n, int C, cudaStream_t s) {
  bwd_dx_kernel<T, VEC><<<dim3(L.nparts, L.gridy), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), mean, inv, gamma, beta, dbeta,
      dgamma, static_cast<T*>(dx), rows, n, C, L.gpb, L.rows_per_block);
}

// The running-stat update's factors for statistics over n rows: keep =
// momentum, take = 1 - momentum, unbias = n/(n-1) (1 when n = 1).
void update_factors(long long n, double momentum, float& keep, float& take, float& unbias) {
  unbias = (float)((double)n / (double)(n > 1 ? n - 1 : 1));
  keep = (float)momentum;
  take = (float)(1.0 - momentum);
}

}  // namespace

// Every entry point: dtype 0 = float32, 1 = bfloat16; x (and dy, dx) are
// contiguous (rows, C) in that dtype; per-channel vectors are float32 [C];
// `sms` is the device's SM count. K1 and K2 take `work`, float32 scratch of
// `work_floats` floats, 16-byte aligned (128 * max(2 * sms, C) always
// suffice), and
// `tickets`, int32 [num_tickets] with num_tickets >= ceil(C / 32), all 0:
// the kernels leave them 0, so one zeroed buffer serves every later call of
// either, replays from a CUDA graph included, as long as the calls that
// share it are ordered on one stream (two kernels in flight at once on one
// buffer would mix tickets).
// bn_finish takes neither.
// Kernels launch on `stream`; the return value is cudaGetLastError().

// K1 (one launch). out: float32 [5, C] = sum, sumsq, mean, biased var, inv.
// With run_mean and run_var non-null: run = momentum*run + (1 - momentum)*stat,
// the variance taken unbiased (times rows/(rows-1)). With sums_only != 0, out
// is float32 [2, C] = sum, sumsq and the running stats must be null; rows may
// then be 0 (a band of zero rows: zero sums, still one launch of one block).
extern "C" int bn_stats(int dtype, const void* x, long long rows, int C, double eps,
                        double momentum, int sums_only, float* work, long long work_floats,
                        int* tickets, int num_tickets, int sms, float* out, float* run_mean,
                        float* run_var, void* stream) {
  if (rows < (sums_only ? 0 : 1) || C < 1 || sms < 1 || (dtype != 0 && dtype != 1) ||
      (sums_only && (run_mean != nullptr || run_var != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 0 ? vec_for<float>(C, {x}) : vec_for<__nv_bfloat16>(C, {x});
  const Layout L = make_reduce_layout(rows, C, vec, dtype == 0 ? 4 : 2, sms);
  if ((long long)L.gridy * L.nparts * L.width > work_floats || L.gridy > num_tickets)
    return (int)cudaErrorInvalidValue;
  float keep, take, unbias;
  update_factors(rows, momentum, keep, take, unbias);
  const float e = (float)eps;
  if (dtype == 0) {
    if (vec == 4)
      launch_stats<float, 4>(L, x, work, tickets, out, run_mean, run_var, rows, C, e, keep,
                             take, unbias, sums_only, s);
    else
      launch_stats<float, 1>(L, x, work, tickets, out, run_mean, run_var, rows, C, e, keep,
                             take, unbias, sums_only, s);
  } else {
    if (vec == 8)
      launch_stats<__nv_bfloat16, 8>(L, x, work, tickets, out, run_mean, run_var, rows, C, e,
                                     keep, take, unbias, sums_only, s);
    else
      launch_stats<__nv_bfloat16, 1>(L, x, work, tickets, out, run_mean, run_var, rows, C, e,
                                     keep, take, unbias, sums_only, s);
  }
  return (int)cudaGetLastError();
}

// bn_finish (one launch): K1's finish from sums, float32 [2, C] (sum x and
// sum x^2 over n rows, e.g. all ranks' K1 sums-only outputs added), into out,
// float32 [3, C] = mean, biased var, inv; with run_mean and run_var non-null,
// the running-stat update of K1 (the variance times n/(n-1)).
extern "C" int bn_finish(const float* sums, long long n, int C, double eps, double momentum,
                         float* out, float* run_mean, float* run_var, void* stream) {
  if (n < 1 || C < 1 || (run_mean == nullptr) != (run_var == nullptr))
    return (int)cudaErrorInvalidValue;
  float keep, take, unbias;
  update_factors(n, momentum, keep, take, unbias);
  constexpr int kFinishThreads = 128;
  finish_kernel<<<(C + kFinishThreads - 1) / kFinishThreads, kFinishThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(sums, (float)n, C, (float)eps, keep, take,
                                                       unbias, out, run_mean, run_var);
  return (int)cudaGetLastError();
}

// K2 (one launch). out: float32 [2, C] = dbeta, dgamma; zeros for 0 rows.
extern "C" int bn_bwd_reduce(int dtype, const void* x, const void* dy, long long rows, int C,
                             const float* mean, const float* inv, const float* gamma,
                             const float* beta, float* work, long long work_floats,
                             int* tickets, int num_tickets, int sms, float* out, void* stream) {
  if (rows < 0 || C < 1 || sms < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 0 ? vec_for<float>(C, {x, dy}) : vec_for<__nv_bfloat16>(C, {x, dy});
  const Layout L = make_reduce_layout(rows, C, vec, dtype == 0 ? 4 : 2, sms);
  if ((long long)L.gridy * L.nparts * L.width > work_floats || L.gridy > num_tickets)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (vec == 4)
      launch_reduce<float, 4>(L, x, dy, mean, inv, gamma, beta, work, tickets, out, rows, C, s);
    else
      launch_reduce<float, 1>(L, x, dy, mean, inv, gamma, beta, work, tickets, out, rows, C, s);
  } else {
    if (vec == 8)
      launch_reduce<__nv_bfloat16, 8>(L, x, dy, mean, inv, gamma, beta, work, tickets, out,
                                      rows, C, s);
    else
      launch_reduce<__nv_bfloat16, 1>(L, x, dy, mean, inv, gamma, beta, work, tickets, out,
                                      rows, C, s);
  }
  return (int)cudaGetLastError();
}

// K3 (one launch). dx: contiguous (rows, C) in x's dtype; n: the row count
// behind mean, inv, dbeta and dgamma (rows in one process, all ranks' rows
// in data-parallel training). 0 rows launch one block that writes nothing.
extern "C" int bn_bwd_dx(int dtype, const void* x, const void* dy, long long rows, long long n,
                         int C, const float* mean, const float* inv, const float* gamma,
                         const float* beta, const float* dbeta, const float* dgamma, void* dx,
                         int sms, void* stream) {
  if (rows < 0 || n < 1 || n < rows || C < 1 || sms < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int vec = dtype == 0 ? vec_for<float>(C, {x, dy, dx})
                             : vec_for<__nv_bfloat16>(C, {x, dy, dx});
  const Layout L = make_dx_layout(rows, C, vec, dtype == 0 ? 4 : 2, sms);
  const float nf = (float)n;
  if (dtype == 0) {
    if (vec == 4)
      launch_dx<float, 4>(L, x, dy, mean, inv, gamma, beta, dbeta, dgamma, dx, rows, nf, C, s);
    else
      launch_dx<float, 1>(L, x, dy, mean, inv, gamma, beta, dbeta, dgamma, dx, rows, nf, C, s);
  } else {
    if (vec == 8)
      launch_dx<__nv_bfloat16, 8>(L, x, dy, mean, inv, gamma, beta, dbeta, dgamma, dx, rows,
                                  nf, C, s);
    else
      launch_dx<__nv_bfloat16, 1>(L, x, dy, mean, inv, gamma, beta, dbeta, dgamma, dx, rows,
                                  nf, C, s);
  }
  return (int)cudaGetLastError();
}
