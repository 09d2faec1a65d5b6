// conv3x3(concat(parts)) + bias over NHWC parts, without the concat.
//
// Replaces: pytorch_nested_unet_tpu/ops/decoder_fusion.py::_fwd_pallas
// (pallas_call at :221, body _fwd_kernel :159-206), the first conv of each of
// NestedUNet's 10 nested decoder nodes. Semantics: reference_multipart_conv3x3
// in ops/decoder_fusion.py of this package (stride 1, pad 1, f32 accumulation,
// bias added in f32, one rounding to the output dtype).
//
// What bounds it on an H100: at the decoder's shapes (cin 96-768, co 32-256,
// batch 16) the work is about 2*9*cin/(bytes per element) operations per byte
// moved, far above the card's ~295 operations per byte in bf16, so the floor is
// arithmetic. This first version does the arithmetic on the FP32 cores (no
// tensor cores), so its own ceiling is the 67 TFLOP/s float rate, and inside
// that the shared-memory traffic of the inner loop.
//
// Design: one block per (batch image, 8x16 output tile, 32-channel slice of
// co). The K loop walks the parts' base pointers one 16-channel chunk at a
// time, so each part contracts against its own rows of the [3,3,cin,co]
// weights and the concatenated tensor never exists. A chunk's 10x18 input halo
// (zero outside the image) and its 9x16x32 weight slab are staged in shared
// memory as float; each of 128 threads then keeps 4 pixels x 8 channels of
// accumulators in registers, reading 8 weights as two float4 and 4 inputs per
// (tap, channel) step for 32 FMAs. The TPU kernel's tap-packed [cin, 9*co]
// product and shift-add served its 128-lane matrix unit and is not carried
// over. A wgmma/TMA implicit GEMM on the tensor cores is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxParts = 8;
constexpr int TH = 8;           // output tile rows
constexpr int TW = 16;          // output tile columns
constexpr int HH = TH + 2;      // halo rows
constexpr int HW = TW + 2;      // halo columns
constexpr int KC = 16;          // input channels staged per step
constexpr int CO_T = 32;        // output channels per block
constexpr int THREADS = 128;
constexpr int PIX = 4;          // pixels per thread: rows py, py+2, py+4, py+6
constexpr int COV = 8;          // output channels per thread

struct Parts {
  const void* ptr[kMaxParts];
  int ch[kMaxParts];
  int n;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
multipart_conv3x3_kernel(Parts parts, const T* __restrict__ weight,
                         const float* __restrict__ bias, T* __restrict__ out,
                         int H, int W, int cin, int co, int tiles_w) {
  __shared__ float s_in[KC][HH][HW];
  __shared__ __align__(16) float s_w[9][KC][CO_T];

  const int tid = threadIdx.x;
  const int n = blockIdx.z;
  const int co0 = blockIdx.y * CO_T;
  const int y0 = (blockIdx.x / tiles_w) * TH;
  const int x0 = (blockIdx.x % tiles_w) * TW;
  const int tc = tid % 4;         // channels co0 + 8*tc .. +7
  const int tp = tid / 4;         // 0..31
  const int px = tp % TW;         // tile column
  const int py = tp / TW;         // 0..1: tile rows py + 2*i

  float acc[PIX][COV];
#pragma unroll
  for (int i = 0; i < PIX; ++i)
#pragma unroll
    for (int j = 0; j < COV; ++j) acc[i][j] = 0.f;

  int cbase = 0;                  // first row of this part in the weights' cin
  for (int p = 0; p < parts.n; ++p) {
    const T* __restrict__ src = static_cast<const T*>(parts.ptr[p]);
    const int cp = parts.ch[p];
    for (int k0 = 0; k0 < cp; k0 += KC) {
      for (int i = tid; i < HH * HW * KC; i += THREADS) {
        const int k = i % KC;
        const int pix = i / KC;
        const int r = pix / HW;
        const int c = pix % HW;
        const int gy = y0 + r - 1;
        const int gx = x0 + c - 1;
        float v = 0.f;
        if (k0 + k < cp && gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = to_f(src[((long long)(n * H + gy) * W + gx) * cp + k0 + k]);
        s_in[k][r][c] = v;
      }
      for (int i = tid; i < 9 * KC * CO_T; i += THREADS) {
        const int j = i % CO_T;
        const int k = (i / CO_T) % KC;
        const int t = i / (CO_T * KC);
        float v = 0.f;
        if (k0 + k < cp && co0 + j < co)
          v = to_f(weight[((long long)t * cin + cbase + k0 + k) * co + co0 + j]);
        s_w[t][k][j] = v;
      }
      __syncthreads();

#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int dy = t / 3;
        const int dx = t % 3;
#pragma unroll 4
        for (int k = 0; k < KC; ++k) {
          const float4 wa = *reinterpret_cast<const float4*>(&s_w[t][k][tc * COV]);
          const float4 wb = *reinterpret_cast<const float4*>(&s_w[t][k][tc * COV + 4]);
          const float wv[COV] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < PIX; ++i) {
            const float a = s_in[k][py + 2 * i + dy][px + dx];
#pragma unroll
            for (int j = 0; j < COV; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
          }
        }
      }
      __syncthreads();
    }
    cbase += cp;
  }

  const int x = x0 + px;
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int y = y0 + py + 2 * i;
    if (y >= H || x >= W) continue;
    T* dst = out + ((long long)(n * H + y) * W + x) * co;
#pragma unroll
    for (int j = 0; j < COV; ++j) {
      const int c = co0 + tc * COV + j;
      if (c < co) dst[c] = from_f<T>(acc[i][j] + (bias ? bias[c] : 0.f));
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. parts: nparts device pointers to NHWC
// contiguous (B,H,W,part_ch[i]) tensors; weight: [3,3,cin,co] contiguous in the
// parts' dtype; bias: float32 [co] or null; out: (B,H,W,co) in the parts' dtype.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int decoder_fusion_fwd(int dtype, const void* const* part_ptrs,
                                  const int* part_ch, int nparts, const void* weight,
                                  const void* bias, void* out, int B, int H, int W,
                                  int co, void* stream) {
  if (nparts < 1 || nparts > kMaxParts || B < 1 || H < 1 || W < 1 || co < 1)
    return (int)cudaErrorInvalidValue;
  Parts parts;
  int cin = 0;
  for (int i = 0; i < kMaxParts; ++i) {
    parts.ptr[i] = i < nparts ? part_ptrs[i] : nullptr;
    parts.ch[i] = i < nparts ? part_ch[i] : 0;
    cin += parts.ch[i];
  }
  parts.n = nparts;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_h * tiles_w, (co + CO_T - 1) / CO_T, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) {
    multipart_conv3x3_kernel<float><<<grid, THREADS, 0, s>>>(
        parts, static_cast<const float*>(weight), b, static_cast<float*>(out),
        H, W, cin, co, tiles_w);
  } else if (dtype == 1) {
    multipart_conv3x3_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        parts, static_cast<const __nv_bfloat16*>(weight), b,
        static_cast<__nv_bfloat16*>(out), H, W, cin, co, tiles_w);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
