// conv3x3(concat(parts)) + bias over NHWC parts, without the concat.
//
// Replaces: pytorch_nested_unet_tpu/ops/decoder_fusion.py::_fwd_pallas
// (pallas_call at :221, body _fwd_kernel :159-206), the first conv of each of
// NestedUNet's 10 nested decoder nodes. Semantics: reference_multipart_conv3x3
// in ops/decoder_fusion.py of this package (stride 1, pad 1, f32 accumulation,
// bias added in f32, one rounding to the output dtype).
//
// bfloat16 (tensor cores). What bounds it on an H100: summed over the 10 nodes
// at batch 16 the work is ~109 GFLOP, 0.11 ms at the 989 TFLOP/s bf16 rate,
// and moving each input, weight and output once is 0.12 ms at 3.35 TB/s: the
// two floors are close, so the kernel has to keep the tensor cores busy and
// read each activation about once. `mma.sync` (no wgmma) caps the tensor-core
// rate below the data sheet's, and the small nodes (24x24, 12x12) give few
// pixels to spread over 132 SMs. Design: an implicit GEMM, one block per
// (image, pixel tile, slice of co). M = the tile's pixels, N = the co slice
// (32 or 64), K = 9 taps x the channels of every part. The K loop walks the
// parts' base pointers in 32-channel chunks; each chunk's input halo
// ((TH+2)x(TW+2) pixels x 64 bytes) and its [9][32][N] weight slab are staged
// in shared memory by 16-byte cp.async copies (zero-filled outside the image
// and past a part's or co's end; scalar loads where a channel count is not a
// multiple of 8) through a ring of 2 stages, so the next chunk's copies
// overlap this chunk's products. All 9 taps contract against the one staged
// halo: a tap is a constant added to each lane's ldmatrix row address, so the
// shift moves no data and costs no instruction. Halo pixels are padded to 80
// bytes and weight rows XOR-swizzled in 16-byte units, so the 8 rows of an
// ldmatrix fall in different banks. Warps run mma.m16n8k16 bf16 -> f32 with
// the accumulators in registers; the epilogue adds the f32 bias, rounds once
// and goes through shared memory to 16-byte NHWC stores. The pixel tile is
// 12x12: it covers every level of a 96x96 input exactly and shares each
// staged weight slab over 144 pixels; other sizes leave ragged tiles, which
// are masked. Where the grid would leave
// SMs idle (the 24x24 and 12x12 nodes), K is split over a thread-block
// cluster of 2 blocks whose f32 partials are summed in rank order through
// distributed shared memory: no workspace (the C interface allocates
// nothing), no atomics, the same bits on every run.
//
// float32 (FP32 cores). What bounds it: the float rate, 67 TFLOP/s, and
// inside that the shared-memory traffic of the inner loop (2*9*cin operations
// per byte moved is far above the card's ratio). Design: one block per (batch
// image, 8x16 output tile, 32-channel slice of co). The K loop walks the
// parts' base pointers one 16-channel chunk at a time, so each part contracts
// against its own rows of the [3,3,cin,co] weights and the concatenated tensor
// never exists. A chunk's 10x18 input halo (zero outside the image) and its
// 9x16x32 weight slab are staged in shared memory as float; each of 128
// threads then keeps 4 pixels x 8 channels of accumulators in registers,
// reading 8 weights as two float4 and 4 inputs per (tap, channel) step for 32
// FMAs. The TPU kernel's tap-packed [cin, 9*co] product and shift-add served
// its 128-lane matrix unit and is not carried over.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

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

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

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

// ---------------------------------------------------------------------------
// bfloat16: implicit GEMM on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kKC = 32;    // input channels per K chunk
constexpr int kAPix = 80;  // bytes per staged halo pixel: 64 of channels, 16 of
                           // padding, so 8 consecutive pixels (one ldmatrix's
                           // rows) start in 8 different bank groups

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, cached in L2 only; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               ::"r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Byte offset of 16-byte chunk c of row r in a weight slab whose rows hold
// kChunks chunks, XOR-swizzled so that the 8 rows one ldmatrix reads (8
// consecutive r, the same c) fall in 8 different bank groups. The pattern
// repeats every 8 rows: swz(r + 8 j, c) = swz(r, c) + 8 j rows.
template <int kChunks>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  static_assert(kChunks == 4 || kChunks == 8, "rows of 64 or 128 bytes");
  if constexpr (kChunks == 4) return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
  else return r * 128 + ((c ^ (r & 7)) << 4);
}

// 8 consecutive bf16 at g, of which the first n exist (the rest, and all of
// them when n <= 0, read as zero), packed for one 16-byte shared store.
__device__ __forceinline__ uint4 load8_masked(const __nv_bfloat16* g, int n) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(g);
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t lo = 2 * e < n ? s[2 * e] : 0u;
    const uint32_t hi = 2 * e + 1 < n ? s[2 * e + 1] : 0u;
    w[e] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

constexpr int kTileH = 12;  // pixel tile rows
constexpr int kTileW = 12;  // pixel tile columns
constexpr int kWarpsM = 3;  // warps over the tile's pixels
constexpr int kStages = 2;  // depth of the cp.async ring

// A block computes the pixel tile x kBN output channels (kBN = 32 or 64) with
// kWarpsM x kWarpsN warps; warp (wm, wn) owns kMT m16 row tiles and kNT n8
// column tiles of it.
template <int kBN>
struct MmaCfg {
  static constexpr int kWarpsN = kBN / 32;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kM = kTileH * kTileW;
  static constexpr int kHaloW = kTileW + 2;
  static constexpr int kHaloPix = (kTileH + 2) * kHaloW;
  static constexpr int kHaloTasks = (kHaloPix * (kKC / 8) + kThreads - 1) / kThreads;
  static constexpr int kABytes = kHaloPix * kAPix;
  static constexpr int kBBytes = 9 * kKC * kBN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes;
  static constexpr int kMT = kM / (16 * kWarpsM);
  static constexpr int kNT = kBN / (8 * kWarpsN);
  static constexpr int kPS = kBN + 8;  // floats per row of split-K partials
  static_assert(kMT * 16 * kWarpsM == kM, "m16 tiles split evenly over warps");
  static_assert(kNT % 2 == 0 && kNT * 8 * kWarpsN == kBN, "n8 tiles in pairs per warp");
  static_assert(kM * kPS * 4 <= kSmem, "the output tile (bf16) or partials (f32) fit the ring");
};

// One block: one (image, pixel tile, co slice) and, when ksplit > 1, one of
// the ksplit shares of the K chunks; the ksplit blocks of a tile form a
// thread-block cluster and sum their partials through distributed shared
// memory in rank order (no atomics: a rerun gives the same bits).
template <int kBN>
__global__ void __launch_bounds__(MmaCfg<kBN>::kThreads)
conv3x3_bf16_mma_kernel(Parts parts, const __nv_bfloat16* __restrict__ weight,
                        const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                        int H, int W, int cin, int co, int tiles_w, int ksplit, int vec_co) {
  using C = MmaCfg<kBN>;
  constexpr int kAChunks = kKC / 8;   // 16-byte chunks per halo pixel
  constexpr int kWChunks = kBN / 8;   // 16-byte chunks per weight row
  constexpr int kWRow = kBN * 2;      // bytes per weight row

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_addr(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp % kWarpsM;
  const int wn = warp / kWarpsM;
  const int rank = blockIdx.x % ksplit;
  const int tile = blockIdx.x / ksplit;
  const int n = blockIdx.z;
  const int n0 = blockIdx.y * kBN;
  const int y0 = (tile / tiles_w) * kTileH;
  const int x0 = (tile % tiles_w) * kTileW;

  // This block's K chunks [k_begin, k_end) of the parts' 32-channel chunks.
  int nk = 0;
  for (int p = 0; p < parts.n; ++p) nk += (parts.ch[p] + kKC - 1) / kKC;
  const int k_begin = nk * rank / ksplit, k_end = nk * (rank + 1) / ksplit;

  // Load cursor at chunk k_begin: part lp, channel lk in it, the part's
  // first row lrow of the weights' cin.
  int lp = 0, lrow = 0, skip = k_begin;
  while (lp < parts.n && skip >= (parts.ch[lp] + kKC - 1) / kKC) {
    skip -= (parts.ch[lp] + kKC - 1) / kKC;
    lrow += parts.ch[lp];
    ++lp;
  }
  int lk = skip * kKC;

  // The halo pixels this thread copies are the same for every chunk: their
  // pixel index in the image batch, or -1 outside the image.
  long long hpix[C::kHaloTasks];
#pragma unroll
  for (int s = 0; s < C::kHaloTasks; ++s) {
    const int q = (tid + s * C::kThreads) / kAChunks;
    const int gy = y0 + q / C::kHaloW - 1, gx = x0 + q % C::kHaloW - 1;
    hpix[s] = gy >= 0 && gy < H && gx >= 0 && gx < W ? (long long)(n * H + gy) * W + gx : -1;
  }

  auto load_chunk = [&](int stage) {
    const int cp = parts.ch[lp];
    const __nv_bfloat16* src = static_cast<const __nv_bfloat16*>(parts.ptr[lp]);
    const bool vec_a = cp % 8 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
    const uint32_t sa = sbase + stage * C::kStageBytes;
    const uint32_t sb = sa + C::kABytes;
#pragma unroll
    for (int s = 0; s < C::kHaloTasks; ++s) {
      const int i = tid + s * C::kThreads;
      if (i >= C::kHaloPix * kAChunks) break;
      const int q = i / kAChunks, c = i % kAChunks;
      const int k = lk + 8 * c;
      // channels of this 8-channel group that exist (<= 0: none, or outside)
      const int have = hpix[s] >= 0 ? cp - k : 0;
      const __nv_bfloat16* g = have > 0 ? src + hpix[s] * cp + k : src;
      const uint32_t dst = sa + q * kAPix + c * 16;
      if (vec_a) cp_async16(dst, g, have > 0 ? 16 : 0);
      else st_shared16(dst, load8_masked(g, have));
    }
    for (int i = tid; i < 9 * kKC * kWChunks; i += C::kThreads) {
      const int r = i / kWChunks, c = i % kWChunks;
      const int tap = r / kKC, k = lk + r % kKC;
      const int nn = n0 + 8 * c;
      const int have = k < cp ? co - nn : 0;
      const __nv_bfloat16* g =
          have > 0 ? weight + ((long long)(tap * cin + lrow + k) * co + nn) : weight;
      const uint32_t dst = sb + swz<kWChunks>(r, c);
      if (vec_co) cp_async16(dst, g, have > 0 ? 16 : 0);
      else st_shared16(dst, load8_masked(g, have));
    }
    lk += kKC;
    if (lk >= cp) {
      lk = 0;
      lrow += cp;
      do { ++lp; } while (lp < parts.n && parts.ch[lp] == 0);
    }
  };

  float acc[C::kMT][C::kNT][4];
#pragma unroll
  for (int i = 0; i < C::kMT; ++i)
#pragma unroll
    for (int j = 0; j < C::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // ldmatrix row addresses, fixed per lane; a tap and a k16 step only add a
  // constant. A (x4): lane l gives row l % 16 of the m16 tile, channels
  // 8 * (l / 16) of the k16 step: the halo pixel under that output pixel at
  // tap (0, 0). B (x4.trans): lane l gives weight row 8 * ((l / 8) % 2) + l % 8
  // of the k16 step, columns of the n8 tile 2 * jp + l / 16.
  uint32_t a_off[C::kMT];
#pragma unroll
  for (int i = 0; i < C::kMT; ++i) {
    const int m = (wm * C::kMT + i) * 16 + (lane & 15);
    a_off[i] = ((m / kTileW) * C::kHaloW + m % kTileW) * kAPix + (lane >> 4) * 16;
  }
  uint32_t b_off[C::kNT / 2];
#pragma unroll
  for (int jp = 0; jp < C::kNT / 2; ++jp)
    b_off[jp] = swz<kWChunks>(((lane >> 3) & 1) * 8 + (lane & 7),
                              wn * C::kNT + 2 * jp + (lane >> 4));

  const int count = k_end - k_begin;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < count) load_chunk(s);
    cp_async_commit();
  }
  for (int it = 0; it < count; ++it) {
    cp_async_wait<kStages - 2>();  // chunk `it` has landed (this thread's copies)
    __syncthreads();               // everyone's copies; everyone done with it - 1
    if (it + kStages - 1 < count) load_chunk((it + kStages - 1) % kStages);
    cp_async_commit();
    const uint32_t sa = sbase + (it % kStages) * C::kStageBytes;
    const uint32_t sb = sa + C::kABytes;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t a_tap = ((tap / 3) * C::kHaloW + tap % 3) * kAPix;
#pragma unroll
      for (int kk = 0; kk < kKC / 16; ++kk) {
        uint32_t a[C::kMT][4];
#pragma unroll
        for (int i = 0; i < C::kMT; ++i) ldsm_x4(a[i], sa + a_off[i] + a_tap + kk * 32);
        uint32_t b[C::kNT][2];
#pragma unroll
        for (int jp = 0; jp < C::kNT / 2; ++jp) {
          uint32_t r[4];
          ldsm_x4_trans(r, sb + b_off[jp] + (tap * kKC + 16 * kk) * kWRow);
          b[2 * jp][0] = r[0];
          b[2 * jp][1] = r[1];
          b[2 * jp + 1][0] = r[2];
          b[2 * jp + 1][1] = r[3];
        }
#pragma unroll
        for (int i = 0; i < C::kMT; ++i)
#pragma unroll
          for (int j = 0; j < C::kNT; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the epilogue stages through it

  // Accumulator (i, j): lane l holds rows l / 4 and l / 4 + 8 of m16 tile i,
  // columns 2 * (l % 4) and + 1 of n8 tile j.
  const int g4 = lane >> 2, t4 = lane & 3;
  if (ksplit == 1) {
    // bias in f32, one rounding, then 16-byte NHWC stores from shared memory
    constexpr int kCS = kBN + 8;  // padded row: the quads' 4-byte writes miss each other
    __nv_bfloat16* sc = reinterpret_cast<__nv_bfloat16*>(smem);
#pragma unroll
    for (int j = 0; j < C::kNT; ++j) {
      const int nl = (wn * C::kNT + j) * 8 + 2 * t4;
      const float b0 = bias != nullptr && n0 + nl < co ? bias[n0 + nl] : 0.f;
      const float b1 = bias != nullptr && n0 + nl + 1 < co ? bias[n0 + nl + 1] : 0.f;
#pragma unroll
      for (int i = 0; i < C::kMT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (wm * C::kMT + i) * 16 + g4 + 8 * h;
          *reinterpret_cast<uint32_t*>(sc + m * kCS + nl) =
              pack_bf16x2(acc[i][j][2 * h] + b0, acc[i][j][2 * h + 1] + b1);
        }
    }
    __syncthreads();
    for (int i = tid; i < C::kM * kWChunks; i += C::kThreads) {
      const int m = i / kWChunks, c = i % kWChunks;
      const int y = y0 + m / kTileW, x = x0 + m % kTileW, nn = n0 + 8 * c;
      if (y >= H || x >= W || nn >= co) continue;
      __nv_bfloat16* dst = out + ((long long)(n * H + y) * W + x) * co + nn;
      const __nv_bfloat16* v = sc + m * kCS + 8 * c;
      if (vec_co) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      } else {
        for (int e = 0; e < 8 && nn + e < co; ++e) dst[e] = v[e];
      }
    }
    return;
  }

  // Split K: this block's f32 partials to its shared memory; then it finishes
  // rows [m_begin, m_end) of the tile from every block's partials in rank
  // order, adds the bias in f32 and rounds once.
  float* sp = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < C::kNT; ++j)
#pragma unroll
    for (int i = 0; i < C::kMT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = (wm * C::kMT + i) * 16 + g4 + 8 * h;
        *reinterpret_cast<float2*>(sp + m * C::kPS + (wn * C::kNT + j) * 8 + 2 * t4) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int m_begin = C::kM * rank / ksplit, m_end = C::kM * (rank + 1) / ksplit;
  for (int i = m_begin * kWChunks + tid; i < m_end * kWChunks; i += C::kThreads) {
    const int m = i / kWChunks, c = i % kWChunks;
    const int y = y0 + m / kTileW, x = x0 + m % kTileW, nn = n0 + 8 * c;
    if (y >= H || x >= W || nn >= co) continue;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < ksplit; ++r) {
      const float4* p = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(sp + m * C::kPS + 8 * c, r));
      const float4 u = p[0], w = p[1];
      v[0] += u.x; v[1] += u.y; v[2] += u.z; v[3] += u.w;
      v[4] += w.x; v[5] += w.y; v[6] += w.z; v[7] += w.w;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (bias != nullptr && nn + e < co) v[e] += bias[nn + e];
    __nv_bfloat16* dst = out + ((long long)(n * H + y) * W + x) * co + nn;
    if (vec_co) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                                  pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
    } else {
      for (int e = 0; e < 8 && nn + e < co; ++e) dst[e] = __float2bfloat16(v[e]);
    }
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

using Bf16Kernel = void (*)(Parts, const __nv_bfloat16*, const float*, __nv_bfloat16*,
                            int, int, int, int, int, int, int);

struct Bf16Variant {
  int bn, threads, smem;
  Bf16Kernel kernel;
};

template <int kBN>
Bf16Variant bf16_variant() {
  return {kBN, MmaCfg<kBN>::kThreads, MmaCfg<kBN>::kSmem, conv3x3_bf16_mma_kernel<kBN>};
}

struct Bf16Launch {
  Bf16Variant v;
  int split;
  dim3 grid;
};

constexpr int kMaxDevices = 64;

// The launch for a shape. Co slice: 32 when co <= 32, else 64. K is split
// over a cluster of 2 blocks when twice the grid still fits in one round of
// the blocks the card holds at once (so the split only fills SMs that would
// idle) and each half keeps at least 3 chunks. On the H100 that splits the
// 24x24 and 12x12 nodes of NestedUNet at batch 16; splits of 3, 4 and 8, and
// a split at 48x48, measured slower (PERF.md). A variant's first plan on a
// device sets its shared-memory limit there and caches how many of its
// blocks the device holds at once; later plans only do the arithmetic.
cudaError_t plan_bf16(int B, int H, int W, int co, const int* part_ch, int nparts,
                      Bf16Launch* plan) {
  static const Bf16Variant table[2] = {bf16_variant<32>(), bf16_variant<64>()};
  static std::atomic<int> resident_of[kMaxDevices][2];  // 0: not set up yet
  const int slice = co > 32 ? 1 : 0;
  const Bf16Variant& v = table[slice];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int resident = resident_of[dev][slice].load(std::memory_order_relaxed);
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(v.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, v.smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, v.kernel, v.threads, v.smem);
    if (err != cudaSuccess) return err;
    resident = sms * per_sm;
    resident_of[dev][slice].store(resident, std::memory_order_relaxed);
  }
  int nk = 0;
  for (int i = 0; i < nparts; ++i) nk += (part_ch[i] + kKC - 1) / kKC;
  const int tiles = (H + kTileH - 1) / kTileH * ((W + kTileW - 1) / kTileW);
  const long long blocks = (long long)tiles * ((co + v.bn - 1) / v.bn) * B;
  const int split = 2 * blocks <= resident && nk >= 6 ? 2 : 1;
  *plan = {v, split, dim3(tiles * split, (co + v.bn - 1) / v.bn, B)};
  return cudaSuccess;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) {
    const int tiles_w = (W + TW - 1) / TW;
    const int tiles_h = (H + TH - 1) / TH;
    const dim3 grid(tiles_h * tiles_w, (co + CO_T - 1) / CO_T, B);
    multipart_conv3x3_kernel<float><<<grid, THREADS, 0, s>>>(
        parts, static_cast<const float*>(weight), b, static_cast<float*>(out),
        H, W, cin, co, tiles_w);
  } else if (dtype == 1) {
    Bf16Launch plan;
    const cudaError_t err = plan_bf16(B, H, W, co, part_ch, nparts, &plan);
    if (err != cudaSuccess) return (int)err;
    const int vec_co = co % 8 == 0 && reinterpret_cast<uintptr_t>(weight) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = plan.grid;
    cfg.blockDim = dim3(plan.v.threads);
    cfg.dynamicSmemBytes = plan.v.smem;
    cfg.stream = s;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = plan.split;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = plan.split > 1 ? 1 : 0;
    const cudaError_t launch = cudaLaunchKernelEx(
        &cfg, plan.v.kernel, parts, static_cast<const __nv_bfloat16*>(weight), b,
        static_cast<__nv_bfloat16*>(out), H, W, cin, co, (W + kTileW - 1) / kTileW,
        plan.split, vec_co);
    if (launch != cudaSuccess) return (int)launch;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The bf16 launch decoder_fusion_fwd makes for a shape: out = {tile rows,
// tile columns, co per block, K split, blocks, threads per block, dynamic
// shared bytes}. Returns a cudaError_t (0 on success).
extern "C" int decoder_fusion_bf16_plan(int B, int H, int W, int co, const int* part_ch,
                                        int nparts, int* out) {
  Bf16Launch plan;
  const cudaError_t err = plan_bf16(B, H, W, co, part_ch, nparts, &plan);
  if (err != cudaSuccess) return (int)err;
  const int values[7] = {kTileH, kTileW, plan.v.bn, plan.split,
                         (int)(plan.grid.x * plan.grid.y * plan.grid.z), plan.v.threads,
                         plan.v.smem};
  for (int i = 0; i < 7; ++i) out[i] = values[i];
  return 0;
}
