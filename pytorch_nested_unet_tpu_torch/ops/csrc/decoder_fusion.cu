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
// ((12+2)x(12+2) pixels x 64 bytes) and its [9][32][N] weight slab are staged
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
// float32 (FP32 cores; no TF32, no HMMA: the fp32 path is held to 1e-4).
// What bounds it: the float rate, 67 TFLOP/s, 1.62 ms for the ~109 GFLOP of
// the 10 nodes at batch 16; inside that, the shared-memory reads of the inner
// loop and the instruction rate. Design: an implicit GEMM on the same
// skeleton, one block per (image, 12x12 pixel tile, 32- or 64-wide co
// slice), the K loop over the parts in 16-channel chunks staged by 16-byte
// cp.async copies (4 floats; zero-filled outside the image and past a part's
// or co's end, scalar loads where a channel count is not a multiple of 4)
// through the 2-stage ring. The halo is staged as 4 planes of 4 channels,
// each 14x14 pixels of 16 bytes, planes padded to 202 units (2 mod 8), so the
// copies (4 planes of a pixel and the next pixel) and the reads (rows of the
// tile) fall in different bank groups. A thread owns one tile row x 4 output
// channels (48 accumulators; at a 32-wide co slice, two threads split the
// planes of each chunk and add up at the end, so that a block still has 6
// warps). For each kernel row dy and 4-channel plane it holds the 3 taps'
// 4x4 weights in registers (12 LDS.128, broadcast over the warp's rows) and
// streams the 14 halo pixels of its row (14 LDS.128), each feeding the up to
// 3 output pixels it lies under: the taps are offsets into the one staged
// halo, and 576 FMAs come from 104 shared words (5.5 per word). Split-K over
// a 2-block cluster follows the bf16 rule and sums in rank order through
// distributed shared memory. The TPU kernel's tap-packed [cin, 9*co] product
// and shift-add served its 128-lane matrix unit and are not carried over.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxParts = 8;

struct Parts {
  const void* ptr[kMaxParts];
  int ch[kMaxParts];
  int n;
};

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

// ---------------------------------------------------------------------------
// float32: implicit GEMM on the FP32 cores
// ---------------------------------------------------------------------------

constexpr int kFKC = 16;                           // input channels per K chunk
constexpr int kFHaloW = kTileW + 2;                // halo columns (and rows: 12x12 tile)
constexpr int kFHaloPix = (kTileH + 2) * kFHaloW;  // 196
constexpr int kFPlane = kFHaloPix + 6;  // 16-byte units per staged 4-channel plane, 2 (mod 8)

// At co slice 32 the 96 (tile row, co group) threads would leave an SM 9
// warps at 3 blocks; there the 4 planes of a chunk are split between two
// halves of 96 threads, whose accumulators are summed in fixed order at the
// end, so every variant runs 192 threads.
template <int kBN>
struct FmaCfg {
  static constexpr int kGroups = kBN / 4;            // 4-channel co groups
  static constexpr int kKHalves = kBN == 32 ? 2 : 1;  // planes split over thread halves
  static constexpr int kPlanes = 4 / kKHalves;       // planes per half
  static constexpr int kThreads = kKHalves * kTileH * kGroups;  // (half, tile row, co group)
  static constexpr int kMinBlocks = 2;               // per SM, as the ring allows
  static constexpr int kHaloTasks = (kFHaloPix * 4 + kThreads - 1) / kThreads;
  static constexpr int kABytes = 4 * kFPlane * 16;
  static constexpr int kBBytes = 9 * kFKC * kBN * 4;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kSmem = kStages * kStageBytes;
  static constexpr int kPS = kBN + 4;  // floats per row of split-K partials
  static_assert(kTileH * kTileW * kPS * 4 <= kSmem, "split-K partials fit the ring");
  static_assert(kABytes % 16 == 0 && kStageBytes % 16 == 0, "16-byte aligned stages");
};

// 4 consecutive floats at g, of which the first n exist (the rest, and all of
// them when n <= 0, read as zero), packed for one 16-byte shared store.
__device__ __forceinline__ uint4 load4_masked(const float* g, int n) {
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) w[e] = e < n ? __float_as_uint(g[e]) : 0u;
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

// One block: one (image, pixel tile, co slice) and, when ksplit > 1, one of
// the ksplit shares of the 16-channel K chunks, as the bf16 kernel. Thread
// (kh, row, grp) accumulates tile row `row` x channels n0 + 4*grp .. + 3 over
// planes kh*kPlanes .. + kPlanes - 1 of each chunk.
template <int kBN>
__global__ void __launch_bounds__(FmaCfg<kBN>::kThreads, FmaCfg<kBN>::kMinBlocks)
conv3x3_f32_fma_kernel(Parts parts, const float* __restrict__ weight,
                       const float* __restrict__ bias, float* __restrict__ out, int H, int W,
                       int cin, int co, int tiles_w, int ksplit, int vec_co) {
  using C = FmaCfg<kBN>;
  constexpr int kWUnits = kBN / 4;  // 16-byte units per weight row

  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sbase = smem_addr(smem);
  const int tid = threadIdx.x;
  const int kh = tid / (kTileH * C::kGroups);
  const int row = tid / C::kGroups % kTileH;
  const int grp = tid % C::kGroups;
  const int rank = blockIdx.x % ksplit;
  const int tile = blockIdx.x / ksplit;
  const int n = blockIdx.z;
  const int n0 = blockIdx.y * kBN;
  const int y0 = (tile / tiles_w) * kTileH;
  const int x0 = (tile % tiles_w) * kTileW;

  int nk = 0;
  for (int p = 0; p < parts.n; ++p) nk += (parts.ch[p] + kFKC - 1) / kFKC;
  const int k_begin = nk * rank / ksplit, k_end = nk * (rank + 1) / ksplit;
  int lp = 0, lrow = 0, skip = k_begin;
  while (lp < parts.n && skip >= (parts.ch[lp] + kFKC - 1) / kFKC) {
    skip -= (parts.ch[lp] + kFKC - 1) / kFKC;
    lrow += parts.ch[lp];
    ++lp;
  }
  int lk = skip * kFKC;

  // Copy task i = (halo pixel i / 4, plane i % 4): the same pixels every
  // chunk; their pixel index in the batch, or -1 outside the image.
  int hpix[C::kHaloTasks];
#pragma unroll
  for (int s = 0; s < C::kHaloTasks; ++s) {
    const int i = tid + s * C::kThreads;
    const int q = i / 4;
    const int gy = y0 + q / kFHaloW - 1, gx = x0 + q % kFHaloW - 1;
    hpix[s] = i < kFHaloPix * 4 && gy >= 0 && gy < H && gx >= 0 && gx < W
                  ? (n * H + gy) * W + gx : -1;
  }

  auto load_chunk = [&](int stage) {
    const int cp = parts.ch[lp];
    const float* src = static_cast<const float*>(parts.ptr[lp]);
    const bool vec_a = cp % 4 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0;
    const uint32_t sa = sbase + stage * C::kStageBytes;
    const uint32_t sb = sa + C::kABytes;
#pragma unroll
    for (int s = 0; s < C::kHaloTasks; ++s) {
      const int i = tid + s * C::kThreads;
      if (i >= kFHaloPix * 4) break;
      const int q = i / 4, kq = i % 4;
      const int k = lk + 4 * kq;
      const int have = hpix[s] >= 0 ? cp - k : 0;  // channels from k on (<= 0: none)
      const float* g = have > 0 ? src + (long long)hpix[s] * cp + k : src;
      const uint32_t dst = sa + (kq * kFPlane + q) * 16;
      if (vec_a) cp_async16(dst, g, have > 0 ? 16 : 0);
      else st_shared16(dst, load4_masked(g, have));
    }
    for (int i = tid; i < 9 * kFKC * kWUnits; i += C::kThreads) {
      const int r = i / kWUnits, c = i % kWUnits;
      const int tap = r / kFKC, k = lk + r % kFKC;
      const int nn = n0 + 4 * c;
      const int have = k < cp ? co - nn : 0;
      const float* g = have > 0 ? weight + ((long long)(tap * cin + lrow + k) * co + nn) : weight;
      const uint32_t dst = sb + i * 16;
      if (vec_co) cp_async16(dst, g, have > 0 ? 16 : 0);
      else st_shared16(dst, load4_masked(g, have));
    }
    lk += kFKC;
    if (lk >= cp) {
      lk = 0;
      lrow += cp;
      do { ++lp; } while (lp < parts.n && parts.ch[lp] == 0);
    }
  };

  float acc[kTileW][4];
#pragma unroll
  for (int j = 0; j < kTileW; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int count = k_end - k_begin;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < count) load_chunk(s);
    cp_async_commit();
  }
  for (int it = 0; it < count; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (it + kStages - 1 < count) load_chunk((it + kStages - 1) % kStages);
    cp_async_commit();
    const unsigned char* sa = smem + (it % kStages) * C::kStageBytes;
    const float4* sw = reinterpret_cast<const float4*>(sa + C::kABytes) + grp;
#pragma unroll 1
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll 1
      for (int kq = kh * C::kPlanes; kq < (kh + 1) * C::kPlanes; ++kq) {
        // w[dx][kk]: tap (dy, dx), input channel 4*kq + kk, this thread's 4 co
        float4 w[3][4];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            w[dx][kk] = sw[((dy * 3 + dx) * kFKC + 4 * kq + kk) * kWUnits];
        const float4* a =
            reinterpret_cast<const float4*>(sa) + kq * kFPlane + (row + dy) * kFHaloW;
#pragma unroll
        for (int c = 0; c < kFHaloW; ++c) {
          const float4 v = a[c];  // halo pixel c of row row+dy, channels 4*kq..+3
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int j = c - dx;  // the output pixel it lies under at tap dx
            if (j < 0 || j >= kTileW) continue;
            fma4(acc[j], v.x, w[dx][0]);
            fma4(acc[j], v.y, w[dx][1]);
            fma4(acc[j], v.z, w[dx][2]);
            fma4(acc[j], v.w, w[dx][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the folds below stage through it

  float* sp = reinterpret_cast<float*>(smem);
  if constexpr (C::kKHalves == 2) {  // half 1's sums onto half 0's
    if (kh == 1)
#pragma unroll
      for (int j = 0; j < kTileW; ++j)
        *reinterpret_cast<float4*>(sp + (row * kTileW + j) * C::kPS + 4 * grp) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
    __syncthreads();
    if (kh == 0)
#pragma unroll
      for (int j = 0; j < kTileW; ++j) {
        const float4 u =
            *reinterpret_cast<const float4*>(sp + (row * kTileW + j) * C::kPS + 4 * grp);
        acc[j][0] += u.x; acc[j][1] += u.y; acc[j][2] += u.z; acc[j][3] += u.w;
      }
    __syncthreads();
  }

  if (ksplit == 1) {
    const int y = y0 + row, nn = n0 + 4 * grp;
    if (kh != 0 || y >= H || nn >= co) return;
    float b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) b[e] = bias != nullptr && nn + e < co ? bias[nn + e] : 0.f;
    float* dst = out + ((long long)(n * H + y) * W + x0) * co + nn;
#pragma unroll
    for (int j = 0; j < kTileW; ++j) {
      if (x0 + j >= W) break;
      const float4 v = make_float4(acc[j][0] + b[0], acc[j][1] + b[1], acc[j][2] + b[2],
                                   acc[j][3] + b[3]);
      if (vec_co) {
        *reinterpret_cast<float4*>(dst + (long long)j * co) = v;
      } else {
        const float e4[4] = {v.x, v.y, v.z, v.w};
        for (int e = 0; e < 4 && nn + e < co; ++e) dst[(long long)j * co + e] = e4[e];
      }
    }
    return;
  }

  // Split K: partials to this block's shared memory; then it finishes rows
  // [m_begin, m_end) of the tile from every block's partials in rank order.
  if (kh == 0)
#pragma unroll
    for (int j = 0; j < kTileW; ++j)
      *reinterpret_cast<float4*>(sp + (row * kTileW + j) * C::kPS + 4 * grp) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int kM = kTileH * kTileW;
  const int m_begin = kM * rank / ksplit, m_end = kM * (rank + 1) / ksplit;
  for (int i = m_begin * kWUnits + tid; i < m_end * kWUnits; i += C::kThreads) {
    const int m = i / kWUnits, c = i % kWUnits;
    const int y = y0 + m / kTileW, x = x0 + m % kTileW, nn = n0 + 4 * c;
    if (y >= H || x >= W || nn >= co) continue;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < ksplit; ++r) {
      const float4 u = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(sp + m * C::kPS + 4 * c, r));
      v[0] += u.x; v[1] += u.y; v[2] += u.z; v[3] += u.w;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (bias != nullptr && nn + e < co) v[e] += bias[nn + e];
    float* dst = out + ((long long)(n * H + y) * W + x) * co + nn;
    if (vec_co) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int e = 0; e < 4 && nn + e < co; ++e) dst[e] = v[e];
    }
  }
  cluster.sync();  // no block leaves while another still reads its partials
}

// A kernel of either dtype and its launch shape; both kernels take
// (Parts, weight, bias, out, H, W, cin, co, tiles_w, ksplit, vec_co).
struct Variant {
  int bn, threads, smem, chunk;  // chunk: input channels per K step
  const void* fn;
};

template <int kBN>
Variant bf16_variant() {
  return {kBN, MmaCfg<kBN>::kThreads, MmaCfg<kBN>::kSmem, kKC,
          reinterpret_cast<const void*>(conv3x3_bf16_mma_kernel<kBN>)};
}

template <int kBN>
Variant f32_variant() {
  return {kBN, FmaCfg<kBN>::kThreads, FmaCfg<kBN>::kSmem, kFKC,
          reinterpret_cast<const void*>(conv3x3_f32_fma_kernel<kBN>)};
}

struct Launch {
  Variant v;
  int split;
  dim3 grid;
};

constexpr int kMaxDevices = 64;

// The launch for a shape in dtype 0 (float32) or 1 (bfloat16). Co slice: 32
// when co <= 32, else 64. K is split over a cluster of 2 blocks when twice
// the grid still fits in one round of the blocks the card holds at once (so
// the split only fills SMs that would idle) and each half keeps at least 3
// chunks. On the H100 that splits the 24x24 and 12x12 nodes of NestedUNet at
// batch 16; in bf16, splits of 3, 4 and 8, and a split at 48x48, measured
// slower (PERF.md). A variant's first plan on a device sets its shared-memory
// limit there and caches how many of its blocks the device holds at once;
// later plans only do the arithmetic.
cudaError_t plan_launch(int dtype, int B, int H, int W, int co, const int* part_ch, int nparts,
                        Launch* plan) {
  static const Variant table[2][2] = {{f32_variant<32>(), f32_variant<64>()},
                                      {bf16_variant<32>(), bf16_variant<64>()}};
  static std::atomic<int> resident_of[kMaxDevices][2][2];  // 0: not set up yet
  const int slice = co > 32 ? 1 : 0;
  const Variant& v = table[dtype][slice];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  int resident = resident_of[dev][dtype][slice].load(std::memory_order_relaxed);
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, v.smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, v.fn, v.threads, v.smem);
    if (err != cudaSuccess) return err;
    resident = sms * per_sm;
    resident_of[dev][dtype][slice].store(resident, std::memory_order_relaxed);
  }
  int nk = 0;
  for (int i = 0; i < nparts; ++i) nk += (part_ch[i] + v.chunk - 1) / v.chunk;
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
  if (nparts < 1 || nparts > kMaxParts || B < 1 || H < 1 || W < 1 || co < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Parts parts;
  int cin = 0;
  for (int i = 0; i < kMaxParts; ++i) {
    parts.ptr[i] = i < nparts ? part_ptrs[i] : nullptr;
    parts.ch[i] = i < nparts ? part_ch[i] : 0;
    cin += parts.ch[i];
  }
  parts.n = nparts;
  Launch plan;
  const cudaError_t err = plan_launch(dtype, B, H, W, co, part_ch, nparts, &plan);
  if (err != cudaSuccess) return (int)err;
  // 16-byte weight rows and output stores: 4 floats or 8 bf16
  int vec_co = co % (dtype == 0 ? 4 : 8) == 0 && reinterpret_cast<uintptr_t>(weight) % 16 == 0 &&
               reinterpret_cast<uintptr_t>(out) % 16 == 0;
  int tiles_w = (W + kTileW - 1) / kTileW;
  int split = plan.split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = plan.grid;
  cfg.blockDim = dim3(plan.v.threads);
  cfg.dynamicSmemBytes = plan.v.smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = plan.split;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = plan.split > 1 ? 1 : 0;
  void* args[] = {&parts, &weight, &bias, &out, &H, &W, &cin, &co, &tiles_w, &split, &vec_co};
  const cudaError_t launch = cudaLaunchKernelExC(&cfg, plan.v.fn, args);
  if (launch != cudaSuccess) return (int)launch;
  return (int)cudaGetLastError();
}

// The launch decoder_fusion_fwd makes for a shape in `dtype`: out = {tile
// rows, tile columns, co per block, K split, blocks, threads per block,
// dynamic shared bytes}. Returns a cudaError_t (0 on success).
extern "C" int decoder_fusion_plan(int dtype, int B, int H, int W, int co, const int* part_ch,
                                   int nparts, int* out) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  Launch plan;
  const cudaError_t err = plan_launch(dtype, B, H, W, co, part_ch, nparts, &plan);
  if (err != cudaSuccess) return (int)err;
  const int values[7] = {kTileH, kTileW, plan.v.bn, plan.split,
                         (int)(plan.grid.x * plan.grid.y * plan.grid.z), plan.v.threads,
                         plan.v.smem};
  for (int i = 0; i < 7; ++i) out[i] = values[i];
  return 0;
}
