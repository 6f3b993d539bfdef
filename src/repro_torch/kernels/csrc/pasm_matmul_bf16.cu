// K1, bf16 activations — two routes of the fused-dequant PASM GEMM for sm_90a.
//
// Replaces the TPU kernel repro/kernels/pasm_matmul.py::pasm_matmul_kernel_call
// (_kernel -> _fused_dequant_step, _dequant_tile, _unpack_int4_tile) for a
// bf16 x, which the JAX kernel computes as
//
//   out (M, N) f32 = relu(x (M, K) . W (K, N) + bias)
//   W[k, n] = bf16(codebook[k / (K / G)][idx[k, n]])     (never stored)
//
// with every tile dequantized to x's dtype and the sum in f32.  A bf16 x bf16
// product is exact in f32, so both routes compute the JAX kernel's products;
// only the order of the sum differs.  f32 x, and any fused pool, stay on the
// SIMT kernel (pasm_matmul.cu), which K2 matches bitwise.  The wrapper
// (kernels/pasm_matmul.py::k1_plan) picks the route from M, K, N alone.
//
// Both routes run mma.sync.m16n8k16 (bf16 in, f32 accumulate) with the
// weights as the A operand and x as B (Yᵀ = Wᵀ xᵀ), and dequantize straight
// into A fragments in registers: no weight tile is ever stored, in device or
// shared memory.  Lane (g = lane / 4, t = lane % 4) of a warp owning C
// columns reads the index bytes of columns c0 + (C / 8) g .. + C / 8 - 1 of
// pair rows t and t + 4 of a k16 block (a packed byte holds K rows 2p and
// 2p + 1): those bytes are exactly its A fragments of C / 16 m16 tiles, tile
// i's row g being column c0 + (C / 8) g + 2i and row g + 8 the column after.
// A packed byte is one A register (two bf16 along k): one lookup in a
// 256-entry bf16x2 pair table, replicated across the 32 banks (lane l reads
// copy l % 32) so a warp's lookups never conflict.  uint8 indices are one
// K row a byte: two lookups in a 256-entry bf16 table make a register.  An
// index >= B clamps to the last codeword, as the TPU kernel's gather does.
//
// stream (decode, M <= M0).  Bound by the index bytes: at M = 4 a weight
// byte feeds 16 flops, far below the card's 295 flops a byte, so the time
// is the int4 index stream over 3.35 TB/s, if the dequant keeps up.
//  - Up to 8 rows of x are one n8 B tile (16 rows two), so nothing is
//    computed for rows that do not exist, and no per-row FMA is issued.
//  - A block of 8 warps owns a 128-column strip (16 bytes a lane, 16-byte
//    coalesced loads); the warps take interleaved k16 blocks and the next
//    batch of index and x loads is in flight while one is dequantized.  x's
//    B fragments are read from L2 (a few hundred KB, shared by every block).
//  - Split-K fills the card where N alone cannot (w2: K = 25600, 40
//    strips): each split writes its partial (M, N) to a scratch the wrapper
//    allocates, and a second pass adds the splits in split order, then bias
//    and ReLU.  No atomics: a result is bitwise repeatable.  (Finishing each
//    tile in its last split block, found by an integer ticket, was slower
//    on mma on an H100: one block then sums a 64 x 256 tile over every
//    split.)
//
// mma (prefill, M > M0).  Bound by operations: 2·M·K·N at 989 TFLOP/s bf16.
//  - A block of 8 warps owns a 64 x 256 output tile, each warp 32 columns
//    (4 index bytes a lane, 2 m16 tiles) x all 64 rows (8 n8 tiles), so an
//    A register feeds 8 mma; 64-row blocks keep two blocks an SM.
//  - x tiles (64 x 64) and index tiles (64 K rows x 256 columns) come by
//    cp.async into a 4-slot ring, two stages in flight; one barrier a
//    stage (64 K rows a stage: 12-15 % faster than 32 on an H100 at the
//    LM shapes).  x's B fragments are read with ldmatrix from rows padded by 16
//    bytes, the index bytes with 4-byte reads from rows padded to 8 words
//    mod 32: both conflict-free.
//  - The epilogue stages the f32 tile through shared memory, half at a
//    time, so the stores are coalesced 128-byte rows.
//  - Split-K by K and N, as in stream, where the column blocks alone leave
//    SMs idle (w2, wq); the same ordered second pass adds the splits.
//
// In both routes an output sums its k16 blocks in an order set by K, N and
// the route only, and a row of x is one B column whose result does not
// depend on the others, so a row computed in a batch equals the row
// computed alone.  Ragged M, N and K edges are masked (zero-filled loads,
// masked stores); nothing is padded in memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace k1b {

using bf16 = __nv_bfloat16;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int RL = 5;  // 32 bank copies of a pair table: 32 KB a dictionary
constexpr int MAX_GROUPS = 2;  // dictionaries the routes take

// ---------------------------------------------------------------------------
// dictionaries
// ---------------------------------------------------------------------------

// packed: [G][256][2^RL] bf16x2 (cb[lo nibble], cb[hi nibble]), copies
// interleaved; each thread writes one entry's copies 16 bytes at a time,
// starting at a lane-rotated chunk so a warp's stores never conflict
__device__ __forceinline__ void fill_pair_table(uint32_t* tab,
                                                const float* __restrict__ cb,
                                                int G, int B) {
  constexpr int R = 1 << RL;
  for (int e = threadIdx.x; e < G * 256; e += THREADS) {
    const float* c = cb + (e / 256) * B;
    const int by = e % 256;
    const uint32_t v =
        tc::pack_bf16x2(__float2bfloat16_rn(c[min(by & 0xF, B - 1)]),
                        __float2bfloat16_rn(c[min(by >> 4, B - 1)]));
    uint32_t* dst = tab + ((size_t)e << RL);
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const int q = (j + threadIdx.x) % (R / 4);
      *reinterpret_cast<uint4*>(dst + 4 * q) = make_uint4(v, v, v, v);
    }
  }
}

// uint8: [G][256] bf16, entries past B clamped
__device__ __forceinline__ void fill_byte_table(uint16_t* tab,
                                                const float* __restrict__ cb,
                                                int G, int B) {
  for (int e = threadIdx.x; e < G * 256; e += THREADS)
    tab[e] = __bfloat16_as_ushort(
        __float2bfloat16_rn(cb[(e / 256) * B + min(e % 256, B - 1)]));
}

// A registers of one m16 tile of a k16 block, from the index bytes of pair
// rows t (w0) and t + 4 (w1): row g is byte sel, row g + 8 byte sel + 1
__device__ __forceinline__ void a_packed(uint32_t (&a)[4], const uint32_t* t0,
                                         const uint32_t* t1, uint32_t w0,
                                         uint32_t w1, int sel) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    a[h] = t0[__byte_perm(w0, 0, 0x4440 | (sel + h)) << RL];
    a[2 + h] = t1[__byte_perm(w1, 0, 0x4440 | (sel + h)) << RL];
  }
}

// the same from the bytes of K rows 2t, 2t + 1 (r0, r1) and 2t + 8, 2t + 9
// (r2, r3), one bf16 a byte
__device__ __forceinline__ void a_bytes(uint32_t (&a)[4], const uint16_t* t0,
                                        const uint16_t* t0h, const uint16_t* t1,
                                        const uint16_t* t1h, uint32_t r0,
                                        uint32_t r1, uint32_t r2, uint32_t r3,
                                        int sel) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = 0x4440 | (sel + h);
    a[h] = t0[__byte_perm(r0, 0, s)] | (uint32_t)t0h[__byte_perm(r1, 0, s)] << 16;
    a[2 + h] = t1[__byte_perm(r2, 0, s)] | (uint32_t)t1h[__byte_perm(r3, 0, s)] << 16;
  }
}

__device__ __forceinline__ uint32_t word_of(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// out = relu(Σ_s part[s] + bias), the splits added in order (a second pass:
// no float atomics, a result bitwise repeatable)
__global__ void __launch_bounds__(THREADS)
    splitk_reduce(const float* __restrict__ part,
                  const float* __restrict__ bias, float* __restrict__ out,
                  long long MN, int N, int splits, int relu) {
  for (long long o = blockIdx.x * (long long)THREADS + threadIdx.x; o < MN;
       o += (long long)gridDim.x * THREADS) {
    float v = part[o];
    for (int s = 1; s < splits; ++s) v += part[s * MN + o];
    if (bias != nullptr) v += bias[o % N];
    if (relu) v = v < 0.f ? 0.f : v;  // NaN passes, as torch.clamp
    out[o] = v;
  }
}

static int splitk_finish(const float* part, const float* bias, float* out,
                         int M, int N, int splits, int relu, cudaStream_t s) {
  const long long MN = (long long)M * N;
  const int blocks = (int)min((MN + THREADS - 1) / THREADS, 4096LL);
  splitk_reduce<<<blocks, THREADS, 0, s>>>(part, bias, out, MN, N, splits,
                                           relu);
  return (int)cudaGetLastError();
}

// bias and ReLU (only without split-K), then the store
__device__ __forceinline__ void store_out(float* __restrict__ dst,
                                          const float* __restrict__ bias,
                                          long long m, int c, int M, int N,
                                          float v, bool final_, int relu) {
  if (m >= M || c >= N) return;
  if (final_) {
    if (bias != nullptr) v += bias[c];
    if (relu) v = v < 0.f ? 0.f : v;  // NaN passes, as torch.clamp
  }
  dst[m * N + c] = v;
}

// ---------------------------------------------------------------------------
// stream
// ---------------------------------------------------------------------------

constexpr int S_BN = 128;  // columns per block: a warp's strip, 16 a lane

__device__ __forceinline__ uint4 load_idx16(const uint8_t* __restrict__ idx,
                                            long long r, int n, int N,
                                            bool vec) {
  const uint8_t* p = idx + r * N + n;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (n + j < N) w[j / 4] |= (uint32_t)__ldg(p + j) << (8 * (j % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// two bf16 of x row m at K rows k, k + 1 (zero past M or K)
__device__ __forceinline__ uint32_t load_x2(const bf16* __restrict__ x,
                                            long long m, int M, int k, int K,
                                            bool xvec) {
  if (m >= M || k >= K) return 0u;
  const bf16* p = x + m * K + k;
  if (xvec) return __ldg(reinterpret_cast<const unsigned int*>(p));
  const uint32_t lo = __bfloat16_as_ushort(p[0]);
  return k + 1 < K ? lo | (uint32_t)__bfloat16_as_ushort(p[1]) << 16 : lo;
}

template <int NT, bool PACKED>
struct StreamBatch {
  static constexpr int U = 2;                 // k16 blocks a batch, per warp
  static constexpr int NLD = PACKED ? 2 : 4;  // 16-byte index loads per k16
  uint4 ld[U][NLD];
  uint32_t b[U][NT][2];
};

template <int NT, bool PACKED>
__global__ void __launch_bounds__(THREADS)
    stream_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ idx,
                  const float* __restrict__ cb, const float* __restrict__ bias,
                  float* __restrict__ out, float* __restrict__ part, int M,
                  int K, int N, int G, int B, int relu, int splits) {
  using Batch = StreamBatch<NT, PACKED>;
  constexpr int U = Batch::U, NLD = Batch::NLD;
  constexpr int MR = 8 * NT;  // rows of x a block takes
  extern __shared__ float4 dyn4[];
  float* red = reinterpret_cast<float*>(dyn4);                  // [MR][S_BN]
  uint32_t* tab = reinterpret_cast<uint32_t*>(red + MR * S_BN);  // the table

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int nb = blockIdx.x * S_BN, ncol = nb + 16 * g;
  const int split = blockIdx.y;
  const long long mb = (long long)blockIdx.z * MR;
  const int rows = (int)min((long long)MR, M - mb);
  const int gs = K / G;
  const int nkb = (K + 15) / 16;
  const int per = (nkb + splits - 1) / splits;
  const int kb_beg = min(nkb, split * per), kb_end = min(nkb, kb_beg + per);
  const bool vec = (N % 16 == 0) && ncol + 16 <= N &&
                   (reinterpret_cast<uintptr_t>(idx) % 16 == 0);
  const bool xvec = (K % 2 == 0) && (reinterpret_cast<uintptr_t>(x) % 4 == 0);

  const uint32_t* tl = tab + (lane & ((1 << RL) - 1));  // this lane's copy
  const uint16_t* t16 = reinterpret_cast<const uint16_t*>(tab);

  // the loads of the k16 blocks kb, kb + WARPS, ... (U of them) into bt
  auto load = [&](int kb, Batch& bt) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kbu = kb + u * WARPS;
      const bool live = kbu < kb_end;
#pragma unroll
      for (int l = 0; l < NLD; ++l) {
        // packed: pair rows 8 kbu + t (+ 4); uint8: K rows 16 kbu + 2t
        // (+ 1, + 8, + 9)
        const long long r = PACKED ? 8LL * kbu + t + 4 * l
                                   : 16LL * kbu + 2 * t + (l % 2) + 8 * (l / 2);
        const bool in = live && r < (PACKED ? K / 2 : K);
        bt.ld[u][l] = in ? load_idx16(idx, r, ncol, N, vec) : make_uint4(0u, 0u, 0u, 0u);
      }
      const int k = 16 * kbu + 2 * t;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const long long m = mb + 8 * n + g;
        bt.b[u][n][0] = live ? load_x2(x, m, M, k, K, xvec) : 0u;
        bt.b[u][n][1] = live ? load_x2(x, m, M, k + 8, K, xvec) : 0u;
      }
    }
  };

  float acc[8][NT][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n) acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

  auto compute = [&](int kb, const Batch& bt) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int kbu = kb + u * WARPS;
      if (kbu >= kb_end) break;
      const int k = 16 * kbu + 2 * t;
      // dictionaries of K rows k, k + 1 and k + 8, k + 9
      int d0 = 0, d0h = 0, d1 = 0, d1h = 0;
      if (G > 1) {
        d0 = min(k, K - 1) / gs;
        d0h = min(k + 1, K - 1) / gs;
        d1 = min(k + 8, K - 1) / gs;
        d1h = min(k + 9, K - 1) / gs;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t a[4];
        if constexpr (PACKED) {
          a_packed(a, tl + (d0 << (8 + RL)), tl + (d1 << (8 + RL)),
                       word_of(bt.ld[u][0], i / 2), word_of(bt.ld[u][1], i / 2),
                       2 * (i % 2));
        } else {
          a_bytes(a, t16 + 256 * d0, t16 + 256 * d0h, t16 + 256 * d1,
                  t16 + 256 * d1h, word_of(bt.ld[u][0], i / 2),
                  word_of(bt.ld[u][1], i / 2), word_of(bt.ld[u][2], i / 2),
                  word_of(bt.ld[u][3], i / 2), 2 * (i % 2));
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
          tc::mma_bf16(acc[i][n], a, bt.b[u][n][0], bt.b[u][n][1]);
      }
    }
  };

  // a two-batch software pipeline: the next batch's loads are in flight
  // while this one is dequantized and multiplied
  constexpr int STEP = WARPS * U;
  Batch b0, b1;
  int kb = kb_beg + warp;
  load(kb, b0);  // in flight while the table is written
  if (PACKED)
    fill_pair_table(tab, cb, G, B);
  else
    fill_byte_table(reinterpret_cast<uint16_t*>(tab), cb, G, B);
  __syncthreads();
  while (kb < kb_end) {
    load(kb + STEP, b1);
    compute(kb, b0);
    kb += STEP;
    if (kb >= kb_end) break;
    load(kb + STEP, b0);
    compute(kb, b1);
    kb += STEP;
  }

  // the 8 warps' partials, added in warp order.  acc[i][n]: c[0] / c[1] are
  // column nb + 16 g + 2i at x rows 8n + 2t / + 1, c[2] / c[3] the next column
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {  // x rows 8n + 2t + e
            float2* r = reinterpret_cast<float2*>(
                red + (8 * n + 2 * t + e) * S_BN + 16 * g + 2 * i);
            const float2 v = make_float2(acc[i][n][e], acc[i][n][2 + e]);
            *r = (w == 0) ? v : make_float2(r->x + v.x, r->y + v.y);
          }
    }
    __syncthreads();
  }
  float* dst = splits == 1 ? out : part + (long long)split * M * N;
  for (int e = tid; e < MR * S_BN; e += THREADS) {
    const int m = e / S_BN;
    if (m < rows)
      store_out(dst, bias, mb + m, nb + e % S_BN, M, N, red[e], splits == 1, relu);
  }
}

template <int NT, bool PACKED>
static int launch_stream(const bf16* x, const uint8_t* idx, const float* cb,
                         const float* bias, float* out, float* part, int M,
                         int K, int N, int G, int B, int relu, int splits,
                         cudaStream_t s) {
  const size_t tab = PACKED ? (size_t)G * 1024 << RL : (size_t)G * 512;
  const size_t smem = (size_t)8 * NT * S_BN * sizeof(float) + tab;
  auto* kern = stream_kernel<NT, PACKED>;
  int dev = 0;
  cudaGetDevice(&dev);
  static size_t granted[64];  // the opt-in, set once per device and size
  if (smem > 48 * 1024 && (dev >= 64 || smem > granted[dev])) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) granted[dev] = smem;
  }
  dim3 grid((N + S_BN - 1) / S_BN, splits, (M + 8 * NT - 1) / (8 * NT));
  kern<<<grid, THREADS, smem, s>>>(x, idx, cb, bias, out, part, M, K, N, G, B,
                                   relu, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return splitk_finish(part, bias, out, M, N, splits, relu, s);
}

// ---------------------------------------------------------------------------
// mma
// ---------------------------------------------------------------------------

constexpr int BM = 64;           // output rows per block
constexpr int BN = 256;          // output columns per block (8 warps x 32)
constexpr int BK = 64;           // K rows per stage
constexpr int XLD = BK + 8;      // bf16 row stride of the x tile (9 x 16 B)
constexpr int ILD = BN + 32;     // byte row stride of the index tile: 72
                                 // words, 8 mod 32
constexpr int OLD = BN + 4;      // f32 row stride of the staged output
constexpr int NSLOT = 4;         // cp.async ring: two stages in flight
constexpr int NT = BM / 8;       // n8 tiles (8 rows of x) per warp

template <bool PACKED>
struct MmaSmem {
  static constexpr int IROWS = PACKED ? BK / 2 : BK;  // index rows a stage
  static constexpr size_t X = (size_t)BM * XLD * sizeof(bf16);  // one slot
  static constexpr size_t I = (size_t)IROWS * ILD;              // one slot
  static constexpr size_t RING = NSLOT * (X + I);
  static_assert(RING >= (BM / 2) * OLD * sizeof(float),
                "half the output tile is staged in the ring");
};

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
    mma_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ idx,
               const float* __restrict__ cb, const float* __restrict__ bias,
               float* __restrict__ out, float* __restrict__ part, int M, int K,
               int N, int G, int B, int relu, int splits) {
  using S = MmaSmem<PACKED>;
  extern __shared__ float4 dyn4[];
  uint8_t* base = reinterpret_cast<uint8_t*>(dyn4);
  bf16* xs = reinterpret_cast<bf16*>(base);    // [NSLOT][BM][XLD]
  uint8_t* is = base + NSLOT * S::X;           // [NSLOT][IROWS][ILD]
  uint32_t* tab = reinterpret_cast<uint32_t*>(base + S::RING);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int t = lane % 4;
  const int n0 = blockIdx.x * BN;
  const long long m0 = (long long)blockIdx.y * BM;
  const int split = blockIdx.z;
  const int gs = K / G;
  const int T = (K + BK - 1) / BK;
  const int per = (T + splits - 1) / splits;
  const int kt_beg = min(T, split * per), kt_end = min(T, kt_beg + per);
  const int krows = PACKED ? K / 2 : K;  // rows of idx
  const bool xvec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  const bool ivec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(idx) % 16 == 0);

  if (PACKED)
    fill_pair_table(tab, cb, G, B);
  else
    fill_byte_table(reinterpret_cast<uint16_t*>(tab), cb, G, B);
  const uint32_t* tl = tab + (lane & ((1 << RL) - 1));
  const uint16_t* t16 = reinterpret_cast<const uint16_t*>(tab);

  auto issue = [&](int kt) {
    if (kt < kt_end) {
      const int slot = kt % NSLOT, k0 = kt * BK;
      bf16* xd = xs + slot * (BM * XLD);
      for (int e = tid; e < BM * (BK / 8); e += THREADS) {
        const int r = e / (BK / 8), c = e % (BK / 8);
        const long long m = m0 + r;
        const int k = k0 + 8 * c;
        bf16* dst = xd + r * XLD + 8 * c;
        if (m < M && k < K && (!xvec || k + 8 > K)) {
          for (int i = 0; i < 8; ++i)  // the ragged K edge, or an unaligned x
            dst[i] = k + i < K ? x[m * K + k + i] : __float2bfloat16_rn(0.f);
        } else {
          const bool in = m < M && k < K;
          tc::cp_async16(dst, in ? x + m * K + k : x, in ? 16 : 0);
        }
      }
      uint8_t* id = is + slot * S::I;
      const int r0 = PACKED ? k0 / 2 : k0;
      for (int e = tid; e < S::IROWS * (BN / 16); e += THREADS) {
        const int r = e / (BN / 16), c = e % (BN / 16);
        const int kr = r0 + r, n = n0 + 16 * c;
        uint8_t* dst = id + r * ILD + 16 * c;
        if (kr < krows && n < N && (!ivec || n + 16 > N)) {
          for (int i = 0; i < 16; ++i)  // the ragged N edge, or odd N
            dst[i] = n + i < N ? idx[(long long)kr * N + n + i] : 0;
        } else {
          const bool in = kr < krows && n < N;
          tc::cp_async16(dst, in ? idx + (long long)kr * N + n : idx, in ? 16 : 0);
        }
      }
    }
    tc::cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // this lane's ldmatrix row of x (B fragments: 2 n8 tiles x k16 an x4)
  const int x_row = (lane % 8) + (lane / 16) * 8;
  const int x_col = ((lane / 8) % 2) * 8;
  const int i_col = warp * 32 + 4 * (lane / 4);  // this lane's 4 index columns

#pragma unroll
  for (int s = 0; s < NSLOT - 1; ++s) issue(kt_beg + s);
  for (int kt = kt_beg; kt < kt_end; ++kt) {
    tc::cp_async_wait<NSLOT - 2>();  // stage kt has landed
    __syncthreads();  // ... for every thread (the table too); slot
                      // (kt - 1) % NSLOT is consumed
    issue(kt + NSLOT - 1);
    const bf16* xt = xs + (kt % NSLOT) * (BM * XLD);
    const uint8_t* it = is + (kt % NSLOT) * S::I;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int k = kt * BK + 16 * ks + 2 * t;
      int d0 = 0, d0h = 0, d1 = 0, d1h = 0;
      if (G > 1) {
        d0 = min(k, K - 1) / gs;
        d0h = min(k + 1, K - 1) / gs;
        d1 = min(k + 8, K - 1) / gs;
        d1h = min(k + 9, K - 1) / gs;
      }
      uint32_t w[PACKED ? 2 : 4];  // this lane's index bytes of the k16 block
#pragma unroll
      for (int l = 0; l < (PACKED ? 2 : 4); ++l) {
        const int r = PACKED ? 8 * ks + t + 4 * l : 16 * ks + 2 * t + (l % 2) + 8 * (l / 2);
        w[l] = *reinterpret_cast<const uint32_t*>(it + r * ILD + i_col);
      }
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if constexpr (PACKED)
          a_packed(a[i], tl + (d0 << (8 + RL)), tl + (d1 << (8 + RL)), w[0],
                       w[1], 2 * i);
        else
          a_bytes(a[i], t16 + 256 * d0, t16 + 256 * d0h, t16 + 256 * d1,
                  t16 + 256 * d1h, w[0], w[1], w[2], w[3], 2 * i);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        tc::ldmatrix_x4(b, xt + (x_row + 16 * np) * XLD + 16 * ks + x_col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          tc::mma_bf16(acc[i][2 * np], a[i], b[0], b[1]);
          tc::mma_bf16(acc[i][2 * np + 1], a[i], b[2], b[3]);
        }
      }
    }
  }

  // epilogue, half the rows at a time through shared memory (the ring is
  // free), so every warp's stores are 128 contiguous bytes.  acc[i][j]:
  // c[0] / c[1] are column i_col + 2i at rows 8j + 2t / + 1, c[2] / c[3]
  // the next column
  tc::cp_async_wait<0>();
  float* os = reinterpret_cast<float*>(base);  // [BM / 2][OLD]
  float* dst = splits == 1 ? out : part + (long long)split * M * N;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    __syncthreads();  // the ring (or the previous half) is consumed
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < NT / 2; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = half * (NT / 2) + jj;
          *reinterpret_cast<float2*>(os + (8 * jj + 2 * t + e) * OLD + i_col + 2 * i) =
              make_float2(acc[i][j][e], acc[i][j][2 + e]);
        }
    __syncthreads();
    for (int e = tid; e < (BM / 2) * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      store_out(dst, bias, m0 + half * (BM / 2) + r, n0 + c, M, N,
                os[r * OLD + c], splits == 1, relu);
    }
  }
}

template <bool PACKED>
static int launch_mma(const bf16* x, const uint8_t* idx, const float* cb,
                      const float* bias, float* out, float* part, int M, int K,
                      int N, int G, int B, int relu, int splits,
                      cudaStream_t s) {
  const size_t tab = PACKED ? (size_t)G * 1024 << RL : (size_t)G * 512;
  const size_t smem = MmaSmem<PACKED>::RING + tab;
  auto* kern = mma_kernel<PACKED>;
  int dev = 0;
  cudaGetDevice(&dev);
  static size_t granted[64];  // the opt-in, set once per device and size
  if (smem > 48 * 1024 && (dev >= 64 || smem > granted[dev])) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) granted[dev] = smem;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  kern<<<grid, THREADS, smem, s>>>(x, idx, cb, bias, out, part, M, K, N, G, B,
                                   relu, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return splitk_finish(part, bias, out, M, N, splits, relu, s);
}

// tile -> template: stream rows per block 8 / 16 (NT 1 / 2); mma: BM (64)
template <bool PACKED>
static int dispatch(const bf16* x, const uint8_t* idx, const float* cb,
                    const float* bias, float* out, float* part, int M, int K,
                    int N, int G, int B, int relu, int route, int splits,
                    int tile, cudaStream_t s) {
  if (route == 0 && tile == 8)
    return launch_stream<1, PACKED>(x, idx, cb, bias, out, part, M, K, N, G, B, relu, splits, s);
  if (route == 0 && tile == 16)
    return launch_stream<2, PACKED>(x, idx, cb, bias, out, part, M, K, N, G, B, relu, splits, s);
  if (route == 1 && tile == BM)
    return launch_mma<PACKED>(x, idx, cb, bias, out, part, M, K, N, G, B, relu, splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace k1b

// Plain C entry point (bound with ctypes).  route 0 = stream (tile = rows
// of x per block: 8 or 16), route 1 = mma (tile = BM: 64); `part` holds
// splits x M x N floats when splits > 1.
// x is bf16 (M, K), idx uint8 (K / 2 or K, N), cb f32 (G, B), bias f32 (N,)
// or NULL, out f32 (M, N).
// At most MAX_GROUPS (2) dictionaries, and packed indices need an even
// K / G (a byte's two rows share one); the wrapper's plan sends any other
// shape to the SIMT kernel.  Returns the launches' cudaError_t; it does not
// synchronise.
extern "C" int pasm_matmul_bf16_launch(const void* x, const uint8_t* idx,
                                       const float* cb, const float* bias,
                                       float* out, float* part, int M, int K,
                                       int N, int G, int B, int packed,
                                       int relu, int route, int splits,
                                       int tile, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || B <= 0 || K % G ||
      splits < 1 || splits > 65535 || (splits > 1 && part == nullptr) ||
      M > 65535LL * tile || G > k1b::MAX_GROUPS || (packed && (K / G) % 2))
    return (int)cudaErrorInvalidValue;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!packed)
    return k1b::dispatch<false>(xb, idx, cb, bias, out, part, M, K, N, G, B,
                                relu, route, splits, tile, s);
  return k1b::dispatch<true>(xb, idx, cb, bias, out, part, M, K, N, G, B,
                             relu, route, splits, tile, s);
}
