// K5 — GQA flash-attention forward for sm_90a.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention_kernel_call (_kernel).
//
//   q (BKV, G, Sq, hd), k, v (BKV, Sk, hd)  ->  out (BKV, G, Sq, hd)
//   out[r] = Σ_j softmax_j(scale · q[r]·k[j]) v[j]   over the keys j with
//            j < sk_valid and, when causal, j <= r
//
// f32 online softmax (m, l, acc), output in q's dtype.  Two routes, chosen
// by dtype:
//  - f32: fa::flash_fwd, SIMT f32 FMA (below);
//  - bf16: fa2::flash_fwd_bf16, tensor cores (further below).
//
// What bounds it on the H100.  Attention at a long S does 4·S²·hd flops
// (2·S²·hd causal) on 4·S·hd values: hundreds of flops per byte, so it is
// bound by operations: 67 TFLOP/s in f32 outside the tensor cores, 989 in
// bf16 on them.  The f32 route is plain SIMT (no tensor cores: they would
// round the f32 inputs), so it is bound by the FMA pipes and by the
// shared-memory reads and other instructions that feed them.  What its
// design does:
//  - The TPU kept the whole (Sk, hd) K/V block resident in VMEM (8 MiB each
//    at 32 k x 128 bf16); no SM holds that.  Here a block owns one
//    (b·kv, g, q tile) and streams K/V through shared memory in 64-key
//    tiles (32 above hd 128) in a loop inside the block, so any Sk runs.
//    The tiles arrive by cp.async into a two-stage ring: K(t + 1) and
//    V(t + 1) are in flight while tile t is computed (at hd 128 V has one
//    stage, refilled after P·V: its copy overlaps the next Q·Kᵀ).
//  - Register-blocked like an SGEMM.  A thread owns 4 query rows x BK/CL
//    keys of S = Q·Kᵀ, then the same 4 rows x hd/CL dims of O += P·V; CL
//    lanes share a row (8 at hd 128: 128-row q tiles; 16 elsewhere: 64
//    rows).  Every float4 a thread reads from shared memory feeds 4 FMAs
//    per row or key it owns (at hd 128: 12 LDS.128 a 128-FMA step of S,
//    20 a 256-FMA step of O).  Rows and keys are interleaved and rows
//    padded, so a warp's reads of its q rows, a key's row or a V row are
//    conflict-free.  (A first design gave four threads a row, one LDS.128
//    per four FMAs: shared-memory bound at 20 % of the bound on an H100,
//    where this one runs at about half of it at hd 128.)
//  - A row's CL lanes sit in one warp: its max is log2(CL) shuffles, and P
//    goes through the warp's own rows of shared memory (__syncwarp where V
//    is already resident).  The sum l stays per thread until the end.  Q
//    is pre-scaled by scale·log2(e), so the softmax is exp2.
//  - The causal bound stops the key loop at the last key the tile's last
//    row may see, as the TPU kernel's loop bound did; only the tiles that
//    cross the diagonal or the valid end mask per element.  The longest
//    causal q tiles are launched first.
//  - The ragged Sq and Sk edges are masked here (rows past Sq compute but
//    never store; keys past the valid count are zero-filled by cp.async
//    and weigh 0), so the wrapper pads nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace fa {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int RPT = 4;             // query rows a thread owns
constexpr float NEG = -1e30f;      // the running max before any valid key
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Cfg {
  // lanes that share a query row (its columns of S, its dims of O); a
  // warp holds 32 / CL row groups of RPT rows each
  static constexpr int CL = HD == 128 ? 8 : 16;
  static constexpr int BQ = WARPS * (32 / CL) * RPT;  // query rows per block
  static constexpr int BK = HD <= 128 ? 64 : 32;      // keys per tile
  static constexpr int KPT = BK / CL;                  // keys of S a thread owns
  // O's dims a thread owns: NCH vectors of VW floats, at VW·(col + CL·c)
  static constexpr int VW = HD % (4 * CL) == 0 ? 4 : HD % (2 * CL) == 0 ? 2 : 1;
  static constexpr int NCH = HD / (CL * VW);
  static constexpr int LD = HD + 4;    // padded row of Q, K, V (floats)
  static constexpr int LDP = BK + CL;  // padded row of P
  static constexpr int TILE = BK * LD;
  // Q, the K ring (2 tiles), V (a ring of 2 where it fits, else 1), P
  static constexpr size_t FIXED =
      sizeof(float) * ((size_t)BQ * LD + 2 * TILE + (size_t)BQ * LDP);
  static constexpr bool VRING = FIXED + sizeof(float) * 2 * TILE <= 232448;
  static constexpr size_t SMEM = FIXED + sizeof(float) * (VRING ? 2 : 1) * TILE;
  static_assert(SMEM <= 232448, "one block's shared memory");
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int VW>
__device__ __forceinline__ void ldv(float (&r)[VW], const float* p) {
  if constexpr (VW == 4) {
    const float4 t = ld4(p);
    r[0] = t.x, r[1] = t.y, r[2] = t.z, r[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    r[0] = t.x, r[1] = t.y;
  } else {
    r[0] = *p;
  }
}

template <int VW>
__device__ __forceinline__ void stv(float* p, const float (&r)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r[0], r[1]);
  } else {
    *p = r[0];
  }
}

__device__ __forceinline__ float part(const float4& t, int i) {
  return i == 0 ? t.x : i == 1 ? t.y : i == 2 ? t.z : t.w;
}

// the max (or sum) over the CL lanes of a row group
template <int CL>
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < CL; o *= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int CL>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < CL; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// keys [j0, j0 + BK) of one (Sk, HD) matrix into a padded tile; keys at or
// past kend are zero-filled (nothing is read); one cp.async group
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* src, int j0,
                                      int kend) {
  using C = Cfg<HD>;
  constexpr int CH = HD / 4;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < C::BK * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const bool in = j0 + r < kend;
    tc::cp_async16(dst + r * C::LD + 4 * c,
                   src + (in ? (size_t)(j0 + r) * HD + 4 * c : 0), in ? 16 : 0);
  }
  tc::cp_async_commit();
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out, int G,
              int Sq, int Sk, int kvalid, int causal, float scale_log2) {
  using C = Cfg<HD>;
  constexpr int CL = C::CL, BQ = C::BQ, BK = C::BK, KPT = C::KPT;
  constexpr int VW = C::VW, NCH = C::NCH, LD = C::LD, LDP = C::LDP;
  constexpr int RG = 32 / CL;  // row groups a warp holds
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // [BQ][LD]
  float* sK = sQ + BQ * LD;                     // 2 x [BK][LD]
  float* sV = sK + 2 * C::TILE;                 // (1 or 2) x [BK][LD]
  float* sP = sV + (C::VRING ? 2 : 1) * C::TILE;  // [BQ][LDP]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int grp = lane / CL;         // the warp's row group
  const int col = lane % CL;         // keys col + CL j of S, dims of O
  const int rg = RG * warp + grp;    // query rows rg + (BQ / RPT) i
  constexpr int RS = BQ / RPT;       // row stride of a thread's rows
  float* myP = sP + RG * RPT * warp * LDP;  // the warp's rows: RG i + grp

  const int qt = gridDim.x - 1 - blockIdx.x;  // long causal rows first
  const int q0 = qt * BQ;
  const long long bkv = blockIdx.z;
  const long long head = bkv * G + blockIdx.y;
  const float* qb = q + head * Sq * HD;
  const float* kb = k + bkv * Sk * HD;
  const float* vb = v + bkv * Sk * HD;

  int kend = min(Sk, kvalid);  // keys this block's rows may see
  if (causal) kend = min(kend, q0 + BQ);
  const int ntiles = (kend + BK - 1) / BK;
  // cp.async groups, in order: K0, V0, then per tile t: K(t+1), V(t+1)
  stage<HD>(sK, kb, 0, kend);
  stage<HD>(sV, vb, 0, kend);

  // Q, pre-scaled by scale·log2(e): the scores come out in base 2
  for (int e = threadIdx.x; e < BQ * (HD / 4); e += THREADS) {
    const int r = e / (HD / 4), c = e % (HD / 4);
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Sq) t = ld4(qb + (size_t)(q0 + r) * HD + 4 * c);
    *reinterpret_cast<float4*>(sQ + r * LD + 4 * c) =
        make_float4(t.x * scale_log2, t.y * scale_log2, t.z * scale_log2,
                    t.w * scale_log2);
  }

  float o[RPT][NCH][VW];
  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int w = 0; w < VW; ++w) o[i][c][w] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const bool next = t + 1 < ntiles;
    const float* tK = sK + (t & 1) * C::TILE;
    const float* tV = sV + (C::VRING ? (t & 1) * C::TILE : 0);
    const int j0 = t * BK;
    if (next) {  // K(t+1) into the other half of the ring (read at t - 1)
      stage<HD>(sK + ((t + 1) & 1) * C::TILE, kb, j0 + BK, kend);
      if (C::VRING) stage<HD>(sV + ((t + 1) & 1) * C::TILE, vb, j0 + BK, kend);
    }
    // K(t) has landed: pending may be V(t) (single V), K(t+1), V(t+1)
    if (!next)
      tc::cp_async_wait<C::VRING ? 0 : 1>();
    else
      tc::cp_async_wait<2>();
    __syncthreads();  // K(t) (and, the first time, Q) seen by every thread

    // S = Q·Kᵀ on the thread's RPT x KPT scores
    float s[RPT][KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 4) {
      float4 qv[RPT], kv[KPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = ld4(sQ + (rg + RS * i) * LD + d);
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = ld4(tK + (col + CL * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    // per-element masks only where the tile crosses the valid end or the
    // causal diagonal
    if (j0 + BK > kend || (causal && j0 + BK - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) {
          const int kj = j0 + col + CL * j, qi = q0 + rg + RS * i;
          if (kj >= kend || (causal && kj > qi)) s[i][j] = -INFINITY;
        }
    }
    // the online softmax: one max per row over its CL lanes; P to the
    // warp's rows of shared memory
    __syncwarp();  // the warp has read the previous tile's P
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mt = s[i][0];
#pragma unroll
      for (int j = 1; j < KPT; ++j) mt = fmaxf(mt, s[i][j]);
      mt = fmaxf(m[i], row_max<CL>(mt));
      const float alpha = exp2f(m[i] - mt);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = exp2f(s[i][j] - mt);  // a masked key: 2^-inf = 0
        ps += p;
        myP[(RG * i + grp) * LDP + col + CL * j] = p;
      }
      l[i] = l[i] * alpha + ps;
      m[i] = mt;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int w = 0; w < VW; ++w) o[i][c][w] *= alpha;
    }
    if (!C::VRING) {  // V(t) has landed (pending: K(t+1))
      if (next)
        tc::cp_async_wait<1>();
      else
        tc::cp_async_wait<0>();
      __syncthreads();
    } else {
      __syncwarp();  // the warp's P rows are written
    }

    // O += P·V on the thread's RPT rows x NCH·VW dims
#pragma unroll
    for (int j = 0; j < BK; j += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ld4(myP + (RG * i + grp) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          float vv[VW];
          ldv<VW>(vv, tV + (j + jj) * LD + VW * (col + CL * c));
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float p = part(pv[i], jj);
#pragma unroll
            for (int w = 0; w < VW; ++w) o[i][c][w] = fmaf(p, vv[w], o[i][c][w]);
          }
        }
      }
    }
    __syncthreads();  // K(t) and V(t) are consumed before they are refilled
    if (!C::VRING && next) stage<HD>(sV, vb, j0 + BK, kend);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const float den = fmaxf(row_sum<CL>(l[i]), 1e-30f);
    const int qi = q0 + rg + RS * i;
    if (qi >= Sq) continue;
    float* op = out + (head * Sq + qi) * HD;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float r[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) r[w] = o[i][c][w] / den;
      stv<VW>(op + VW * (col + CL * c), r);
    }
  }
}

template <int HD>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int BKV, int G, int Sq, int Sk, int kvalid, int causal,
                  float scale, cudaStream_t stream) {
  constexpr size_t smem = Cfg<HD>::SMEM;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Sq + Cfg<HD>::BQ - 1) / Cfg<HD>::BQ, G, BKV);
  flash_fwd<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), G, Sq, Sk,
      kvalid, causal, scale * LOG2E);
  return (int)cudaGetLastError();
}

static int dispatch_f32(int hd, const void* q, const void* k, const void* v,
                        void* out, int BKV, int G, int Sq, int Sk, int kvalid,
                        int causal, float scale, cudaStream_t s) {
  switch (hd) {
#define FA_HD(n) \
  case n:        \
    return launch<n>(q, k, v, out, BKV, G, Sq, Sk, kvalid, causal, scale, s);
    FA_HD(16)
    FA_HD(32)
    FA_HD(64)
    FA_HD(80)
    FA_HD(128)
    FA_HD(192)
    FA_HD(256)
#undef FA_HD
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace fa

// ---------------------------------------------------------------------------
// bf16 route: FA2 on mma.sync.m16n8k16 (bf16 in, f32 accumulate)
// ---------------------------------------------------------------------------
//
// A block of 4 warps owns 64 query rows of one (b·kv, g), 16 per warp (8
// warps and 128 rows, half the K/V reads from L2, were no faster on an H100
// at the qwen3 prefill shape: the tensor cores and the softmax set the
// time).
//  - Q fragments are loaded once with ldmatrix and stay in registers for the
//    whole key loop (hd <= 128).  At hd 192 and 256 the f32 output
//    accumulator alone is 96 and 128 registers a thread, so there Q stays in
//    shared memory and is re-read with ldmatrix every key tile, and the key
//    tile is 32 keys instead of 64 (the score accumulator halves).
//  - K/V tiles come in by cp.async into a two-stage ring: the next tile's
//    copy is in flight while the tensor cores work on this one.  Rows are
//    padded by 16 bytes (hd + 8 bf16), so the 8 row addresses of every
//    ldmatrix phase fall in 8 distinct 16-byte bank groups: conflict-free at
//    every head dim (all are multiples of 16, so the padded stride is an odd
//    number of 16-byte units).  K is read with ldmatrix, V with
//    ldmatrix.trans.
//  - S = Q Kᵀ accumulates in f32 registers; the scale, with log2(e) folded
//    in, is applied to S in f32, so the softmax is exp2.
//  - The online softmax runs on the accumulator fragments: the row max over
//    the four lanes of a quad with shfl_xor; the row sum stays a per-lane
//    partial until the end (the rescale factor is uniform over the quad).
//  - P is rounded to bf16 in registers and is directly the A operand of
//    P·V (the S accumulator layout is the A fragment layout), so P never
//    touches shared memory.  The JAX kernel keeps P in f32: this is the one
//    numeric difference, held to |Δ| <= 2^-7 (|plain| + Σ_j p_j |v_j|).
//  - The causal bound ends the key loop at the block's last visible key;
//    the per-element mask runs only on tiles that straddle the diagonal or
//    the valid-key edge.  Rows past Sq compute but are not stored; keys past
//    the valid count are zero-filled by cp.async and weigh 0.
//  - Blocks walk the query tiles last-first, so the long causal rows start
//    first and the short ones fill the tail.
namespace fa2 {

constexpr float NEG = -1e30f;   // the running max before any valid key
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr bool Q_REGS = HD <= 128;         // Q fragments in registers
  static constexpr int WARPS = 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BQ = 16 * WARPS;             // query rows per block
  static constexpr int BKEYS = Q_REGS ? 64 : 32;    // keys per tile
  static constexpr int LD = HD + 8;                 // padded smem row (bf16)
  static constexpr int KSTEPS = HD / 16;            // k16 steps of Q Kᵀ
  static constexpr int NT_S = BKEYS / 8;            // score n8 tiles
  static constexpr int NT_O = HD / 8;               // output n8 tiles
  static constexpr int TILE = BKEYS * LD;           // elements of a K/V tile
  // stage s holds K at 2s·TILE and V after it; Q in registers is staged
  // over the second stage, else it has its own tile after the ring
  static constexpr int Q_OFF = Q_REGS ? 2 * TILE : 4 * TILE;
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (size_t)(Q_REGS ? 4 * TILE : 4 * TILE + BQ * LD);
  static_assert(!Q_REGS || BQ * LD <= 2 * TILE, "Q staging fits one stage");
};

// rows [r0, r0 + rows) of a (., HD) bf16 matrix into a padded smem tile;
// rows at or past `valid` are zero-filled
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int rows, int valid) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < rows * CH; e += Cfg<HD>::THREADS) {
    const int r = e / CH, c = e % CH;
    const bool in = r0 + r < valid;
    tc::cp_async16(dst + r * Cfg<HD>::LD + 8 * c,
                   in ? src + (size_t)(r0 + r) * HD + 8 * c : src, in ? 16 : 0);
  }
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS)
    flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, int G, int Sq, int Sk,
                   int kvalid, int causal, float scale_log2) {
  using C = Cfg<HD>;
  constexpr int BKEYS = C::BKEYS, LD = C::LD, BQ = C::BQ;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sK = sm;            // stage s: K at 2s·TILE ...
  __nv_bfloat16* sV = sm + C::TILE;  // ... and V after it
  __nv_bfloat16* sQ = sm + C::Q_OFF;  // [BQ][LD]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int qt = gridDim.x - 1 - blockIdx.x;  // long causal rows first
  const int q0 = qt * BQ;
  const long long bkv = blockIdx.z;
  const long long head = bkv * G + blockIdx.y;
  const __nv_bfloat16* qb = q + head * Sq * HD;
  const __nv_bfloat16* kb = k + bkv * Sk * HD;
  const __nv_bfloat16* vb = v + bkv * Sk * HD;

  const int kval = min(Sk, kvalid);  // keys that may weigh
  int kend = kval;                   // keys this block's rows may see
  if (causal) kend = min(kend, q0 + BQ);
  const int ntiles = (kend + BKEYS - 1) / BKEYS;

  load_rows<HD>(sQ, qb, q0, BQ, Sq);
  tc::cp_async_commit();
  load_rows<HD>(sK, kb, 0, BKEYS, kend);
  load_rows<HD>(sV, vb, 0, BKEYS, kend);
  tc::cp_async_commit();

  // this lane's A-operand row address inside a 16-row tile (ldmatrix x4)
  const int a_row = lane % 16, a_col = (lane / 16) * 8;
  uint32_t qf[C::Q_REGS ? C::KSTEPS : 1][4];
  if constexpr (C::Q_REGS) {
    tc::cp_async_wait<1>();  // Q has landed (the first K/V tile may not)
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < C::KSTEPS; ++ks)
      tc::ldmatrix_x4(qf[ks], sQ + (warp * 16 + a_row) * LD + ks * 16 + a_col);
    __syncthreads();  // sQ (the second stage) is free before it is refilled
  }

  float o[C::NT_O][4];
#pragma unroll
  for (int i = 0; i < C::NT_O; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m_r[2] = {NEG, NEG};  // running max of rows g and g + 8 (log2 units)
  float l_r[2] = {0.f, 0.f};  // this lane's partial row sums
  const int g = lane / 4, t = lane % 4;
  const int qw = q0 + warp * 16;  // this warp's first row
  const int row0 = qw + g, row1 = qw + g + 8;

  for (int j = 0; j < ntiles; ++j) {
    const int st = j & 1;
    if (j + 1 < ntiles) {
      load_rows<HD>(sK + (st ^ 1) * 2 * C::TILE, kb, (j + 1) * BKEYS, BKEYS, kend);
      load_rows<HD>(sV + (st ^ 1) * 2 * C::TILE, vb, (j + 1) * BKEYS, BKEYS, kend);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile j (and Q) have landed
    __syncthreads();
    const __nv_bfloat16* tK = sK + st * 2 * C::TILE;
    const __nv_bfloat16* tV = sV + st * 2 * C::TILE;
    const int j0 = j * BKEYS;

    // S = Q Kᵀ over the tile, f32
    float s[C::NT_S][4];
#pragma unroll
    for (int i = 0; i < C::NT_S; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < C::KSTEPS; ++ks) {
      uint32_t a[4];
      if constexpr (C::Q_REGS) {
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qf[ks][i];
      } else {
        tc::ldmatrix_x4(a, sQ + (warp * 16 + a_row) * LD + ks * 16 + a_col);
      }
#pragma unroll
      for (int np = 0; np < C::NT_S / 2; ++np) {
        uint32_t b[4];  // keys np·16 + [0, 16), hd ks·16 + [0, 16)
        tc::ldmatrix_x4(b, tK + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD +
                               ks * 16 + ((lane / 8) % 2) * 8);
        tc::mma_bf16(s[2 * np], a, b[0], b[1]);
        tc::mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // scale (log2 units), mask, online softmax on the fragments
    const bool edge = j0 + BKEYS > kval || (causal && j0 + BKEYS - 1 > qw);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < C::NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge) {
          const int kj = j0 + nt * 8 + 2 * t + (e & 1);
          const int qi = (e < 2) ? row0 : row1;
          if (kj >= kval || (causal && kj > qi)) x = -INFINITY;
        }
        s[nt][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      alpha[h] = tc::exp2_approx(m_r[h] - mx[h]);
      m_r[h] = mx[h];
      l_r[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < C::NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = tc::exp2_approx(s[nt][e] - m_r[e / 2]);  // masked: 0
        s[nt][e] = p;
        l_r[e / 2] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < C::NT_O; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V: P (bf16, registers) is the A operand, V via ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BKEYS / 16; ++kk) {
      uint32_t a[4];
      a[0] = tc::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = tc::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = tc::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = tc::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < C::NT_O / 2; ++dp) {
        uint32_t b[4];  // keys kk·16 + [0, 16), hd dp·16 + [0, 16)
        tc::ldmatrix_x4_trans(
            b, tV + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LD +
                   dp * 16 + (lane / 16) * 8);
        tc::mma_bf16(o[2 * dp], a, b[0], b[1]);
        tc::mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
  }
  const float den0 = fmaxf(l_r[0], 1e-30f), den1 = fmaxf(l_r[1], 1e-30f);
  __nv_bfloat16* ob = out + head * Sq * HD;
#pragma unroll
  for (int nt = 0; nt < C::NT_O; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * HD + c) =
          tc::pack_bf16x2(o[nt][0] / den0, o[nt][1] / den0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * HD + c) =
          tc::pack_bf16x2(o[nt][2] / den1, o[nt][3] / den1);
  }
}

template <int HD>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int BKV, int G, int Sq, int Sk, int kvalid, int causal,
                  float scale, cudaStream_t stream) {
  const size_t smem = Cfg<HD>::SMEM;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_bf16<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Sq + Cfg<HD>::BQ - 1) / Cfg<HD>::BQ, G, BKV);
  flash_fwd_bf16<HD><<<grid, Cfg<HD>::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), G,
      Sq, Sk, kvalid, causal, scale * LOG2E);
  return (int)cudaGetLastError();
}

static int dispatch_bf16(int hd, const void* q, const void* k, const void* v,
                         void* out, int BKV, int G, int Sq, int Sk, int kvalid,
                         int causal, float scale, cudaStream_t s) {
  switch (hd) {
#define FA_HD(n) \
  case n:        \
    return launch<n>(q, k, v, out, BKV, G, Sq, Sk, kvalid, causal, scale, s);
    FA_HD(16)
    FA_HD(32)
    FA_HD(64)
    FA_HD(80)
    FA_HD(128)
    FA_HD(192)
    FA_HD(256)
#undef FA_HD
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace fa2

// Plain C entry point (bound with ctypes).  q, k, v and out are contiguous,
// 16-byte aligned, all float32 (bf16 == 0: the SIMT route) or all bfloat16
// (bf16 == 1: the tensor-core route); keys at or past kvalid weigh nothing.
// hd is one of 16, 32, 64, 80, 128, 192, 256 (every head dim of the
// registry's attention archs).  Returns the launch's cudaError_t; it does
// not synchronise.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int BKV,
                                      int G, int Sq, int Sk, int kvalid,
                                      int hd, int causal, int bf16,
                                      float scale, void* stream) {
  if (BKV <= 0 || G <= 0 || Sq <= 0 || Sk <= 0 || kvalid <= 0 || BKV > 65535 ||
      G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return fa2::dispatch_bf16(hd, q, k, v, out, BKV, G, Sq, Sk, kvalid, causal,
                              scale, s);
  return fa::dispatch_f32(hd, q, k, v, out, BKV, G, Sq, Sk, kvalid, causal,
                          scale, s);
}
