// K6 — split-KV decode attention ("flash-decoding") for sm_90a.
//
// Replaces no TPU kernel: the JAX package decodes with an XLA einsum
// (src/repro/nn/attention.py, decode_attention: preferred_element_type=f32).
// It was added because the port's plain version of that arithmetic (the
// whole K and V caches widened to f32 through a permuted copy, every
// position scored whatever the slot's pos, two f32 gemv, the mask applied
// afterwards) took 87 % of a phi3-medium decode tick on an H100.
//
//   q (B, H, hd), H = KV·G: the query heads grouped under their KV head
//   k, v (B, S, KV, hd): each slot's (S, KV, hd) rows row-major, any batch
//       stride; bf16 or f32, read where they lie
//   pos (B,) int32: the rows each slot may read are, in this cache's block
//       of positions (from `offset` on),
//         offset + j < pos[b]  and, with window >= 0, offset + j >= pos[b] - window
//       a slot with no such row reads every row of the block, each scored
//       -1e30 (what the plain softmax over all-masked scores gives)
//   out[b, kv·G + g] = Σ_j softmax_j(scale · q·k_j) v_j  in q's dtype, or,
//       `partial`, the block's f32 (m, l, o) packed as [m, l, o(hd)]
//
// The arithmetic is the plain version's: scores from exact widenings in
// f32 times scale, an f32 softmax, each weight rounded to the cache's dtype
// before the value product (relative to the running max of its split, as
// softmax_partial rounds it relative to its block's), sums in f32.
//
// What bounds it on the H100.  A decode step reads each live K and V row
// once and does 4·G·hd flops on it (16 flops a byte at phi3's G 4, bf16):
// far below the card's ridge, so the bound is the live rows' bytes over
// 3.35 TB/s.  What the design does:
//  - The grid is (B·KV, ceil(S / CHUNK)).  A block owns CHUNK positions of
//    one KV head of one slot and all G query heads under it, so a K/V row is
//    read from device memory once for its G heads.  The grid is sized from
//    S, never from pos (the host reads no pos, so a decode tick stays a
//    stream of asynchronous launches); a block whose chunk lies wholly
//    outside its slot's rows returns at once.
//  - Tiles of TR rows arrive by cp.async, 16 B a thread with neighbouring
//    threads on neighbouring addresses, into a ring of STAGES tiles: tiles
//    t + 1 .. t + STAGES - 1 are in flight while tile t is scored, so a
//    block's chain of tiles is not one memory latency a tile.
//  - A thread is (tx, g, tz): BDX lanes share a row, each holding 16-byte
//    vectors of it, widened to f32 in registers (SIMT FMA: the flops need no
//    tensor cores); g is the query head; tz picks the tile's rows.  A score
//    is the lanes' partial dots summed by xor shuffles.  Each thread keeps an
//    f32 online softmax (m, l, o) over its rows; the block folds its tz
//    partials in tz order through shared memory and writes its split's
//    (m, l, o).
//  - A second launch folds a slot's splits in split order with
//    combine_partials' arithmetic (the max, exp weights, o / max(l, 1e-30)).
//    Nothing is summed by atomics, so a call repeats bit for bit.
// On an H100 at phi3-medium's serving shape (16 slots of 4096, 10 KV heads,
// G 4, hd 128) it reads the closed chat mix's live rows at about a third of
// the bound, every row of a full cache at about half; rings of 2 to 6
// stages and splits of 64 to 512 rows moved that by a few per cent at most.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace da {

constexpr int CHUNK = 256;          // cache rows a split covers
constexpr int RPT = 4;              // rows of a tile each thread scores
constexpr int STAGES = 4;           // tiles in the ring: STAGES - 1 in flight
constexpr int MAX_G = 16;           // query heads a block serves
constexpr int THREADS = 256;        // the block size aimed at
constexpr int MAX_BDZ = 32;
constexpr int TILE_BYTES = 8192;    // the most bytes of K (and of V) a tile holds
constexpr int COMBINE_THREADS = 128;
constexpr float NEG = -1e30f;       // a masked score, as the plain version's
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int pow2ceil(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

template <int HD, typename T>
struct Cfg {
  static constexpr int VEC = 16 / (int)sizeof(T);   // elements in 16 bytes
  static constexpr int NV = HD / VEC > 8 ? 2 : 1;   // 16-byte vectors a lane holds
  static constexpr int E = VEC * NV;                // elements a lane holds
  static constexpr int LANES = HD / E;              // lanes holding a row
  static constexpr int BDX = pow2ceil(LANES);       // lanes a row is given
  static constexpr int ROW = HD * (int)sizeof(T);   // bytes of a row
  static constexpr int PIECES = ROW / 16;
  static_assert(HD % E == 0 && BDX <= 32, "a row is whole vectors in one warp");
};

__device__ __forceinline__ void widen(const float* p, float* r) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  r[0] = t.x, r[1] = t.y, r[2] = t.z, r[3] = t.w;
}

// 8 bf16 -> f32, exactly: a bf16 is the high half of its f32
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float* r) {
  const uint4 t = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[2 * i] = __uint_as_float(w[i] << 16);
    r[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// a softmax weight rounded to the cache's dtype (round to nearest even)
__device__ __forceinline__ float rounded(float p, const float*) { return p; }
__device__ __forceinline__ float rounded(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

// [lo, hi): the rows of this block of positions that slot `p` may read;
// `dead` when there is none, and then every row is read at score -1e30
__device__ __forceinline__ void valid_rows(int p, int S, int window,
                                           long long offset, int& lo, int& hi,
                                           bool& dead) {
  long long h = (long long)p - offset;
  long long l = window >= 0 ? (long long)p - window - offset : 0;
  h = h < 0 ? 0 : h > S ? S : h;
  l = l < 0 ? 0 : l > S ? S : l;
  dead = h <= l;
  lo = dead ? 0 : (int)l;
  hi = dead ? S : (int)h;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  long long sbk, sbv;  // batch strides of k and v (elements)
  const int* pos;
  float* part_o;       // (B·KV, n_split, G, hd)
  float* part_ml;      // (B·KV, n_split, G, 2)
  void* out;
  int S, KV, G, n_split, window, q_bf16, out_kind;  // out: 0 f32, 1 bf16, 2 packed (m, l, o)
  long long offset;
  float scale;
};

template <int HD, typename T>
__global__ void __launch_bounds__(512) split_kernel(const Args a) {
  using C = Cfg<HD, T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bkv = blockIdx.x, split = blockIdx.y;
  const int b = bkv / a.KV, h = bkv - b * a.KV;
  int lo, hi;
  bool dead;
  valid_rows(a.pos[b], a.S, a.window, a.offset, lo, hi, dead);
  const int r0 = max(lo, split * CHUNK), r1 = min(hi, split * CHUNK + CHUNK);
  if (r0 >= r1) return;

  const int tx = threadIdx.x, g = threadIdx.y, tz = threadIdx.z;
  const int G = a.G, BDZ = blockDim.z;
  const int tid = tx + C::BDX * (g + G * tz), nthreads = C::BDX * G * BDZ;
  const int TR = RPT * BDZ;
  const size_t stage = (size_t)TR * C::ROW;  // bytes of a K (or V) tile
  const size_t rstride = (size_t)a.KV * C::ROW;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(
      static_cast<const T*>(a.k) + b * a.sbk + (size_t)h * HD);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(
      static_cast<const T*>(a.v) + b * a.sbv + (size_t)h * HD);

  const int n_tiles = (r1 - r0 + TR - 1) / TR;
  auto load_tile = [&](int t) {  // tile t into its stage; an empty group past the end
    unsigned char* dk = smem + (size_t)(t % STAGES) * 2 * stage;
    unsigned char* dv = dk + stage;
    const int t0 = r0 + t * TR;
    const int n = t < n_tiles ? min(TR, r1 - t0) * C::PIECES : 0;
    for (int i = tid; i < n; i += nthreads) {
      const int r = i / C::PIECES, c = (i - r * C::PIECES) * 16;
      const size_t src = (size_t)(t0 + r) * rstride + c;
      tc::cp_async16(dk + r * C::ROW + c, kb + src, 16);
      tc::cp_async16(dv + r * C::ROW + c, vb + src, 16);
    }
    tc::cp_async_commit();
  };

  // this thread's dims of its query head, widened; the softmax state
  const bool lane = tx < C::LANES;
  float qr[C::E], o[C::E];
  {
    const size_t base = ((size_t)bkv * G + g) * HD;
#pragma unroll
    for (int n = 0; n < C::NV; ++n)
#pragma unroll
      for (int i = 0; i < C::VEC; ++i) {
        const size_t e = base + (size_t)(n * C::LANES + tx) * C::VEC + i;
        qr[n * C::VEC + i] =
            !lane ? 0.f
            : a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[e])
                       : static_cast<const float*>(a.q)[e];
      }
  }
#pragma unroll
  for (int i = 0; i < C::E; ++i) o[i] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int t = 0; t < STAGES - 1; ++t) load_tile(t);
  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait<STAGES - 2>();  // one group a tile: tiles 0..t landed
    __syncthreads();  // ... for every thread; every thread is done with tile t - 1
    load_tile(t + STAGES - 1);        // into tile t - 1's stage
    const unsigned char* tk = smem + (size_t)(t % STAGES) * 2 * stage;
    const unsigned char* tv = tk + stage;
    const int t0 = r0 + t * TR;

    // every row's partial dot first (independent chains), then the lanes'
    // sums, the rows interleaved
    float s[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = tz + BDZ * j;
      float d = 0.f;
      if (t0 + r < r1 && lane) {
        const T* kr = reinterpret_cast<const T*>(tk + (size_t)r * C::ROW);
#pragma unroll
        for (int n = 0; n < C::NV; ++n) {
          float kk[C::VEC];
          widen(kr + (n * C::LANES + tx) * C::VEC, kk);
#pragma unroll
          for (int i = 0; i < C::VEC; ++i) d = fmaf(qr[n * C::VEC + i], kk[i], d);
        }
      }
      s[j] = d;
    }
#pragma unroll
    for (int off = C::BDX / 2; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < RPT; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const bool ok = t0 + tz + BDZ * j < r1;
      s[j] = !ok ? -INFINITY : dead ? NEG : s[j] * a.scale;
      mx = fmaxf(mx, s[j]);
    }
    if (mx > -INFINITY) {  // this thread has a row in the tile
      const float m_new = fmaxf(m, mx);
      const float alpha = exp2f((m - m_new) * LOG2E);  // 0 before the first row
      m = m_new;
      l *= alpha;
#pragma unroll
      for (int i = 0; i < C::E; ++i) o[i] *= alpha;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        if (s[j] == -INFINITY) continue;
        const float p = exp2f((s[j] - m) * LOG2E);
        l += p;
        if (!lane) continue;
        const T* vr = reinterpret_cast<const T*>(tv + (size_t)(tz + BDZ * j) * C::ROW);
        const float pr = rounded(p, vr);
#pragma unroll
        for (int n = 0; n < C::NV; ++n) {
          float vv[C::VEC];
          widen(vr + (n * C::LANES + tx) * C::VEC, vv);
#pragma unroll
          for (int i = 0; i < C::VEC; ++i)
            o[n * C::VEC + i] = fmaf(pr, vv[i], o[n * C::VEC + i]);
        }
      }
    }
  }

  // fold the tz partials in tz order (the ring's bytes are free now)
  tc::cp_async_wait<0>();  // the empty groups past the end
  __syncthreads();
  float* fm = reinterpret_cast<float*>(smem);  // [BDZ][G]
  float* fl = fm + BDZ * G;                     // [BDZ][G]
  float* fo = fl + BDZ * G;                     // [BDZ][G][HD]
  if (tx == 0) fm[tz * G + g] = m, fl[tz * G + g] = l;
  __syncthreads();
  float top = fm[g];
  for (int z = 1; z < BDZ; ++z) top = fmaxf(top, fm[z * G + g]);
  const float w = expf(m - top);  // a thread without rows: m = -inf, w = 0
  if (lane)
#pragma unroll
    for (int n = 0; n < C::NV; ++n)
#pragma unroll
      for (int i = 0; i < C::VEC; ++i)
        fo[(size_t)(tz * G + g) * HD + (n * C::LANES + tx) * C::VEC + i] =
            o[n * C::VEC + i] * w;
  __syncthreads();
  if (tz != 0) return;
  const size_t slot = ((size_t)bkv * a.n_split + split) * G + g;
  if (lane)
#pragma unroll
    for (int n = 0; n < C::NV; ++n)
#pragma unroll
      for (int i = 0; i < C::VEC; ++i) {
        const int d = (n * C::LANES + tx) * C::VEC + i;
        float acc = fo[(size_t)g * HD + d];
        for (int z = 1; z < BDZ; ++z) acc += fo[(size_t)(z * G + g) * HD + d];
        a.part_o[slot * HD + d] = acc;
      }
  if (tx == 0) {
    float acc = fl[g] * expf(fm[g] - top);
    for (int z = 1; z < BDZ; ++z) acc += fl[z * G + g] * expf(fm[z * G + g] - top);
    a.part_ml[slot * 2] = top;
    a.part_ml[slot * 2 + 1] = acc;
  }
}

// one block a (slot, KV head): fold the splits that hold its rows, in split
// order, as combine_partials folds its blocks
__global__ void __launch_bounds__(COMBINE_THREADS) combine_kernel(const Args a, int HD) {
  const int bkv = blockIdx.x, b = bkv / a.KV, G = a.G;
  int lo, hi;
  bool dead;
  valid_rows(a.pos[b], a.S, a.window, a.offset, lo, hi, dead);
  const int s0 = lo / CHUNK, s1 = (hi + CHUNK - 1) / CHUNK;
  for (int idx = threadIdx.x; idx < G * HD; idx += blockDim.x) {
    const int g = idx / HD, d = idx - g * HD;
    const size_t first = (size_t)bkv * a.n_split * G + g;  // split 0's (slot, g)
    const float* ml = a.part_ml + first * 2;
    const float* po = a.part_o + first * HD + d;
    const size_t ms = (size_t)G * 2, os = (size_t)G * HD;  // a split's strides
    float top = ml[s0 * ms];
    for (int s = s0 + 1; s < s1; ++s) top = fmaxf(top, ml[s * ms]);
    float lsum = 0.f, osum = 0.f;
    for (int s = s0; s < s1; ++s) {
      const float w = expf(ml[s * ms] - top);
      const float lw = ml[s * ms + 1] * w, ow = po[s * os] * w;
      lsum = s == s0 ? lw : lsum + lw;
      osum = s == s0 ? ow : osum + ow;
    }
    const size_t row = (size_t)bkv * G + g;
    if (a.out_kind == 2) {
      float* out = static_cast<float*>(a.out) + row * (HD + 2);
      out[2 + d] = osum;
      if (d == 0) out[0] = top, out[1] = lsum;
    } else {
      const float y = osum / fmaxf(lsum, 1e-30f);
      if (a.out_kind == 1)
        static_cast<__nv_bfloat16*>(a.out)[row * HD + d] = __float2bfloat16(y);
      else
        static_cast<float*>(a.out)[row * HD + d] = y;
    }
  }
}

// threads along the rows: about THREADS a block, a K tile of at most
// TILE_BYTES (the ring then fits a block's shared memory several times over
// an SM's), a whole number of warps
static int block_rows(int bdx, int G, int row_bytes) {
  int per = 32 / bdx, f = G;  // per / gcd(G, per): the least tz count that fills warps
  while (per > 1 && f % 2 == 0) per /= 2, f /= 2;
  const int cap = TILE_BYTES / (RPT * row_bytes);
  int z = THREADS / (bdx * G);
  z = z < MAX_BDZ ? z : MAX_BDZ;
  z = (z < cap ? z : cap) / per * per;
  return z < per ? per : z;
}

template <int HD, typename T>
static int launch(const Args& a, int B, cudaStream_t stream) {
  using C = Cfg<HD, T>;
  const int bdz = block_rows(C::BDX, a.G, C::ROW);
  const size_t ring = (size_t)2 * STAGES * RPT * bdz * C::ROW;
  const size_t fold = sizeof(float) * (size_t)bdz * a.G * (HD + 2);
  const size_t smem = ring > fold ? ring : fold;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        split_kernel<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  split_kernel<HD, T><<<dim3(B * a.KV, a.n_split), dim3(C::BDX, a.G, bdz), smem,
                        stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  combine_kernel<<<B * a.KV, COMBINE_THREADS, 0, stream>>>(a, HD);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(int hd, const Args& a, int B, cudaStream_t s) {
  switch (hd) {
#define DA_HD(n) \
  case n:        \
    return launch<n, T>(a, B, s);
    DA_HD(16)
    DA_HD(32)
    DA_HD(64)
    DA_HD(80)
    DA_HD(128)
    DA_HD(192)
    DA_HD(256)
#undef DA_HD
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace da

// Plain C entry point (bound with ctypes).  q (B, KV·G, hd) contiguous, f32
// or bf16 (q_bf16); k and v (B, S, KV, hd), both f32 or both bf16
// (cache_bf16), each slot's rows row-major at batch strides sbk / sbv
// (elements), 16-byte aligned; pos (B,) int32; window < 0 for none.  part
// is f32 scratch of B·KV·n_split·G·(hd + 2) floats, n_split = ceil(S /
// 256).  out: (B, KV·G, hd) in q's dtype, or with partial (B, KV, G, hd + 2)
// f32 holding [m, l, o].  hd is one of 16, 32, 64, 80, 128, 192, 256 and
// 1 <= G <= 16.  Returns the launches' cudaError_t; it does not synchronise.
extern "C" int decode_attention_launch(const void* q, int q_bf16, const void* k,
                                       const void* v, long long sbk, long long sbv,
                                       int cache_bf16, const int* pos, void* out,
                                       void* part, int B, int S, int KV, int G,
                                       int hd, int window, long long offset,
                                       int partial, float scale, void* stream) {
  const int n_split = (S + da::CHUNK - 1) / da::CHUNK;
  if (B <= 0 || S <= 0 || KV <= 0 || G <= 0 || G > da::MAX_G || n_split > 65535 ||
      (long long)B * KV > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  da::Args a;
  a.q = q, a.k = k, a.v = v, a.sbk = sbk, a.sbv = sbv, a.pos = pos, a.out = out;
  const size_t n = (size_t)B * KV * n_split * G;
  a.part_o = static_cast<float*>(part);
  a.part_ml = a.part_o + n * hd;
  a.S = S, a.KV = KV, a.G = G, a.n_split = n_split, a.window = window;
  a.q_bf16 = q_bf16, a.out_kind = partial ? 2 : q_bf16 ? 1 : 0;
  a.offset = offset, a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cache_bf16) return da::dispatch<__nv_bfloat16>(hd, a, B, s);
  return da::dispatch<float>(hd, a, B, s);
}
