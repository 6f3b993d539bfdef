// K5 — GQA flash-attention forward for sm_90a.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention.py::flash_attention_kernel_call (_kernel).
//
//   q (BKV, G, Sq, hd), k, v (BKV, Sk, hd)  ->  out (BKV, G, Sq, hd)
//   out[r] = Σ_j softmax_j(scale · q[r]·k[j]) v[j]   over the keys j with
//            j < sk_valid and, when causal, j <= r
//
// f32 or bf16 in (every load is widened to f32), f32 online softmax
// (m, l, acc), output in q's dtype (bf16 rounded to nearest even).
//
// What bounds it on the H100.  Attention at a long S does 4·S²·hd flops
// (2·S²·hd causal) on 4·S·hd values: hundreds of flops per byte, so it is
// bound by operations, and at full speed by the tensor cores.  This first
// kernel is plain SIMT f32 (no wgmma, no TMA): right first, fast later
// (ROADMAP Queue 2).  What the design does:
//  - The TPU kept the whole (Sk, hd) K/V block resident in VMEM (8 MiB each
//    at 32 k x 128 bf16); no SM holds that.  Here a block owns one
//    (b·kv, g, 64-row q tile) and streams K/V through shared memory in
//    32-key tiles, in a loop inside the block, so any Sk runs.
//  - Four threads own a query row; each keeps a quarter of q (pre-scaled)
//    and of the f32 accumulator in registers, as float4 chunks interleaved
//    so a warp's shared-memory reads of one key never conflict; a score is
//    the four partial dots summed by two shuffles.  m and l live in
//    registers too; nothing of the running state goes to device memory.
//  - The causal bound stops the key loop at the last key the tile's last
//    row may see, as the TPU kernel's loop bound did; inside the last tiles
//    the mask is per element.
//  - The ragged Sq and Sk edges are masked here (rows past Sq compute but
//    never store; keys past the valid count read 0 and weigh 0), so the
//    wrapper pads nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fa {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 32;            // keys per shared-memory tile
constexpr int TPR = 4;            // threads per query row
constexpr int THREADS = BQ * TPR;  // 256
constexpr float NEG = -1e30f;     // the running max before any valid key

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <int HD, typename T>
__global__ void __launch_bounds__(THREADS)
    flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ out, int G, int Sq,
              int Sk, int kvalid, int causal, float scale) {
  constexpr int H4 = HD / 4;    // float4 slots of one key row
  constexpr int C = HD / 16;    // float4 chunks a thread owns
  extern __shared__ float4 smem[];
  float4* ks = smem;            // [BK][H4]
  float4* vs = smem + BK * H4;  // [BK][H4]

  const int part = threadIdx.x % TPR;
  const int qi = blockIdx.x * BQ + threadIdx.x / TPR;
  const bool live = qi < Sq;
  const long long bkv = blockIdx.z;
  const long long head = bkv * G + blockIdx.y;

  float4 qr[C], acc[C];
  const T* qp = q + (head * Sq + (live ? qi : 0)) * HD;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float4 t = live ? load4(qp + 4 * (part + TPR * c)) : make_float4(0, 0, 0, 0);
    qr[c] = make_float4(t.x * scale, t.y * scale, t.z * scale, t.w * scale);
    acc[c] = make_float4(0, 0, 0, 0);
  }
  float m = NEG, l = 0.f;

  // keys this tile of rows may see: the causal bound ends the loop early
  int kend = min(Sk, kvalid);
  if (causal) kend = min(kend, (int)blockIdx.x * BQ + BQ);
  const T* kb = k + bkv * Sk * HD;
  const T* vb = v + bkv * Sk * HD;

  for (int j0 = 0; j0 < kend; j0 += BK) {
    __syncthreads();  // the previous tile has been consumed
    for (int e = threadIdx.x; e < BK * H4; e += THREADS) {
      const int kj = j0 + e / H4;
      const long long off = (long long)kj * HD + 4 * (e % H4);
      const bool in = kj < kend;
      ks[e] = in ? load4(kb + off) : make_float4(0, 0, 0, 0);
      vs[e] = in ? load4(vb + off) : make_float4(0, 0, 0, 0);
    }
    __syncthreads();

    float s[BK];
    float mt = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 kk = ks[j * H4 + part + TPR * c];
        d = fmaf(qr[c].x, kk.x, d);
        d = fmaf(qr[c].y, kk.y, d);
        d = fmaf(qr[c].z, kk.z, d);
        d = fmaf(qr[c].w, kk.w, d);
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      const int kj = j0 + j;
      const bool ok = kj < kend && (!causal || kj <= qi);
      s[j] = ok ? d : -INFINITY;
      mt = fmaxf(mt, s[j]);
    }
    const float alpha = expf(m - mt);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - mt);  // a masked key: exp(-inf) = 0
      ps += p;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float4 vv = vs[j * H4 + part + TPR * c];
        acc[c].x = fmaf(p, vv.x, acc[c].x);
        acc[c].y = fmaf(p, vv.y, acc[c].y);
        acc[c].z = fmaf(p, vv.z, acc[c].z);
        acc[c].w = fmaf(p, vv.w, acc[c].w);
      }
    }
    l = l * alpha + ps;
    m = mt;
  }

  if (!live) return;
  const float den = fmaxf(l, 1e-30f);
  T* op = out + (head * Sq + qi) * HD;
#pragma unroll
  for (int c = 0; c < C; ++c)
    store4(op + 4 * (part + TPR * c),
           make_float4(acc[c].x / den, acc[c].y / den, acc[c].z / den,
                       acc[c].w / den));
}

template <int HD, typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int BKV, int G, int Sq, int Sk, int kvalid, int causal,
                  float scale, cudaStream_t stream) {
  const size_t smem = 2 * BK * HD * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd<HD, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((Sq + BQ - 1) / BQ, G, BKV);
  flash_fwd<HD, T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), G, Sq, Sk, kvalid,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(int hd, const void* q, const void* k, const void* v,
                    void* out, int BKV, int G, int Sq, int Sk, int kvalid,
                    int causal, float scale, cudaStream_t s) {
  switch (hd) {
#define FA_HD(n) \
  case n:        \
    return launch<n, T>(q, k, v, out, BKV, G, Sq, Sk, kvalid, causal, scale, s);
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

// Plain C entry point (bound with ctypes).  q, k, v and out are contiguous,
// 16-byte aligned, all float32 (bf16 == 0) or all bfloat16 (bf16 == 1);
// keys at or past kvalid weigh nothing.  hd is one of 16, 32, 64, 80, 128,
// 192, 256 (every head dim of the registry's attention archs).  Returns the launch's cudaError_t; it does not synchronise.
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
    return fa::dispatch<__nv_bfloat16>(hd, q, k, v, out, BKV, G, Sq, Sk,
                                       kvalid, causal, scale, s);
  return fa::dispatch<float>(hd, q, k, v, out, BKV, G, Sq, Sk, kvalid, causal,
                             scale, s);
}
