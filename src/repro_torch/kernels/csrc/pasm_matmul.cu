// K1 (f32 route) — fused-dequant PASM GEMM for sm_90a.
//
// Replaces the TPU kernel repro/kernels/pasm_matmul.py::pasm_matmul_kernel_call
// (_kernel -> _fused_dequant_step, _dequant_tile, _unpack_int4_tile).
//
//   out (M / pool^2, N) = window_max(relu(x (M, K) . W (K, N) + bias))
//   W[k, n] = codebook[k / (K / G)][idx[k, n]]     (never stored)
//
// The TPU kernel walked a sequential k grid axis with a VMEM accumulator;
// here a block owns a 128 x 64/96/128 output tile (a thread 8 x 8, 8 x 6 or
// 8 x 4 of it) and runs its K range itself: x and index stages arrive by
// cp.async in a ring, 16 k a stage, each index stage is dequantized once
// into an f32 tile, and every output is one f32 fmaf chain (no tensor cores,
// no TF32).  It is bound by the f32 FMA pipe at the AlexNet shapes.  Split-K
// (a count fixed by K and N, pasm_matmul.py::simt_plan) runs the late
// stages' short-M layers on enough blocks; split_sum adds the partials in
// order.  pasm_common.cuh has the layout, the ring and the epilogue.
#include "pasm_common.cuh"

namespace pasm {

template <int BM, int BN>
__global__ void __launch_bounds__(THREADS, Simt<BM, BN>::MIN_BLOCKS)
    pasm_matmul_kernel(const float* __restrict__ x,
                       const uint8_t* __restrict__ idx,
                       const float* __restrict__ cb,
                       const float* __restrict__ bias, float* __restrict__ out,
                       float* __restrict__ part, long long M, int K, int N,
                       int G, int B, int packed, int relu, int pool,
                       int splits) {
  using S = Simt<BM, BN>;
  extern __shared__ float4 simt_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(simt_smem);
  float* cb_s = reinterpret_cast<float*>(smem + S::AREA);
  const SimtTile t = simt_tile(BM, BN, pool, K, N, splits);
  const int ty = simt_ty(), tx = simt_tx();
  load_codebook(cb_s, cb, G * B);
  SimtMatLoader<S> ld{x, M, K,
                      K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0};
  float acc[S::TM][S::TN];
  simt_gemm<S>(smem, cb_s, ld, idx, t, K, N, G, B, packed, acc, ty, tx);
  simt_epilogue<S>(acc, smem, bias, out, part, M, N, t, splits, relu, pool,
                   ty, tx);
}

template <int BM, int BN>
static int launch(const float* x, const uint8_t* idx, const float* cb,
                  const float* bias, float* out, float* part, long long M,
                  int K, int N, int G, int B, int packed, int relu, int pool,
                  int splits, cudaStream_t stream) {
  using S = Simt<BM, BN>;
  const int rows = BM - BM % (pool * pool);
  const long long blocks =
      (M + rows - 1) / rows * ((N + BN - 1) / BN) * (long long)splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = simt_smem_bytes<S>(G, B, 0);
  int e0 = simt_smem_opt_in(pasm_matmul_kernel<BM, BN>, smem);
  if (e0) return e0;
  pasm_matmul_kernel<BM, BN><<<(unsigned)blocks, THREADS, smem, stream>>>(
      x, idx, cb, bias, out, part, M, K, N, G, B, packed, relu, pool, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return split_sum_launch(part, bias, out, M, N, splits, relu, pool, 1, stream);
}

}  // namespace pasm

// Plain C entry point (bound with ctypes).  bm x bn is the block tile and
// splits the split-K count, both from pasm_matmul.py::simt_plan; a block
// owns the whole pool windows that fit its bm rows.  part: splits x M x N
// f32 scratch when splits > 1 (else NULL); bias may be NULL.  Returns the
// first failing launch's cudaError_t; it does not synchronise.
extern "C" int pasm_matmul_launch(const float* x, const uint8_t* idx,
                                  const float* cb, const float* bias,
                                  float* out, float* part, long long M, int K,
                                  int N, int G, int B, int packed, int relu,
                                  int pool, int bm, int bn, int splits,
                                  void* stream) {
  using namespace pasm;
  if (M <= 0 || K <= 0 || !simt_args_ok(N, G, B, pool, bm, bn, splits, part) ||
      K % G || M % (pool * pool))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 256)
    return launch<256, 64>(x, idx, cb, bias, out, part, M, K, N, G, B, packed,
                           relu, pool, splits, s);
  if (bn == 64)
    return launch<128, 64>(x, idx, cb, bias, out, part, M, K, N, G, B, packed,
                           relu, pool, splits, s);
  if (bn == 96)
    return launch<128, 96>(x, idx, cb, bias, out, part, M, K, N, G, B, packed,
                           relu, pool, splits, s);
  return launch<128, 128>(x, idx, cb, bias, out, part, M, K, N, G, B, packed,
                          relu, pool, splits, s);
}
