// K1 — fused-dequant PASM GEMM for sm_90a.
//
// Replaces the TPU kernel repro/kernels/pasm_matmul.py::pasm_matmul_kernel_call
// (_kernel -> _fused_dequant_step, _dequant_tile, _unpack_int4_tile).
//
//   out (M / pool^2, N) = window_max(relu(x (M, K) . W (K, N) + bias))
//   W[k, n] = codebook[k / (K / G)][idx[k, n]]     (never stored)
//
// The TPU kernel walked a sequential k grid axis with a VMEM accumulator;
// here one block owns a BM x 64 output tile and runs the whole K loop
// itself, 16 reduction rows per shared-memory stage, accumulating in f32
// registers (see pasm_common.cuh for the thread layout and epilogue).  It
// is bound by f32 FMA throughput at the AlexNet shapes; no tensor cores yet.
#include "pasm_common.cuh"

namespace pasm {

template <int BM>
__global__ void __launch_bounds__(THREADS)
    pasm_matmul_kernel(const float* __restrict__ x,
                       const uint8_t* __restrict__ idx,
                       const float* __restrict__ cb,
                       const float* __restrict__ bias, float* __restrict__ out,
                       int M, int K, int N, int G, int B, int packed, int relu,
                       int pool, int rows) {
  constexpr int TM = BM / 16;
  __shared__ Stage<BM> st;
  extern __shared__ float4 dyn4[];
  float* cb_s = reinterpret_cast<float*>(dyn4);
  float* pool_s = cb_s + ((G * B + 3) / 4) * 4;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long m0 = (long long)blockIdx.x * rows;
  const int n0 = blockIdx.y * BN;
  const int gs = K / G;
  load_codebook(cb_s, cb, G * B);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // BK divides THREADS, so each thread always loads the same column kk
  const int kk = threadIdx.x % BK;
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // previous stage consumed; codebook visible
    const int k = k0 + kk;
    for (int r = threadIdx.x / BK; r < BM; r += THREADS / BK) {
      long long m = m0 + r;
      st.xs[kk][r] = (r < rows && m < M && k < K) ? x[m * K + k] : 0.f;
    }
    load_weight_tile<BM>(st, idx, cb_s, k0, n0, K, N, gs, B, packed);
    __syncthreads();
    stage_product<BM>(st, acc, ty, tx);
  }

  const int pw = pool * pool;
  epilogue<GemmLayout<BM>>(acc, pool_s, bias, out, n0, N, rows, m0 / pw,
                           M / pw, relu, pool, ty, tx);
}

template <int BM>
static int launch(const float* x, const uint8_t* idx, const float* cb,
                  const float* bias, float* out, int M, int K, int N, int G,
                  int B, int packed, int relu, int pool, int rows,
                  cudaStream_t stream) {
  size_t smem = dyn_smem_bytes(G, B, BM, pool);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pasm_matmul_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((M + rows - 1) / rows, (N + BN - 1) / BN);
  pasm_matmul_kernel<BM><<<grid, THREADS, smem, stream>>>(
      x, idx, cb, bias, out, M, K, N, G, B, packed, relu, pool, rows);
  return (int)cudaGetLastError();
}

}  // namespace pasm

// Plain C entry point (bound with ctypes).  bm is the row tile (64 or 256);
// a block owns the whole pool windows that fit it.  bias may be NULL.
// Returns the launch's cudaError_t; it does not synchronise.
extern "C" int pasm_matmul_launch(const float* x, const uint8_t* idx,
                                  const float* cb, const float* bias,
                                  float* out, int M, int K, int N, int G,
                                  int B, int packed, int relu, int pool,
                                  int bm, void* stream) {
  const int pw = pool * pool;
  if (M <= 0 || N <= 0 || K <= 0 || G <= 0 || K % G || pool < 1 ||
      M % pw || pw > bm)
    return (int)cudaErrorInvalidValue;
  const int rows = bm - bm % pw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 64)
    return pasm::launch<64>(x, idx, cb, bias, out, M, K, N, G, B, packed,
                            relu, pool, rows, s);
  if (bm == 256)
    return pasm::launch<256>(x, idx, cb, bias, out, M, K, N, G, B, packed,
                             relu, pool, rows, s);
  return (int)cudaErrorInvalidValue;
}
