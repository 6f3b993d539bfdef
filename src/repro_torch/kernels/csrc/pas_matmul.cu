// K3 — paper-faithful two-phase PAS GEMM for sm_90a.
//
// Replaces the TPU kernel repro/kernels/pas_histogram.py::pas_matmul_kernel_call
// (_kernel -> _pas_step).
//
//   out (M / pool^2, N) = window_max(relu(y + bias)),
//   y[m, n] = sum_b cb[b] * sum_{k : idx[k, n] = b} x[m, k]
//
// One dictionary (G = 1), unpacked uint8 idx (K, N).  The TPU kernel ran the
// PAS phase as x_tile @ one_hot(idx_tile) into a (bm, bn, B) VMEM scratch
// (1 MiB at its tiles) along a sequential k grid axis.  Here one block owns
// a 32 x 32 (or 256 x 4) output tile and runs the whole K loop itself, 16
// reduction rows per shared-memory stage, adding each activation into its
// bin in shared memory (pas_common.cuh: layout, tiles per B, passes).  The
// post-pass folds the codebook in at the end, then K1's epilogue runs.
#include "pas_common.cuh"

namespace pasm {

template <int BM>
__global__ void __launch_bounds__(THREADS)
    pas_matmul_kernel(const float* __restrict__ x,
                      const uint8_t* __restrict__ idx,
                      const float* __restrict__ cb,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int M, int K, int N, int B, int relu, int pool,
                      int rows) {
  using L = PasLayout<BM>;
  __shared__ PasStage<L> st;
  extern __shared__ float4 dyn4[];
  float* cb_s = reinterpret_cast<float*>(dyn4);
  float* pool_s = cb_s + ((B + 3) / 4) * 4;
  float* bins = pool_s + (pool > 1 ? L::BM * L::BN : 0);

  const int tx = threadIdx.x % L::BN, ty = threadIdx.x / L::BN;
  const long long m0 = (long long)blockIdx.x * rows;
  const int n0 = blockIdx.y * L::BN;
  load_codebook(cb_s, cb, B);

  float y[PAS_TM][1];
#pragma unroll
  for (int i = 0; i < PAS_TM; ++i) y[i][0] = 0.f;

  // BK divides THREADS, so each thread always loads the same column kk
  const int kk = threadIdx.x % BK;
  for (int b0 = 0; b0 < B; b0 += PAS_BINS) {
    const int nb = min(PAS_BINS, B - b0);
    zero_bins(bins, nb);
    for (int k0 = 0; k0 < K; k0 += BK) {
      __syncthreads();  // previous stage consumed; codebook visible
      const int k = k0 + kk;
      for (int r = threadIdx.x / BK; r < BM; r += THREADS / BK) {
        long long m = m0 + r;
        st.xs[kk][r] = (r < rows && m < M && k < K) ? x[m * K + k] : 0.f;
      }
      load_bin_tile<L>(st, idx, k0, n0, K, N);
      __syncthreads();
      pas_stage<L>(st, bins, b0, nb, ty, tx);
    }
    pas_postpass(bins, cb_s, b0, nb, y);
  }

  const int pw = pool * pool;
  epilogue<L>(y, pool_s, bias, out, n0, N, rows, m0 / pw, M / pw, relu, pool,
              ty, tx);
}

template <int BM>
static int launch(const float* x, const uint8_t* idx, const float* cb,
                  const float* bias, float* out, int M, int K, int N, int B,
                  int relu, int pool, int rows, cudaStream_t stream) {
  using L = PasLayout<BM>;
  dim3 grid((M + rows - 1) / rows, (N + L::BN - 1) / L::BN);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  size_t smem = pas_dyn_smem_bytes(B, L::BM, L::BN, pool);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pas_matmul_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pas_matmul_kernel<BM><<<grid, THREADS, smem, stream>>>(
      x, idx, cb, bias, out, M, K, N, B, relu, pool, rows);
  return (int)cudaGetLastError();
}

}  // namespace pasm

// Plain C entry point (bound with ctypes).  bm is the row tile (32 or 256);
// a block owns the whole pool windows that fit it.  bias may be NULL.
// Returns the launch's cudaError_t; it does not synchronise.
extern "C" int pas_matmul_launch(const float* x, const uint8_t* idx,
                                 const float* cb, const float* bias,
                                 float* out, int M, int K, int N, int B,
                                 int relu, int pool, int bm, void* stream) {
  const int pw = pool * pool;
  if (M <= 0 || N <= 0 || K <= 0 || B <= 0 || B > 256 || pool < 1 ||
      M % pw || pw > bm)
    return (int)cudaErrorInvalidValue;
  const int rows = bm - bm % pw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 32)
    return pasm::launch<32>(x, idx, cb, bias, out, M, K, N, B, relu, pool,
                            rows, s);
  if (bm == 256)
    return pasm::launch<256>(x, idx, cb, bias, out, M, K, N, B, relu, pool,
                             rows, s);
  return (int)cudaErrorInvalidValue;
}
