// K4 — implicit-GEMM paper-faithful PAS convolution for sm_90a.
//
// Replaces the TPU kernel repro/kernels/pas_histogram.py::pas_conv_kernel_call
// (_conv_kernel -> patch_tile, _pas_step).
//
//   out (B, P_out, N) = window_max(relu(PAS(patches(x), idx, cb) + bias))
//
// per image: K3's PAS phase and post-pass (pas_common.cuh) on K2's patch
// tiles, gathered straight from the unpadded image in global memory with
// K2's row and column decode (pasm_common.cuh: window-major rows, masked
// spatial pad, 0 at q >= c*ky*kx).  K3 and K4 walk K in the same 16-row
// stages and add into each bin in the same order, so the explicit and
// implicit PAS engines agree bitwise.  No patch matrix, no slab schedule:
// images of any size run.
#include "pas_common.cuh"

namespace pasm {

template <int BM>
__global__ void __launch_bounds__(THREADS)
    pas_conv_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ idx,
                    const float* __restrict__ cb,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int C, int H, int W, int nhwc, int ky, int kx, int stride,
                    int pad_h, int pad_w, int ow, int pool, int P_out,
                    int conv_k, int Kp, int N, int B, int relu, int rows) {
  using L = PasLayout<BM>;
  __shared__ PasStage<L> st;
  __shared__ int row_iy[BM], row_ix[BM];  // top-left input pixel of each row
  extern __shared__ float4 dyn4[];
  float* cb_s = reinterpret_cast<float*>(dyn4);
  float* pool_s = cb_s + ((B + 3) / 4) * 4;
  float* bins = pool_s + (pool > 1 ? L::BM * L::BN : 0);

  const int tx = threadIdx.x % L::BN, ty = threadIdx.x / L::BN;
  const int pw = pool * pool;
  const int m0 = blockIdx.x * rows;
  const int n0 = blockIdx.y * L::BN;
  const float* img = x + (size_t)blockIdx.z * C * H * W;
  load_codebook(cb_s, cb, B);
  conv_row_origins<BM>(row_iy, row_ix, m0, rows, P_out * pw, pool, ow, stride,
                       pad_h, pad_w);

  float y[PAS_TM][1];
#pragma unroll
  for (int i = 0; i < PAS_TM; ++i) y[i][0] = 0.f;

  for (int b0 = 0; b0 < B; b0 += PAS_BINS) {
    const int nb = min(PAS_BINS, B - b0);
    zero_bins(bins, nb);
    for (int k0 = 0; k0 < Kp; k0 += BK) {
      __syncthreads();  // previous stage consumed; codebook and rows visible
      gather_patch_stage<BM>(&st.xs[0][0], PasStage<L>::LD, img, row_iy,
                             row_ix, k0, conv_k, nhwc, C, H, W, ky, kx);
      load_bin_tile<L>(st, idx, k0, n0, Kp, N);
      __syncthreads();
      pas_stage<L>(st, bins, b0, nb, ty, tx);
    }
    pas_postpass(bins, cb_s, b0, nb, y);
  }

  epilogue<L>(y, pool_s, bias, out + (size_t)blockIdx.z * P_out * N, n0, N,
              rows, m0 / pw, P_out, relu, pool, ty, tx);
}

template <int BM>
static int launch(const float* x, const uint8_t* idx, const float* cb,
                  const float* bias, float* out, int batch, int C, int H,
                  int W, int nhwc, int ky, int kx, int stride, int pad_h,
                  int pad_w, int ow, int pool, int P_out, int conv_k, int Kp,
                  int N, int B, int relu, int rows, cudaStream_t stream) {
  using L = PasLayout<BM>;
  const int P_rows = P_out * pool * pool;
  dim3 grid((P_rows + rows - 1) / rows, (N + L::BN - 1) / L::BN, batch);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  size_t smem = pas_dyn_smem_bytes(B, L::BM, L::BN, pool);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pas_conv_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pas_conv_kernel<BM><<<grid, THREADS, smem, stream>>>(
      x, idx, cb, bias, out, C, H, W, nhwc, ky, kx, stride, pad_h, pad_w, ow,
      pool, P_out, conv_k, Kp, N, B, relu, rows);
  return (int)cudaGetLastError();
}

}  // namespace pasm

// Plain C entry point (bound with ctypes).  x is the unpadded image batch;
// bm is the row tile (32 or 256) and a block owns the whole pool windows
// that fit it; bias may be NULL.  Returns the launch's cudaError_t; it does
// not synchronise.
extern "C" int pas_conv_launch(const float* x, const uint8_t* idx,
                               const float* cb, const float* bias, float* out,
                               int batch, int C, int H, int W, int nhwc,
                               int ky, int kx, int stride, int pad_h,
                               int pad_w, int ow, int pool, int P_out,
                               int conv_k, int Kp, int N, int B, int relu,
                               int bm, void* stream) {
  const int pw = pool * pool;
  if (batch <= 0 || batch > 65535 || P_out <= 0 || N <= 0 || B <= 0 ||
      B > 256 || Kp < conv_k || pool < 1 || pw > bm)
    return (int)cudaErrorInvalidValue;
  const int rows = bm - bm % pw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 32)
    return pasm::launch<32>(x, idx, cb, bias, out, batch, C, H, W, nhwc, ky,
                            kx, stride, pad_h, pad_w, ow, pool, P_out, conv_k,
                            Kp, N, B, relu, rows, s);
  if (bm == 256)
    return pasm::launch<256>(x, idx, cb, bias, out, batch, C, H, W, nhwc, ky,
                             kx, stride, pad_h, pad_w, ow, pool, P_out,
                             conv_k, Kp, N, B, relu, rows, s);
  return (int)cudaErrorInvalidValue;
}
