// K2 — implicit-GEMM PASM convolution for sm_90a.
//
// Replaces the TPU kernel repro/kernels/pasm_matmul.py::pasm_conv_kernel_call
// (_conv_kernel, patch_tile, _slab_image, _image_specs).
//
//   out (B, P_out, N) = window_max(relu(patches(x) . W + bias)),
//
// per image, where patches(x) is never stored: each stage's patch tile is
// gathered straight from the image in global memory (it is L2-resident: a
// 3 x 224 x 224 f32 image is 602 KB against a 50 MB L2), with the index
// decode of the TPU kernel's patch_tile.  GEMM rows are window-major under
// pool (row m = offset m % pool^2 of pooled pixel m / pool^2); columns are
// reduction positions in (c, ky, kx) order (NCHW) or (ky, kx, c) (NHWC).
// The spatial zero-pad is a masked read, and positions at or past c*ky*kx
// (the pack-time K pad) read 0.  There is no whole-image residency and no
// slab schedule, so images of any size run.  Then the same dequant stage and
// epilogue as K1 (pasm_common.cuh).
#include "pasm_common.cuh"

namespace pasm {

template <int BM>
__global__ void __launch_bounds__(THREADS)
    pasm_conv_kernel(const float* __restrict__ x,
                     const uint8_t* __restrict__ idx,
                     const float* __restrict__ cb,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int C, int H, int W, int nhwc, int ky, int kx, int stride,
                     int pad_h, int pad_w, int ow, int pool, int P_out,
                     int conv_k, int Kp, int N, int G, int B, int packed,
                     int relu, int rows) {
  constexpr int TM = BM / 16;
  __shared__ Stage<BM> st;
  __shared__ int row_iy[BM], row_ix[BM];  // top-left input pixel of each row
  extern __shared__ float4 dyn4[];
  float* cb_s = reinterpret_cast<float*>(dyn4);
  float* pool_s = cb_s + ((G * B + 3) / 4) * 4;

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int pw = pool * pool;
  const int m0 = blockIdx.x * rows;
  const int n0 = blockIdx.y * BN;
  const float* img = x + (size_t)blockIdx.z * C * H * W;
  const int gs = Kp / G;
  load_codebook(cb_s, cb, G * B);
  conv_row_origins<BM>(row_iy, row_ix, m0, rows, P_out * pw, pool, ow, stride,
                       pad_h, pad_w);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Kp; k0 += BK) {
    __syncthreads();  // previous stage consumed; codebook and rows visible
    gather_patch_stage<BM>(&st.xs[0][0], BM + 1, img, row_iy, row_ix, k0,
                           conv_k, nhwc, C, H, W, ky, kx);
    load_weight_tile<BM>(st, idx, cb_s, k0, n0, Kp, N, gs, B, packed);
    __syncthreads();
    stage_product<BM>(st, acc, ty, tx);
  }

  epilogue<GemmLayout<BM>>(acc, pool_s, bias,
                           out + (size_t)blockIdx.z * P_out * N, n0, N, rows,
                           m0 / pw, P_out, relu, pool, ty, tx);
}

template <int BM>
static int launch(const float* x, const uint8_t* idx, const float* cb,
                  const float* bias, float* out, int batch, int C, int H,
                  int W, int nhwc, int ky, int kx, int stride, int pad_h,
                  int pad_w, int ow, int pool, int P_out, int conv_k, int Kp,
                  int N, int G, int B, int packed, int relu, int rows,
                  cudaStream_t stream) {
  size_t smem = dyn_smem_bytes(G, B, BM, pool);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pasm_conv_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int P_rows = P_out * pool * pool;
  dim3 grid((P_rows + rows - 1) / rows, (N + BN - 1) / BN, batch);
  pasm_conv_kernel<BM><<<grid, THREADS, smem, stream>>>(
      x, idx, cb, bias, out, C, H, W, nhwc, ky, kx, stride, pad_h, pad_w, ow,
      pool, P_out, conv_k, Kp, N, G, B, packed, relu, rows);
  return (int)cudaGetLastError();
}

}  // namespace pasm

// Plain C entry point (bound with ctypes).  x is the unpadded image batch;
// bm is the row tile (64 or 256) and a block owns the whole pool windows
// that fit it; bias may be NULL.  Returns the launch's cudaError_t; it does
// not synchronise.
extern "C" int pasm_conv_launch(const float* x, const uint8_t* idx,
                                const float* cb, const float* bias, float* out,
                                int batch, int C, int H, int W, int nhwc,
                                int ky, int kx, int stride, int pad_h,
                                int pad_w, int ow, int pool, int P_out,
                                int conv_k, int Kp, int N, int G, int B,
                                int packed, int relu, int bm, void* stream) {
  const int pw = pool * pool;
  if (batch <= 0 || batch > 65535 || P_out <= 0 || N <= 0 || G <= 0 ||
      Kp % G || Kp < conv_k || pool < 1 || pw > bm)
    return (int)cudaErrorInvalidValue;
  const int rows = bm - bm % pw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 64)
    return pasm::launch<64>(x, idx, cb, bias, out, batch, C, H, W, nhwc, ky,
                            kx, stride, pad_h, pad_w, ow, pool, P_out, conv_k,
                            Kp, N, G, B, packed, relu, rows, s);
  if (bm == 256)
    return pasm::launch<256>(x, idx, cb, bias, out, batch, C, H, W, nhwc, ky,
                             kx, stride, pad_h, pad_w, ow, pool, P_out,
                             conv_k, Kp, N, G, B, packed, relu, rows, s);
  return (int)cudaErrorInvalidValue;
}
