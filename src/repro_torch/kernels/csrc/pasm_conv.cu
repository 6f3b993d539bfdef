// K2 — implicit-GEMM PASM convolution for sm_90a.
//
// Replaces the TPU kernel repro/kernels/pasm_matmul.py::pasm_conv_kernel_call
// (_conv_kernel, patch_tile, _slab_image, _image_specs).
//
//   out (B, P_out, N) = window_max(relu(patches(x) . W + bias)),
//
// where patches(x) is never stored: each stage's patch rows are gathered
// straight from the images in global memory (L2-resident: a 3 x 224 x 224
// f32 image is 602 KB against a 50 MB L2) into K1's stage ring, by masked
// 4-byte cp.async.  The rows of the implicit patch matrix run over the
// whole batch, image after image (row m: pixel m % P_rows of image m /
// P_rows, window-major under pool), so a block is full whatever the image
// size, and K1 on the explicit patches takes the same plan.  Columns are
// reduction positions in (c, ky, kx) order (NCHW) or (ky, kx, c) (NHWC).
// A block decodes its rows and columns once into shared-memory tables, so
// an element costs an add and a bounds test; the spatial zero pad and
// positions at or past c*ky*kx (the pack-time K pad) read 0.  No slab
// schedule: images of any size run.  Then K1's dequant stage, product,
// split-K and epilogue (pasm_common.cuh): K1 == K2 bitwise.
#include "pasm_common.cuh"

namespace pasm {

template <int BM, int BN>
__global__ void __launch_bounds__(THREADS, Simt<BM, BN>::MIN_BLOCKS)
    pasm_conv_kernel(const float* __restrict__ x,
                     const uint8_t* __restrict__ idx,
                     const float* __restrict__ cb,
                     const float* __restrict__ bias, float* __restrict__ out,
                     float* __restrict__ part, long long M, SimtConvGeom g,
                     int Kp, int N, int G, int B, int packed, int relu,
                     int splits, int tabn) {
  using S = Simt<BM, BN>;
  extern __shared__ float4 simt_smem[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(simt_smem);
  float* cb_s = reinterpret_cast<float*>(smem + S::AREA);
  int4* rowtab = reinterpret_cast<int4*>(cb_s + (G * B + 3) / 4 * 4);
  int2* coltab = reinterpret_cast<int2*>(rowtab + BM);
  const SimtTile t = simt_tile(BM, BN, g.pool, Kp, N, splits);
  const int ty = simt_ty(), tx = simt_tx();
  load_codebook(cb_s, cb, G * B);
  simt_conv_rows<S>(rowtab, t, M, g);
  simt_conv_cols(coltab, t.kb, tabn, g);
  __syncthreads();  // the tables are visible to the first stages' gathers
  SimtConvLoader<S> ld{x, rowtab, coltab, g, tabn, t.kb, min(t.ke, g.conv_k)};
  float acc[S::TM][S::TN];
  simt_gemm<S>(smem, cb_s, ld, idx, t, Kp, N, G, B, packed, acc, ty, tx);
  simt_epilogue<S>(acc, smem, bias, out, part, M, N, t, splits, relu, g.pool,
                   ty, tx);
}

template <int BM, int BN>
static int launch(const float* x, const uint8_t* idx, const float* cb,
                  const float* bias, float* out, float* part, long long M,
                  const SimtConvGeom& g, int Kp, int N, int G, int B,
                  int packed, int relu, int splits, cudaStream_t stream) {
  using S = Simt<BM, BN>;
  const int rows = BM - BM % (g.pool * g.pool);
  const long long blocks =
      (M + rows - 1) / rows * ((N + BN - 1) / BN) * (long long)splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the column table holds a split's stages, at most SIMT_TAB_MAX columns
  const int stages = (Kp + SIMT_BK - 1) / SIMT_BK;
  const int per = (stages + splits - 1) / splits * SIMT_BK;
  const int tabn = min(per, SIMT_TAB_MAX);
  const size_t smem = simt_smem_bytes<S>(G, B, tabn);
  int e0 = simt_smem_opt_in(pasm_conv_kernel<BM, BN>, smem);
  if (e0) return e0;
  pasm_conv_kernel<BM, BN><<<(unsigned)blocks, THREADS, smem, stream>>>(
      x, idx, cb, bias, out, part, M, g, Kp, N, G, B, packed, relu, splits,
      tabn);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return split_sum_launch(part, bias, out, M, N, splits, relu, g.pool, 1,
                          stream);
}

}  // namespace pasm

// Plain C entry point (bound with ctypes).  x is the unpadded image batch;
// its rows (output pixels, window-major) run image after image, as K1's
// rows of the explicit patch matrix do, and bm x bn and splits come from
// pasm_matmul.py::simt_plan over them.  part: splits x batch*P_rows x N f32
// scratch when splits > 1 (else NULL); bias may be NULL.  Returns the first
// failing launch's cudaError_t; it does not synchronise.
extern "C" int pasm_conv_launch(const float* x, const uint8_t* idx,
                                const float* cb, const float* bias, float* out,
                                float* part, long long batch, int C, int H,
                                int W, int nhwc, int ky, int kx, int stride,
                                int pad_h, int pad_w, int ow, int pool,
                                int P_out, int conv_k, int Kp, int N, int G,
                                int B, int packed, int relu, int bm, int bn,
                                int splits, void* stream) {
  using namespace pasm;
  // offsets within an image are ints; a column's (dy, dx) travel as 16 bits
  if (batch <= 0 || P_out <= 0 || Kp < conv_k || Kp <= 0 ||
      !simt_args_ok(N, G, B, pool, bm, bn, splits, part) || Kp % G ||
      (long long)C * H * W > 0x7fffffffLL || ky > 32767 || kx > 32767)
    return (int)cudaErrorInvalidValue;
  const int P_rows = P_out * pool * pool;
  const long long M = batch * P_rows;
  const SimtConvGeom g{C,     H,     W,  nhwc, ky,     kx,    stride,
                       pad_h, pad_w, ow, pool, P_rows, conv_k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bm == 256)
    return launch<256, 64>(x, idx, cb, bias, out, part, M, g, Kp, N, G, B,
                           packed, relu, splits, s);
  if (bn == 64)
    return launch<128, 64>(x, idx, cb, bias, out, part, M, g, Kp, N, G, B,
                           packed, relu, splits, s);
  if (bn == 96)
    return launch<128, 96>(x, idx, cb, bias, out, part, M, g, Kp, N, G, B,
                           packed, relu, splits, s);
  return launch<128, 128>(x, idx, cb, bias, out, part, M, g, Kp, N, G, B,
                          packed, relu, splits, s);
}
