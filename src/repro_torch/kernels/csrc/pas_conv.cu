// K4 — implicit-GEMM paper-faithful PAS convolution for sm_90a.
//
// Replaces the TPU kernel repro/kernels/pas_histogram.py::pas_conv_kernel_call
// (_conv_kernel -> patch_tile, _pas_step).
//
//   out (B, P_out, N) = window_max(relu(PAS(patches(x), idx, cb) + bias))
//
// K3's device body (pas_common.cuh: pas_block, pas_epilogue) with the patch
// stage gathered straight from the unpadded images (ConvLoader: window-major
// rows, masked spatial pad, 0 at q >= c*ky*kx).  The rows of the implicit
// patch matrix run image after image, so K3 on the explicit patches and K4
// take the same plan, walk K in the same stages and add into each bin in
// the same order: the explicit and implicit PAS engines agree bitwise.  No
// patch matrix, no slab schedule: images of any size run (an image wider
// or taller than 16-bit coordinates hold takes the WIDE row record), and
// the wrapper splits a batch of more than PAS_MAX_M rows into launches.
#include "pas_common.cuh"

namespace pasm {

template <bool WIDE>
__global__ void __launch_bounds__(PAS_THREADS, 1)
    pas_conv_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ idx,
                    const float* __restrict__ cb,
                    const float* __restrict__ bias, float* __restrict__ out,
                    float* __restrict__ part, int M, int C, int H,
                    int W, int nhwc, int ky, int kx, int stride, int pad_h,
                    int pad_w, int ow, int pool, int P_rows, int conv_k,
                    int Kp, int N, int B, int relu, int tile, int splits) {
  __shared__ PasSmem sm;
  __shared__ typename PasRow<WIDE>::T rows[PAS_MAX_ROWS];
  extern __shared__ float4 pas_ring[];
  float* ring = reinterpret_cast<float*>(pas_ring);
  const PasTile t = pas_tile(tile, pool, Kp, N, splits, blockIdx.x);
  load_codebook(sm.cb, cb, B);
  pas_conv_rows<WIDE>(rows, t, M, P_rows, pool, ow, stride, pad_h, pad_w);
  __syncthreads();  // row origins visible to the first stage's gather
  ConvLoader<WIDE> ld{x, rows, conv_k, nhwc, C, H, W, ky, kx};
  float y[PAS_TM];
  pas_block(sm, ring, ld, idx, t, N, B, y);
  const int cols = (N + t.bn - 1) / t.bn;
  pas_epilogue(y, ring, t, bias, out, part, M, N,
               (blockIdx.x / cols) % splits, splits, M / (pool * pool), relu,
               pool);
}

}  // namespace pasm

// Plain C entry point (bound with ctypes).  x is the unpadded image batch;
// its rows (output pixels, window-major) run image after image, as K3's
// rows of the patch matrix do, and tile and splits come from
// pas_histogram.py::pas_plan over them.  part: splits x batch*P_rows x N
// f32 scratch when splits > 1 (else NULL); bias may be NULL.  Returns the
// first failing launch's cudaError_t; it does not synchronise.
extern "C" int pas_conv_launch(const float* x, const uint8_t* idx,
                               const float* cb, const float* bias, float* out,
                               float* part, int batch, int C, int H, int W,
                               int nhwc, int ky, int kx, int stride, int pad_h,
                               int pad_w, int ow, int pool, int P_out,
                               int conv_k, int Kp, int N, int B, int relu,
                               int tile, int splits, void* stream) {
  using namespace pasm;
  const int pw = pool * pool;
  // offsets within an image are ints
  if (batch <= 0 || P_out <= 0 || Kp < conv_k || Kp <= 0 ||
      (long long)C * H * W > 0x7fffffffLL ||
      !pas_args_ok(N, B, pool, tile, splits, part))
    return (int)cudaErrorInvalidValue;
  const int P_rows = P_out * pw;
  const long long M = (long long)batch * P_rows;
  if (M > PAS_MAX_M) return (int)cudaErrorInvalidValue;
  const int rows = tile - tile % pw, bn = pas_cols(tile);
  const long long blocks = (M + rows - 1) / rows * ((N + bn - 1) / bn) * splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // a pixel coordinate (with its kernel offset) lies in [-(k + stride),
  // size + k + stride]: 16-bit halves hold it up to 32767
  const bool wide = (long long)H + ky + stride > 32767 ||
                    (long long)W + kx + stride > 32767;
  const size_t dyn = pas_dyn_smem_bytes(tile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide) {
    int e0 = pas_smem_opt_in(pas_conv_kernel<true>, dyn,
                             sizeof(PasSmem) + PAS_MAX_ROWS * sizeof(int4));
    if (e0) return e0;
    pas_conv_kernel<true><<<(unsigned)blocks, PAS_THREADS, dyn, s>>>(
        x, idx, cb, bias, out, part, (int)M, C, H, W, nhwc, ky, kx, stride,
        pad_h, pad_w, ow, pool, P_rows, conv_k, Kp, N, B, relu, tile, splits);
  } else {
    int e0 = pas_smem_opt_in(pas_conv_kernel<false>, dyn,
                             sizeof(PasSmem) + PAS_MAX_ROWS * sizeof(int2));
    if (e0) return e0;
    pas_conv_kernel<false><<<(unsigned)blocks, PAS_THREADS, dyn, s>>>(
        x, idx, cb, bias, out, part, (int)M, C, H, W, nhwc, ky, kx, stride,
        pad_h, pad_w, ow, pool, P_rows, conv_k, Kp, N, B, relu, tile, splits);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return split_sum_launch(part, bias, out, M, N, splits, relu, pool, 1, s);
}
