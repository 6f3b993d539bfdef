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
// along a sequential k grid axis.  Here a block of 16 warps owns a 128 x 16
// (or 256 x 8) output tile and walks its K range (or its split's) itself:
// lanes over rows, warps over columns, so the bin of each add is the same
// in every lane of a warp, and the 16 bins of a lane's 4 rows sit in
// registers, reached by a ballot walk per bin (pas_common.cuh: layout,
// passes, split-K, what bounds it).  The x stage comes in 16-byte loads
// (4-byte where K or x's alignment forbids) while the warps add the
// previous one.
#include "pas_common.cuh"

namespace pasm {

__global__ void __launch_bounds__(PAS_THREADS, 1)
    pas_matmul_kernel(const float* __restrict__ x,
                      const uint8_t* __restrict__ idx,
                      const float* __restrict__ cb,
                      const float* __restrict__ bias, float* __restrict__ out,
                      float* __restrict__ part, int M, int K, int N,
                      int B, int relu, int pool, int tile, int splits) {
  __shared__ PasSmem sm;
  extern __shared__ float4 pas_ring[];
  float* ring = reinterpret_cast<float*>(pas_ring);
  const PasTile t = pas_tile(tile, pool, K, N, splits, blockIdx.x);
  load_codebook(sm.cb, cb, B);
  float y[PAS_TM];
  MatmulLoader ld{x, M, K,
                  K % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0};
  pas_block(sm, ring, ld, idx, t, N, B, y);
  const int cols = (N + t.bn - 1) / t.bn;
  pas_epilogue(y, ring, t, bias, out, part, M, N, (blockIdx.x / cols) % splits,
               splits, M / (pool * pool), relu, pool);
}

}  // namespace pasm

// Plain C entry point (bound with ctypes).  tile (128 or 256 rows) and
// splits come from pas_histogram.py::pas_plan; a block owns the whole pool
// windows that fit its tile.  part: splits x M x N f32 scratch when
// splits > 1 (else NULL).  bias may be NULL.  Returns the first failing
// launch's cudaError_t; it does not synchronise.
extern "C" int pas_matmul_launch(const float* x, const uint8_t* idx,
                                 const float* cb, const float* bias,
                                 float* out, float* part, long long M, int K,
                                 int N, int B, int relu, int pool, int tile,
                                 int splits, void* stream) {
  using namespace pasm;
  const int pw = pool * pool;
  if (M <= 0 || M > PAS_MAX_M || K <= 0 || M % pw ||
      !pas_args_ok(N, B, pool, tile, splits, part))
    return (int)cudaErrorInvalidValue;
  const int rows = tile - tile % pw, bn = pas_cols(tile);
  const long long blocks =
      (M + rows - 1) / rows * ((N + bn - 1) / bn) * (long long)splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t dyn = pas_dyn_smem_bytes(tile);
  int e0 = pas_smem_opt_in(pas_matmul_kernel, dyn, sizeof(PasSmem));
  if (e0) return e0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pas_matmul_kernel<<<(unsigned)blocks, PAS_THREADS, dyn, s>>>(
      x, idx, cb, bias, out, part, (int)M, K, N, B, relu, pool, tile, splits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  return split_sum_launch(part, bias, out, M, N, splits, relu, pool, 1, s);
}
