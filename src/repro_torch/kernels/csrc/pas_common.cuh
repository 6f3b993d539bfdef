// Shared device code of the two PAS kernels (K3 pas_matmul.cu, K4
// pas_conv.cu): the paper's two-phase PASM (§2.2) on SIMT.
//
//   PAS phase   S[m, n, b] += x[m, k]      for b = idx[k, n]   (adds only)
//   post-pass   y[m, n] = sum_b S[m, n, b] * cb[b]             (B FMAs)
//
// then the bias / ReLU / window-max epilogue of K1/K2 (pasm_common.cuh).
//
// The bin accumulators are the PAS register file of the circuit.  An array
// indexed by a runtime bin would spill to local memory, and a compare-and-
// select over every bin is the TPU's one-hot again (B times the work), so
// the bins live in shared memory, laid out [bin][row slot][thread]: the
// runtime bin picks the row of the array and the thread index the bank, so
// the read-modify-write of a warp never conflicts, whatever bins its lanes
// hit.  Each thread owns its outputs' bins, so no atomics and no barriers
// guard them.
//
// Tiles: 256 threads; a thread owns TM = 4 consecutive rows of one column.
// All rows of a column share idx[k, n], so the bin is decoded once per
// (k, column) and its four adds take one float4 read of the activation
// tile.  Two tiles, picked by the pool window like K1's:
//   BM = 32  x BN = 32 outputs (8 row lanes x 32 column lanes), pool^2 <= 32;
//   BM = 256 x BN = 4  outputs (64 x 4 lanes), pool^2 <= 256 (pool 6..16).
// Bins: PAS_BINS = 16 per pass, 16 x 1024 x 4 B = 64 KB of shared memory at
// every B; B <= 16 takes one pass (B x 16 KB: 16 KB at B = 4, 64 KB at 16),
// and a larger dictionary walks K once per 16 bins (B = 256: 16 passes),
// each pass adding only the indices in its bins and folding them into the
// post-pass in bin order.  An index >= B falls in no pass and adds nothing:
// the one-hot of the JAX reference maps it to an all-zero row.
//
// What bounds them: a shared-memory read-modify-write per (m, k, n), about
// 2.5 shared-memory accesses per add, against K1/K2's register-tile FMA.
#pragma once

#include "pasm_common.cuh"

namespace pasm {

constexpr int PAS_TM = 4;     // consecutive rows per thread
constexpr int PAS_BINS = 16;  // bins per pass

template <int BM>
using PasLayout = Layout<BM, (BM == 32 ? 32 : 4), PAS_TM, 1, true>;

// One K stage: the activation / patch tile (k-major, rows padded to keep
// each 4-row group 16-byte aligned) and the stage's bin indices (-1: masked).
template <class L>
struct PasStage {
  static constexpr int LD = L::BM + 4;
  __align__(16) float xs[BK][LD];
  int bin[BK][L::BN];
};

inline size_t pas_dyn_smem_bytes(int B, int bm, int bn, int pool) {
  size_t cb = ((size_t)B * sizeof(float) + 15) / 16 * 16;
  size_t pool_tile = pool > 1 ? (size_t)bm * bn * sizeof(float) : 0;
  size_t nb = B < PAS_BINS ? B : PAS_BINS;
  return cb + pool_tile + nb * PAS_TM * THREADS * sizeof(float);
}

// Bin indices of rows [k0, k0 + BK) x columns [n0, n0 + BN).  Rows past K
// and columns past N are -1, which no pass adds.
template <class L>
__device__ __forceinline__ void load_bin_tile(PasStage<L>& st,
                                              const uint8_t* __restrict__ idx,
                                              int k0, int n0, int K, int N) {
  for (int e = threadIdx.x; e < BK * L::BN; e += THREADS) {
    int r = e / L::BN, c = e % L::BN;
    int k = k0 + r, n = n0 + c;
    st.bin[r][c] = (k < K && n < N) ? (int)idx[(size_t)k * N + n] : -1;
  }
}

__device__ __forceinline__ void zero_bins(float* bins, int nb) {
  for (int s = 0; s < nb * PAS_TM; ++s) bins[s * THREADS + threadIdx.x] = 0.f;
}

// PAS phase over one stage: for each k, the column's bin (once) and the
// thread's four rows added into it, in k order.
template <class L>
__device__ __forceinline__ void pas_stage(const PasStage<L>& st, float* bins,
                                          int b0, int nb, int ty, int tx) {
  static_assert(L::TM == 4, "one float4 of rows per thread");
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const unsigned b = (unsigned)(st.bin[kk][tx] - b0);
    if (b < (unsigned)nb) {
      const float4 v = *reinterpret_cast<const float4*>(&st.xs[kk][ty * 4]);
      float* s = bins + b * (PAS_TM * THREADS) + threadIdx.x;
      s[0] += v.x;
      s[THREADS] += v.y;
      s[2 * THREADS] += v.z;
      s[3 * THREADS] += v.w;
    }
  }
}

// Post-pass of one pass: y += S[b] * cb[b0 + b] for b = 0 .. nb - 1.
__device__ __forceinline__ void pas_postpass(const float* bins,
                                             const float* cb_s, int b0, int nb,
                                             float (&y)[PAS_TM][1]) {
  for (int b = 0; b < nb; ++b) {
    const float c = cb_s[b0 + b];
    const float* s = bins + b * (PAS_TM * THREADS) + threadIdx.x;
#pragma unroll
    for (int i = 0; i < PAS_TM; ++i) y[i][0] = fmaf(s[i * THREADS], c, y[i][0]);
  }
}

}  // namespace pasm
