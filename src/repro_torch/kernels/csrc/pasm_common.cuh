// Shared device code of the PASM kernels (K1 pasm_matmul.cu, K2
// pasm_conv.cu) and of the PAS kernels (K3 pas_matmul.cu, K4 pas_conv.cu):
// codebook staging, the dequantized weight tile, the register tile product,
// the implicit-GEMM patch gather and the fused bias / ReLU / window-max
// epilogue.
//
// K1/K2 block shape: 256 threads as 16 x 16 (tx = column lane, ty = row
// lane).  A block owns a BM x BN output tile; thread (ty, tx) owns rows
// ty + 16 i (i < BM / 16) and columns tx + 16 j (j < 4), so shared-memory
// reads of the weight tile are conflict-free and output stores are
// coalesced.  The reduction runs in BK-row stages inside the block: the
// activation / patch tile and the dequantized weight tile of a stage sit in
// shared memory.  K3/K4 own their outputs in another layout (pas_common.cuh);
// the epilogue takes the layout as a template argument.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pasm {

constexpr int BN = 64;        // output columns per block
constexpr int BK = 16;        // reduction rows per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16
constexpr int TN = BN / 16;   // columns per thread

// Shared memory of one block: static stage tiles, plus dynamic memory
// holding the codebook (G*B floats) and, when pooling, the BM x BN
// pre-pool tile.
template <int BM>
struct Stage {
  float xs[BK][BM + 1];  // activation / patch tile, k-major (+1: fewer conflicts)
  float ws[BK][BN];      // dequantized weight tile
};

inline size_t dyn_smem_bytes(int G, int B, int bm, int pool) {
  size_t cb = ((size_t)G * B * sizeof(float) + 15) / 16 * 16;
  return cb + (pool > 1 ? (size_t)bm * BN * sizeof(float) : 0);
}

__device__ __forceinline__ void load_codebook(float* cb_s, const float* cb,
                                              int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) cb_s[i] = cb[i];
}

// Dequantize idx rows [k0, k0 + BK) x columns [n0, n0 + BN) into ws.  Row k
// reads dictionary k / gs.  Packed: byte (k / 2, n), low nibble = even row.
// Rows past K and columns past N read 0 (the ragged edges are masked here,
// not padded in memory).  An index past the dictionary clamps to its last
// entry, as the TPU kernel's gather does.
template <int BM>
__device__ __forceinline__ void load_weight_tile(
    Stage<BM>& st, const uint8_t* __restrict__ idx,
    const float* __restrict__ cb_s, int k0, int n0, int K, int N, int gs,
    int B, int packed) {
  for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
    int r = e / BN, c = e % BN;
    int k = k0 + r, n = n0 + c;
    float w = 0.f;
    if (k < K && n < N) {
      int ix;
      if (packed) {
        uint8_t b = idx[(size_t)(k >> 1) * N + n];
        ix = (k & 1) ? (b >> 4) : (b & 0xF);
      } else {
        ix = idx[(size_t)k * N + n];
      }
      w = cb_s[(k / gs) * B + min(ix, B - 1)];
    }
    st.ws[r][c] = w;
  }
}

// acc += xs^T ws over one stage: f32 FMA, no tensor cores.
template <int BM>
__device__ __forceinline__ void stage_product(const Stage<BM>& st,
                                              float (&acc)[BM / 16][TN],
                                              int ty, int tx) {
  constexpr int TM = BM / 16;
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = st.xs[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = st.ws[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Which outputs a thread owns: TM x TN of a BM x BN tile.  Thread
// (ty, tx) owns columns tx + (BN / TN) j and rows ty + (BM / TM) i
// (interleaved, K1/K2) or ty * TM + i (blocked, K3/K4).
template <int BM_, int BN_, int TM_, int TN_, bool BLOCKED_ROWS>
struct Layout {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static_assert((BM / TM) * (BN / TN) == THREADS, "one output set per thread");
  __device__ static __forceinline__ int row(int ty, int i) {
    return BLOCKED_ROWS ? ty * TM + i : ty + (BM / TM) * i;
  }
  __device__ static __forceinline__ int col(int tx, int j) {
    return tx + (BN / TN) * j;
  }
};

// K1/K2's layout for a BM-row tile.
template <int BM>
using GemmLayout = Layout<BM, BN, BM / 16, TN, false>;

// bias -> ReLU -> (pool > 1) max over each pool^2 consecutive rows, then
// store.  The block's first `rows` tile rows are its GEMM rows (whole
// windows); tile row r maps to output row out_row0 + r / pool^2 and is
// stored only below out_rows.  `out` points at row 0 of this output matrix
// (row stride N); pool_s holds L::BM x L::BN floats.
template <class L>
__device__ __forceinline__ void epilogue(
    float (&acc)[L::TM][L::TN], float* pool_s, const float* __restrict__ bias,
    float* __restrict__ out, int n0, int N, int rows, long long out_row0,
    long long out_rows, int relu, int pool, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < L::TM; ++i) {
#pragma unroll
    for (int j = 0; j < L::TN; ++j) {
      int n = n0 + L::col(tx, j);
      float v = acc[i][j];
      if (bias != nullptr && n < N) v += bias[n];
      if (relu) v = v < 0.f ? 0.f : v;  // NaN passes, as torch.clamp
      acc[i][j] = v;
    }
  }
  if (pool == 1) {
#pragma unroll
    for (int i = 0; i < L::TM; ++i) {
      int r = L::row(ty, i);
      long long m = out_row0 + r;
      if (r >= rows || m >= out_rows) continue;
#pragma unroll
      for (int j = 0; j < L::TN; ++j) {
        int n = n0 + L::col(tx, j);
        if (n < N) out[m * N + n] = acc[i][j];
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int j = 0; j < L::TN; ++j)
      pool_s[L::row(ty, i) * L::BN + L::col(tx, j)] = acc[i][j];
  __syncthreads();
  const int pw = pool * pool;
  const int nwin = rows / pw;
  for (int e = threadIdx.x; e < nwin * L::BN; e += THREADS) {
    int w = e / L::BN, c = e % L::BN, n = n0 + c;
    long long m = out_row0 + w;
    if (n >= N || m >= out_rows) continue;
    float v = pool_s[(w * pw) * L::BN + c];
    for (int s = 1; s < pw; ++s) {  // NaN-propagating max, as torch.amax
      float u = pool_s[(w * pw + s) * L::BN + c];
      v = (isnan(v) || u <= v) ? v : u;
    }
    out[m * N + n] = v;
  }
}

// ---------------------------------------------------------------------------
// implicit-GEMM patch gather (K2, K4)
// ---------------------------------------------------------------------------

constexpr int OFF_IMAGE = -(1 << 29);  // a coordinate that is out of every image

// Top-left input pixel (before the kernel offset) of each of the block's BM
// GEMM rows, with the index decode of the TPU kernel's patch_tile: row m is
// offset s = m % pool^2 of pooled pixel pp = m / pool^2 (window-major).
// Rows past the block's `rows` or past P_rows are off the image.
template <int BM>
__device__ __forceinline__ void conv_row_origins(
    int* row_iy, int* row_ix, int m0, int rows, int P_rows, int pool, int ow,
    int stride, int pad_h, int pad_w) {
  const int pw = pool * pool, owp = ow / pool;
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    int m = m0 + r;
    if (r < rows && m < P_rows) {
      int pp = m / pw, s = m % pw;
      int oy = (pp / owp) * pool + s / pool;
      int ox = (pp % owp) * pool + s % pool;
      row_iy[r] = oy * stride - pad_h;
      row_ix[r] = ox * stride - pad_w;
    } else {
      row_iy[r] = OFF_IMAGE;
      row_ix[r] = OFF_IMAGE;
    }
  }
}

// Gather reduction columns [k0, k0 + BK) of the block's BM rows into xs
// (k-major, ld floats per column).  Column q is decoded in (c, ky, kx)
// order (NCHW) or (ky, kx, c) (NHWC); positions at or past conv_k (the
// pack-time K pad) and the spatial zero-pad read 0.
template <int BM>
__device__ __forceinline__ void gather_patch_stage(
    float* xs, int ld, const float* __restrict__ img, const int* row_iy,
    const int* row_ix, int k0, int conv_k, int nhwc, int C, int H, int W,
    int ky, int kx) {
  const int kk = threadIdx.x % BK;  // this thread's column in every stage
  const int q = k0 + kk;
  int c = 0, dy = OFF_IMAGE, dx = 0;
  if (q < conv_k) {
    if (nhwc) {
      dy = q / (kx * C);
      dx = (q / C) % kx;
      c = q % C;
    } else {
      c = q / (ky * kx);
      dy = (q / kx) % ky;
      dx = q % kx;
    }
  }
  for (int r = threadIdx.x / BK; r < BM; r += THREADS / BK) {
    int iy = row_iy[r] + dy, ix = row_ix[r] + dx;
    float v = 0.f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = nhwc ? img[((size_t)iy * W + ix) * C + c]
               : img[((size_t)c * H + iy) * W + ix];
    xs[kk * ld + r] = v;
  }
}

}  // namespace pasm
