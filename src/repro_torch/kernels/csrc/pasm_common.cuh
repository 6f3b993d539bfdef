// Shared device code of the PASM kernels (K1 pasm_matmul.cu, K2
// pasm_conv.cu) and the pieces the PAS kernels (K3 pas_matmul.cu, K4
// pas_conv.cu) take from them: codebook staging and the split-K second pass.
//
// K1 and K2 are one f32 SIMT GEMM body (simt_gemm) that differs only in the
// loader of the activation stage: K1 copies rows of the explicit patch
// matrix, K2 gathers them from the images (SimtConvLoader).  What bounds it on
// the H100 is the f32 FMA pipe (the AlexNet stages do 45+ flops a byte), so
// the design spends as few non-FMA instructions as it can per FMA:
//
// * Tiles.  256 threads; a block owns a BM x BN output tile, BM = 128 (256
//   when a pool window holds more than 128 rows) and BN = 64, 96 or 128,
//   picked from N by the plan (pasm_matmul.py::simt_plan).  Thread (ty, tx)
//   holds rows ty + 16 i (i < BM / 16) and columns 4 tx + j (j < 4) and, for
//   BN > 64, 64 + (BN - 64) / 16 * tx + j: 8 x 8, 8 x 6 or 8 x 4
//   accumulators.  A warp is 4 ty x 8 tx.
// * The product (simt_product).  The x stage is row-major in shared memory
//   (k contiguous, rows SIMT_XLD floats apart), the weight stage k-major; per
//   4 k a thread reads one float4 of x per row and one or two vectors of
//   weights per k, all conflict-free (a warp reads 4 rows 20 words apart,
//   and 8 consecutive float4 of a weight row), so 8 x 8 costs 16 LDS.128 per
//   256 FMAs.  Each output is one fmaf chain in ascending k.
// * Stages.  SIMT_BK = 16 k a stage, a ring of SIMT_DEPTH + 1 x slots and
//   SIMT_DEPTH index slots in dynamic shared memory, each stage's copies
//   issued SIMT_DEPTH stages before its product, and one barrier a stage.  x
//   comes in 16-byte copies where K % 4 == 0 and x is 16-byte aligned, else
//   4-byte ones; the index bytes in 16-byte copies where N % 16 == 0, else
//   byte by byte.  After the barrier each stage's indices are dequantized
//   once into an f32 weight tile (two slots) through the shared codebook:
//   row k reads dictionary k / (K / G); packed bytes hold the even row in the
//   low nibble; an index past the dictionary clamps to its last entry.
//   Rows past K (or past the split's end) read 0.
// * Split-K.  The plan's split count depends on K and N only.  A split runs
//   its K range as above and stores its raw sums to a scratch; split_sum
//   adds the partials in split order, then bias, ReLU and the window max.
// * Epilogue.  bias, then ReLU, then with pool > 1 the NaN-propagating max
//   over each pool^2 consecutive (window-major) rows through a pool tile
//   that reuses the ring.  A block owns whole windows (rows = BM - BM %
//   pool^2).
//
// Without split-K every output is the same fmaf chain from 0 in ascending
// k, then the same epilogue, as in the 64 x 64 design this replaced, so the
// outputs are the same bitwise; K1 and K2 feed the same values into the
// same chain, so K1 == K2 bitwise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pasm {

constexpr int THREADS = 256;

__device__ __forceinline__ void load_codebook(float* cb_s, const float* cb,
                                              int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) cb_s[i] = cb[i];
}

// ---------------------------------------------------------------------------
// cp.async
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies; src_bytes = 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// the SIMT GEMM body of K1 and K2
// ---------------------------------------------------------------------------

constexpr int SIMT_BK = 16;              // k rows a stage
constexpr int SIMT_XLD = SIMT_BK + 4;    // floats between two x rows
static_assert(SIMT_BK % 16 == 0 && SIMT_XLD % 8 == 4, "the loaders' mapping");
constexpr int SIMT_DEPTH = 3;            // stages in the ring
constexpr int SIMT_XSLOTS = SIMT_DEPTH + 1;
constexpr int SIMT_ISLOTS = SIMT_DEPTH;
constexpr int SIMT_TAB_MAX = 4096;       // K2's column table, entries
constexpr int OFF_IMAGE = -(1 << 29);    // a row origin out of every image

template <int BM_, int BN_>
struct Simt {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int TM = BM / 16;          // rows a thread
  static constexpr int TN1 = (BN - 64) / 16;  // columns in the second half
  static constexpr int TN = 4 + TN1;          // columns a thread
  static constexpr int RG = BM / 64;          // loader row groups
  static constexpr int X_SLOT = BM * SIMT_XLD;   // floats
  static constexpr int W_SLOT = SIMT_BK * BN;    // floats
  static constexpr int I_SLOT = SIMT_BK * BN;    // bytes
  static constexpr int PLD = BN + 4;             // pool tile row stride
  static constexpr size_t RING =
      (size_t)(SIMT_XSLOTS * X_SLOT + 2 * W_SLOT) * sizeof(float) +
      (size_t)SIMT_ISLOTS * I_SLOT;
  static constexpr size_t POOL = (size_t)BM * PLD * sizeof(float);
  static constexpr size_t AREA = RING > POOL ? RING : POOL;
  static constexpr int MIN_BLOCKS = BM == 128 ? 2 : 1;  // a block's 128 / 255 registers
  static_assert(BN == 64 || BN == 96 || BN == 128, "column tiles");
  static_assert(BM == 128 || (BM == 256 && BN == 64), "row tiles");
  static_assert(AREA % 16 == 0, "the codebook after the ring stays aligned");
};

// Dynamic shared memory: the ring (or the pool tile), the codebook, and
// for K2 the row and column tables.
template <class S>
inline size_t simt_smem_bytes(int G, int B, int tab) {
  size_t cb = ((size_t)G * B * sizeof(float) + 15) / 16 * 16;
  return S::AREA + cb + (tab ? (size_t)S::BM * sizeof(int4) + (size_t)tab * sizeof(int2) : 0);
}

// One block's place: output rows, columns and the split's K range.  The
// split of K into stages depends on K and splits only.
struct SimtTile {
  long long m0;  // first GEMM row
  int rows;      // GEMM rows the block owns (whole windows)
  int n0;        // first column
  int split;
  int kb, ke;    // reduction rows [kb, ke)
  int nst;       // stages of SIMT_BK rows
};

__device__ __forceinline__ SimtTile simt_tile(int bm, int bn, int pool, int K,
                                              int N, int splits) {
  SimtTile t;
  const int cols = (N + bn - 1) / bn;
  const unsigned b = blockIdx.x;
  t.n0 = (int)(b % cols) * bn;
  t.split = (int)(b / cols % splits);
  t.rows = bm - bm % (pool * pool);
  t.m0 = (long long)(b / cols / splits) * t.rows;
  const int stages = (K + SIMT_BK - 1) / SIMT_BK;
  const int per = (stages + splits - 1) / splits * SIMT_BK;
  t.kb = min(K, t.split * per);
  t.ke = min(K, t.kb + per);
  t.nst = (t.ke - t.kb + SIMT_BK - 1) / SIMT_BK;
  return t;
}

// A loader's share of a stage: thread row lrow + 64 rg (rg < RG), and
// reduction offsets lk + 4 q (4-byte copies) or 16 h + 4 lk .. + 3
// (16-byte): a warp covers 8 rows x 16 bytes an instruction, conflict-free
// in rows SIMT_XLD = 4 mod 8 words apart.
__device__ __forceinline__ int simt_lrow() {
  return (threadIdx.x / 32) * 8 + threadIdx.x % 8;
}
__device__ __forceinline__ int simt_lk() { return (threadIdx.x % 32) / 8; }

// K1's loader: rows [m0, m0 + rows) of the row-major x (M, K).
template <class S>
struct SimtMatLoader {
  const float* __restrict__ x;
  long long M;
  int K;
  bool vec;  // K % 4 == 0 and x 16-byte aligned: a chunk is all in or out

  __device__ __forceinline__ void refill(const SimtTile&, int) {}  // no table
  __device__ __forceinline__ void issue(float* xs, const SimtTile& t,
                                        int k0) const {
    const int lrow = simt_lrow(), lk = simt_lk();
#pragma unroll
    for (int rg = 0; rg < S::RG; ++rg) {
      const int r = lrow + 64 * rg;
      const long long m = t.m0 + r;
      const bool row = r < t.rows && m < M;
      const float* src = x + m * K;
      float* dst = xs + r * SIMT_XLD;
      if (vec) {
#pragma unroll
        for (int h = 0; h < SIMT_BK / 16; ++h) {
          const int k = k0 + 16 * h + 4 * lk;
          const bool in = row && k < t.ke;
          cp_async16(dst + 16 * h + 4 * lk, in ? src + k : x, in ? 16 : 0);
        }
      } else {
#pragma unroll
        for (int q = 0; q < SIMT_BK / 4; ++q) {
          const int k = k0 + lk + 4 * q;
          const bool in = row && k < t.ke;
          cp_async4(dst + lk + 4 * q, in ? src + k : x, in ? 4 : 0);
        }
      }
    }
  }
};

// K2's loader: the patch rows gathered from the unpadded images.  GEMM row
// m is offset s = p % pool^2 of pooled pixel p / pool^2 (window-major),
// p = m % P_rows, of image m / P_rows: the rows run over the whole batch.
// Column q is (c, dy, dx) in (c, ky, kx) order (NCHW) or (ky, kx, c)
// (NHWC).  Per block, the row table holds each tile row's image offset and
// top-left input pixel, and the column table each column's offset in an
// image and its (dy, dx), so an element is an add and a bounds test: a
// masked 4-byte cp.async.  The spatial zero pad, rows past the block or M,
// and columns at or past conv_k (the pack-time K pad) or the split's end
// read 0.
struct SimtConvGeom {
  int C, H, W, nhwc, ky, kx, stride, pad_h, pad_w, ow, pool, P_rows, conv_k;
};

// K2's tables: the rows of this block, and the columns [tab0, tab0 + n).
template <class S>
__device__ __forceinline__ void simt_conv_rows(int4* rowtab, const SimtTile& t,
                                               long long M,
                                               const SimtConvGeom& g) {
  const int pw = g.pool * g.pool, owp = g.ow / g.pool;
  const long long chw = (long long)g.C * g.H * g.W;
  for (int r = threadIdx.x; r < S::BM; r += THREADS) {
    const long long m = t.m0 + r;
    int4 rw = make_int4(0, 0, OFF_IMAGE, 0);
    if (r < t.rows && m < M) {
      const long long img = m / g.P_rows;
      const int p = (int)(m - img * g.P_rows);
      const int pp = p / pw, s = p % pw;
      const int iy = ((pp / owp) * g.pool + s / g.pool) * g.stride - g.pad_h;
      const int ix = ((pp % owp) * g.pool + s % g.pool) * g.stride - g.pad_w;
      const long long pix = (long long)iy * g.W + ix;
      const long long off = img * chw + (g.nhwc ? pix * g.C : pix);
      rw = make_int4((int)(unsigned)(unsigned long long)off,
                     (int)(unsigned)((unsigned long long)off >> 32), iy, ix);
    }
    rowtab[r] = rw;
  }
}

__device__ __forceinline__ void simt_conv_cols(int2* coltab, int tab0, int n,
                                               const SimtConvGeom& g) {
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int q = tab0 + i;
    int2 e = make_int2(0, 0);
    if (q < g.conv_k) {
      int c, dy, dx;
      if (g.nhwc) {
        dy = q / (g.kx * g.C);
        dx = (q / g.C) % g.kx;
        c = q % g.C;
        e.x = (dy * g.W + dx) * g.C + c;
      } else {
        c = q / (g.ky * g.kx);
        dy = (q / g.kx) % g.ky;
        dx = q % g.kx;
        e.x = c * g.H * g.W + dy * g.W + dx;
      }
      e.y = (dy << 16) | dx;
    }
    coltab[i] = e;
  }
}

template <class S>
struct SimtConvLoader {
  const float* __restrict__ x;
  const int4* rowtab;  // per tile row: {offset lo, offset hi, iy0, ix0}
  int2* coltab;        // per column from tab0: {offset, dy << 16 | dx}
  SimtConvGeom g;
  int tabn;            // columns the table holds: a whole number of stages
  int tab0;            // the first column of the table
  int kvalid;          // min(the split's end, conv_k)

  // Before stage s is issued: when its columns lie past the table, the
  // table moves to start at them (every thread has issued the stages
  // before s: the caller is past a barrier).  Only K ranges of more than
  // SIMT_TAB_MAX columns get here.
  __device__ __forceinline__ void refill(const SimtTile& t, int s) {
    const int k0 = t.kb + s * SIMT_BK;
    if (s < t.nst && k0 >= tab0 + tabn) {
      tab0 = k0;
      simt_conv_cols(coltab, tab0, tabn, g);
      __syncthreads();
    }
  }

  __device__ __forceinline__ void issue(float* xs, const SimtTile& t,
                                        int k0) const {
    const int lrow = simt_lrow(), lk = simt_lk();
    int2 col[SIMT_BK / 4];
#pragma unroll
    for (int q = 0; q < SIMT_BK / 4; ++q) col[q] = coltab[k0 + lk + 4 * q - tab0];
#pragma unroll
    for (int rg = 0; rg < S::RG; ++rg) {
      const int r = lrow + 64 * rg;
      const int4 rw = rowtab[r];
      const long long roff =
          (long long)(((unsigned long long)(unsigned)rw.y << 32) | (unsigned)rw.x);
      float* dst = xs + r * SIMT_XLD;
#pragma unroll
      for (int q = 0; q < SIMT_BK / 4; ++q) {
        const int k = k0 + lk + 4 * q;
        const int iy = rw.z + (col[q].y >> 16), ix = rw.w + (col[q].y & 0xffff);
        const bool in = k < kvalid && (unsigned)iy < (unsigned)g.H &&
                        (unsigned)ix < (unsigned)g.W;
        cp_async4(dst + lk + 4 * q, in ? x + roff + col[q].x : x, in ? 4 : 0);
      }
    }
  }
};

// The index bytes of stage rows [k0, k0 + SIMT_BK) (packed: half as many
// byte rows) x the block's columns, into an index slot (row stride BN).
template <class S>
__device__ __forceinline__ void simt_issue_idx(uint8_t* is,
                                               const uint8_t* __restrict__ idx,
                                               const SimtTile& t, int k0,
                                               int N, int packed, bool vec) {
  const int nrows = packed ? SIMT_BK / 2 : SIMT_BK;
  const int r0 = packed ? k0 / 2 : k0;
  const int rend = packed ? (t.ke + 1) / 2 : t.ke;
  if (vec) {  // N % 16 == 0: a 16-byte chunk is all in or all out
    for (int e = threadIdx.x; e < nrows * (S::BN / 16); e += THREADS) {
      const int r = e / (S::BN / 16), c = 16 * (e % (S::BN / 16));
      const int kr = r0 + r, n = t.n0 + c;
      const bool in = kr < rend && n < N;
      cp_async16(is + r * S::BN + c, in ? idx + (long long)kr * N + n : idx,
                 in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * S::BN; e += THREADS) {
      const int r = e / S::BN, c = e % S::BN;
      const int kr = r0 + r, n = t.n0 + c;
      is[r * S::BN + c] = kr < rend && n < N ? idx[(long long)kr * N + n] : 0;
    }
  }
}

// Dequantize an index slot into a weight slot: w[r][c] = cb[k / gs][idx]
// (clamped to the dictionary), 0 at rows past the split's end.  A thread
// converts 4 columns at a time: one 32-bit read, four codebook reads, one
// float4 store.
template <class S>
__device__ __forceinline__ void simt_dequant(float* ws, const uint8_t* is,
                                             const float* cb_s, int k0, int ke,
                                             int gs, int G, int B,
                                             int packed) {
  constexpr int Q = S::BN / 4;
  for (int e = threadIdx.x; e < SIMT_BK * Q; e += THREADS) {
    const int r = e / Q, c = 4 * (e % Q);
    const int k = k0 + r;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k < ke) {
      uint32_t b = *reinterpret_cast<const uint32_t*>(
          is + (packed ? r / 2 : r) * S::BN + c);
      if (packed) b = ((r & 1) ? b >> 4 : b) & 0x0f0f0f0fu;
      const float* row = cb_s + (G > 1 ? (k / gs) * B : 0);
      const unsigned last = (unsigned)B - 1;
      w.x = row[min(b & 0xffu, last)];
      w.y = row[min((b >> 8) & 0xffu, last)];
      w.z = row[min((b >> 16) & 0xffu, last)];
      w.w = row[min(b >> 24, last)];
    }
    *reinterpret_cast<float4*>(ws + r * S::BN + c) = w;
  }
}

// Which outputs a thread owns (see the top of this file).
__device__ __forceinline__ int simt_ty() {
  return 4 * (threadIdx.x / 64) + (threadIdx.x % 32) / 8;
}
__device__ __forceinline__ int simt_tx() {
  return 8 * ((threadIdx.x / 32) % 2) + threadIdx.x % 8;
}
template <class S>
__device__ __forceinline__ int simt_col(int tx, int j) {
  return j < 4 ? 4 * tx + j : 64 + S::TN1 * tx + (j - 4);
}

// acc += xs . ws over one stage: f32 FMA, each output one chain in k.
template <class S>
__device__ __forceinline__ void simt_product(const float* xs, const float* ws,
                                             float (&acc)[S::TM][S::TN],
                                             int ty, int tx) {
#pragma unroll
  for (int kq = 0; kq < SIMT_BK / 4; ++kq) {
    float4 a[S::TM];
#pragma unroll
    for (int i = 0; i < S::TM; ++i)
      a[i] = *reinterpret_cast<const float4*>(xs + (ty + 16 * i) * SIMT_XLD +
                                              4 * kq);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wr = ws + (4 * kq + kk) * S::BN;
      float b[S::TN];
      const float4 b0 = *reinterpret_cast<const float4*>(wr + 4 * tx);
      b[0] = b0.x;
      b[1] = b0.y;
      b[2] = b0.z;
      b[3] = b0.w;
      if constexpr (S::TN1 == 4) {
        const float4 b1 = *reinterpret_cast<const float4*>(wr + 64 + 4 * tx);
        b[4] = b1.x;
        b[5] = b1.y;
        b[6] = b1.z;
        b[7] = b1.w;
      } else if constexpr (S::TN1 == 2) {
        const float2 b1 = *reinterpret_cast<const float2*>(wr + 64 + 2 * tx);
        b[4] = b1.x;
        b[5] = b1.y;
      }
#pragma unroll
      for (int i = 0; i < S::TM; ++i) {
        const float av =
            kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int j = 0; j < S::TN; ++j) acc[i][j] = fmaf(av, b[j], acc[i][j]);
      }
    }
  }
}

// The whole K loop of one block over its split: the stage ring, the
// dequant and the product.  The caller has staged the codebook (and K2's
// tables) before it; it ends with the ring free for the pool tile.
template <class S, class Loader>
__device__ __forceinline__ void simt_gemm(uint8_t* smem, const float* cb_s,
                                          Loader& ld,
                                          const uint8_t* __restrict__ idx,
                                          const SimtTile& t, int K, int N,
                                          int G, int B, int packed,
                                          float (&acc)[S::TM][S::TN], int ty,
                                          int tx) {
  float* xs = reinterpret_cast<float*>(smem);  // [XSLOTS][BM][XLD]
  float* ws = xs + SIMT_XSLOTS * S::X_SLOT;    // [2][BK][BN]
  uint8_t* is = reinterpret_cast<uint8_t*>(ws + 2 * S::W_SLOT);  // [ISLOTS][BK][BN]
  const int gs = K / G;
  const bool ivec =
      N % 16 == 0 && (reinterpret_cast<uintptr_t>(idx) & 15) == 0;
#pragma unroll
  for (int i = 0; i < S::TM; ++i)
#pragma unroll
    for (int j = 0; j < S::TN; ++j) acc[i][j] = 0.f;

  auto issue = [&](int s) {
    if (s < t.nst) {
      const int k0 = t.kb + s * SIMT_BK;
      ld.issue(xs + (s % SIMT_XSLOTS) * S::X_SLOT, t, k0);
      simt_issue_idx<S>(is + (s % SIMT_ISLOTS) * S::I_SLOT, idx, t, k0, N,
                        packed, ivec);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < SIMT_DEPTH; ++s) issue(s);
  cp_async_wait<SIMT_DEPTH - 1>();
  __syncthreads();  // stage 0 and the codebook visible to every thread
  if (t.nst > 0)
    simt_dequant<S>(ws, is, cb_s, t.kb, t.ke, gs, G, B, packed);
  for (int s = 0; s < t.nst; ++s) {
    cp_async_wait<SIMT_DEPTH - 2>();  // this thread's copies of stage s + 1
    __syncthreads();  // ... and every thread's; weights of s dequantized;
                      // the slots of stage s - 1 consumed
    ld.refill(t, s + SIMT_DEPTH);
    issue(s + SIMT_DEPTH);
    if (s + 1 < t.nst)
      simt_dequant<S>(ws + ((s + 1) & 1) * S::W_SLOT,
                      is + ((s + 1) % SIMT_ISLOTS) * S::I_SLOT, cb_s,
                      t.kb + (s + 1) * SIMT_BK, t.ke, gs, G, B, packed);
    simt_product<S>(xs + (s % SIMT_XSLOTS) * S::X_SLOT,
                    ws + (s & 1) * S::W_SLOT, acc, ty, tx);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the pool tile
}

// Store a thread's TN values of one output row (row pointer dst, first
// column of the block n0): float4 / float2 stores where N allows.
template <class S>
__device__ __forceinline__ void simt_store_row(float* dst, const float (&v)[S::TN],
                                               int n0, int N, int tx,
                                               bool vec) {
  const int na = n0 + 4 * tx;
  if (vec && na < N) {
    *reinterpret_cast<float4*>(dst + na) = make_float4(v[0], v[1], v[2], v[3]);
  } else if (!vec) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (na + j < N) dst[na + j] = v[j];
  }
  if constexpr (S::TN1 > 0) {
    const int nb = n0 + 64 + S::TN1 * tx;
    if (vec && nb < N) {
      if constexpr (S::TN1 == 4)
        *reinterpret_cast<float4*>(dst + nb) = make_float4(v[4], v[5], v[6], v[7]);
      else
        *reinterpret_cast<float2*>(dst + nb) = make_float2(v[4], v[5]);
    } else if (!vec) {
#pragma unroll
      for (int j = 0; j < S::TN1; ++j)
        if (nb + j < N) dst[nb + j] = v[4 + j];
    }
  }
}

// Epilogue of one block.  splits > 1: the raw sums go to part[split][m][n]
// (M rows) for split_sum.  Otherwise bias -> ReLU -> (pool > 1) the max
// over each pool^2 consecutive rows through the pool tile -> out (M /
// pool^2 rows of N).
template <class S>
__device__ __forceinline__ void simt_epilogue(
    float (&acc)[S::TM][S::TN], uint8_t* smem, const float* __restrict__ bias,
    float* __restrict__ out, float* __restrict__ part, long long M, int N,
    const SimtTile& t, int splits, int relu, int pool, int ty, int tx) {
  // float4 / float2 stores need 16-byte aligned rows; the tensors are
  // allocated by the wrapper, so N % 4 == 0 suffices
  const bool vec = N % 4 == 0;
  if (splits > 1) {
    float* base = part + (long long)t.split * M * N;
#pragma unroll
    for (int i = 0; i < S::TM; ++i) {
      const int r = ty + 16 * i;
      const long long m = t.m0 + r;
      if (r < t.rows && m < M)
        simt_store_row<S>(base + m * N, acc[i], t.n0, N, tx, vec);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < S::TN; ++j) {
    const int n = t.n0 + simt_col<S>(tx, j);
    const float bj = bias != nullptr && n < N ? bias[n] : 0.f;
#pragma unroll
    for (int i = 0; i < S::TM; ++i) {
      float v = acc[i][j];
      if (bias != nullptr && n < N) v += bj;
      if (relu) v = v < 0.f ? 0.f : v;  // NaN passes, as torch.clamp
      acc[i][j] = v;
    }
  }
  const int pw = pool * pool;
  if (pool == 1) {
#pragma unroll
    for (int i = 0; i < S::TM; ++i) {
      const int r = ty + 16 * i;
      const long long m = t.m0 + r;
      if (r < t.rows && m < M)
        simt_store_row<S>(out + m * N, acc[i], t.n0, N, tx, vec);
    }
    return;
  }
  float* pool_s = reinterpret_cast<float*>(smem);  // [BM][PLD]
#pragma unroll
  for (int i = 0; i < S::TM; ++i)
    simt_store_row<S>(pool_s + (ty + 16 * i) * S::PLD, acc[i], 0, S::BN, tx,
                      true);
  __syncthreads();
  const int nwin = t.rows / pw;
  const long long out_row0 = t.m0 / pw, out_rows = M / pw;
  for (int e = threadIdx.x; e < nwin * S::BN; e += THREADS) {
    const int w = e / S::BN, c = e % S::BN, n = t.n0 + c;
    const long long m = out_row0 + w;
    if (n >= N || m >= out_rows) continue;
    float v = pool_s[(w * pw) * S::PLD + c];
    for (int s = 1; s < pw; ++s) {  // NaN-propagating max, as torch.amax
      const float u = pool_s[(w * pw + s) * S::PLD + c];
      v = (isnan(v) || u <= v) ? v : u;
    }
    out[m * N + n] = v;
  }
}

// Checks shared by the two C entry points: the tile is one the kernels are
// built for and holds a whole window; splits >= 1 and has scratch.
inline bool simt_args_ok(int N, int G, int B, int pool, int bm, int bn,
                         int splits, const float* part) {
  const int pw = pool * pool;
  return N > 0 && G > 0 && B > 0 && pool >= 1 && pw <= bm &&
         ((bm == 128 && (bn == 64 || bn == 96 || bn == 128)) ||
          (bm == 256 && bn == 64)) &&
         splits >= 1 && (splits == 1 || part != nullptr);
}

// Dynamic shared memory above 48 KB needs the kernel's opt-in; the carveout
// hint asks for the shared memory of two blocks an SM.
template <class Kernel>
inline int simt_smem_opt_in(Kernel kernel, size_t dyn) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
}

// ---------------------------------------------------------------------------
// split-K second pass (K1, K2, K3, K4)
// ---------------------------------------------------------------------------

// y = part[0] + part[1] + ... in split order, then bias -> ReLU -> window
// max, as the kernels' epilogues.  blockIdx.y is the image (part: splits x
// M x N per image; out: M / pool^2 x N per image).
__global__ void __launch_bounds__(THREADS)
    split_sum(const float* __restrict__ part, const float* __restrict__ bias,
              float* __restrict__ out, long long M, int N, int splits,
              int relu, int pool) {
  const int pw = pool * pool;
  const long long out_rows = M / pw;
  part += (long long)blockIdx.y * splits * M * N;
  out += (long long)blockIdx.y * out_rows * N;
  for (long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
       e < out_rows * N; e += (long long)gridDim.x * THREADS) {
    const long long mo = e / N;
    const int n = (int)(e % N);
    float best = 0.f;
    for (int s = 0; s < pw; ++s) {
      const long long m = mo * pw + s;
      float v = part[m * N + n];
      for (int p = 1; p < splits; ++p) v += part[((long long)p * M + m) * N + n];
      if (bias != nullptr) v += bias[n];
      if (relu) v = v < 0.f ? 0.f : v;
      best = (s == 0 || !(isnan(best) || v <= best)) ? v : best;
    }
    out[e] = best;
  }
}

inline int split_sum_launch(const float* part, const float* bias, float* out,
                            long long M, int N, int splits, int relu, int pool,
                            int batch, cudaStream_t stream) {
  const long long n = M / (pool * pool) * N;
  const long long want = (n + THREADS - 1) / THREADS;
  dim3 grid((unsigned)(want < 4096 ? (want > 0 ? want : 1) : 4096), batch);
  split_sum<<<grid, THREADS, 0, stream>>>(part, bias, out, M, N, splits, relu,
                                          pool);
  return (int)cudaGetLastError();
}

}  // namespace pasm
