// Shared device code of the two PAS kernels (K3 pas_matmul.cu, K4
// pas_conv.cu): the paper's two-phase PASM (§2.2) on SIMT, one device body
// (pas_block) whose only difference between the two is the loader of the
// activation / patch stage.
//
//   PAS phase   S[m, n, b] += x[m, k]      for b = idx[k, n]   (adds only)
//   post-pass   y[m, n] = sum_b S[m, n, b] * cb[b]             (B FMAs)
//
// then bias / ReLU / window max.
//
// Layout: lanes over rows, warps over columns, bins in registers.  A warp
// owns one column and 128 consecutive rows, a lane 4 of them.  All lanes of
// a warp share idx[k, n], so the bin a k feeds is the same in every lane,
// and the accumulators S[b][i] (16 bins x 4 rows) are registers, each named
// by a compile-time index.
//
// The walk (pas_stage, pas_walk): a stage holds 32 k rows, one index per
// lane.  For each bin b, in order, __ballot_sync gives the mask of the
// stage's rows in b, and the warp walks its set bits upward, adding each
// row's float4 of x (shared memory, k-major) into S[b]: one 16-byte read
// and 4 adds per lane and k, and no branch on the bin; the next row's read
// is issued before the current row's adds.  (A switch on the
// uniform bin compiles to a tree of taken branches per k and measured
// slower than the shared-memory bins it was to replace.)  Each bin stays a
// sequential f32 sum in increasing k.
//
// Tiles: a block is 16 warps (512 threads, 128 registers: one block an SM).
// They stand 1 x 16 (128 rows x 16 columns) or, when a pool window holds
// more than 128 rows (pool 12, 16), 2 x 8 (256 x 8); a block owns the whole
// windows that fit (rows = tile - tile % pool^2).  One kernel instance
// serves both: the warp grid is a runtime argument.  The next stage's x and
// index bytes are loaded into registers before the warps add the current
// one and stored to the other slot of a two-slot ring after, so one stage
// of adds covers their latency.  Bins: PAS_BINS = 16 per pass; B <= 16
// takes one pass, B = 256 walks K 16 times, each pass adding only the
// indices in its bins (stored pass-relative; 255 = no add) and folding
// them into the post-pass in bin order.  An index >= B falls in no pass:
// the one-hot of the JAX reference maps it to a zero row.
//
// Order of the sums: each bin is a sequential f32 sum in increasing k, the
// post-pass an fmaf chain in ascending b, as in the shared-memory design
// this replaced; without split-K the output is the same bitwise.  With
// split-K (a count fixed by K and N, pas_plan in pas_histogram.py) each
// split runs its own bins and post-pass over a K range, writes its partial
// y to scratch, and split_sum (pasm_common.cuh) adds the partials in split
// order, then the epilogue: no float atomics, and a row's result never
// depends on M.
//
// What bounds it: the walk's shared-memory reads (one 16-byte read a lane
// per 4 adds: at most 32 adds an SM clock) and its issue (11 instructions a
// warp per k, a chain of 3 dependent integer operations on the mask per
// row, 4 warps a scheduler to cover it), then the stage loads, which share
// the load/store pipe with the walk, so issuing them earlier does not hide
// them (kernels/ablation.py times each part; PERF.md has the numbers).
// K4's gather issues 4-byte loads where K3 issues 16-byte ones.
#pragma once

#include "pasm_common.cuh"

namespace pasm {

constexpr int PAS_TM = 4;              // consecutive rows per lane
constexpr int PAS_THREADS = 512;       // threads per block: 16 warps
constexpr int PAS_BINS = 16;           // bins per pass (accumulators per lane)
constexpr int PAS_BK = 32;             // k rows per stage: one per lane
constexpr int PAS_WARPS = PAS_THREADS / 32;
constexpr int PAS_WARP_ROWS = 32 * PAS_TM;  // 128
constexpr int PAS_MAX_ROWS = 256;  // the tallest tile: every admitted window
constexpr uint8_t PAS_NO_BIN = 255;  // bin stage: add nothing
// GEMM rows are ints in the kernels: M stays below 2^31 by a tile
constexpr long long PAS_MAX_M = 0x7fffffffLL - PAS_MAX_ROWS;

static_assert(PAS_MAX_ROWS == 2 * PAS_WARP_ROWS, "two warp grids");
static_assert(PAS_WARPS == 16, "the copy mappings: 16 warps");
static_assert(2 * PAS_BK * (PAS_WARP_ROWS + 4) >= PAS_WARPS * PAS_WARP_ROWS,
              "the pool tile fits the x ring");

// Static shared memory; the x ring is dynamic (pas_dyn_smem_bytes).
struct PasSmem {
  uint8_t bins[2][PAS_WARPS][PAS_BK];  // [slot][column][31 - k]
  float cb[256];
};

// The x ring: 2 slots of PAS_BK rows of (tile + 4) floats, k-major.  The
// epilogue's pool tile reuses it.
__host__ __device__ inline int pas_ld(int tile) { return tile + 4; }
__host__ __device__ inline int pas_cols(int tile) {
  return PAS_WARPS * PAS_WARP_ROWS / tile;
}
inline size_t pas_dyn_smem_bytes(int tile) {
  return (size_t)2 * PAS_BK * pas_ld(tile) * sizeof(float);
}

using PasAcc = float[PAS_BINS][PAS_TM];

// One block's place: warp grid, tile origin, K range.
struct PasTile {
  int wn, wm;       // this warp's column and row group
  int tile, bn;     // block rows x columns
  int rows;         // GEMM rows the block owns (whole windows)
  int m0;           // first GEMM row (M < 2^31: the launchers check)
  int n0;           // first column
  int kb, ke;       // reduction rows [kb, ke) of this split
  int ld;           // x-stage row stride
};

__device__ __forceinline__ PasTile pas_tile(int tile, int pool, int K, int N,
                                            int splits, int block) {
  PasTile t;
  const int wn_n = PAS_WARPS / (tile / PAS_WARP_ROWS);
  const int warp = threadIdx.x / 32;
  t.wn = warp % wn_n;
  t.wm = warp / wn_n;
  t.tile = tile;
  t.bn = wn_n;
  t.rows = tile - tile % (pool * pool);
  t.ld = pas_ld(tile);
  const int cols = (N + t.bn - 1) / t.bn;
  const int col = block % cols;
  const int split = (block / cols) % splits;
  t.m0 = (block / cols / splits) * t.rows;
  t.n0 = col * t.bn;
  const int stages = (K + PAS_BK - 1) / PAS_BK;
  const int per = (stages + splits - 1) / splits * PAS_BK;
  t.kb = min(K, split * per);
  t.ke = min(K, t.kb + per);
  return t;
}

// The x ring has two slots: the warps walk stage s in one while the next
// stage is loaded into registers (fetch, before the walk) and stored k-major
// into the other slot (put, after it), so the adds cover the loads'
// latency.  A loader covers 128 rows a round; the second round of a 256-row
// tile (pool 12, 16) fetches and puts at once (pas_block).  (4-byte
// cp.async copies queue in the load/store unit; 16-byte ones into a
// row-major staging ring, turned k-major in shared memory, add traffic; a
// second register set to load two walks ahead gains nothing: all measured
// no faster.)
constexpr int PAS_ROUND = PAS_WARP_ROWS;

// K3's stage: x (M, K) row-major, rows [m0, m0 + rows) x k0 + [0, PAS_BK),
// in chunks of 4 k of one row: one 16-byte load where x allows (K % 4 == 0
// and 16-byte aligned: a chunk is then all in or all out), else four 4-byte
// loads.  A warp instruction covers 16 rows x 2 chunks: 16 sectors of x,
// and its 4-byte shared stores fall in 32 distinct banks (ld = 4 mod 32).
constexpr int PAS_K3_CHUNKS = PAS_ROUND * (PAS_BK / 4) / PAS_THREADS;

struct MatmulLoader {
  const float* __restrict__ x;
  int M, K;
  bool vec;
  int k0;
  float4 v[PAS_K3_CHUNKS];

  // chunk j of this thread in a round: tile row r, k offset 4 kq
  __device__ __forceinline__ void place(int round, int j, int& r,
                                        int& kq) const {
    const int g = threadIdx.x / 32 + PAS_WARPS * j;
    r = PAS_ROUND * round + 16 * (g % (PAS_ROUND / 16)) + threadIdx.x % 16;
    kq = 2 * (g / (PAS_ROUND / 16)) + (threadIdx.x % 32) / 16;
  }
  __device__ __forceinline__ void fetch(const PasTile& t, int round) {
#pragma unroll
    for (int j = 0; j < PAS_K3_CHUNKS; ++j) {
      int r, kq;
      place(round, j, r, kq);
      const int m = t.m0 + r;
      const int k = k0 + 4 * kq;
      const float* p = x + (size_t)m * K + k;
      const bool row = r < t.rows && m < M;
      float4& d = v[j];
      d = make_float4(0.f, 0.f, 0.f, 0.f);
      if (vec) {
        if (row && k < t.ke) d = __ldg(reinterpret_cast<const float4*>(p));
      } else if (row) {
        if (k < t.ke) d.x = __ldg(p);
        if (k + 1 < t.ke) d.y = __ldg(p + 1);
        if (k + 2 < t.ke) d.z = __ldg(p + 2);
        if (k + 3 < t.ke) d.w = __ldg(p + 3);
      }
    }
  }
  __device__ __forceinline__ void put(float* xs, const PasTile& t,
                                      int round) const {
#pragma unroll
    for (int j = 0; j < PAS_K3_CHUNKS; ++j) {
      int r, kq;
      place(round, j, r, kq);
      float* d = xs + 4 * kq * t.ld + r;
      d[0] = v[j].x;
      d[t.ld] = v[j].y;
      d[2 * t.ld] = v[j].z;
      d[3 * t.ld] = v[j].w;
    }
  }
};

// K4's stage: the patch rows gathered from the unpadded images (window-
// major rows, masked spatial pad, 0 at q >= conv_k).  The rows run over the
// whole batch, image after image, as K3's rows do, so a block is full
// whatever the image size.  A warp loads one k of 32 consecutive rows an
// instruction: neighbouring output pixels read neighbouring input pixels,
// and the shared stores are conflict-free.  The warp's lanes decode its
// PAS_K4_KS k at once (lane a: the a-th) and hand them round by shuffles;
// each row is one 8-byte shared read (pas_conv_rows).  Pixel coordinates
// travel as 16-bit halves; an image whose coordinates need more (WIDE)
// takes 16-byte row records and a second shuffle.
constexpr int PAS_K4_KS = PAS_BK / PAS_WARPS;      // k rows per warp
constexpr int PAS_K4_RS = PAS_ROUND / 32;          // rows per lane a round

// per tile row: {iy0 & 0xffff | ix0 << 16, image}, or (WIDE) {iy0, ix0,
// image, 0}
template <bool WIDE>
struct PasRow {
  using T = int2;
};
template <>
struct PasRow<true> {
  using T = int4;
};

template <bool WIDE>
struct ConvLoader {
  using Row = typename PasRow<WIDE>::T;
  const float* __restrict__ x;
  const Row* rows;  // shared: per tile row
  int conv_k, nhwc, C, H, W, ky, kx;
  int k0;
  float v[PAS_K4_KS][PAS_K4_RS];

  __device__ __forceinline__ void fetch(const PasTile& t, int round) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    // lane a < PAS_K4_KS decodes k0 + warp + PAS_WARPS a: the offset of
    // its channel and its (dy, dx), packed; out of range: dy far off
    const int q = k0 + warp + PAS_WARPS * (lane % PAS_K4_KS);
    int koff = 0, dydx = (int)0x80008000, dyw = -(1 << 29);
    if (q < conv_k && q < t.ke) {
      int c, dy, dx;
      if (nhwc) {
        dy = q / (kx * C);
        dx = (q / C) % kx;
        c = q % C;
      } else {
        c = q / (ky * kx);
        dy = (q / kx) % ky;
        dx = q % kx;
      }
      koff = nhwc ? c : c * H * W;
      if constexpr (WIDE) {
        dyw = dy;
        dydx = dx;
      } else {
        dydx = (int)(((unsigned)dy & 0xffffu) | ((unsigned)dx << 16));
      }
    }
    const size_t chw = (size_t)C * H * W;
    Row rw[PAS_K4_RS];
#pragma unroll
    for (int i = 0; i < PAS_K4_RS; ++i) rw[i] = rows[PAS_ROUND * round + lane + 32 * i];
#pragma unroll
    for (int a = 0; a < PAS_K4_KS; ++a) {
      const int ko = __shfl_sync(0xffffffffu, koff, a);
      const int dd = __shfl_sync(0xffffffffu, dydx, a);
      int dy, dx;
      if constexpr (WIDE) {
        dy = __shfl_sync(0xffffffffu, dyw, a);
        dx = dd;
      } else {
        dy = (short)(dd & 0xffff);
        dx = dd >> 16;
      }
#pragma unroll
      for (int i = 0; i < PAS_K4_RS; ++i) {
        int iy, ix;
        if constexpr (WIDE) {
          iy = rw[i].x + dy;
          ix = rw[i].y + dx;
        } else {
          iy = (short)(rw[i].x & 0xffff) + dy;
          ix = (rw[i].x >> 16) + dx;
        }
        v[a][i] = 0.f;
        if ((unsigned)iy < (unsigned)H && (unsigned)ix < (unsigned)W) {
          const size_t off = nhwc ? (size_t)(iy * W + ix) * C + ko
                                  : (size_t)ko + iy * W + ix;
          int img;
          if constexpr (WIDE)
            img = rw[i].z;
          else
            img = rw[i].y;
          v[a][i] = __ldg(x + (size_t)img * chw + off);
        }
      }
    }
  }
  __device__ __forceinline__ void put(float* xs, const PasTile& t,
                                      int round) const {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int a = 0; a < PAS_K4_KS; ++a)
#pragma unroll
      for (int i = 0; i < PAS_K4_RS; ++i)
        xs[(warp + PAS_WARPS * a) * t.ld + PAS_ROUND * round + lane + 32 * i] =
            v[a][i];
  }
};

// Top-left input pixel and image of each of the block's tile rows (global
// rows m0 + r over the batch), as PasRow<WIDE>; rows past the block's or
// past M are off every image (iy0 = -32768, or -2^29 when WIDE).
template <bool WIDE>
__device__ __forceinline__ void pas_conv_rows(typename PasRow<WIDE>::T* rows,
                                              const PasTile& t, int M,
                                              int P_rows, int pool, int ow,
                                              int stride, int pad_h,
                                              int pad_w) {
  const int pw = pool * pool, owp = ow / pool;
  for (int r = threadIdx.x; r < PAS_MAX_ROWS; r += PAS_THREADS) {
    const int m = t.m0 + r;
    const bool in = r < t.rows && m < M;
    int iy = -(1 << 29), ix = 0, img = 0;
    if (in) {
      const int p = (int)(m % P_rows);
      const int pp = p / pw, s = p % pw;
      iy = ((pp / owp) * pool + s / pool) * stride - pad_h;
      ix = ((pp % owp) * pool + s % pool) * stride - pad_w;
      img = (int)(m / P_rows);
    }
    if constexpr (WIDE)
      rows[r] = make_int4(iy, ix, img, 0);
    else
      rows[r] = in ? make_int2((int)(((unsigned)iy & 0xffffu) | ((unsigned)ix << 16)), img)
                   : make_int2(0x8000, 0);
  }
}

// The bin stage of rows [k0, k0 + PAS_BK) x the block's columns: this
// thread's elements e = tid + PAS_THREADS j (k = e / PAS_WARPS, column
// e % PAS_WARPS).  pas_load_bins only issues the loads: the bytes are first
// used in pas_store_bins, after the warps have added the current stage, so
// the wait for them hides behind the adds.  pas_store_bins stores each
// pass-relative, or PAS_NO_BIN past K, past N, past the block's columns, or
// outside this pass's bins.
constexpr int PAS_BIN_LOADS = PAS_BK * PAS_WARPS / PAS_THREADS;

struct PasBinRegs {
  unsigned b[PAS_BIN_LOADS];  // the index byte, or PAS_NO_BIN
};

__device__ __forceinline__ PasBinRegs pas_load_bins(
    const uint8_t* __restrict__ idx, const PasTile& t, int N, int k0) {
  PasBinRegs r;
#pragma unroll
  for (int j = 0; j < PAS_BIN_LOADS; ++j) {
    const int e = threadIdx.x + PAS_THREADS * j;
    const int k = k0 + e / PAS_WARPS, c = e % PAS_WARPS, n = t.n0 + c;
    r.b[j] = PAS_NO_BIN;
    if (c < t.bn && k < t.ke && n < N) r.b[j] = __ldg(idx + (size_t)k * N + n);
  }
  return r;
}

__device__ __forceinline__ void pas_store_bins(PasSmem& sm, int slot,
                                               const PasBinRegs& r, int b0,
                                               int nb) {
#pragma unroll
  for (int j = 0; j < PAS_BIN_LOADS; ++j) {
    const int e = threadIdx.x + PAS_THREADS * j;
    const unsigned d = r.b[j] - (unsigned)b0;
    sm.bins[slot][e % PAS_WARPS][PAS_BK - 1 - e / PAS_WARPS] =
        d < (unsigned)nb ? (uint8_t)d : PAS_NO_BIN;
  }
}

// S[b] += the rows of x in the stage mask r (bit 31 - k: row k), in
// increasing k: bfind gives f, the highest set bit (row k = 31 - f, at
// base31 - f * ldb, base31 being row 31's address), and each row's load is
// issued before the previous row's adds, so one load is always in flight
// and no row is read twice.  The loop is PTX for bra.uni: r is the same in
// every lane, and a branch the compiler cannot prove uniform costs a
// convergence barrier a bin.
__device__ __forceinline__ void pas_walk(float (&s)[PAS_TM], unsigned r,
                                         uint32_t base31, uint32_t ldb) {
  static_assert(PAS_TM == 4, "one v4 load per row");
  asm volatile(
      "{\n\t"
      ".reg .pred p;\n\t"
      ".reg .b32 f, t, a;\n\t"
      ".reg .f32 v0, v1, v2, v3, w0, w1, w2, w3;\n\t"
      "setp.eq.b32 p, %4, 0;\n\t"
      "@p bra.uni W_DONE;\n\t"
      "bfind.u32 f, %4;\n\t"
      "shl.b32 t, 1, f;\n\t"
      "xor.b32 %4, %4, t;\n\t"
      "mad.lo.u32 a, f, %6, %5;\n\t"
      "ld.shared.v4.f32 {v0, v1, v2, v3}, [a];\n\t"
      "W_LOOP:\n\t"
      "setp.eq.b32 p, %4, 0;\n\t"
      "@p bra.uni W_LASTV;\n\t"
      "bfind.u32 f, %4;\n\t"
      "shl.b32 t, 1, f;\n\t"
      "xor.b32 %4, %4, t;\n\t"
      "mad.lo.u32 a, f, %6, %5;\n\t"
      "ld.shared.v4.f32 {w0, w1, w2, w3}, [a];\n\t"
      "add.f32 %0, %0, v0;\n\t"
      "add.f32 %1, %1, v1;\n\t"
      "add.f32 %2, %2, v2;\n\t"
      "add.f32 %3, %3, v3;\n\t"
      "setp.eq.b32 p, %4, 0;\n\t"
      "@p bra.uni W_LASTW;\n\t"
      "bfind.u32 f, %4;\n\t"
      "shl.b32 t, 1, f;\n\t"
      "xor.b32 %4, %4, t;\n\t"
      "mad.lo.u32 a, f, %6, %5;\n\t"
      "ld.shared.v4.f32 {v0, v1, v2, v3}, [a];\n\t"
      "add.f32 %0, %0, w0;\n\t"
      "add.f32 %1, %1, w1;\n\t"
      "add.f32 %2, %2, w2;\n\t"
      "add.f32 %3, %3, w3;\n\t"
      "bra.uni W_LOOP;\n\t"
      "W_LASTV:\n\t"
      "add.f32 %0, %0, v0;\n\t"
      "add.f32 %1, %1, v1;\n\t"
      "add.f32 %2, %2, v2;\n\t"
      "add.f32 %3, %3, v3;\n\t"
      "bra.uni W_DONE;\n\t"
      "W_LASTW:\n\t"
      "add.f32 %0, %0, w0;\n\t"
      "add.f32 %1, %1, w1;\n\t"
      "add.f32 %2, %2, w2;\n\t"
      "add.f32 %3, %3, w3;\n\t"
      "W_DONE:\n\t"
      "}"
      : "+f"(s[0]), "+f"(s[1]), "+f"(s[2]), "+f"(s[3]), "+r"(r)
      : "r"(base31), "r"(0u - ldb));
}

// PAS phase over one stage: for each bin, the stage's rows in it, added in
// increasing k.  Lane l holds the bin of row 31 - l, so the bin's ballot is
// the mask of pas_walk.
__device__ __forceinline__ void pas_stage(const PasSmem& sm, const float* xs,
                                          int slot, const PasTile& t,
                                          PasAcc& S) {
  const int lane = threadIdx.x % 32;
  const unsigned mine = sm.bins[slot][t.wn][lane];
  const uint32_t base31 = (uint32_t)__cvta_generic_to_shared(
      xs + (PAS_BK - 1) * t.ld + t.wm * PAS_WARP_ROWS + lane * PAS_TM);
  const uint32_t ldb = (uint32_t)t.ld * sizeof(float);
#pragma unroll
  for (int b = 0; b < PAS_BINS; ++b)
    pas_walk(S[b], __ballot_sync(0xffffffffu, mine == (unsigned)b), base31, ldb);
}

// Stage j of the block's K range into the loader's registers (its first
// 128 rows), and the registers into x slot xs (the second round of a
// 256-row tile fetched and put at once).
template <class Loader>
__device__ __forceinline__ void pas_fetch(Loader& ld, const PasTile& t, int j) {
  ld.k0 = t.kb + j * PAS_BK;
  ld.fetch(t, 0);
}
template <class Loader>
__device__ __forceinline__ void pas_put(Loader& ld, float* xs, const PasTile& t) {
  ld.put(xs, t, 0);
  if (t.tile > PAS_ROUND) {
    ld.fetch(t, 1);
    ld.put(xs, t, 1);
  }
}

// The whole PAS phase and post-pass of one block: y[i] for the lane's rows
// and the warp's column over the split's K range.  Ends with a barrier, so
// the x ring is free for the epilogue's pool tile.
template <class Loader>
__device__ __forceinline__ void pas_block(PasSmem& sm, float* ring,
                                          Loader& ld,
                                          const uint8_t* __restrict__ idx,
                                          const PasTile& t, int N, int B,
                                          float (&y)[PAS_TM]) {
  const int slot_floats = PAS_BK * t.ld;
#pragma unroll
  for (int i = 0; i < PAS_TM; ++i) y[i] = 0.f;
  const int nst = (t.ke - t.kb + PAS_BK - 1) / PAS_BK;
  for (int b0 = 0; b0 < B; b0 += PAS_BINS) {
    const int nb = min(PAS_BINS, B - b0);
    PasAcc S;
#pragma unroll
    for (int b = 0; b < PAS_BINS; ++b)
#pragma unroll
      for (int i = 0; i < PAS_TM; ++i) S[b][i] = 0.f;
    if (nst > 0) {
      pas_fetch(ld, t, 0);
      pas_put(ld, ring, t);
      pas_store_bins(sm, 0, pas_load_bins(idx, t, N, t.kb), b0, nb);
    }
    for (int s = 0; s < nst; ++s) {
      __syncthreads();  // stage s stored; every warp is done with stage s - 1
      const int slot = s & 1;
      const bool more = s + 1 < nst;
      PasBinRegs next;
      if (more) {
        pas_fetch(ld, t, s + 1);
        next = pas_load_bins(idx, t, N, t.kb + (s + 1) * PAS_BK);
      }
      pas_stage(sm, ring + slot * slot_floats, slot, t, S);
      if (more) {
        pas_put(ld, ring + (slot ^ 1) * slot_floats, t);
        pas_store_bins(sm, slot ^ 1, next, b0, nb);
      }
    }
    __syncthreads();  // the ring is free for the next pass / the pool tile
    // post-pass: y += S[b] * cb[b0 + b], b ascending
#pragma unroll
    for (int b = 0; b < PAS_BINS; ++b) {
      if (b < nb) {
        const float c = sm.cb[b0 + b];
#pragma unroll
        for (int i = 0; i < PAS_TM; ++i) y[i] = fmaf(S[b][i], c, y[i]);
      }
    }
  }
}

// Epilogue of one block.  splits > 1: the raw partial y goes to
// part[split][m][n] (M rows) for split_sum.  Otherwise bias -> ReLU ->
// (pool > 1) the max over each pool^2 consecutive rows through a pool tile
// in the x ring -> out (row stride N; row 0 is this matrix's first output
// row; out_rows bounds it).
__device__ __forceinline__ void pas_epilogue(
    float (&y)[PAS_TM], float* ring, const PasTile& t,
    const float* __restrict__ bias, float* __restrict__ out,
    float* __restrict__ part, int M, int N, int split, int splits,
    int out_rows, int relu, int pool) {
  const int r0 = t.wm * PAS_WARP_ROWS + (threadIdx.x % 32) * PAS_TM;
  const int n = t.n0 + t.wn;
  if (splits > 1) {
#pragma unroll
    for (int i = 0; i < PAS_TM; ++i) {
      const int m = t.m0 + r0 + i;
      if (n < N && r0 + i < t.rows && m < M)
        part[((size_t)split * M + m) * N + n] = y[i];
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < PAS_TM; ++i) {
    float v = y[i];
    if (bias != nullptr && n < N) v += bias[n];
    if (relu) v = v < 0.f ? 0.f : v;  // NaN passes, as torch.clamp
    y[i] = v;
  }
  const int pw = pool * pool;
  const int out_row0 = t.m0 / pw;
  if (pool == 1) {
#pragma unroll
    for (int i = 0; i < PAS_TM; ++i) {
      const int m = out_row0 + r0 + i;
      if (n < N && r0 + i < t.rows && m < out_rows) out[(size_t)m * N + n] = y[i];
    }
    return;
  }
  float* pool_s = ring;  // the pre-pool tile, [row][column]
#pragma unroll
  for (int i = 0; i < PAS_TM; ++i) pool_s[(r0 + i) * t.bn + t.wn] = y[i];
  __syncthreads();
  const int nwin = t.rows / pw;
  for (int e = threadIdx.x; e < nwin * t.bn; e += PAS_THREADS) {
    const int w = e / t.bn, c = e % t.bn, nc = t.n0 + c;
    const int m = out_row0 + w;
    if (nc >= N || m >= out_rows) continue;
    float v = pool_s[(w * pw) * t.bn + c];
    for (int s = 1; s < pw; ++s) {  // NaN-propagating max, as torch.amax
      const float u = pool_s[(w * pw + s) * t.bn + c];
      v = (isnan(v) || u <= v) ? v : u;
    }
    out[(size_t)m * N + nc] = v;
  }
}

// Checks shared by the two C entry points: the tile is one of the two warp
// grids and holds a whole window; splits >= 1 and has scratch.
inline bool pas_args_ok(int N, int B, int pool, int tile, int splits,
                        const float* part) {
  const int pw = pool * pool;
  return N > 0 && B > 0 && B <= 256 && pool >= 1 &&
         (tile == PAS_WARP_ROWS || tile == PAS_MAX_ROWS) && pw <= tile &&
         splits >= 1 && (splits == 1 || part != nullptr);
}

// Dynamic shared memory above the default 48 KB needs the kernel's opt-in.
template <class Kernel>
inline int pas_smem_opt_in(Kernel kernel, size_t dyn, size_t stat) {
  if (dyn + stat <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
}

}  // namespace pasm
