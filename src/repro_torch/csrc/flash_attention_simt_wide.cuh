// Flash attention on the CUDA cores with full fp32 products, route "wide"
// of csrc/flash_attention.cu: fp32 above a head dim of 32 and bf16 above
// kTcWideMaxDim (where no tensor-core route holds). The kernels' templates;
// flash_attention_simt_wide.cu instantiates the column tiles above 256 (as
// clusters) and dispatches, flash_attention_simt_tile.cu the one-tile
// kernels of d 33-256, each source compiled by its own nvcc.
// flash_attention.cu dispatches here, after its
// flash_bwd_preprocess_rows_kernel has written the backward's delta over
// the real d.
//
// Replaces, for those shapes, the TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (_fa_kernel), which
// takes any head dim; its backward is the port's own (FlashAttention-2's:
// dV = P^T dO, dS = P (dP - delta) with dP = dO V^T, dK = dS^T Q scale,
// dQ = dS K scale).
//
// flash_fwd_wide_kernel, flash_bwd_dkdv_wide_kernel and
// flash_bwd_dq_wide_kernel: the output's d columns in simt_wide_col_tiles(d)
// tiles of 64, 128, 192 or 256 columns (common.cuh; one tile up to d 256),
// a block a (row tile, head, batch, column tile).
// Bound: fp32 FMAs (b 8, s 256, 8/8 d 512, causal: 4.3 GFLOP forward, 0.064
// ms at the H100's 67 TFLOP/s). The design aims to keep the FMA pipe, not
// the load unit or the copies, setting the pace:
// * S once per cluster. Above 256 the tiles of one row tile launch as a
//   thread-block cluster of up to 8 (simt_wide_cluster): each block
//   computes the partial scores over its own slice of d
//   (simt_wide_slice_width), writes them to its shared memory, and after
//   the cluster barrier every block reads all the partials through
//   distributed shared memory and sums them in rank order, so every tile
//   holds the same bits of S (and dP) and hence of m, l, P and dS. Above 8
//   tiles each group of 8 is a cluster over the same slices. Up to 256
//   (kOneTile) one block holds the whole d: no partials, no cluster.
// * The X operand resident (kOneTile, and kResident above 256 where the
//   copies are element copies: simt_wide_resident): the rows that stay
//   fixed over a block's walk (Q in the forward and in dQ, K and V in
//   dK/dV) are copied over the block's slice of d into shared memory once,
//   so the steps stage only the Y operands and the Z chunks. The
//   streamed design, kStreamed, stages X with every piece; it stays above
//   256 at 16-byte copies, where it measured 0-3 % faster, and where a
//   slice is wider than a tile (d above 2048).
// * Register tiles fed by 128-bit shared loads: a thread holds 4 x 4 (or
//   2 x 4, 4 x 2) of the scores and 4 (or 2) rows by 4-16 columns of each
//   output, so every shared load instruction feeds 5-16 FMAs; the next
//   operands are loaded while the last are multiplied.
// * Staging overlapped: each 64-column piece of the Y operands (and each
//   chunk of V, K, or dO and Q rows) is copied by cp.async (16 bytes where
//   d % 4 == 0, else 4; zero-filled past the rows, the slice and d) into
//   one of three buffers while another is multiplied; bf16 pieces load 8
//   or 2 bytes and convert to fp32 once as they are stored.
// * A grid that fills the card: dK/dV blocks of 32 kv rows
//   (simt_wide_kv_tiles), and where those are fewer than one wave
//   (kSimtWideWave), the walk over a kv head's q heads split into
//   simt_wide_kv_parts parts, each block writing fp32 partial dK and dV to
//   a scratch that flash_bwd_parts_sum_kernel sums in part order. One
//   block an SM (155-228 KB of shared memory, three staging buffers).
// No atomics; 64-bit offsets throughout. A block or cluster that cannot be
// resident, or a failed attribute set or launch, is returned as an error.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {
namespace simt {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;          // 16 row groups x 16 lanes
constexpr int kKP = 2 * kSimtWidePiece;  // columns of d a staged piece
constexpr int kLP = kKP + 4;           // row stride of a piece (16-byte rows)
constexpr int kStages = 3;             // staging buffers (two in flight)
constexpr size_t kMaxSmem = 232448;    // dynamic shared memory a block (sm_90)

// How a launch's blocks share the scores, and where the X rows live:
// column tiles as clusters with X staged beside Y piece by piece, or
// resident (simt_wide_resident); one tile (d up to 256), no cluster, X
// resident.
constexpr int kStreamed = 0, kResident = 1, kOneTile = 2;

// The tiles of one kernel. The scores: an M x N tile, rows from the X
// operands (Q in the forward and dQ; K and V in dK/dV), columns from the Y
// operands (K and V; Q and dO), NP products summed over d (S; S and dP). A
// thread owns rows ty * RX + i and columns tx + 16 j of it (RX = M / 16,
// RY = N / 16). W (P, or dS; P^T and dS^T in dK/dV) goes to shared memory,
// then NZ products W Z accumulate into the thread's RX rows and columns
// tx * 4 + 64 jj + (0..3) of an output tile of TW columns, Z (V; K; dO and
// Q) streamed in chunks of KC of its rows. Every operand is held as fp32.
// Shared memory, in order: the resident X rows (NP x M rows of the slice,
// TW + 4 words apart; none in kStreamed), kStages staging buffers (a Y
// piece, with kStreamed an X piece too, or a Z chunk), W, and with a
// cluster two partials of the scores (one a step, alternating).
template <int M, int N, int NP, int NZ, int KC, int TW, int MODE>
struct Tiles {
  static constexpr int kM = M, kN = N, kNP = NP, kNZ = NZ, kKC = KC;
  static constexpr int kTW = TW, kNJ = TW / 64, kCols = 4 * kNJ;
  static constexpr int kRX = M / 16, kRY = N / 16;
  static constexpr bool kRes = MODE != kStreamed;
  static constexpr bool kCluster = MODE != kOneTile;
  static constexpr int kLW = N + 4;                 // row stride of W
  static constexpr int kChunks = N / KC;
  static constexpr int kLX = kRes ? TW + 4 : kLP;   // row stride of X
  static constexpr int kX = kRes ? NP * M * kLX : 0;
  static constexpr int kPiece = NP * ((kRes ? 0 : M) + N) * kLP;
  static constexpr int kChunk = NZ * KC * TW;
  static constexpr int kStage = kPiece > kChunk ? kPiece : kChunk;
  static constexpr int kW = NZ * M * kLW;
  static constexpr int kPart = kCluster ? kThreads * NP * kRX * kRY : 0;
  __host__ __device__ static constexpr size_t smem() {
    return sizeof(float) * (static_cast<size_t>(kX) +
                            kStages * static_cast<size_t>(kStage) + kW +
                            2 * static_cast<size_t>(kPart));
  }
};

// Rows of a (batch, rows, heads, d) tensor at one batch and head: row r at
// base + r * stride, n rows.
template <typename T>
struct Rows {
  const T* base;
  long long stride;
  int n;
};

template <typename T>
__device__ __forceinline__ Rows<T> rows_of(const T* t, int bb, int n,
                                           int heads, int h, int d) {
  return {t + (static_cast<long long>(bb) * n * heads + h) * d,
          static_cast<long long>(heads) * d, n};
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// Rows [row0, row0 + R) and columns [col0, col0 + C) of `src` into `dst`
// (row stride LD) as fp32; rows at or past src.n and columns at or past
// cend read as 0. VEC elements a copy, each copy wholly in or out (cend
// and col0 are multiples of VEC): fp32 by cp.async of 16 (VEC 4) or 4
// bytes, zero-filled, in the caller's commit group; bf16 by loads of 8 or
// 2 bytes, converted once as they are stored.
template <typename T, int VEC, int R, int C, int LD>
__device__ __forceinline__ void copy_block(float* dst, Rows<T> src,
                                           int row0, int col0, int cend) {
  constexpr int kV = C / VEC;
  constexpr int kIters = (R * kV + kThreads - 1) / kThreads;
  // element copies unrolled by 4 only: their addresses would hold registers
#pragma unroll (VEC == 4 ? kIters : 4)
  for (int it = 0; it < kIters; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    if (R * kV % kThreads != 0 && idx >= R * kV) break;
    const int r = idx / kV, c = idx % kV * VEC;
    const int row = row0 + r, col = col0 + c;
    const bool ok = row < src.n && col < cend;
    const T* p = ok ? src.base + row * src.stride + col : src.base;
    float* q = dst + r * LD + c;
    if constexpr (std::is_same<T, float>::value) {
      if constexpr (VEC == 4)
        cp_async16_zfill(q, p, ok);
      else
        cp_async4_zfill(q, p, ok);
    } else if constexpr (VEC == 4) {
      uint2 u = ok ? *reinterpret_cast<const uint2*>(p) : make_uint2(0, 0);
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<__nv_bfloat162*>(&u.x));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<__nv_bfloat162*>(&u.y));
      *reinterpret_cast<float4*>(q) = make_float4(a.x, a.y, b.x, b.y);
    } else {
      *q = ok ? __bfloat162float(*p) : 0.f;
    }
  }
}

// Four output columns from col on (all below d or none where VEC is 4).
template <typename T, int VEC>
__device__ __forceinline__ void store4(T* row, int col, int d, float a,
                                       float b, float c, float e) {
  if constexpr (VEC == 4) {
    if (col >= d) return;
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float4*>(row + col) = make_float4(a, b, c, e);
    } else {
      __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
      __nv_bfloat162 hi = __floats2bfloat162_rn(c, e);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&lo);
      u.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(row + col) = u;
    }
  } else {
    const float v[4] = {a, b, c, e};
#pragma unroll
    for (int x = 0; x < 4; ++x)
      if (col + x < d) row[col + x] = from_f32<T>(v[x]);
  }
}

// S (and dP) += X Y^T over one piece of d (its first half where `half`: a
// slice's last kSimtWidePiece columns), X from `xp` (the piece's first
// column, rows P::kLX apart) and Y from `yp` (rows kLP apart): 128-bit
// loads along d, each feeding RY (or RX) x 4 FMAs; the next four columns'
// operands are loaded while these are multiplied.
template <class P>
__device__ __forceinline__ void piece_product(
    const float* xp, const float* yp, bool half,
    float (&s)[P::kNP][P::kRX][P::kRY], int ty, int tx) {
  const float* X = xp + ty * P::kRX * P::kLX;
  const float* Y = yp + tx * kLP;
  float4 xr[2][P::kNP][P::kRX], yr[2][P::kNP][P::kRY];
  auto load = [&](float4 (&xo)[P::kNP][P::kRX],
                  float4 (&yo)[P::kNP][P::kRY], int c) {
#pragma unroll
    for (int p = 0; p < P::kNP; ++p) {
#pragma unroll
      for (int i = 0; i < P::kRX; ++i)
        xo[p][i] = *reinterpret_cast<const float4*>(
            X + p * P::kM * P::kLX + i * P::kLX + c);
#pragma unroll
      for (int j = 0; j < P::kRY; ++j)
        yo[p][j] = *reinterpret_cast<const float4*>(
            Y + p * P::kN * kLP + 16 * j * kLP + c);
    }
  };
  auto fma4 = [&](const float4 (&xo)[P::kNP][P::kRX],
                  const float4 (&yo)[P::kNP][P::kRY]) {
#pragma unroll
    for (int p = 0; p < P::kNP; ++p)
#pragma unroll
      for (int i = 0; i < P::kRX; ++i)
#pragma unroll
        for (int j = 0; j < P::kRY; ++j) {
          float a = s[p][i][j];
          a = fmaf(xo[p][i].x, yo[p][j].x, a);
          a = fmaf(xo[p][i].y, yo[p][j].y, a);
          a = fmaf(xo[p][i].z, yo[p][j].z, a);
          a = fmaf(xo[p][i].w, yo[p][j].w, a);
          s[p][i][j] = a;
        }
  };
  const int end = half ? kKP / 2 : kKP;
  load(xr[0], yr[0], 0);
#pragma unroll 1
  for (int c = 0; c < end; c += 8) {
    load(xr[1], yr[1], c + 4);
    fma4(xr[0], yr[0]);
    if (c + 8 < end) load(xr[0], yr[0], c + 8);
    fma4(xr[1], yr[1]);
  }
}

// acc[z] += W[z][:, chunk] Z[z] over one staged chunk of KC rows of Z; the
// next row's Z operands are loaded while one row is multiplied.
template <class P>
__device__ __forceinline__ void chunk_product(
    const float* st, const float* W, int chunk,
    float (&acc)[P::kNZ][P::kRX][P::kCols], int ty, int tx) {
  const float* Wt = W + ty * P::kRX * P::kLW + chunk * P::kKC;
  const float* Zt = st + tx * 4;
  float4 zr[2][P::kNZ][P::kNJ];
  auto load = [&](float4 (&zo)[P::kNZ][P::kNJ], int r) {
#pragma unroll
    for (int z = 0; z < P::kNZ; ++z)
#pragma unroll
      for (int jj = 0; jj < P::kNJ; ++jj)
        zo[z][jj] = *reinterpret_cast<const float4*>(
            Zt + z * P::kKC * P::kTW + r * P::kTW + 64 * jj);
  };
  load(zr[0], 0);
#pragma unroll 1
  for (int kk = 0; kk < P::kKC; kk += 4) {
    float4 w[P::kNZ][P::kRX];
#pragma unroll
    for (int z = 0; z < P::kNZ; ++z)
#pragma unroll
      for (int i = 0; i < P::kRX; ++i)
        w[z][i] = *reinterpret_cast<const float4*>(
            Wt + z * P::kM * P::kLW + i * P::kLW + kk);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e < 3 || kk + 4 < P::kKC) load(zr[(e + 1) & 1], kk + e + 1);
#pragma unroll
      for (int z = 0; z < P::kNZ; ++z)
#pragma unroll
        for (int jj = 0; jj < P::kNJ; ++jj) {
          const float4 zv = zr[e & 1][z][jj];
#pragma unroll
          for (int i = 0; i < P::kRX; ++i) {
            const float we = e == 0 ? w[z][i].x : e == 1 ? w[z][i].y
                           : e == 2 ? w[z][i].z : w[z][i].w;
            float* a = acc[z][i] + 4 * jj;
            a[0] = fmaf(we, zv.x, a[0]);
            a[1] = fmaf(we, zv.y, a[1]);
            a[2] = fmaf(we, zv.z, a[2]);
            a[3] = fmaf(we, zv.w, a[3]);
          }
        }
    }
  }
}

// The cluster's C partial scores summed in rank order 0..C-1: each CTA
// writes its own (over its slice of d) to `part` in a layout of its
// threads, and after the cluster barrier reads the same thread's values of
// every rank through distributed shared memory, so every CTA of the
// cluster holds the same bits of S (and dP).
template <class P>
__device__ __forceinline__ void cluster_sum(
    float* part, float (&s)[P::kNP][P::kRX][P::kRY], int cl) {
  constexpr int kQ = P::kNP * P::kRX * P::kRY / 4;
  float* f = &s[0][0][0];
  float4* mine = reinterpret_cast<float4*>(part);
#pragma unroll
  for (int e = 0; e < kQ; ++e)
    mine[e * kThreads + threadIdx.x] =
        make_float4(f[4 * e], f[4 * e + 1], f[4 * e + 2], f[4 * e + 3]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float4 tot[kQ];
  for (int r = 0; r < cl; ++r) {
    const float4* rp = cluster.map_shared_rank(mine, r);
#pragma unroll
    for (int e = 0; e < kQ; ++e) {
      const float4 x = rp[e * kThreads + threadIdx.x];
      if (r == 0) {
        tot[e] = x;
      } else {
        tot[e].x += x.x;
        tot[e].y += x.y;
        tot[e].z += x.z;
        tot[e].w += x.w;
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kQ; ++e) {
    f[4 * e] = tot[e].x;
    f[4 * e + 1] = tot[e].y;
    f[4 * e + 2] = tot[e].z;
    f[4 * e + 3] = tot[e].w;
  }
}

// Where this block's work lies: output columns [c0, c0 + TW) (column tile
// blockIdx.x; past d in a cluster's padding, where nothing is stored), the
// scores over [s0, s1) of d, its rank's slice (the rank is blockIdx.x %
// cl, clusters laid along x).
struct Span {
  int c0, s0, s1;
};

__device__ __forceinline__ Span span_of(int d, int cl) {
  const int s0 = static_cast<int>(blockIdx.x) % cl * simt_wide_slice_width(d);
  return {static_cast<int>(blockIdx.x) * simt_wide_tile_width(d), s0,
          min(d, s0 + simt_wide_slice_width(d))};
}

// The walk every kernel shares: `steps` outer steps (kv tiles, or q heads
// and q tiles), each a run of staged items: the pieces of the block's
// slice of d (the scores), then the chunks of Z (the products into acc).
// The next kStages - 1 items are staged (cp.async for fp32) while one is
// multiplied. With P::kRes the X rows of the whole slice are copied first,
// in item 0's commit group, and the items stage Y alone. After a step's
// last piece: a cluster's partials are summed, then
// kern.scores(step, s, W, acc) writes W from the scores (and may rescale
// acc). kern.sources(step, xs, ys, zs, x0, y0) names the operands' rows
// (xs and x0 the same at every step).
template <class P, typename T, int VEC, class K>
__device__ __forceinline__ void walk(K& kern, float* smem, int steps,
                                     Span sp, int d, int cl,
                                     float (&acc)[P::kNZ][P::kRX][P::kCols]) {
  float* X = smem;                        // resident X (P::kRes)
  float* stages = smem + P::kX;
  float* W = stages + kStages * P::kStage;
  float* part = W + P::kW;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int np = (sp.s1 - sp.s0 + kKP - 1) / kKP;
  const int per = np + P::kChunks;

  auto issue = [&](int item) {
    float* st = stages + item % kStages * P::kStage;
    const int step = item / per, local = item % per;
    Rows<T> xs[P::kNP], ys[P::kNP], zs[P::kNZ];
    int x0, y0;
    kern.sources(step, xs, ys, zs, x0, y0);
    if (local < np) {
      const int p0 = sp.s0 + local * kKP;
      float* yst = st + (P::kRes ? 0 : P::kNP * P::kM * kLP);
#pragma unroll
      for (int p = 0; p < P::kNP; ++p) {
        if constexpr (!P::kRes)
          copy_block<T, VEC, P::kM, kKP, kLP>(st + p * P::kM * kLP, xs[p],
                                              x0, p0, sp.s1);
        copy_block<T, VEC, P::kN, kKP, kLP>(yst + p * P::kN * kLP, ys[p],
                                            y0, p0, sp.s1);
      }
    } else {
      const int r0 = y0 + (local - np) * P::kKC;
#pragma unroll
      for (int z = 0; z < P::kNZ; ++z)
        copy_block<T, VEC, P::kKC, P::kTW, P::kTW>(
            st + z * P::kKC * P::kTW, zs[z], r0, sp.c0, d);
    }
    cp_async_commit();
  };
  // item's stage has landed and is visible; the stage of item - 1 is free
  // (multiplied before this barrier), so item + kStages - 1 goes there (an
  // empty commit group past the last item keeps the count)
  auto advance = [&](int item) -> const float* {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (item + kStages - 1 < steps * per)
      issue(item + kStages - 1);
    else
      cp_async_commit();
    return stages + item % kStages * P::kStage;
  };

  if constexpr (P::kRes) {
    if (steps > 0) {
      Rows<T> xs[P::kNP], ys[P::kNP], zs[P::kNZ];
      int x0, y0;
      kern.sources(0, xs, ys, zs, x0, y0);
#pragma unroll
      for (int p = 0; p < P::kNP; ++p)
        copy_block<T, VEC, P::kM, P::kTW, P::kLX>(X + p * P::kM * P::kLX,
                                                  xs[p], x0, sp.s0, sp.s1);
    }
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < steps * per)
      issue(i);
    else
      cp_async_commit();
  }
  int item = 0;
  for (int step = 0; step < steps; ++step) {
    float s[P::kNP][P::kRX][P::kRY];
#pragma unroll
    for (int p = 0; p < P::kNP; ++p)
#pragma unroll
      for (int i = 0; i < P::kRX; ++i)
#pragma unroll
        for (int j = 0; j < P::kRY; ++j) s[p][i][j] = 0.f;
    for (int piece = 0; piece < np; ++piece, ++item) {
      const float* st = advance(item);
      piece_product<P>(P::kRes ? X + piece * kKP : st,
                       P::kRes ? st : st + P::kNP * P::kM * kLP,
                       sp.s1 - sp.s0 - piece * kKP <= kKP / 2, s, ty, tx);
    }
    if constexpr (P::kCluster)
      cluster_sum<P>(part + (step & 1) * P::kPart, s, cl);
    kern.scores(step, s, W, acc);
    for (int c = 0; c < P::kChunks; ++c, ++item)
      chunk_product<P>(advance(item), W, c, acc, ty, tx);
  }
  // no block leaves while another block of its cluster may read its part
  if constexpr (P::kCluster) cg::this_cluster().sync();
}

template <class P>
__device__ __forceinline__ void zero(float (&acc)[P::kNZ][P::kRX][P::kCols]) {
#pragma unroll
  for (int z = 0; z < P::kNZ; ++z)
#pragma unroll
    for (int i = 0; i < P::kRX; ++i)
#pragma unroll
      for (int c = 0; c < P::kCols; ++c) acc[z][i][c] = 0.f;
}

// Forward: S = Q K^T over 64 x 64 tiles, online softmax as
// flash_fwd_simt_kernel, O += P V over the block's column tile.
template <int TW, int MODE>
using FwdTiles = Tiles<64, 64, 1, 1, 32, TW, MODE>;

template <typename T, class P>
struct FwdKern {
  Rows<T> q, k, v;
  int q0, skv, causal;
  float scale, m[P::kRX], l[P::kRX];

  __device__ __forceinline__ void sources(int step, Rows<T>* xs, Rows<T>* ys,
                                          Rows<T>* zs, int& x0, int& y0) {
    xs[0] = q;
    ys[0] = k;
    zs[0] = v;
    x0 = q0;
    y0 = step * P::kN;
  }

  __device__ __forceinline__ void scores(
      int step, float (&s)[P::kNP][P::kRX][P::kRY], float* W,
      float (&acc)[P::kNZ][P::kRX][P::kCols]) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    const int k0 = step * P::kN;
#pragma unroll
    for (int i = 0; i < P::kRX; ++i) {
      const int row = q0 + ty * P::kRX + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < P::kRY; ++j) {
        const int col = k0 + tx + 16 * j;
        float val = s[0][i][j] * scale;
        if (col >= skv || (causal && col > row)) val = kNegInf;
        s[0][i][j] = val;
        mx = fmaxf(mx, val);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < P::kRY; ++j) {
        const float p = expf(s[0][i][j] - m_new);
        rowsum += p;
        W[(ty * P::kRX + i) * P::kLW + tx + 16 * j] = p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + group16_sum(rowsum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < P::kCols; ++c) acc[0][i][c] *= alpha;
    }
  }
};

// Grid (column tiles, padded to whole clusters of cl along x; hq x b; q
// tiles of 64, longest first when causal: a wave's tail takes the
// shortest).
template <typename T, int VEC, int TW, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int sq, int skv, int hq,
                      int hkv, int d, float scale, int causal, int cl) {
  using P = FwdTiles<TW, MODE>;
  static_assert(P::smem() <= kMaxSmem, "forward tiles");
  extern __shared__ float smem[];
  const int h = blockIdx.y % hq, bb = blockIdx.y / hq;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * P::kM;
  const int kvh = h / (hq / hkv);
  const Span sp = span_of(d, cl);
  FwdKern<T, P> kern{rows_of(q, bb, sq, hq, h, d),
                     rows_of(k, bb, skv, hkv, kvh, d),
                     rows_of(v, bb, skv, hkv, kvh, d), q0, skv, causal,
                     scale};
#pragma unroll
  for (int i = 0; i < P::kRX; ++i) {
    kern.m[i] = kNegInf;
    kern.l[i] = 0.f;
  }
  float acc[1][P::kRX][P::kCols];
  zero<P>(acc);
  const int kv_end = causal ? min(skv, q0 + P::kM) : skv;
  walk<P, T, VEC>(kern, smem, (kv_end + P::kN - 1) / P::kN, sp, d, cl,
                  acc);

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < P::kRX; ++i) {
    const int row = q0 + ty * P::kRX + i;
    if (row >= sq) continue;
    const float denom = kern.l[i] == 0.f ? 1.f : kern.l[i];
    if (lse != nullptr && blockIdx.x == 0 && tx == 0)
      lse[(static_cast<size_t>(bb) * hq + h) * sq + row] =
          kern.m[i] + logf(denom);
    T* orow = o + ((static_cast<size_t>(bb) * sq + row) * hq + h) *
                      static_cast<size_t>(d);
#pragma unroll
    for (int jj = 0; jj < P::kNJ; ++jj) {
      const float* a = acc[0][i] + 4 * jj;
      store4<T, VEC>(orow, sp.c0 + tx * 4 + 64 * jj, d, a[0] / denom,
                     a[1] / denom, a[2] / denom, a[3] / denom);
    }
  }
}

// dQ: for each kv tile of 32 rows up to the diagonal, S = Q K^T and
// dP = dO V^T, dS = P (dP - delta) with P = exp(S scale - lse), and
// dQ += dS K over the block's column tile. With Q and dO resident at 256
// columns, K comes in chunks of 16 rows (of 32, 240 KB would pass a
// block's 227).
template <int TW, int MODE>
using DqTiles = Tiles<64, 32, 2, 1, TW == 256 && MODE != kStreamed ? 16 : 32,
                      TW, MODE>;

template <typename T, class P>
struct DqKern {
  Rows<T> q, dout, k, v;
  int q0, sq, skv, causal;
  float scale, lr[P::kRX], dl[P::kRX];

  __device__ __forceinline__ void sources(int step, Rows<T>* xs, Rows<T>* ys,
                                          Rows<T>* zs, int& x0, int& y0) {
    xs[0] = q;
    xs[1] = dout;
    ys[0] = k;
    ys[1] = v;
    zs[0] = k;
    x0 = q0;
    y0 = step * P::kN;
  }

  __device__ __forceinline__ void scores(
      int step, float (&s)[P::kNP][P::kRX][P::kRY], float* W,
      float (&)[P::kNZ][P::kRX][P::kCols]) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < P::kRX; ++i) {
      const int qi = q0 + ty * P::kRX + i;
#pragma unroll
      for (int j = 0; j < P::kRY; ++j) {
        const int ki = step * P::kN + tx + 16 * j;
        const bool ok = qi < sq && ki < skv && (!causal || ki <= qi);
        const float p = ok ? expf(s[0][i][j] * scale - lr[i]) : 0.f;
        W[(ty * P::kRX + i) * P::kLW + tx + 16 * j] =
            p * (s[1][i][j] - dl[i]);
      }
    }
  }
};

// Grid (column tiles as the forward's; hq x b; q tiles of 64, longest
// first when causal).
template <typename T, int VEC, int TW, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dq,
                         int sq, int skv, int hq, int hkv, int d, float scale,
                         int causal, int cl) {
  using P = DqTiles<TW, MODE>;
  static_assert(P::smem() <= kMaxSmem, "dQ tiles");
  extern __shared__ float smem[];
  const int h = blockIdx.y % hq, bb = blockIdx.y / hq;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * P::kM;
  const int kvh = h / (hq / hkv);
  const Span sp = span_of(d, cl);
  DqKern<T, P> kern{rows_of(q, bb, sq, hq, h, d),
                    rows_of(dout, bb, sq, hq, h, d),
                    rows_of(k, bb, skv, hkv, kvh, d),
                    rows_of(v, bb, skv, hkv, kvh, d), q0, sq, skv, causal,
                    scale};
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < P::kRX; ++i) {
    const int qi = q0 + ty * P::kRX + i;
    const size_t off = (static_cast<size_t>(bb) * hq + h) * sq + qi;
    kern.lr[i] = qi < sq ? lse[off] : 0.f;
    kern.dl[i] = qi < sq ? delta[off] : 0.f;
  }
  float acc[1][P::kRX][P::kCols];
  zero<P>(acc);
  const int kv_end = causal ? min(skv, q0 + P::kM) : skv;
  walk<P, T, VEC>(kern, smem, (kv_end + P::kN - 1) / P::kN, sp, d, cl,
                  acc);
#pragma unroll
  for (int i = 0; i < P::kRX; ++i) {
    const int qi = q0 + ty * P::kRX + i;
    if (qi >= sq) continue;
    T* row = dq + ((static_cast<size_t>(bb) * sq + qi) * hq + h) *
                      static_cast<size_t>(d);
#pragma unroll
    for (int jj = 0; jj < P::kNJ; ++jj) {
      const float* a = acc[0][i] + 4 * jj;
      store4<T, VEC>(row, sp.c0 + tx * 4 + 64 * jj, d, a[0] * scale,
                     a[1] * scale, a[2] * scale, a[3] * scale);
    }
  }
}

// dK, dV: for each q head of the block's part of the kv head's group and
// each q tile of 64 rows (none wholly above the diagonal when causal),
// S^T = K Q^T and dP^T = V dO^T, P^T = exp(S^T scale - lse),
// dS^T = P^T (dP^T - delta), then dV += P^T dO and dK += dS^T Q over the
// block's column tile. A block a kv tile of kSimtWideKvRows (32) rows.
template <int TW, int MODE>
using DkdvTiles = Tiles<kSimtWideKvRows, 64, 2, 2, 16, TW, MODE>;

template <typename T, class P>
struct DkdvKern {
  const T *q, *dout;
  const float *lse, *delta;
  Rows<T> k, v;
  int k0, bb, h0, qt0, nq, sq, hq, d, causal;
  float scale;

  __device__ __forceinline__ void sources(int step, Rows<T>* xs, Rows<T>* ys,
                                          Rows<T>* zs, int& x0, int& y0) {
    const int h = h0 + step / nq;
    const Rows<T> qr = rows_of(q, bb, sq, hq, h, d);
    const Rows<T> dr = rows_of(dout, bb, sq, hq, h, d);
    xs[0] = k;
    xs[1] = v;
    ys[0] = qr;
    ys[1] = dr;
    zs[0] = dr;     // dV += P^T dO
    zs[1] = qr;     // dK += dS^T Q
    x0 = k0;
    y0 = (qt0 + step % nq) * P::kN;
  }

  __device__ __forceinline__ void scores(
      int step, float (&s)[P::kNP][P::kRX][P::kRY], float* W,
      float (&)[P::kNZ][P::kRX][P::kCols]) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    const int h = h0 + step / nq;
    const int q0 = (qt0 + step % nq) * P::kN;
    const size_t off = (static_cast<size_t>(bb) * hq + h) * sq;
    float lr[P::kRY], dl[P::kRY];
#pragma unroll
    for (int j = 0; j < P::kRY; ++j) {
      const int qi = q0 + tx + 16 * j;
      lr[j] = qi < sq ? lse[off + qi] : 0.f;
      dl[j] = qi < sq ? delta[off + qi] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < P::kRX; ++i) {
      const int kvi = k0 + ty * P::kRX + i;
#pragma unroll
      for (int j = 0; j < P::kRY; ++j) {
        const int qi = q0 + tx + 16 * j;
        const bool ok = kvi < k.n && qi < sq && (!causal || kvi <= qi);
        const float p = ok ? expf(s[0][i][j] * scale - lr[j]) : 0.f;
        const int at = (ty * P::kRX + i) * P::kLW + tx + 16 * j;
        W[at] = p;
        W[P::kM * P::kLW + at] = p * (s[1][i][j] - dl[j]);
      }
    }
  }
};

// Grid (column tiles as the forward's; hkv x b x parts, part-major; kv
// tiles of 32, the causal walk's longest first). Part p of `parts` walks q
// heads [p g / parts, (p + 1) g / parts) of the group. With one part dK
// and dV are stored; with more, each part's fp32 sums (dK unscaled) go to
// `part_out`: dV of part p at p n, dK at (parts + p) n, n = b skv hkv d,
// for flash_bwd_parts_sum_kernel.
template <typename T, int VEC, int TW, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dk, T* __restrict__ dv,
                           float* __restrict__ part_out, int parts, int sq,
                           int skv, int hq, int hkv, int d, float scale,
                           int causal, int cl) {
  using P = DkdvTiles<TW, MODE>;
  static_assert(P::smem() <= kMaxSmem, "dK/dV tiles");
  extern __shared__ float smem[];
  const int units = static_cast<int>(gridDim.y) / parts;   // hkv x b
  const int part = static_cast<int>(blockIdx.y) / units;
  const int kvh = static_cast<int>(blockIdx.y) % hkv;
  const int bb = static_cast<int>(blockIdx.y) % units / hkv;
  const int k0 = blockIdx.z * P::kM, g = hq / hkv;
  const int ha = part * g / parts, hb = (part + 1) * g / parts;
  const int n_qt = (sq + P::kN - 1) / P::kN;
  const int qt0 = causal ? min(k0 / P::kN, n_qt) : 0;
  const Span sp = span_of(d, cl);
  DkdvKern<T, P> kern{q, dout, lse, delta,
                      rows_of(k, bb, skv, hkv, kvh, d),
                      rows_of(v, bb, skv, hkv, kvh, d), k0, bb, kvh * g + ha,
                      qt0, n_qt - qt0, sq, hq, d, causal, scale};
  float acc[2][P::kRX][P::kCols];
  zero<P>(acc);
  walk<P, T, VEC>(kern, smem, (hb - ha) * (n_qt - qt0), sp, d, cl, acc);

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const size_t n = static_cast<size_t>(units) * skv * d;
#pragma unroll
  for (int i = 0; i < P::kRX; ++i) {
    const int kvi = k0 + ty * P::kRX + i;
    if (kvi >= skv) continue;
    const size_t off = ((static_cast<size_t>(bb) * skv + kvi) * hkv + kvh) *
                       static_cast<size_t>(d);
#pragma unroll
    for (int jj = 0; jj < P::kNJ; ++jj) {
      const int col = sp.c0 + tx * 4 + 64 * jj;
      const float* a = acc[0][i] + 4 * jj;
      const float* b = acc[1][i] + 4 * jj;
      if (parts == 1) {
        store4<T, VEC>(dv + off, col, d, a[0], a[1], a[2], a[3]);
        store4<T, VEC>(dk + off, col, d, b[0] * scale, b[1] * scale,
                       b[2] * scale, b[3] * scale);
      } else {
        store4<float, VEC>(part_out + part * n + off, col, d, a[0], a[1],
                           a[2], a[3]);
        store4<float, VEC>(part_out + (parts + part) * n + off, col, d,
                           b[0], b[1], b[2], b[3]);
      }
    }
  }
}

// dV = the sum of the parts' dV in part order, dK = the same of theirs
// times `scale`, each element by one thread (n elements each).
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_parts_sum_kernel(const float* __restrict__ part,
                           T* __restrict__ dk, T* __restrict__ dv,
                           long long n, int parts, float scale) {
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < 2 * n; i += static_cast<long long>(gridDim.x) * kThreads) {
    const bool is_k = i >= n;
    const long long e = is_k ? i - n : i;
    const float* src = part + (is_k ? parts * n : 0) + e;
    float s = src[0];
    for (int p = 1; p < parts; ++p) s += src[p * n];
    if (is_k)
      dk[e] = from_f32<T>(s * scale);
    else
      dv[e] = from_f32<T>(s);
  }
}

// A launch over the column tiles of d. kOneTile: one block along x, no
// cluster, checked to be resident on an SM. Else grid x the tiles, padded
// to whole clusters of simt_wide_cluster(d) blocks (checked to fit the
// card: a plan whose clusters cannot be resident is refused). Failures are
// returned.
template <int MODE, typename... Params, typename... Args>
cudaError_t launch_tiles(void (*kernel)(Params...), int d, unsigned y,
                         unsigned z, size_t smem, cudaStream_t stream,
                         Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int cl = MODE == kOneTile ? 1 : simt_wide_cluster(d);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(MODE == kOneTile ? 1 : cl * simt_wide_clusters(d), y,
                     z);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  int resident = 0;
  if constexpr (MODE == kOneTile) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        kThreads, smem);
  } else {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(&resident, kernel, &cfg);
  }
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, args..., cl);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int VEC, int TW, int MODE>
int fwd_as(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int skv, int hq, int hkv, int d, float scale,
           int causal, cudaStream_t stream) {
  using P = FwdTiles<TW, MODE>;
  return static_cast<int>(launch_tiles<MODE>(
      flash_fwd_wide_kernel<T, VEC, TW, MODE>, d, hq * b,
      (sq + P::kM - 1) / P::kM, P::smem(), stream,
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, skv, hq, hkv, d,
      scale, causal));
}

// dK/dV (in simt_wide_kv_parts parts, then their sum where there is more
// than one: `scratch`, 2 parts b skv hkv d floats, null if one), then dQ.
template <typename T, int VEC, int TW, int MODE>
int bwd_as(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, void* scratch, int b, int sq, int skv, int hq, int hkv,
           int d, float scale, int causal, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int kv_tiles = simt_wide_kv_tiles(skv);
  const int parts = simt_wide_kv_parts(
      simt_wide_cluster(d) * simt_wide_clusters(d) * hkv * b * kv_tiles,
      hq / hkv);
  float* part_out = static_cast<float*>(scratch);
  if (parts > 1 && part_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = launch_tiles<MODE>(
      flash_bwd_dkdv_wide_kernel<T, VEC, TW, MODE>, d, hkv * b * parts,
      kv_tiles, DkdvTiles<TW, MODE>::smem(), stream, qt, kt, vt, dot, lse,
      delta, static_cast<T*>(dk), static_cast<T*>(dv), part_out, parts, sq,
      skv, hq, hkv, d, scale, causal);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (parts > 1) {
    const long long n = static_cast<long long>(b) * skv * hkv * d;
    const long long blocks = (2 * n + kThreads - 1) / kThreads;
    flash_bwd_parts_sum_kernel<T>
        <<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), kThreads, 0,
           stream>>>(part_out, static_cast<T*>(dk), static_cast<T*>(dv), n,
                     parts, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(launch_tiles<MODE>(
      flash_bwd_dq_wide_kernel<T, VEC, TW, MODE>, d, hq * b,
      (sq + DqTiles<TW, MODE>::kM - 1) / DqTiles<TW, MODE>::kM,
      DqTiles<TW, MODE>::smem(), stream, qt, kt, vt, dot, lse, delta,
      static_cast<T*>(dq), sq, skv, hq, hkv, d, scale, causal));
}

}  // namespace simt
}  // namespace
}  // namespace repro
