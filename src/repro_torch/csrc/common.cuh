// Shared helpers of the port's CUDA kernels: dtype conversion, warp
// reductions and the attention kernels' padded head dim. Every kernel
// computes in fp32 and reads and writes float32 or bfloat16 (dtype code 0
// or 1, as in _build.DTYPE_CODES).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr int kF32 = 0;
constexpr int kBF16 = 1;
// Masked scores take this value, as in the JAX kernels (not -inf), so that a
// row with every position masked stays finite and l == 0 maps to output 0.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

// The max and the sum over a group of 16 lanes (lanes whose ids differ in
// the low four bits), as the CUDA-core flash kernels reduce a score row.
__device__ __forceinline__ float group16_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float group16_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The instantiated head dim an attention call of head dim d runs at: the
// least of 16, 32, 64, 128, 160 and 256 at or above d, 0 outside 1..256
// (above 256 the column-tile kernels serve it; below 1 it is refused).
// Columns d..D - 1 load as zeros and are never stored.
inline int padded_dim(int d) {
  constexpr int kDims[] = {16, 32, 64, 128, 160, 256};
  for (int dd : kDims)
    if (d >= 1 && d <= dd) return dd;
  return 0;
}

// Head dims above 256 (the attention kernels' column-tile designs): the
// output's d columns in ceil(d / 256) tiles of equal width, rounded up to
// 16, the last cut at d; a block a tile.
constexpr int kWideTileCols = 256;  // output columns a tile, at most

__host__ __device__ inline int wide_col_tiles(int d) {
  return (d + kWideTileCols - 1) / kWideTileCols;
}

__host__ __device__ inline int wide_tile_width(int d) {
  const int n = wide_col_tiles(d);
  return ((d + n - 1) / n + 15) / 16 * 16;
}

// fp32 above kSimtMaxDim, and bf16 above kTcWideMaxDim: the CUDA-core
// tiles of flash_attention_simt_wide.cuh (route "wide"), forward and
// backward; the CUDA-core kernels of flash_attention.cu serve the rest of
// d up to kSimtMaxDim, in both dtypes.
constexpr int kSimtMaxDim = 32;

// The output's d columns in simt_wide_col_tiles(d) tiles of equal width
// rounded up to a 64-column multiple (64-256; one tile up to 256, of 192 or
// 256 above), a block a tile, the last cut at d. Above 256 the tiles of one
// (row tile, head, batch) run as clusters of simt_wide_cluster(d) blocks
// (at most kSimtWideMaxCluster, the portable cluster size;
// simt_wide_clusters(d) clusters, padded with blocks past d that store
// nothing): block r of a cluster computes the partial scores over slice r
// of d, simt_wide_slice_width(d) columns (a multiple of kSimtWidePiece,
// half a staged piece; the last cut at d), and every block sums the
// cluster's partials in rank order. A block keeps its X rows over its slice
// resident (simt_wide_resident) at one tile, and above it where its copies
// are element copies (d % 4 != 0, where staging X with every piece is
// dear) and the slice is no wider than a tile (up to 8 tiles); else X is
// staged with every piece. The dK/dV kernel's blocks take kSimtWideKvRows
// kv rows each (simt_wide_kv_tiles); where they are fewer than one wave
// (kSimtWideWave, an SM of the H100 each), each splits its walk over the
// group's q heads into simt_wide_kv_parts parts, a block each, enough for
// kSimtWideFillBlocks blocks (two waves), whose fp32 sums are added in
// part order after.
constexpr int kSimtWideCols = 256;
constexpr int kSimtWideMaxCluster = 8;
constexpr int kSimtWidePiece = 32;
constexpr int kSimtWideKvRows = 32;
constexpr int kSimtWideWave = 132;
constexpr int kSimtWideFillBlocks = 264;

__host__ __device__ inline int simt_wide_col_tiles(int d) {
  return (d + kSimtWideCols - 1) / kSimtWideCols;
}

__host__ __device__ inline int simt_wide_tile_width(int d) {
  return ((d + simt_wide_col_tiles(d) - 1) / simt_wide_col_tiles(d) + 63) /
         64 * 64;
}

__host__ __device__ inline int simt_wide_cluster(int d) {
  return simt_wide_col_tiles(d) < kSimtWideMaxCluster
             ? simt_wide_col_tiles(d) : kSimtWideMaxCluster;
}

__host__ __device__ inline int simt_wide_clusters(int d) {
  return (simt_wide_col_tiles(d) + simt_wide_cluster(d) - 1) /
         simt_wide_cluster(d);
}

__host__ __device__ inline int simt_wide_slice_width(int d) {
  return ((d + simt_wide_cluster(d) - 1) / simt_wide_cluster(d) +
          kSimtWidePiece - 1) / kSimtWidePiece * kSimtWidePiece;
}

__host__ __device__ inline int simt_wide_kv_tiles(int skv) {
  return (skv + kSimtWideKvRows - 1) / kSimtWideKvRows;
}

__host__ __device__ inline bool simt_wide_resident(int d) {
  return d % 4 != 0 && simt_wide_slice_width(d) <= simt_wide_tile_width(d)
             ? 1 : simt_wide_col_tiles(d) == 1;
}

// Parts of the dK/dV walk, given the blocks one part takes and the group
// g: enough for kSimtWideFillBlocks blocks, at most g.
__host__ __device__ inline int simt_wide_kv_fill(int blocks, int g) {
  return (kSimtWideFillBlocks + blocks - 1) / blocks < g
             ? (kSimtWideFillBlocks + blocks - 1) / blocks : g;
}

__host__ __device__ inline int simt_wide_kv_parts(int blocks, int g) {
  return blocks >= kSimtWideWave ? 1 : simt_wide_kv_fill(blocks, g);
}

// bf16 above 256 where the rows are whole 16-byte chunks (the TMA maps'
// row stride) and the backward's resident tiles fit shared memory: the
// tensor-core column-tile kernels of flash_attention_wide.cu, forward and
// backward. Their own tile plans, of widths 192 or 256 (the wgmma N, a
// compile-time constant), the last tile cut at d. The backward's:
// ceil(d / 256) tiles of equal width rounded up to a whole 64-column box.
// The forward's: tiles of 192 while two blocks an SM fit shared memory
// beside the resident Q (d <= kTcWideFwd192MaxDim), else the backward's.
constexpr int kTcWideMaxDim = 768;
constexpr int kTcWideFwd192MaxDim = 704;

__host__ __device__ inline bool tc_wide_route(int d) {
  return d > 256 && d <= kTcWideMaxDim && d % 8 == 0;
}

__host__ __device__ inline int tc_wide_col_tiles(int d) {
  return (d + 255) / 256;
}

__host__ __device__ inline int tc_wide_tile_width(int d) {
  return ((d + tc_wide_col_tiles(d) - 1) / tc_wide_col_tiles(d) + 63) / 64 * 64;
}

__host__ __device__ inline int tc_wide_fwd_tile_width(int d) {
  return d <= kTcWideFwd192MaxDim ? 192 : tc_wide_tile_width(d);
}

__host__ __device__ inline int tc_wide_fwd_col_tiles(int d) {
  return (d + tc_wide_fwd_tile_width(d) - 1) / tc_wide_fwd_tile_width(d);
}

// bf16 from 33 to 256 where a row is not whole 16-byte chunks: the flash
// forward's and backward's staged route (flash_attention.cu), which copies
// Q, K, V (and dO) into rows of staged_ld(d) elements, the least multiple
// of 8 at or above d, and runs the tensor-core kernels on them.
__host__ __device__ inline bool staged_route(int d) {
  return d > 32 && d <= 256 && d % 8 != 0;
}

__host__ __device__ inline int staged_ld(int d) { return (d + 7) / 8 * 8; }

// bf16 above 256 where a row is not whole 16-byte chunks, up to
// kTcWideMaxDim: the flash forward and backward copy their inputs into rows
// of staged_ld(d) elements (flash_stage_rows_kernel) and run the tensor-core
// column tiles of flash_attention_wide.cu on the copies, at the plans of
// tc_wide_route's d.
__host__ __device__ inline bool tc_wide_staged_route(int d) {
  return d > 256 && d <= kTcWideMaxDim && d % 8 != 0;
}

// Route "wide" (f32: 1 for fp32, 0 for bf16), forward and backward.
__host__ __device__ inline bool simt_wide_route(int f32, int d) {
  return f32 ? d > kSimtMaxDim : d > kTcWideMaxDim;
}

// bf16 decode at the padded head dim 256 where d is whole 16-byte chunks
// (d 168-256): decode_attention_tc.cu, on the tensor cores. Its cache rows
// come in tiles of kDecodeMmaTile (eight warps a block, each scoring 8
// rows); its splits are planned from skv and the number of (batch, kv
// head, q-head slice) units alone, never from the lengths: as many as fill
// the card (about kDecodeMmaBlocks blocks, one an SM: a block's two tiles
// in flight take 144 KB), at most 32 (the combine takes one split a lane),
// but at least kDecodeMmaMinRows rows a split (a tile: each split adds a
// partial that the combine reads after the last split).
constexpr int kDecodeMmaTile = 64;
constexpr int kDecodeMmaBlocks = 132;
constexpr int kDecodeMmaMinRows = 64;

__host__ __device__ inline bool decode_mma_route(int d) {
  return d > 160 && d <= 256 && d % 8 == 0;
}

__host__ __device__ inline int decode_mma_splits(int units) {
  return (kDecodeMmaBlocks + units - 1) / units > 32
             ? 32 : (kDecodeMmaBlocks + units - 1) / units;
}

// The least whole tiles that cover skv in decode_mma_splits(units) splits.
__host__ __device__ inline int decode_mma_fill_rows(int skv, int units) {
  return kDecodeMmaTile * ((skv + kDecodeMmaTile * decode_mma_splits(units) -
                            1) / (kDecodeMmaTile * decode_mma_splits(units)));
}

// Cache rows a split: decode_mma_fill_rows, but at least kDecodeMmaMinRows.
__host__ __device__ inline int decode_mma_split_rows(int skv, int units) {
  return decode_mma_fill_rows(skv, units) < kDecodeMmaMinRows
             ? kDecodeMmaMinRows : decode_mma_fill_rows(skv, units);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace repro
