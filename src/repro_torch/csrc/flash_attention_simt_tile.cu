// Route "wide" at one column tile: fp32 flash attention at head dims 33 to
// 256 on the CUDA cores (flash_attention_simt_wide.cuh, mode kOneTile: one
// block holds the whole d, X rows resident, no cluster), at tile widths 64,
// 128, 192 and 256 (simt_wide_tile_width; d 160 at 192, whose last 32
// columns are zeros that are never stored). Compiled by an nvcc of its own,
// beside the column tiles above 256 (flash_attention_simt_wide.cu), which
// dispatch here.
#include "flash_attention_simt_wide.cuh"

namespace repro {
namespace wide_tile {

// 16-byte copies where d is a multiple of 4, else element copies.
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int sq, int skv, int hq, int hkv, int d,
               float scale, int causal, cudaStream_t stream) {
  using simt::fwd_as;
  using simt::kOneTile;
  const bool v4 = d % 4 == 0;
  switch (simt_wide_col_tiles(d) == 1 ? simt_wide_tile_width(d) : 0) {
    case 64:
      return v4 ? fwd_as<float, 4, 64, kOneTile>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream)
                : fwd_as<float, 1, 64, kOneTile>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream);
    case 128:
      return v4 ? fwd_as<float, 4, 128, kOneTile>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream)
                : fwd_as<float, 1, 128, kOneTile>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream);
    case 192:
      return v4 ? fwd_as<float, 4, 192, kOneTile>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream)
                : fwd_as<float, 1, 192, kOneTile>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream);
    case 256:
      return v4 ? fwd_as<float, 4, 256, kOneTile>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream)
                : fwd_as<float, 1, 256, kOneTile>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, void* scratch, int b, int sq, int skv, int hq,
               int hkv, int d, float scale, int causal, cudaStream_t stream) {
  using simt::bwd_as;
  using simt::kOneTile;
  const bool v4 = d % 4 == 0;
  switch (simt_wide_col_tiles(d) == 1 ? simt_wide_tile_width(d) : 0) {
    case 64:
      return v4 ? bwd_as<float, 4, 64, kOneTile>(q, k, v, dout, lse, delta, dq, dk, dv, scratch, b, sq, skv, hq, hkv, d, scale, causal, stream)
                : bwd_as<float, 1, 64, kOneTile>(q, k, v, dout, lse, delta, dq, dk, dv, scratch, b, sq, skv, hq, hkv, d, scale, causal, stream);
    case 128:
      return v4 ? bwd_as<float, 4, 128, kOneTile>(q, k, v, dout, lse, delta, dq, dk, dv, scratch, b, sq, skv, hq, hkv, d, scale, causal, stream)
                : bwd_as<float, 1, 128, kOneTile>(q, k, v, dout, lse, delta, dq, dk, dv, scratch, b, sq, skv, hq, hkv, d, scale, causal, stream);
    case 192:
      return v4 ? bwd_as<float, 4, 192, kOneTile>(q, k, v, dout, lse, delta, dq, dk, dv, scratch, b, sq, skv, hq, hkv, d, scale, causal, stream)
                : bwd_as<float, 1, 192, kOneTile>(q, k, v, dout, lse, delta, dq, dk, dv, scratch, b, sq, skv, hq, hkv, d, scale, causal, stream);
    case 256:
      return v4 ? bwd_as<float, 4, 256, kOneTile>(q, k, v, dout, lse, delta, dq, dk, dv, scratch, b, sq, skv, hq, hkv, d, scale, causal, stream)
                : bwd_as<float, 1, 256, kOneTile>(q, k, v, dout, lse, delta, dq, dk, dv, scratch, b, sq, skv, hq, hkv, d, scale, causal, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace wide_tile
}  // namespace repro
