// Route "wide" above a head dim of 256: flash attention on the CUDA cores
// in column tiles of 192 or 256 launched as clusters
// (flash_attention_simt_wide.cuh): fp32 above 256 and bf16 above
// kTcWideMaxDim, with the X rows resident where simt_wide_resident holds
// (element copies, d % 4 != 0, up to 8 tiles: on an H100 at 8/8 d 257 it
// took 6 % off the forward and the backward), else staged beside Y (the
// streamed design: at 16-byte copies resident X was 0-3 % slower; PERF.md
// §6 has the times). Below 257 fp32 takes one tile
// (flash_attention_simt_tile.cu); bf16 takes no route here there. The
// entry points of flash_attention.cu's route "wide".
#include <type_traits>

#include "flash_attention_simt_wide.cuh"

namespace repro {
// flash_attention_simt_tile.cu: fp32 at one tile (d 33-256).
namespace wide_tile {
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int sq, int skv, int hq, int hkv, int d,
               float scale, int causal, cudaStream_t stream);
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, void* scratch, int b, int sq, int skv, int hq,
               int hkv, int d, float scale, int causal, cudaStream_t stream);
}  // namespace wide_tile

namespace {
namespace simt {

// The instantiation of d above 256: X resident where simt_wide_resident
// holds (element copies, d % 4 != 0, up to d 2048) at tile widths 192
// (fp32 only: bf16 above 768 is always 256 wide) and 256; else X staged
// with every piece (kStreamed), with 16-byte (fp32) or 8-byte (bf16)
// copies where d is a multiple of 4 at 192 (fp32) and 256, and element
// copies at 256 (d above 2048). Any other plan is refused.
template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int sq, int skv, int hq, int hkv, int d,
               float scale, int causal, cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  const bool v4 = d % 4 == 0;
  const int tw = simt_wide_col_tiles(d) > 1 ? simt_wide_tile_width(d) : 0;
  if (simt_wide_resident(d)) {
    if constexpr (f32) {
      if (tw == 192)
        return fwd_as<T, 1, 192, kResident>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream);
    }
    if (tw == 256)
      return fwd_as<T, 1, 256, kResident>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (f32) {
    if (tw == 192 && v4)
      return fwd_as<T, 4, 192, kStreamed>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream);
  }
  if (tw == 256)
    return v4 ? fwd_as<T, 4, 256, kStreamed>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream)
              : fwd_as<T, 1, 256, kStreamed>(q, k, v, o, lse, b, sq, skv, hq, hkv, d, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dK/dV and dQ column tiles (delta already written), as the forward's.
template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, void* scratch, int b, int sq, int skv, int hq,
               int hkv, int d, float scale, int causal, cudaStream_t stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  const bool v4 = d % 4 == 0;
  const int tw = simt_wide_col_tiles(d) > 1 ? simt_wide_tile_width(d) : 0;
  if (simt_wide_resident(d)) {
    if constexpr (f32) {
      if (tw == 192)
        return bwd_as<T, 1, 192, kResident>(q, k, v, dout, lse, delta, dq, dk, dv, scratch, b, sq, skv, hq, hkv, d, scale, causal, stream);
    }
    if (tw == 256)
      return bwd_as<T, 1, 256, kResident>(q, k, v, dout, lse, delta, dq, dk, dv, scratch, b, sq, skv, hq, hkv, d, scale, causal, stream);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (f32) {
    if (tw == 192 && v4)
      return bwd_as<T, 4, 192, kStreamed>(q, k, v, dout, lse, delta, dq, dk, dv, scratch, b, sq, skv, hq, hkv, d, scale, causal, stream);
  }
  if (tw == 256)
    return v4 ? bwd_as<T, 4, 256, kStreamed>(q, k, v, dout, lse, delta, dq, dk, dv, scratch, b, sq, skv, hq, hkv, d, scale, causal, stream)
              : bwd_as<T, 1, 256, kStreamed>(q, k, v, dout, lse, delta, dq, dk, dv, scratch, b, sq, skv, hq, hkv, d, scale, causal, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace simt
}  // namespace

// dtype kF32 or kBF16 (checked by the caller), as flash_attention.cu
// declares them; where simt_wide_route holds (the caller's dispatch). One
// tile (fp32, d 33-256) goes to flash_attention_simt_tile.cu.
namespace wide {
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int b, int sq, int skv, int hq, int hkv, int d,
               float scale, int causal, int dtype, cudaStream_t stream) {
  if (simt_wide_col_tiles(d) == 1)
    return dtype == kF32
               ? wide_tile::launch_fwd(q, k, v, o, lse, b, sq, skv, hq, hkv,
                                       d, scale, causal, stream)
               : static_cast<int>(cudaErrorInvalidValue);
  return dtype == kF32
             ? simt::launch_fwd<float>(q, k, v, o, lse, b, sq, skv, hq, hkv,
                                       d, scale, causal, stream)
             : simt::launch_fwd<__nv_bfloat16>(q, k, v, o, lse, b, sq, skv,
                                               hq, hkv, d, scale, causal,
                                               stream);
}

// scratch: simt_wide_kv_parts' partial sums of dK and dV (2 parts b skv
// hkv d floats) where the plan has more than one part, else unread.
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, void* dk,
               void* dv, void* scratch, int b, int sq, int skv, int hq,
               int hkv, int d, float scale, int causal, int dtype,
               cudaStream_t stream) {
  if (simt_wide_col_tiles(d) == 1)
    return dtype == kF32
               ? wide_tile::launch_bwd(q, k, v, dout, lse, delta, dq, dk, dv,
                                       scratch, b, sq, skv, hq, hkv, d, scale,
                                       causal, stream)
               : static_cast<int>(cudaErrorInvalidValue);
  return dtype == kF32
             ? simt::launch_bwd<float>(q, k, v, dout, lse, delta, dq, dk, dv,
                                       scratch, b, sq, skv, hq, hkv, d, scale,
                                       causal, stream)
             : simt::launch_bwd<__nv_bfloat16>(q, k, v, dout, lse, delta, dq,
                                               dk, dv, scratch, b, sq, skv,
                                               hq, hkv, d, scale, causal,
                                               stream);
}
}  // namespace wide
}  // namespace repro
