// RMSNorm over the last dim: y = x * rsqrt(mean(x^2) + eps) * w, with fp32
// statistics and an fp32 w.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (_rms_kernel), which tiles 256 rows into VMEM per grid step.
//
// Bound on the H100: bytes, 2 * rows * d * sizeof(T) + 4 * d over 3.35
// TB/s: 0.82 us at 333 x 2048 bf16, 0.47 us at 512 x 768, a few ns at the
// 4-row decode tick, where the kernel is one chain of latencies (load,
// reduce, store) after its launch and the arithmetic costs nothing.
// Design (the launch plan comes from kernels/rmsnorm.py::plan):
// * Each row is read once, in 16-byte loads (8 bf16 or 4 float a load;
//   w as float4s), all issued before the first use, and kept in
//   registers: NV chunks of 16 bytes a lane, a template parameter, so the
//   serve widths unroll fully (d 768 bf16: 3 a lane, d 2048: 8).
// * One warp per row up to 32 * 8 chunks (d 2048 bf16, 1024 fp32), the
//   sum of squares reduced by a 5-step xor butterfly with no shared memory
//   and no barrier, the output written from the registers. Several rows a
//   block, so 333-512 rows fill the card; one row a block at the 4-row
//   tick, so each row has an SM to itself.
// * Wider rows take WPR = 2, 4 or 8 warps a row and one exchange of the
//   warps' sums through shared memory. Chunks past what the registers hold
//   (d > 16384 bf16) are streamed: read for the sum, read again for the
//   output.
// * d not a multiple of the vector width, or a pointer not 16-byte
//   aligned (a contiguous view at an offset), takes the same kernel with
//   one element a chunk (scalar loads).
//
// Backward: the JAX package has no backward kernel; its gradient is
// jax.grad of the forward. With r = rsqrt(mean(x^2) + eps), in fp32:
//   dx = r * (w * dy) - x * r^3 * mean(x * w * dy), rounded once to x's dtype;
//   dw = sum over rows of dy * x * r.
// Bound: bytes, x and dy read and dx written once (3 * rows * d *
// sizeof(T)) plus w and dw: 2.8 us at 2048 x 768 bf16, 7.5 us at 2048 x
// 2048. r is recomputed from the row (the forward saves nothing). No
// floating-point atomics anywhere, so two calls are bitwise equal (a
// checkpoint resume is checked bit for bit). Three designs, as
// kernels/rmsnorm.py::bwd_design picks:
// * ring (rmsnorm_bwd_ring_kernel; 16-byte chunks, rows of up to 2048 of
//   them): one persistent block of 16 warps an SM, each block a contiguous
//   range of rows. Its row groups of WPR = 1, 2, 4, 8 or 16 warps (the
//   fewest that hold the row at NV <= 4 chunks a lane, so 128 registers a
//   thread do) take the range's rows in turn. Their rows' x and dy stream into the groups'
//   slots of a shared-memory ring, one 1-D bulk copy (TMA) of each a row
//   and one mbarrier a slot: every slot is filled at the block's start, so
//   up to 192 KB an SM are in flight at once (at 2048 x 768 bf16 a block's
//   whole share, 16 rows, 48 KB). A lane takes NV chunks of the
//   row; the row's two sums (x^2, x * w * dy) reduce by a warp butterfly,
//   across a group's warps through one exchange in shared memory, with no
//   block barrier a row; the group then refills the slot with its row spg
//   on. Each lane sums the dw of
//   its chunks over its group's rows in registers (w there too); the block
//   adds its groups' sums in group order into one fp32 partial row.
// * The partials' column sums, in block order, in the same launch after a
//   grid barrier: column slice j of dw (sw columns, dw_slice_width) is
//   summed by one block, thread t over the partials t / sw, t / sw +
//   512 / sw, ... of its column, then the 512 / sw sums of each column in
//   order. The launch is cooperative, so every block is resident, and the
//   barrier is cooperative groups' grid sync, whose word CUDA keeps
//   for each launch: launches on other streams, and graph replays, never
//   share it.
// * block_rows (rmsnorm_bwd_kernel + rmsnorm_dw_kernel, the first design):
//   one block of kBwdThreads a row at a time, rows in a fixed grid stride;
//   a thread owns chunks t + i * kBwdThreads of every row and sums its dw
//   in registers, the row's sums go through shared memory across 8 warps,
//   and rmsnorm_dw_kernel sums the blocks' partial rows in order. It takes
//   single-element chunks (d not a multiple of 16 bytes, or a misaligned
//   view), which bulk copies cannot, and 16-byte chunks up to 1024 a row so
//   the ring design can be timed against it.
// * stream (rmsnorm_bwd_stream_kernel + rmsnorm_dw_kernel): rows of any
//   width, 16-byte chunks or single elements; the rows the other two do
//   not take (more than 2048 chunks, or single elements past 2048). One
//   block of kBwdThreads a row at a time, as block_rows, but nothing of
//   the row is held: a first pass over its chunks for the two sums, a
//   second that reads x, dy and w again (from L2) to write dx and adds
//   each chunk's dw into the block's partial row in memory. A thread owns
//   the same columns of that row for every row, so no other thread
//   touches them and the sums keep a fixed order.
//
// Backward under lowp (bf16): jax.grad of ref.rmsnorm_lowp, whose multiply
// chain runs in bf16. With j = mean(x^2) + eps, r = rsqrt(j), inv =
// bf16(r) and g = bf16(dy * bf16(w)):
//   dx = bf16(bf16(g * inv) + bf16(c * 2x)), c = bf16(sum bf16(x * g)) *
//        (-r / (2 j)) / d;
//   dw = bf16(sum over rows of bf16(bf16(x * inv) * dy)).
// The sums run in fp32 and are rounded once (XLA on the CPU rounds a bf16
// sum after every add; the closed form ref.rmsnorm_lowp_bwd_ref rounds
// once, as here). In fp32 every rounding is the identity and lowp is the
// plain backward's arithmetic: lowp is a template flag of the bf16
// backward kernels only (with_lowp), so the unflagged ones keep their code.
//
// lowp: the JAX package's Pallas path drops `lowp` (src/repro/kernels/ops.py:59)
// and always computes in fp32. This kernel follows the reference-mode
// semantics instead (ref.rmsnorm_lowp), which the port's tests hold it to:
// inv = rsqrt(var + eps) is rounded to x's dtype, then x * inv and the
// product with w (also rounded to x's dtype) are each rounded to x's dtype.
#include <cooperative_groups.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

constexpr int kMaxThreads = 256;

// V elements of T as loaded and stored at once: 16 bytes (float4, or 8
// bf16 in a uint4), or one element.
template <typename T, int V>
using Raw = std::conditional_t<
    V == 1, T, std::conditional_t<std::is_same_v<T, float>, float4, uint4>>;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  if constexpr (V == 1) {
    return p[0];
  } else {
    return __ldg(reinterpret_cast<const Raw<T, V>*>(p));
  }
}

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> zero_raw() {
  if constexpr (V == 1) {
    return from_f32<T>(0.f);
  } else if constexpr (std::is_same_v<T, float>) {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    return make_uint4(0u, 0u, 0u, 0u);
  }
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& r, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = to_f32(r);
  } else if constexpr (std::is_same_v<T, float>) {
    f[0] = r.x; f[1] = r.y; f[2] = r.z; f[3] = r.w;
  } else {
    const uint32_t words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&words[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
}

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> pack(const float (&f)[V]) {
  if constexpr (V == 1) {
    return from_f32<T>(f[0]);
  } else if constexpr (std::is_same_v<T, float>) {
    return make_float4(f[0], f[1], f[2], f[3]);
  } else {
    uint32_t words[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      words[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    return make_uint4(words[0], words[1], words[2], words[3]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_raw(T* p, const Raw<T, V>& r) {
  *reinterpret_cast<Raw<T, V>*>(p) = r;
}

// V floats of w: float4s for a 16-byte chunk of x, else one float.
template <int V>
__device__ __forceinline__ void load_w(const float* p, float (&f)[V]) {
  if constexpr (V == 1) {
    f[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
      f[4 * i] = t.x; f[4 * i + 1] = t.y; f[4 * i + 2] = t.z;
      f[4 * i + 3] = t.w;
    }
  }
}

// One chunk of output. kLowp rounds as ref.rmsnorm_lowp: for 8 bf16 the
// products run on bf16 pairs (__hmul2: the exact product of two bf16
// values, rounded once, as torch's bf16 multiply); in float32 lowp
// changes nothing.
template <bool kLowp, typename T, int V>
__device__ __forceinline__ Raw<T, V> norm_chunk(const Raw<T, V>& x,
                                                const float (&w)[V],
                                                float inv) {
  if constexpr (kLowp && V == 8) {
    const __nv_bfloat162 inv2 = __float2bfloat162_rn(inv);
    const uint32_t xw[4] = {x.x, x.y, x.z, x.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 xi =
          __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&xw[i]), inv2);
      const __nv_bfloat162 y =
          __hmul2(xi, __floats2bfloat162_rn(w[2 * i], w[2 * i + 1]));
      o[i] = *reinterpret_cast<const uint32_t*>(&y);
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  } else {
    float f[V], y[V];
    unpack<T, V>(x, f);
    if constexpr (kLowp) {
      const float inv_t = to_f32(from_f32<T>(inv));
#pragma unroll
      for (int e = 0; e < V; ++e)
        y[e] = to_f32(from_f32<T>(f[e] * inv_t)) * to_f32(from_f32<T>(w[e]));
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) y[e] = f[e] * inv * w[e];
    }
    return pack<T, V>(y);
  }
}

// Rows of d = nchunks * V elements; each row is held by WPR warps (a "row
// group" of WPR * 32 threads), blockDim.x / (WPR * 32) rows a block. Lane t
// of a row group holds chunks t + i * WPR * 32, i < NV.
template <typename T, int V, int NV, int WPR>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, int rows, int d, float eps, int lowp) {
  constexpr int kRowThreads = WPR * 32;
  const int group = threadIdx.x / kRowThreads;
  const int t = threadIdx.x % kRowThreads;
  const int row = blockIdx.x * (blockDim.x / kRowThreads) + group;
  const bool live = row < rows;
  const int nchunks = d / V;
  const T* xr = x + static_cast<size_t>(live ? row : 0) * d;
  T* orow = out + static_cast<size_t>(live ? row : 0) * d;

  Raw<T, V> xv[NV];
  float wv[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = t + i * kRowThreads;
    const bool ok = live && c < nchunks;
    xv[i] = ok ? load_raw<T, V>(xr + c * V) : zero_raw<T, V>();
    if (ok) load_w<V>(w + c * V, wv[i]);
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float f[V];
    unpack<T, V>(xv[i], f);
#pragma unroll
    for (int e = 0; e < V; ++e) ss = fmaf(f[e], f[e], ss);
  }
  // Chunks the registers do not hold (rows wider than NV * WPR * 32).
#pragma unroll 1
  for (int c = t + NV * kRowThreads; live && c < nchunks; c += kRowThreads) {
    float f[V];
    unpack<T, V>(load_raw<T, V>(xr + c * V), f);
#pragma unroll
    for (int e = 0; e < V; ++e) ss = fmaf(f[e], f[e], ss);
  }
  ss = warp_sum(ss);
  if constexpr (WPR > 1) {
    __shared__ float partial[kMaxThreads / 32];
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int j = 0; j < WPR; ++j) ss += partial[group * WPR + j];
  }
  if (!live) return;
  const float inv = rsqrtf(ss / static_cast<float>(d) + eps);

  // The output, with lowp fixed for the whole row.
  auto write = [&](auto lowp_tag) {
    constexpr bool kLowp = decltype(lowp_tag)::value;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = t + i * kRowThreads;
      if (c < nchunks)
        store_raw<T, V>(orow + c * V,
                        norm_chunk<kLowp, T, V>(xv[i], wv[i], inv));
    }
#pragma unroll 1
    for (int c = t + NV * kRowThreads; c < nchunks; c += kRowThreads) {
      float wf[V];
      load_w<V>(w + c * V, wf);
      store_raw<T, V>(orow + c * V, norm_chunk<kLowp, T, V>(
                                        load_raw<T, V>(xr + c * V), wf, inv));
    }
  };
  if (lowp)
    write(std::true_type{});
  else
    write(std::false_type{});
}

template <typename T, int V, int NV, int WPR>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                   float eps, int lowp, int rows_per_block,
                   cudaStream_t s) {
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  rmsnorm_kernel<T, V, NV, WPR><<<blocks, rows_per_block * WPR * 32, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<T*>(out), rows, d, eps, lowp);
  return cudaGetLastError();
}

// The instantiated plans: 16-byte chunks with one warp a row and NV 1..8,
// or NV 8 and WPR 2, 4, 8; single elements with NV 8 and WPR 1, 2, 4, 8.
template <typename T>
cudaError_t dispatch(const void* x, const void* w, void* out, int rows,
                     int d, float eps, int lowp, int vec, int nv, int wpr,
                     int rpb, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    if (wpr == 1) {
      switch (nv) {
        case 1: return launch<T, V, 1, 1>(x, w, out, rows, d, eps, lowp, rpb, s);
        case 2: return launch<T, V, 2, 1>(x, w, out, rows, d, eps, lowp, rpb, s);
        case 3: return launch<T, V, 3, 1>(x, w, out, rows, d, eps, lowp, rpb, s);
        case 4: return launch<T, V, 4, 1>(x, w, out, rows, d, eps, lowp, rpb, s);
        case 5: return launch<T, V, 5, 1>(x, w, out, rows, d, eps, lowp, rpb, s);
        case 6: return launch<T, V, 6, 1>(x, w, out, rows, d, eps, lowp, rpb, s);
        case 7: return launch<T, V, 7, 1>(x, w, out, rows, d, eps, lowp, rpb, s);
        case 8: return launch<T, V, 8, 1>(x, w, out, rows, d, eps, lowp, rpb, s);
        default: return cudaErrorInvalidValue;
      }
    }
    if (nv != 8) return cudaErrorInvalidValue;
    switch (wpr) {
      case 2: return launch<T, V, 8, 2>(x, w, out, rows, d, eps, lowp, rpb, s);
      case 4: return launch<T, V, 8, 4>(x, w, out, rows, d, eps, lowp, rpb, s);
      case 8: return launch<T, V, 8, 8>(x, w, out, rows, d, eps, lowp, rpb, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (nv != 8) return cudaErrorInvalidValue;
  switch (wpr) {
    case 1: return launch<T, 1, 8, 1>(x, w, out, rows, d, eps, lowp, rpb, s);
    case 2: return launch<T, 1, 8, 2>(x, w, out, rows, d, eps, lowp, rpb, s);
    case 4: return launch<T, 1, 8, 4>(x, w, out, rows, d, eps, lowp, rpb, s);
    case 8: return launch<T, 1, 8, 8>(x, w, out, rows, d, eps, lowp, rpb, s);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---------------------------------------------------------------------------
// Backward.
// ---------------------------------------------------------------------------
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;

// v rounded to T and back (the identity for float).
template <typename T>
__device__ __forceinline__ float round_t(float v) {
  return to_f32(from_f32<T>(v));
}

// lowp takes effect in bf16 only: in fp32 it is the plain arithmetic.
template <typename T>
__device__ __forceinline__ bool lowp_of(int lowp) {
  return !std::is_same_v<T, float> && lowp != 0;
}

// f(std::true_type) for bf16 under lowp, else f(std::false_type): the
// backward kernels take lowp as a template parameter, so the unflagged
// instantiations keep their code and registers, and fp32 has no lowp
// instantiation at all (the flag is the plain arithmetic there).
template <typename T, typename F>
cudaError_t with_lowp(int lowp, F f) {
  if constexpr (std::is_same_v<T, float>) {
    return f(std::false_type{});
  } else {
    return lowp ? f(std::true_type{}) : f(std::false_type{});
  }
}

// A row's coefficients, from its sums ss = sum x^2 and sd = sum x w dy (or,
// under lowp, sum bf16(x g)).
struct BwdRow {
  float r;    // rsqrt(ss / d + eps)
  float k;    // plain: r^3 sd / d
  float inv;  // lowp: bf16(r)
  float c;    // lowp: bf16(sd) * (-r / (2 j)) / d
};

template <typename T>
__device__ __forceinline__ BwdRow bwd_row(float ss, float sd, int d,
                                          float eps, bool lowp) {
  BwdRow o;
  const float j = ss / static_cast<float>(d) + eps;
  o.r = rsqrtf(j);
  o.k = o.r * o.r * o.r * (sd / static_cast<float>(d));
  o.inv = o.c = 0.f;
  if (lowp) {
    o.inv = round_t<T>(o.r);
    o.c = round_t<T>(sd) * (-0.5f * (o.r / j)) / static_cast<float>(d);
  }
  return o;
}

// One element's term of the row's second sum.
template <typename T>
__device__ __forceinline__ float sd_add(float sd, float x, float w, float g,
                                        bool lowp) {
  if (lowp) return sd + round_t<T>(x * round_t<T>(g * round_t<T>(w)));
  return fmaf(x, w * g, sd);
}

// One element's dx, before the store rounds it to T.
template <typename T>
__device__ __forceinline__ float dx_of(const BwdRow& c, float x, float w,
                                       float g, bool lowp) {
  if (lowp)
    return round_t<T>(round_t<T>(g * round_t<T>(w)) * c.inv) +
           round_t<T>(c.c * (2.f * x));
  return c.r * (w * g) - x * c.k;
}

// One element's dw added to acc.
template <typename T>
__device__ __forceinline__ float dw_add(float acc, const BwdRow& c, float x,
                                        float g, bool lowp) {
  if (lowp) return acc + round_t<T>(round_t<T>(x * c.inv) * g);
  return fmaf(g, x * c.r, acc);
}

// A row's two sums across the block's kBwdWarps warps: each warp's by a
// butterfly, then the warps' in warp order. red: this row's [2][kBwdWarps]
// (rows alternate between two, so one barrier a row does).
__device__ __forceinline__ void block_sums(float& ss, float& sd,
                                           float (&red)[2][kBwdWarps],
                                           int warp, int lane) {
  ss = warp_sum(ss);
  sd = warp_sum(sd);
  if (lane == 0) {
    red[0][warp] = ss;
    red[1][warp] = sd;
  }
  __syncthreads();
  ss = 0.f;
  sd = 0.f;
#pragma unroll
  for (int j = 0; j < kBwdWarps; ++j) {
    ss += red[0][j];
    sd += red[1][j];
  }
}

// Rows of d = nchunks * V elements, one block a row at a time (rows
// blockIdx.x, + gridDim.x, ...); thread t holds chunks t + i * kBwdThreads,
// i < NV. dw_part: (gridDim.x, d) fp32, this block's sum of dy * x * r.
template <typename T, int V, int NV, bool kLowp>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const T* __restrict__ dy, T* __restrict__ dx,
                   float* __restrict__ dw_part, int rows, int d, float eps) {
  constexpr bool lowp = kLowp;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int nchunks = d / V;
  __shared__ float red[2][2][kBwdWarps];

  float wv[NV][V], acc[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = t + i * kBwdThreads;
    if (c < nchunks) {
      load_w<V>(w + c * V, wv[i]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) wv[i][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
  }

  int parity = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
    const size_t base = static_cast<size_t>(row) * d;
    float xf[NV][V], gf[NV][V];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = t + i * kBwdThreads;
      const bool ok = c < nchunks;
      unpack<T, V>(ok ? load_raw<T, V>(x + base + c * V) : zero_raw<T, V>(),
                   xf[i]);
      unpack<T, V>(ok ? load_raw<T, V>(dy + base + c * V) : zero_raw<T, V>(),
                   gf[i]);
    }
    float ss = 0.f, sd = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ss = fmaf(xf[i][e], xf[i][e], ss);
        sd = sd_add<T>(sd, xf[i][e], wv[i][e], gf[i][e], lowp);
      }
    block_sums(ss, sd, red[parity], warp, lane);
    const BwdRow co = bwd_row<T>(ss, sd, d, eps, lowp);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = t + i * kBwdThreads;
      if (c >= nchunks) continue;
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        o[e] = dx_of<T>(co, xf[i][e], wv[i][e], gf[i][e], lowp);
        acc[i][e] = dw_add<T>(acc[i][e], co, xf[i][e], gf[i][e], lowp);
      }
      store_raw<T, V>(dx + base + c * V, pack<T, V>(o));
    }
  }
  float* part = dw_part + static_cast<size_t>(blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = t + i * kBwdThreads;
    if (c >= nchunks) continue;
#pragma unroll
    for (int e = 0; e < V; ++e) part[c * V + e] = acc[i][e];
  }
}

// dw[c] = sum over b < nparts of part[b, c], in the same order every call
// (rounded to T once under lowp): a block takes 32 columns (one a lane,
// coalesced), warp j sums the partials j, j + 8, ..., and the warps' sums
// are added in warp order.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_dw_kernel(const float* __restrict__ part, float* __restrict__ dw,
                  int nparts, int d, int lowp_arg) {
  __shared__ float red[kBwdWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (c < d)
    for (int b = warp; b < nparts; b += kBwdWarps)
      s += part[static_cast<size_t>(b) * d + c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < d) {
    float tot = 0.f;
#pragma unroll
    for (int j = 0; j < kBwdWarps; ++j) tot += red[j][lane];
    dw[c] = lowp_of<T>(lowp_arg) ? round_t<T>(tot) : tot;
  }
}

// The partials' column sums (rmsnorm_dw_kernel) after a block_rows or
// stream launch.
template <typename T>
cudaError_t launch_dw(float* dw, const float* part, int blocks, int d,
                      int lowp, cudaStream_t s) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_dw_kernel<T><<<(d + 31) / 32, kBwdThreads, 0, s>>>(part, dw,
                                                              blocks, d,
                                                              lowp);
  return cudaGetLastError();
}

template <typename T, int V, int NV>
cudaError_t launch_bwd(const void* x, const void* w, const void* dy, void* dx,
                       float* dw, float* part, int rows, int d, float eps,
                       int lowp, int blocks, cudaStream_t s) {
  return with_lowp<T>(lowp, [&](auto lp) {
    rmsnorm_bwd_kernel<T, V, NV, decltype(lp)::value>
        <<<blocks, kBwdThreads, 0, s>>>(
            static_cast<const T*>(x), static_cast<const float*>(w),
            static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, d,
            eps);
    return launch_dw<T>(dw, part, blocks, d, lowp, s);
  });
}

// block_rows: NV 1, 2 or 4 chunks a thread of 16 bytes (vec), or 1, 2, 4
// or 8 of one element.
template <typename T>
cudaError_t dispatch_bwd(const void* x, const void* w, const void* dy,
                         void* dx, float* dw, float* part, int rows, int d,
                         float eps, int lowp, int vec, int nv, int blocks,
                         cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    switch (nv) {
      case 1: return launch_bwd<T, V, 1>(x, w, dy, dx, dw, part, rows, d, eps, lowp, blocks, s);
      case 2: return launch_bwd<T, V, 2>(x, w, dy, dx, dw, part, rows, d, eps, lowp, blocks, s);
      case 4: return launch_bwd<T, V, 4>(x, w, dy, dx, dw, part, rows, d, eps, lowp, blocks, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (nv) {
    case 1: return launch_bwd<T, 1, 1>(x, w, dy, dx, dw, part, rows, d, eps, lowp, blocks, s);
    case 2: return launch_bwd<T, 1, 2>(x, w, dy, dx, dw, part, rows, d, eps, lowp, blocks, s);
    case 4: return launch_bwd<T, 1, 4>(x, w, dy, dx, dw, part, rows, d, eps, lowp, blocks, s);
    case 8: return launch_bwd<T, 1, 8>(x, w, dy, dx, dw, part, rows, d, eps, lowp, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

// stream: rows of any width, d = nchunks * V elements (16-byte chunks or
// single elements). One block a row at a time (rows blockIdx.x, +
// gridDim.x, ...); thread t takes chunks t, t + kBwdThreads, ... of every
// row, in both passes: the first sums x^2 and the dw-side product, the
// second reads the chunks again to write dx and adds their dw into
// dw_part's row of this block, columns this thread alone touches.
template <typename T, int V, bool kLowp>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_stream_kernel(const T* __restrict__ x,
                          const float* __restrict__ w,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ dw_part, int rows, int d,
                          float eps) {
  constexpr bool lowp = kLowp;
  const int t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  const int nchunks = d / V;
  __shared__ float red[2][2][kBwdWarps];
  float* part = dw_part + static_cast<size_t>(blockIdx.x) * d;
  for (int c = t; c < nchunks; c += kBwdThreads)
#pragma unroll
    for (int e = 0; e < V; ++e) part[c * V + e] = 0.f;

  int parity = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
    const size_t base = static_cast<size_t>(row) * d;
    float ss = 0.f, sd = 0.f;
    for (int c = t; c < nchunks; c += kBwdThreads) {
      float xf[V], gf[V], wf[V];
      unpack<T, V>(load_raw<T, V>(x + base + c * V), xf);
      unpack<T, V>(load_raw<T, V>(dy + base + c * V), gf);
      load_w<V>(w + c * V, wf);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ss = fmaf(xf[e], xf[e], ss);
        sd = sd_add<T>(sd, xf[e], wf[e], gf[e], lowp);
      }
    }
    block_sums(ss, sd, red[parity], warp, lane);
    const BwdRow co = bwd_row<T>(ss, sd, d, eps, lowp);
    for (int c = t; c < nchunks; c += kBwdThreads) {
      float xf[V], gf[V], wf[V], o[V];
      unpack<T, V>(load_raw<T, V>(x + base + c * V), xf);
      unpack<T, V>(load_raw<T, V>(dy + base + c * V), gf);
      load_w<V>(w + c * V, wf);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        o[e] = dx_of<T>(co, xf[e], wf[e], gf[e], lowp);
        part[c * V + e] = dw_add<T>(part[c * V + e], co, xf[e], gf[e], lowp);
      }
      store_raw<T, V>(dx + base + c * V, pack<T, V>(o));
    }
  }
}

template <typename T>
cudaError_t dispatch_stream(const void* x, const void* w, const void* dy,
                            void* dx, float* dw, float* part, int rows,
                            int d, float eps, int lowp, int vec, int blocks,
                            cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  return with_lowp<T>(lowp, [&](auto lp) {
    constexpr bool L = decltype(lp)::value;
    auto run = [&](auto kernel) {
      kernel<<<blocks, kBwdThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const float*>(w),
          static_cast<const T*>(dy), static_cast<T*>(dx), part, rows, d,
          eps);
    };
    if (vec)
      run(rmsnorm_bwd_stream_kernel<T, V, L>);
    else
      run(rmsnorm_bwd_stream_kernel<T, 1, L>);
    return launch_dw<T>(dw, part, blocks, d, lowp, s);
  });
}

// ---------------------------------------------------------------------------
// Backward, ring design.
// ---------------------------------------------------------------------------
constexpr int kBlockRows = 0, kRing = 1, kStream = 2;  // design codes
constexpr int kRingWarps = 16;
constexpr int kRingThreads = kRingWarps * 32;
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block, sm_90

// Block b of `blocks` takes rows [ring_row(b), ring_row(b + 1)).
__device__ __forceinline__ int ring_row(int b, int rows, int blocks) {
  return static_cast<int>(static_cast<long long>(b) * rows / blocks);
}

__host__ __device__ __forceinline__ size_t ring_bars_bytes(int slots) {
  return (static_cast<size_t>(slots) * 8 + 127) / 128 * 128;
}

// Dynamic shared memory of a ring launch: one mbarrier a slot, padded to
// 128 bytes, then the slots, each an x row and a dy row. After the rows the
// same bytes hold the groups' dw sums (groups x d floats), then the column
// sums' kRingThreads floats.
__host__ __device__ __forceinline__ size_t ring_smem_bytes(int d, int esize,
                                                           int groups,
                                                           int spg) {
  const int slots = groups * spg;
  size_t ring = static_cast<size_t>(slots) * 2 * d * esize;
  const size_t sums = static_cast<size_t>(groups) * d * 4;
  if (ring < sums) ring = sums;
  if (ring < kRingThreads * 4) ring = kRingThreads * 4;
  return ring_bars_bytes(slots) + ring;
}

// Columns a block sums in the last phase: the least power of two from 32
// (a 128-byte line of each partial row) to kRingThreads at or above
// d / nparts, so the slices cover d in at most nparts blocks, and a thread
// loads at most nparts * 32 / kRingThreads partials at d <= 32 * nparts
// (9 at 132 partials: one batch of kSliceLoads).
__host__ __device__ __forceinline__ int dw_slice_width(int d, int nparts) {
  const int want = (d + nparts - 1) / nparts;
  int sw = 32;
  while (sw < want && sw < kRingThreads) sw *= 2;
  return sw;
}

// dw[c0, c0 + sw) = the sum over p < nparts of part[p, c] in a fixed
// order: thread t takes column c0 + t % sw and sums partials t / sw,
// t / sw + tpc, ... (tpc = kRingThreads / sw) in that order, loading
// kSliceLoads of them at once; then each column's tpc sums are added in
// order (rounded to T once under lowp). red: kRingThreads floats of shared
// memory.
constexpr int kSliceLoads = 16;

template <typename T>
__device__ __forceinline__ void dw_slice(const float* part, float* dw,
                                         int nparts, int d, int c0, int sw,
                                         float* red, bool lowp) {
  const int t = threadIdx.x, tpc = kRingThreads / sw;
  const int c = c0 + t % sw;
  float s = 0.f;
  if (c < d) {
    for (int p0 = t / sw; p0 < nparts; p0 += kSliceLoads * tpc) {
      float v[kSliceLoads];
#pragma unroll
      for (int u = 0; u < kSliceLoads; ++u) {
        const int p = p0 + u * tpc;
        v[u] = p < nparts ? __ldcg(part + static_cast<size_t>(p) * d + c)
                          : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kSliceLoads; ++u)
        if (p0 + u * tpc < nparts) s += v[u];
    }
  }
  red[t] = s;
  __syncthreads();
  if (t < sw && c < d) {
    float tot = 0.f;
#pragma unroll 8
    for (int q = 0; q < tpc; ++q) tot += red[q * sw + t];
    dw[c] = lowp ? round_t<T>(tot) : tot;
  }
  __syncthreads();
}

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_shared(const T* p) {
  return *reinterpret_cast<const Raw<T, V>*>(p);
}

// Rows of d = nchunks * V elements (16-byte chunks); a row group of WPR
// warps, lane t of it holding chunks t + i * WPR * 32, i < NV. part:
// (gridDim.x, d) fp32, this block's sum of dy * x * r; dw: (d,). spg:
// ring slots a group. A cooperative launch (the grid sync).
template <typename T, int NV, int WPR, bool kLowp>
__global__ void __launch_bounds__(kRingThreads, 1)
rmsnorm_bwd_ring_kernel(const T* __restrict__ x, const float* __restrict__ w,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ part, float* __restrict__ dw,
                        int rows, int d, float eps, int spg) {
  constexpr int V = 16 / sizeof(T);
  constexpr bool lowp = kLowp;
  constexpr int kRowThreads = WPR * 32;
  constexpr int kGroups = kRingWarps / WPR;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float xch[kRingWarps][2];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int g = tid / kRowThreads, t = tid % kRowThreads;
  const int nchunks = d / V;
  const int slots = kGroups * spg;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  T* ring = reinterpret_cast<T*>(smem + ring_bars_bytes(slots));
  const int r0 = ring_row(blockIdx.x, rows, gridDim.x);
  const int nrows = ring_row(blockIdx.x + 1, rows, gridDim.x) - r0;
  // This group's rows: r0 + g + k * kGroups, k < mine.
  const int mine = nrows > g ? (nrows - g + kGroups - 1) / kGroups : 0;
  const uint32_t row_bytes = static_cast<uint32_t>(d) * sizeof(T);

  // Row k of group gr into slot gr + kGroups * (k % spg): x, then dy.
  auto issue = [&](int gr, int k) {
    const int slot = gr + kGroups * (k % spg);
    const size_t row = static_cast<size_t>(r0 + gr + k * kGroups);
    T* dst = ring + static_cast<size_t>(slot) * 2 * d;
    mbar_expect_tx(&full[slot], 2 * row_bytes);
    bulk_load(dst, x + row * d, row_bytes, &full[slot]);
    bulk_load(dst + d, dy + row * d, row_bytes, &full[slot]);
  };
  // Thread s sets up slot s; after the barrier, lane k of each group fills
  // the group's slot for its row k (k < spg), all at once: a bulk copy
  // holds the thread that issues it, so one thread issuing every row's
  // would serialise them. Each group refills its own slots after.
  if (tid < slots) {
    mbar_init(&full[tid], 1);
    mbar_fence_init();
  }
  // w's loads go out before the rows' bulk copies, ahead of them in the
  // memory system's queues.
  float wv[NV][V], acc[NV][V];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = t + i * kRowThreads;
    if (c < nchunks) {
      load_w<V>(w + c * V, wv[i]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) wv[i][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) acc[i][e] = 0.f;
  }
  __syncthreads();
  if (t < spg && t < mine) issue(g, t);

  for (int k = 0; k < mine; ++k) {
    const int slot = g + kGroups * (k % spg);
    mbar_wait(&full[slot], (k / spg) & 1);
    const T* xs = ring + static_cast<size_t>(slot) * 2 * d;
    const T* gs = xs + d;
    float ss = 0.f, sd = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = t + i * kRowThreads;
      if (c >= nchunks) continue;
      float xf[V], gf[V];
      unpack<T, V>(load_shared<T, V>(xs + c * V), xf);
      unpack<T, V>(load_shared<T, V>(gs + c * V), gf);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ss = fmaf(xf[e], xf[e], ss);
        sd = sd_add<T>(sd, xf[e], wv[i][e], gf[e], lowp);
      }
    }
    ss = warp_sum(ss);
    sd = warp_sum(sd);
    if constexpr (WPR > 1) {
      if ((tid & 31) == 0) {
        xch[warp][0] = ss;
        xch[warp][1] = sd;
      }
      asm volatile("bar.sync %0, %1;\n" :: "r"(1 + g), "r"(kRowThreads)
                   : "memory");
      ss = 0.f;
      sd = 0.f;
#pragma unroll
      for (int j = 0; j < WPR; ++j) {
        ss += xch[g * WPR + j][0];
        sd += xch[g * WPR + j][1];
      }
    }
    const BwdRow co = bwd_row<T>(ss, sd, d, eps, lowp);
    T* out = dx + static_cast<size_t>(r0 + g + k * kGroups) * d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = t + i * kRowThreads;
      if (c >= nchunks) continue;
      float xf[V], gf[V], o[V];
      unpack<T, V>(load_shared<T, V>(xs + c * V), xf);
      unpack<T, V>(load_shared<T, V>(gs + c * V), gf);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        o[e] = dx_of<T>(co, xf[e], wv[i][e], gf[e], lowp);
        acc[i][e] = dw_add<T>(acc[i][e], co, xf[e], gf[e], lowp);
      }
      store_raw<T, V>(out + c * V, pack<T, V>(o));
    }
    // Every lane of the group has read the slot (and xch): refill it.
    if constexpr (WPR > 1)
      asm volatile("bar.sync %0, %1;\n" :: "r"(1 + g), "r"(kRowThreads)
                   : "memory");
    else
      __syncwarp();
    if (t == 0 && k + spg < mine) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(g, k + spg);
    }
  }

  // The groups' dw, added in group order into the block's partial row.
  __syncthreads();
  float* sums = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = t + i * kRowThreads;
    if (c >= nchunks) continue;
#pragma unroll
    for (int e = 0; e < V; e += 4)
      *reinterpret_cast<float4*>(sums + static_cast<size_t>(g) * d + c * V +
                                 e) =
          make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
  }
  __syncthreads();
  float* mine_part = part + static_cast<size_t>(blockIdx.x) * d;
  for (int c = tid; c < d; c += kRingThreads) {
    float s = sums[c];
#pragma unroll
    for (int j = 1; j < kGroups; ++j) s += sums[static_cast<size_t>(j) * d + c];
    mine_part[c] = s;
  }
  // The partial rows are written: sum their columns.
  cooperative_groups::this_grid().sync();
  const int sw = dw_slice_width(d, gridDim.x);
  for (int j = blockIdx.x; j * sw < d; j += gridDim.x)
    dw_slice<T>(part, dw, gridDim.x, d, j * sw, sw, sums, lowp);
}

template <typename T, int NV, int WPR>
cudaError_t launch_ring(const void* x, const void* w, const void* dy,
                        void* dx, float* dw, float* part, int rows, int d,
                        float eps, int lowp, int spg, int blocks,
                        cudaStream_t s) {
  const size_t smem = ring_smem_bytes(d, sizeof(T), kRingWarps / WPR, spg);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  return with_lowp<T>(lowp, [&](auto lp) {
    auto kernel = rmsnorm_bwd_ring_kernel<T, NV, WPR, decltype(lp)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kRingThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                             static_cast<const float*>(w),
                             static_cast<const T*>(dy), static_cast<T*>(dx),
                             part, dw, rows, d, eps, spg);
    return err == cudaSuccess ? cudaGetLastError() : err;
  });
}

// ring: NV 1..4 chunks a lane with one warp a row, or NV 4 with 2, 4, 8
// or 16 warps a row.
template <typename T>
cudaError_t dispatch_ring(const void* x, const void* w, const void* dy,
                          void* dx, float* dw, float* part, int rows, int d,
                          float eps, int lowp, int nv, int wpr, int spg,
                          int blocks, cudaStream_t s) {
#define REPRO_RING(NV, WPR) \
  launch_ring<T, NV, WPR>(x, w, dy, dx, dw, part, rows, d, eps, lowp, spg, \
                          blocks, s)
  if (wpr == 1) {
    switch (nv) {
      case 1: return REPRO_RING(1, 1);
      case 2: return REPRO_RING(2, 1);
      case 3: return REPRO_RING(3, 1);
      case 4: return REPRO_RING(4, 1);
      default: return cudaErrorInvalidValue;
    }
  }
  if (nv != 4) return cudaErrorInvalidValue;
  switch (wpr) {
    case 2: return REPRO_RING(4, 2);
    case 4: return REPRO_RING(4, 4);
    case 8: return REPRO_RING(4, 8);
    case 16: return REPRO_RING(4, 16);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_RING
}

}  // namespace
}  // namespace repro

// x, out: (rows, d) float32 or bfloat16 (dtype), w: (d,) float32, all
// contiguous. vec, nv, wpr, rows_per_block: the launch plan of
// kernels/rmsnorm.py::plan; vec needs d a multiple of 16 bytes and every
// pointer 16-byte aligned.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* out,
                             int rows, int d, float eps, int lowp, int dtype,
                             int vec, int nv, int wpr, int rows_per_block,
                             void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int esize = dtype == kF32 ? 4 : 2;
  if (rows <= 0 || d <= 0 || rows_per_block <= 0 ||
      rows_per_block * wpr * 32 > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((d * esize) % 16 || !aligned16(x) || !aligned16(w) ||
              !aligned16(out)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == kF32)
    err = dispatch<float>(x, w, out, rows, d, eps, lowp, vec, nv, wpr,
                          rows_per_block, s);
  else if (dtype == kBF16)
    err = dispatch<__nv_bfloat16>(x, w, out, rows, d, eps, lowp, vec, nv, wpr,
                                  rows_per_block, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// Backward of repro_rmsnorm: x, dy, dx (rows, d) in dtype, w and dw (d,)
// float32, part (blocks, d) float32 scratch; lowp: jax.grad of
// ref.rmsnorm_lowp in bf16 (ignored in fp32, where it is the plain
// arithmetic); design, vec, nv, wpr, spg, blocks: the plan of
// kernels/rmsnorm.py::bwd_plan. block_rows: d / (16 bytes or 1 element)
// chunks, at most nv * 256 of them, wpr and spg unused; launches
// rmsnorm_bwd_kernel, then rmsnorm_dw_kernel. ring: 16-byte chunks, at
// most nv * wpr * 32 of them, spg ring slots a row group, blocks <= rows
// and co-resident; launches rmsnorm_bwd_ring_kernel, cooperative. stream:
// any d, nv, wpr and spg unused; launches rmsnorm_bwd_stream_kernel, then
// rmsnorm_dw_kernel. All on the stream.
extern "C" int repro_rmsnorm_bwd(const void* x, const void* w,
                                 const void* dy, void* dx, void* dw,
                                 void* part, int rows, int d, float eps,
                                 int lowp, int dtype, int design, int vec,
                                 int nv, int wpr, int spg, int blocks,
                                 void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int esize = dtype == kF32 ? 4 : 2;
  const int nchunks = vec ? d * esize / 16 : d;
  const bool ring = design == kRing, streamed = design == kStream;
  if (rows <= 0 || d <= 0 || blocks <= 0 || blocks > rows ||
      (design != kBlockRows && !ring && !streamed) ||
      (ring && (!vec || spg <= 0)) ||
      (!streamed && nchunks > nv * (ring ? wpr * 32 : kBwdThreads)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec && ((d * esize) % 16 || !aligned16(x) || !aligned16(w) ||
              !aligned16(dy) || !aligned16(dx)))
    return static_cast<int>(cudaErrorInvalidValue);
  float* dwf = static_cast<float*>(dw);
  float* pf = static_cast<float*>(part);
  auto run = [&](auto zero) -> cudaError_t {
    using T = decltype(zero);
    if (ring)
      return dispatch_ring<T>(x, w, dy, dx, dwf, pf, rows, d, eps, lowp, nv,
                              wpr, spg, blocks, s);
    if (streamed)
      return dispatch_stream<T>(x, w, dy, dx, dwf, pf, rows, d, eps, lowp,
                                vec, blocks, s);
    return dispatch_bwd<T>(x, w, dy, dx, dwf, pf, rows, d, eps, lowp, vec,
                           nv, blocks, s);
  };
  cudaError_t err;
  if (dtype == kF32)
    err = run(0.f);
  else if (dtype == kBF16)
    err = run(__nv_bfloat16{});
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
