// Decode attention: one query token per (batch, q head) against a KV cache,
// q (b, hq, d), k/v (b, skv, hkv, d), length (b,) int32 -> o (b, hq, d).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::decode_attention
// (_dec_kernel), which walks kv blocks of 256 in order with the valid
// length brought in by scalar prefetch, skips blocks at or past it and
// masks the positions past it.
//
// Bound on the H100: memory bytes. Every K and V element below length[b]
// is read once for two multiply-adds per query head that shares it, so
// the work is a fraction of a flop per byte.
//
// Design: one block of 8 warps per (kv head, batch). The block serves the
// G = hq / hkv query heads that share the kv head, so each K/V row is
// loaded once for all of them. Each block reads its own length[b] (the
// scalar prefetch of the TPU kernel), clamps it to skv and never reads a
// cache row at or past it. Warp w takes rows w, w + 8, ...; it loads four
// rows ahead before it uses them, so loads overlap. A lane holds d / 32
// consecutive dims (one per lane, lanes >= d idle, when d < 32); a warp
// reduces each dot product with shuffles and keeps its own fp32 running
// max, sum and accumulator. The eight warps' partial softmaxes are then
// combined through shared memory. length 0 gives l == 0, which maps to
// an output of zeros, as in the JAX kernel. Any skv is taken (the JAX kernel
// asserts skv % 256 == 0); split-KV across blocks is later work.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kAhead = 4;  // cache rows a warp loads before it uses them

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ length,
              T* __restrict__ o, int skv, int hq, int hkv, float scale) {
  constexpr int VEC = D >= 32 ? D / 32 : 1;   // dims per lane
  constexpr int ACTIVE = D / VEC;             // lanes that hold dims
  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool active = lane < ACTIVE;
  const int len = min(max(length[b], 0), skv);

  float qv[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (active) {
      load_vec<VEC>(q + (static_cast<size_t>(b) * hq + kvh * G + g) * D +
                        lane * VEC, qv[g]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qv[g][e] = 0.f;
    }
  }

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const size_t row_stride = static_cast<size_t>(hkv) * D;
  const T* kbase = k + static_cast<size_t>(b) * skv * row_stride +
                   static_cast<size_t>(kvh) * D + lane * VEC;
  const T* vbase = v + static_cast<size_t>(b) * skv * row_stride +
                   static_cast<size_t>(kvh) * D + lane * VEC;

  for (int t0 = warp; t0 < len; t0 += kWarps * kAhead) {
    float kr[kAhead][VEC], vr[kAhead][VEC];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int t = t0 + a * kWarps;
      if (active && t < len) {
        load_vec<VEC>(kbase + t * row_stride, kr[a]);
        load_vec<VEC>(vbase + t * row_stride, vr[a]);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kr[a][e] = vr[a][e] = 0.f;
      }
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      if (t0 + a * kWarps >= len) break;  // uniform across the warp
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot += qv[g][e] * kr[a][e];
        const float s = warp_sum(dot) * scale;
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = alpha * l[g] + p;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][e] = alpha * acc[g][e] + p * vr[a][e];
        m[g] = m_new;
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
    if (active) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][g][lane * VEC + e] = acc[g][e];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, dd = idx % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][g]);
    float lsum = 0.f, osum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][g] - mx);
      lsum += sm_l[w][g] * f;
      osum += sm_acc[w][g][dd] * f;
    }
    if (lsum == 0.f) lsum = 1.f;
    o[(static_cast<size_t>(b) * hq + kvh * G + g) * D + dd] =
        from_f32<T>(osum / lsum);
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* length,
           void* o, int b, int skv, int hq, int hkv, float scale,
           cudaStream_t stream) {
  const dim3 grid(hkv, b);
  decode_kernel<T, D, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), length, static_cast<T*>(o), skv, hq, hkv,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_g(int g, const void* q, const void* k, const void* v,
               const int* length, void* o, int b, int skv, int hq, int hkv,
               float scale, cudaStream_t s) {
  switch (g) {
    case 1: return launch<T, D, 1>(q, k, v, length, o, b, skv, hq, hkv, scale, s);
    case 2: return launch<T, D, 2>(q, k, v, length, o, b, skv, hq, hkv, scale, s);
    case 4: return launch<T, D, 4>(q, k, v, length, o, b, skv, hq, hkv, scale, s);
    case 8: return launch<T, D, 8>(q, k, v, length, o, b, skv, hq, hkv, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_d(int d, int g, const void* q, const void* k, const void* v,
               const int* length, void* o, int b, int skv, int hq, int hkv,
               float scale, cudaStream_t s) {
  switch (d) {
    case 16: return dispatch_g<T, 16>(g, q, k, v, length, o, b, skv, hq, hkv, scale, s);
    case 32: return dispatch_g<T, 32>(g, q, k, v, length, o, b, skv, hq, hkv, scale, s);
    case 64: return dispatch_g<T, 64>(g, q, k, v, length, o, b, skv, hq, hkv, scale, s);
    case 128: return dispatch_g<T, 128>(g, q, k, v, length, o, b, skv, hq, hkv, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, const void* length,
                                      void* o, int b, int skv, int hq,
                                      int hkv, int d, float scale, int dtype,
                                      void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* len = static_cast<const int*>(length);
  const int g = hq / hkv;
  if (dtype == kF32)
    return dispatch_d<float>(d, g, q, k, v, len, o, b, skv, hq, hkv, scale, s);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(d, g, q, k, v, len, o, b, skv, hq, hkv,
                                     scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
