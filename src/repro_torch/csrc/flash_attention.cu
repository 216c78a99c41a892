// Causal or full GQA attention for prefill: q (b, sq, hq, d), k/v
// (b, skv, hkv, d) -> o (b, sq, hq, d), fp32 online softmax.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (_fa_kernel), whose grid walks 128x128 q/kv tiles in order and carries the
// running max, sum and accumulator in VMEM scratch across the kv axis.
//
// Bound on the H100: at the serving path's prompt lengths (a few hundred
// tokens, 16 heads, d = 128) the bytes of q, k, v and o and the causal
// matmul work take about the same least time; this simple kernel runs its
// products on the CUDA cores in fp32, not on the tensor cores, so in
// practice it is bound by its own shared-memory reads and fp32 FMAs
// (wgmma, TMA and a warp-specialised pipeline are later work).
//
// Design: one block of 256 threads per (q tile of 64 rows, q head, batch).
// Blocks run in parallel in no order, so the kv loop is a loop inside the
// block: it stages one 64-row K tile and one V tile in shared memory (as
// fp32, rows padded by one word against bank conflicts) and stops at the
// diagonal when causal, so tiles above it are never read. Each thread owns
// 4 query rows and a 16-lane group shares a row, so the row max and sum of
// the online softmax reduce with four shuffles. The kv head of q head h is
// h / (hq / hkv), as in the JAX kernel's index map. Unlike the JAX kernel
// (which asserts sq % block_q == 0), this one masks the ragged edge itself:
// q rows >= sq are computed on zeros and never written, kv positions
// >= skv are masked, so any sq and skv are taken.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // kv rows per tile
constexpr int kThreads = 256; // 16 row groups x 16 lanes
constexpr int kRows = 4;      // query rows per thread (kBQ / 16)
constexpr int kCols = 4;      // score columns per thread (kBK / 16)

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kBQ) * (D + 1) +
                          2 * static_cast<size_t>(kBK) * (D + 1) +
                          static_cast<size_t>(kBQ) * (kBK + 1));
}

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int sq, int skv,
                 int hq, int hkv, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                 // kBQ x LD
  float* Ks = Qs + kBQ * LD;        // kBK x LD
  float* Vs = Ks + kBK * LD;        // kBK x LD
  float* Ps = Vs + kBK * LD;        // kBQ x (kBK + 1)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int rg = tid >> 4;   // row group: rows rg*4 .. rg*4+3
  const int lc = tid & 15;   // lane in the group

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int qi = q0 + r;
    Qs[r * LD + c] = qi < sq
        ? to_f32(q[((static_cast<size_t>(b) * sq + qi) * hq + h) * D + c])
        : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int r = idx / D, c = idx % D;
      const int ki = k0 + r;
      float kval = 0.f, vval = 0.f;
      if (ki < skv) {
        const size_t off =
            ((static_cast<size_t>(b) * skv + ki) * hkv + kvh) * D + c;
        kval = to_f32(k[off]);
        vval = to_f32(v[off]);
      }
      Ks[r * LD + c] = kval;
      Vs[r * LD + c] = vval;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = Qs[(rg * kRows + i) * LD + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = Ks[(lc + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + rg * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = k0 + lc + 16 * j;
        float val = s[i][j] * scale;
        if (col >= skv || (causal && col > row)) val = kNegInf;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      const float m_new = fmaxf(m[i], group16_max(mx));
      float rowsum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        rowsum += p;
        Ps[(rg * kRows + i) * (kBK + 1) + lc + 16 * j] = p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + group16_sum(rowsum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    const int kn = min(kBK, kv_end - k0);  // P is 0 past the valid columns
#pragma unroll 4
    for (int c = 0; c < kn; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = Ps[(rg * kRows + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const float vv = Vs[c * LD + lc + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] += pv[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + rg * kRows + i;
    if (row >= sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((static_cast<size_t>(b) * sq + row) * hq + h) * D;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      orow[lc + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int skv, int hq, int hkv, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, skv, hq, hkv, scale,
      causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* o,
               int b, int sq, int skv, int hq, int hkv, float scale,
               int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, sq, skv, hq, hkv, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, b, sq, skv, hq, hkv, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, b, sq, skv, hq, hkv, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, b, sq, skv, hq, hkv, scale, causal, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int b, int sq,
                                     int skv, int hq, int hkv, int d,
                                     float scale, int causal, int dtype,
                                     void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32)
    return dispatch_d<float>(d, q, k, v, o, b, sq, skv, hq, hkv, scale,
                             causal, s);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, o, b, sq, skv, hq, hkv,
                                     scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
