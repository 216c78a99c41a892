// W8A8 matmul: out[m, n] = (float(sum_k x_q[m, k] * w_q[k, n]) * sx[m]) * sw[n]
// with int8 operands, an exact int32 sum over k, and the epilogue in fp32
// in the reference's order (ref.int8_matmul_ref), stored as float32 or
// bfloat16.
//
// Replaces the TPU kernel src/repro/kernels/int8_matmul.py::int8_matmul
// (_mm_kernel), which accumulates 128 x 128 output blocks over K blocks of
// 512 in an int32 VMEM scratch and needs m, n, k divisible by its blocks.
// This kernel takes any m, k, n: the ragged edges load as zeros.
//
// Bound on the H100: at 333 x 2048 x 8192 (an MLP up projection of a
// 333-token prefill) the 11 GOP over 1979 TOP/s of int8 tensor cores take
// 5.6 us, the 23 MB of operands and bf16 output 6.8 us (28 MB, 8.5 us with
// a float32 output): bound by bytes, the two within 1.5x. Design,
// simple first: 64 x 64 output tiles, one block of 256 threads each, 4 x 4
// outputs a thread; k advances in steps of 64 bytes held in shared memory
// as 32-bit words of four k values (w transposed while it is stored), and
// __dp4a does four multiply-adds an instruction on the CUDA cores. The
// int8 tensor cores (mma.sync s8, wgmma) and TMA are later work.
#include <cstdint>

#include "common.cuh"

namespace repro {
namespace {

constexpr int kBM = 64, kBN = 64, kBK = 64;   // tile (k in bytes)
constexpr int kWords = kBK / 4;               // k words per tile row
constexpr int kLdw = kWords + 1;              // padded row, in words
constexpr int kThreads = 256;

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c,
                                     int8_t d) {
  return static_cast<int>((static_cast<uint32_t>(static_cast<uint8_t>(a))) |
                          (static_cast<uint32_t>(static_cast<uint8_t>(b)) << 8) |
                          (static_cast<uint32_t>(static_cast<uint8_t>(c)) << 16) |
                          (static_cast<uint32_t>(static_cast<uint8_t>(d)) << 24));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                   const int8_t* __restrict__ wq, const float* __restrict__ sw,
                   T* __restrict__ out, int m, int k, int n) {
  __shared__ int Xs[kBM * kLdw];   // [row][k word]
  __shared__ int Ws[kBN * kLdw];   // [col][k word], w transposed
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tm = tid / 16, tn = tid % 16;   // rows tm + 16 i, cols tn + 16 j
  int acc[4][4] = {};

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int w = tid; w < kBM * kWords; w += kThreads) {
      const int row = w / kWords, kw = w - row * kWords;
      const int gm = m0 + row, gk = k0 + kw * 4;
      int v = 0;
      if (gm < m) {
        const int8_t* src = xq + static_cast<size_t>(gm) * k + gk;
        if ((k & 3) == 0 && gk + 3 < k) {
          v = *reinterpret_cast<const int*>(src);
        } else {
          int8_t b[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) b[q] = gk + q < k ? src[q] : 0;
          v = pack4(b[0], b[1], b[2], b[3]);
        }
      }
      Xs[row * kLdw + kw] = v;
    }
    for (int w = tid; w < kBN * kWords; w += kThreads) {
      const int col = w % kBN, kw = w / kBN;
      const int gn = n0 + col, gk = k0 + kw * 4;
      int8_t b[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        b[q] = (gn < n && gk + q < k) ? wq[static_cast<size_t>(gk + q) * n + gn]
                                      : 0;
      Ws[col * kLdw + kw] = pack4(b[0], b[1], b[2], b[3]);
    }
    __syncthreads();
#pragma unroll 4
    for (int kw = 0; kw < kWords; ++kw) {
      int a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Xs[(tm + 16 * i) * kLdw + kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = Ws[(tn + 16 * j) * kLdw + kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + tm + 16 * i;
    if (gm >= m) continue;
    const float rs = sx[gm];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tn + 16 * j;
      if (gn >= n) continue;
      // (acc * sx) * sw, each product rounded to fp32: the reference's order
      const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), rs),
                                sw[gn]);
      out[static_cast<size_t>(gm) * n + gn] = from_f32<T>(v);
    }
  }
}

}  // namespace
}  // namespace repro

// x_q: (m, k) int8, sx: (m,) f32, w_q: (k, n) int8, sw: (n,) f32,
// out: (m, n) float32 or bfloat16 (out_dtype); all contiguous.
extern "C" int repro_int8_matmul(const void* xq, const void* sx,
                                 const void* wq, const void* sw, void* out,
                                 int m, int k, int n, int out_dtype,
                                 void* stream) {
  using namespace repro;
  if (m <= 0 || k <= 0 || n <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const int8_t* x8 = static_cast<const int8_t*>(xq);
  const int8_t* w8 = static_cast<const int8_t*>(wq);
  const float* sxf = static_cast<const float*>(sx);
  const float* swf = static_cast<const float*>(sw);
  if (out_dtype == kF32)
    int8_matmul_kernel<float><<<grid, kThreads, 0, st>>>(
        x8, sxf, w8, swf, static_cast<float*>(out), m, k, n);
  else if (out_dtype == kBF16)
    int8_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        x8, sxf, w8, swf, static_cast<__nv_bfloat16*>(out), m, k, n);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
