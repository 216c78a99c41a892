// RMSNorm over the last dim: y = x * rsqrt(mean(x^2) + eps) * w.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (_rms_kernel), which tiles 256 rows into VMEM per grid step.
//
// Bound on the H100: memory bytes. Each element is read once for the sum of
// squares and once more for the output (the second read hits L1/L2: a row
// is at most a few KB), and written once; the arithmetic is a few flops a
// byte. Design: one block of 256 threads per row, an fp32 sum of squares
// reduced across warps through shared memory, then one pass that writes
// the output. No padding of rows: the grid is exactly the row count.
//
// lowp: the JAX package's Pallas path drops `lowp` (src/repro/kernels/ops.py:59)
// and always computes in fp32. This kernel follows the reference-mode
// semantics instead (ref.rmsnorm_lowp), which the port's tests hold it to:
// inv = rsqrt(var + eps) is rounded to x's dtype, then x * inv and the
// product with w (also rounded to x's dtype) are each rounded to x's dtype.
// w is float32 in both modes.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ out, int d, float eps, int lowp) {
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  __shared__ float partial[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < kThreads / 32 ? partial[lane] : 0.f;
    ss = warp_sum(ss);
    if (lane == 0) partial[0] = ss;
  }
  __syncthreads();
  const float inv = rsqrtf(partial[0] / static_cast<float>(d) + eps);
  if (lowp) {
    const float inv_t = to_f32(from_f32<T>(inv));
    for (int i = threadIdx.x; i < d; i += kThreads) {
      const float xi = to_f32(from_f32<T>(to_f32(xr[i]) * inv_t));
      orow[i] = from_f32<T>(xi * to_f32(from_f32<T>(w[i])));
    }
  } else {
    for (int i = threadIdx.x; i < d; i += kThreads)
      orow[i] = from_f32<T>(to_f32(xr[i]) * inv * w[i]);
  }
}

}  // namespace
}  // namespace repro

extern "C" int repro_rmsnorm(const void* x, const void* w, void* out,
                             int rows, int d, float eps, int lowp, int dtype,
                             void* stream) {
  using namespace repro;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32) {
    rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), d, eps, lowp);
  } else if (dtype == kBF16) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
        static_cast<__nv_bfloat16*>(out), d, eps, lowp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
