// Shared helpers of the two attention kernels (flash_attention.cu,
// decode_attention.cu): float32 <-> storage-type conversion, 16-byte
// vectors widened to float32, and the shared-memory opt-in.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace attn {

constexpr float kLog2e = 1.4426950408889634f;

// elements of T in one 16-byte load
template <typename T>
constexpr int kVec = 16 / sizeof(T);

// one 16-byte register vector of T widened to float32
__device__ __forceinline__ void unpack(const uint4& x, const float*,
                                       float* out) {
  out[0] = __uint_as_float(x.x);
  out[1] = __uint_as_float(x.y);
  out[2] = __uint_as_float(x.z);
  out[3] = __uint_as_float(x.w);
}

__device__ __forceinline__ void unpack(const uint4& x, const __nv_bfloat16*,
                                       float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  unpack(*reinterpret_cast<const uint4*>(p), p, out);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy `rows` rows of D elements (row r at src + r * stride, the D axis
// contiguous, 16-byte aligned) into shared memory as float32 rows of
// leading dimension ld, each row times `mul`. Rows rows..max_rows-1 are
// zero-filled so that a masked score never meets a stale value.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long stride, int rows,
                                          int max_rows, float mul, int tid,
                                          int nthreads) {
  constexpr int V = kVec<T>;
  constexpr int C = D / V;  // vectors per row
  for (int i = tid; i < max_rows * C; i += nthreads) {
    const int r = i / C, c = (i - r * C) * V;
    float x[V];
    if (r < rows) {
      load_vec(src + r * stride + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) dst[r * ld + c + e] = x[e] * mul;
  }
}

// Raise a kernel's dynamic shared-memory limit above 48 KB, once per
// device (the attribute is per device). Called before a launch, never
// during stream capture: the first call happens on the eager warm-up.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (*done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) *done |= bit;
  return err;
}

}  // namespace attn
