// Shared helpers of the two actor kernels (gcn_agg.cu, edge_score.cu):
// staging operands into shared memory (bulk copies of the Tensor Memory
// Accelerator on transaction barriers for contiguous runs, cp.async for
// rows), a division-free walk over a thread's items, a true divide that
// skips zero dividends, and the shared-memory opt-in.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace actor {

__host__ __device__ constexpr long long up4(long long x) {
  return (x + 3) / 4 * 4;
}
// a row length >= x holding an odd number of 16-byte chunks: float4 reads
// of rows 1 (or 4) apart fall in different banks
__host__ __device__ constexpr long long odd_ld(long long x) {
  return (x + 7) / 8 * 8 + 4;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// ------------------------------------------------------------ cp.async
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ------------------------------------------- bulk copies on an mbarrier
// A transaction barrier in shared memory (8 bytes): thread 0 initializes
// it for `count` arrivals; each arriving thread arms it with the bytes its
// bulk copies land (0 for none); every thread waits for the phase's parity.
__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
// make initialized barriers visible to the bulk-copy unit (then a
// __syncthreads makes them visible to the block)
__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_arm(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory by the Tensor Memory Accelerator, completing on bar. Its
// cost is per copy more than per byte: give it few, large runs, and issue
// them from threads of different warps.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// a thread of warp i (of a block of nt threads) to issue copies
__device__ __forceinline__ int issuer(int i, int nt) { return (i * 32) % nt; }

// A thread's items tid, tid + nt, ... of a grid with `cols` columns, as
// (row r, column c), walked without a division per item.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ Walk(int tid, int nt, int cols_) : cols(cols_) {
    if (cols <= 0) {
      r = 1 << 30;  // no items
      c = dr = dc = 0;
      return;
    }
    r = tid / cols;
    c = tid - r * cols;
    dr = nt / cols;
    dc = nt - dr * cols;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// rows x cols floats, row r from src + r * sld to dst + r * dld (dst 16-
// byte aligned, dld a multiple of 4), by cp.async from every thread:
// 16-byte copies when every source row starts on 16 bytes, else 4-byte
template <typename Src>
__device__ __forceinline__ void copy_rows(float* dst, int dld, Src src,
                                          bool vec, int rows, int cols,
                                          int tid, int nt) {
  const int sz = vec ? 4 : 1;
  for (Walk w(tid, nt, cols / sz); w.r < rows; w.next()) {
    float* d = dst + w.r * dld + w.c * sz;
    const float* s = src(w.r) + w.c * sz;
    if (vec)
      cp_async16(d, s);
    else
      cp_async4(d, s);
  }
}
__device__ __forceinline__ bool rows_vec(const float* src, long long sld,
                                         int cols) {
  return cols % 4 == 0 && sld % 4 == 0 && aligned16(src);
}

// rows x cols floats at src + r * sld to dst + r * dld, with one arrival
// on bar by thread `who`. Rows that are one contiguous run on both sides
// (sld == dld == cols), in whole 16-byte chunks on 16-byte boundaries, are
// one bulk copy, and `who` arrives with its bytes; otherwise every thread
// issues cp.async copies and `who` arrives with none (the caller waits for
// its cp.async group).
__device__ __forceinline__ void stage(float* dst, int dld, const float* src,
                                      long long sld, int rows, int cols,
                                      uint64_t* bar, int who, int tid,
                                      int nt) {
  const int n = rows * cols;
  if (sld == cols && dld == cols && n > 0 && n % 4 == 0 && aligned16(src)) {
    if (tid == who) {
      bar_arm(bar, (unsigned)(n * 4));
      bulk_copy(dst, src, (unsigned)(n * 4), bar);
    }
    return;
  }
  if (tid == who) bar_arm(bar, 0);
  copy_rows(dst, dld, [=](int r) { return src + r * sld; }, rows_vec(src, sld, cols),
            rows, cols, tid, nt);
}

// zero columns c0..c1-1 of `rows` rows of leading dimension ld
__device__ __forceinline__ void zero_cols(float* dst, int ld, int rows,
                                          int c0, int c1, int tid, int nt) {
  for (Walk w(tid, nt, c1 - c0); w.r < rows; w.next())
    dst[w.r * ld + c0 + w.c] = 0.f;
}

__device__ __forceinline__ float lane(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// x / d rounded as '/' rounds it. A zero x gives a signed zero without
// the division, whose check sends a zero dividend down its slow path
// (d finite and nonzero: 0 / d is then 0 with the sign of x * d).
__device__ __forceinline__ float quot(float x, float d) {
  return x == 0.f && d != 0.f && fabsf(d) != INFINITY ? x * copysignf(1.f, d)
                                                       : x / d;
}

// The card's largest dynamic shared memory for a block and the carveout
// that lets several such blocks share an SM, set for `kernel` once per
// device (`done` holds a bit per device).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, unsigned long long* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const unsigned long long bit = 1ull << (dev & 63);
  if (err != cudaSuccess || (*done & bit)) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    *done |= bit;
  else
    cudaGetLastError();  // clear it, so the next launch does not report it
  return err;
}

}  // namespace actor
