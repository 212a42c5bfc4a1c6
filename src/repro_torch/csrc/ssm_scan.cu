// Chunked gated linear recurrence (RWKV-6 WKV / Mamba-2 SSD) for Hopper
// (sm_90a): bfloat16 or float32 q/k/v, float32 decays, bonus and state,
// output in the input type. Two kernels: bf16 on the tensor cores, f32 on
// the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py:93 (ssm_scan,
// Pallas body `_kernel`, :31-89), and adds what the model-level function
// repro/models/ssm.py::chunked_linear_attn adds around it: an initial
// state and the final state as a second output (prefill hands it to
// decode). For q, k, log_w [B,T,H,dk], v [B,T,H,dv], per (b, h):
//   S_t = diag(exp(log_w_t)) S_{t-1} + k_t^T v_t      (S [dk, dv], S_0 given)
//   Mamba (no bonus):  y_t = q_t S_t
//   RWKV (bonus u):    y_t = q_t S_{t-1} + (q_t * u * k_t) . v_t
//
// What bounds it on the H100: bytes. At RWKV-6-7B's prefill shape
// ([4, 2048, 64 heads, 64, 64], chunk 128, bf16) the function moves
// ~0.41 GB (q/k/v/y in bf16, decays in f32), 121.45 us at 3.35 TB/s; its
// recurrence needs 5 dk dv operations per token and head, ~10.7 GFLOP,
// ~11 us at the bf16 tensor-core rate. The chunked form does more: ~19
// GFLOP of products and ~0.4 G exps, most of them on the diagonal
// sub-blocks, which stay exact in log space (~0.1 ms of the SFUs at the
// prefill shape).
//
// Both kernels: one block of 256 threads per (head, sequence); the TPU
// grid's sequential chunk axis becomes a loop over chunks of c rows inside
// the block (at the prefill shape 256 blocks fill the card). q/k/v/log_w
// are read through their [B,T,H,d] strides (no head-major copy). Per chunk
// (cum = inclusive cumsum of log_w, qe = cum for Mamba, cum - log_w for
// RWKV), for each 16-row sub-block t:
//   diagonal 16x16 pairs exactly in log space:
//     A[i][j] = sum_d q_i exp(qe_i - cum_j) k_j  (j < i RWKV, j <= i Mamba)
//     plus (q_i * u * k_i) on i == j (RWKV);
//   earlier rows j < 16 t through anchored products (below);
//   y_i = sum_j A[i][j] v_j + (q_i exp(qe_i)) S;
//   S = S exp(cum[c-1]) + sum_j (k_j exp(cum[c-1] - cum_j))^T v_j.
// One difference from the TPU kernel: cumsums are kept per sub-block (with
// each sub-block's total and the sums of the earlier and later totals),
// and every exponent is assembled from them, so two cumsums are only
// subtracted within one sub-block. Subtracting chunk-wide cumsums, as the
// reference does, loses precision in proportion to their size, ~-145 at
// the end of a 128-row chunk of fast decays. Every exponent is <= 0
// (decays are <= 0), so nothing overflows and no decay is clamped.
//
// bf16 (ssm_scan_bf16_kernel): products on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 accumulators), one warp per sub-block.
// * q, k, v are staged in shared memory in bf16 as they arrive (16-byte
//   loads), in rows whose 16-byte chunks are XOR-swizzled by row so that
//   ldmatrix and the fragment loads meet no bank conflict; log_w is staged
//   in float32, times log2(e), and turned into the per-sub-block cumsum
//   tables in place; exps are ex2.approx.
// * The 8 warps take the chunk's 8 sub-blocks at once (no series loop;
//   six barriers per chunk). Warp t accumulates its 16 y rows x dv in mma
//   accumulators:
//   - diagonal (s = t) on the CUDA cores, exact in log space: each lane
//     computes the (i, j) entries it holds of the m16n8k16 A fragment, so
//     the block never goes through shared memory; rounded to bf16, times
//     V_t on the tensor cores;
//   - earlier sub-blocks s < t, anchored at the END of s: k is staged once
//     per chunk as k_j exp(tot_s - cum_j) (rest of s after j) in bf16, and
//     warp t forms q_i exp(qe_i + (sub-blocks s+1 .. t-1)) in registers,
//     the middle sum a difference of suffix sums (exactly 0 for s = t-1);
//     both exponents <= 0. A = q^ k^T in f32, rounded to bf16 in
//     registers (the accumulator fragment reused as the A operand, as
//     flash's P), times V_s;
//   - the carried-state read (q_i exp(qe_i + earlier sub-blocks)) S from a
//     bf16 copy of S written once per chunk.
// * The state update runs on the tensor cores at float32 precision, as the
//   f32 gate on the final state requires: S is split over the 8 warps as
//   mma accumulators (16 floats a thread at dk = dv = 64), kept in
//   registers across chunks and written out once. k_out = k exp(tot -
//   cum) is split into bf16 hi + lo (relative error ~2^-16; V is exact in
//   bf16) and both run into the same accumulators, operands by
//   ldmatrix.trans; the exp(tot) row scale goes on the accumulators first.
// * Shared memory at c = 128, dk = dv = 64: q, k, anchored k (then k_out
//   lo), v and the bf16 state 72 KB, the f32 cumsums 34 KB, tables 7 KB:
//   115,456 bytes, so two blocks share an SM (__launch_bounds__(256, 2))
//   and the prefill's 256 blocks run in one wave. The q and anchored-k
//   buffers take k_out hi and lo after the y rows are written. The
//   chunk's loads are synchronous; the second block on the SM overlaps
//   them. dk or dv of 8 is padded to 16 with zeros (zero products are
//   exact), a chunk below 16 rows to one zero-padded sub-block.
//
// f32 (ssm_scan_kernel, the first design): tensor cores on float32 inputs
// would run TF32 (~3 decimal digits), which breaks the float32 gates of
// 1e-4, so float32 stays on the CUDA cores. The chunk's q, k, v, cumsums
// and anchored k are staged in shared memory as float32 rows padded to
// dk + 4 (dv + 4) floats, and the sub-blocks run in series with the state
// in shared memory; each thread accumulates a 4-row (score, y) or 4x4
// (state) tile in registers. ~213 KB of shared memory at c = 128, dk = dv
// = 64, one block per SM.
//
// A request the card cannot hold (c = 256 at dk = dv = 64 in float32) is
// refused at the launch.
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSub = 16;  // sub-block rows (the TPU kernel's _SUB)

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int DK, int DV>
size_t smem_bytes(int c) {
  constexpr int LK = DK + 4, LV = DV + 4;
  const int n_sub = c < kSub ? 1 : c / kSub;
  return sizeof(float) * ((size_t)4 * c * LK + (size_t)c * LV + DK * DV +
                          2 * kSub * LK + DK * kSub + (size_t)c * kSub +
                          (size_t)(3 * n_sub + 1) * LK);
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(kThreads, 1)  // one block per SM fits
    ssm_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u, const float* __restrict__ s0,
                    T* __restrict__ y, float* __restrict__ s_out,
                    long long q_sb, long long q_st, long long q_sh,
                    long long k_sb, long long k_st, long long k_sh,
                    long long v_sb, long long v_st, long long v_sh,
                    long long w_sb, long long w_st, long long w_sh,
                    long long y_sb, long long y_st, long long y_sh, int T_len,
                    int H, int c) {
  constexpr int LK = DK + 4, LV = DV + 4;
  extern __shared__ __align__(16) float smem[];
  const int U = c < kSub ? c : kSub;  // a chunk below 16 rows is one sub-block
  const int n_sub = c / U;
  float* s_k = smem;                  // [c][LK] k of the chunk
  float* s_loc = s_k + c * LK;        // [c][LK] log_w cumsum within sub-block
  float* s_kx = s_loc + c * LK;       // [c][LK] anchored k, then k_out
  float* s_q = s_kx + c * LK;         // [c][LK] q of the chunk
  float* s_v = s_q + c * LK;          // [c][LV]
  float* s_S = s_v + c * LV;          // [DK][DV] carried state
  float* s_qe = s_S + DK * DV;        // [16][LK] q-side exponent
  float* s_qin = s_qe + kSub * LK;    // [16][LK] q exp(qe - base)
  float* s_qsT = s_qin + kSub * LK;   // [DK][16] q exp(qe), transposed
  float* s_aT = s_qsT + DK * kSub;    // [c][16] scores, transposed
  float* s_tot = s_aT + c * kSub;     // [n_sub][LK] sub-block log decay
  float* s_pre = s_tot + n_sub * LK;  // [n_sub + 1][LK] sum of earlier ones
  float* s_suf = s_pre + (n_sub + 1) * LK;  // [n_sub][LK] of later ones

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const bool rwkv = u != nullptr;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;
  const float* wb = w + b * w_sb + h * w_sh;
  T* yb = y + b * y_sb + h * y_sh;
  const long long sbase = ((long long)b * H + h) * DK * DV;

  for (int i = tid; i < DK * DV; i += kThreads)
    s_S[i] = s0 ? s0[sbase + i] : 0.f;
  // rows U..15 of the sub-block buffers stay zero (read, never used)
  for (int i = tid; i < 2 * kSub * LK + DK * kSub + c * kSub; i += kThreads)
    s_qe[i] = 0.f;

  for (int c0 = 0; c0 < T_len; c0 += c) {
    __syncthreads();  // the previous chunk's readers are done
    // the chunk's rows, many independent loads in flight per thread
#pragma unroll 4
    for (int i = tid; i < c * DK; i += kThreads) {
      const int r = i / DK, d = i - r * DK;
      s_k[r * LK + d] = to_f32(kb[(c0 + r) * k_st + d]);
      s_q[r * LK + d] = to_f32(qb[(c0 + r) * q_st + d]);
      s_loc[r * LK + d] = wb[(c0 + r) * w_st + d];
    }
#pragma unroll 4
    for (int i = tid; i < c * DV; i += kThreads) {
      const int r = i / DV, e = i - r * DV;
      s_v[r * LV + e] = to_f32(vb[(c0 + r) * v_st + e]);
    }
    __syncthreads();
    // inclusive cumsum of log_w within each sub-block (L), then per
    // sub-block its total, the sum of the earlier ones and of the later
    // ones. Every exponent below is built from these so that a difference
    // of two cumsums is only ever taken within one sub-block (see above).
    for (int it = tid; it < n_sub * DK; it += kThreads) {
      const int sb = it / DK, d = it - sb * DK;
      float acc = 0.f;
      for (int r = sb * U; r < (sb + 1) * U; ++r) {
        acc += s_loc[r * LK + d];
        s_loc[r * LK + d] = acc;
      }
      s_tot[sb * LK + d] = acc;
    }
    __syncthreads();
    for (int d = tid; d < DK; d += kThreads) {
      float pre = 0.f, suf = 0.f;
      for (int sb = 0; sb < n_sub; ++sb) {
        s_pre[sb * LK + d] = pre;
        pre += s_tot[sb * LK + d];
        const int sr = n_sub - 1 - sb;
        s_suf[sr * LK + d] = suf;
        suf += s_tot[sr * LK + d];
      }
      s_pre[n_sub * LK + d] = pre;  // the chunk's total log decay
    }

    for (int lo = 0, t = 0; lo < c; lo += U, ++t) {
      __syncthreads();  // the tables are complete; the last sub-block is done
      for (int i = tid; i < U * DK; i += kThreads) {
        const int r = i / DK, d = i - r * DK;
        const float qv = s_q[(lo + r) * LK + d];
        // q-side exponent from the sub-block's start: inclusive (Mamba)
        // or exclusive (RWKV) cumsum
        const float qe = rwkv ? (r > 0 ? s_loc[(lo + r - 1) * LK + d] : 0.f)
                              : s_loc[(lo + r) * LK + d];
        s_qe[r * LK + d] = qe;
        s_qin[r * LK + d] = qv * expf(qe);
        s_qsT[d * kSub + r] = qv * expf(qe + s_pre[t * LK + d]);
      }
      // rows j of earlier sub-blocks sb, anchored at this one's start:
      // exponent (rest of sb after j) + (sub-blocks sb+1 .. t-1); the
      // latter as a difference of suffix sums, exactly 0 for sb = t-1 and
      // otherwise at least one whole sub-block of decay
      for (int i = tid; i < lo * DK; i += kThreads) {
        const int j = i / DK, d = i - j * DK, sb = j / U;
        const float gap = (s_tot[sb * LK + d] - s_loc[j * LK + d]) +
                          (s_suf[sb * LK + d] - s_suf[(t - 1) * LK + d]);
        s_kx[j * LK + d] = s_k[j * LK + d] * expf(gap);
      }
      __syncthreads();

      // diagonal sub-block: one (i, j) pair per thread, exact in log space
      {
        const int i = tid / kSub, jj = tid - i * kSub;
        if (i < U && jj < U) {
          float a = 0.f;
          if (rwkv ? jj < i : jj <= i) {
            const float* qr = s_q + (lo + i) * LK;
            const float* qer = s_qe + i * LK;
            const float* cr = s_loc + (lo + jj) * LK;
            const float* kr = s_k + (lo + jj) * LK;
#pragma unroll 4
            for (int d = 0; d < DK; d += 4) {
              const float4 qv = ld4(qr + d), qe = ld4(qer + d),
                           cm = ld4(cr + d), kv = ld4(kr + d);
              a = fmaf(qv.x * expf(qe.x - cm.x), kv.x, a);
              a = fmaf(qv.y * expf(qe.y - cm.y), kv.y, a);
              a = fmaf(qv.z * expf(qe.z - cm.z), kv.z, a);
              a = fmaf(qv.w * expf(qe.w - cm.w), kv.w, a);
            }
          }
          if (rwkv && jj == i) {
            const float* qr = s_q + (lo + i) * LK;
            const float* kr = s_k + (lo + i) * LK;
            const float* ur = u + h * DK;
            for (int d = 0; d < DK; ++d) a = fmaf(qr[d] * ur[d], kr[d], a);
          }
          s_aT[(lo + jj) * kSub + i] = a;
        }
      }
      // earlier rows of the chunk: 4 rows x 1 column per item
      for (int it = tid; it < 4 * lo; it += kThreads) {
        const int rg = it / lo, j = it - rg * lo;
        const float* kr = s_kx + j * LK;
        const float* qr = s_qin + 4 * rg * LK;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
        for (int d = 0; d < DK; d += 4) {
          const float4 kv = ld4(kr + d);
          a0 = dot4(ld4(qr + d), kv, a0);
          a1 = dot4(ld4(qr + LK + d), kv, a1);
          a2 = dot4(ld4(qr + 2 * LK + d), kv, a2);
          a3 = dot4(ld4(qr + 3 * LK + d), kv, a3);
        }
        *reinterpret_cast<float4*>(s_aT + j * kSub + 4 * rg) =
            make_float4(a0, a1, a2, a3);
      }
      __syncthreads();

      // y rows lo..lo+U: 4 rows x 1 column per item
      const int n = lo + U;
      for (int it = tid; it < 4 * DV; it += kThreads) {
        const int rg = it / DV, e = it - rg * DV;
        if (4 * rg >= U) continue;
        float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll 4
        for (int j = 0; j < n; ++j) {
          const float4 a = ld4(s_aT + j * kSub + 4 * rg);
          const float vj = s_v[j * LV + e];
          y0 = fmaf(a.x, vj, y0);
          y1 = fmaf(a.y, vj, y1);
          y2 = fmaf(a.z, vj, y2);
          y3 = fmaf(a.w, vj, y3);
        }
        float z0 = 0.f, z1 = 0.f, z2 = 0.f, z3 = 0.f;  // carried-state read
#pragma unroll 8
        for (int d = 0; d < DK; ++d) {
          const float4 a = ld4(s_qsT + d * kSub + 4 * rg);
          const float sd = s_S[d * DV + e];
          z0 = fmaf(a.x, sd, z0);
          z1 = fmaf(a.y, sd, z1);
          z2 = fmaf(a.z, sd, z2);
          z3 = fmaf(a.w, sd, z3);
        }
        T* yr = yb + (c0 + lo + 4 * rg) * y_st + e;
        yr[0] = attn::from_f32<T>(y0 + z0);  // the rows below U
        if (4 * rg + 1 < U) yr[y_st] = attn::from_f32<T>(y1 + z1);
        if (4 * rg + 2 < U) yr[2 * y_st] = attn::from_f32<T>(y2 + z2);
        if (4 * rg + 3 < U) yr[3 * y_st] = attn::from_f32<T>(y3 + z3);
      }
    }

    // state update: S = S exp(tot) + sum_j (k_j exp(tot - cum_j))^T v_j,
    // tot - cum_j = (rest of j's sub-block after j) + (later sub-blocks)
    __syncthreads();
    const float* tot = s_pre + n_sub * LK;
    for (int i = tid; i < c * DK; i += kThreads) {
      const int j = i / DK, d = i - j * DK, sb = j / U;
      s_kx[j * LK + d] =
          s_k[j * LK + d] * expf(s_tot[sb * LK + d] - s_loc[j * LK + d] +
                                 s_suf[sb * LK + d]);
    }
    __syncthreads();
    for (int it = tid; it < (DK / 4) * (DV / 4); it += kThreads) {
      const int dg = it / (DV / 4), eg = it - dg * (DV / 4);
      const int d0 = 4 * dg, e0 = 4 * eg;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float decay = expf(tot[d0 + r]);
        const float4 s = ld4(s_S + (d0 + r) * DV + e0);
        acc[r][0] = s.x * decay;
        acc[r][1] = s.y * decay;
        acc[r][2] = s.z * decay;
        acc[r][3] = s.w * decay;
      }
#pragma unroll 4
      for (int j = 0; j < c; ++j) {
        const float4 kv = ld4(s_kx + j * LK + d0);
        const float4 vv = ld4(s_v + j * LV + e0);
        const float kr[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          acc[r][0] = fmaf(kr[r], vv.x, acc[r][0]);
          acc[r][1] = fmaf(kr[r], vv.y, acc[r][1]);
          acc[r][2] = fmaf(kr[r], vv.z, acc[r][2]);
          acc[r][3] = fmaf(kr[r], vv.w, acc[r][3]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(s_S + (d0 + r) * DV + e0) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  __syncthreads();
  for (int i = tid; i < DK * DV; i += kThreads) s_out[sbase + i] = s_S[i];
}

// ------------------------------------------------------------ bf16 kernel
// (tensor cores; the design is in the header note)
namespace tc {

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats as one bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

// d += a b: m16n8k16, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s)
               : "memory");
}

// Element (r, col) of a bf16 tile of rows W wide (16, 32 or 64): the
// 16-byte chunk col / 8 is XORed with a function of the row, so that the
// eight rows one ldmatrix reads, or one fragment load touches, lie in
// eight different 16-byte bank groups; no padding.
template <int W>
__device__ __forceinline__ int swz(int r, int col) {
  constexpr int NC = W / 8, SH = NC == 8 ? 0 : NC == 4 ? 1 : 2;
  return r * W + ((((col >> 3) ^ (r >> SH)) & (NC - 1)) << 3) + (col & 7);
}

}  // namespace tc

template <int DK, int DV>
struct Bf16Shape {
  static constexpr int KP = DK < 16 ? 16 : DK;  // dk padded to an mma step
  static constexpr int VP = DV < 16 ? 16 : DV;
  static constexpr int LW = DK + 4;  // float row of the cumsums
  static constexpr int TM = KP / 16, WPM = 8 / TM;  // state m-tiles, warps each
  static constexpr int TN = VP / 8;                  // state n-tiles
  static constexpr int NPW = TN > WPM ? TN / WPM : 1;  // n-tiles per warp
  __host__ __device__ static size_t smem(int c) {
    const size_t R = c < kSub ? kSub : c, n_sub = R / kSub;
    return 2 * (3 * R * KP + R * VP + KP * VP) +
           4 * (R * LW + (3 * n_sub + 1) * DK + 2 * DK);
  }
};

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks share an SM
    ssm_scan_bf16_kernel(
        const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
        const __nv_bfloat16* __restrict__ v, const float* __restrict__ w,
        const float* __restrict__ u, const float* __restrict__ s0,
        __nv_bfloat16* __restrict__ y, float* __restrict__ s_out,
        long long q_sb, long long q_st, long long q_sh, long long k_sb,
        long long k_st, long long k_sh, long long v_sb, long long v_st,
        long long v_sh, long long w_sb, long long w_st, long long w_sh,
        long long y_sb, long long y_st, long long y_sh, int T_len, int H,
        int c) {
  using L = Bf16Shape<DK, DV>;
  constexpr int KP = L::KP, VP = L::VP, LW = L::LW, WPM = L::WPM,
                TN = L::TN, NPW = L::NPW;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = c < kSub ? kSub : c;  // rows staged; a short chunk is padded
  const int U = c < kSub ? c : kSub;  // rows of a sub-block
  const int n_sub = R / kSub;
  bf16* s_q = reinterpret_cast<bf16*>(smem_raw);  // [R][KP] q, then k_out hi
  bf16* s_k = s_q + R * KP;                       // [R][KP] k
  bf16* s_kx = s_k + R * KP;   // [R][KP] k anchored at its sub-block's end,
                               // then k_out lo
  bf16* s_v = s_kx + R * KP;   // [R][VP]
  bf16* s_S = s_v + R * VP;    // [KP][VP] the carried state, rounded
  float* s_loc = reinterpret_cast<float*>(s_S + KP * VP);  // [R][LW]
  float* s_tot = s_loc + R * LW;          // [n_sub][DK] sub-block log2 decay
  float* s_pre = s_tot + n_sub * DK;      // [n_sub + 1][DK] earlier ones
  float* s_suf = s_pre + (n_sub + 1) * DK;  // [n_sub][DK] later ones
  float* s_u = s_suf + n_sub * DK;        // [DK] bonus
  float* s_zero = s_u + DK;               // [DK] zeros

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, qd = lane & 3;
  const int mat = lane >> 3, rr = lane & 7;  // ldmatrix: matrix, its row
  const bool rwkv = u != nullptr;
  const bf16* qb = q + b * q_sb + h * q_sh;
  const bf16* kb = k + b * k_sb + h * k_sh;
  const bf16* vb = v + b * v_sb + h * v_sh;
  const float* wb = w + b * w_sb + h * w_sh;
  bf16* yb = y + b * y_sb + h * y_sh;
  const long long sbase = ((long long)b * H + h) * DK * DV;

  // zeros once: the padding rows (c < 16) and columns (dk or dv of 8) are
  // never loaded and must read as zero
  const int n16 = (int)(L::smem(c) / 16);
  for (int i = tid; i < n16; i += kThreads)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (rwkv)
    for (int d = tid; d < DK; d += kThreads) s_u[d] = u[h * DK + d];

  // the state: warp w holds rows mi*16.. of it, n-tiles nw*NPW.., as mma
  // accumulators (rows g, g + 8; columns 2 qd, 2 qd + 1 of each tile)
  const int mi = warp / WPM, nw = warp % WPM;
  const bool st_on = nw * NPW < TN;
  const int d0 = mi * 16 + g, d1 = d0 + 8;
  float st[NPW][4];
#pragma unroll
  for (int j = 0; j < NPW; ++j) {
    const int e = (nw * NPW + j) * 8 + 2 * qd;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int d = x < 2 ? d0 : d1, ee = e + (x & 1);
      st[j][x] = (s0 && st_on && d < DK && ee < DV) ? s0[sbase + d * DV + ee]
                                                    : 0.f;
    }
  }

  for (int c0 = 0; c0 < T_len; c0 += c) {
    __syncthreads();  // the previous chunk's readers are done
    if (st_on) {      // the carried state, rounded, for the read-out
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        const int e = (nw * NPW + j) * 8 + 2 * qd;
        *reinterpret_cast<uint32_t*>(s_S + tc::swz<VP>(d0, e)) =
            tc::pack(st[j][0], st[j][1]);
        *reinterpret_cast<uint32_t*>(s_S + tc::swz<VP>(d1, e)) =
            tc::pack(st[j][2], st[j][3]);
      }
    }
    // the chunk's rows, as they are (bf16), 16 bytes a load; log_w in
    // log2 units
    constexpr int QV = DK / 8, VV = DV / 8, WV = DK / 4;
#pragma unroll 4
    for (int i = tid; i < c * QV; i += kThreads) {
      const int r = i / QV, x = (i - r * QV) * 8;
      const uint4 qv = __ldg(reinterpret_cast<const uint4*>(
          qb + (long long)(c0 + r) * q_st + x));
      const uint4 kv = __ldg(reinterpret_cast<const uint4*>(
          kb + (long long)(c0 + r) * k_st + x));
      *reinterpret_cast<uint4*>(s_q + tc::swz<KP>(r, x)) = qv;
      *reinterpret_cast<uint4*>(s_k + tc::swz<KP>(r, x)) = kv;
    }
#pragma unroll 4
    for (int i = tid; i < c * VV; i += kThreads) {
      const int r = i / VV, x = (i - r * VV) * 8;
      *reinterpret_cast<uint4*>(s_v + tc::swz<VP>(r, x)) =
          __ldg(reinterpret_cast<const uint4*>(vb + (long long)(c0 + r) * v_st +
                                               x));
    }
#pragma unroll 4
    for (int i = tid; i < c * WV; i += kThreads) {
      const int r = i / WV, x = (i - r * WV) * 4;
      float4 wv = __ldg(
          reinterpret_cast<const float4*>(wb + (long long)(c0 + r) * w_st + x));
      wv.x *= attn::kLog2e;
      wv.y *= attn::kLog2e;
      wv.z *= attn::kLog2e;
      wv.w *= attn::kLog2e;
      *reinterpret_cast<float4*>(s_loc + r * LW + x) = wv;
    }
    __syncthreads();
    // inclusive cumsum within each sub-block, and each sub-block's total
    for (int it = tid; it < n_sub * DK; it += kThreads) {
      const int sb = it / DK, d = it - sb * DK;
      float acc = 0.f;
      for (int r = sb * kSub; r < sb * kSub + U; ++r) {
        acc += s_loc[r * LW + d];
        s_loc[r * LW + d] = acc;
      }
      s_tot[sb * DK + d] = acc;
    }
    __syncthreads();
    // the sums of the earlier and of the later sub-blocks' totals
    for (int d = tid; d < DK; d += kThreads) {
      float pre = 0.f, suf = 0.f;
      for (int sb = 0; sb < n_sub; ++sb) {
        s_pre[sb * DK + d] = pre;
        pre += s_tot[sb * DK + d];
        const int sr = n_sub - 1 - sb;
        s_suf[sr * DK + d] = suf;
        suf += s_tot[sr * DK + d];
      }
      s_pre[n_sub * DK + d] = pre;  // the chunk's total
    }
    // k of every sub-block but the last, anchored at its sub-block's end:
    // k_j exp(tot_s - cum_j), exponent <= 0, rounded to bf16
    for (int i = tid; i < (R - kSub) * KP / 2; i += kThreads) {
      const int r = i / (KP / 2), d = 2 * (i - r * (KP / 2)), sb = r / kSub;
      float2 kx = make_float2(0.f, 0.f);
      if (d < DK) {
        const float2 kv = tc::unpack(
            *reinterpret_cast<const uint32_t*>(s_k + tc::swz<KP>(r, d)));
        kx.x = kv.x * tc::ex2(s_tot[sb * DK + d] - s_loc[r * LW + d]);
        kx.y = kv.y * tc::ex2(s_tot[sb * DK + d + 1] - s_loc[r * LW + d + 1]);
      }
      *reinterpret_cast<uint32_t*>(s_kx + tc::swz<KP>(r, d)) =
          tc::pack(kx.x, kx.y);
    }
    __syncthreads();

    // y: one warp per 16-row sub-block t, all at once
    for (int t = warp; t < n_sub; t += 8) {
      const int lo = t * kSub;
      // q-side exponent rows: inclusive cumsum (Mamba) or exclusive (RWKV),
      // from the sub-block's start
      const float* qe0 =
          rwkv ? (g > 0 ? s_loc + (lo + g - 1) * LW : s_zero) : s_loc + (lo + g) * LW;
      const float* qe1 = s_loc + (lo + g + (rwkv ? 7 : 8)) * LW;
      const bf16* q0r = s_q;  // rows lo + g, lo + g + 8 through swz
      float yacc[VP / 8][4];

      // diagonal 16x16 block, exact in log space on the CUDA cores: this
      // lane's entries of the A fragment, (g, 2qd..+1), (g+8, 2qd..+1),
      // (g+8, 2qd+8..+9); (g, 2qd+8..+9) lie above the diagonal
      {
        const int j0 = lo + 2 * qd, j1 = j0 + 1, j2 = j0 + 8, j3 = j0 + 9;
        const bool in0 = rwkv ? 2 * qd < g : 2 * qd <= g;
        const bool in1 = rwkv ? 2 * qd + 1 < g : 2 * qd + 1 <= g;
        const bool bon0 = rwkv && 2 * qd == g, bon1 = rwkv && 2 * qd + 1 == g;
        float a[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
        for (int d = 0; d < DK; d += 4) {
          const float4 e0 = *reinterpret_cast<const float4*>(qe0 + d);
          const float4 e1 = *reinterpret_cast<const float4*>(qe1 + d);
          const float4 c0v = *reinterpret_cast<const float4*>(s_loc + j0 * LW + d);
          const float4 c1v = *reinterpret_cast<const float4*>(s_loc + j1 * LW + d);
          const float4 c2v = *reinterpret_cast<const float4*>(s_loc + j2 * LW + d);
          const float4 c3v = *reinterpret_cast<const float4*>(s_loc + j3 * LW + d);
          const float4 uv = *reinterpret_cast<const float4*>(s_u + d);
          const uint2 qa = *reinterpret_cast<const uint2*>(q0r + tc::swz<KP>(lo + g, d));
          const uint2 qb2 = *reinterpret_cast<const uint2*>(q0r + tc::swz<KP>(lo + g + 8, d));
          const uint2 k0 = *reinterpret_cast<const uint2*>(s_k + tc::swz<KP>(j0, d));
          const uint2 k1 = *reinterpret_cast<const uint2*>(s_k + tc::swz<KP>(j1, d));
          const uint2 k2 = *reinterpret_cast<const uint2*>(s_k + tc::swz<KP>(j2, d));
          const uint2 k3 = *reinterpret_cast<const uint2*>(s_k + tc::swz<KP>(j3, d));
          const float2 qa01 = tc::unpack(qa.x), qa23 = tc::unpack(qa.y);
          const float2 qb01 = tc::unpack(qb2.x), qb23 = tc::unpack(qb2.y);
          const float2 k001 = tc::unpack(k0.x), k023 = tc::unpack(k0.y);
          const float2 k101 = tc::unpack(k1.x), k123 = tc::unpack(k1.y);
          const float2 k201 = tc::unpack(k2.x), k223 = tc::unpack(k2.y);
          const float2 k301 = tc::unpack(k3.x), k323 = tc::unpack(k3.y);
          const float qi0[4] = {qa01.x, qa01.y, qa23.x, qa23.y};
          const float qi1[4] = {qb01.x, qb01.y, qb23.x, qb23.y};
          const float kj0[4] = {k001.x, k001.y, k023.x, k023.y};
          const float kj1[4] = {k101.x, k101.y, k123.x, k123.y};
          const float kj2[4] = {k201.x, k201.y, k223.x, k223.y};
          const float kj3[4] = {k301.x, k301.y, k323.x, k323.y};
          const float x0[4] = {e0.x, e0.y, e0.z, e0.w};
          const float x1[4] = {e1.x, e1.y, e1.z, e1.w};
          const float l0[4] = {c0v.x, c0v.y, c0v.z, c0v.w};
          const float l1[4] = {c1v.x, c1v.y, c1v.z, c1v.w};
          const float l2[4] = {c2v.x, c2v.y, c2v.z, c2v.w};
          const float l3[4] = {c3v.x, c3v.y, c3v.z, c3v.w};
          const float uu[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // entries on or above the diagonal would have exponents > 0:
            // clamped here, zeroed (or given the bonus) below
            const float f0 = bon0 ? uu[e] : tc::ex2(fminf(x0[e] - l0[e], 0.f));
            const float f1 = bon1 ? uu[e] : tc::ex2(fminf(x0[e] - l1[e], 0.f));
            const float f4 = bon0 ? uu[e] : tc::ex2(fminf(x1[e] - l2[e], 0.f));
            const float f5 = bon1 ? uu[e] : tc::ex2(fminf(x1[e] - l3[e], 0.f));
            a[0] = fmaf(qi0[e] * kj0[e], f0, a[0]);
            a[1] = fmaf(qi0[e] * kj1[e], f1, a[1]);
            a[2] = fmaf(qi1[e] * kj0[e], tc::ex2(x1[e] - l0[e]), a[2]);
            a[3] = fmaf(qi1[e] * kj1[e], tc::ex2(x1[e] - l1[e]), a[3]);
            a[4] = fmaf(qi1[e] * kj2[e], f4, a[4]);
            a[5] = fmaf(qi1[e] * kj3[e], f5, a[5]);
          }
        }
        const bool k0on = in0 || bon0, k1on = in1 || bon1;
        const uint32_t pa[4] = {tc::pack(k0on ? a[0] : 0.f, k1on ? a[1] : 0.f),
                                tc::pack(a[2], a[3]), 0u,
                                tc::pack(k0on ? a[4] : 0.f, k1on ? a[5] : 0.f)};
#pragma unroll
        for (int np = 0; np < VP / 16; ++np) {
          uint32_t bv[4];
          tc::ldsm_x4_t(bv, s_v + tc::swz<VP>(lo + (mat & 1) * 8 + rr,
                                              np * 16 + (mat >> 1) * 8));
#pragma unroll
          for (int x = 0; x < 4; ++x) yacc[2 * np][x] = yacc[2 * np + 1][x] = 0.f;
          tc::mma(yacc[2 * np], pa, bv[0], bv[1]);
          tc::mma(yacc[2 * np + 1], pa, bv[2], bv[3]);
        }
      }

      // earlier sub-blocks s < t, anchored at the end of s: q_i
      // exp(qe_i + (sub-blocks s+1 .. t-1)) against k_j exp(tot_s - cum_j),
      // both exponents <= 0; the middle sum as a difference of suffix sums,
      // exactly 0 for s = t - 1
      for (int s = 0; s < t; ++s) {
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const float* suf_s = s_suf + s * DK;
        const float* suf_t = s_suf + (t - 1) * DK;
#pragma unroll
        for (int kk = 0; kk < KP / 16; ++kk) {
          uint32_t qa[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int half = 0; half < (DK < 16 ? 1 : 2); ++half) {
            const int d = kk * 16 + half * 8 + 2 * qd;
            const float gx = suf_s[d] - suf_t[d], gy = suf_s[d + 1] - suf_t[d + 1];
            const float2 v0 = tc::unpack(*reinterpret_cast<const uint32_t*>(
                s_q + tc::swz<KP>(lo + g, d)));
            const float2 v1 = tc::unpack(*reinterpret_cast<const uint32_t*>(
                s_q + tc::swz<KP>(lo + g + 8, d)));
            qa[2 * half] = tc::pack(v0.x * tc::ex2(qe0[d] + gx),
                                    v0.y * tc::ex2(qe0[d + 1] + gy));
            qa[2 * half + 1] = tc::pack(v1.x * tc::ex2(qe1[d] + gx),
                                        v1.y * tc::ex2(qe1[d + 1] + gy));
          }
          uint32_t bk[4];
          tc::ldsm_x4(bk, s_kx + tc::swz<KP>(s * kSub + (mat >> 1) * 8 + rr,
                                             kk * 16 + (mat & 1) * 8));
          tc::mma(sc[0], qa, bk[0], bk[1]);
          tc::mma(sc[1], qa, bk[2], bk[3]);
        }
        // the scores, rounded to bf16 in registers, as A of A V_s
        const uint32_t pa[4] = {tc::pack(sc[0][0], sc[0][1]),
                                tc::pack(sc[0][2], sc[0][3]),
                                tc::pack(sc[1][0], sc[1][1]),
                                tc::pack(sc[1][2], sc[1][3])};
#pragma unroll
        for (int np = 0; np < VP / 16; ++np) {
          uint32_t bv[4];
          tc::ldsm_x4_t(bv, s_v + tc::swz<VP>(s * kSub + (mat & 1) * 8 + rr,
                                              np * 16 + (mat >> 1) * 8));
          tc::mma(yacc[2 * np], pa, bv[0], bv[1]);
          tc::mma(yacc[2 * np + 1], pa, bv[2], bv[3]);
        }
      }

      // carried-state read: (q_i exp(qe_i + earlier sub-blocks)) S
      {
        const float* pre_t = s_pre + t * DK;
#pragma unroll
        for (int kk = 0; kk < KP / 16; ++kk) {
          uint32_t qa[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int half = 0; half < (DK < 16 ? 1 : 2); ++half) {
            const int d = kk * 16 + half * 8 + 2 * qd;
            const float2 v0 = tc::unpack(*reinterpret_cast<const uint32_t*>(
                s_q + tc::swz<KP>(lo + g, d)));
            const float2 v1 = tc::unpack(*reinterpret_cast<const uint32_t*>(
                s_q + tc::swz<KP>(lo + g + 8, d)));
            qa[2 * half] = tc::pack(v0.x * tc::ex2(qe0[d] + pre_t[d]),
                                    v0.y * tc::ex2(qe0[d + 1] + pre_t[d + 1]));
            qa[2 * half + 1] =
                tc::pack(v1.x * tc::ex2(qe1[d] + pre_t[d]),
                         v1.y * tc::ex2(qe1[d + 1] + pre_t[d + 1]));
          }
#pragma unroll
          for (int np = 0; np < VP / 16; ++np) {
            uint32_t bs[4];
            tc::ldsm_x4_t(bs, s_S + tc::swz<VP>(kk * 16 + (mat & 1) * 8 + rr,
                                                np * 16 + (mat >> 1) * 8));
            tc::mma(yacc[2 * np], qa, bs[0], bs[1]);
            tc::mma(yacc[2 * np + 1], qa, bs[2], bs[3]);
          }
        }
      }

      bf16* yr = yb + (long long)(c0 + lo + g) * y_st;
#pragma unroll
      for (int ni = 0; ni < VP / 8; ++ni) {
        const int e = ni * 8 + 2 * qd;
        if (e >= DV) continue;
        if (g < U)
          *reinterpret_cast<uint32_t*>(yr + e) = tc::pack(yacc[ni][0], yacc[ni][1]);
        if (g + 8 < U)
          *reinterpret_cast<uint32_t*>(yr + 8 * y_st + e) =
              tc::pack(yacc[ni][2], yacc[ni][3]);
      }
    }
    __syncthreads();

    // k_out = k exp(tot - cum) = hi + lo, both bf16, into the q and
    // anchored-k buffers: (rest of j's sub-block) + (later sub-blocks)
    for (int i = tid; i < R * KP / 2; i += kThreads) {
      const int r = i / (KP / 2), d = 2 * (i - r * (KP / 2)), sb = r / kSub;
      uint32_t hi = 0u, lo2 = 0u;
      if (d < DK) {
        const float2 kv = tc::unpack(
            *reinterpret_cast<const uint32_t*>(s_k + tc::swz<KP>(r, d)));
        const float ox = kv.x * tc::ex2(s_tot[sb * DK + d] - s_loc[r * LW + d] +
                                        s_suf[sb * DK + d]);
        const float oy =
            kv.y * tc::ex2(s_tot[sb * DK + d + 1] - s_loc[r * LW + d + 1] +
                           s_suf[sb * DK + d + 1]);
        hi = tc::pack(ox, oy);
        const float2 h2 = tc::unpack(hi);
        lo2 = tc::pack(ox - h2.x, oy - h2.y);
      }
      *reinterpret_cast<uint32_t*>(s_q + tc::swz<KP>(r, d)) = hi;
      *reinterpret_cast<uint32_t*>(s_kx + tc::swz<KP>(r, d)) = lo2;
    }
    __syncthreads();

    // state update on the tensor cores: S = S exp(tot) + hi^T V + lo^T V
    if (st_on) {
      const float* tot = s_pre + n_sub * DK;
      const float f0 = d0 < DK ? tc::ex2(tot[d0]) : 0.f;
      const float f1 = d1 < DK ? tc::ex2(tot[d1]) : 0.f;
#pragma unroll
      for (int j = 0; j < NPW; ++j) {
        st[j][0] *= f0;
        st[j][1] *= f0;
        st[j][2] *= f1;
        st[j][3] *= f1;
      }
      for (int j0 = 0; j0 < R; j0 += kSub) {
        uint32_t ah[4], al[4];
        const int ar = j0 + (mat >> 1) * 8 + rr, ac = mi * 16 + (mat & 1) * 8;
        tc::ldsm_x4_t(ah, s_q + tc::swz<KP>(ar, ac));
        tc::ldsm_x4_t(al, s_kx + tc::swz<KP>(ar, ac));
        if constexpr (NPW == 1) {
          uint32_t bv[2];
          tc::ldsm_x2_t(bv, s_v + tc::swz<VP>(j0 + (mat & 1) * 8 + rr, nw * 8));
          tc::mma(st[0], ah, bv[0], bv[1]);
          tc::mma(st[0], al, bv[0], bv[1]);
        } else {
#pragma unroll
          for (int j = 0; j < NPW; j += 2) {
            uint32_t bv[4];
            tc::ldsm_x4_t(bv, s_v + tc::swz<VP>(j0 + (mat & 1) * 8 + rr,
                                                (nw * NPW + j) * 8 + (mat >> 1) * 8));
            tc::mma(st[j], ah, bv[0], bv[1]);
            tc::mma(st[j], al, bv[0], bv[1]);
            tc::mma(st[j + 1], ah, bv[2], bv[3]);
            tc::mma(st[j + 1], al, bv[2], bv[3]);
          }
        }
      }
    }
  }
  if (st_on) {
#pragma unroll
    for (int j = 0; j < NPW; ++j) {
      const int e = (nw * NPW + j) * 8 + 2 * qd;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int d = x < 2 ? d0 : d1, ee = e + (x & 1);
        if (d < DK && ee < DV) s_out[sbase + d * DV + ee] = st[j][x];
      }
    }
  }
}

template <int DK, int DV>
struct F32Kernel {
  static auto fn() { return ssm_scan_kernel<float, DK, DV>; }
  static size_t smem(int c) { return smem_bytes<DK, DV>(c); }
  using T = float;
};

template <int DK, int DV>
struct Bf16Kernel {
  static auto fn() { return ssm_scan_bf16_kernel<DK, DV>; }
  static size_t smem(int c) { return Bf16Shape<DK, DV>::smem(c); }
  using T = __nv_bfloat16;
};

// Set kernel K's shared-memory limit for chunk c (and, for bf16, the
// largest shared-memory carveout, so that two blocks fit an SM). The
// largest chunk launched so far sets the limit; a larger one raises it on
// every device again. A request the card cannot hold is refused here
// (cudaErrorInvalidValue) and leaves the limit as it was.
template <typename K>
cudaError_t prepare(int c) {
  static unsigned long long configured = 0;
  static size_t limit = 0;
  static unsigned long long carved = 0;  // per device, as the limit
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  const unsigned long long bit = 1ull << (dev & 63);
  if (err == cudaSuccess && !(carved & bit) &&
      std::is_same<typename K::T, __nv_bfloat16>::value) {
    err = cudaFuncSetAttribute(K::fn(),
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess) carved |= bit;
  }
  const size_t smem = K::smem(c);
  if (err == cudaSuccess) {
    if (smem > limit) configured = 0;
    err = attn::allow_smem(K::fn(), smem > limit ? smem : limit, &configured);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return err;
  }
  if (smem > limit) limit = smem;
  return cudaSuccess;
}

template <typename K>
int launch(const void* q, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* y, float* s_out,
           const long long* st, long long B, long long T_len, long long H,
           long long c, cudaStream_t stream) {
  using T = typename K::T;
  const cudaError_t err = prepare<K>((int)c);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)H, (unsigned)B);
  K::fn()<<<grid, kThreads, K::smem((int)c), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(y), s_out, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], st[12], st[13], st[14], (int)T_len, (int)H, (int)c);
  return (int)cudaGetLastError();
}

// f(K{}) for the kernel K of (dtype, DK, DV); cudaErrorInvalidValue for a
// combination no kernel takes
template <template <int, int> class K, int DK, typename F>
int with_dv(long long DV, F&& f) {
  switch (DV) {
    case 8: return f(K<DK, 8>{});
    case 16: return f(K<DK, 16>{});
    case 32: return f(K<DK, 32>{});
    case 64: return f(K<DK, 64>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

template <template <int, int> class K, typename F>
int with_dims(long long DK, long long DV, F&& f) {
  switch (DK) {
    case 8: return with_dv<K, 8>(DV, f);
    case 16: return with_dv<K, 16>(DV, f);
    case 32: return with_dv<K, 32>(DV, f);
    case 64: return with_dv<K, 64>(DV, f);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename F>
int with_kernel(long long dtype, long long DK, long long DV, F&& f) {
  if (dtype == 0) return with_dims<F32Kernel>(DK, DV, f);
  if (dtype == 1) return with_dims<Bf16Kernel>(DK, DV, f);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, log_w [B,T,H,DK] and v, y [B,T,H,DV] through their (batch, time,
// head) strides in elements, the last axis contiguous (bf16: every row
// 16-byte aligned); bonus_u [H,DK] float32 contiguous, or null for Mamba
// semantics; initial_state (null: zeros) and final_state [B,H,DK,DV]
// float32 contiguous. log_w is float32; q, k, v, y share dtype: 0 float32
// (the CUDA-core kernel), 1 bfloat16 (the tensor-core kernel). DK, DV in
// {8, 16, 32, 64}; the chunk c divides T and is below 16 or a multiple of
// 16. Returns cudaGetLastError() after the launch.
extern "C" int ssm_scan_fwd(
    const void* q, const void* k, const void* v, const void* log_w,
    const void* bonus_u, const void* initial_state, void* y, void* final_state,
    long long q_sb, long long q_st, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long w_sb, long long w_st, long long w_sh,
    long long y_sb, long long y_st, long long y_sh, long long B,
    long long T_len, long long H, long long DK, long long DV, long long c,
    long long dtype, void* stream) {
  if (c <= 0 || T_len % c || (c > kSub && c % kSub))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || H <= 0) return 0;
  const long long st[15] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st,
                            v_sh, w_sb, w_st, w_sh, y_sb, y_st, y_sh};
  const float* w = static_cast<const float*>(log_w);
  const float* u = static_cast<const float*>(bonus_u);
  const float* s0 = static_cast<const float*>(initial_state);
  float* s_out = static_cast<float*>(final_state);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_kernel(dtype, DK, DV, [&](auto kernel) {
    return launch<decltype(kernel)>(q, k, v, w, u, s0, y, s_out, st, B, T_len,
                                    H, c, s);
  });
}

// The dynamic shared memory one block of the (dtype, DK, DV) kernel takes
// at chunk c, in bytes; negative (minus a CUDA error) for no kernel.
extern "C" long long ssm_scan_smem_bytes(long long DK, long long DV,
                                         long long c, long long dtype) {
  long long bytes = -(long long)cudaErrorInvalidValue;
  with_kernel(dtype, DK, DV, [&](auto kernel) {
    bytes = (long long)decltype(kernel)::smem((int)c);
    return 0;
  });
  return bytes;
}

// How many blocks of the (dtype, DK, DV) kernel at chunk c the current
// device runs at once on one SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// after the launch's own settings); negative (minus a CUDA error) if the
// kernel cannot be configured for it.
extern "C" long long ssm_scan_blocks_per_sm(long long DK, long long DV,
                                            long long c, long long dtype) {
  int blocks = 0;
  const int err = with_kernel(dtype, DK, DV, [&](auto kernel) {
    using K = decltype(kernel);
    cudaError_t e = prepare<K>((int)c);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, K::fn(),
                                                        kThreads, K::smem((int)c));
    return (int)e;
  });
  return err ? -(long long)err : (long long)blocks;
}
