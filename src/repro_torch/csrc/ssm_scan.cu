// Chunked gated linear recurrence (RWKV-6 WKV / Mamba-2 SSD) for Hopper
// (sm_90a): bfloat16 or float32 q/k/v, float32 decays, bonus and state,
// float32 arithmetic, output in the input type.
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py::ssm_scan (Pallas body
// `_kernel`), and adds what the model-level function
// repro/models/ssm.py::chunked_linear_attn adds around it: an initial
// state and the final state as a second output (prefill hands it to
// decode). For q, k, log_w [B,T,H,dk], v [B,T,H,dv], per (b, h):
//   S_t = diag(exp(log_w_t)) S_{t-1} + k_t^T v_t      (S [dk, dv], S_0 given)
//   Mamba (no bonus):  y_t = q_t S_t
//   RWKV (bonus u):    y_t = q_t S_{t-1} + (q_t * u * k_t) . v_t
//
// What bounds it on the H100: bytes. At RWKV-6-7B's prefill shape
// ([4, 2048, 64 heads, 64, 64], chunk 128, bf16) the function moves
// ~0.41 GB (q/k/v/y in bf16, decays in f32), ~0.12 ms at 3.35 TB/s; its
// recurrence needs 5 dk dv operations per token and head, ~10.7 GFLOP,
// ~11 us at the bf16 tensor-core rate. This kernel is far from that: its
// chunked form does ~19 GFLOP and ~0.5 G exps of float32 work on the CUDA
// cores (~0.28 ms at 67 TFLOP/s), where the shared-memory loads that feed
// the FMAs, not the FMAs, are the limit.
//
// Design: one block of 256 threads per (head, sequence); the TPU grid's
// sequential chunk axis becomes a loop over chunks of c rows inside the
// block, and the [dk, dv] float32 state stays in shared memory across
// chunks. q/k/v/log_w are read through their [B,T,H,d] strides (no
// head-major copy). Per chunk, as the TPU kernel does (cum = inclusive
// cumsum of log_w over the chunk, qe = cum for Mamba, cum - log_w for RWKV):
//   for each 16-row sub-block [lo, lo+16), base = cum[lo-1]:
//     diagonal 16x16 pairs exactly in log space:
//       A[i][j] = sum_d q_i exp(qe_i - cum_j) k_j  (j < i RWKV, j <= i Mamba)
//       plus (q_i * u * k_i) on i == j (RWKV);
//     earlier rows j < lo anchored at base:
//       A[i][j] = (q_i exp(qe_i - base)) . (k_j exp(base - cum_j));
//     y_i = sum_j A[i][j] v_j + (q_i exp(qe_i)) S;
//   S = S exp(cum[c-1]) + sum_j (k_j exp(cum[c-1] - cum_j))^T v_j.
// One difference from the TPU kernel: cumsums are kept per sub-block (with
// each sub-block's total and the sums of the earlier and later totals),
// and every exponent above is assembled from them, so two cumsums are only
// subtracted within one sub-block. Subtracting chunk-wide cumsums, as the
// reference does, loses precision in proportion to their size, ~-145 at
// the end of a 128-row chunk of fast decays.
// Every exponent is <= 0 (decays are <= 0), so nothing overflows and no
// decay is clamped. The chunk's q, k, v, cumsums and anchored k are staged in
// shared memory as float32 rows padded to dk + 4 (dv + 4) floats, so that
// float4 reads of eight neighbouring rows hit distinct banks; scores are
// kept transposed ([j][16]) so four rows of a column are one float4.
// Each thread accumulates a 4-row (score, y) or 4x4 (state) tile in
// registers. Shared memory at c = 128, dk = dv = 64 is ~213 KB, above the
// 48 KB default: the launch raises the kernel's limit, and a request the
// card cannot hold (c = 256 at dk = dv = 64) is refused.
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
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

template <typename T, int DK, int DV>
int launch(const void* q, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* y, float* s_out,
           const long long* st, long long B, long long T_len, long long H,
           long long c, cudaStream_t stream) {
  static unsigned long long configured = 0;
  // the largest chunk launched so far sets the limit; a larger one raises
  // it on every device again. A request the card cannot hold is refused
  // here (cudaErrorInvalidValue) and leaves the limit as it was.
  static size_t limit = 0;
  const size_t smem = smem_bytes<DK, DV>((int)c);
  if (smem > limit) configured = 0;
  const size_t want = smem > limit ? smem : limit;
  cudaError_t err =
      attn::allow_smem(ssm_scan_kernel<T, DK, DV>, want, &configured);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  limit = want;
  const dim3 grid((unsigned)H, (unsigned)B);
  ssm_scan_kernel<T, DK, DV><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(y), s_out, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], st[12], st[13], st[14], (int)T_len, (int)H, (int)c);
  return (int)cudaGetLastError();
}

template <typename T, int DK>
int dispatch_dv(long long DV, const void* q, const void* k, const void* v,
                const float* w, const float* u, const float* s0, void* y,
                float* s_out, const long long* st, long long B, long long T_len,
                long long H, long long c, cudaStream_t s) {
  switch (DV) {
    case 8:
      return launch<T, DK, 8>(q, k, v, w, u, s0, y, s_out, st, B, T_len, H, c, s);
    case 16:
      return launch<T, DK, 16>(q, k, v, w, u, s0, y, s_out, st, B, T_len, H, c, s);
    case 32:
      return launch<T, DK, 32>(q, k, v, w, u, s0, y, s_out, st, B, T_len, H, c, s);
    case 64:
      return launch<T, DK, 64>(q, k, v, w, u, s0, y, s_out, st, B, T_len, H, c, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dk(long long DK, long long DV, const void* q, const void* k,
                const void* v, const float* w, const float* u, const float* s0,
                void* y, float* s_out, const long long* st, long long B,
                long long T_len, long long H, long long c, cudaStream_t s) {
  switch (DK) {
    case 8:
      return dispatch_dv<T, 8>(DV, q, k, v, w, u, s0, y, s_out, st, B, T_len, H, c, s);
    case 16:
      return dispatch_dv<T, 16>(DV, q, k, v, w, u, s0, y, s_out, st, B, T_len, H, c, s);
    case 32:
      return dispatch_dv<T, 32>(DV, q, k, v, w, u, s0, y, s_out, st, B, T_len, H, c, s);
    case 64:
      return dispatch_dv<T, 64>(DV, q, k, v, w, u, s0, y, s_out, st, B, T_len, H, c, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, log_w [B,T,H,DK] and v, y [B,T,H,DV] through their (batch, time,
// head) strides in elements, the last axis contiguous; bonus_u [H,DK]
// float32 contiguous, or null for Mamba semantics; initial_state (null:
// zeros) and final_state [B,H,DK,DV] float32 contiguous. log_w is float32;
// q, k, v, y share dtype: 0 float32, 1 bfloat16. DK, DV in {8, 16, 32,
// 64}; the chunk c divides T and is below 16 or a multiple of 16.
// Returns cudaGetLastError() after the launch.
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
  if (dtype == 0)
    return dispatch_dk<float>(DK, DV, q, k, v, w, u, s0, y, s_out, st, B,
                              T_len, H, c, s);
  if (dtype == 1)
    return dispatch_dk<__nv_bfloat16>(DK, DV, q, k, v, w, u, s0, y, s_out, st,
                                      B, T_len, H, c, s);
  return (int)cudaErrorInvalidValue;
}
