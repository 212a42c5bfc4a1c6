// Causal (optionally windowed) GQA flash attention for Hopper (sm_90a),
// bfloat16 or float32 in, float32 softmax state, output in the input type.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (Pallas body `_kernel`). For q [B,S,H,d], k/v [B,S,KVH,d], kv head
// h // (H / KVH), scale 1/sqrt(d):
//   out[b,i,h] = sum_j softmax_j(q_i . k_j * scale  | j <= i, i - j < window)
//                * v_j
//
// What bounds it on the H100: operations. At the prefill shape of
// Llama-3.2-1B (B=4, S=2048, H=32, KVH=8, d=64, bf16) the causal half is
// ~69 GFLOP against ~42 MB of input and output, ~1600 FLOP per byte, far
// above the card's ~295 (bf16) ridge. This first version runs the two
// products as float32 FMAs on the CUDA cores, so its ceiling is the 67
// TFLOP/s float32 rate, not the 989 TFLOP/s of the tensor cores; moving
// both products to mma/wgmma on bf16 is the later step.
//
// Design: one block of 256 threads per (64-row query tile, q head, batch).
// A loop inside the block walks the 64-row K/V tiles, which replaces the
// TPU's sequential kv grid axis: each tile is staged in shared memory as
// float32, S = Q K^T is a 4x4 register micro-tile per thread, the online
// softmax (running max m, sum l in float32, base-2 exponent) runs with four
// threads per row, and acc += P V is a 4 x d/16 register micro-tile per
// thread. Tiles wholly past the causal diagonal or before the window are
// skipped, not masked. Q, K and V are read through their (batch, position,
// head) strides, so the [B,S,H,d] layout needs no transposed copy and the
// shared K/V of a GQA group is never expanded. Shared-memory rows are
// padded by one float, so the strided reads of both products are free of
// bank conflicts. Query tiles are issued heaviest first (the last tiles
// of a causal row see the most keys).
#include "attention_common.cuh"

namespace {

constexpr int kBq = 64;
constexpr int kBk = 64;
constexpr int kThreads = 256;

struct Strides {
  long long b, s, h;  // in elements; the head_dim axis is contiguous
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBq * (D + 1) + 2 * kBk * (D + 1) + kBq * (kBk + 1) + 3 * kBq);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           Strides qs, Strides ks, Strides vs, Strides os,
                           int S, int group, float scale_log2, int causal,
                           int window) {
  constexpr int LD = D + 1;
  constexpr int LP = kBk + 1;
  constexpr int TC = D / 16;  // acc columns per thread
  extern __shared__ float smem[];
  float* s_q = smem;               // [Bq][LD], pre-scaled by scale*log2(e)
  float* s_k = s_q + kBq * LD;     // [Bk][LD]
  float* s_v = s_k + kBk * LD;     // [Bk][LD]
  float* s_p = s_v + kBk * LD;     // [Bq][LP]: scores, then probabilities
  float* s_m = s_p + kBq * LP;     // [Bq] running max (base-2 units)
  float* s_l = s_m + kBq;          // [Bq] running sum
  float* s_alpha = s_l + kBq;      // [Bq] this tile's rescale factor

  const int nq = (S + kBq - 1) / kBq;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBq;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const T* qb = q + b * qs.b + h * qs.h + q0 * qs.s;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  attn::load_rows<T, D>(s_q, LD, qb, qs.s, min(kBq, S - q0), kBq, scale_log2,
                        tid, kThreads);
  if (tid < kBq) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }
  float acc[4][TC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

  int kt_end = (S + kBk - 1) / kBk;
  if (causal) kt_end = min(kt_end, (min(q0 + kBq, S) - 1) / kBk + 1);
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / kBk;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBk;
    const int rows = min(kBk, S - k0);
    __syncthreads();  // the previous tile's readers are done
    attn::load_rows<T, D>(s_k, LD, kb + k0 * ks.s, ks.s, rows, kBk, 1.f, tid,
                          kThreads);
    attn::load_rows<T, D>(s_v, LD, vb + k0 * vs.s, vs.s, rows, kBk, 1.f, tid,
                          kThreads);
    __syncthreads();

    // scores for rows ty + 16 i, columns tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_q[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = s_k[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        s_p[(ty + 16 * i) * LP + tx + 16 * j] = ok ? sc[i][j] : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: four neighbouring lanes per row, 16 columns each
    {
      const int r = tid >> 2, part = tid & 3;
      float* row = s_p + r * LP;
      const float m_prev = s_m[r];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBk / 4; ++j) mx = fmaxf(mx, row[part + 4 * j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      // a row with no key yet keeps m = -inf; exp2(-inf - 0) = 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBk / 4; ++j) {
        const float p = exp2f(row[part + 4 * j] - m_use);
        row[part + 4 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = exp2f(m_prev - m_use);
        s_alpha[r] = alpha;
        s_l[r] = s_l[r] * alpha + sum;
        s_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = s_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBk; ++kk) {
      float p[4], vv[TC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_p[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int j = 0; j < TC; ++j) vv[j] = s_v[kk * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
    if (qpos >= S) continue;
    const float inv = 1.f / s_l[r];  // >= 1: the row's own key is kept
#pragma unroll
    for (int j = 0; j < TC; ++j)
      ob[qpos * os.s + tx + 16 * j] = attn::from_f32<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, Strides qs,
           Strides ks, Strides vs, Strides os, long long B, long long S,
           long long H, long long KVH, int causal, int window,
           cudaStream_t stream) {
  static unsigned long long configured = 0;
  auto kernel = flash_attention_kernel<T, D>;
  const size_t smem = smem_bytes<D>();
  cudaError_t err = attn::allow_smem(kernel, smem, &configured);
  if (err != cudaSuccess) return (int)err;
  const float scale_log2 = attn::kLog2e / sqrtf((float)D);
  const dim3 grid((unsigned)((S + kBq - 1) / kBq), (unsigned)H, (unsigned)B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, (int)S,
      (int)(H / KVH), scale_log2, causal, window);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(long long D, const void* q, const void* k, const void* v,
               void* o, Strides qs, Strides ks, Strides vs, Strides os,
               long long B, long long S, long long H, long long KVH,
               int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, qs, ks, vs, os, B, S, H, KVH, causal,
                           window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, qs, ks, vs, os, B, S, H, KVH, causal,
                           window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, qs, ks, vs, os, B, S, H, KVH, causal,
                            window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,S,H,D], k/v [B,S,KVH,D], o [B,S,H,D], each read or written through
// its (batch, position, head) strides in elements with the D axis
// contiguous and 16-byte aligned. dtype: 0 float32, 1 bfloat16. window
// <= 0 means none. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, long long B, long long S,
    long long H, long long KVH, long long D, long long causal,
    long long window, long long dtype, void* stream) {
  if (H <= 0 || KVH <= 0 || H % KVH) return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return 0;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh},
      vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, qs, ks, vs, os, B, S, H, KVH,
                             (int)causal, (int)window, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, qs, ks, vs, os, B, S, H,
                                     KVH, (int)causal, (int)window, st);
  return (int)cudaErrorInvalidValue;
}
