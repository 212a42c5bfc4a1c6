// Single-token GQA decode attention over a KV cache for Hopper (sm_90a),
// bfloat16 or float32 in, float32 softmax state, output in the input type.
//
// Replaces the TPU kernel repro/kernels/decode_attention.py::decode_attention
// (Pallas body `_kernel`). For q [B,H,d] (one token per sequence), k/v
// [B,S,KVH,d] and lengths [B], kv head h // (H / KVH), scale 1/sqrt(d):
//   out[b,h] = sum_{j < lengths[b]} softmax_j(q . k_j * scale) * v_j
//
// What bounds it on the H100: bytes. Every cached K/V row is used for a
// handful of FMAs (g = H/KVH query heads), ~2 FLOP per byte in bf16 for
// Llama-3.2-1B's g = 4, so reading the cache at 3.35 TB/s is the floor.
//
// Design: one block of 128 threads per (kv head, sequence), covering the
// group's g query heads, so each cached row is read from device memory
// once per group and never once per query head. A loop inside the block
// walks 64-row tiles of K and V over positions < lengths[b] only (the
// rows past the length are never read; this replaces the TPU's
// sequential kv grid axis and its mask). Each tile is loaded with 16-byte
// vector loads through the cache's (batch, position, head) strides and
// staged in shared memory as float32, rows padded by one float so the
// score loop, one (head, position) pair per thread, is free of bank
// conflicts. The online softmax (running max and sum in float32, base-2
// exponent) runs one warp per head; acc [g, d] lives in shared memory,
// one element per thread. Known limit: the grid is B x KVH blocks, 8 at
// B=1 for Llama-3.2-1B on 132 SMs, so a single sequence cannot reach the
// bandwidth floor; splitting the cache across blocks (flash-decoding) is
// the later step.
#include "attention_common.cuh"

namespace {

constexpr int kT = 64;  // cache rows per tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <int D>
size_t smem_bytes(int g) {
  return sizeof(float) * (2 * kT * (D + 1) + 2 * g * D + g * kT + 3 * g);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const int* __restrict__ lengths,
                            T* __restrict__ o, long long q_sb, long long q_sh,
                            long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh,
                            long long o_sb, long long o_sh, int S, int g,
                            float scale_log2) {
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* s_k = smem;               // [T][LD]
  float* s_v = s_k + kT * LD;      // [T][LD]
  float* s_q = s_v + kT * LD;      // [g][D], pre-scaled by scale*log2(e)
  float* s_acc = s_q + g * D;      // [g][D]
  float* s_p = s_acc + g * D;      // [g][T]: scores, then probabilities
  float* s_m = s_p + g * kT;       // [g] running max (base-2 units)
  float* s_l = s_m + g;            // [g] running sum
  float* s_alpha = s_l + g;        // [g] this tile's rescale factor

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lengths[b], S);
  const int h0 = kvh * g;

  for (int hh = 0; hh < g; ++hh)
    attn::load_rows<T, D>(s_q + hh * D, D, q + b * q_sb + (h0 + hh) * q_sh,
                          0, 1, 1, scale_log2, tid, kThreads);
  for (int i = tid; i < g * D; i += kThreads) s_acc[i] = 0.f;
  for (int i = tid; i < g; i += kThreads) {
    s_m[i] = -INFINITY;
    s_l[i] = 0.f;
  }
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int p0 = 0; p0 < len; p0 += kT) {
    const int n = min(kT, len - p0);
    __syncthreads();  // the previous tile's readers are done
    attn::load_rows<T, D>(s_k, LD, kb + p0 * k_ss, k_ss, n, n, 1.f, tid,
                          kThreads);
    attn::load_rows<T, D>(s_v, LD, vb + p0 * v_ss, v_ss, n, n, 1.f, tid,
                          kThreads);
    __syncthreads();

    for (int i = tid; i < g * kT; i += kThreads) {
      const int hh = i / kT, r = i - hh * kT;
      float s = -INFINITY;
      if (r < n) {
        const float* qr = s_q + hh * D;
        const float* kr = s_k + r * LD;
        float a = 0.f;
#pragma unroll 16
        for (int c = 0; c < D; ++c) a = fmaf(qr[c], kr[c], a);
        s = a;
      }
      s_p[i] = s;
    }
    __syncthreads();

    // online softmax, one warp per head, two positions per lane
    for (int hh = warp; hh < g; hh += kWarps) {
      float* row = s_p + hh * kT;
      const float m_prev = s_m[hh];
      float mx = fmaxf(row[lane], row[lane + 32]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_prev, mx);  // finite: n >= 1
      const float p0v = exp2f(row[lane] - m_new);
      const float p1v = exp2f(row[lane + 32] - m_new);
      row[lane] = p0v;
      row[lane + 32] = p1v;
      float sum = p0v + p1v;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = exp2f(m_prev - m_new);  // 0 on the first tile
        s_alpha[hh] = alpha;
        s_l[hh] = s_l[hh] * alpha + sum;
        s_m[hh] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < g * D; i += kThreads) {
      const int hh = i / D, c = i - hh * D;
      const float* pr = s_p + hh * kT;
      float a = s_acc[i] * s_alpha[hh];
      for (int r = 0; r < n; ++r) a = fmaf(pr[r], s_v[r * LD + c], a);
      s_acc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < g * D; i += kThreads) {
    const int hh = i / D, c = i - hh * D;
    const float l = s_l[hh];
    // lengths[b] == 0 reads nothing and writes zeros
    o[b * o_sb + (h0 + hh) * o_sh + c] =
        attn::from_f32<T>(l > 0.f ? s_acc[i] / l : 0.f);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, long long q_sb, long long q_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, long long o_sb, long long o_sh, long long B,
           long long S, long long H, long long KVH, cudaStream_t stream) {
  static unsigned long long configured = 0;
  const int g = (int)(H / KVH);
  const size_t smem = smem_bytes<D>(g);
  // the largest group launched so far sets the limit; a larger one raises
  // it on every device again. A group the card cannot hold is refused
  // here (cudaErrorInvalidValue) and leaves the limit as it was.
  static size_t limit = 0;
  if (smem > limit) configured = 0;
  const size_t want = smem > limit ? smem : limit;
  cudaError_t err =
      attn::allow_smem(decode_attention_kernel<T, D>, want, &configured);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  limit = want;
  const float scale_log2 = attn::kLog2e / sqrtf((float)D);
  const dim3 grid((unsigned)KVH, (unsigned)B);
  decode_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), q_sb, q_sh, k_sb,
      k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh, (int)S, g, scale_log2);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(long long D, const void* q, const void* k, const void* v,
               const int* lengths, void* o, long long q_sb, long long q_sh,
               long long k_sb, long long k_ss, long long k_sh, long long v_sb,
               long long v_ss, long long v_sh, long long o_sb, long long o_sh,
               long long B, long long S, long long H, long long KVH,
               cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, lengths, o, q_sb, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, o_sb, o_sh, B, S, H, KVH, st);
    case 64:
      return launch<T, 64>(q, k, v, lengths, o, q_sb, q_sh, k_sb, k_ss, k_sh,
                           v_sb, v_ss, v_sh, o_sb, o_sh, B, S, H, KVH, st);
    case 128:
      return launch<T, 128>(q, k, v, lengths, o, q_sb, q_sh, k_sb, k_ss, k_sh,
                            v_sb, v_ss, v_sh, o_sb, o_sh, B, S, H, KVH, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,D] and o [B,H,D] through their (batch, head) strides, k/v
// [B,S,KVH,D] through their (batch, position, head) strides, in elements,
// the D axis contiguous and 16-byte aligned; lengths [B] int32 on the
// device (values above S read S rows). dtype: 0 float32, 1 bfloat16.
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, long long B, long long S, long long H,
    long long KVH, long long D, long long dtype, void* stream) {
  if (H <= 0 || KVH <= 0 || H % KVH) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int* lens = static_cast<const int*>(lengths);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, lens, o, q_sb, q_sh, k_sb, k_ss, k_sh,
                             v_sb, v_ss, v_sh, o_sb, o_sh, B, S, H, KVH, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, lens, o, q_sb, q_sh, k_sb,
                                     k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh,
                                     B, S, H, KVH, st);
  return (int)cudaErrorInvalidValue;
}
