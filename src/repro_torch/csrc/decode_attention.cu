// Single-token GQA decode attention over a KV cache for Hopper (sm_90a),
// bfloat16 or float32 in, float32 arithmetic, output in the input type.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:56
// (decode_attention, Pallas body `_kernel`). For q [B,H,d] (one token per
// sequence), k/v [B,S,KVH,d] and lengths [B], kv head h // (H / KVH),
// scale 1/sqrt(d):
//   out[b,h] = sum_{j < lengths[b]} softmax_j(q . k_j * scale) * v_j
//
// What bounds it on the H100: bytes. Every cached K/V row is used for a
// handful of FMAs (g = H/KVH query heads), ~2 FLOP per byte in bf16 for
// Llama-3.2-1B's g = 4, so reading the cache at 3.35 TB/s is the floor.
//
// Design (split-KV, streamed from device memory):
// * The rows below lengths[b] of one (kv head, sequence) are cut into
//   gridDim.x splits of ceil(length / splits) rows; each split is one
//   block, so a single sequence still spreads over the card (the wrapper
//   picks the count from B * KVH, S and the SM count). The splits of one
//   (kv head, sequence) form a thread-block cluster (at most 8, the
//   portable size): each block leaves its partial (m, l, acc) in its own
//   shared memory, and after cluster.sync() every block combines a share
//   of the outputs from all the partials through distributed shared
//   memory. One launch per call, no scratch, no atomics; one split is a
//   plain launch.
// * Inside a block each warp streams its rows straight from device memory
//   into registers, 16 bytes a lane through the cache's strides (D / 8 or
//   D / 4 lanes per row), a chunk of 2 rows per lane in flight while the
//   previous chunk is scored. Rows at or past lengths[b] are never read.
// * Each loaded K row is scored against all g query heads of the group
//   (q held in registers, pre-scaled by scale * log2(e)); the partial dots
//   are summed across the row's lanes with __shfl_xor. The online softmax
//   (running max and sum per head, exp2f) and P V accumulate in registers,
//   per chunk, not per row.
// * At the end the row groups of a warp combine by __shfl_xor, the warps
//   through shared memory, the splits through the cluster. A split with no
//   row contributes m = -inf, l = 0.
// * A sequence with lengths[b] <= 0 attends uniformly over all S rows, as
//   the Pallas kernel does (every logit masked alike, so p = 1 on every
//   row): it is read as length S with q scaled by 0, so every logit is 0
//   and the online softmax and the split combine give sum_s v[b, s] / S.
// g up to 8 (every config of the repo); a larger group is refused. Head
// widths 32, 64, 128 and 80: a head of 80 runs in the 128-wide lane layout
// (16 or 32 lanes a row, a power of two for the __shfl_xor sums), its
// lanes past column 80 holding zeros and loading nothing.
#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxSplits = 8;  // the portable cluster size
constexpr unsigned kFull = 0xffffffffu;

template <typename T, int D, int G>
struct Layout {
  static constexpr int V = 16 / sizeof(T);  // elements per 16-byte load
  static constexpr int LPR = D / V;         // lanes per cache row
  static constexpr int RPW = 32 / LPR;      // rows per warp-wide load
  static constexpr int NR = 2;              // rows per lane per chunk
  static constexpr int CHUNK = RPW * NR;    // rows per warp per chunk
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  void* o;
  long long q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh;
  int S, g;
  float scale_log2;
};

// (m, l) of two partials merged; returns the factors of each side
__device__ __forceinline__ void merge(float m0, float m1, float* m,
                                      float* a0, float* a1) {
  const float mx = fmaxf(m0, m1);
  const float mu = mx == -INFINITY ? 0.f : mx;  // both empty: factors 0
  *m = mx;
  *a0 = exp2f(m0 - mu);
  *a1 = exp2f(m1 - mu);
}

// at g <= 4 the registers are capped at 128, so that four 4-warp blocks
// (Llama's B=64 grid of 512 blocks in one wave) share an SM
// D is the lane layout's head width (a power of two), DR <= D the head's
// own: lanes whose 16 bytes lie past DR load nothing and hold zeros
template <typename T, int D, int G, int DR = D>
__global__ void __launch_bounds__(kMaxWarps * 32, G <= 4 ? 2 : 1)
    decode_attention_kernel(Args a) {
  using L = Layout<T, D, G>;
  constexpr int V = L::V, LPR = L::LPR, RPW = L::RPW, NR = L::NR;
  constexpr const T* kTag = nullptr;  // picks attn::unpack's overload
  __shared__ float s_m[kMaxWarps][G], s_l[kMaxWarps][G];
  __shared__ __align__(16) float s_acc[kMaxWarps][G][D];
  __shared__ float s_pm[G], s_pl[G];            // this split's partial
  __shared__ __align__(16) float s_pacc[G][D];

  const int split = blockIdx.x, n_split = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const int sub = lane % LPR, grp = lane / LPR;  // d chunk, row in a load
  const bool live = sub * V < DR;                // the chunk is the head's
  const bool empty = a.lengths[b] <= 0;  // uniform over all S rows
  const int len = empty ? a.S : min(a.lengths[b], a.S);
  const float q_scale = empty ? 0.f : a.scale_log2;
  const int per = (len + n_split - 1) / n_split;
  const int r0 = min(len, split * per), r1 = min(len, r0 + per);
  const int g = a.g, h0 = kvh * g;

  float qr[G][V], m[G], l[G], acc[G][V];
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h0 * a.q_sh + sub * V;
#pragma unroll
  for (int hh = 0; hh < G; ++hh) {
    if (hh < g && live) {
      attn::load_vec(qp + hh * a.q_sh, qr[hh]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) qr[hh][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      qr[hh][e] *= q_scale;
      acc[hh][e] = 0.f;
    }
    m[hh] = -INFINITY;
    l[hh] = 0.f;
  }

  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh + sub * V;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh + sub * V;
  // this lane's rows of the chunk at c0: c0 + grp + j * RPW, j < NR
  auto fetch = [&](int c0, uint4* kd, uint4* vd) {
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int row = c0 + grp + j * RPW;
      if (row < r1 && live) {
        kd[j] = __ldg(reinterpret_cast<const uint4*>(kp + row * a.k_ss));
        vd[j] = __ldg(reinterpret_cast<const uint4*>(vp + row * a.v_ss));
      } else {
        kd[j] = vd[j] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  const int step = n_warps * L::CHUNK;
  int c0 = r0 + warp * L::CHUNK;  // warp-uniform
  uint4 kc[NR], vc[NR];
  fetch(c0, kc, vc);
  for (; c0 < r1; c0 += step) {
    uint4 kn[NR], vn[NR];
    fetch(c0 + step, kn, vn);  // the next chunk flies while this one is used

    float s[NR][G];
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      float kf[V];
      attn::unpack(kc[j], kTag, kf);
#pragma unroll
      for (int hh = 0; hh < G; ++hh) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < V; ++e) d = fmaf(qr[hh][e], kf[e], d);
        s[j][hh] = d;
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int j = 0; j < NR; ++j)
#pragma unroll
        for (int hh = 0; hh < G; ++hh)
          s[j][hh] += __shfl_xor_sync(kFull, s[j][hh], off);
#pragma unroll
    for (int j = 0; j < NR; ++j)
      if (c0 + grp + j * RPW >= r1)
#pragma unroll
        for (int hh = 0; hh < G; ++hh) s[j][hh] = -INFINITY;

#pragma unroll
    for (int hh = 0; hh < G; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int j = 0; j < NR; ++j) mx = fmaxf(mx, s[j][hh]);
      const float mu = mx == -INFINITY ? 0.f : mx;  // no row yet
      const float alpha = exp2f(m[hh] - mu);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        s[j][hh] = exp2f(s[j][hh] - mu);
        sum += s[j][hh];
      }
      l[hh] = l[hh] * alpha + sum;
      m[hh] = mx;
#pragma unroll
      for (int e = 0; e < V; ++e) acc[hh][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      float vf[V];
      attn::unpack(vc[j], kTag, vf);
#pragma unroll
      for (int hh = 0; hh < G; ++hh)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[hh][e] = fmaf(s[j][hh], vf[e], acc[hh][e]);
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      kc[j] = kn[j];
      vc[j] = vn[j];
    }
  }

  // the warp's row groups, by __shfl_xor over the lanes of one d chunk
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
    for (int hh = 0; hh < G; ++hh) {
      const float mo = __shfl_xor_sync(kFull, m[hh], off);
      const float lo = __shfl_xor_sync(kFull, l[hh], off);
      float a0, a1;
      merge(m[hh], mo, &m[hh], &a0, &a1);
      l[hh] = l[hh] * a0 + lo * a1;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const float ao = __shfl_xor_sync(kFull, acc[hh][e], off);
        acc[hh][e] = acc[hh][e] * a0 + ao * a1;
      }
    }
  if (grp == 0) {
#pragma unroll
    for (int hh = 0; hh < G; ++hh) {
#pragma unroll
      for (int e = 0; e < V; ++e) s_acc[warp][hh][sub * V + e] = acc[hh][e];
      if (sub == 0) {
        s_m[warp][hh] = m[hh];
        s_l[warp][hh] = l[hh];
      }
    }
  }
  __syncthreads();

  // the warps, through shared memory: this split's partial, or the output
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h0 * a.o_sh;
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int hh = i / D, c = i - hh * D;
    float mx = -INFINITY;
    for (int w = 0; w < n_warps; ++w) mx = fmaxf(mx, s_m[w][hh]);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float sl = 0.f, sa = 0.f;
    for (int w = 0; w < n_warps; ++w) {
      const float f = exp2f(s_m[w][hh] - mu);
      sl += s_l[w][hh] * f;
      sa += s_acc[w][hh][c] * f;
    }
    if (n_split == 1) {
      if (hh < g && c < DR)
        op[hh * a.o_sh + c] = attn::from_f32<T>(sl > 0.f ? sa / sl : 0.f);
    } else {
      s_pacc[hh][c] = sa;
      if (c == 0) {
        s_pm[hh] = mx;
        s_pl[hh] = sl;
      }
    }
  }
  if (n_split == 1) return;

  // the splits, through the cluster's distributed shared memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  for (int i = rank * blockDim.x + tid; i < G * D; i += n_split * blockDim.x) {
    const int hh = i / D, c = i - hh * D;
    if (hh >= g || c >= DR) continue;
    float mx = -INFINITY;
    for (int r = 0; r < n_split; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(&s_pm[0], r)[hh]);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float sl = 0.f, sa = 0.f;
    for (int r = 0; r < n_split; ++r) {
      const float f = exp2f(cluster.map_shared_rank(&s_pm[0], r)[hh] - mu);
      sl += cluster.map_shared_rank(&s_pl[0], r)[hh] * f;
      sa += cluster.map_shared_rank(&s_pacc[0][0], r)[hh * D + c] * f;
    }
    op[hh * a.o_sh + c] = attn::from_f32<T>(sl > 0.f ? sa / sl : 0.f);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename T, int D, int G, int DR>
int launch(const Args& a, long long B, long long KVH, int n_split,
           int n_warps, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, D, G, DR>;
  const dim3 grid((unsigned)n_split, (unsigned)KVH, (unsigned)B);
  const dim3 block((unsigned)(32 * n_warps));
  if (n_split == 1) {
    kernel<<<grid, block, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so the next launch does not report it
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T, int D, int DR = D>
int dispatch_g(const Args& a, long long B, long long KVH, int n_split,
               int n_warps, cudaStream_t st) {
  if (a.g <= 1) return launch<T, D, 1, DR>(a, B, KVH, n_split, n_warps, st);
  if (a.g <= 2) return launch<T, D, 2, DR>(a, B, KVH, n_split, n_warps, st);
  if (a.g <= 4) return launch<T, D, 4, DR>(a, B, KVH, n_split, n_warps, st);
  if (a.g <= 8) return launch<T, D, 8, DR>(a, B, KVH, n_split, n_warps, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_d(long long D, const Args& a, long long B, long long KVH,
               int n_split, int n_warps, cudaStream_t st) {
  switch (D) {
    case 32:
      return dispatch_g<T, 32>(a, B, KVH, n_split, n_warps, st);
    case 64:
      return dispatch_g<T, 64>(a, B, KVH, n_split, n_warps, st);
    case 80:
      return dispatch_g<T, 128, 80>(a, B, KVH, n_split, n_warps, st);
    case 128:
      return dispatch_g<T, 128>(a, B, KVH, n_split, n_warps, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B,H,D] and o [B,H,D] through their (batch, head) strides, k/v
// [B,S,KVH,D] through their (batch, position, head) strides, in elements,
// the D axis contiguous and 16-byte aligned; lengths [B] int32 on the
// device (values above S read S rows, values <= 0 average all S rows, as
// the Pallas kernel does). n_split in
// [1, 8] blocks per (kv head, sequence), a cluster when above 1; n_warps
// in [1, 8] per block. dtype: 0 float32, 1 bfloat16. Returns the launch's
// error, else cudaGetLastError() after it.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* lengths, void* o,
    long long q_sb, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_sh, long long B, long long S, long long H,
    long long KVH, long long D, long long n_split, long long n_warps,
    long long dtype, void* stream) {
  if (H <= 0 || KVH <= 0 || H % KVH) return (int)cudaErrorInvalidValue;
  if (n_split < 1 || n_split > kMaxSplits || n_warps < 1 ||
      n_warps > kMaxWarps)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int*>(lengths);
  a.o = o;
  a.q_sb = q_sb, a.q_sh = q_sh;
  a.k_sb = k_sb, a.k_ss = k_ss, a.k_sh = k_sh;
  a.v_sb = v_sb, a.v_ss = v_ss, a.v_sh = v_sh;
  a.o_sb = o_sb, a.o_sh = o_sh;
  a.S = (int)S;
  a.g = (int)(H / KVH);
  a.scale_log2 = attn::kLog2e / sqrtf((float)D);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, a, B, KVH, (int)n_split, (int)n_warps, st);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, a, B, KVH, (int)n_split,
                                     (int)n_warps, st);
  return (int)cudaErrorInvalidValue;
}
