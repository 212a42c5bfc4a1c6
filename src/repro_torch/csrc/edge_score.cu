// Eq-13/14 fused edge scorer for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel repro/kernels/edge_score.py::edge_score (Pallas
// body `_kernel`). Per graph b:
//   src = hs @ Ws + bs  [M, E];   dst = hd @ Wd  [O, E]
//   logits[m, o] = sum_e relu(src[m, e] + dst[o, e] + ef[m, o] * wf[e]) * wo[e] + bo
// The [M, O, E] hidden is never written to device memory.
//
// What bounds it on the H100: at the actor's shapes (M = 14, O = 10,
// H = E = 64) a graph is ~0.2 MFLOP over ~7 KB of its own inputs. Up to a
// few hundred graphs a launch is bound by latency (launch, weight staging,
// the 64-long chains); at B = 1024 by float32 FMA issue in the two
// projections and shared-memory reads in the pair loop.
//
// Design: G consecutive graphs share a block (kernels/edge_score.py; G = 1
// up to one graph per SM, more at large B so that the 32 KB of weights
// staged per block serve several graphs). A block
//   1. stages W_src and W_dst whole, its graphs' hs and hd rows, w_feat and
//      w_out in shared memory, dense: six bulk copies of the Tensor Memory
//      Accelerator on one transaction barrier, issued from six warps, where
//      the widths are whole 16-byte chunks; cp.async rows otherwise;
//   2. computes src [G*M, E] and dst [G*O, E] as register-tiled products,
//      a 4 x 4 float32 micro-tile per thread read as float4s, into
//      shared-memory rows padded so that the pair loop reads them without
//      bank conflicts;
//   3. runs the G*M*O (m, o) pairs one per thread, e four at a time from
//      float4s, and writes the logits coalesced.
// H = E = 64 (the actor's widths) are compile-time, so the loops run fixed
// counts, two steps an iteration (a block runs each loop once: fully
// unrolled, its code would wait on the instruction cache line by line);
// one runtime instance takes every other width.
#include "actor_common.cuh"

namespace {

using actor::odd_ld;
using actor::up4;

constexpr int kMaxThreads = 576;    // two blocks share an SM at <= 56 registers

// A block's shared memory, in floats; each region starts on 16 bytes.
struct Layout {
  long long kld, eld, pld, ws, wd, hs, hd, src, dst, wf, wo, floats;
  __host__ __device__ Layout(long long G, long long M, long long O,
                             long long H, long long E) {
    kld = up4(H);                     // hs, hd rows, dense
    eld = up4(E);                     // weight rows, dense
    pld = odd_ld(E);                  // src, dst rows
    ws = 4;                           // the barrier, at 0
    wd = ws + up4(H) * eld;           // W_src: [up4(H)][eld]
    hs = wd + up4(H) * eld;           // W_dst: [up4(H)][eld]
    hd = hs + up4(G * M) * kld;       // hs: [up4(G*M)][kld]
    src = hd + up4(G * O) * kld;      // hd: [up4(G*O)][kld]
    dst = src + G * M * pld;          // src: [G*M][pld]
    wf = dst + G * O * pld;           // dst: [G*O][pld]
    wo = wf + up4(E);                 // w_feat, w_out: [up4(E)] each
    floats = wo + up4(E);
  }
};

// threads of a block: one per micro-tile of the projections or per pair,
// whichever is more, up to kMaxThreads (the loops below stride)
__host__ __device__ inline int block_threads(long long G, long long M,
                                             long long O, long long E) {
  const long long units = (up4(G * M) + up4(G * O)) / 4 * (up4(E) / 4);
  const long long pairs = G * M * O;
  const long long want = ((units > pairs ? units : pairs) + 31) / 32 * 32;
  return (int)(want < kMaxThreads ? want : kMaxThreads);
}

// the actor's widths: two blocks of up to kMaxThreads share an SM
template <int HC, int EC>
__global__ void __launch_bounds__(kMaxThreads, HC > 0 ? 2 : 1)
    edge_score_kernel(const float* __restrict__ hs, const float* __restrict__ hd,
                      const float* __restrict__ ef, const float* __restrict__ ws,
                      const float* __restrict__ bs, const float* __restrict__ wd,
                      const float* __restrict__ wf, const float* __restrict__ wo,
                      const float* __restrict__ bo, float* __restrict__ out,
                      long long B, int M, int O, int H_, int E_, int G) {
  const int H = HC > 0 ? HC : H_, E = EC > 0 ? EC : E_;
  const int H4 = (int)up4(H), E4 = (int)up4(E);
  const Layout L(G, M, O, H, E);
  const int kld = (int)L.kld, eld = (int)L.eld, pld = (int)L.pld;
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* sWs = smem + L.ws;
  float* sWd = smem + L.wd;
  float* sHs = smem + L.hs;
  float* sHd = smem + L.hd;
  float* sSrc = smem + L.src;
  float* sDst = smem + L.dst;
  float* sWf = smem + L.wf;
  float* sWo = smem + L.wo;

  const int tid = threadIdx.x, nt = blockDim.x;
  const long long b0 = (long long)blockIdx.x * G;
  const int ng = (int)min((long long)G, B - b0);
  const int nm = ng * M, no = ng * O;

  if (tid == 0) {  // six arrivals: one per operand
    actor::bar_init(bar, 6);
    actor::bar_fence_init();
  }
  __syncthreads();

  // 1. weights whole, the graphs' rows, w_feat and w_out: at dense widths
  // one bulk copy each on the barrier, issued from six warps (odd blocks
  // fetch W_dst first, so that not all read the same lines of L2 at once);
  // else cp.async rows in one group
  const float* hs0 = hs + b0 * M * H;
  const float* hd0 = hd + b0 * O * H;
  for (int j = 0; j < 2; ++j) {
    const bool src_side = (j + blockIdx.x) % 2 == 0;
    actor::stage(src_side ? sWs : sWd, eld, src_side ? ws : wd, E, H, E, bar,
                 actor::issuer(j, nt), tid, nt);
  }
  actor::stage(sHs, kld, hs0, H, nm, H, bar, actor::issuer(2, nt), tid, nt);
  actor::stage(sHd, kld, hd0, H, no, H, bar, actor::issuer(3, nt), tid, nt);
  actor::stage(sWf, E4, wf, E, 1, E, bar, actor::issuer(4, nt), tid, nt);
  actor::stage(sWo, E4, wo, E, 1, E, bar, actor::issuer(5, nt), tid, nt);
  actor::cp_async_commit();
  // the padding that the float4 loops read is zero, so that no stale
  // value (NaN, Inf) of an earlier launch enters a sum
  actor::zero_cols(sWs + H * eld, 0, 1, 0, (H4 - H) * eld, tid, nt);  // rows H..H4-1
  actor::zero_cols(sWd + H * eld, 0, 1, 0, (H4 - H) * eld, tid, nt);
  actor::zero_cols(sHs, kld, nm, H, H4, tid, nt);
  actor::zero_cols(sHd, kld, no, H, H4, tid, nt);
  actor::zero_cols(sWf, E4, 1, E, E4, tid, nt);
  actor::zero_cols(sWo, E4, 1, E, E4, tid, nt);
  actor::cp_async_wait_all();
  actor::bar_wait(bar, 0);
  __syncthreads();

  // 2. src = hs @ Ws + bs and dst = hd @ Wd, one 4 x 4 micro-tile per unit;
  // columns E..E4-1 are written as zeros
  const int ntx = E4 / 4;
  const int n_src = (int)(up4(nm) / 4) * ntx;
  const int n_units = n_src + (int)(up4(no) / 4) * ntx;
  for (int u = tid; u < n_units; u += nt) {
    const bool is_src = u < n_src;
    const int v = is_src ? u : u - n_src;
    const int ty = v / ntx, tx = v - ty * ntx;
    const float* a = (is_src ? sHs : sHd) + ty * 4 * kld;
    const float* w = (is_src ? sWs : sWd) + tx * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < H4; k += 4) {
      float4 av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + i * kld + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 wv = *reinterpret_cast<const float4*>(w + (k + j) * eld);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = actor::lane(av[i], j);
          acc[i][0] = fmaf(x, wv.x, acc[i][0]);
          acc[i][1] = fmaf(x, wv.y, acc[i][1]);
          acc[i][2] = fmaf(x, wv.z, acc[i][2]);
          acc[i][3] = fmaf(x, wv.w, acc[i][3]);
        }
      }
    }
    float* o = is_src ? sSrc : sDst;
    const int nr = is_src ? nm : no;
    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bias[j] = is_src && tx * 4 + j < E ? __ldg(bs + tx * 4 + j) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ty * 4 + i >= nr) break;
      float y[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = tx * 4 + j < E ? acc[i][j] + bias[j] : 0.f;
      *reinterpret_cast<float4*>(o + (ty * 4 + i) * pld + tx * 4) =
          make_float4(y[0], y[1], y[2], y[3]);
    }
  }
  __syncthreads();

  // 3. one (m, o) pair per thread; the 4 partial sums take e mod 4
  const int mo = M * O;
  const float b_out = __ldg(bo);
  const float4* f4 = reinterpret_cast<const float4*>(sWf);
  const float4* w4 = reinterpret_cast<const float4*>(sWo);
  for (int p = tid; p < ng * mo; p += nt) {
    const int row = p / O;                     // g * M + m
    const int g = p / mo, opt = p - row * O;
    const float4* s4 = reinterpret_cast<const float4*>(sSrc + row * pld);
    const float4* d4 = reinterpret_cast<const float4*>(sDst + (g * O + opt) * pld);
    const float x = __ldg(ef + b0 * mo + p);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int e = 0; e < E4 / 4; ++e) {
      const float4 s = s4[e], d = d4[e], f = f4[e], w = w4[e];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float h =
            fmaf(x, actor::lane(f, j), actor::lane(s, j) + actor::lane(d, j));
        acc[j] = fmaf(fmaxf(h, 0.f), actor::lane(w, j), acc[j]);
      }
    }
    out[b0 * mo + p] = (acc[0] + acc[1]) + (acc[2] + acc[3]) + b_out;
  }
}

// One compiled instance, with its shared-memory opt-in.
template <int HC, int EC>
struct Instance {
  static auto fn() { return edge_score_kernel<HC, EC>; }
  static cudaError_t prepare() {
    static unsigned long long done = 0;
    return actor::allow_smem(fn(), &done);
  }
};

// f(Instance) for widths H, E; the actor's H = E = 64 has its own
template <typename F>
int with_instance(long long H, long long E, F&& f) {
  if (H == 64 && E == 64) return f(Instance<64, 64>{});
  return f(Instance<0, 0>{});
}

bool valid(long long M, long long O, long long H, long long E, long long G) {
  return M > 0 && O > 0 && H >= 0 && E >= 0 && G > 0;
}

size_t smem_of(long long M, long long O, long long H, long long E,
               long long G) {
  return sizeof(float) * Layout(G, M, O, H, E).floats;
}

}  // namespace

// Every operand is contiguous; G graphs per block (kernels/edge_score.py).
// Returns cudaGetLastError() after the launch.
extern "C" int edge_score_f32(const float* hs, const float* hd, const float* ef,
                              const float* ws, const float* bs, const float* wd,
                              const float* wf, const float* wo, const float* bo,
                              float* out, long long B, long long M, long long O,
                              long long H, long long E, long long G,
                              void* stream) {
  if (!valid(M, O, H, E, G)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const dim3 grid((unsigned)((B + G - 1) / G));
  return with_instance(H, E, [&](auto inst) {
    using I = decltype(inst);
    const cudaError_t err = I::prepare();
    if (err != cudaSuccess) return (int)err;
    I::fn()<<<grid, block_threads(G, M, O, E), smem_of(M, O, H, E, G),
              static_cast<cudaStream_t>(stream)>>>(
        hs, hd, ef, ws, bs, wd, wf, wo, bo, out, B, (int)M, (int)O, (int)H,
        (int)E, (int)G);
    return (int)cudaGetLastError();
  });
}

// The dynamic shared memory of one block of that launch, in bytes;
// negative (minus a CUDA error) for a shape the kernel does not take.
extern "C" long long edge_score_smem_bytes(long long M, long long O,
                                           long long H, long long E,
                                           long long G) {
  if (!valid(M, O, H, E, G)) return -(long long)cudaErrorInvalidValue;
  return (long long)smem_of(M, O, H, E, G);
}

// How many blocks of that launch one SM of the current device runs at
// once; negative (minus a CUDA error) if it cannot be configured.
extern "C" long long edge_score_blocks_per_sm(long long M, long long O,
                                              long long H, long long E,
                                              long long G) {
  if (!valid(M, O, H, E, G)) return -(long long)cudaErrorInvalidValue;
  int blocks = 0;
  const int err = with_instance(H, E, [&](auto inst) {
    using I = decltype(inst);
    cudaError_t e = I::prepare();
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, I::fn(), block_threads(G, M, O, E), smem_of(M, O, H, E, G));
    return (int)e;
  });
  return err ? -(long long)err : (long long)blocks;
}
