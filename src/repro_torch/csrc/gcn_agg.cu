// Eq-12 bipartite GCN aggregation for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel repro/kernels/gcn_agg.py::gcn_agg (Pallas body
// `_kernel`). Per graph b:
//   deg = sum_o adj[m, o];  agg = (adj @ hn) / (deg + 1e-6)
//   out = relu(hs @ Ws + agg @ Wn + bias)
//
// What bounds it on the H100: neither the bytes nor the FLOPs. At the
// actor's shapes (M=14 devices, O=10 options, widths 4..128) one graph is
// ~0.1 MFLOP and ~10 KB, and a slot has only B = #fleets graphs, so the
// card is bound by latency: launch overhead and the serial dependency
// load -> deg -> agg -> output inside one block.
//
// Design: one thread block per graph. The graph's adjacency and both
// feature tiles are staged in shared memory, deg and agg [M, Fn] are
// computed there, then each thread owns output elements (m, h) with h
// fastest, so a warp reads a weight row coalesced from L2/L1 (the weights
// are shared by every block and stay cache-resident) and the shared-memory
// operand is a broadcast. Sums are float32. The adjacency is read through
// strides, so the transposed view the option-side layer uses needs no copy.
// Later work: several graphs per block, mma.sync for layer 2, and fusing
// the four launches of one actor forward.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void gcn_agg_kernel(const float* __restrict__ adj,
                               const float* __restrict__ hs,
                               const float* __restrict__ hn,
                               const float* __restrict__ ws,
                               const float* __restrict__ wn,
                               const float* __restrict__ bias,
                               float* __restrict__ out,
                               long long adj_sb, long long adj_sm,
                               long long adj_so, int M, int O, int Fs, int Fn,
                               int H) {
  extern __shared__ float smem[];
  float* s_adj = smem;               // [M, O]
  float* s_hs = s_adj + M * O;       // [M, Fs]
  float* s_hn = s_hs + M * Fs;       // [O, Fn]
  float* s_agg = s_hn + O * Fn;      // [M, Fn]
  float* s_deg = s_agg + M * Fn;     // [M], deg + eps

  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  const float* adj_b = adj + b * adj_sb;
  for (int i = tid; i < M * O; i += nt) {
    const int m = i / O, o = i - (i / O) * O;
    s_adj[i] = adj_b[m * adj_sm + o * adj_so];
  }
  const float* hs_b = hs + b * M * Fs;
  for (int i = tid; i < M * Fs; i += nt) s_hs[i] = hs_b[i];
  const float* hn_b = hn + b * O * Fn;
  for (int i = tid; i < O * Fn; i += nt) s_hn[i] = hn_b[i];
  __syncthreads();

  for (int m = tid; m < M; m += nt) {
    float d = 0.f;
    for (int o = 0; o < O; ++o) d += s_adj[m * O + o];
    s_deg[m] = d + 1e-6f;
  }
  __syncthreads();

  for (int i = tid; i < M * Fn; i += nt) {
    const int m = i / Fn, f = i - (i / Fn) * Fn;
    float a = 0.f;
    for (int o = 0; o < O; ++o) a = fmaf(s_adj[m * O + o], s_hn[o * Fn + f], a);
    s_agg[i] = a / s_deg[m];
  }
  __syncthreads();

  float* out_b = out + b * M * H;
  for (int i = tid; i < M * H; i += nt) {
    const int m = i / H, h = i - (i / H) * H;
    float p = 0.f;
    for (int f = 0; f < Fs; ++f) p = fmaf(s_hs[m * Fs + f], __ldg(ws + f * H + h), p);
    float q = 0.f;
    for (int f = 0; f < Fn; ++f) q = fmaf(s_agg[m * Fn + f], __ldg(wn + f * H + h), q);
    out_b[i] = fmaxf(p + q + __ldg(bias + h), 0.f);
  }
}

}  // namespace

// adj is read through (batch, row, col) strides in elements; every other
// operand is contiguous. Returns cudaGetLastError() after the launch.
extern "C" int gcn_agg_f32(const float* adj, const float* hs, const float* hn,
                           const float* ws, const float* wn, const float* bias,
                           float* out, long long adj_sb, long long adj_sm,
                           long long adj_so, long long B, long long M,
                           long long O, long long Fs, long long Fn,
                           long long H, void* stream) {
  const size_t smem = sizeof(float) * (M * O + M * Fs + O * Fn + M * Fn + M);
  gcn_agg_kernel<<<dim3((unsigned)B), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      adj, hs, hn, ws, wn, bias, out, adj_sb, adj_sm, adj_so, (int)M, (int)O,
      (int)Fs, (int)Fn, (int)H);
  return (int)cudaGetLastError();
}
