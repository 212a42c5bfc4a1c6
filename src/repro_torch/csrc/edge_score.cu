// Eq-13/14 fused edge scorer for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel repro/kernels/edge_score.py::edge_score (Pallas
// body `_kernel`). Per graph b:
//   src = hs @ Ws + bs  [M, E];   dst = hd @ Wd  [O, E]
//   logits[m, o] = sum_e relu(src[m, e] + dst[o, e] + ef[m, o] * wf[e]) * wo[e] + bo
// The [M, O, E] hidden is never written to device memory.
//
// What bounds it on the H100: latency, as for gcn_agg. At the actor's
// shapes (M=14, O=10, H=E=64) one graph is ~0.2 MFLOP over ~7 KB of its
// own inputs, and a slot scores only B = #fleets graphs.
//
// Design: one thread block per graph. hs and hd are staged in shared
// memory; src and dst are computed into shared memory (rows padded by one
// float so the pair loop below reads them without bank conflicts); then
// each thread takes (m, o) pairs and loops over e, accumulating
// relu(.) * wo in a register. Weights are read through L2/L1 (shared by
// every block). Later work: several graphs per block, and fusing this
// launch with the last gcn_agg layer.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void edge_score_kernel(const float* __restrict__ hs,
                                  const float* __restrict__ hd,
                                  const float* __restrict__ ef,
                                  const float* __restrict__ ws,
                                  const float* __restrict__ bs,
                                  const float* __restrict__ wd,
                                  const float* __restrict__ wf,
                                  const float* __restrict__ wo,
                                  const float* __restrict__ bo,
                                  float* __restrict__ out, int M, int O,
                                  int H, int E) {
  extern __shared__ float smem[];
  const int ld = E + 1;                  // padded row of src/dst
  float* s_hs = smem;                    // [M, H]
  float* s_hd = s_hs + M * H;            // [O, H]
  float* s_src = s_hd + O * H;           // [M, ld]
  float* s_dst = s_src + M * ld;         // [O, ld]
  float* s_wf = s_dst + O * ld;          // [E]
  float* s_wo = s_wf + E;                // [E]

  const long long b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  const float* hs_b = hs + b * M * H;
  for (int i = tid; i < M * H; i += nt) s_hs[i] = hs_b[i];
  const float* hd_b = hd + b * O * H;
  for (int i = tid; i < O * H; i += nt) s_hd[i] = hd_b[i];
  for (int i = tid; i < E; i += nt) {
    s_wf[i] = wf[i];
    s_wo[i] = wo[i];
  }
  __syncthreads();

  for (int i = tid; i < (M + O) * E; i += nt) {
    const int r = i / E, e = i - (i / E) * E;
    float acc = 0.f;
    if (r < M) {
      for (int h = 0; h < H; ++h) acc = fmaf(s_hs[r * H + h], __ldg(ws + h * E + e), acc);
      s_src[r * ld + e] = acc + __ldg(bs + e);
    } else {
      const int o = r - M;
      for (int h = 0; h < H; ++h) acc = fmaf(s_hd[o * H + h], __ldg(wd + h * E + e), acc);
      s_dst[o * ld + e] = acc;
    }
  }
  __syncthreads();

  const float* ef_b = ef + b * M * O;
  float* out_b = out + b * M * O;
  const float b_out = __ldg(bo);
  for (int p = tid; p < M * O; p += nt) {
    const int m = p / O, o = p - (p / O) * O;
    const float x_ef = ef_b[p];
    const float* src = s_src + m * ld;
    const float* dst = s_dst + o * ld;
    float acc = 0.f;
    for (int e = 0; e < E; ++e) {
      const float x = src[e] + dst[e] + x_ef * s_wf[e];
      acc = fmaf(fmaxf(x, 0.f), s_wo[e], acc);
    }
    out_b[p] = acc + b_out;
  }
}

}  // namespace

// Every operand is contiguous. Returns cudaGetLastError() after the launch.
extern "C" int edge_score_f32(const float* hs, const float* hd, const float* ef,
                              const float* ws, const float* bs, const float* wd,
                              const float* wf, const float* wo, const float* bo,
                              float* out, long long B, long long M, long long O,
                              long long H, long long E, void* stream) {
  const size_t smem =
      sizeof(float) * (M * H + O * H + (M + O) * (E + 1) + 2 * E);
  edge_score_kernel<<<dim3((unsigned)B), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      hs, hd, ef, ws, bs, wd, wf, wo, bo, out, (int)M, (int)O, (int)H, (int)E);
  return (int)cudaGetLastError();
}
