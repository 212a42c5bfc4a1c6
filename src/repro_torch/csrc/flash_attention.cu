// Causal (optionally windowed) GQA flash attention for Hopper (sm_90a),
// bfloat16 or float32 in, float32 softmax state, output in the input type.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:70
// (flash_attention, Pallas body `_kernel`). For q [B,S,H,d], k/v
// [B,S,KVH,d], kv head h // (H / KVH), scale 1/sqrt(d):
//   out[b,i,h] = sum_j softmax_j(q_i . k_j * scale  | j <= i, i - j < window)
//                * v_j
//
// What bounds it on the H100: operations. At the prefill shape of
// Llama-3.2-1B (B=4, S=2048, H=32, KVH=8, d=64, bf16) the causal half is
// ~69 GFLOP against ~42 MB of input and output, ~1600 FLOP per byte, far
// above the card's ~295 (bf16) ridge, so only the tensor cores can bring
// it near its bound.
//
// bfloat16 (the serving path), `flash_attention_kernel`: one block of two
// warpgroups per (128-row query tile, q head, batch); each warpgroup owns
// 64 query rows and runs both products on the tensor cores as
// wgmma.mma_async m64nNk16 with float32 accumulators in registers:
// S = Q K^T with Q and K read from shared memory by descriptors (both
// K-major), O += P V with P from registers and V by a transposing
// descriptor (MN-major). Q, K and V tiles sit in shared memory in the
// canonical swizzled layouts wgmma reads (rows of 128 bytes, or 64 at
// d = 32, their 16-byte chunks XOR-swizzled by row, so no bank conflicts),
// written there by cp.async.cg 16-byte copies; the 64-row K/V tiles come
// in through a ring of 4 stages (3 at d = 128), two tiles ahead, with one
// __syncthreads per tile. The loop is software-pipelined per warpgroup:
// tile j+1's Q K^T and tile j's P V start together, and the softmax
// of tile j+1 waits only for the former. The online softmax lives in
// registers: the running max is kept on raw scores and scale * log2(e)
// is applied inside ex2.approx's argument (one fmaf a score); each row's
// max and sum are kept by the quad of lanes that holds it (max by
// __shfl_xor; the sum stays per lane until the end), and P is rounded to
// bf16 in registers, where the accumulator layout of S is the A-fragment
// layout of P V; scores never touch shared memory. Tiles wholly past the
// causal diagonal or before the window are skipped by the block (not by a
// warpgroup: see the loop); only the diagonal tiles, the window's edge and
// the ragged tail past S are masked. The output is divided by the row sum
// and staged through the warp's own rows of the Q tile, so each store to
// [B,S,H,d] is 16 bytes.
//
// float32 (the golden replays and the tests), `flash_attention_f32_kernel`:
// tensor cores on float32 would mean TF32, about three decimal digits, so
// float32 keeps the CUDA-core design: 256 threads per query tile, each K/V
// tile staged as float32 in shared memory (rows padded by one float), S and
// P V as 4x4 and 4 x d/16 register micro-tiles of fmaf, the softmax with
// four threads per row.
//
// Head widths: 32, 64, 128 and 80 (StableLM-3B, Zamba2's shared block). In
// bfloat16 a head of 80 runs in the 128-wide layout with its last 48
// columns zero-filled (rows of 160 bytes fit no 128-byte swizzle atom), at
// the cost of 128-wide products; float32 takes 80 as it is.
//
// Both read Q, K and V through their (batch, position, head) strides, so the
// [B,S,H,d] layout needs no transposed copy and the shared K/V of a GQA
// group is never expanded, and take query tiles heaviest first (the last
// tiles of a causal row see the most keys).
#include <stdint.h>

#include "attention_common.cuh"

namespace {

constexpr int kBk = 64;  // key rows per tile

struct Strides {
  long long b, s, h;  // in elements; the head_dim axis is contiguous
};

// Key tiles [begin, end) that a query tile of bq rows at q0 sees.
__device__ __forceinline__ void key_tiles(int q0, int bq, int S, int causal,
                                          int window, int* begin, int* end) {
  int e = (S + kBk - 1) / kBk;
  if (causal) e = min(e, (min(q0 + bq, S) - 1) / kBk + 1);
  int bgn = 0;
  if (window > 0 && q0 - window + 1 > 0) bgn = (q0 - window + 1) / kBk;
  *begin = bgn;
  *end = e;
}

// ------------------------------------------------------------------ bf16
using bf16 = __nv_bfloat16;
constexpr int kWarpgroups = 2;
constexpr int kMmaThreads = 128 * kWarpgroups;

template <int D>
struct MmaCfg {
  static constexpr int kBq = 64 * kWarpgroups;  // query rows per block
  static constexpr int kStages = D <= 64 ? 4 : 3;  // >= 3: see the loop
  // Q, K and V tiles: [rows][D] in column blocks of kRow bytes (the
  // swizzle width, 128 or 64), 16-byte chunks of row r XOR-swizzled by r
  static constexpr int kRow = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kSwizzle = kRow == 128 ? 1 : 2;  // descriptor mode
  static constexpr int kTile = kBk * D * 2;             // bytes per K/V stage
  static constexpr size_t kSmem = 1024 + 2 * kStages * kTile + kBq * D * 2;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16-byte asynchronous copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  // make the copies visible to the tensor cores' (async proxy) reads
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// two floats as one register of bf16 pairs, the first in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets, swizzle mode (the tile's base is 1024-aligned)
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, int lbo,
                                              int sbo, int swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups of this warpgroup's wgmma run
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers that order the warpgroups' turns at the tensor cores
// (ping-pong): warpgroup w waits on barrier 1 + w, then lets the next one
// go; each barrier counts the 2 x 128 threads of the two warpgroups.
__device__ __forceinline__ void turn_wait(int wg) {
  if constexpr (kWarpgroups > 1)
    asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  if constexpr (kWarpgroups > 1)
    asm volatile("bar.arrive %0, 256;\n" ::"r"(1 + (wg + 1) % kWarpgroups)
                 : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// Pins registers that a wgmma reads (its accumulators, its A fragments) to
// this point of the program: without it the compiler may compute them after
// the wgmma.fence that must follow their last write.
template <int N>
__device__ __forceinline__ void hold(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(unsigned* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d += a b, m64n32k16, A (bf16) from registers, B MN-major by descriptor
__device__ __forceinline__ void wgmma_n32(float* d, const unsigned* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(1));
}

// d += a b, m64n64k16, A (bf16) from registers, B MN-major by descriptor
__device__ __forceinline__ void wgmma_n64(float* d, const unsigned* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(1));
}

// d += a b, m64n128k16, A (bf16) from registers, B MN-major by descriptor
__device__ __forceinline__ void wgmma_n128(float* d, const unsigned* a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1),
        "n"(1));
}

// d = a b (accumulate 0) or d += a b, m64n64k16, A and B by descriptor,
// both K-major
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float* d, const unsigned* a,
                                         uint64_t b) {
  if constexpr (D == 32) wgmma_n32(d, a, b);
  if constexpr (D == 64) wgmma_n64(d, a, b);
  if constexpr (D == 128) wgmma_n128(d, a, b);
}

// byte offset of 16-byte chunk c of row r in a swizzled tile of R rows
template <int D, int R>
__device__ __forceinline__ int swizzled(int r, int c) {
  constexpr int RB = MmaCfg<D>::kRow, CPB = RB / 16;  // chunks per block
  const int x = RB == 128 ? (r & 7) : ((r >> 1) & 3);
  return (c / CPB) * (R * RB) + r * RB + (((c % CPB) ^ x) << 4);
}

// Start copying `rows` rows (row r at src + r * stride) of an R-row tile
// into its swizzled place; rows rows..R-1 are zero-filled, so a masked
// score never meets a stale value. A head of DR < D elements sits in the
// D-wide layout with its columns DR..D-1 zero-filled, so they add nothing
// to Q K^T and leave zeros in O's columns that are never stored.
template <int D, int R, int DR = D>
__device__ __forceinline__ void load_tile_async(unsigned dst, const bf16* src,
                                                long long stride, int rows,
                                                int tid) {
  constexpr int C = D / 8;    // 16-byte chunks per row of the layout
  constexpr int CR = DR / 8;  // ... of which the head's own
#pragma unroll
  for (int it = 0; it < (R * C + kMmaThreads - 1) / kMmaThreads; ++it) {
    const int i = tid + it * kMmaThreads;
    if (R * C % kMmaThreads && i >= R * C) break;
    const int r = i / C, c = i - r * C;
    const bool ok = r < rows && c < CR;
    cp_async16(dst + swizzled<D, R>(r, c),
               src + (ok ? r : 0) * stride + (ok ? c : 0) * 8, ok ? 16 : 0);
  }
}

// D is the layout's head width (32, 64 or 128), DR <= D the head's own:
// D = 128, DR = 80 runs a head of 80 in the 128-wide layout (see
// load_tile_async), wgmma's N = 80 rows of 160 bytes fitting no swizzle
// atom of the D = 64 / 128 layouts.
template <int D, int DR = D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_attention_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v, bf16* __restrict__ o,
                           Strides qs, Strides ks, Strides vs, Strides os,
                           int S, int group, float scale_log2, int causal,
                           int window) {
  using Cfg = MmaCfg<D>;
  constexpr int ST = Cfg::kStages, BQ = Cfg::kBq;
  constexpr int RB = Cfg::kRow, SW = Cfg::kSwizzle;
  constexpr int KPB = RB / 32;  // 16-wide k steps per column block
  constexpr int KC = D / 16;    // 16-wide k steps of Q K^T
  constexpr int NT = kBk / 8;   // 8-key n tiles of S
  constexpr int DT = D / 8;     // 8-wide n tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // tiles on a 1024-byte boundary (the swizzle's period): K and V stages,
  // then Q (and, at the end, each warp's output rows in Q's place)
  const unsigned raw = smem_addr(smem_raw);
  const unsigned base = (raw + 1023u) & ~1023u;
  const unsigned s_k = base;                        // [ST] tiles
  const unsigned s_v = base + ST * Cfg::kTile;      // [ST] tiles
  const unsigned s_q = base + 2 * ST * Cfg::kTile;  // [BQ][D]
  unsigned char* q_ptr = smem_raw + (s_q - raw);

  const int nq = (S + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tg = lane & 3;  // fragment row / column pair
  const int w0 = q0 + warp * 16;            // the warp's first query row
  const int wg = warp >> 2;                 // its warpgroup

  const bf16* qb = q + b * qs.b + h * qs.h + q0 * qs.s;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  int kt_begin, kt_end;
  key_tiles(q0, BQ, S, causal, window, &kt_begin, &kt_end);
  const int n_tiles = kt_end - kt_begin;  // >= 1: every row sees a key

  auto fetch_tile = [&](int t) {  // tile t of [0, n_tiles) into its stage
    const int k0 = (kt_begin + t) * kBk, rows = min(kBk, S - k0);
    const int st = t % ST;
    load_tile_async<D, kBk, DR>(s_k + st * Cfg::kTile, kb + k0 * ks.s, ks.s,
                                rows, tid);
    load_tile_async<D, kBk, DR>(s_v + st * Cfg::kTile, vb + k0 * vs.s, vs.s,
                                rows, tid);
  };
  load_tile_async<D, BQ, DR>(s_q, qb, qs.s, min(BQ, S - q0), tid);
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < n_tiles) fetch_tile(t);
    cp_async_commit();  // Q rides with tile 0's group
  }

  float acc[DT * 4];  // O, scaled to the running max
#pragma unroll
  for (int i = 0; i < DT * 4; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // rows gr, gr + 8; raw units
  float l_run[2] = {0.f, 0.f};              // this lane's part of the sum
  float sc[NT * 4];                         // S, then P, of one tile
  unsigned pa[kBk / 16][4];                 // P in bf16: P V's A fragments
  float alpha[2];

  // S = Q K^T of tile t: the warpgroup's 64 rows x 64 keys, both K-major;
  // the first k step overwrites sc
  auto scores = [&](int t) {
    const unsigned sk = s_k + (t % ST) * Cfg::kTile;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int off = (kc % KPB) * 32;
      wgmma_ss_n64(sc,
                   smem_desc(s_q + (kc / KPB) * (BQ * RB) + wg * 64 * RB + off,
                             16, 8 * RB, SW),
                   smem_desc(sk + (kc / KPB) * (kBk * RB) + off, 16, 8 * RB,
                             SW),
                   kc > 0);
    }
    wgmma_commit();
  };
  // O += P V of tile t: P's bf16 A fragments from registers, V MN-major
  // (transposed by the descriptor)
  auto pv = [&](int t) {
    const unsigned sv = s_v + (t % ST) * Cfg::kTile;
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk)
      wgmma_pv<D>(acc, pa[kk],
                  smem_desc(sv + kk * 16 * RB, kBk * RB, 8 * RB, SW));
    wgmma_commit();
  };
  // mask tile t's scores, update the running max and sum, leave P (float)
  // in sc and each row's rescale factor in alpha; the quad of lanes
  // tg = 0..3 holds each row
  auto softmax = [&](int t) {
    const int k0 = (kt_begin + t) * kBk;
    if ((causal && k0 + kBk - 1 > w0) ||
        (window > 0 && w0 + 15 - k0 >= window) || k0 + kBk > S) {
#pragma unroll
      for (int i = 0; i < NT * 4; ++i) {
        const int qpos = w0 + gr + ((i >> 1) & 1) * 8;
        const int kpos = k0 + (i >> 2) * 8 + 2 * tg + (i & 1);
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && qpos - kpos < window;
        if (!ok) sc[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // a row with no key yet keeps m = -inf; exp2(-inf) = 0
      const float neg = -(mx == -INFINITY ? 0.f : mx) * scale_log2;
      alpha[r] = exp2_approx(fmaf(m_run[r], scale_log2, neg));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          sc[4 * j + e] = exp2_approx(fmaf(sc[4 * j + e], scale_log2, neg));
          sum += sc[4 * j + e];
        }
      l_run[r] = l_run[r] * alpha[r] + sum;
      m_run[r] = mx;
    }
  };
  // rescale O to the new max and round P to bf16 (once O's last P V is done)
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * j + e] *= alpha[e >> 1];
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
  };

  // Software pipeline, per warpgroup: while the tensor cores run tile j's
  // P V and tile j+1's Q K^T, the softmax of tile j+1 waits only for the
  // latter, so its exponentials overlap the former. Stages: tile j-1's is
  // free and refilled with tile j+ST-1, tile j's V and tile j+1's K are read.
  // Every branch around a wgmma is uniform over the block (ptxas serializes
  // wgmma placed under a branch it cannot prove uniform), so a warpgroup
  // also runs the tiles of its block that are wholly masked for its rows.
  cp_async_wait<ST - 2>();  // tile 0 and Q have landed
  __syncthreads();
  hold<NT * 4>(sc);
  wgmma_fence();
  scores(0);
  wgmma_wait<0>();
  hold<NT * 4>(sc);
  softmax(0);
  rescale_and_pack();
  // The warpgroups take turns to start their products, so that one's
  // softmax runs while the next one's products occupy the tensor cores;
  // the last warpgroup lets the first go first.
  if (wg == kWarpgroups - 1) turn_pass(wg);
  // no branch of the loop holds a wgmma or its wait: ptxas serializes the
  // wgmma of a loop whose waits it cannot match to them
  for (int j = 0; j + 1 < n_tiles; ++j) {
    cp_async_wait<ST - 3>();  // tile j+1 has landed
    __syncthreads();          // ... for every thread; tile j-1 is consumed
    if (j + ST - 1 < n_tiles) fetch_tile(j + ST - 1);
    cp_async_commit();
    // every register the two batches touch is final before the fence
    hold<NT * 4>(sc);
    hold<DT * 4>(acc);
    hold<kBk / 4>(&pa[0][0]);
    turn_wait(wg);
    wgmma_fence();
    scores(j + 1);
    pv(j);
    turn_pass(wg);
    wgmma_wait<1>();  // tile j+1's scores; tile j's P V may still run
    hold<NT * 4>(sc);
    softmax(j + 1);
    wgmma_wait<0>();
    hold<DT * 4>(acc);
    hold<kBk / 4>(&pa[0][0]);  // its registers stay P's until P V is done
    rescale_and_pack();
  }
  hold<DT * 4>(acc);
  hold<kBk / 4>(&pa[0][0]);
  turn_wait(wg);
  wgmma_fence();
  pv(n_tiles - 1);
  if (wg != kWarpgroups - 1) turn_pass(wg);  // no turn follows the last
  wgmma_wait<0>();
  hold<DT * 4>(acc);

  // epilogue: divide by the row sums, stage the warp's 16 rows in its own
  // (swizzled) rows of the Q tile, which its warpgroup's products no longer
  // read, and store 16 bytes a lane
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;  // > 0: a row's own key
    const int row = warp * 16 + gr + 8 * r;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<unsigned*>(q_ptr + swizzled<D, BQ>(row, j) + 4 * tg) =
          pack_bf16(acc[4 * j + 2 * r] * inv, acc[4 * j + 2 * r + 1] * inv);
  }
  __syncwarp();
  constexpr int C = DR / 8;  // the head's own 16-byte chunks per row
  bf16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int it = 0; it < (16 * C + 31) / 32; ++it) {
    const int i = lane + it * 32;
    const int r = i / C, c = i - r * C;
    if (i < 16 * C && w0 + r < S)
      *reinterpret_cast<uint4*>(ob + (w0 + r) * os.s + c * 8) =
          *reinterpret_cast<const uint4*>(
              q_ptr + swizzled<D, BQ>(warp * 16 + r, c));
  }
}

// --------------------------------------------------------------- float32
constexpr int kF32Threads = 256;
constexpr int kBq = 64;  // query rows per block of the float32 kernel

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (kBq * (D + 1) + 2 * kBk * (D + 1) + kBq * (kBk + 1) + 3 * kBq);
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ o, Strides qs, Strides ks,
                               Strides vs, Strides os, int S, int group,
                               float scale_log2, int causal, int window) {
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

  const float* qb = q + b * qs.b + h * qs.h + q0 * qs.s;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  attn::load_rows<float, D>(s_q, LD, qb, qs.s, min(kBq, S - q0), kBq,
                            scale_log2, tid, kF32Threads);
  if (tid < kBq) {
    s_m[tid] = -INFINITY;
    s_l[tid] = 0.f;
  }
  float acc[4][TC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.f;

  int kt_begin, kt_end;
  key_tiles(q0, kBq, S, causal, window, &kt_begin, &kt_end);

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBk;
    const int rows = min(kBk, S - k0);
    __syncthreads();  // the previous tile's readers are done
    attn::load_rows<float, D>(s_k, LD, kb + k0 * ks.s, ks.s, rows, kBk, 1.f,
                              tid, kF32Threads);
    attn::load_rows<float, D>(s_v, LD, vb + k0 * vs.s, vs.s, rows, kBk, 1.f,
                              tid, kF32Threads);
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

  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
    if (qpos >= S) continue;
    const float inv = 1.f / s_l[r];  // >= 1: the row's own key is kept
#pragma unroll
    for (int j = 0; j < TC; ++j) ob[qpos * os.s + tx + 16 * j] = acc[i][j] * inv;
  }
}

// ---------------------------------------------------------------- launch
// the wgmma layout's head width for a head of d: 80 runs zero-padded to 128
constexpr int mma_layout(int d) { return d == 80 ? 128 : d; }

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, Strides qs,
           Strides ks, Strides vs, Strides os, long long B, long long S,
           long long H, long long KVH, int causal, int window,
           cudaStream_t stream) {
  static unsigned long long configured = 0;
  const float scale_log2 = attn::kLog2e / sqrtf((float)D);
  const int group = (int)(H / KVH);
  if constexpr (sizeof(T) == 2) {
    constexpr int DL = mma_layout(D);
    auto kernel = flash_attention_kernel<DL, D>;
    const size_t smem = MmaCfg<DL>::kSmem;
    constexpr int bq = MmaCfg<DL>::kBq;
    cudaError_t err = attn::allow_smem(kernel, smem, &configured);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((S + bq - 1) / bq), (unsigned)H, (unsigned)B);
    kernel<<<grid, kMmaThreads, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), qs, ks, vs, os,
        (int)S, group, scale_log2, causal, window);
  } else {
    auto kernel = flash_attention_f32_kernel<D>;
    const size_t smem = f32_smem_bytes<D>();
    cudaError_t err = attn::allow_smem(kernel, smem, &configured);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((S + kBq - 1) / kBq), (unsigned)H, (unsigned)B);
    kernel<<<grid, kF32Threads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os,
        (int)S, group, scale_log2, causal, window);
  }
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
    case 80:
      return launch<T, 80>(q, k, v, o, qs, ks, vs, os, B, S, H, KVH, causal,
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
    return dispatch_d<bf16>(D, q, k, v, o, qs, ks, vs, os, B, S, H, KVH,
                            (int)causal, (int)window, st);
  return (int)cudaErrorInvalidValue;
}
