// Eq-12 bipartite GCN aggregation for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel repro/kernels/gcn_agg.py::gcn_agg (Pallas body
// `_kernel`). Per graph b:
//   deg = sum_o adj[m, o];  agg = (adj @ hn) / (deg + 1e-6)
//   out = relu(hs @ Ws + agg @ Wn + bias)
//
// What bounds it on the H100: at the actor's shapes (M = 14 devices, O = 10
// options, widths 7/4 -> 128, then 128/128 -> 64) a launch moves well under
// 10 MB and does at most ~0.5 GFLOP (layer 2 at B = 1024 fleets). Up to a
// few hundred graphs it is bound by latency: the launch, the operands'
// trip from L2, and the chain agg -> K-long product inside a block. At
// B = 1024, layer 2 is bound by float32 FMA issue; TF32 is out, it would
// break the 1e-5 gates.
//
// Design: the output, viewed as [B*M, H], is cut into tiles of `rows` rows
// (G whole graphs, or 64 rows of a larger graph) by `cols` columns, chosen
// by kernels/gcn_agg.py::plan: whole rows of H, so that a weight K-tile is
// one contiguous bulk copy and a graph's agg is formed once; one graph a
// block up to one per SM, and beyond that several, so that each weight
// tile fetched from L2 serves them all. A block
//   1. stages its graphs' hn and (device side) adjacency rows in shared
//      memory with one bulk copy each of the Tensor Memory Accelerator on a
//      transaction barrier, and its rows of hs, the option side's
//      transposed adjacency (read through its strides) and what is not
//      16-byte aligned (layer 1's 28-byte rows) with cp.async;
//   2. streams [Ws; Wn] in K-tiles of 32 rows into S stages, one barrier
//      each: a tile of whole rows (cols = H) is one or two bulk copies, a
//      column slice cp.async; at large B in flight with step 1, at small B
//      every tile resident (S = tiles), issued by a producer warp that
//      skips step 3, and one wait serves them all;
//   3. forms agg = (adj @ hn) / (deg + 1e-6) into A = [hs | agg]
//      ([rows][K], K = Fs + Fn) with a true divide, up to eight columns a
//      thread;
//   4. multiplies A by the weight with a 4 x 4 float32 micro-tile per
//      thread in registers, 4 rows of A and 4 columns of the weight read as
//      float4s. When a tile has few micro-tiles, K is split over KS slices
//      of threads (k_split), which shortens each thread's chain;
//   5. sums the slices' partial tiles in shared memory in order, adds the
//      bias, applies relu and stores whole rows of the tile, coalesced.
// K = 11 and 256 (the actor's two layers) are compile-time, so the loops
// run fixed counts; one runtime-K instance takes every other width.
#include "actor_common.cuh"

namespace {

using actor::up4;

constexpr int kTM = 4;              // output rows per thread
constexpr int kTN = 4;              // output columns per thread
constexpr int kKT = 32;             // weight rows per K-tile
constexpr int kPad = 4;             // floats added to a shared-memory row
constexpr int kMaxThreads = 512;
constexpr int kMaxStages = 8;       // weight K-tiles in flight

// weight rows per K-tile of the instance for width KC (0: any width)
__host__ __device__ constexpr int tile_rows(int kc) {
  return kc > 0 && kc < kKT ? (int)up4(kc) : kKT;
}

// graphs a block's rows can touch: G when rows = G * M, else the rows are
// a piece of one graph larger than a tile and may straddle two
template <typename I>
__host__ __device__ inline I span_of(I rows, I M) {
  return rows % M == 0 ? rows / M : rows / M + 2;
}

// A block's shared memory, in floats; each region starts on 16 bytes.
// Integer type I: long long on the host, int in the kernel.
template <typename I>
struct Layout {
  I rpad, kld, cld, rld, a, w, hn, adj, floats;
  __host__ __device__ Layout(I rows, I cols, I M, I O, I K, I Fn, I ks, I kt,
                             I stages) {
    rpad = (I)up4(rows);
    kld = (I)actor::odd_ld(K);       // rows of A 4 apart: no bank conflict
    cld = cols;                      // weight rows, dense: one bulk copy a tile
    rld = cols + kPad;               // partial tiles' rows
    a = (I)up4(2 * (1 + stages));    // barriers: operands, then a stage each
    w = a + rpad * kld;                            // A: [rpad][kld]
    hn = w + stages * kt * cld;                    // weight: S x [kt][cld]
    adj = hn + (I)up4(span_of(rows, M) * O * Fn);  // hn: [span][O][Fn]
    const I end = adj + (I)up4(rpad * O);          // adjacency: [rpad][O]
    const I red = a + ks * rpad * rld;             // partials: [ks][rpad][rld]
    floats = end > red ? end : red;
  }
};

// acc += A[4 rows][N] @ W[N][4 columns], N a multiple of 4 (0: n at run
// time); a and w point at this thread's rows and columns. Two 4-row
// groups an iteration, not the whole run: a block runs this code once, and
// straight-line code that long waits on the instruction cache line by line
template <int N>
__device__ __forceinline__ void fma_rows(float (&acc)[kTM][kTN],
                                         const float* a, int kld,
                                         const float* w, int cld, int n) {
#pragma unroll 2
  for (int kk = 0; kk < (N > 0 ? N : n); kk += 4) {
    float4 av[kTM], wv[4];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * kld + kk);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wv[j] = *reinterpret_cast<const float4*>(w + (kk + j) * cld);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float x = actor::lane(av[i], j);
        acc[i][0] = fmaf(x, wv[j].x, acc[i][0]);
        acc[i][1] = fmaf(x, wv[j].y, acc[i][1]);
        acc[i][2] = fmaf(x, wv[j].z, acc[i][2]);
        acc[i][3] = fmaf(x, wv[j].w, acc[i][3]);
      }
    }
  }
}

// agg = (adj @ hn) / (deg + 1e-6) for rows 0..nrows-1 of the tile (row r
// is row m0 + r of the tile's graphs) into dst + r * ld, a thread taking R
// rows of one graph (which share the hn they read) by V consecutive
// columns; a true divide per element
template <int V, int R>
__device__ __forceinline__ void agg_rows(float* dst, int ld, const float* sAdj,
                                         const float* sHn, int M, int O,
                                         int Fn, int m0, int nrows, int tid,
                                         int nt) {
  actor::Walk w(tid, nt, Fn / V);
  int g = (m0 + R * w.r) / M, m = m0 + R * w.r - g * M;
  while (R * w.r < nrows) {
    const int r = R * w.r, f = w.c * V;
    const float* a = sAdj + r * O;
    const float* x = sHn + g * O * Fn + f;
    float num[R][V], deg[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      deg[i] = 0.f;
#pragma unroll
      for (int v = 0; v < V; ++v) num[i][v] = 0.f;
    }
#pragma unroll 5
    for (int o = 0; o < O; ++o) {
      float h[V];
      if (V >= 4) {
#pragma unroll
        for (int v = 0; v < V; v += 4) {
          const float4 q = *reinterpret_cast<const float4*>(x + o * Fn + v);
          h[v] = q.x;
          h[v + 1] = q.y;
          h[v + 2] = q.z;
          h[v + 3] = q.w;
        }
      } else {
        h[0] = x[o * Fn];
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float ao = a[i * O + o];
#pragma unroll
        for (int v = 0; v < V; ++v) num[i][v] = fmaf(ao, h[v], num[i][v]);
        deg[i] += ao;
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float d = deg[i] + 1e-6f;
#pragma unroll
      for (int v = 0; v < V; ++v)
        dst[(r + i) * ld + f + v] = actor::quot(num[i][v], d);
    }
    const int rg = w.r;
    w.next();
    for (m += R * (w.r - rg); m >= M; m -= M) ++g;
  }
}

// K = 11 (layer 1) takes few registers: ask for two blocks of the most
// threads per SM, so that tiles of four graphs by 128 columns pair up
template <int KC, int KS>
__global__ void __launch_bounds__(kMaxThreads, KC == 11 ? 2 : 1)
    gcn_agg_kernel(const float* __restrict__ adj, const float* __restrict__ hs,
                   const float* __restrict__ hn, const float* __restrict__ ws,
                   const float* __restrict__ wn,
                   const float* __restrict__ bias, float* __restrict__ out,
                   long long adj_sb, long long adj_sm, long long adj_so,
                   long long B, int M, int O, int Fs, int Fn, int H, int rows,
                   int cols, int stages) {
  constexpr int KT = tile_rows(KC);
  constexpr int SK = KT / KS;  // weight rows of a K-tile per slice
  static_assert(KT % KS == 0 && SK % 4 == 0, "slices take 4-row groups");
  const int K = KC > 0 ? KC : Fs + Fn;
  const int K4 = (int)up4(K);
  const Layout<int> L(rows, cols, M, O, K, Fn, KS, KT, stages);
  const int rpad = L.rpad, kld = L.kld, cld = L.cld, rld = L.rld;
  extern __shared__ __align__(16) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* sA = smem + L.a;
  float* sW = smem + L.w;
  float* sHn = smem + L.hn;
  float* sAdj = smem + L.adj;

  const int tid = threadIdx.x, nt = blockDim.x;
  const int ntx = cols >> 2, per_slice = ntx * (rpad >> 2);
  const int sl = tid / per_slice;
  const int ty = (tid - sl * per_slice) / ntx;
  const int tx = tid - sl * per_slice - ty * ntx;

  // the tile: rows row0.. of [B*M, H] from row m0 of graph b0 on (m0 = 0
  // when it holds whole graphs), columns c0..
  const long long row0 = (long long)blockIdx.x * rows;
  const int nrows = (int)min((long long)rows, B * M - row0);
  long long b0;
  int m0;
  if (rows % M == 0) {
    b0 = (long long)blockIdx.x * (rows / M);
    m0 = 0;
  } else {
    b0 = row0 / M;
    m0 = (int)(row0 - b0 * M);
  }
  const int nb = (m0 + nrows - 1) / M + 1;   // graphs the tile touches
  const int c0 = blockIdx.y * cols;
  const int ncols = min(cols, H - c0);
  // the columns this thread stores in step 5, and their bias
  const int c = (tid % ntx) * kTN;
  float bv[kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j)
    bv[j] = c + j < ncols ? __ldg(bias + c0 + c + j) : 0.f;

  if (tid == 0) {  // operands: hn and the adjacency; a stage: its tile
    actor::bar_init(bars, 2);
    for (int i = 1; i <= stages; ++i) actor::bar_init(bars + i, 1);
    actor::bar_fence_init();
  }
  __syncthreads();

  // 1. operands on barrier 0 (bulk, issued from warps 1 and 2) and one
  // cp.async group: hs rows into A's columns 0..Fs-1, the graphs' hn
  // (flat), the adjacency rows
  const float* hs0 = hs + row0 * Fs;
  actor::copy_rows(sA, kld, [=](int r) { return hs0 + (long long)r * Fs; },
                   actor::rows_vec(hs0, Fs, Fs), nrows, Fs, tid, nt);
  actor::stage(sHn, Fn, hn + b0 * O * Fn, Fn, nb * O, Fn, bars,
               actor::issuer(1, nt), tid, nt);
  const float* adj0 = adj + b0 * adj_sb + m0 * adj_sm;
  if (adj_so == 1 && adj_sm == O && adj_sb == (long long)M * O) {
    actor::stage(sAdj, O, adj0, O, nrows, O, bars, actor::issuer(2, nt), tid,
                 nt);
  } else {  // a strided view: 4-byte copies through the strides
    if (tid == actor::issuer(2, nt)) actor::bar_arm(bars, 0);
    actor::Walk w(tid, nt, O);
    int g = (m0 + w.r) / M, m = m0 + w.r - g * M;
    while (w.r < nrows) {
      actor::cp_async4(sAdj + w.r * O + w.c,
                       adj + (b0 + g) * adj_sb + m * adj_sm + w.c * adj_so);
      const int r = w.r;
      w.next();
      for (m += w.r - r; m >= M; m -= M) ++g;
    }
  }
  actor::cp_async_commit();

  actor::zero_cols(sA, kld, nrows, K, K4, tid, nt);

  // 2. the block's i-th weight K-tile, t = (i + rot) % tiles, into stage
  // i % S on barrier 1 + i % S (resident: stage t): whole rows (cols = H)
  // are contiguous, one bulk copy from Ws and one from Wn; a column slice
  // is cp.async rows from every thread. A bulk copy holds its thread until
  // the copy unit takes it. Streaming (large B), the tiles go out before
  // step 1's wait, from threads of different warps, to be in flight with
  // the operands; resident (small B), after it, from lane i of the last
  // warp (the producer), which takes no part in agg, so that its wait
  // overlaps agg. Blocks start at different tiles, so that they do not all
  // read the same lines of L2 at once. Rows K..K4-1 of the last tile are
  // zeroed, as A's columns K..K4-1 are, so that no stale value (NaN, Inf)
  // of an earlier launch enters a sum
  const int ntiles = (K + KT - 1) / KT;
  const bool resident = stages >= ntiles;
  const int rot = ntiles > 0 ? blockIdx.x % ntiles : 0;
  const bool wvec = actor::rows_vec(ws + c0, H, ncols);
  const bool wbulk = ncols == H && wvec && actor::aligned16(wn);
  const int producer = resident && wbulk && nt >= 64 ? nt - 32 : -1;
  auto load = [=](int i) {
    if (i >= ntiles) return;
    const int t = (i + rot) % ntiles, slot = resident ? t : i % stages;
    const int k0 = t * KT, nk = min(KT, K - k0);
    float* dst = sW + slot * KT * cld;
    if (wbulk) {
      const int who =
          producer >= 0 ? producer + i % 32 : actor::issuer(3 + i, nt);
      if (tid == who) {  // rows k0.. of Ws, then of Wn
        const int na = max(0, min(nk, Fs - k0));
        uint64_t* bar = bars + 1 + slot;
        actor::bar_arm(bar, (unsigned)(nk * H * 4));
        if (na > 0)
          actor::bulk_copy(dst, ws + (long long)k0 * H, (unsigned)(na * H * 4), bar);
        if (nk > na)
          actor::bulk_copy(dst + na * H, wn + (long long)(k0 + na - Fs) * H,
                           (unsigned)((nk - na) * H * 4), bar);
      }
    } else {
      actor::copy_rows(dst, cld, [=](int r) {
        const int k = k0 + r;
        return (k < Fs ? ws + (long long)k * H : wn + (long long)(k - Fs) * H) + c0;
      }, wvec, nk, ncols, tid, nt);
      actor::cp_async_commit();
    }
    for (int i = tid; i < (min(KT, K4 - k0) - nk) * cld; i += nt)
      dst[nk * cld + i] = 0.f;
  };
  if (!resident)
    for (int i = 0; i < stages; ++i) load(i);
  actor::cp_async_wait_all();  // this thread's cp.async copies have landed
  actor::bar_wait(bars, 0);    // ... and step 1's bulk copies
  __syncthreads();
  if (resident)
    for (int i = 0; i < stages; ++i) load(i);

  // 3. agg into A's columns Fs..K-1, by every thread but the producer's:
  // a thread takes eight (or four) columns where the rows of hn allow, and
  // two rows of one graph where the graphs' rows pair up and there are
  // items enough for every thread twice over (not for K = 11: layer 1's
  // narrow rows keep to the paths that fit its 64 registers); an all-zero
  // adjacency row gives 0
  const int na = producer >= 0 ? producer : nt;
  constexpr bool wide = KC != 11;
  if (tid >= na) {
  } else if (wide && Fn % 8 == 0 && M % 2 == 0 && m0 == 0 &&
             nrows * (Fn / 8) >= 2 * na) {
    agg_rows<8, 2>(sA + Fs, kld, sAdj, sHn, M, O, Fn, m0, nrows, tid, na);
  } else if (wide && Fn % 8 == 0) {
    agg_rows<8, 1>(sA + Fs, kld, sAdj, sHn, M, O, Fn, m0, nrows, tid, na);
  } else if (Fn % 4 == 0) {
    agg_rows<4, 1>(sA + Fs, kld, sAdj, sHn, M, O, Fn, m0, nrows, tid, na);
  } else {
    agg_rows<1, 1>(sA + Fs, kld, sAdj, sHn, M, O, Fn, m0, nrows, tid, na);
  }

  // 4. [hs | agg] @ [Ws; Wn]. Resident: one wait for every tile, then this
  // slice's contiguous rows of K. Streaming: this slice's rows of each
  // tile in the block's order, which waits for its stage and frees it for
  // the tile S later.
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  const float* a_rows = sA + ty * kTM * kld;
  const float* w_cols = sW + tx * kTN;
  if (resident) {
    if (wbulk)
      for (int t = 0; t < ntiles; ++t) actor::bar_wait(bars + 1 + t, 0);
    actor::cp_async_wait_all();
    __syncthreads();  // every tile and agg, for every thread
    constexpr int RS = KC > 0 ? (int)up4(KC) / KS : 0;  // rows of K a slice
    static_assert(RS % 4 == 0, "slices take 4-row groups");
    const int rs = KC > 0 ? RS : (int)up4((K4 + KS - 1) / KS);
    const int k0 = sl * rs;
    fma_rows<RS>(acc, a_rows + k0, kld, w_cols + k0 * cld, cld,
                 max(0, min(rs, K4 - k0)));
  } else {
    for (int i = 0; i < ntiles; ++i) {
      const int t = (i + rot) % ntiles, slot = i % stages;
      if (wbulk)
        actor::bar_wait(bars + 1 + slot, (i / stages) & 1);
      else
        actor::cp_async_wait_all();
      __syncthreads();  // tile t (and its zeroed rows), and agg
      const int k0 = t * KT + sl * SK;
      fma_rows<(KC > 0 && KC % KT == 0 ? SK : 0)>(
          acc, a_rows + k0, kld, w_cols + (slot * KT + sl * SK) * cld, cld,
          max(0, min(SK, K4 - k0)));
      __syncthreads();  // stage t % S is free
      load(i + stages);
    }
  }
  __syncthreads();  // every thread is done with A and the weight

  // 5. partial tiles over A, summed slice by slice in order; bias, relu,
  // whole rows stored
  float* red = sA;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
    *reinterpret_cast<float4*>(red + (sl * rpad + ty * kTM + i) * rld +
                               tx * kTN) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  if (c >= ncols) return;
  const bool vec = H % 4 == 0 && actor::aligned16(out);
  for (int r = tid / ntx; r < nrows; r += nt / ntx) {
    float4 v = *reinterpret_cast<const float4*>(red + r * rld + c);
    for (int s = 1; s < KS; ++s) {
      const float4 p =
          *reinterpret_cast<const float4*>(red + (s * rpad + r) * rld + c);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    const float y[kTN] = {fmaxf(v.x + bv[0], 0.f), fmaxf(v.y + bv[1], 0.f),
                          fmaxf(v.z + bv[2], 0.f), fmaxf(v.w + bv[3], 0.f)};
    float* dst = out + (row0 + r) * H + c0 + c;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (c + j < ncols) dst[j] = y[j];
    }
  }
}

// One compiled instance: the kernel for width KC (0: any) split KS ways,
// with its shared-memory opt-in.
template <int KC, int KS>
struct Instance {
  static constexpr int kt = tile_rows(KC);
  static auto fn() { return gcn_agg_kernel<KC, KS>; }
  static cudaError_t prepare() {
    static unsigned long long done = 0;
    return actor::allow_smem(fn(), &done);
  }
};

template <int KC, typename F>
int by_split(long long ks, F&& f) {
  switch (ks) {
    case 1: return f(Instance<KC, 1>{});
    case 2: return f(Instance<KC, 2>{});
    case 4: return f(Instance<KC, 4>{});
    case 8: return f(Instance<KC, 8>{});
  }
  return (int)cudaErrorInvalidValue;
}

// f(Instance) for width K split ks ways; the actor's widths 11 and 256
// have their own instances
template <typename F>
int with_instance(long long K, long long ks, F&& f) {
  if (K == 11 && ks == 1) return f(Instance<11, 1>{});
  if (K == 256) return by_split<256>(ks, f);
  return by_split<0>(ks, f);
}

struct Shape {
  long long M, O, Fs, Fn, H, rows, cols, ks, stages;
  long long threads() const { return ks * (up4(rows) / kTM) * (cols / kTN); }
  bool valid() const {
    return M > 0 && O >= 0 && Fs >= 0 && Fn >= 0 && H > 0 && rows > 0 &&
           cols > 0 && cols % kTN == 0 && threads() <= kMaxThreads &&
           stages >= 1 && stages <= kMaxStages;
  }
  template <typename I>
  size_t smem() const {
    return sizeof(float) * Layout<long long>(rows, cols, M, O, Fs + Fn, Fn, ks,
                                             I::kt, stages).floats;
  }
};

}  // namespace

// adj is read through (batch, row, col) strides in elements; every other
// operand is contiguous. rows x cols is the output tile of one block, ks
// the K split, stages the weight K-tiles in flight (kernels/gcn_agg.py::
// plan). Returns cudaGetLastError() after the launch.
extern "C" int gcn_agg_f32(const float* adj, const float* hs, const float* hn,
                           const float* ws, const float* wn, const float* bias,
                           float* out, long long adj_sb, long long adj_sm,
                           long long adj_so, long long B, long long M,
                           long long O, long long Fs, long long Fn,
                           long long H, long long rows, long long cols,
                           long long ks, long long stages, void* stream) {
  const Shape s{M, O, Fs, Fn, H, rows, cols, ks, stages};
  if (!s.valid()) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const dim3 grid((unsigned)((B * M + rows - 1) / rows),
                  (unsigned)((H + cols - 1) / cols));
  return with_instance(Fs + Fn, ks, [&](auto inst) {
    using I = decltype(inst);
    const cudaError_t err = I::prepare();
    if (err != cudaSuccess) return (int)err;
    I::fn()<<<grid, (unsigned)s.threads(), s.smem<I>(),
              static_cast<cudaStream_t>(stream)>>>(
        adj, hs, hn, ws, wn, bias, out, adj_sb, adj_sm, adj_so, B, (int)M,
        (int)O, (int)Fs, (int)Fn, (int)H, (int)rows, (int)cols, (int)stages);
    return (int)cudaGetLastError();
  });
}

// The dynamic shared memory of one block of that launch, in bytes;
// negative (minus a CUDA error) for a tile the kernel does not take.
extern "C" long long gcn_agg_smem_bytes(long long M, long long O, long long Fs,
                                        long long Fn, long long H,
                                        long long rows, long long cols,
                                        long long ks, long long stages) {
  const Shape s{M, O, Fs, Fn, H, rows, cols, ks, stages};
  if (!s.valid()) return -(long long)cudaErrorInvalidValue;
  long long bytes = 0;
  const int err = with_instance(Fs + Fn, ks, [&](auto inst) {
    bytes = (long long)s.smem<decltype(inst)>();
    return 0;
  });
  return err ? -(long long)err : bytes;
}

// How many blocks of that launch one SM of the current device runs at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor after the launch's
// own settings); negative (minus a CUDA error) if it cannot be configured.
extern "C" long long gcn_agg_blocks_per_sm(long long M, long long O,
                                           long long Fs, long long Fn,
                                           long long H, long long rows,
                                           long long cols, long long ks,
                                           long long stages) {
  const Shape s{M, O, Fs, Fn, H, rows, cols, ks, stages};
  if (!s.valid()) return -(long long)cudaErrorInvalidValue;
  int blocks = 0;
  const int err = with_instance(Fs + Fn, ks, [&](auto inst) {
    using I = decltype(inst);
    cudaError_t e = I::prepare();
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, I::fn(), (int)s.threads(), s.smem<I>());
    return (int)e;
  });
  return err ? -(long long)err : (long long)blocks;
}
