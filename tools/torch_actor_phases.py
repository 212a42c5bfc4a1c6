"""Where a launch of each actor kernel spends its time, phase by phase, on
one NVIDIA GPU.

    python3 tools/torch_actor_phases.py [--fleets 1,64,1024]

Builds copies of ``csrc/gcn_agg.cu`` and ``csrc/edge_score.cu`` (into
``build/actor_phases/``) in which thread 0 of every block records its SM
clock (``clock64``) at the end of each phase, and the global timer at the
block's start and end; the copies compute what the kernels compute. It
runs the five launches of one actor forward once on the main path's inputs
at each fleet count B, with the wrappers' own tiling
(``kernels/gcn_agg.py::plan``, ``kernels/edge_score.py::graphs``), and
prints one JSON line per launch: the median over blocks of the cycles from
the block's start to the end of each phase, a block's median duration and
the kernel's span in µs (global timer), and the max abs error against the
plain version. Phases of gcn_agg: ``setup`` (indices, bias, barriers),
``operands_issued`` (hs, hn, adjacency), ``operands_landed``,
``weights_issued`` (thread 0's part; at small B a producer warp issues
them),
``agg``, ``weights_landed`` (resident tiles, small B only), ``product``,
``stored``; of edge_score: ``staging_issued``, ``staged``,
``projections``, ``stored``. The clock stamps add a few instructions per
phase; compare durations with ``tools/torch_actor_kernels.py``. A phase
anchor that no longer matches the kernel's source is an error. Needs a
GPU; refuses to run without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "src", "repro_torch", "csrc")
OUT = os.path.join(HERE, "build", "actor_phases")
STAMPS = 16     # clock slots per block; the last two hold the global timer

# the recorder, placed before the kernel's anonymous namespace
RECORDER = r'''
__device__ long long g_stamps[16 * 65536];
#define STAMP(n, last) do { if (threadIdx.x == 0) { \
  const long long b_ = blockIdx.y * gridDim.x + blockIdx.x; \
  g_stamps[b_ * 16 + (n)] = clock64(); \
  if ((n) == 0 || (last)) { long long t_; \
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \
    g_stamps[b_ * 16 + 14 + ((last) ? 1 : 0)] = t_; } } } while (0)
extern "C" int stamps_read(long long* dst, long long n) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, n * sizeof(long long));
}
extern "C" int stamps_clear(long long n) {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, g_stamps);
  return (int)(e != cudaSuccess ? e : cudaMemset(p, 0, n * sizeof(long long)));
}
'''
# (phase, source anchor, stamp inserted before or after it)
GCN_PHASES = [
    ("start", "int cols, int stages) {", "after"),
    ("setup", "  // 1. operands on barrier 0", "before"),
    ("operands_issued", "  actor::zero_cols(sA, kld, nrows, K, K4, tid, nt);",
     "before"),
    ("operands_landed", "step 1's bulk copies\n  __syncthreads();\n", "after"),
    ("weights_issued", "  if (resident)\n    for (int i = 0; i < stages; ++i) "
                       "load(i);\n", "after"),
    ("agg", "  // 4. [hs | agg] @ [Ws; Wn].", "before"),
    ("weights_landed", "      for (int t = 0; t < ntiles; ++t) "
                       "actor::bar_wait(bars + 1 + t, 0);\n", "after"),
    ("product", "  __syncthreads();  // every thread is done with A and the "
                "weight", "before"),
    ("stored", "        if (c + j < ncols) dst[j] = y[j];\n    }\n  }\n",
     "after"),
]
EDGE_PHASES = [
    ("start", "long long B, int M, int O, int H_, int E_, int G) {", "after"),
    ("staging_issued", "  actor::cp_async_commit();\n", "after"),
    ("staged", "  actor::bar_wait(bar, 0);\n  __syncthreads();\n", "after"),
    ("projections", "  // 3. one (m, o) pair per thread", "before"),
    ("stored", "    out[b0 * mo + p] = (acc[0] + acc[1]) + (acc[2] + acc[3])"
               " + b_out;\n  }\n", "after"),
]


def instrumented(name: str, phases) -> ctypes.CDLL:
    """Build the copy of ``csrc/<name>.cu`` with a stamp per phase."""
    from repro_torch.kernels import _build
    src = open(os.path.join(CSRC, name + ".cu")).read()
    src = src.replace("namespace {", RECORDER + "\nnamespace {", 1)
    for i, (phase, anchor, where) in enumerate(phases):
        if src.count(anchor) != 1:
            raise SystemExit(f"{name}.cu: phase anchor of {phase!r} not found "
                             f"once: {anchor!r}")
        stamp = f"  STAMP({i}, {int(i == len(phases) - 1)});\n"
        at = src.index(anchor) + (len(anchor) if where == "after" else 0)
        src = src[:at] + ("\n" + stamp if where == "after" and
                          anchor.endswith("{") else stamp) + src[at:]
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, name + ".cu")
    with open(path, "w") as f:
        f.write(src)
    lib = path[:-3] + ".so"
    run = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", CSRC,
                          "-o", lib, path], capture_output=True, text=True)
    if run.returncode:
        raise SystemExit(f"nvcc failed on {path}:\n{run.stdout}{run.stderr}")
    dll = ctypes.CDLL(lib)
    dll.stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    dll.stamps_clear.argtypes = [ctypes.c_longlong]
    return dll


def phases_of(dll, names, blocks: int) -> dict:
    import numpy as np
    buf = np.zeros(STAMPS * blocks, dtype=np.int64)
    if dll.stamps_read(buf.ctypes.data, buf.size) != 0:
        raise SystemExit("reading the stamps failed")
    s = buf.reshape(blocks, STAMPS)
    return {   # a phase its path does not pass leaves its stamps at 0
        "median_cycles_from_start": {
            n: float(np.median(s[:, i] - s[:, 0]))
            for i, n in enumerate(names) if i > 0 and s[:, i].all()},
        "block_median_us": float(np.median(s[:, 15] - s[:, 14])) / 1e3,
        "kernel_span_us": float(s[:, 15].max() - s[:, 14].min()) / 1e3,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fleets", default="1,64,1024")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(HERE, "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_actor_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(1, HERE)
    import chip_smoke as cs
    from repro_torch.core import agent_def
    from repro_torch.kernels import _build
    from repro_torch.kernels import edge_score as edge_mod
    from repro_torch.kernels import gcn_agg as gcn_mod
    from repro_torch.mec import MECEnv, make_scenario

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.card_line())
    gcn = instrumented("gcn_agg", GCN_PHASES)
    gcn.gcn_agg_f32.argtypes = ([ctypes.c_void_p] * 7
                                + [ctypes.c_longlong] * 13 + [ctypes.c_void_p])
    edge = instrumented("edge_score", EDGE_PHASES)
    edge.edge_score_f32.argtypes = ([ctypes.c_void_p] * 10
                                    + [ctypes.c_longlong] * 6
                                    + [ctypes.c_void_p])
    env = MECEnv(make_scenario("fig5_baseline"), device=dev)
    adef = agent_def("grle", env, device=dev)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    params = adef.init(gen).params
    sms = _build.sm_count(dev)
    for b in (int(x) for x in args.fleets.split(",")):
        for kernel, name, a, _, plain, _ in cs.actor_cases(env, params, gen, b):
            stream = torch.cuda.current_stream().cuda_stream
            for dll in (gcn, edge):
                if dll.stamps_clear(STAMPS * 65536) != 0:
                    raise SystemExit("clearing the stamps failed")
            if kernel == "gcn_agg":
                adj, hs, hn, ws, wn, bias = a
                bb, m, o = adj.shape
                fs, fn, h = hs.shape[-1], hn.shape[-1], ws.shape[-1]
                t, ks, st = gcn_mod.plan(bb, m, o, fs, fn, h, sms)
                out = torch.empty((bb, m, h), device=dev)
                blocks = t.grid[0] * t.grid[1]
                err = gcn.gcn_agg_f32(
                    *(x.data_ptr() for x in a), out.data_ptr(), *adj.stride(),
                    bb, m, o, fs, fn, h, t.rows, t.cols, ks, st, stream)
                dll, names = gcn, [p[0] for p in GCN_PHASES]
                tile = {"graphs": t.graphs, "cols": t.cols, "k_split": ks,
                        "stages": st, "blocks": blocks}
            else:
                bb, m, o = a[2].shape
                h, e = a[3].shape
                g = edge_mod.graphs(bb, m, o, h, e, sms)
                out = torch.empty((bb, m, o), device=dev)
                blocks = -(-bb // g)
                err = edge.edge_score_f32(*(x.data_ptr() for x in a),
                                          out.data_ptr(), bb, m, o, h, e, g,
                                          stream)
                dll, names = edge, [p[0] for p in EDGE_PHASES]
                tile = {"graphs": g, "blocks": blocks}
            if err:
                raise SystemExit(f"{kernel} {name} B={b}: launch failed: "
                                 f"CUDA error {err}")
            torch.cuda.synchronize()
            print(json.dumps({"fleets": b, "launch": f"{kernel}/{name}",
                              **tile, **phases_of(dll, names, blocks),
                              "max_abs_err": float(
                                  (out - plain(*a)).abs().max())}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
