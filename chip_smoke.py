"""Drive repro_torch's GRLE decision and training paths and its LM serving
paths (dense GQA and RWKV-6) on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU, nvcc and
PyTorch built for CUDA; it needs no JAX and no network. Phases, in
order, each fatal on failure:

1. the card's name and power limit (nvidia-smi); TF32 off for matmuls
   and convolutions, so the plain versions run in full float32;
2. build every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc per
   source, all started together) and print the build time and each
   kernel instance's registers, spills and static shared memory; fail if
   ptxas warns that it serialized a kernel's wgmma (C7514, C7518), which
   costs speed and no correctness;
3. hold each actor kernel against its plain PyTorch version on the card,
   at the main path's shapes and inputs for B in {1, 64, 1024} fleets: max
   abs error <= 1e-5; per launch (layer and side) print the tile from
   kernels/gcn_agg.py::plan (G graphs and C columns a block, K split,
   weight stages), blocks per SM and shared memory from the kernel's own
   layout, kernel time (CUDA-graph replay, so host launch overhead is
   excluded) beside the first design's (FIRST_DESIGN_US), plain time and
   the bound; per slot the sums; first the launch floor, the graph-replay
   time of a one-element in-place add;
4. golden replay: ``tests/data/torch_port_golden.npz`` (a JAX run with
   its draws) through the port's driver on the card — every decision
   matches, or differs only at a recorded near-tie (margin <= 1e-5);
5. the decision path: GRLE on fig5_baseline at full width (M=14, N=2,
   L=5, hidden (128, 64), edge 64, 143 candidates), 64 fleets, 200 slots
   on the port's own generator, random weights from seed 0; the launch
   counts must read exactly 4 per slot for gcn_agg and 1 for edge_score;
6. the attention kernels against their plain versions: flash_attention at
   Llama-3.2-1B's prefill shape [4, 2048, 32 heads, 8 kv heads, 64] and
   on tests/test_kernels.py's grid (window 64 included); decode_attention
   at [B in {1, 64}, 32, 8, 64, S=4096] with lengths from numpy seed 0 in
   [1, S] and all equal to S, at the serve shape [8, 32, 8, 64, 256], and
   on tests/test_kernels.py's grid; every shape in f32 and bf16, with the
   tolerances there (f32 2e-5, bf16 2e-2; the f32 checks hold the
   arithmetic tightly at the main path's shapes too; in bf16 the flash
   kernel's tensor cores round P to bf16, which the tests show stays
   within the bf16 gate); every bf16 flash shape also against
   ref.flash_attention_bf16_emulation, the kernel's own rounding in plain
   PyTorch: what its bf16 output store (half an ulp) leaves of the error,
   over 1 + the largest |value| of its row, within FLASH_EMU_TOL, which at
   the prefill shape must reject three faulty versions of the emulation
   (a key tile lost for long rows, one warpgroup's last rescale skipped,
   O rounded to bf16 after every tile); at the main path's shapes in bf16, kernel,
   plain and library times (scaled_dot_product_attention, the yardstick
   only) and the bound, and decode's split count per shape; then decode at B=1
   against 4096 rows with every split count forced (1..8), f32 and bf16,
   a random length and the full one, checked and (bf16) timed (a
   sequence of length 0 gets the mean of its V rows, as from the
   reference; tests/test_torch_cuda.py holds that at every split count);
7. LM golden replay: ``tests/data/torch_lm_golden.npz`` (reduced Llama,
   f32, JAX outputs) through the port's prefill and serve steps on the
   card: prefill logits, prefill cache and every exit's serve logits
   within 1e-4;
8. prefill at full width: llama3_2_1b, bf16, random weights from seed 0,
   B=4, S=2048; exactly 16 flash_attention and 0 decode_attention
   launches;
9. serve at full width: greedy decoding as EdgeServingEngine._decode does
   it, B=8 prompts of 16..64 tokens (numpy seed 0), 32 new tokens, a
   256-row cache, at each exit (4, 8, 12, 16); decode_attention launches
   = exit x steps; then one serve_step per exit at B=64 against a
   4096-row cache from a prefill (pos = 4095);
10. consistency at full width: a 256-token prefill at B=2 against the
   same tokens teacher-forced through serve_step: last logits and every
   layer's K/V within relative L2 2e-2 (bf16);
11. ssm_scan against its plain version: tests/test_kernels.py's grid in
   both semantics (Mamba without a bonus, RWKV with one) and RWKV-6-7B's
   prefill shape [4, 2048, 64, 64, 64], chunk 128, RWKV semantics, in f32
   and bf16, unit-normal q, k, v; each with the fast log decay -exp(0.5 N)
   of the tests and a slow one -exp(0.5 N - 5) with a nonzero initial
   state, so the carried state matters; y and the final state within f32
   1e-4 / bf16 3e-2 of 1 + the largest |value| of their (sequence, head)
   (float32 rounding scales with the sums a recurrence adds, and |y|
   reaches ~400 at slow decays); at the prefill shape in f32 the same
   tolerance must reject the plain version with the initial state
   dropped, the decays one token late or the bonus dropped; every bf16
   shape also against ref.ssm_scan_bf16_emulation, the tensor-core
   kernel's own rounding in plain PyTorch (ref.ssm_emu_err: y beyond its
   bf16 output rounding within ref.SSM_EMU_TOL, the state within
   ref.SSM_EMU_STATE_TOL, of 1 + the largest |value| of the sequence and
   head), which at the prefill shape must reject three faults planted in
   the emulation (the last off-diagonal sub-block dropped for the last
   sub-block's rows, the carried-state read skipped in the last chunk,
   k_out's lo half dropped); the bf16 and f32 kernels' shared memory and
   blocks per SM at the prefill shape (bf16 must fit two); in bf16
   kernel time (CUDA-graph replay) beside the first design's, plain time
   (CUDA events around one eager call: the plain version is a 2048-step
   loop) and the bound (the recurrence's 5 dk dv operations per token and
   head);
12. RWKV golden replay: ``tests/data/torch_rwkv_golden.npz`` (reduced
   RWKV-6, f32, JAX outputs) through the port on the card: prefill logits
   and state and every exit's serve logits within 1e-4;
13. prefill at full width: rwkv6_7b (Llama's params freed first), bf16,
   random weights from seed 0, B=4, S=2048; exactly 32 ssm_scan launches
   and no attention launch;
14. serve at full width: greedy decoding as in phase 9, B=8 prompts of
   16..64 tokens, 32 new tokens, at each exit (8, 16, 24, 32); no kernel
   launch (decode runs the plain recurrence step) and no state past the
   exit written; then one serve_step per exit at B=64 from the state of a
   256-token prefill;
15. consistency at full width: a 256-token prefill at B=2 against the
   same tokens teacher-forced through serve_step, relative L2 of the last
   logits and every layer's wkv, shift_tm and shift_cm: in bf16 all
   printed and layer 0's (same inputs on both paths) within 2e-2; then on
   the same weights in float32, all within 2e-3, once with the init's
   decays and once with w0 uniform in [-6, 0] (slow decays, so the state
   carried across prefill's two chunks matters); in bf16 the drift grows
   with depth to ~0.1-0.2, in the JAX reference too (tools/rwkv_drift.py);
16. training, the actor kernels' gradients: at the training minibatch
   (64 graphs of a fresh slot, full width, the option side's transposed
   adjacency view), every input's gradient of each of the five actor
   launches (the kernel's forward, the hand-written backward) against
   PyTorch's autograd of the plain version, for a random cotangent,
   within rtol 2e-4 / atol 1e-4 (tests/test_kernels.py's);
17. training golden replay: ``tests/data/torch_port_train_golden.npz`` (a
   JAX ``train=True`` run, B=4, T=64, 5 train steps, with its draws and
   each step's replay rows) through the port's driver: decisions equal,
   or a flip only at a recorded near-tie (<= 1e-5), after which the
   comparison stops (fatal before the first train step); each loss
   within 1e-5 relative; the final params and Adam moments within
   TRAIN_PARAM_TOL (nu: TRAIN_NU_TOL);
18. the training path at full width on the port's own generator: B=64,
   T=200, ring 128, minibatch 64, a step every 10 slots: 20 finite
   losses, exactly 880 gcn_agg and 220 edge_score launches, slot ms
   beside the decision path's (episodes in the order decision, training,
   training, decision), and one train step split into forward, backward
   and Adam: ms by CUDA events and CUDA launches of each;
19. the compiled episode, ``RolloutDriver.run(mode="scan")`` (one CUDA
   graph a slot; phases 4, 5, 17 and 18 pass ``mode="loop"``, whose
   launches the wrappers count, which they cannot for a graph's replays):
   (1) the decision golden in scan mode, 128/128 as in phase 4; (2) the
   training golden in scan mode as in phase 17, then against the loop on
   the same draws: decisions and rewards bit for bit, the largest loss
   and param differences printed; (3) B=64, T=200, fig5_baseline on the
   port's own generator (registered with the graphs), without and with
   training (ring 128, minibatch 64, a step every 10 slots): slot ms of
   episodes in the order loop, scan, scan, loop; from the profiler's
   device records of a scan episode exactly 800 gcn_agg and 200
   edge_score launches (880 and 220 with training), each cudaGraphLaunch
   carrying its own slot's (4 and 1, 8 and 2 on a train step), one
   cudaGraphLaunch a slot and the busy share; whether scan equals loop bit for bit on one
   seed (else both runs' ssp and avg_accuracy); (4) B=1024, T=50 without
   training, slot ms of loop and scan; (5) B=64, T=200 with training and
   ``telemetry=True``: scan's counters and histogram counts equal the
   loop's bit for bit and its loss EMA within 1e-5 relative, the counters
   agree with the trace, and telemetry on and off give the same
   decisions, rewards and params; scan slot ms with telemetry on and off;
20. one ``{"kernels": [...]}`` line (launches of phase 18), the card line
   again, and last ``{"ok": true, "device": {...}}``.

Exits non-zero, printing no result, when no GPU is available.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

GOLDEN = os.path.join(ROOT, "tests", "data", "torch_port_golden.npz")
TRAIN_GOLDEN = os.path.join(ROOT, "tests", "data",
                            "torch_port_train_golden.npz")
LM_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_lm_golden.npz")
RWKV_GOLDEN = os.path.join(ROOT, "tests", "data", "torch_rwkv_golden.npz")
TOL = 1e-5            # max abs error, kernel vs plain, float32
NEAR_TIE = 1e-5       # golden: a flipped decision must sit at such a margin
N_FLEETS, N_SLOTS, SEED = 64, 200, 0
# training: tests/test_kernels.py's tolerance for the actor kernels'
# gradients; each golden train step's loss, relative; the golden run's
# final params and Adam moments (rtol, atol): tests/test_policy.py's rtol,
# atol ~5x the largest abs errors the card read (params 3.725e-8, mu
# 2.235e-8, nu 2.619e-10; NVIDIA H100 80GB HBM3, 700 W; PERF.md §6)
GRAD_RTOL, GRAD_ATOL = 2e-4, 1e-4
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_TOL = (1e-4, 2e-7)
TRAIN_NU_TOL = (1e-4, 2e-9)
# attention: tests/test_kernels.py's tolerances; LM golden; consistency
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LM_GOLDEN_TOL = 1e-4
# bf16 flash_attention against its emulation, beyond the output's bf16
# rounding (flash_emu_err): what remains are P's bf16 roundings that the
# kernel's ex2.approx and summation order tip the other way, each moving a
# short row by up to 2^-8 of a key's weight; ~2x the largest reading on the
# card, well under the faults of FLASH_FAULTS
FLASH_EMU_TOL = 1e-3
# torch.profiler (torch 2.11, CUDA 12.8, H100) can lose the device records
# of the last milliseconds of work in its window, even after a synchronize:
# a scan episode whose window closed at once showed 872 of its 880 gcn_agg
# launches, the last slots' records missing (tools/torch_profiler_window.py
# measures it). Every profiled window here stays open this long after its
# work's closing synchronize.
PROFILER_TAIL_S = 0.2
# ptxas' warnings that it serialized a kernel's wgmma instructions
WGMMA_SERIALIZED = ("C7514", "C7518")
CONSIST_TOL = 2e-2
# RWKV-6 in bf16 drifts far more than that over its 32 layers, in the JAX
# reference too (tools/rwkv_drift.py); its full-depth consistency is held in
# float32, 10x tighter than the bf16 limit, and in bf16 at layer 0 only,
# whose inputs both paths share
CONSIST_F32_TOL = 2e-3
# the LM path: Llama-3.2-1B at full width
LM_ARCH = "llama3_2_1b"
PREFILL_B, PREFILL_S = 4, 2048
SERVE_B, SERVE_NEW, SERVE_CACHE, PROMPT_LENS = 8, 32, 256, (16, 64)
LONG_B, LONG_S = 64, 4096
CONSIST_B, CONSIST_P = 2, 256
# the SSM path: RWKV-6-7B at full width; tests/test_kernels.py's ssm grid
# (B, T, H, dk, dv, chunk) and tolerances, taken of 1 + the largest |value|
# of each (sequence, head) (scan_err)
SSM_ARCH = "rwkv6_7b"
SSM_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SSM_GRID = ((2, 64, 2, 8, 16, 16), (1, 128, 4, 16, 16, 32),
            (2, 32, 1, 64, 32, 32))
SSM_PREFILL = (PREFILL_B, PREFILL_S, 64, 64, 64, 128)
SSM_LONG_B, SSM_LONG_P = 64, 256
# the bf16 scan's time at SSM_PREFILL in its first design (f32 products on
# the CUDA cores, one block per SM; PERF.md §6 row 5), beside the current
SSM_FIRST_DESIGN_US = 2338.39
STATE_FIELDS = ("wkv", "shift_tm", "shift_cm")
# the actor kernels at B fleets: a live scheduler, the smoke's fleets, a
# sweep or population evaluation
ACTOR_BATCHES = (1, N_FLEETS, 1024)
# device us per launch of the first design (one block per graph, weights
# read through L1/L2), by launch and B: tools/torch_actor_kernels.py on
# that tree, NVIDIA H100 80GB HBM3 at 700 W, the mean of two runs in one
# call (PERF.md §6)
FIRST_DESIGN_US = {
    "gcn_agg": {
        "layer1/device": {1: 7.10, 64: 7.33, 1024: 17.50},
        "layer1/option": {1: 6.20, 64: 6.40, 1024: 13.77},
        "layer2/device": {1: 44.42, 64: 49.00, 1024: 103.53},
        "layer2/option": {1: 24.10, 64: 25.67, 1024: 65.92}},
    "edge_score": {"edge": {1: 11.47, 64: 12.01, 1024: 40.48}},
}
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, non-tensor-core float32
# FLOP/s and dense bf16 FLOP/s; a bound takes the rate of its inputs' type
# (peak_for), whatever units the kernel itself computes on
PEAK_BYTES, PEAK_F32, PEAK_BF16 = 3.35e12, 67e12, 989e12
TASK_FIELDS = ("size_bits", "deadline_s", "rate_true", "rate_est", "capacity",
               "cmp_true", "cmp_est", "connect", "active")


def phase(n, title):
    print(f"\n== phase {n}: {title}", flush=True)


def ptxas_report(log):
    """(kernel, registers, spill stores/loads, static smem bytes) of each
    entry function in nvcc's -Xptxas -v output, names demangled by
    c++filt where the machine has it."""
    rows, fn, spills = [], None, "?"
    for line in log.splitlines():
        if "Function properties for" in line:
            fn, spills = line.split("Function properties for")[1].strip(), "?"
        elif "spill stores" in line:
            parts = line.replace(",", "").split()
            spills = f"{parts[parts.index('spill') - 2]}/" \
                f"{parts[parts.index('loads') - 3]}"
        elif "Used" in line and "registers" in line and fn:
            words = line.replace(",", "").split()
            regs = words[words.index("registers") - 1]
            smem = (words[words.index("smem") - 2]
                    if "smem" in words else "0")
            rows.append([fn, regs, spills, smem])
            fn = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            r[0] for r in rows), capture_output=True, text=True,
            timeout=60, check=True).stdout.splitlines()
        if len(names) == len(rows):
            for r, n in zip(rows, names):
                n = n.replace("(anonymous namespace)::", "")
                r[0] = n.split("(")[0].removeprefix("void ")
    except (OSError, subprocess.SubprocessError):
        pass
    return rows


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


# ----------------------------------------------------------------- timing
def graph_ms(fn, *, inner=20, reps=10) -> float:
    """Device time of one ``fn()`` call: ``inner`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * inner)


def eager_ms(fn, *, n=200) -> float:
    """Wall time of one eager ``fn()`` call, host launch path included."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def numel(*ts) -> int:
    return sum(t.numel() for t in ts)


def gcn_agg_cost(adj, hs, hn, ws, wn, b):
    """(bytes, flops) the function needs: each input read once, the output
    written once; adj@hn, deg, the divide, both products, bias, relu."""
    bsz, m, o = adj.shape
    fs, fn, h = hs.shape[-1], hn.shape[-1], ws.shape[-1]
    out = bsz * m * h
    nbytes = 4 * (numel(adj, hs, hn, ws, wn, b) + out)
    flops = bsz * m * (2 * o * fn + o + fn) + out * (2 * fs + 2 * fn + 3)
    return nbytes, flops


def edge_score_cost(hs, hd, ef, ws, bs, wd, wf, wo, bo):
    bsz, m, o = ef.shape
    h, e = ws.shape
    nbytes = 4 * (numel(hs, hd, ef, ws, bs, wd, wf, wo, bo) + bsz * m * o)
    flops = (bsz * m * e * (2 * h + 1) + bsz * o * e * 2 * h
             + bsz * m * o * (6 * e + 1))
    return nbytes, flops


def bound(nbytes, flops, peak_flops=PEAK_F32):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def causal_pairs(s, window):
    """(query, key) pairs a causal mask keeps, with an optional window."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_cost(q, k, window):
    """Each of q, k, v read once, the output written once; QK^T and PV
    over the kept (causal) pairs only."""
    b, s, h, d = q.shape
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    return nbytes, 4 * b * h * d * causal_pairs(s, window)


def decode_cost(q, k, lengths):
    """q and the output once, the K/V rows below each length once (the
    kernel reads no others), the lengths; QK^T and PV over those rows."""
    b, h, d = q.shape
    rows = int(lengths.clamp(max=k.shape[1]).sum())
    nbytes = (q.element_size() * (2 * q.numel() + 2 * rows * k.shape[2] * d)
              + 4 * b)
    return nbytes, 4 * h * d * rows


def flash_emu_err(got, emu):
    """The bf16 flash kernel's error against its emulation beyond the
    bf16 rounding of its output (half an ulp, <= 2^-8 |emu|), over 1 + the
    largest |emu| of its row (query, head): f32 summation order and
    ex2.approx are all that should remain."""
    g, e = got.float(), emu.float()
    excess = ((g - e).abs() - 2.0 ** -8 * e.abs()).clamp(min=0)
    return float((excess.amax(-1) / (1 + e.abs().amax(-1))).max())


FLASH_FAULTS = ("a key tile lost for long rows",
                "the second warpgroup's last rescale skipped",
                "O rounded to bf16 after every tile")


def flash_fault(q, k, v, fault, tile=64):
    """ref.flash_attention_bf16_emulation (causal, no window) with one
    fault of FLASH_FAULTS planted, as the kernel could have it: query rows
    in the second half of S drop the key tile just before their 128-row
    block; or the second half's rows of each block's second 64 (the second
    warpgroup) skip the rescale of O on their last tile; or O is kept in
    bf16 between tiles. Float32 out, as the emulation's."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qf = q.float().reshape(b, s, kvh, h // kvh, d)
    kf, vf = k.float(), v.float()
    scale = 1.4426950408889634 / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    block = pos // 128 * 128
    late = pos >= s // 2
    m = torch.full((b, kvh, h // kvh, s), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(m.shape + (d,), device=q.device)
    for k0 in range(0, s, tile):
        kp = pos[k0:k0 + tile]
        sc = torch.einsum("bqkgd,bskd->bkgqs", qf,
                          kf[:, k0:k0 + tile]) * scale
        ok = kp[None, :] <= pos[:, None]
        if fault == FLASH_FAULTS[0]:
            ok &= ~(late & (block - tile == k0))[:, None]
        sc = torch.where(ok, sc, -math.inf)
        mx = torch.maximum(m, sc.amax(-1))
        mu = torch.where(mx == -math.inf, 0.0, mx)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(sc - mu[..., None])
        l = l * alpha + p.sum(-1)
        rescale = alpha
        if fault == FLASH_FAULTS[1]:
            skip = late & (pos % 128 >= 64) & (pos // tile * tile == k0)
            rescale = torch.where(skip, 1.0, alpha)
        acc = acc * rescale[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.bfloat16().float(), vf[:, k0:k0 + tile])
        if fault == FLASH_FAULTS[2]:
            acc = acc.bfloat16().float()
        m = mx
    out = acc / l.clamp(min=1e-38)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def peak_for(dtype):
    return PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32


def rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


# -------------------------------------------------------------- LM phases
def attention_phase(dev):
    """Phase 6: both attention kernels against their plain versions; at
    the main path's shapes also kernel, plain and library times and the
    bound. Returns the summary fields of each kernel."""
    from repro_torch.kernels import decode_attention as decode_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def normal(dtype, *shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def check(kernel, label, dtype, got, want):
        """|kernel - plain| <= tol + tol * |plain| elementwise, as
        np.testing.assert_allclose(rtol=tol, atol=tol)."""
        diff = (got.float() - want.float()).abs()
        tol = ATTN_TOL[dtype]
        err = float(diff.max())
        print(f"  {kernel:16s} {label:44s} {str(dtype)[6:]:8s} max_abs_err "
              f"{err:.3e}", flush=True)
        if not bool((diff <= tol + tol * want.float().abs()).all()):
            raise SystemExit(f"{kernel} {label} {dtype}: kernel differs from "
                             f"plain by more than {tol} (rtol and atol); max "
                             f"abs error {err}")
        return err

    def check_emulation(label, got, emu):
        err = flash_emu_err(got, emu)
        print(f"  {'flash_attention':16s} {label:44s} {'bfloat16':8s} vs "
              f"emulation {err:.3e} beyond the output's rounding", flush=True)
        if err > FLASH_EMU_TOL:
            raise SystemExit(f"flash_attention {label} bf16: kernel differs "
                             f"from its emulation by {err} beyond the "
                             f"output's rounding (limit {FLASH_EMU_TOL})")
        return err

    def flash_controls(q, k, v, emu, plain):
        """The emulation check must reject each planted fault; whether the
        2e-2 gate against plain would is printed beside it."""
        tol = ATTN_TOL[torch.bfloat16]
        for fault in FLASH_FAULTS:
            bad = flash_fault(q, k, v, fault).bfloat16()
            err = flash_emu_err(bad, emu)
            gate = bool(((bad.float() - plain.float()).abs()
                         <= tol + tol * plain.float().abs()).all())
            print(f"  control: {fault}: {err:.3e} beyond the output's "
                  f"rounding (limit {FLASH_EMU_TOL}); the 2e-2 gate "
                  f"{'accepts' if gate else 'rejects'} it", flush=True)
            if err <= FLASH_EMU_TOL:
                raise SystemExit(f"flash_attention: the emulation check "
                                 f"accepts a planted fault ({fault})")

    def library_ms(library, inner, reps):
        """The yardstick's time; None (and why) if it cannot run here."""
        try:
            return graph_ms(library, inner=inner, reps=reps)
        except (RuntimeError, ValueError, TypeError) as exc:
            print(f"  library call not timed: {type(exc).__name__}: "
                  f"{str(exc).splitlines()[0] if str(exc) else ''}")
            return None

    def timed(kernel, label, fn, plain, library, cost, dtype, inner, reps):
        ms = graph_ms(fn, inner=inner, reps=reps)
        plain_ms = graph_ms(plain, inner=inner, reps=reps)
        lib_ms = library_ms(library, inner, reps)
        b_ms, b_by = bound(*cost, peak_flops=peak_for(dtype))
        lib = "n/a" if lib_ms is None else f"{lib_ms * 1e3:9.2f} us"
        print(f"  {kernel:16s} {label:44s} kernel {ms * 1e3:9.2f} us  plain "
              f"{plain_ms * 1e3:9.2f} us  library {lib}  "
              f"bound {b_ms * 1e3:8.2f} us ({b_by}, {cost[0] / 1e6:.1f} MB, "
              f"{cost[1] / 1e9:.2f} GFLOP)", flush=True)
        return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                    bound_ms=b_ms, bound_by=b_by)

    out = {}
    # flash_attention: the prefill shape in bf16 (timed) and f32, then
    # tests/test_kernels.py's grid
    grid = [(PREFILL_B, PREFILL_S, 32, 8, 64, None, dt)
            for dt in (torch.bfloat16, torch.float32)] + [
        (b, s, h, kvh, d, win, dt) for dt in (torch.float32, torch.bfloat16)
        for b, s, h, kvh, d, win in ((1, 128, 2, 2, 32, None),
                                     (2, 128, 4, 2, 64, None),
                                     (1, 256, 8, 2, 32, 64),
                                     (2, 64, 4, 1, 128, None),
                                     (1, 200, 8, 2, 64, 64),
                                     (1, 200, 4, 2, 128, None))]
    errs, emu_errs = [], []
    for i, (b, s, h, kvh, d, win, dt) in enumerate(grid):
        q, k, v = normal(dt, b, s, h, d), normal(dt, b, s, kvh, d), \
            normal(dt, b, s, kvh, d)
        label = f"[{b}, {s}, {h}, {kvh}, {d}] window {win}"
        got = flash_mod.flash_attention(q, k, v, window=win)
        torch.cuda.synchronize()
        plain = ref.flash_attention_ref(q, k, v, window=win)
        err = check("flash_attention", label, dt, got, plain)
        if i < 2:
            errs.append(err)
        if dt == torch.bfloat16:
            emu = ref.flash_attention_bf16_emulation(q, k, v, window=win)
            emu_errs.append(check_emulation(label, got, emu))
            if i == 0:
                flash_controls(q, k, v, emu, plain)
            del emu
        del plain
        if i == 0:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            out["flash_attention"] = timed(
                "flash_attention", label,
                lambda: flash_mod.flash_attention(q, k, v),
                lambda: ref.flash_attention_ref(q, k, v),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True),
                flash_cost(q, k, None), dt, inner=5, reps=4)
    out["flash_attention"]["max_abs_err"] = max(errs)
    print(f"  flash_attention bf16 vs its emulation, largest error beyond "
          f"the output's rounding: {max(emu_errs):.3e} (limit "
          f"{FLASH_EMU_TOL})")

    # decode_attention: the main path's shapes in bf16 (timed) and f32,
    # then the test grid; one draw of lengths serves both dtypes
    lens_rng = np.random.default_rng(SEED)
    errs = []
    main_dts = (torch.bfloat16, torch.float32)
    # (B, H, KVH, d, S, dtypes, lengths, at a main-path shape)
    cases = [(bb, 32, 8, 64, LONG_S, main_dts, lens, True)
             for bb in (1, LONG_B) for lens in ("random", "full")]
    cases += [(SERVE_B, 32, 8, 64, SERVE_CACHE, main_dts, "random", True)]
    cases += [(b, h, kvh, d, s, (dt,), "random", False)
              for dt in (torch.float32, torch.bfloat16)
              for b, h, kvh, d, s in ((2, 4, 2, 32, 256), (3, 8, 2, 64, 512),
                                      (1, 2, 2, 128, 128))]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b, h, kvh, d, s, dts, kind, main_shape in cases:
        lens = (np.full(b, s) if kind == "full"
                else lens_rng.integers(1, s + 1, size=b))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        label = f"[{b}, {h}, {kvh}, {d}, S={s}] lengths {kind}"
        if main_shape:
            n = decode_mod.n_splits(b, kvh, s, sms)
            print(f"  decode_attention {label}: n_splits {n}, "
                  f"{decode_mod.n_warps(b * kvh * n, sms)} warps per block, "
                  f"{sms} SMs, lengths sum {int(lens.sum())}")
        for dt in dts:
            q, k, v = normal(dt, b, h, d), normal(dt, b, s, kvh, d), \
                normal(dt, b, s, kvh, d)
            got = decode_mod.decode_attention(q, k, v, lengths)
            torch.cuda.synchronize()
            err = check("decode_attention", label, dt, got,
                        ref.decode_attention_ref(q, k, v, lengths))
            if main_shape:
                errs.append(err)
            if not main_shape or dt != torch.bfloat16:
                continue
            mask = (torch.arange(s, device=dev)[None, :]
                    < lengths[:, None])[:, None, None, :]
            q4, kt, vt = (q[:, :, None, :], k.transpose(1, 2),
                          v.transpose(1, 2))
            stats = timed(
                "decode_attention", label,
                lambda: decode_mod.decode_attention(q, k, v, lengths),
                lambda: ref.decode_attention_ref(q, k, v, lengths),
                lambda: F.scaled_dot_product_attention(
                    q4, kt, vt, attn_mask=mask, enable_gqa=True),
                decode_cost(q, k, lengths), dt, inner=20, reps=10)
            if b == LONG_B and kind == "full":
                out["decode_attention"] = stats

    # decode_attention at B=1 against 4096 rows, every split count forced
    lens = (int(lens_rng.integers(1, LONG_S + 1)), LONG_S)
    for dt in main_dts:
        q, k, v = normal(dt, 1, 32, 64), normal(dt, 1, LONG_S, 8, 64), \
            normal(dt, 1, LONG_S, 8, 64)
        for n in range(1, decode_mod.MAX_SPLITS + 1):
            for ln in lens:
                lengths = torch.tensor([ln], dtype=torch.int32, device=dev)
                got = decode_mod.decode_attention(q, k, v, lengths, splits=n)
                torch.cuda.synchronize()
                errs.append(check(
                    "decode_attention", f"[1, 32, 8, 64, S={LONG_S}] length "
                    f"{ln}, splits {n}", dt, got,
                    ref.decode_attention_ref(q, k, v, lengths)))
            if dt == torch.bfloat16:
                ms = graph_ms(lambda: decode_mod.decode_attention(
                    q, k, v, lengths, splits=n), inner=20, reps=10)
                print(f"  decode_attention B=1 S={LONG_S} full, splits {n}: "
                      f"kernel {ms * 1e3:9.2f} us", flush=True)
    out["decode_attention"]["max_abs_err"] = max(errs)
    return out


def lm_golden_phase(dev):
    """Phase 7: the reduced-Llama JAX run through the port on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.core.bridge import lm_params_from_numpy, lm_params_numpy
    from repro_torch.models import DecoderLM
    from repro_torch.train import make_prefill_step, make_serve_step

    with np.load(LM_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    cfg = get_arch(str(gold["arch"])).reduced(
        **{k.split("/")[1]: int(gold[k]) for k in gold
           if k.startswith("reduced/")})
    params = lm_params_from_numpy(lm_params_numpy(cfg, int(gold["seed"])),
                                  cfg, dev)
    toks = torch.tensor(gold["tokens"], device=dev)
    b, t = toks.shape
    n = int(gold["prefill_len"])

    def err(got, key):
        want = torch.tensor(gold[key], device=dev)
        return float(((got.float() - want).abs() / (1 + want.abs())).max())

    logits, cache = make_prefill_step(cfg)(params, {"tokens": toks[:, :n]})
    errs = {"prefill/logits": err(logits, "prefill/logits"),
            "prefill/k": err(cache["layers"].k, "prefill/k"),
            "prefill/v": err(cache["layers"].v, "prefill/v")}
    for e in (int(x) for x in gold["exits"]):
        step = make_serve_step(cfg, exit_layer=e)
        c = DecoderLM.init_cache(cfg, b, t, device=dev)
        got = []
        for i in range(t):
            lg, c = step(params, c, toks[:, i],
                         torch.full((b,), i, dtype=torch.int64, device=dev))
            got.append(lg)
        errs[f"serve/logits_{e}"] = err(torch.stack(got), f"serve/logits_{e}")
    for k, v in errs.items():
        print(f"  {k:18s} max |d| / (1 + |ref|) {v:.3e}")
    worst = max(errs.values())
    if not worst <= LM_GOLDEN_TOL:
        raise SystemExit(f"LM golden: error {worst} above {LM_GOLDEN_TOL}")
    return worst


def lm_model(dev, arch=LM_ARCH):
    from repro_torch.configs import get_arch
    from repro_torch.models import DecoderLM

    cfg = get_arch(arch)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = DecoderLM.init(gen, cfg, device=dev)
    n = sum(x.numel() for x in _leaves(params))
    heads = (f"{cfg.n_heads} heads over {cfg.n_kv_heads} kv heads x "
             f"{cfg.head_dim}" if cfg.n_heads else
             f"{cfg.d_model // cfg.ssm_head_dim} {cfg.ssm_kind} heads x "
             f"{cfg.ssm_head_dim}, chunk {cfg.ssm_chunk}")
    print(f"{cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {heads}, exits "
          f"{cfg.exit_layers}, {cfg.dtype}; {n / 1e9:.3f} B params "
          f"(random, torch.Generator seed {SEED})", flush=True)
    return cfg, params, gen


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def prefill_phase(dev, cfg, params, gen):
    """Phase 8: one full-width prefill, its launches counted."""
    from repro_torch.kernels import ops
    from repro_torch.train import make_prefill_step

    prefill = make_prefill_step(cfg)
    toks = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen,
                         device=dev)
    prefill(params, {"tokens": toks[:, :256]})      # warm-up: cuBLAS, attrs
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"B={PREFILL_B} S={PREFILL_S}: {wall * 1e3:.3f} ms, "
          f"{PREFILL_B * PREFILL_S / wall:.1f} prompt tokens/s; launches "
          f"{counts}")
    if (counts["flash_attention"] != cfg.n_layers
            or counts["decode_attention"] or counts["ssm_scan"]):
        raise SystemExit(f"prefill launches {counts}: expected "
                         f"flash_attention {cfg.n_layers}, decode_attention 0")
    kv = (cfg.n_layers, PREFILL_B, PREFILL_S, cfg.n_kv_heads, cfg.head_dim)
    if (tuple(logits.shape) != (PREFILL_B, cfg.vocab)
            or not bool(torch.isfinite(logits).all())
            or tuple(cache["layers"].k.shape) != kv
            or not bool(torch.isfinite(cache["layers"].k).all())):
        raise SystemExit("prefill output malformed")
    return counts["flash_attention"]


def greedy_decode(params, step, cache, prompt_mat, lens, max_new):
    """EdgeServingEngine._decode's loop: teacher-force each prompt, then
    feed back the argmax; returns each request's ``max_new`` outputs and
    the number of steps."""
    b, total = prompt_mat.shape
    dev = prompt_mat.device
    lens_d = torch.tensor(lens, device=dev)
    cur = prompt_mat[:, 0]
    toks = []
    for pos in range(total):
        logits, cache = step(params, cache, cur,
                             torch.full((b,), pos, dtype=torch.int64,
                                        device=dev))
        nxt = torch.argmax(logits, -1)
        toks.append(nxt)
        if pos + 1 < total:
            cur = torch.where(pos + 1 < lens_d, prompt_mat[:, pos + 1], nxt)
    gen = torch.stack(toks, 1).cpu().numpy()
    return [gen[i, lens[i] - 1: lens[i] - 1 + max_new]
            for i in range(b)], total


def serve_phase(dev, cfg, params, gen):
    """Phase 9: greedy decoding at every exit, launches counted; then one
    serve_step per exit at B=64 against a 4096-row cache."""
    from repro_torch.kernels import ops
    from repro_torch.models import DecoderLM
    from repro_torch.train import make_prefill_step, make_serve_step

    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=SERVE_B)
    total = int(lens.max()) + SERVE_NEW
    mat = np.zeros((SERVE_B, total), np.int64)
    for i, n in enumerate(lens):
        mat[i, :n] = rng.integers(0, cfg.vocab, size=n)
    prompt_mat = torch.tensor(mat, device=dev)
    print(f"B={SERVE_B} prompts of {sorted(lens.tolist())} tokens, "
          f"max_new {SERVE_NEW}, cache {SERVE_CACHE} rows, {total} steps")
    warm = DecoderLM.init_cache(cfg, SERVE_B, SERVE_CACHE, device=dev)
    greedy_decode(params, make_serve_step(cfg), warm, prompt_mat[:, :3],
                  lens.clip(max=3), 0)
    del warm
    decode_launches, rows = 0, {}
    for e in cfg.exit_layers:
        step = make_serve_step(cfg, exit_layer=e)
        cache = DecoderLM.init_cache(cfg, SERVE_B, SERVE_CACHE, device=dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs, steps = greedy_decode(params, step, cache, prompt_mat, lens,
                                    SERVE_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        decode_launches += counts["decode_attention"]
        rows[e] = wall / steps * 1e3
        print(f"  exit {e:2d}: {wall / steps * 1e3:8.3f} ms/step, "
              f"{SERVE_B * SERVE_NEW / wall:9.1f} generated tokens/s, "
              f"launches {counts}", flush=True)
        if (counts["decode_attention"] != e * steps
                or counts["flash_attention"]):
            raise SystemExit(f"exit {e}: launches {counts}, expected "
                             f"decode_attention {e * steps}")
        if any(len(o) != SERVE_NEW or o.min() < 0 or o.max() >= cfg.vocab
               for o in outs):
            raise SystemExit(f"exit {e}: generated tokens malformed")
        if cache["layers"].k[e:].any():
            raise SystemExit(f"exit {e}: a layer past the exit wrote the cache")
        del cache

    # one serve_step against a 4096-row cache filled by a prefill
    prefill = make_prefill_step(cfg)
    cache = DecoderLM.init_cache(cfg, LONG_B, LONG_S, device=dev)
    toks = torch.randint(0, cfg.vocab, (LONG_B, LONG_S), generator=gen,
                         device=dev)
    chunk = 16
    for i in range(0, LONG_B, chunk):
        _, c = prefill(params, {"tokens": toks[i:i + chunk]})
        cache["layers"].k[:, i:i + chunk] = c["layers"].k
        cache["layers"].v[:, i:i + chunk] = c["layers"].v
        del c
    pos = torch.full((LONG_B,), LONG_S - 1, dtype=torch.int64, device=dev)
    for e in cfg.exit_layers:
        step = make_serve_step(cfg, exit_layer=e)
        step(params, cache, toks[:, -1], pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            logits, _ = step(params, cache, toks[:, -1], pos)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        if not bool(torch.isfinite(logits).all()):
            raise SystemExit(f"B={LONG_B} exit {e}: logits not finite")
        print(f"  B={LONG_B} cache {LONG_S} exit {e:2d}: {ms:8.3f} ms/step, "
              f"{LONG_B / ms * 1e3:9.1f} tokens/s")
    del cache
    torch.cuda.empty_cache()
    return decode_launches


def consistency_phase(dev, cfg, params, gen):
    """Phase 10: prefill against teacher-forced decode on the same tokens."""
    from repro_torch.models import DecoderLM
    from repro_torch.train import make_prefill_step, make_serve_step

    toks = torch.randint(0, cfg.vocab, (CONSIST_B, CONSIST_P), generator=gen,
                         device=dev)
    logits_p, cache_p = make_prefill_step(cfg)(params, {"tokens": toks})
    step = make_serve_step(cfg)
    cache_d = DecoderLM.init_cache(cfg, CONSIST_B, CONSIST_P, device=dev)
    for t in range(CONSIST_P):
        logits_d, cache_d = step(params, cache_d, toks[:, t],
                                 torch.full((CONSIST_B,), t,
                                            dtype=torch.int64, device=dev))
    errs = {"logits": rel_l2(logits_d, logits_p)}
    for i in range(cfg.n_layers):
        errs[f"k[{i}]"] = rel_l2(cache_d["layers"].k[i], cache_p["layers"].k[i])
        errs[f"v[{i}]"] = rel_l2(cache_d["layers"].v[i], cache_p["layers"].v[i])
    print("relative L2, decode vs prefill: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()))
    worst = max(errs.values())
    if not worst <= CONSIST_TOL:
        raise SystemExit(f"consistency: relative L2 {worst} above "
                         f"{CONSIST_TOL}")
    return worst


# ------------------------------------------------------------- SSM phases
def ssm_cost(q, v, log_w, u, s0):
    """(bytes, flops) the function needs: q, k, v, log_w, u and the initial
    state read once, y and the final state written once; per token and
    head the recurrence's decay (dk·dv), update (2·dk·dv) and read-out
    (2·dk·dv), plus RWKV's bonus term (3·dk + 2·dv). The kernel's chunked
    form does more; that is its cost, not the function's."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    es = q.element_size()
    nbytes = (es * (2 * q.numel() + 2 * v.numel()) + 4 * log_w.numel()
              + 4 * b * h * dk * dv
              + sum(4 * x.numel() for x in (u, s0) if x is not None))
    per_token = 5 * dk * dv + (3 * dk + 2 * dv if u is not None else 0)
    return nbytes, b * t * h * per_token


def scan_err(got, want, state=False):
    """Max over elements of |got - want| / (1 + the largest |want| of the
    same (sequence, head)), for y [B,T,H,dv] or a state [B,H,dk,dv]. The
    float32 rounding of a recurrence's output scales with the sums it is
    made of, so with the largest outputs of its (sequence, head), not with
    each element's own size."""
    got, want = got.float(), want.float()
    scale = 1 + want.abs().amax(dim=(2, 3) if state else (1, 3),
                                keepdim=True)
    return float(((got - want).abs() / scale).max())
def event_ms(fn, *, reps=3) -> float:
    """Device time of one eager ``fn()`` between CUDA events, host launch
    path included (for the plain scan, a loop too long to capture)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def ssm_scan_phase(dev):
    """Phase 11: ssm_scan against its plain version, y and final state;
    at the prefill shape in f32 with slow decays, that the tolerance
    rejects three wrong answers; in bf16 kernel and plain times and the
    bound. Returns the kernel's summary fields."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as ssm_mod

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def normal(*shape, scale=1.0, shift=0.0):
        return torch.randn(shape, generator=gen, device=dev) * scale + shift

    def check(label, dtype, got, want, tol, state=False):
        err = scan_err(got, want, state)
        if not err <= tol:
            raise SystemExit(f"ssm_scan {label} {dtype}: kernel differs from "
                             f"plain by {err} of 1 + its (sequence, head)'s "
                             f"largest |value|, above {tol}")
        return err

    def check_emulation(label, y, st, emu_y, emu_s):
        """The bf16 kernel against its emulation, y beyond its output
        rounding and the state; returns both readings."""
        excess = ref.ssm_emu_excess(y, emu_y)
        err_y = float(excess.max())
        err_s = ref.ssm_emu_err(st, emu_s, state=True)
        # how sparse the y error is: rounding flips touch a few rows
        sparse = ", ".join(f"{int((excess > th).sum())} above {th}"
                           for th in (1e-4, 1e-3))
        print(f"  ssm_scan {label:46s} bfloat16 vs emulation: y {err_y:.3e} "
              f"beyond its rounding (limit {ref.SSM_EMU_TOL}; of "
              f"{excess.numel()} elements {sparse}), state {err_s:.3e} "
              f"(limit {ref.SSM_EMU_STATE_TOL})", flush=True)
        if err_y > ref.SSM_EMU_TOL or err_s > ref.SSM_EMU_STATE_TOL:
            raise SystemExit(f"ssm_scan {label} bf16: kernel differs from its "
                             f"emulation by y {err_y}, state {err_s}")
        return err_y, err_s

    def emulation_controls(q, k, v, log_w, u, s0, c, emu_y, emu_s, want_y):
        """The emulation check must reject each planted fault; whether the
        3e-2 gate against plain would is printed beside it."""
        for fault in ref.SSM_EMU_FAULTS:
            bad_y, bad_s = ref.ssm_scan_bf16_emulation(
                q, k, v, log_w, bonus_u=u, chunk=c, initial_state=s0,
                fault=fault)
            err_y = ref.ssm_emu_err(bad_y.bfloat16(), emu_y)
            err_s = ref.ssm_emu_err(bad_s, emu_s, state=True)
            gate = scan_err(bad_y, want_y) <= SSM_TOL[torch.bfloat16]
            print(f"  control: {fault}: y {err_y:.3e}, state {err_s:.3e} "
                  f"(limits {ref.SSM_EMU_TOL}, {ref.SSM_EMU_STATE_TOL}); the "
                  f"3e-2 gate {'accepts' if gate else 'rejects'} it",
                  flush=True)
            if err_y <= ref.SSM_EMU_TOL and err_s <= ref.SSM_EMU_STATE_TOL:
                raise SystemExit(f"ssm_scan: the emulation check accepts a "
                                 f"planted fault ({fault})")

    _, _, _, dk, dv, c = SSM_PREFILL
    info = {dt: ssm_mod.kernel_info(dk, dv, c, dt)
            for dt in (torch.bfloat16, torch.float32)}
    for dt, kinfo in info.items():
        print(f"  ssm_scan dk={dk} dv={dv} chunk {c} {str(dt)[6:]:8s} shared "
              f"memory {kinfo['smem_bytes']} bytes a block, "
              f"{kinfo['blocks_per_sm']} blocks per SM")
    if info[torch.bfloat16]["blocks_per_sm"] < 2:
        raise SystemExit("ssm_scan: the bf16 kernel no longer fits two "
                         "blocks per SM at the prefill shape")

    cases = [(shape, dt, rwkv, slow) for dt in (torch.float32, torch.bfloat16)
             for shape in SSM_GRID for rwkv in (False, True)
             for slow in (False, True)]
    cases += [(SSM_PREFILL, dt, True, slow)
              for dt in (torch.bfloat16, torch.float32) for slow in (False, True)]
    out, errs, emu_errs = None, [], []
    for (b, t, h, dk, dv, c), dt, rwkv, slow in cases:
        main_shape = (b, t, h, dk, dv, c) == SSM_PREFILL
        q = normal(b, t, h, dk).to(dt)
        k = normal(b, t, h, dk).to(dt)
        v = normal(b, t, h, dv).to(dt)
        log_w = -torch.exp(normal(b, t, h, dk, scale=0.5,
                                  shift=-5.0 if slow else 0.0))
        u = normal(h, dk, scale=0.2) if rwkv else None
        s0 = normal(b, h, dk, dv) if slow else None
        y, st = ssm_mod.ssm_scan(q, k, v, log_w, u, chunk=c, initial_state=s0)
        torch.cuda.synchronize()
        want_y, want_s = ref.ssm_scan_ref(q, k, v, log_w, bonus_u=u,
                                          initial_state=s0)
        label = (f"[{b}, {t}, {h}, {dk}, {dv}] chunk {c} "
                 f"{'rwkv' if rwkv else 'mamba'} {'slow' if slow else 'fast'}")
        err_y = check(label + " y", dt, y, want_y, SSM_TOL[dt])
        err_s = check(label + " state", dt, st, want_s, SSM_TOL[torch.float32],
                      state=True)
        print(f"  ssm_scan {label:46s} {str(dt)[6:]:8s} err y {err_y:.3e} "
              f"state {err_s:.3e} (max |y| "
              f"{float(want_y.float().abs().max()):.1f}, max abs error "
              f"{float((y.float() - want_y.float()).abs().max()):.3e})",
              flush=True)
        if main_shape:
            errs.append(float((y.float() - want_y.float()).abs().max()))
        if dt == torch.bfloat16:
            emu_y, emu_s = ref.ssm_scan_bf16_emulation(
                q, k, v, log_w, bonus_u=u, chunk=c, initial_state=s0)
            emu_errs.append(check_emulation(label, y, st, emu_y, emu_s))
            if main_shape and slow:
                emulation_controls(q, k, v, log_w, u, s0, c, emu_y, emu_s,
                                   want_y)
            del emu_y, emu_s
        if main_shape and dt == torch.float32 and slow:
            # the tolerance must still reject a kernel that drops the
            # initial state, applies each decay one token late or drops
            # RWKV's bonus
            late = torch.cat([log_w[:, :1], log_w[:, :-1]], dim=1)
            for what, w_c, u_c, s0_c in (
                    ("initial state dropped", log_w, u, None),
                    ("decays one token late", late, u, s0),
                    ("bonus dropped", log_w, torch.zeros_like(u), s0)):
                wrong, _ = ref.ssm_scan_ref(q, k, v, w_c, bonus_u=u_c,
                                            initial_state=s0_c)
                e = scan_err(wrong, want_y)
                print(f"  control: plain with the {what}: err y {e:.3e} "
                      f"(tolerance {SSM_TOL[dt]})")
                if not e > SSM_TOL[dt]:
                    raise SystemExit(f"ssm_scan: the tolerance accepts the "
                                     f"plain version with the {what}")
                del wrong
        if main_shape and dt == torch.bfloat16 and not slow:
            ms = graph_ms(lambda: ssm_mod.ssm_scan(q, k, v, log_w, u, chunk=c),
                          inner=5, reps=4)
            plain_ms = event_ms(lambda: ref.ssm_scan_ref(q, k, v, log_w,
                                                         bonus_u=u))
            cost = ssm_cost(q, v, log_w, u, None)
            b_ms, b_by = bound(*cost, peak_for(dt))
            print(f"  ssm_scan {label:46s} kernel {ms * 1e3:9.2f} us "
                  f"(first design {SSM_FIRST_DESIGN_US} us)  plain "
                  f"{plain_ms * 1e3:9.2f} us (eager)  library n/a  bound "
                  f"{b_ms * 1e3:8.2f} us ({b_by}, {cost[0] / 1e6:.1f} MB, "
                  f"{cost[1] / 1e9:.2f} GFLOP); "
                  f"{info[dt]['smem_bytes']} bytes of shared memory a "
                  f"block, {info[dt]['blocks_per_sm']} blocks per SM",
                  flush=True)
            out = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=b_ms, bound_by=b_by)
        del q, k, v, log_w, y, st, want_y, want_s
    print(f"  ssm_scan bf16 vs its emulation, largest readings: y "
          f"{max(e[0] for e in emu_errs):.3e} beyond its rounding (limit "
          f"{ref.SSM_EMU_TOL}), state {max(e[1] for e in emu_errs):.3e} "
          f"(limit {ref.SSM_EMU_STATE_TOL})")
    out["max_abs_err"] = max(errs)
    return out


def rwkv_golden_phase(dev):
    """Phase 12: the reduced-RWKV JAX run through the port on the card."""
    from repro_torch.configs import get_arch
    from repro_torch.core.bridge import lm_params_from_numpy, lm_params_numpy
    from repro_torch.models import DecoderLM
    from repro_torch.train import make_prefill_step, make_serve_step

    with np.load(RWKV_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    cfg = get_arch(str(gold["arch"])).reduced(
        **{k.split("/")[1]: int(gold[k]) for k in gold
           if k.startswith("reduced/")})
    params = lm_params_from_numpy(lm_params_numpy(cfg, int(gold["seed"])),
                                  cfg, dev)
    toks = torch.tensor(gold["tokens"], device=dev)
    b, n = toks.shape[0], int(gold["serve_len"])

    def err(got, key):
        want = torch.tensor(gold[key], device=dev)
        return float(((got.float() - want).abs() / (1 + want.abs())).max())

    logits, cache = make_prefill_step(cfg)(params, {"tokens": toks})
    errs = {"prefill/logits": err(logits, "prefill/logits")}
    errs.update({f"prefill/{f}": err(getattr(cache["layers"], f),
                                     f"prefill/{f}") for f in STATE_FIELDS})
    for e in (int(x) for x in gold["exits"]):
        step = make_serve_step(cfg, exit_layer=e)
        c = DecoderLM.init_cache(cfg, b, n, device=dev)
        got = []
        for i in range(n):
            lg, c = step(params, c, toks[:, i],
                         torch.full((b,), i, dtype=torch.int64, device=dev))
            got.append(lg)
        errs[f"serve/logits_{e}"] = err(torch.stack(got), f"serve/logits_{e}")
    for k, v in errs.items():
        print(f"  {k:18s} max |d| / (1 + |ref|) {v:.3e}")
    worst = max(errs.values())
    if not worst <= LM_GOLDEN_TOL:
        raise SystemExit(f"RWKV golden: error {worst} above {LM_GOLDEN_TOL}")
    return worst


def rwkv_prefill_phase(dev, cfg, params, gen):
    """Phase 13: one full-width RWKV-6 prefill, its launches counted."""
    from repro_torch.kernels import ops
    from repro_torch.train import make_prefill_step

    prefill = make_prefill_step(cfg)
    toks = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen,
                         device=dev)
    prefill(params, {"tokens": toks[:, :256]})      # warm-up: cuBLAS, attrs
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"B={PREFILL_B} S={PREFILL_S}: {wall * 1e3:.3f} ms, "
          f"{PREFILL_B * PREFILL_S / wall:.1f} prompt tokens/s; launches "
          f"{counts}")
    if counts["ssm_scan"] != cfg.n_layers or any(
            n for k, n in counts.items() if k != "ssm_scan"):
        raise SystemExit(f"prefill launches {counts}: expected ssm_scan "
                         f"{cfg.n_layers} and nothing else")
    h = cfg.d_model // cfg.ssm_head_dim
    st = cache["layers"]
    if (tuple(logits.shape) != (PREFILL_B, cfg.vocab)
            or not bool(torch.isfinite(logits).all())
            or tuple(st.wkv.shape) != (cfg.n_layers, PREFILL_B, h,
                                       cfg.ssm_head_dim, cfg.ssm_head_dim)
            or tuple(st.shift_tm.shape) != (cfg.n_layers, PREFILL_B,
                                            cfg.d_model)
            or not all(bool(torch.isfinite(x).all()) for x in st)):
        raise SystemExit("RWKV prefill output malformed")
    return counts["ssm_scan"]


def rwkv_serve_phase(dev, cfg, params, gen):
    """Phase 14: greedy decoding at every exit, launches counted; then one
    serve_step per exit at B=64 from a prefilled state."""
    from repro_torch.kernels import ops
    from repro_torch.models import DecoderLM
    from repro_torch.train import make_prefill_step, make_serve_step

    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, size=SERVE_B)
    total = int(lens.max()) + SERVE_NEW
    mat = np.zeros((SERVE_B, total), np.int64)
    for i, n in enumerate(lens):
        mat[i, :n] = rng.integers(0, cfg.vocab, size=n)
    prompt_mat = torch.tensor(mat, device=dev)
    print(f"B={SERVE_B} prompts of {sorted(lens.tolist())} tokens, "
          f"max_new {SERVE_NEW}, {total} steps")
    warm = DecoderLM.init_cache(cfg, SERVE_B, total, device=dev)
    greedy_decode(params, make_serve_step(cfg), warm, prompt_mat[:, :3],
                  lens.clip(max=3), 0)
    del warm
    launches = 0
    for e in cfg.exit_layers:
        step = make_serve_step(cfg, exit_layer=e)
        cache = DecoderLM.init_cache(cfg, SERVE_B, total, device=dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs, steps = greedy_decode(params, step, cache, prompt_mat, lens,
                                    SERVE_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        launches += counts["ssm_scan"]
        print(f"  exit {e:2d}: {wall / steps * 1e3:8.3f} ms/step, "
              f"{SERVE_B * SERVE_NEW / wall:9.1f} generated tokens/s, "
              f"launches {counts}", flush=True)
        if any(counts.values()):
            raise SystemExit(f"exit {e}: launches {counts}, expected none "
                             f"(decode runs the plain recurrence step)")
        if any(len(o) != SERVE_NEW or o.min() < 0 or o.max() >= cfg.vocab
               for o in outs):
            raise SystemExit(f"exit {e}: generated tokens malformed")
        if any(bool(x[e:].any()) for x in cache["layers"]):
            raise SystemExit(f"exit {e}: a layer past the exit wrote its state")
        if not all(bool(x[:e].any()) for x in cache["layers"]):
            raise SystemExit(f"exit {e}: a layer up to the exit kept a zero "
                             f"state")
        del cache

    # one serve_step per exit from the state of a 256-token prefill
    toks = torch.randint(0, cfg.vocab, (SSM_LONG_B, SSM_LONG_P),
                         generator=gen, device=dev)
    _, filled = make_prefill_step(cfg)(params, {"tokens": toks})
    pos = torch.full((SSM_LONG_B,), SSM_LONG_P, dtype=torch.int64, device=dev)
    nxt = toks[:, -1]
    for e in cfg.exit_layers:
        step = make_serve_step(cfg, exit_layer=e)
        cache = {"layers": type(filled["layers"])(
            *(x.clone() for x in filled["layers"]))}
        step(params, cache, nxt, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            logits, _ = step(params, cache, nxt, pos)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        if not bool(torch.isfinite(logits).all()):
            raise SystemExit(f"B={SSM_LONG_B} exit {e}: logits not finite")
        print(f"  B={SSM_LONG_B} after a {SSM_LONG_P}-token prefill, exit "
              f"{e:2d}: {ms:8.3f} ms/step, {SSM_LONG_B / ms * 1e3:9.1f} "
              f"tokens/s")
        del cache
    del filled
    torch.cuda.empty_cache()
    return launches


def rwkv_drift(dev, cfg, params, toks):
    """Relative L2 between a prefill of ``toks`` and the same tokens
    teacher-forced through serve_step: last logits and every layer's
    wkv, shift_tm and shift_cm."""
    from repro_torch.models import DecoderLM
    from repro_torch.train import make_prefill_step, make_serve_step

    b, n = toks.shape
    logits_p, cache_p = make_prefill_step(cfg)(params, {"tokens": toks})
    step = make_serve_step(cfg)
    cache_d = DecoderLM.init_cache(cfg, b, n, device=dev)
    for t in range(n):
        logits_d, cache_d = step(params, cache_d, toks[:, t],
                                 torch.full((b,), t, dtype=torch.int64,
                                            device=dev))
    errs = {"logits": rel_l2(logits_d, logits_p)}
    for f in STATE_FIELDS:
        for i in range(cfg.n_layers):
            errs[f"{f}[{i}]"] = rel_l2(getattr(cache_d["layers"], f)[i],
                                       getattr(cache_p["layers"], f)[i])
    return errs


def rwkv_consistency_phase(dev, cfg, params, gen):
    """Phase 15: prefill against teacher-forced decode on the same tokens,
    in bf16 (layer 0 gated), then on the same weights cast to float32
    (every layer gated), then in float32 with slow decays."""
    toks = torch.randint(0, cfg.vocab, (CONSIST_B, CONSIST_P), generator=gen,
                         device=dev)
    errs = rwkv_drift(dev, cfg, params, toks)
    print("bf16, relative L2, decode vs prefill: " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()))
    first = max(errs[f"{f}[0]"] for f in STATE_FIELDS)
    if not first <= CONSIST_TOL:
        raise SystemExit(f"RWKV consistency (bf16): layer 0's state differs "
                         f"by relative L2 {first}, above {CONSIST_TOL}")
    for leaves in _dicts(params):          # in place: the bf16 copy goes
        for k, x in leaves.items():
            if not isinstance(x, dict):
                leaves[k] = x.float()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    worst = 0.0
    for decays in ("init", "slow"):
        if decays == "slow":
            # w0 uniform in [-6, 0], as lm_params_numpy draws it: the
            # init's zero w0 decays the state by ~e^-1 a step, these by
            # down to ~0.9975, so the state that prefill carries from its
            # first chunk into its second matters
            w0 = params["blocks"]["core"]["w0"]
            w0.copy_(-6.0 * torch.rand(w0.shape, generator=gen, device=dev))
        errs = rwkv_drift(dev, cfg32, params, toks)
        print(f"f32, {decays} decays, relative L2, decode vs prefill: "
              + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        worst = max(worst, *errs.values())
        if not worst <= CONSIST_F32_TOL:
            raise SystemExit(f"RWKV consistency (f32, {decays} decays): "
                             f"relative L2 {worst} above {CONSIST_F32_TOL}")
    return worst


def _dicts(tree):
    """Every dict of a nested param tree, the tree itself included."""
    yield tree
    for v in tree.values():
        if isinstance(v, dict):
            yield from _dicts(v)

# ------------------------------------------------------------ actor kernels
def actor_cases(env, params, gen, b):
    """The five actor launches of one slot at B = b fleets, on inputs of
    the main path (a fresh slot's graph; layer 2 on layer 1's plain
    output): (kernel, launch, args, wrapper, plain version, (bytes, flops))."""
    from repro_torch.core import gcn
    from repro_torch.core.graph import build_graph
    from repro_torch.kernels import edge_score as edge_mod
    from repro_torch.kernels import gcn_agg as gcn_mod
    from repro_torch.kernels import ref
    tasks = env.sample_slot(gen, (b,))
    g = build_graph(env.observe(env.reset((b,)), tasks), env.N, env.L)
    adj, adj_t = g.adj, g.adj.transpose(-1, -2)
    split = gcn._split
    fs, fo = g.device_feat.shape[-1], g.option_feat.shape[-1]
    l1d = (adj, g.device_feat, g.option_feat, *split(params["dev1"], fs))
    l1o = (adj_t, g.option_feat, g.device_feat, *split(params["opt1"], fo))
    h_dev, h_opt = ref.gcn_agg_ref(*l1d), ref.gcn_agg_ref(*l1o)
    l2d = (adj, h_dev, h_opt, *split(params["dev2"], h_dev.shape[-1]))
    l2o = (adj_t, h_opt, h_dev, *split(params["opt2"], h_opt.shape[-1]))
    h_dev2, h_opt2 = ref.gcn_agg_ref(*l2d), ref.gcn_agg_ref(*l2o)
    e_args = (h_dev2, h_opt2, adj, params["edge_src"]["w"],
              params["edge_src"]["b"], params["edge_dst"]["w"],
              params["edge_feat"]["w"][0], params["edge_out"]["w"][:, 0],
              params["edge_out"]["b"])
    cases = [("gcn_agg", name, args, gcn_mod.gcn_agg, ref.gcn_agg_ref,
              gcn_agg_cost(*args))
             for name, args in (("layer1/device", l1d),
                                ("layer1/option", l1o),
                                ("layer2/device", l2d),
                                ("layer2/option", l2o))]
    cases.append(("edge_score", "edge", e_args, edge_mod.edge_score,
                  ref.edge_score_ref, edge_score_cost(*e_args)))
    return cases


def actor_info(kernel, args, dev) -> str:
    """The launch's tile (G graphs a block, C columns, K split, weight
    stages), blocks per SM and shared memory per block, from the kernel's
    own layout."""
    from repro_torch.kernels import edge_score as edge_mod
    from repro_torch.kernels import gcn_agg as gcn_mod
    if kernel == "gcn_agg":
        adj, hs, hn, ws = args[:4]
        b, m, o = adj.shape
        i = gcn_mod.kernel_info(b, m, o, hs.shape[-1], hn.shape[-1],
                                ws.shape[-1], dev)
        tile = (f"G={i['graphs']} C={i['cols']:3d} ks={i['k_split']} "
                f"stages={i['stages']}")
    else:
        hs, hd, ef, ws = args[:4]
        b, m, o = ef.shape
        i = edge_mod.kernel_info(b, m, o, *ws.shape, dev)
        tile = f"G={i['graphs']} C={ws.shape[1]:3d} ks=1 stages=1"
    return (f"{tile} blocks/SM {i['blocks_per_sm']} smem "
            f"{i['smem_bytes']:6d} B")


def launch_floor_ms(dev) -> float:
    """Device time of the smallest launch: a one-element in-place add, by
    CUDA-graph replay as the kernels are timed."""
    x = torch.zeros(1, device=dev)
    return graph_ms(lambda: x.add_(1.0))


# --------------------------------------------------------------- training
def tree_of(data: dict, prefix: str) -> dict:
    """The ``{layer: {leaf: array}}`` tree a golden file stores under
    ``prefix/``."""
    tree = {}
    for k in data:
        if k.startswith(prefix + "/"):
            layer, leaf = k[len(prefix) + 1:].split("/")
            tree.setdefault(layer, {})[leaf] = data[k]
    return tree


def close_excess(got, want, rtol, atol) -> float:
    """max(|got - want| - (atol + rtol |want|)): <= 0 when within."""
    return float(((got - want).abs() - (atol + rtol * want.abs())).max())


def grad_phase(dev, env, params, gen):
    """(a) Every input's gradient of each actor kernel, at the training
    minibatch (64 graphs of a fresh slot, full width), against autograd of
    its plain version: the kernel's forward with the hand-written
    backward against PyTorch's own differentiation of ref.*_ref, for one
    random cotangent. Returns the largest error."""
    from repro_torch.kernels import ops
    worst = 0.0
    for kernel, name, args, _, plain, _ in actor_cases(env, params, gen,
                                                       N_FLEETS):
        op = getattr(ops, kernel)
        xs = [a.detach().clone().requires_grad_() for a in args]
        ys = [a.detach().clone().requires_grad_() for a in args]
        if kernel == "gcn_agg" and not args[0].is_contiguous():
            # the option side's transposed adjacency view, as in the path
            xs[0] = args[0].detach().transpose(-1, -2).clone() \
                .requires_grad_().transpose(-1, -2)
        before = ops.launch_counts()[kernel]
        out = op(*xs)
        cot = torch.randn(out.shape, generator=gen, device=dev)
        got = torch.autograd.grad((out * cot).sum(), xs)
        want = torch.autograd.grad((plain(*ys) * cot).sum(), ys)
        torch.cuda.synchronize()
        if ops.launch_counts()[kernel] != before + 1:
            raise SystemExit(f"grad {kernel} {name}: the kernel did not run")
        errs = [(float((g - w).abs().max()),
                 close_excess(g, w, GRAD_RTOL, GRAD_ATOL))
                for g, w in zip(got, want)]
        print(f"  {kernel:10s} {name:14s} B={N_FLEETS} max abs grad error "
              f"per input {[f'{e:.2e}' for e, _ in errs]}", flush=True)
        for i, (e, excess) in enumerate(errs):
            if not excess <= 0:
                raise SystemExit(f"grad {kernel} {name} input {i}: max abs "
                                 f"error {e}, beyond rtol {GRAD_RTOL} atol "
                                 f"{GRAD_ATOL}")
            worst = max(worst, e)
    return worst


def golden_phase(dev, mode):
    """tests/data/torch_port_golden.npz (a JAX run with its draws) through
    the port's driver in ``mode``: every decision matches, or differs only
    at a recorded near-tie; q_est within 1e-5 relative."""
    from repro_torch.core import agent_def, agent_state_from_params
    from repro_torch.mec import MECEnv, SlotTasks, make_scenario
    from repro_torch.rollout import RolloutDriver, SlotDraws
    with np.load(GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    tree = tree_of(gold, "params")
    g_env = MECEnv(make_scenario(str(gold["scenario"])), device=dev)
    g_def = agent_def("grle", g_env, device=dev)
    st = agent_state_from_params(g_def, tree, gold["exit_mask"])
    t_gold, b_gold = gold["rand_cands"].shape[:2]
    draws = SlotDraws(
        SlotTasks(*(torch.tensor(gold[f"tasks/{f}"], device=dev)
                    for f in TASK_FIELDS)),
        torch.tensor(gold["rand_cands"].astype(np.int64), device=dev))
    _, trace = RolloutDriver(g_def, b_gold, train=False, device=dev).run(
        SEED, t_gold, mode=mode, agent_state=st, draws=draws)
    dec = trace.decisions.cpu().numpy()
    same = (dec == gold["trace/decisions"]).all(-1)
    dq = np.abs(trace.q_est.cpu().numpy() - gold["trace/q_est"])
    print(f"mode={mode}: decisions matching: {int(same.sum())}/{same.size} "
          f"slot-fleets; max |dq| {float(dq.max()):.3e}; "
          f"max |dreward| {float(np.abs(trace.reward.cpu().numpy() - gold['trace/reward']).max()):.3e}")
    for t, b in np.argwhere(~same):
        margin = min(gold["q_margin"][t, b], gold["xhat_margin"][t, b])
        print(f"  slot {t} fleet {b}: q margin {gold['q_margin'][t, b]:.3e}, "
              f"x_hat margin {gold['xhat_margin'][t, b]:.3e}")
        if margin > NEAR_TIE:
            raise SystemExit(f"golden ({mode}): decision differs at slot {t} "
                             f"fleet {b}, not at a near-tie")
    if not (dq[same] <= 1e-5 * np.abs(gold["trace/q_est"][same])).all():
        raise SystemExit(f"golden ({mode}): q_est differs by more than 1e-5 "
                         f"relative")


def train_golden_phase(dev, mode="loop"):
    """(b) tests/data/torch_port_train_golden.npz (a JAX train=True run
    with its draws and minibatch rows) through the port's driver in
    ``mode``. Returns the run's (carry, trace)."""
    from repro_torch.core import agent_def, agent_state_from_params
    from repro_torch.mec import MECEnv, SlotTasks, make_scenario
    from repro_torch.rollout import RolloutDriver, SlotDraws
    with np.load(TRAIN_GOLDEN) as z:
        gold = {k: z[k] for k in z.files}
    env = MECEnv(make_scenario(str(gold["scenario"])), device=dev)
    t_gold, b_gold = gold["rand_cands"].shape[:2]
    drv = RolloutDriver(agent_def("grle", env, device=dev), b_gold,
                        train=True, device=dev)
    st = agent_state_from_params(drv.adef, tree_of(gold, "init_params"),
                                 gold["exit_mask"])
    draws = SlotDraws(
        SlotTasks(*(torch.tensor(gold[f"tasks/{f}"], device=dev)
                    for f in TASK_FIELDS)),
        torch.tensor(gold["rand_cands"].astype(np.int64), device=dev),
        torch.tensor(gold["replay_take"], device=dev))
    carry, trace = drv.run(SEED, t_gold, mode=mode, agent_state=st,
                           draws=draws)
    dec = trace.decisions.cpu().numpy()
    same = (dec == gold["trace/decisions"]).all(-1)
    first_train = int(gold["train_slots"][0]) - 1       # slot index
    flipped = np.flatnonzero(~same.all(-1))
    stop = int(flipped[0]) if flipped.size else t_gold
    for t, b in np.argwhere(~same[:stop + 1]):
        margin = min(gold["q_margin"][t, b], gold["xhat_margin"][t, b])
        print(f"  slot {t} fleet {b}: q margin {gold['q_margin'][t, b]:.3e},"
              f" x_hat margin {gold['xhat_margin'][t, b]:.3e}")
        if margin > NEAR_TIE:
            raise SystemExit(f"train golden: decision differs at slot {t} "
                             f"fleet {b}, not at a near-tie")
    if stop <= first_train:
        raise SystemExit(f"train golden: a decision flipped at slot {stop}, "
                         f"before the first train step (slot index "
                         f"{first_train})")
    print(f"mode={mode}: decisions matching: {int(same[:stop].sum())}/"
          f"{same[:stop].size} slot-fleets before slot {stop}" + (
              "" if stop == t_gold else
              f"; a near-tie flip at slot {stop}: the comparison stops"))
    loss, want = trace.loss.cpu().numpy()[:stop], gold["trace/loss"][:stop]
    if not (np.isnan(loss) == np.isnan(want)).all():
        raise SystemExit("train golden: train steps at other slots")
    ok = ~np.isnan(want)
    rel = np.abs(loss[ok] / want[ok] - 1)
    print(f"train steps compared: {int(ok.sum())}, losses "
          f"{np.round(loss[ok], 6).tolist()}, max relative error "
          f"{float(rel.max()):.3e}")
    if not (rel <= TRAIN_LOSS_RTOL).all():
        raise SystemExit(f"train golden: loss beyond {TRAIN_LOSS_RTOL}")
    if stop < t_gold:
        print("final params and moments not compared (the run left the "
              "golden one at the flip)")
        return carry, trace
    fin = carry.agent_state
    for name, got, tol in (("params", fin.params, TRAIN_PARAM_TOL),
                           ("mu", fin.opt_state["mu"], TRAIN_PARAM_TOL),
                           ("nu", fin.opt_state["nu"], TRAIN_NU_TOL)):
        want_t = tree_of(gold, f"final/{name}")
        pairs = [(got[layer][leaf].cpu(), torch.tensor(want_t[layer][leaf]))
                 for layer in want_t for leaf in want_t[layer]]
        err = max(float((g - w).abs().max()) for g, w in pairs)
        rel = max(float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())
                  for g, w in pairs)
        excess = max(close_excess(g, w, *tol) for g, w in pairs)
        print(f"final {name}: max abs error {err:.3e}, max relative "
              f"{rel:.3e} (tolerance rtol {tol[0]} atol {tol[1]})")
        if not excess <= 0:
            raise SystemExit(f"train golden: final {name} beyond rtol "
                             f"{tol[0]} atol {tol[1]}")
    if int(fin.opt_state["step"]) != int(gold["final/opt_step"]):
        raise SystemExit("train golden: Adam step count differs")
    return carry, trace


def cuda_launches(fn) -> int:
    """CUDA kernels (and copies) one ``fn()`` runs, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILER_TAIL_S)
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.events() if e.device_type == cuda)


def train_step_parts(adef, state, gen, reps=20):
    """(c) One train step split as AgentDef.train_step runs it: forward
    (minibatch draw and the Eq-16 loss through the kernels), backward
    (autograd through the hand-written rules) and Adam; ms of each by
    CUDA events (mean of ``reps``) and CUDA launches of each."""
    from repro_torch.core.devreplay import replay_sample
    from repro_torch.nn.pytree import flatten_dict, unflatten_dict
    from repro_torch.optim import apply_updates
    box = {}

    def fwd():
        graphs, dec = replay_sample(state.replay, adef.batch_size,
                                    generator=gen)
        flat = flatten_dict(state.params)
        box["paths"] = list(flat)
        box["leaves"] = [p.detach().requires_grad_() for p in flat.values()]
        box["loss"] = adef.loss(unflatten_dict(dict(zip(flat,
                                                        box["leaves"]))),
                                graphs, dec, state.exit_mask)

    def bwd():
        box["grads"] = torch.autograd.grad(box["loss"], box["leaves"])

    def opt():
        grads = unflatten_dict(dict(zip(box["paths"], box["grads"])))
        updates, _ = adef.opt.update(grads, state.opt_state)
        apply_updates(state.params, updates)

    parts = (("forward", fwd), ("backward", bwd), ("adam", opt))
    for _ in range(3):
        for _, fn in parts:
            fn()
    torch.cuda.synchronize()
    ms = {k: 0.0 for k, _ in parts}
    for _ in range(reps):
        for name, fn in parts:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            ms[name] += start.elapsed_time(end) / reps
    launches = {name: cuda_launches(fn) for name, fn in parts}
    whole = event_ms(lambda: adef.train_step(state, generator=gen),
                     reps=reps)
    t0 = time.perf_counter()
    for _ in range(reps):
        adef.train_step(state, generator=gen)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    return ms, launches, whole, wall, cuda_launches(
        lambda: adef.train_step(state, generator=gen))


def episode_s(drv, seed=SEED, mode="loop", n_slots=N_SLOTS):
    """Wall seconds of one ``n_slots`` episode in ``mode``, ending in a
    synchronize, and its (carry, trace)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = drv.run(seed, n_slots, mode=mode)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def train_path_phase(dev, adef):
    """(c) The training path at full width on the port's own generator:
    B=64 fleets, T=200 slots, replay 128, minibatch 64, a train step every
    10 slots: 20 steps; slot ms beside the decision path's, episodes in
    the order decision, training, training, decision (host time drifts
    within a call). Returns the launch counts of the first training
    episode."""
    from repro_torch.kernels import ops
    from repro_torch.rollout import RolloutDriver
    drv = RolloutDriver(adef, N_FLEETS, train=True, device=dev)
    plain = RolloutDriver(adef, N_FLEETS, train=False, device=dev)
    drv.run(SEED + 1, 20, mode="loop")      # warm-up: a train step too
    walls = {"decision": [episode_s(plain)[0]]}
    ops.reset_launch_counts()
    wall, (carry, trace) = episode_s(drv)
    counts = ops.launch_counts()
    walls["training"] = [wall, episode_s(drv)[0]]
    walls["decision"].append(episode_s(plain)[0])
    loss = trace.loss.cpu().numpy()
    m = drv.metrics(carry)
    trained = np.flatnonzero(~np.isnan(loss)) + 1
    n_train = N_SLOTS // adef.train_every
    print(f"B={N_FLEETS} T={N_SLOTS} replay {drv.replay_capacity} "
          f"minibatch {drv.batch_size} every {drv.train_every} slots")
    print(f"train steps {len(trained)} at slots {trained.tolist()}")
    print(f"losses {np.round(loss[trained - 1], 6).tolist()}")
    print(f"ssp {m['ssp']:.6f}  avg_accuracy {m['avg_accuracy']:.6f}  "
          f"final_loss {m['final_loss']:.6f}  train_steps "
          f"{int(m['train_steps'])}")
    slot_ms = {k: [w / N_SLOTS * 1e3 for w in v] for k, v in walls.items()}
    mean = {k: sum(v) / len(v) for k, v in slot_ms.items()}
    print(f"slot ms, episodes in the order decision, training, training, "
          f"decision: {slot_ms['decision'][0]:.3f}, "
          f"{slot_ms['training'][0]:.3f}, {slot_ms['training'][1]:.3f}, "
          f"{slot_ms['decision'][1]:.3f}; with training {mean['training']:.3f}"
          f" ms, without {mean['decision']:.3f} ms: "
          f"{mean['training'] - mean['decision']:+.3f} ms a slot")
    print(f"launches {counts}")
    want = {"gcn_agg": 4 * (N_SLOTS + n_train),
            "edge_score": N_SLOTS + n_train, "flash_attention": 0,
            "decode_attention": 0, "ssm_scan": 0}
    if (trained.tolist() != list(range(adef.train_every, N_SLOTS + 1,
                                       adef.train_every))
            or not np.isfinite(loss[trained - 1]).all()
            or int(m["train_steps"]) != n_train
            or not np.isfinite(m["final_loss"])):
        raise SystemExit(f"training path: expected {n_train} finite train "
                         f"steps, got {len(trained)}")
    if counts != want:
        raise SystemExit(f"training path: launch counts {counts}, "
                         f"expected {want}")
    ms, launches, whole, wall_ms, whole_launches = train_step_parts(
        drv.adef, carry.agent_state, torch.Generator(device=dev)
        .manual_seed(SEED))
    for name in ms:
        print(f"train step {name:8s}: {ms[name]:.3f} ms (CUDA events), "
              f"{launches[name]} CUDA launches")
    print(f"train step whole: {whole:.3f} ms (CUDA events), {wall_ms:.3f} ms "
          f"host wall, {whole_launches} CUDA launches; per slot over "
          f"{adef.train_every} slots: {whole / adef.train_every:.3f} ms")
    return counts


# ------------------------------------------------- the compiled episode
SPANS = ("sample", "actor", "env_step", "train")


def profiled_episode(drv, mode, n_slots=N_SLOTS, seed=SEED):
    """One episode under torch.profiler, whose window stays open
    ``PROFILER_TAIL_S`` after it: (carry, trace), the device records of
    the two actor kernels, the same per cudaGraphLaunch in launch order
    ([gcn_agg, edge_score] a launch, by the launch's correlation id), CUDA
    kernels (and copies) in all, cudaGraphLaunch calls, and the busy share
    (device time over the wall time of the episode, which ends in a
    synchronize)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = drv.run(seed, n_slots, mode=mode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        time.sleep(PROFILER_TAIL_S)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    launches = sorted((e.time_range.start, e.id) for e in events
                      if e.name == "cudaGraphLaunch")
    slot_of = {corr: i for i, (_, corr) in enumerate(launches)}
    per_launch = [[0, 0] for _ in launches]
    ours = {"gcn_agg": 0, "edge_score": 0}
    busy_us, kernels = 0.0, 0
    for e in events:
        if e.device_type != cuda or e.name in SPANS:
            continue
        kernels += 1
        busy_us += e.time_range.elapsed_us()
        for j, k in enumerate(ours):
            if f"{k}_kernel" in e.name:
                ours[k] += 1
                if e.id in slot_of:
                    per_launch[slot_of[e.id]][j] += 1
    return (out, ours, per_launch, kernels, len(launches),
            busy_us / (wall * 1e6))


def same_run(a, b) -> bool:
    """Two (carry, trace) pairs equal bit for bit (NaN equal to NaN)."""
    from repro_torch.rollout.driver import _tensors
    xs, ys = _tensors(a), _tensors(b)
    return len(xs) == len(ys) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and bool(((x == y) | (x != x) & (y != y)).all())
        for x, y in zip(xs, ys))


def max_diff(xs, ys) -> float:
    return max((float((x.float() - y.float()).abs().nan_to_num().max())
                for x, y in zip(xs, ys) if x.numel()), default=0.0)


def interleaved(drv, n_slots=N_SLOTS):
    """Slot ms of episodes in the order loop, scan, scan, loop on one seed
    (host time drifts within a call); the first of each mode's runs."""
    drv.run(SEED + 1, 3, mode="loop")                  # warm-up
    drv.run(SEED, n_slots, mode="scan")                # capture
    ms, runs = {"loop": [], "scan": []}, {}
    for mode in ("loop", "scan", "scan", "loop"):
        wall, out = episode_s(drv, mode=mode, n_slots=n_slots)
        ms[mode].append(wall / n_slots * 1e3)
        runs.setdefault(mode, out)
    return ms, runs


def compiled_episode_phase(dev, adef):
    """19. RolloutDriver.run(mode="scan"): the golden runs, the full-width
    episodes against the loop, launch and graph counts from the profiler,
    B=1024, and the telemetry registry. Returns {B=64 train: slot ms}."""
    from repro_torch.kernels import ops
    from repro_torch.nn.pytree import flatten_dict
    from repro_torch.rollout import RolloutDriver
    print("(1) decision golden, scan")
    golden_phase(dev, "scan")

    print("(2) training golden, scan, and the loop on the same draws")
    s_carry, s_trace = train_golden_phase(dev, "scan")
    l_carry, l_trace = train_golden_phase(dev, "loop")
    if not (torch.equal(s_trace.decisions, l_trace.decisions)
            and torch.equal(s_trace.reward, l_trace.reward)):
        raise SystemExit("train golden: scan and loop differ in decisions or "
                         "rewards")
    ok = ~torch.isnan(l_trace.loss)
    p_s = list(flatten_dict(s_carry.params).values())
    p_l = list(flatten_dict(l_carry.params).values())
    print(f"scan vs loop: decisions and rewards bitwise equal; max |dloss| "
          f"{max_diff([s_trace.loss[ok]], [l_trace.loss[ok]]):.3e}, max "
          f"|dparam| {max_diff(p_s, p_l):.3e}")

    print(f"(3) full width, own generator: B={N_FLEETS} T={N_SLOTS} "
          f"fig5_baseline")
    slot = {}
    for train in (False, True):
        drv = RolloutDriver(adef, N_FLEETS, train=train, device=dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        drv.run(SEED, N_SLOTS, mode="scan")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        captured = ops.launch_counts()
        ms, runs = interleaved(drv)
        ops.reset_launch_counts()
        (carry, trace), ours, per_launch, kernels, graphs, busy = (
            profiled_episode(drv, "scan"))
        replayed = ops.launch_counts()
        n_train = N_SLOTS // adef.train_every if train else 0
        want = {"gcn_agg": 4 * (N_SLOTS + n_train),
                "edge_score": N_SLOTS + n_train}
        due = [train and (t + 1) % adef.train_every == 0
               for t in range(N_SLOTS)]
        off = {t: got for t, got in enumerate(per_launch)
               if got != ([8, 2] if due[t] else [4, 1])}
        equal = same_run(runs["loop"], runs["scan"])
        slot[train] = ms
        print(f"train={train}: slot ms, episodes loop, scan, scan, loop: "
              f"{ms['loop'][0]:.3f}, {ms['scan'][0]:.3f}, {ms['scan'][1]:.3f},"
              f" {ms['loop'][1]:.3f}; first scan episode (warm-up and capture"
              f" included) {first_s:.3f} s, wrapper calls in it {captured}")
        print(f"  profiled scan episode: actor kernels on the device {ours} "
              f"(expected {want}), {kernels / N_SLOTS:.2f} CUDA kernels and "
              f"{graphs / N_SLOTS:.2f} cudaGraphLaunch a slot, busy share "
              f"{busy:.1%}; wrapper calls {replayed}")
        print(f"  scan equals loop bit for bit on one seed: {equal}")
        if not equal:
            for mode, (c, _) in runs.items():
                m = drv.metrics(c)
                print(f"  {mode}: ssp {m['ssp']:.6f} avg_accuracy "
                      f"{m['avg_accuracy']:.6f}")
        if ours != want or off:
            raise SystemExit(f"scan train={train}: actor kernels on the "
                             f"device {ours}, expected {want}; graph "
                             f"launches whose [gcn_agg, edge_score] differ "
                             f"from their slot's [4, 1] or, training, "
                             f"[8, 2]: {dict(list(off.items())[:12])} "
                             f"({len(off)} of {len(per_launch)})")
        if captured["gcn_agg"] == 0 or captured["edge_score"] == 0:
            raise SystemExit(f"scan train={train}: the capture called no "
                             f"actor kernel ({captured})")
        if graphs != N_SLOTS:
            raise SystemExit(f"scan train={train}: {graphs} graph launches "
                             f"for {N_SLOTS} slots")
        m = drv.metrics(carry)
        if (not torch.isfinite(trace.reward).all()
                or int(m["train_steps"]) != n_train
                or not 0.0 < m["ssp"] <= 1.0):
            raise SystemExit(f"scan train={train}: output malformed")

    big, big_t = 1024, 50
    print(f"(4) large batch: B={big} T={big_t}, train=False")
    drv = RolloutDriver(adef, big, train=False, device=dev)
    ms, runs = interleaved(drv, big_t)
    print(f"slot ms, episodes loop, scan, scan, loop: {ms['loop'][0]:.3f}, "
          f"{ms['scan'][0]:.3f}, {ms['scan'][1]:.3f}, {ms['loop'][1]:.3f}; "
          f"scan equals loop bit for bit: "
          f"{same_run(runs['loop'], runs['scan'])}")
    del drv, runs

    print(f"(5) telemetry: B={N_FLEETS} T={N_SLOTS}, train=True")
    tel = RolloutDriver(adef, N_FLEETS, train=True, telemetry=True,
                        device=dev)
    off = RolloutDriver(adef, N_FLEETS, train=True, device=dev)
    c_loop, _ = tel.run(SEED, N_SLOTS, mode="loop")
    c_scan, t_scan = tel.run(SEED, N_SLOTS, mode="scan")
    c_off, t_off = off.run(SEED, N_SLOTS, mode="scan")
    a, b = c_scan.telemetry, c_loop.telemetry
    for name in a.counters:
        if not torch.equal(a.counters[name], b.counters[name]):
            raise SystemExit(f"telemetry: counter {name} differs, scan "
                             f"{float(a.counters[name])} loop "
                             f"{float(b.counters[name])}")
    for name in a.hists:
        if not torch.equal(a.hists[name].counts, b.hists[name].counts):
            raise SystemExit(f"telemetry: histogram {name} differs")
    ema_rel = abs(float(a.loss_ema) / float(b.loss_ema) - 1)
    if not ema_rel <= 1e-5:
        raise SystemExit(f"telemetry: loss_ema differs by {ema_rel:.3e}")
    c = {k: float(v) for k, v in a.counters.items()}
    active = t_scan.active > 0.5
    checks = {
        "slots": c["slots"] == N_SLOTS,
        "tasks": c["tasks"] == float(active.sum()),
        "success": c["success"] == float((t_scan.success & active).sum()),
        "train_steps": c["train_steps"]
        == float((~torch.isnan(t_scan.loss)).sum()),
        "reward": abs(c["reward"] / float(t_scan.reward.double().sum())
                      - 1) <= 1e-5,
        "hists": all(float(a.hists[n].counts.sum()) == c["tasks"]
                     for n in ("exit", "server", "latency"))}
    on_off = (torch.equal(t_scan.decisions, t_off.decisions)
              and torch.equal(t_scan.reward, t_off.reward)
              and all(torch.equal(x, y) for x, y in zip(
                  flatten_dict(c_scan.params).values(),
                  flatten_dict(c_off.params).values())))
    print(f"scan vs loop: counters and histogram counts bitwise equal, "
          f"loss_ema relative difference {ema_rel:.3e}; counters vs trace "
          f"{checks}; telemetry on vs off: same decisions, rewards and "
          f"params {on_off}")
    print(f"counters {c}")
    walls = {"on": [], "off": []}
    for name in ("on", "off", "off", "on"):
        wall, _ = episode_s(tel if name == "on" else off, mode="scan")
        walls[name].append(wall / N_SLOTS * 1e3)
    print(f"scan slot ms with telemetry on, off, off, on: {walls['on'][0]:.3f}"
          f", {walls['off'][0]:.3f}, {walls['off'][1]:.3f}, "
          f"{walls['on'][1]:.3f}")
    if not all(checks.values()) or not on_off:
        raise SystemExit("telemetry: counters disagree with the trace, or "
                         "the registry perturbed the run")
    return slot


# ------------------------------------------------------------------ phases
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2

    from repro_torch.core import agent_def, agent_state_from_params
    from repro_torch.kernels import _build, ops
    from repro_torch.mec import MECEnv, SlotTasks, make_scenario
    from repro_torch.rollout import RolloutDriver, SlotDraws

    dev = torch.device("cuda")

    phase(1, "card")
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phase(2, "build")
    t0 = time.perf_counter()
    report = _build.build_all()
    print(f"built {sorted(report)} in {time.perf_counter() - t0:.2f} s "
          f"(already present: {sorted(set(_build.KERNELS) - set(report))})")
    for name in _build.KERNELS:
        log = _build.build_log(name)
        for fn, regs, spills, smem in ptxas_report(log):
            print(f"  {name}: {fn}: {regs} registers, spill stores/loads "
                  f"{spills}, {smem} bytes smem")
        serialized = sorted({w for w in WGMMA_SERIALIZED if w in log})
        if serialized:
            raise SystemExit(f"{name}: ptxas serialized its wgmma (warnings "
                             f"{serialized}); keep every wgmma and its wait "
                             f"out of branches")
    print(f"no wgmma serialized (ptxas warnings {WGMMA_SERIALIZED})")

    phase(3, "kernels vs plain versions on the card")
    env = MECEnv(make_scenario("fig5_baseline"), device=dev)
    adef = agent_def("grle", env, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = adef.init(gen).params
    floor_ms = launch_floor_ms(dev)
    print(f"launch floor: {floor_ms * 1e3:.2f} us (graph replay of a "
          f"one-element in-place add)")
    stats = {"gcn_agg": {}, "edge_score": {}}
    for b in ACTOR_BATCHES:
        first = {"gcn_agg": 0.0, "edge_score": 0.0}
        for kernel, name, args, fn, plain, cost in actor_cases(
                env, params, gen, b):
            got = fn(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ms = graph_ms(lambda: fn(*args))
            plain_ms = graph_ms(lambda: plain(*args))
            call_ms = eager_ms(lambda: fn(*args))
            b_ms, b_by = bound(*cost)
            info = actor_info(kernel, args, dev)
            first_us = FIRST_DESIGN_US[kernel][name][b]
            first[kernel] += first_us
            print(f"  {kernel:10s} {name:14s} B={b:4d} {info}  max_abs_err "
                  f"{err:.3e}  kernel {ms * 1e3:8.2f} us (first design "
                  f"{first_us:.2f})  plain {plain_ms * 1e3:8.2f} us  eager "
                  f"call {call_ms * 1e3:8.2f} us  bound {b_ms * 1e3:6.3f} us "
                  f"({b_by})", flush=True)
            if not err <= TOL:
                raise SystemExit(f"{kernel} {name} B={b}: max abs error "
                                 f"{err} above {TOL}")
            s = stats[kernel].setdefault(b, dict(err=0.0, ms=0.0, plain=0.0,
                                                 bytes=0, flops=0))
            s["err"] = max(s["err"], err)
            s["ms"] += ms
            s["plain"] += plain_ms
            s["bytes"] += cost[0]
            s["flops"] += cost[1]
        for kernel, s in stats.items():
            print(f"  {kernel:10s} per slot B={b:4d}: kernel "
                  f"{s[b]['ms'] * 1e3:8.2f} us (first design "
                  f"{first[kernel]:.2f}), plain {s[b]['plain'] * 1e3:8.2f} us, "
                  f"bound {bound(s[b]['bytes'], s[b]['flops'])[0] * 1e3:.3f} us",
                  flush=True)

    phase(4, "golden replay of a JAX run")
    golden_phase(dev, "loop")

    phase(5, "main path: GRLE fig5_baseline, full width")
    drv = RolloutDriver(adef, N_FLEETS, train=False, device=dev)
    drv.run(SEED + 1, 5, mode="loop")           # warm-up: allocator, cuBLAS
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    carry, trace = drv.run(SEED, N_SLOTS, mode="loop")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    m = drv.metrics(carry)
    print(f"M={env.M} N={env.N} L={env.L} hidden={adef.hidden} "
          f"candidates={adef.n_candidates}+{adef.n_random} B={N_FLEETS} "
          f"T={N_SLOTS}")
    print(f"ssp {m['ssp']:.6f}  avg_accuracy {m['avg_accuracy']:.6f}  "
          f"avg_reward {m['avg_reward']:.6f}  tasks {int(m['tasks'])}")
    print(f"wall {wall:.4f} s  fleet-slots/s {N_FLEETS * N_SLOTS / wall:.1f}  "
          f"slot {wall / N_SLOTS * 1e3:.3f} ms")
    print(f"launches {counts}")
    if counts != {"gcn_agg": 4 * N_SLOTS, "edge_score": N_SLOTS,
                  "flash_attention": 0, "decode_attention": 0,
                  "ssm_scan": 0}:
        raise SystemExit(f"launch counts {counts}, expected gcn_agg "
                         f"{4 * N_SLOTS} and edge_score {N_SLOTS}")
    dec = trace.decisions
    if (tuple(dec.shape) != (N_SLOTS, N_FLEETS, env.M)
            or dec.dtype != torch.int32 or int(dec.min()) < 0
            or int(dec.max()) >= env.N * env.L
            or not bool(torch.isfinite(trace.reward).all())
            or not 0.0 < m["ssp"] <= 1.0
            or not 0.0 < m["avg_accuracy"] <= float(env.exit_acc.max())):
        raise SystemExit("main path output malformed")

    phase(6, "attention kernels vs plain versions on the card")
    attn = attention_phase(dev)

    phase(7, "LM golden replay of a JAX run (reduced Llama, f32)")
    lm_golden_phase(dev)

    phase(8, "LM prefill: llama3_2_1b, full width, bf16")
    cfg, params, lm_gen = lm_model(dev)
    flash_launches = prefill_phase(dev, cfg, params, lm_gen)

    phase(9, "LM serve: greedy early-exit decoding, full width, bf16")
    decode_launches = serve_phase(dev, cfg, params, lm_gen)

    phase(10, "LM consistency: prefill vs teacher-forced decode")
    consistency_phase(dev, cfg, params, lm_gen)
    del params
    torch.cuda.empty_cache()

    phase(11, "ssm_scan vs its plain version on the card")
    ssm = ssm_scan_phase(dev)

    phase(12, "RWKV golden replay of a JAX run (reduced RWKV-6, f32)")
    rwkv_golden_phase(dev)

    phase(13, "RWKV prefill: rwkv6_7b, full width, bf16")
    cfg, params, lm_gen = lm_model(dev, SSM_ARCH)
    ssm_launches = rwkv_prefill_phase(dev, cfg, params, lm_gen)

    phase(14, "RWKV serve: greedy early-exit decoding, full width, bf16")
    rwkv_serve_phase(dev, cfg, params, lm_gen)

    phase(15, "RWKV consistency: prefill vs teacher-forced decode")
    rwkv_consistency_phase(dev, cfg, params, lm_gen)

    phase(16, "training: actor kernels' gradients vs autograd of their "
              "plain versions")
    grad_err = grad_phase(dev, env, adef.init(gen).params, gen)

    phase(17, "training: golden replay of a JAX train=True run")
    train_golden_phase(dev)

    phase(18, "training path: GRLE fig5_baseline, full width, train=True")
    counts = train_path_phase(dev, adef)

    phase(19, "the compiled episode: RolloutDriver.run(mode=\"scan\")")
    compiled_episode_phase(dev, adef)

    phase(20, "summary")
    sources = {"gcn_agg": ("src/repro_torch/csrc/gcn_agg.cu",
                           "src/repro/kernels/gcn_agg.py:40"),
               "edge_score": ("src/repro_torch/csrc/edge_score.cu",
                              "src/repro/kernels/edge_score.py:45")}
    kernels = []
    for name, (source, replaces) in sources.items():
        s = stats[name][N_FLEETS]
        b_ms, b_by = bound(s["bytes"], s["flops"])
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": max(grad_err, *(v["err"]
                                           for v in stats[name].values())),
            "ms": s["ms"], "plain_ms": s["plain"], "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None})
    launches = {"flash_attention": flash_launches,
                "decode_attention": decode_launches}
    for name, replaces in (
            ("flash_attention", "src/repro/kernels/flash_attention.py:70"),
            ("decode_attention", "src/repro/kernels/decode_attention.py:56")):
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name],
            **attn[name]})
    kernels.append({
        "name": "ssm_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan.py:93",
        "launches": ssm_launches, **ssm})
    print("gcn_agg, edge_score: times per slot at B=64, the sum over one "
          "actor forward's launches (4 and 1), launches of the training "
          "path (phase 18: 200 slots' and 20 train steps' forwards), error "
          "the larger of the forward's and the gradients'; "
          "flash_attention: one call at "
          f"[{PREFILL_B}, {PREFILL_S}, 32, 8, 64] bf16, launches of one "
          f"prefill; decode_attention: one call at [{LONG_B}, 32, 8, 64, "
          f"S={LONG_S}] bf16, every row read, launches of the serve phase's "
          f"four exits; ssm_scan: one call at {list(SSM_PREFILL[:5])} chunk "
          f"{SSM_PREFILL[5]} bf16, plain timed eagerly, launches of one RWKV "
          "prefill (its decode launches none)")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
