"""Eq-12 message passing: wrapper of the CUDA kernel ``csrc/gcn_agg.cu``.

Counterpart of ``repro/kernels/gcn_agg.py``. A CUDA tensor launches the
hand-written kernel or raises; a CPU tensor runs the plain version
``ref.gcn_agg_ref``. ``launches`` counts kernel launches and nothing else.

The kernel computes the output, viewed as [B*M, H], in tiles of ``rows``
rows by ``cols`` columns, one tile per block. ``tiling`` chooses the tile,
``k_split`` how many thread slices share a tile's K-tiles and ``stages``
how many weight K-tiles are in flight; ``plan`` combines them. All are
pure functions of the shapes and the card's SM count, so that they can be
tested without a card. ``smem_bytes`` is the kernel's shared memory (the
same layout as ``csrc/gcn_agg.cu::Layout``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref

launches = 0

TM = TN = 4         # the kernel's micro-tile: rows x columns per thread
KT = 32             # weight rows per K-tile
PAD = 4             # floats added to a shared-memory row
MAX_ROWS = 64       # output rows per block
MAX_COLS = 128      # output columns per block
MAX_THREADS = 512
MAX_SPLIT = 8
MAX_STAGES = 8
SPLIT_THREADS = 256     # k_split stops at this many threads a block
# dynamic shared memory a block may opt in to on an H100; the most that
# lets two blocks share an SM (228 KB an SM, 1 KB of it reserved a block)
SMEM_LIMIT = 227 * 1024
SMEM_TWO_PER_SM = 228 * 1024 // 2 - 1024
_fn = None


class Tiling(NamedTuple):
    graphs: int     # G: whole graphs per block (1 when a graph is cut)
    rows: int       # output rows per block: G * M, or MAX_ROWS of a graph
    cols: int       # C: output columns per block, a multiple of 4
    grid: tuple     # (row blocks, column blocks)


class Plan(NamedTuple):
    tiling: Tiling
    k_split: int    # thread slices sharing a tile's K-tiles
    stages: int     # weight K-tiles in flight


def _kernel():
    global _fn
    if _fn is None:
        _fn = _build.bind("gcn_agg", "gcn_agg_f32", n_ptr=7, n_int=13)
    return _fn


def _up(x: int, n: int) -> int:
    return -(-x // n) * n


def graphs_per_block(b: int, m: int, sm_count: int,
                     max_graphs: int | None = None) -> int:
    """Graphs of ``m`` rows one block takes: 1 while the B graphs are no
    more than the SMs; else enough that the blocks are about two per SM,
    at most ``max_graphs`` (default: as many as fit MAX_ROWS rows)."""
    cap = max(1, MAX_ROWS // m) if max_graphs is None else max_graphs
    if b <= sm_count:
        return 1
    return max(1, min(cap, -(-b // (2 * sm_count))))


def tiling(b: int, m: int, h: int, sm_count: int,
           max_graphs: int | None = None,
           max_cols: int = MAX_COLS) -> Tiling:
    """The output tile of one block for B graphs of M rows and H columns
    on a card of ``sm_count`` SMs: whole rows of H (up to ``max_cols``
    columns), so that a weight K-tile is one contiguous bulk copy and each
    graph's agg is formed once; one graph a block while B <= sm_count,
    packed graphs beyond (``graphs_per_block``). A graph of more than
    MAX_ROWS rows is cut into tiles of MAX_ROWS. (Splitting the columns at
    small B to fill more SMs measured slower on the H100: every column
    block repeats the operands' trip and agg; PERF.md.)"""
    g = graphs_per_block(b, m, sm_count, max_graphs) if m <= MAX_ROWS else 1
    rows = g * m if m <= MAX_ROWS else MAX_ROWS
    cols = min(_up(h, TN), max_cols)
    return Tiling(g, rows, cols, (-(-b * m // rows), -(-h // cols)))


def k_split(rows: int, cols: int, k: int) -> int:
    """Thread slices that share a tile's K-tiles: 1, or, when the tile has
    few micro-tiles and K is at least two K-tiles, the most (up to
    MAX_SPLIT) that keep the block within SPLIT_THREADS threads."""
    per_slice = _up(rows, TM) // TM * (cols // TN)
    ks = 1
    if k >= 2 * KT:
        while ks < MAX_SPLIT and per_slice * ks * 2 <= SPLIT_THREADS:
            ks *= 2
    return ks


def threads(rows: int, cols: int, ks: int) -> int:
    return ks * _up(rows, TM) // TM * (cols // TN)


def tile_rows(k: int, ks: int) -> int:
    """Weight rows per K-tile of the kernel instance for width K: K = 11
    (the actor's layer 1) is one tile of 12 rows, every other width tiles
    of KT."""
    return 12 if k == 11 and ks == 1 else KT


def smem_bytes(m: int, o: int, fs: int, fn: int, rows: int, cols: int,
               ks: int, stages: int) -> int:
    """Dynamic shared memory of one block, in bytes: the barriers, A =
    [hs | agg], ``stages`` weight K-tiles, the graphs' hn and the adjacency
    rows, or the slices' partial tiles if those take more."""
    k = fs + fn
    rpad = _up(rows, TM)
    kld = _up(k, 8) + PAD
    span = rows // m if rows % m == 0 else rows // m + 2
    a = _up(2 * (1 + stages), 4)     # a transaction barrier per stage, + 1
    end = (a + rpad * kld + stages * tile_rows(k, ks) * cols
           + _up(span * o * fn, 4) + _up(rpad * o, 4))
    return 4 * max(end, a + ks * rpad * (cols + PAD))


def stages(m: int, o: int, fs: int, fn: int, rows: int, cols: int,
           ks: int) -> int:
    """Weight K-tiles in flight: every tile (up to MAX_STAGES) while the
    block still leaves room for a second on its SM, else fewer, at least
    two (one where K is a single tile)."""
    k = fs + fn
    n = min(MAX_STAGES, max(1, -(-k // tile_rows(k, ks))))
    while n > 2 and (smem_bytes(m, o, fs, fn, rows, cols, ks, n)
                     > SMEM_TWO_PER_SM):
        n -= 1
    return n


def plan(b: int, m: int, o: int, fs: int, fn: int, h: int,
         sm_count: int) -> Plan:
    """Tile, k split and stages of a launch: ``tiling``'s choice, with
    fewer graphs, then fewer columns, where its shared memory would not
    fit."""
    t = tiling(b, m, h, sm_count)
    while True:
        ks = k_split(t.rows, t.cols, fs + fn)
        s = stages(m, o, fs, fn, t.rows, t.cols, ks)
        if (smem_bytes(m, o, fs, fn, t.rows, t.cols, ks, s) <= SMEM_LIMIT
                or (t.graphs == 1 and t.cols == TN)):
            return Plan(t, ks, s)
        if t.graphs > 1:
            t = tiling(b, m, h, sm_count, max_graphs=t.graphs // 2,
                       max_cols=t.cols)
        else:
            t = tiling(b, m, h, sm_count, max_graphs=1,
                       max_cols=max(TN, t.cols // 2 // TN * TN))


def kernel_info(b: int, m: int, o: int, fs: int, fn: int, h: int,
                device) -> dict:
    """The launch at these shapes on CUDA ``device``: its tile, k split,
    stages, threads, dynamic shared memory per block (from the kernel's
    own layout) and how many of its blocks one SM runs at once. Needs the
    card."""
    t, ks, st = plan(b, m, o, fs, fn, h, _build.sm_count(device))
    args = (m, o, fs, fn, h, t.rows, t.cols, ks, st)
    with torch.cuda.device(device):
        return {"graphs": t.graphs, "rows": t.rows, "cols": t.cols,
                "grid": t.grid, "k_split": ks, "stages": st,
                "threads": threads(t.rows, t.cols, ks),
                "smem_bytes": _build.query("gcn_agg", "gcn_agg_smem_bytes",
                                           *args),
                "blocks_per_sm": _build.query(
                    "gcn_agg", "gcn_agg_blocks_per_sm", *args)}


def gcn_agg(adj, self_feat, nbr_feat, w_self, w_nbr, bias):
    """adj [B,M,O], self_feat [B,M,Fs], nbr_feat [B,O,Fn], w_self [Fs,H],
    w_nbr [Fn,H], bias [H] -> relu'd [B,M,H]. ``adj`` may be strided (the
    option-side layer passes a transposed view); the rest is contiguous."""
    device = _build.device_of(adj, self_feat, nbr_feat, w_self, w_nbr, bias)
    if device.type == "cpu":
        return ref.gcn_agg_ref(adj, self_feat, nbr_feat, w_self, w_nbr, bias)
    if device.type != "cuda":
        raise ValueError(f"gcn_agg: no kernel for device {device}")
    return _launch(device, adj, self_feat, nbr_feat, w_self, w_nbr, bias)


def _launch(device, adj, hs, hn, ws, wn, bias):
    global launches
    _build.check_dtype("adj", adj, contiguous=False)
    _build.check_dtype("self_feat nbr_feat w_self w_nbr bias",
                     hs, hn, ws, wn, bias)
    b, m, o = adj.shape
    fs, fn, h = hs.shape[-1], hn.shape[-1], ws.shape[-1]
    if (hs.shape != (b, m, fs) or hn.shape != (b, o, fn)
            or ws.shape != (fs, h) or wn.shape != (fn, h)
            or bias.shape != (h,)):
        raise ValueError(
            f"gcn_agg: inconsistent shapes adj {tuple(adj.shape)}, self "
            f"{tuple(hs.shape)}, nbr {tuple(hn.shape)}, w_self "
            f"{tuple(ws.shape)}, w_nbr {tuple(wn.shape)}, bias "
            f"{tuple(bias.shape)}")
    out = torch.empty((b, m, h), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    t, ks, st = plan(b, m, o, fs, fn, h, _build.sm_count(device))
    smem = smem_bytes(m, o, fs, fn, t.rows, t.cols, ks, st)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"gcn_agg: M={m}, O={o}, Fs={fs}, Fn={fn} need {smem} B of "
            f"shared memory for a {t.rows} x {t.cols} tile, over the "
            f"kernel's {SMEM_LIMIT} B")
    _build.launch(_kernel(), "gcn_agg", device,
                  adj.data_ptr(), hs.data_ptr(), hn.data_ptr(), ws.data_ptr(),
                  wn.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  *adj.stride(), b, m, o, fs, fn, h, t.rows, t.cols, ks, st)
    launches += 1
    return out
