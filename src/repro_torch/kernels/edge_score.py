"""Eq-13/14 fused edge scorer: wrapper of the CUDA kernel
``csrc/edge_score.cu``.

Counterpart of ``repro/kernels/edge_score.py``. A CUDA tensor launches the
hand-written kernel or raises; a CPU tensor runs the plain version
``ref.edge_score_ref``. ``launches`` counts kernel launches and nothing
else. A block scores ``graphs`` consecutive graphs (``gcn_agg``'s
``graphs_per_block``: 1 up to one graph per SM, more at large B);
``smem_bytes`` is its shared memory (the layout of
``csrc/edge_score.cu::Layout``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.gcn_agg import SMEM_LIMIT, graphs_per_block

launches = 0

PAD = 4             # floats added to a shared-memory row
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = _build.bind("edge_score", "edge_score_f32", n_ptr=10, n_int=6)
    return _fn


def _up(x: int, n: int) -> int:
    return -(-x // n) * n


def smem_bytes(m: int, o: int, h: int, e: int, graphs: int) -> int:
    """Dynamic shared memory of one block, in bytes: the barrier, W_src
    and W_dst whole, the graphs' hs and hd rows, src and dst, w_feat and
    w_out."""
    kld, eld, pld = _up(h, 4), _up(e, 4), _up(e, 8) + PAD
    floats = (4 + 2 * _up(h, 4) * eld
              + (_up(graphs * m, 4) + _up(graphs * o, 4)) * kld
              + graphs * (m + o) * pld + 2 * _up(e, 4))
    return 4 * floats


def graphs(b: int, m: int, o: int, h: int, e: int, sm_count: int) -> int:
    """Graphs per block: ``graphs_per_block`` for the larger of M and O,
    halved while the block's shared memory would not fit."""
    g = graphs_per_block(b, max(m, o), sm_count)
    while g > 1 and smem_bytes(m, o, h, e, g) > SMEM_LIMIT:
        g //= 2
    return g


def kernel_info(b: int, m: int, o: int, h: int, e: int, device) -> dict:
    """The launch at these shapes on CUDA ``device``: graphs per block,
    dynamic shared memory per block (from the kernel's own layout) and how
    many of its blocks one SM runs at once. Needs the card."""
    g = graphs(b, m, o, h, e, _build.sm_count(device))
    with torch.cuda.device(device):
        return {"graphs": g,
                "smem_bytes": _build.query("edge_score",
                                           "edge_score_smem_bytes",
                                           m, o, h, e, g),
                "blocks_per_sm": _build.query(
                    "edge_score", "edge_score_blocks_per_sm", m, o, h, e, g)}


def edge_score(h_src, h_dst, edge_feat, w_src, b_src, w_dst, w_feat, w_out,
               b_out):
    """h_src [B,M,H], h_dst [B,O,H], edge_feat [B,M,O]; w_src/w_dst [H,E],
    b_src/w_feat/w_out [E], b_out [1] -> logits [B,M,O]."""
    args = (h_src, h_dst, edge_feat, w_src, b_src, w_dst, w_feat, w_out,
            b_out)
    device = _build.device_of(*args)
    if device.type == "cpu":
        return ref.edge_score_ref(*args)
    if device.type != "cuda":
        raise ValueError(f"edge_score: no kernel for device {device}")
    return _launch(device, *args)


def _launch(device, hs, hd, ef, ws, bs, wd, wf, wo, bo):
    global launches
    _build.check_dtype("h_src h_dst edge_feat w_src b_src w_dst w_feat w_out "
                     "b_out", hs, hd, ef, ws, bs, wd, wf, wo, bo)
    b, m, o = ef.shape
    h, e = ws.shape
    if (hs.shape != (b, m, h) or hd.shape != (b, o, h)
            or wd.shape != (h, e) or bs.shape != (e,) or wf.shape != (e,)
            or wo.shape != (e,) or bo.shape != (1,)):
        raise ValueError(
            f"edge_score: inconsistent shapes h_src {tuple(hs.shape)}, h_dst "
            f"{tuple(hd.shape)}, edge_feat {tuple(ef.shape)}, w_src "
            f"{tuple(ws.shape)}, w_dst {tuple(wd.shape)}, b_src "
            f"{tuple(bs.shape)}, w_feat {tuple(wf.shape)}, w_out "
            f"{tuple(wo.shape)}, b_out {tuple(bo.shape)}")
    out = torch.empty((b, m, o), dtype=torch.float32, device=device)
    if out.numel() == 0:
        return out
    g = graphs(b, m, o, h, e, _build.sm_count(device))
    smem = smem_bytes(m, o, h, e, g)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"edge_score: M={m}, O={o}, H={h}, E={e} need {smem} B of "
            f"shared memory, over the kernel's {SMEM_LIMIT} B")
    _build.launch(_kernel(), "edge_score", device,
                  hs.data_ptr(), hd.data_ptr(), ef.data_ptr(), ws.data_ptr(),
                  bs.data_ptr(), wd.data_ptr(), wf.data_ptr(), wo.data_ptr(),
                  bo.data_ptr(), out.data_ptr(), b, m, o, h, e, g)
    launches += 1
    return out
