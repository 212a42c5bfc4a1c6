"""Eq-13/14 fused edge scorer: wrapper of the CUDA kernel
``csrc/edge_score.cu``.

Counterpart of ``repro/kernels/edge_score.py``. A CUDA tensor launches the
hand-written kernel or raises; a CPU tensor runs the plain version
``ref.edge_score_ref``. ``launches`` counts kernel launches and nothing
else.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0

# dynamic shared memory the kernel may take without the >48 KB opt-in
SMEM_LIMIT = 48 * 1024
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = _build.bind("edge_score", "edge_score_f32", n_ptr=10, n_int=5)
    return _fn


def smem_bytes(m: int, o: int, h: int, e: int) -> int:
    return 4 * (m * h + o * h + (m + o) * (e + 1) + 2 * e)


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
    if smem_bytes(m, o, h, e) > SMEM_LIMIT:
        raise ValueError(
            f"edge_score: M={m}, O={o}, H={h}, E={e} need "
            f"{smem_bytes(m, o, h, e)} B of shared memory, over the "
            f"kernel's {SMEM_LIMIT} B")
    out = torch.empty((b, m, o), dtype=torch.float32, device=device)
    if b == 0:
        return out
    _build.launch(_kernel(), "edge_score", device,
                  hs.data_ptr(), hd.data_ptr(), ef.data_ptr(), ws.data_ptr(),
                  bs.data_ptr(), wd.data_ptr(), wf.data_ptr(), wo.data_ptr(),
                  bo.data_ptr(), out.data_ptr(), b, m, o, h, e)
    launches += 1
    return out
