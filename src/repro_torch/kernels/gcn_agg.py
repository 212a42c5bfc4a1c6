"""Eq-12 message passing: wrapper of the CUDA kernel ``csrc/gcn_agg.cu``.

Counterpart of ``repro/kernels/gcn_agg.py``. A CUDA tensor launches the
hand-written kernel or raises; a CPU tensor runs the plain version
``ref.gcn_agg_ref``. ``launches`` counts kernel launches and nothing else.
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
        _fn = _build.bind("gcn_agg", "gcn_agg_f32", n_ptr=7, n_int=9)
    return _fn


def smem_bytes(m: int, o: int, fs: int, fn: int) -> int:
    return 4 * (m * o + m * fs + o * fn + m * fn + m)


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
    if smem_bytes(m, o, fs, fn) > SMEM_LIMIT:
        raise ValueError(
            f"gcn_agg: M={m}, O={o}, Fs={fs}, Fn={fn} need "
            f"{smem_bytes(m, o, fs, fn)} B of shared memory, over the "
            f"kernel's {SMEM_LIMIT} B")
    out = torch.empty((b, m, h), dtype=torch.float32, device=device)
    if b == 0:
        return out
    _build.launch(_kernel(), "gcn_agg", device,
                  adj.data_ptr(), hs.data_ptr(), hn.data_ptr(), ws.data_ptr(),
                  wn.data_ptr(), bias.data_ptr(), out.data_ptr(),
                  *adj.stride(), b, m, o, fs, fn, h)
    launches += 1
    return out
