"""GQA flash attention, causal or not: wrapper of the CUDA kernel
``csrc/flash_attention.cu``.

Counterpart of ``repro/kernels/flash_attention.py``. A CUDA tensor
launches the hand-written kernel or raises; a CPU tensor runs the plain
version ``ref.flash_attention_ref``. ``launches`` counts kernel launches
and nothing else. The kernel reads q/k/v through their strides, so
unlike the JAX wrapper there is no head-major copy, and any sequence
length is taken (the TPU kernel needs S to be a multiple of its blocks).
bfloat16 runs both products on the tensor cores (P rounded to bf16
before P V, the row sums in float32; a head of 80 in the 128-wide layout,
zero-padded); float32 runs them as float32 FMAs. ``HEAD_DIMS`` are the
head widths the kernel takes; another raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0

HEAD_DIMS = (32, 64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = _build.bind("flash_attention", "flash_attention_fwd", n_ptr=4,
                          n_int=20)
    return _fn


def check_shapes(q, k, v, window) -> None:
    """q [B,S,H,d], k/v [B,S,KVH,d], H % KVH == 0, window None or >= 1."""
    if (q.dim() != 4 or k.dim() != 4 or k.shape != v.shape
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]):
        raise ValueError(
            f"flash_attention: q must be [B,S,H,d] and k, v [B,S,KVH,d]; got "
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    h, kvh = q.shape[2], k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: {h} query heads do not split "
                         f"into groups over {kvh} kv heads")
    if window is not None and int(window) < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q [B,S,H,d], k/v [B,S,KVH,d] -> [B,S,H,d] in q's dtype; query i
    attends to keys j <= i (``causal``) with i - j < ``window``."""
    check_shapes(q, k, v, window)
    device = _build.device_of(q, k, v)
    if device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {device}")
    return _launch(device, q, k, v, causal, window)


def _launch(device, q, k, v, causal, window):
    global launches
    _build.check_dtype("q k v", q, k, v, dtypes=DTYPES, contiguous=False)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: q, k, v must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    _build.check_rows("q k v", q, k, v)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=device)
    if out.numel() == 0:
        return out
    _build.launch(_kernel(), "flash_attention", device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *out.stride()[:3], b, s, h, k.shape[2], d, int(causal),
                  0 if window is None else int(window),
                  int(q.dtype == torch.bfloat16))
    launches += 1
    return out
