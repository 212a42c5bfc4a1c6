"""Single-token GQA decode attention over a KV cache: wrapper of the CUDA
kernel ``csrc/decode_attention.cu``.

Counterpart of ``repro/kernels/decode_attention.py``. A CUDA tensor
launches the hand-written kernel or raises; a CPU tensor runs the plain
version ``ref.decode_attention_ref``. ``launches`` counts kernel launches
and nothing else. The kernel reads the cache through its strides (a
layer's slice of a stacked cache costs no copy) and only the rows below
``lengths[b]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0

HEAD_DIMS = (32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = _build.bind("decode_attention", "decode_attention_fwd",
                          n_ptr=5, n_int=16)
    return _fn


def check_shapes(q, k, v, lengths) -> None:
    """q [B,H,d], k/v [B,S,KVH,d], lengths [B], H % KVH == 0."""
    if (q.dim() != 3 or k.dim() != 4 or k.shape != v.shape
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[2]
            or tuple(lengths.shape) != (q.shape[0],)):
        raise ValueError(
            f"decode_attention: q must be [B,H,d], k, v [B,S,KVH,d] and "
            f"lengths [B]; got q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, lengths {tuple(lengths.shape)}")
    h, kvh = q.shape[1], k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"decode_attention: {h} query heads do not split "
                         f"into groups over {kvh} kv heads")


def decode_attention(q, k, v, lengths):
    """q [B,H,d] (one token per sequence) against k/v [B,S,KVH,d], keys
    j < lengths[b] (values above S mean S) -> [B,H,d] in q's dtype."""
    check_shapes(q, k, v, lengths)
    device = _build.device_of(q, k, v, lengths)
    if device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths)
    if device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {device}")
    return _launch(device, q, k, v, lengths)


def _launch(device, q, k, v, lengths):
    global launches
    _build.check_dtype("q k v", q, k, v, dtypes=DTYPES, contiguous=False)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"decode_attention: q, k, v must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    _build.check_dtype("lengths", lengths, dtypes=(torch.int32,))
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {d} not in {HEAD_DIMS}")
    # a query-head group too large for one block's shared memory is refused
    # by the kernel's launch, which _build.launch raises on
    _build.check_rows("q k v", q, k, v)
    out = torch.empty((b, h, d), dtype=q.dtype, device=device)
    if out.numel() == 0:
        return out
    _build.launch(_kernel(), "decode_attention", device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), *q.stride()[:2],
                  *k.stride()[:3], *v.stride()[:3], *out.stride()[:2],
                  b, s, h, kvh, d, int(q.dtype == torch.bfloat16))
    launches += 1
    return out
