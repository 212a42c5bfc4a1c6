"""Single-token GQA decode attention over a KV cache: wrapper of the CUDA
kernel ``csrc/decode_attention.cu``.

Counterpart of ``repro/kernels/decode_attention.py``. A CUDA tensor
launches the hand-written kernel or raises; a CPU tensor runs the plain
version ``ref.decode_attention_ref``. ``launches`` counts kernel launches
and nothing else. The kernel reads the cache through its strides (a
layer's slice of a stacked cache costs no copy) and only the rows below
``lengths[b]``. It splits each sequence's rows across up to
``MAX_SPLITS`` blocks (one thread-block cluster) when B * KVH blocks
alone would leave the card idle; ``n_splits`` is that choice, a pure
function so that it can be tested without a card. ``HEAD_DIMS`` are the
head widths the kernel takes (80 in the 128-wide lane layout); another
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0

HEAD_DIMS = (32, 64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_SPLITS = 8      # the portable thread-block cluster size
MIN_SPLIT_ROWS = 256
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = _build.bind("decode_attention", "decode_attention_fwd",
                          n_ptr=5, n_int=18)
    return _fn


def n_splits(batch: int, kv_heads: int, seq: int, sm_count: int) -> int:
    """Blocks per (kv head, sequence): 1 when the B * KVH blocks already
    give every SM two; else enough splits for that, at most
    ``MAX_SPLITS`` and with at least ``MIN_SPLIT_ROWS`` cache rows each
    (so every split of a full cache holds rows)."""
    blocks = batch * kv_heads
    if blocks >= 2 * sm_count:
        return 1
    want = -(-2 * sm_count // max(blocks, 1))
    return max(1, min(MAX_SPLITS, want, seq // MIN_SPLIT_ROWS))


def n_warps(blocks: int, sm_count: int) -> int:
    """Warps per block: 8 when the grid leaves SMs without a block, so
    that the few busy ones keep more rows in flight; else 4."""
    return 8 if blocks < sm_count else 4


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


def decode_attention(q, k, v, lengths, *, splits=None):
    """q [B,H,d] (one token per sequence) against k/v [B,S,KVH,d], keys
    j < lengths[b] (values above S mean S) -> [B,H,d] in q's dtype.
    ``splits`` forces the kernel's number of blocks per (kv head,
    sequence), 1 to ``MAX_SPLITS`` (None: ``n_splits``'s choice); a CPU
    tensor checks its range and runs the plain version all the same."""
    check_shapes(q, k, v, lengths)
    if splits is not None and not 1 <= int(splits) <= MAX_SPLITS:
        raise ValueError(f"decode_attention: splits must be in [1, "
                         f"{MAX_SPLITS}], got {splits}")
    device = _build.device_of(q, k, v, lengths)
    if device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths)
    if device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for device {device}")
    return _launch(device, q, k, v, lengths, splits)


def _launch(device, q, k, v, lengths, splits):
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
    # a query-head group above 8 is refused by the kernel's launch, which
    # _build.launch raises on
    _build.check_rows("q k v", q, k, v)
    out = torch.empty((b, h, d), dtype=q.dtype, device=device)
    if out.numel() == 0:
        return out
    sms = _build.sm_count(device)
    n = int(splits) if splits is not None else n_splits(b, kvh, s, sms)
    _build.launch(_kernel(), "decode_attention", device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  lengths.data_ptr(), out.data_ptr(), *q.stride()[:2],
                  *k.stride()[:3], *v.stride()[:3], *out.stride()[:2],
                  b, s, h, kvh, d, n, n_warps(b * kvh * n, sms),
                  int(q.dtype == torch.bfloat16))
    launches += 1
    return out
