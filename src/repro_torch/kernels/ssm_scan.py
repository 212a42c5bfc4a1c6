"""Chunked gated linear recurrence (RWKV-6 WKV, Mamba-2 SSD): wrapper of
the CUDA kernel ``csrc/ssm_scan.cu``.

Counterpart of ``repro/kernels/ssm_scan.py`` plus what
``repro/models/ssm.py::chunked_linear_attn`` adds around it: an initial
state and the final state as a second output. A CUDA tensor launches the
hand-written kernel or raises; a CPU tensor runs the plain version
``ref.ssm_scan_ref`` (the sequential recurrence). ``launches`` counts
kernel launches and nothing else. The kernel reads q/k/v/log_w through
their [B,T,H,d] strides, so unlike the JAX wrapper there is no
head-major copy. A bfloat16 input runs the tensor-core kernel (rows
16-byte aligned), a float32 input the CUDA-core one; ``kernel_info``
gives either's shared memory and blocks per SM.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

launches = 0

DIMS = (8, 16, 32, 64)
DTYPES = (torch.float32, torch.bfloat16)
SUB = 16   # the kernel's sub-block rows
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        _fn = _build.bind("ssm_scan", "ssm_scan_fwd", n_ptr=8, n_int=22)
    return _fn


def kernel_info(dk: int, dv: int, chunk: int, dtype) -> dict:
    """The CUDA kernel that takes (dk, dv, chunk, dtype): its dynamic
    shared memory per block in bytes and how many of its blocks one SM of
    the current card runs at once. Needs the card."""
    args = (dk, dv, chunk, int(dtype == torch.bfloat16))
    return {key: _build.query("ssm_scan", symbol, *args)
            for key, symbol in (("smem_bytes", "ssm_scan_smem_bytes"),
                                ("blocks_per_sm", "ssm_scan_blocks_per_sm"))}


def check_shapes(q, k, v, log_w, bonus_u, initial_state, chunk) -> int:
    """q, k, log_w [B,T,H,dk], v [B,T,H,dv], T >= 1, bonus_u [H,dk] or
    None, initial_state [B,H,dk,dv] or None. Returns the chunk length
    ``c = min(chunk, T)``, which must divide T and, from 16 rows up, be a
    multiple of the 16-row sub-block (the reference's own limits)."""
    if (q.dim() != 4 or k.shape != q.shape or log_w.shape != q.shape
            or v.dim() != 4 or v.shape[:3] != q.shape[:3] or q.shape[1] < 1):
        raise ValueError(
            f"ssm_scan: q, k, log_w must be [B,T,H,dk] and v [B,T,H,dv] with "
            f"T >= 1; got q {tuple(q.shape)}, k {tuple(k.shape)}, log_w "
            f"{tuple(log_w.shape)}, v {tuple(v.shape)}")
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    if bonus_u is not None and tuple(bonus_u.shape) != (h, dk):
        raise ValueError(f"ssm_scan: bonus_u must be [H, dk] = {(h, dk)}, got "
                         f"{tuple(bonus_u.shape)}")
    if initial_state is not None and tuple(initial_state.shape) != (b, h, dk, dv):
        raise ValueError(f"ssm_scan: initial_state must be [B,H,dk,dv] = "
                         f"{(b, h, dk, dv)}, got {tuple(initial_state.shape)}")
    c = min(int(chunk), t)
    if c < 1 or t % c or (c > SUB and c % SUB):
        raise ValueError(f"ssm_scan: chunk {chunk} over T={t} gives c={c}: c "
                         f"must divide T and be below {SUB} or a multiple "
                         f"of {SUB}")
    return c


def ssm_scan(q, k, v, log_w, bonus_u=None, *, chunk: int = 128,
             initial_state=None):
    """-> (y [B,T,H,dv] in q's dtype, final state [B,H,dk,dv] float32).

    ``bonus_u`` [H, dk] selects RWKV semantics, None Mamba/SSD;
    ``initial_state`` None starts from zeros. ``chunk`` is the kernel's
    chunk length (at most T); the plain version checks it and does not
    need it."""
    c = check_shapes(q, k, v, log_w, bonus_u, initial_state, chunk)
    extra = [x for x in (bonus_u, initial_state) if x is not None]
    device = _build.device_of(q, k, v, log_w, *extra)
    if device.type == "cpu":
        return ref.ssm_scan_ref(q, k, v, log_w, bonus_u=bonus_u,
                                initial_state=initial_state)
    if device.type != "cuda":
        raise ValueError(f"ssm_scan: no kernel for device {device}")
    return _launch(device, q, k, v, log_w, bonus_u, initial_state, c)


def _launch(device, q, k, v, log_w, bonus_u, initial_state, c):
    global launches
    _build.check_dtype("q k v", q, k, v, dtypes=DTYPES, contiguous=False)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"ssm_scan: q, k, v must share a dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    _build.check_dtype("log_w", log_w, contiguous=False)
    if bonus_u is not None:
        _build.check_dtype("bonus_u", bonus_u)
    if initial_state is not None:
        _build.check_dtype("initial_state", initial_state)
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    if dk not in DIMS or dv not in DIMS:
        raise ValueError(f"ssm_scan: dk {dk} and dv {dv} must be in {DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v), ("log_w", log_w)):
        if x.stride(-1) != 1:
            raise ValueError(f"ssm_scan: {name}'s last axis must be "
                             f"contiguous (strides {x.stride()})")
    if q.dtype == torch.bfloat16:   # the tensor-core kernel's 16-byte loads
        _build.check_rows("q k v log_w", q, k, v, log_w)
    y = torch.empty((b, t, h, dv), dtype=q.dtype, device=device)
    final = torch.empty((b, h, dk, dv), dtype=torch.float32, device=device)
    if y.numel() == 0:
        return y, final
    # a chunk too large for one block's shared memory is refused by the
    # kernel's launch, which _build.launch raises on
    _build.launch(_kernel(), "ssm_scan", device,
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                  0 if bonus_u is None else bonus_u.data_ptr(),
                  0 if initial_state is None else initial_state.data_ptr(),
                  y.data_ptr(), final.data_ptr(),
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *log_w.stride()[:3], *y.stride()[:3],
                  b, t, h, dk, dv, c, int(q.dtype == torch.bfloat16))
    launches += 1
    return y, final
