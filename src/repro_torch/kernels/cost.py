"""What each hand-written kernel's function costs, from its arguments.

One formula per kernel, ``(bytes, flops)``: the bytes the function must
move (each input read once, each output written once) and the operations
it does on these inputs, whatever implements it. ``chip_smoke.py`` sets
each kernel's bound from them, and ``obs.cost`` counts each kernel call's
FLOPs by them, so that a program's cost does not depend on whether the
kernel or its plain version ran. Where the work depends on the data
(``decode_attention``'s rows below each length) the formula reads it.
"""
from __future__ import annotations


def numel(*ts) -> int:
    return sum(t.numel() for t in ts)


def gcn_agg_cost(adj, hs, hn, ws, wn, b):
    """Each input read once, the output written once; adj@hn, deg, the
    divide, both products, bias, relu."""
    bsz, m, o = adj.shape
    fs, fn, h = hs.shape[-1], hn.shape[-1], ws.shape[-1]
    out = bsz * m * h
    nbytes = 4 * (numel(adj, hs, hn, ws, wn, b) + out)
    flops = bsz * m * (2 * o * fn + o + fn) + out * (2 * fs + 2 * fn + 3)
    return nbytes, flops


def edge_score_cost(hs, hd, ef, ws, bs, wd, wf, wo, bo):
    """Each input read once, the logits written once; both projections and
    the per-edge hidden, relu and read-out."""
    bsz, m, o = ef.shape
    h, e = ws.shape
    nbytes = 4 * (numel(hs, hd, ef, ws, bs, wd, wf, wo, bo) + bsz * m * o)
    flops = (bsz * m * e * (2 * h + 1) + bsz * o * e * 2 * h
             + bsz * m * o * (6 * e + 1))
    return nbytes, flops


def causal_pairs(s, window):
    """(query, key) pairs a causal mask keeps, with an optional window."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def flash_cost(q, k, window, causal=True):
    """Each of q, k, v read once, the output written once; QK^T and PV
    over the kept pairs only (all S^2 without the causal mask)."""
    b, s, h, d = q.shape
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    pairs = causal_pairs(s, window) if causal else s * s
    return nbytes, 4 * b * h * d * pairs


def flash_bwd_flops(q, k, window, causal=True):
    """The backward's operations: QK^T recomputed, and dP = dO V^T,
    dV = P^T dO, dQ = dS K, dK = dS^T Q over the same pairs, 2.5 times the
    forward's two products."""
    return 5 * flash_cost(q, k, window, causal)[1] // 2


def decode_cost(q, k, lengths):
    """q and the output once, the K/V rows below each length once (the
    kernel reads no others), the lengths; QK^T and PV over those rows.
    Lengths without data (fake tensors: the dry run) count every row."""
    from torch._subclasses.fake_tensor import FakeTensor

    b, h, d = q.shape
    rows = (b * k.shape[1] if isinstance(lengths, FakeTensor)
            else int(lengths.clamp(max=k.shape[1]).sum()))
    nbytes = (q.element_size() * (2 * q.numel() + 2 * rows * k.shape[2] * d)
              + 4 * b)
    return nbytes, 4 * h * d * rows


def ssm_cost(q, v, log_w, u, s0):
    """q, k, v, log_w, u and the initial state read once, y and the final
    state written once; per token and head the recurrence's decay (dk·dv),
    update (2·dk·dv) and read-out (2·dk·dv), plus RWKV's bonus term (3·dk
    + 2·dv). The kernel's chunked form does more; that is its cost, not
    the function's."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    es = q.element_size()
    nbytes = (es * (2 * q.numel() + 2 * v.numel()) + 4 * log_w.numel()
              + 4 * b * h * dk * dv
              + sum(4 * x.numel() for x in (u, s0) if x is not None))
    per_token = 5 * dk * dv + (3 * dk + 2 * dv if u is not None else 0)
    return nbytes, b * t * h * per_token


def ssm_bwd_flops(q, v, log_w, u, s0):
    """The backward's operations: two products per forward product (the
    cotangent of each operand), twice the forward's."""
    return 2 * ssm_cost(q, v, log_w, u, s0)[1]
