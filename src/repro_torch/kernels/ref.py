"""Plain PyTorch versions of the hand-written kernels.

Counterparts of ``repro/kernels/ref.py::gcn_agg_ref``, ``::edge_score_ref``,
``::flash_attention_ref``, ``::decode_attention_ref`` and ``::ssm_scan_ref``. They are what a
CPU tensor runs, and what ``chip_smoke.py`` holds the CUDA kernels against
on the card. ``gcn_agg_bwd`` and ``edge_score_bwd`` are the backward rules
of the two actor kernels (``repro/kernels/ops.py:85-105, 141-171``), which
``ops`` runs on both devices; ``ssm_scan_bwd`` is the scan's, the VJP of
``ssm_scan_chunked_ref`` (the reference's ``chunked_linear_attn``, which
its training differentiates; it has no backward kernel). ``flash_attention_bf16_emulation``,
``decode_attention_split_ref`` and ``ssm_scan_bf16_emulation`` have no
JAX counterpart: they compute with the CUDA kernels' own rounding and
order (the bf16 flash and scan kernels' tensor-core arithmetic, decode
split by split), so that the card's results can be held to the precision
that arithmetic allows (``ssm_emu_err``).
"""
from __future__ import annotations

import math

import torch

_NEG = -1e30
_LOG2E = 1.4426950408889634


def gcn_agg_ref(adj, self_feat, nbr_feat, w_self, w_nbr, bias):
    """Degree-normalized neighbor aggregation + fused linear + relu (Eq 12).

    adj [B, M, O], self_feat [B, M, Fs], nbr_feat [B, O, Fn],
    w_self [Fs, H], w_nbr [Fn, H], bias [H] -> [B, M, H].
    """
    deg = adj.sum(-1, keepdim=True)
    agg = (adj @ nbr_feat) / (deg + 1e-6)
    pre = self_feat @ w_self + agg @ w_nbr + bias
    return torch.relu(pre)


def edge_score_ref(h_src, h_dst, edge_feat, w_src, b_src, w_dst, w_feat,
                   w_out, b_out):
    """Fused edge scorer (Eq 13-14).

    h_src [B, M, H], h_dst [B, O, H], edge_feat [B, M, O];
    w_src/w_dst [H, E], b_src/w_feat/w_out [E], b_out [1] -> [B, M, O].
    """
    src = h_src @ w_src + b_src                       # [B, M, E]
    dst = h_dst @ w_dst                               # [B, O, E]
    x = src[..., :, None, :] + dst[..., None, :, :] \
        + edge_feat[..., None] * w_feat
    return torch.sum(torch.relu(x) * w_out, dim=-1) + b_out[0]


def _flat2(x):
    """[B, N, F] -> [B*N, F], so that a weight's gradient is one GEMM."""
    return x.reshape(-1, x.shape[-1])


def gcn_agg_bwd(dout, adj, hs, hn, ws, wn, out, needs=(True,) * 6):
    """The backward of ``gcn_agg_ref``, as ``repro/kernels/ops.py:85-105``:
    the relu mask from the saved output (out > 0 iff the pre-activation
    was), ``agg`` recomputed. ``adj`` may be a strided view. Returns
    (dadj, dhs, dhn, dws, dwn, dbias), None where ``needs`` is False."""
    deg = adj.sum(-1, keepdim=True) + 1e-6
    dpre = torch.where(out > 0, dout, 0.0)                  # [B, M, H]
    want_agg = needs[0] or needs[4]
    agg = (adj @ hn) / deg if want_agg else None
    dagg_n = (dpre @ wn.T) / deg if needs[0] or needs[2] else None
    dadj = dhs = dhn = dws = dwn = dbias = None
    if needs[0]:
        # d(agg)/d(adj[i, o]) = (hn[o] - agg[i]) / deg[i]
        dadj = dagg_n @ hn.transpose(-1, -2) \
            - (dagg_n * agg).sum(-1, keepdim=True)
    if needs[1]:
        dhs = dpre @ ws.T
    if needs[2]:
        dhn = adj.transpose(-1, -2) @ dagg_n
    if needs[3]:
        dws = _flat2(hs).T @ _flat2(dpre)
    if needs[4]:
        dwn = _flat2(agg).T @ _flat2(dpre)
    if needs[5]:
        dbias = dpre.sum((0, 1))
    return dadj, dhs, dhn, dws, dwn, dbias


def edge_score_bwd(dl, h_src, h_dst, ef, w_src, b_src, w_dst, w_feat, w_out,
                   needs=(True,) * 9):
    """The backward of ``edge_score_ref``, as
    ``repro/kernels/ops.py:141-171``: the [B, M, O, E] hidden is recomputed
    from src, dst and the edge feature, not saved by the forward. Returns
    the gradients of (h_src, h_dst, edge_feat, w_src, b_src, w_dst, w_feat,
    w_out, b_out), None where ``needs`` is False."""
    src = h_src @ w_src + b_src                             # [B, M, E]
    dst = h_dst @ w_dst                                     # [B, O, E]
    x = src[..., :, None, :] + dst[..., None, :, :] + ef[..., None] * w_feat
    am = torch.where(x > 0, dl[..., None] * w_out, 0.0)     # dL/dx, masked
    dsrc = am.sum(-2)                                       # [B, M, E]
    ddst = am.sum(-3)                                       # [B, O, E]
    grads = [None] * 9
    if needs[0]:
        grads[0] = dsrc @ w_src.T
    if needs[1]:
        grads[1] = ddst @ w_dst.T
    if needs[2]:
        grads[2] = (am * w_feat).sum(-1)
    if needs[3]:
        grads[3] = _flat2(h_src).T @ _flat2(dsrc)
    if needs[4]:
        grads[4] = dsrc.sum((0, 1))
    if needs[5]:
        grads[5] = _flat2(h_dst).T @ _flat2(ddst)
    if needs[6]:
        grads[6] = (am * ef[..., None]).sum((0, 1, 2))
    if needs[7]:
        grads[7] = (torch.relu(x) * dl[..., None]).sum((0, 1, 2))
    if needs[8]:
        grads[8] = dl.sum()[None]
    return tuple(grads)


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q [B,S,H,d], k/v [B,S,KVH,d] -> [B,S,H,d]: plain softmax attention
    in float32 with kv head h // (H / KVH), scale 1/sqrt(d), keys j kept
    where j <= i (causal) and i - j < window; cast to q's dtype."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qf = q.float().reshape(b, s, kvh, h // kvh, d)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) * scale
    pos = torch.arange(s, device=q.device)
    ok = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window is not None:
        ok &= pos[:, None] - pos[None, :] < window
    logits = torch.where(ok, logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)


def flash_attention_bf16_emulation(q, k, v, *, causal: bool = True,
                                   window=None, tile: int = 64):
    """The arithmetic of the bf16 CUDA flash kernel in plain PyTorch: S =
    Q K^T summed in float32 and scaled by log2(e)/sqrt(d), an online
    softmax over ``tile``-key tiles from key 0 on (running max and sum in
    float32, exp2; the sum taken before rounding), the probabilities
    rounded to bf16 before P V (float32 accumulators), the output divided
    by the sum. q/k/v [B,S,H,d] / [B,S,KVH,d] as ``flash_attention_ref``;
    returns float32, not rounded, so that a check sees the kernel's own
    output rounding."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qf = q.float().reshape(b, s, kvh, h // kvh, d)
    kf, vf = k.float(), v.float()
    scale = _LOG2E / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    m = torch.full((b, kvh, h // kvh, s), -math.inf, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(m.shape + (d,), device=q.device)
    for k0 in range(0, s, tile):
        kp = pos[k0:k0 + tile]
        sc = torch.einsum("bqkgd,bskd->bkgqs", qf,
                          kf[:, k0:k0 + tile]) * scale
        ok = torch.ones((s, kp.numel()), dtype=torch.bool, device=q.device)
        if causal:
            ok &= kp[None, :] <= pos[:, None]
        if window is not None:
            ok &= pos[:, None] - kp[None, :] < window
        sc = torch.where(ok, sc, -math.inf)
        mx = torch.maximum(m, sc.amax(-1))
        mu = torch.where(mx == -math.inf, 0.0, mx)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(sc - mu[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.bfloat16().float(), vf[:, k0:k0 + tile])
        m = mx
    out = acc / l.clamp(min=1e-38)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def decode_attention_ref(q, k, v, lengths):
    """q [B,H,d] one token; k/v [B,S,KVH,d]; lengths [B] = number of valid
    cache rows -> [B,H,d], in float32, cast to q's dtype."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    qf = q.float().reshape(b, kvh, h // kvh, d)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k.float()) * scale
    valid = torch.arange(s, device=q.device)[None, :] < lengths[:, None]
    logits = torch.where(valid[:, None, None, :], logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_split_ref(q, k, v, lengths, n_splits: int):
    """``decode_attention_ref`` computed as the CUDA kernel splits it: the
    rows below L = clamp(lengths[b], 0, S) are cut into ``n_splits``
    splits of ceil(L / n_splits) rows; each split keeps its own running
    max m (base 2), sum l and unnormalised output acc in float32 (m = -inf,
    l = 0 for a split with no row); the splits combine by rescaling to
    the largest m. A sequence with lengths[b] <= 0 attends uniformly over
    all S rows, as ``decode_attention_ref`` and the JAX reference do: as
    the kernel does it, it is read as length S with q scaled by 0, so that
    every logit is 0. Cast to q's dtype."""
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    empty = lengths.long() <= 0
    scale = torch.where(empty, 0.0, _LOG2E / math.sqrt(d))
    qf = q.float().reshape(b, kvh, h // kvh, d) * scale[:, None, None, None]
    logits = torch.einsum("bkgd,bskd->bkgs", qf, k.float())
    n = torch.where(empty, s, lengths.long().clamp(max=s))
    per = (n + n_splits - 1) // n_splits
    pos = torch.arange(s, device=q.device)
    split_of = pos[None, :] // per.clamp(min=1)[:, None]        # [B, S]
    rows = pos[None, :] < n[:, None]
    ms, ls, accs = [], [], []
    for j in range(n_splits):
        keep = (rows & (split_of == j))[:, None, None, :]
        sj = torch.where(keep, logits, -math.inf)
        m = sj.amax(-1)                                         # [B,KVH,g]
        p = torch.exp2(sj - torch.where(m == -math.inf, 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p, v.float()))
    m_all = torch.stack(ms)
    top = m_all.amax(0)
    f = torch.exp2(m_all - torch.where(top == -math.inf, 0.0, top))
    l_sum = (f * torch.stack(ls)).sum(0)
    acc = (f[..., None] * torch.stack(accs)).sum(0)
    out = torch.where(l_sum[..., None] > 0,
                      acc / l_sum.clamp(min=1e-38)[..., None], 0.0)
    return out.reshape(b, h, d).to(q.dtype)


def ssm_step_ref(q, k, v, decay, state, *, bonus_u=None):
    """One step of the gated linear recurrence: q, k [B,H,dk], v [B,H,dv],
    decay = exp(log_w) [B,H,dk], state [B,H,dk,dv] float32 -> (y [B,H,dv],
    new state), both float32. ``S = diag(decay) S + k^T v``; ``bonus_u``
    None reads ``y = q S`` after the update (Mamba/SSD), ``bonus_u``
    [H, dk] reads ``y = q S + (q * u * k) . v`` before it (RWKV-6)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    upd = kf[..., :, None] * vf[..., None, :]
    if bonus_u is None:
        state = state * decay[..., None] + upd
        return torch.einsum("bhd,bhde->bhe", qf, state), state
    y = torch.einsum("bhd,bhde->bhe", qf, state) + torch.sum(
        qf * bonus_u.float() * kf, dim=-1, keepdim=True) * vf
    return y, state * decay[..., None] + upd


def ssm_scan_ref(q, k, v, log_w, *, bonus_u=None, initial_state=None):
    """The gated linear recurrence, ``ssm_step_ref`` one step at a time,
    batched over B and H: q, k, log_w [B,T,H,dk], v [B,T,H,dv] ->
    (y [B,T,H,dv] in q's dtype, final state [B,H,dk,dv] float32), from
    ``initial_state`` (zeros if None). Float32 throughout. Deliberately
    not the chunked algorithm of the kernel, so that it checks the kernel
    independently; for the same reason it is the oracle that
    ``ssm_scan_bwd``'s chunked VJP is held against on the card (its own
    autograd would save T states, so it is not the backward)."""
    b, t, h, dk = q.shape
    s = (torch.zeros((b, h, dk, v.shape[-1]), dtype=torch.float32,
                     device=q.device)
         if initial_state is None else initial_state.float())
    qf, kf, vf = q.float(), k.float(), v.float()
    w = torch.exp(log_w.float())
    u = None if bonus_u is None else bonus_u.float()
    ys = []
    for i in range(t):
        y, s = ssm_step_ref(qf[:, i], kf[:, i], vf[:, i], w[:, i], s,
                            bonus_u=u)
        ys.append(y)
    return torch.stack(ys, dim=1).to(q.dtype), s


SUBBLOCK = 16   # the chunked form's anchoring sub-block (all exponents <= 0)


def _intra_chunk(qc, kc, vc, qe, cum, u):
    """The within-chunk part of ``ssm_scan_chunked_ref``'s y, every chunk
    at once: q, k, qe, cum [N, c, H, dk], v [N, c, H, dv] (N = B x chunks)
    -> [N, c, H, dv]. As the reference's ``_intra_chunk``: the diagonal
    16-row sub-blocks exact in log space (qe_i - cum_j), the earlier
    sub-blocks of the chunk through q and k rescaled at an anchor, the
    cumulative decay at the end of the sub-block before the rows' own."""
    n, c, h, dk = qc.shape
    uu = min(SUBBLOCK, c)
    ns = c // uu
    dev = qc.device

    def sub(x):
        return x.reshape(n, ns, uu, h, x.shape[-1])

    qs, ks, vs, qes, cums = (sub(x) for x in (qc, kc, vc, qe, cum))
    pos = torch.arange(uu, device=dev)
    keep = (pos[None, :] < pos[:, None]) if u is not None \
        else (pos[None, :] <= pos[:, None])                    # [i, j]
    gap = qes[:, :, :, None] - cums[:, :, None]               # [n,s,i,j,h,d]
    pair = torch.exp(torch.where(keep[:, :, None, None], gap, -math.inf))
    a = torch.einsum("nsihd,nsijhd,nsjhd->nshij", qs, pair, ks)
    if u is not None:
        a = a + torch.diag_embed(
            torch.einsum("nsihd,hd,nsihd->nshi", qs, u, ks))
    y = torch.einsum("nshij,nsjhe->nsihe", a, vs)
    if ns > 1:
        base = cum[:, uu - 1:c - 1:uu]                         # [n,s-1,h,d]
        q_in = qs[:, 1:] * torch.exp(qes[:, 1:] - base[:, :, None])
        rows = torch.arange(c, device=dev)
        before = rows[None, :] < uu * torch.arange(1, ns, device=dev)[:, None]
        k_in = kc[:, None] * torch.exp(torch.where(
            before[None, :, :, None, None], base[:, :, None] - cum[:, None],
            -math.inf))                                        # [n,s-1,c,h,d]
        a_off = torch.einsum("ntihd,ntjhd->nthij", q_in, k_in)
        y = torch.cat([y[:, :1], y[:, 1:] + torch.einsum(
            "nthij,njhe->ntihe", a_off, vc)], 1)
    return y.reshape(n, c, h, vc.shape[-1])


def ssm_scan_chunked_ref(q, k, v, log_w, *, chunk: int, bonus_u=None,
                         initial_state=None):
    """The gated linear recurrence in the chunked form of
    ``repro/models/ssm.py::chunked_linear_attn``, in float32: per chunk of
    c = min(chunk, T) rows the inclusive cumulative decay ``cum``, its
    total ``tot`` and the read-out exponent ``qexp`` (``cum`` for Mamba,
    the exclusive ``cum - log_w`` for RWKV); y = the within-chunk part
    (``_intra_chunk``) + (q e^qexp) S, then S' = e^tot S + sum_j
    e^(tot - cum_j) k_j^T v_j. q, k, log_w [B,T,H,dk], v [B,T,H,dv] ->
    (y [B,T,H,dv] in q's dtype, final state [B,H,dk,dv] float32). The
    within-chunk parts of all chunks are computed at once, then the
    states chunk by chunk. It is what ``ssm_scan_bwd`` differentiates."""
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    c = min(int(chunk), t)
    if t % c:
        raise ValueError(f"ssm_scan_chunked_ref: chunk {c} does not divide "
                         f"T={t}")
    nc = t // c

    def resh(x):
        return x.float().reshape(b, nc, c, h, x.shape[-1])

    qc, kc, vc, wc = resh(q), resh(k), resh(v), resh(log_w)
    cum = wc.cumsum(2)
    qe = cum if bonus_u is None else cum - wc
    u = None if bonus_u is None else bonus_u.float()
    y = _intra_chunk(*(x.reshape(b * nc, c, h, x.shape[-1])
                       for x in (qc, kc, vc, qe, cum)), u)
    tot = cum[:, :, -1]                                        # [b,nc,h,dk]
    upd = torch.einsum("bnjhd,bnjhe->bnhde",
                       kc * torch.exp(tot[:, :, None] - cum), vc)
    s = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.float())
    starts = []
    for i in range(nc):
        starts.append(s)
        s = s * torch.exp(tot[:, i])[..., None] + upd[:, i]
    y = y.reshape(b, nc, c, h, dv) + torch.einsum(
        "bnihd,bnhde->bnihe", qc * torch.exp(qe), torch.stack(starts, 1))
    return y.reshape(b, t, h, dv).to(q.dtype), s


def ssm_scan_bwd(dy, dstate, q, k, v, log_w, bonus_u, initial_state, *,
                 chunk: int, needs=(True,) * 6):
    """The VJP of the scan: autograd of ``ssm_scan_chunked_ref`` over
    float32 copies of the inputs, for the cotangents ``dy`` [B,T,H,dv] of
    y and ``dstate`` [B,H,dk,dv] of the final state (None: zero). Returns
    the gradients of (q, k, v, log_w, bonus_u, initial_state), each in its
    input's dtype; None where ``needs`` is False or the input is None.
    The chunked graph keeps a [B,H,dk,dv] state and the within-chunk
    score blocks per chunk, not T states (``ssm_scan_ref``'s loop would)."""
    inputs = (q, k, v, log_w, bonus_u, initial_state)
    want = [x is not None and bool(n) for x, n in zip(inputs, needs)]
    with torch.enable_grad():
        xs = [None if x is None else x.detach().float().requires_grad_(w)
              for x, w in zip(inputs, want)]
        outs = ssm_scan_chunked_ref(*xs[:4], chunk=chunk, bonus_u=xs[4],
                                    initial_state=xs[5])
        pairs = [(o, d.float()) for o, d in zip(outs, (dy, dstate))
                 if d is not None]
        leaves = [x for x, w in zip(xs, want) if w]
        grads = list(torch.autograd.grad(
            [o for o, _ in pairs], leaves, [d for _, d in pairs],
            allow_unused=True)) if pairs and leaves else [None] * len(leaves)
    grads = iter(grads)
    out = []
    for x, w in zip(inputs, want):
        g = next(grads) if w else None
        if w and g is None:
            g = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        out.append(None if g is None else g.to(x.dtype))
    return tuple(out)


# The bf16 scan kernel against its emulation (ssm_emu_err), y beyond its
# bf16 output rounding and the final state, over 1 + the largest |value|
# of the (sequence, head); ~2x the largest readings on the card (PERF.md).
# What remains in y are bf16 roundings of a score that the kernel's
# ex2.approx and mma summation order tip the other way: one such flip moves
# a whole y row by up to an ulp of the score times |v| (a few hundred of
# 33.5M elements above 1e-4 at RWKV-6-7B's prefill shape, 1.478e-3 at
# most). In the state, k_out's hi + lo split represents each term to
# ~2^-18 whatever its rounding, so the kernel and the emulation differ
# there by ~1e-5 of the largest |S|.
SSM_EMU_TOL = 3e-3
SSM_EMU_STATE_TOL = 2e-5
# faults that the limits must reject, planted in the emulation only
SSM_EMU_FAULTS = ("the last off-diagonal sub-block dropped for the last "
                  "sub-block's rows",
                  "the carried-state read skipped in the last chunk",
                  "k_out's lo half dropped")


def ssm_scan_bf16_emulation(q, k, v, log_w, *, bonus_u=None, chunk=128,
                            initial_state=None, rounding=True, fault=None):
    """The arithmetic of the bf16 CUDA scan kernel in plain PyTorch: the
    chunked algorithm in float32 by its 16-row sub-blocks (cumsums within a
    sub-block, each sub-block's total, the sums of the earlier and later
    totals), with bf16 roundings where the kernel rounds: the diagonal
    block A_tt (exact in log space) and each off-diagonal A_ts = q^ k^T
    before they multiply V; q^ = q exp(qe + sub-blocks s+1..t-1) and k^ =
    k exp(tot_s - cum) (anchored at the end of s); q exp(qe + earlier
    sub-blocks) and the carried state S for the state read; k_out = k
    exp(tot - cum) as bf16 hi + lo for the state update. ``rounding=False``
    leaves out every rounding (and lo): the exact chunked algorithm.
    ``fault`` plants one of SSM_EMU_FAULTS. q, k, log_w [B,T,H,dk], v
    [B,T,H,dv] as ``ssm_scan_ref``; returns (y [B,T,H,dv] float32, not
    rounded, so that a check sees the kernel's own output rounding; the
    final state [B,H,dk,dv] float32)."""
    if fault is not None and fault not in SSM_EMU_FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    b, t, h, dk = q.shape
    dv = v.shape[-1]
    c = min(int(chunk), t)
    sub = min(c, 16)
    n = c // sub
    rwkv = bonus_u is not None

    def rnd(x):
        return x.bfloat16().float() if rounding else x

    qf, kf, vf, wf = (x.float().transpose(1, 2) for x in (q, k, v, log_w))
    s = (torch.zeros((b, h, dk, dv), device=q.device)
         if initial_state is None else initial_state.float().clone())
    pos = torch.arange(sub, device=q.device)
    keep = (pos[None, :] < pos[:, None]) if rwkv \
        else (pos[None, :] <= pos[:, None])                    # [i, j]
    ys = []
    for c0 in range(0, t, c):
        last = c0 + c == t

        def cut(x):
            return x[:, :, c0:c0 + c].reshape(b, h, n, sub, x.shape[-1])

        qc, kc, vc, wc = cut(qf), cut(kf), cut(vf), cut(wf)
        loc = wc.cumsum(3)                        # within each sub-block
        tot = loc[:, :, :, -1]                    # [B,H,n,dk]
        run = tot.cumsum(2)
        pre = torch.cat([torch.zeros_like(tot[:, :, :1]), run[:, :, :-1]], 2)
        suf = tot.flip(2).cumsum(2).flip(2) - tot  # later sub-blocks
        qe = torch.cat([torch.zeros_like(loc[:, :, :, :1]), loc[:, :, :, :-1]],
                       3) if rwkv else loc
        # diagonal blocks, exact in log space
        gap = qe[:, :, :, :, None, :] - loc[:, :, :, None, :, :]
        pair = torch.where(keep[..., None], torch.exp(gap.clamp(max=0.0)), 0.0)
        a = torch.einsum("bhnid,bhnijd,bhnjd->bhnij", qc, pair, kc)
        if rwkv:
            bonus = (qc * bonus_u.float()[None, :, None, None, :] * kc).sum(-1)
            a = a + torch.diag_embed(bonus)
        y = torch.einsum("bhnij,bhnje->bhnie", rnd(a), vc)
        # earlier sub-blocks, anchored at the end of each
        k_hat = rnd(kc * torch.exp(tot[:, :, :, None, :] - loc))
        for ti in range(1, n):
            gaps = suf[:, :, :ti] - suf[:, :, ti - 1:ti]      # [B,H,ti,dk]
            q_hat = rnd(qc[:, :, ti, None] * torch.exp(
                qe[:, :, ti, None] + gaps[:, :, :, None, :]))
            a = rnd(torch.einsum("bhsid,bhsjd->bhsij", q_hat, k_hat[:, :, :ti]))
            if fault == SSM_EMU_FAULTS[0] and ti == n - 1:
                a[:, :, ti - 1] = 0.0
            y[:, :, ti] += torch.einsum("bhsij,bhsje->bhie", a, vc[:, :, :ti])
        # the carried-state read
        if not (fault == SSM_EMU_FAULTS[1] and last):
            q_s = rnd(qc * torch.exp(qe + pre[:, :, :, None, :]))
            y = y + torch.einsum("bhnid,bhde->bhnie", q_s, rnd(s))
        ys.append(y.reshape(b, h, c, dv))
        # the state update, k_out as bf16 hi + lo
        k_out = kc * torch.exp(tot[:, :, :, None, :] - loc
                               + suf[:, :, :, None, :])
        hi = rnd(k_out)
        parts = [hi]
        if rounding and fault != SSM_EMU_FAULTS[2]:
            parts.append(rnd(k_out - hi))
        s = s * torch.exp(run[:, :, -1])[..., None]
        for part in parts:
            s = s + torch.einsum("bhnjd,bhnje->bhde", part, vc)
    return torch.cat(ys, 2).transpose(1, 2), s


def ssm_emu_excess(got, emu, *, state=False):
    """Per element, the bf16 scan kernel's error against
    ``ssm_scan_bf16_emulation`` over 1 + the largest |emu| of the same
    (sequence, head): for y [B,T,H,dv], beyond the bf16 rounding of the
    kernel's output (half an ulp, <= 2^-8 |emu|); for the float32 state
    [B,H,dk,dv], all of it."""
    g, e = got.float(), emu.float()
    diff = (g - e).abs()
    if not state:
        diff = (diff - 2.0 ** -8 * e.abs()).clamp(min=0)
    scale = 1 + e.abs().amax(dim=(2, 3) if state else (1, 3), keepdim=True)
    return diff / scale


def ssm_emu_err(got, emu, *, state=False):
    """The largest of ``ssm_emu_excess``: what SSM_EMU_TOL and
    SSM_EMU_STATE_TOL hold."""
    return float(ssm_emu_excess(got, emu, state=state).max())
