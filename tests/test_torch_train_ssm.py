"""The differentiable ``ssm_scan`` against the JAX package: the plain
chunked form ``ref.ssm_scan_chunked_ref`` against the reference's
``chunked_linear_attn`` (which its RWKV-6 and Mamba-2 blocks train
through), its VJP ``ref.ssm_scan_bwd`` and ``ops.ssm_scan`` under autograd
(``ops._SsmScan``: the sequential plain forward on the CPU, the chunked
VJP backward, as on the card) against ``jax.vjp`` of it, with cotangents
on y and on the final state, both semantics, with and without an initial
state, fast and slow decays; float32 on numpy-drawn inputs. The models'
losses, gradients and AdamW steps are in test_torch_train_lm.py; the
card's Function against the kernel in test_torch_cuda.py."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.models.ssm import chunked_linear_attn as jax_chunked
from repro_torch.kernels import ops, ref
from test_torch_ssm import DECAYS, ssm_inputs

torch.set_num_threads(1)

GRAD_TOL = 1e-4          # of each leaf's max |g|
SSM_TOL = dict(rtol=1e-4, atol=1e-4)
# (B, T, H, dk, dv, chunk): two chunks of two 16-row sub-blocks
SHAPE = (2, 64, 2, 16, 8, 32)
CASES = [(rwkv, init, decay) for rwkv in (False, True)
         for init in (False, True) for decay in DECAYS]
NAMES = ("q", "k", "v", "log_w", "bonus_u", "initial_state")


def case_id(case):
    rwkv, init, decay = case
    return f"{'rwkv' if rwkv else 'mamba'}-{'init' if init else 'zero'}-{decay}"


@functools.lru_cache(maxsize=None)
def _jax_vjp(rwkv, init, chunk):
    def run(q, k, v, log_w, u, s0, dy, ds):
        out, vjp = jax.vjp(
            lambda q, k, v, w, u, s0: jax_chunked(
                q, k, v, w, chunk=chunk, bonus_u=u, initial_state=s0),
            q, k, v, log_w, u, s0)
        return out, vjp((dy, ds))

    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def reference(case):
    """(JAX inputs, torch inputs, cotangents (numpy), the reference's
    (y, final state) and its gradients of the six inputs, None where an
    input is None)."""
    rwkv, init, decay = case
    b, t, h, dk, dv, chunk = SHAPE
    jx, tx = ssm_inputs(11, b, t, h, dk, dv, rwkv=rwkv, decay=decay,
                        init=init)
    rng = np.random.default_rng(12)
    dy = rng.standard_normal((b, t, h, dv)).astype(np.float32)
    ds = rng.standard_normal((b, h, dk, dv)).astype(np.float32)
    out, grads = _jax_vjp(rwkv, init, chunk)(*jx, dy, ds)
    return (tx, (dy, ds), tuple(np.asarray(o) for o in out),
            tuple(None if g is None else np.asarray(g) for g in grads))


def assert_grads(got, want):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        m = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.detach().float().numpy() - w).max()) / m
        assert err <= GRAD_TOL, f"{name}: {err:.3e} of the leaf's max |g|"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_chunked_ref_matches_reference(case):
    """The plain chunked form's y and final state against the reference's
    ``chunked_linear_attn`` and against the sequential ``ssm_scan_ref``."""
    tx, _, (y, s), _ = reference(case)
    q, k, v, w, u, s0 = tx
    got = ref.ssm_scan_chunked_ref(q, k, v, w, chunk=SHAPE[-1], bonus_u=u,
                                   initial_state=s0)
    np.testing.assert_allclose(got[0].numpy(), y, **SSM_TOL)
    np.testing.assert_allclose(got[1].numpy(), s, **SSM_TOL)
    seq = ref.ssm_scan_ref(q, k, v, w, bonus_u=u, initial_state=s0)
    for a, b in zip(got, seq):
        torch.testing.assert_close(a, b, **SSM_TOL)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_scan_bwd_matches_jax_vjp(case):
    """``ref.ssm_scan_bwd`` with cotangents on y and on the final state
    against ``jax.vjp`` of the reference's ``chunked_linear_attn``: every
    input's gradient within 1e-4 of its max |g|."""
    tx, (dy, ds), _, want = reference(case)
    got = ref.ssm_scan_bwd(torch.tensor(dy), torch.tensor(ds), *tx,
                           chunk=SHAPE[-1])
    assert_grads(got, want)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_ops_scan_is_differentiable(case):
    """``ops.ssm_scan`` on inputs that require grad: the forward is the
    plain sequential version's bit for bit (the same call as without
    grad), and autograd's gradients of <y, dy> + <S, dS> are the
    reference's VJP."""
    tx, (dy, ds), _, want = reference(case)
    leaves = [None if x is None else x.clone().requires_grad_()
              for x in tx]
    q, k, v, w, u, s0 = leaves
    y, s = ops.ssm_scan(q, k, v, w, u, chunk=SHAPE[-1], initial_state=s0)
    with torch.no_grad():
        plain = ops.ssm_scan(*tx[:5], chunk=SHAPE[-1], initial_state=tx[5])
    assert torch.equal(y, plain[0]) and torch.equal(s, plain[1])
    assert y.grad_fn is not None and s.grad_fn is not None
    ((y * torch.tensor(dy)).sum() + (s * torch.tensor(ds)).sum()).backward()
    assert_grads([None if x is None else x.grad for x in leaves], want)


@pytest.mark.parametrize("rwkv", [False, True], ids=["mamba", "rwkv"])
def test_a_missing_cotangent_is_zero(rwkv):
    """A loss of y alone (the training step's) or of the final state alone
    gives the VJP with the other cotangent zero (autograd hands the
    Function None for it)."""
    tx, (dy, ds), _, _ = reference((rwkv, True, "slow"))
    dy, ds = torch.tensor(dy), torch.tensor(ds)
    for use_y in (True, False):
        leaves = [None if x is None else x.clone().requires_grad_()
                  for x in tx]
        y, s = ops.ssm_scan(*leaves[:5], chunk=SHAPE[-1],
                            initial_state=leaves[5])
        ((y * dy).sum() if use_y else (s * ds).sum()).backward()
        cot = (dy, torch.zeros_like(ds)) if use_y \
            else (torch.zeros_like(dy), ds)
        want = ref.ssm_scan_bwd(*cot, *tx, chunk=SHAPE[-1])
        for name, x, w in zip(NAMES, leaves, want):
            if x is not None:
                torch.testing.assert_close(x.grad, w, rtol=1e-6, atol=1e-6,
                                           msg=name)


def test_scan_bwd_needs_dtypes_and_broadcast_views():
    """Gradients come back in each input's dtype (bf16 q, k, v; float32
    log_w), None where ``needs`` is False; Mamba-2's q and k, views
    broadcast over the heads, get the sum over the heads."""
    b, t, h, n, dv = 2, 32, 3, 16, 8
    rng = np.random.default_rng(3)
    c_src = torch.tensor(rng.standard_normal((b, t, 1, n)), dtype=torch.float32)
    b_src = torch.tensor(rng.standard_normal((b, t, 1, n)), dtype=torch.float32)
    v = torch.tensor(rng.standard_normal((b, t, h, dv)), dtype=torch.float32)
    w = torch.tensor(-np.exp(0.5 * rng.standard_normal((b, t, h, n))),
                     dtype=torch.float32)
    dy = torch.tensor(rng.standard_normal((b, t, h, dv)), dtype=torch.float32)
    leaves = [x.clone().requires_grad_() for x in (c_src, b_src, v, w)]
    q, k = (x.expand(b, t, h, n) for x in leaves[:2])
    y, _ = ops.ssm_scan(q, k, leaves[2], leaves[3], chunk=16)
    (y * dy).sum().backward()
    full = ref.ssm_scan_bwd(dy, None, c_src.expand(b, t, h, n).contiguous(),
                            b_src.expand(b, t, h, n).contiguous(), v, w,
                            None, None, chunk=16)
    for x, g in zip(leaves, full):
        want = g.sum(2, keepdim=True) if x.shape[2] == 1 else g
        torch.testing.assert_close(x.grad, want, rtol=1e-5, atol=1e-5)
    # bf16 inputs, float32 decays; only some inputs need a gradient
    bf = [x.to(torch.bfloat16) for x in (q.detach(), k.detach(), v)]
    got = ref.ssm_scan_bwd(dy.bfloat16(), None, *bf, w, None, None,
                           chunk=16, needs=(True, False, True, True, False,
                                            False))
    assert [None if g is None else g.dtype for g in got] == [
        torch.bfloat16, None, torch.bfloat16, torch.float32, None, None]


def test_chunked_ref_refuses_a_chunk_that_does_not_divide():
    q = torch.zeros(1, 24, 1, 8)
    with pytest.raises(ValueError, match="divide"):
        ref.ssm_scan_chunked_ref(q, q, q, q, chunk=16)
