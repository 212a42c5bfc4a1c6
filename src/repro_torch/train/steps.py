"""Train, prefill and serve steps of the LMs.

Counterpart of ``repro/train/steps.py``. PyTorch runs eagerly, so a step
is a plain function (no ``jit``).

* ``make_train_step``: multi-exit weighted CE (the paper's early-exit
  training objective lifted to LMs: main branch weight 1.0, earlier exits
  ``EXIT_WEIGHT``) plus the MoE load-balance loss, its gradients by
  autograd, and one optimizer step (AdamW by default). CE is computed in
  sequence chunks against the shared LM head, each chunk checkpointed, so
  [B, S, V] logits are never all held for the backward. It serves every
  config; RWKV-6 and Zamba2 (Mamba-2) train through the differentiable
  ``ops.ssm_scan`` (the kernel forward, the plain chunked form's VJP).
* ``make_serve_step``: one decode token against the cache, per exit.
* ``make_prefill_step``: full-sequence forward that fills the cache.

The prefill and serve steps run under ``torch.no_grad()``.

Each step also runs partitioned: given params (and batch, cache) as
DTensors placed under the partition rules (``sharding/partition.py``),
every operation runs on DTensors, DTensor's sharding propagation issuing
the collectives, and the kernels run per device through ``ops``'
``local_map``. The constants a model builds itself (rope tables,
positions, masks, the CE chunks' labels) enter as replicated
(``partitioned``: ``implicit_replication`` at the step's entry). On plain
tensors nothing changes.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import DecoderLM, EncDecLM, model_for
from repro_torch.nn import Linear
from repro_torch.nn.pytree import flatten_dict, unflatten_dict
from repro_torch.optim import adamw
from repro_torch.optim.optimizers import Optimizer, apply_updates
from repro_torch.sharding.runtime import take_last

EXIT_WEIGHT = 0.3   # weight of non-final exits in the training loss


def partitioned(*trees):
    """``implicit_replication()`` if any leaf of ``trees`` is a DTensor
    (a partitioned step: the tensors the step builds itself enter as
    replicated), else a context that does nothing."""
    from repro_torch.nn.pytree import tree_tensors

    if any(isinstance(x, DTensor) for t in trees for x in tree_tensors(t)):
        return implicit_replication()
    return contextlib.nullcontext()


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


def make_train_state(cfg: ArchConfig, generator: torch.Generator,
                     optimizer: Optional[Optimizer] = None, *, device=None,
                     params=None):
    """(TrainState, optimizer): params from ``model_for(cfg).init`` with
    ``generator`` on ``device`` (the card unless ``"cpu"``) unless
    ``params`` injects them, the optimizer's fresh state (``adamw(3e-4)``
    by default) and step 0."""
    opt = optimizer or adamw(3e-4)
    if params is None:
        params = model_for(cfg).init(generator, cfg, device=device)
    step = torch.zeros((), dtype=torch.int32,
                       device=next(iter(flatten_dict(params).values())).device)
    return TrainState(params, opt.init(params), step), opt


def _chunk_ce(head_params, h, lab):
    logits = Linear.apply(head_params, h).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = take_last(logits, lab)
    return torch.sum(logz - gold)


def chunked_ce_loss(head_params, hidden, labels, *, chunk: int = 2048):
    """Mean token CE of hidden [B,S,D] against labels [B,S] through the LM
    head (in the head's dtype, logits cast to float32), over sequence
    chunks of ``min(chunk, S)`` tokens, each checkpointed with grad
    enabled (as ``jax.checkpoint`` in the reference) so that one chunk's
    logits live at a time."""
    b, s, _ = hidden.shape
    c = min(chunk, s)
    assert s % c == 0
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, c):
        args = (head_params, hidden[:, i:i + c], labels[:, i:i + c])
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_ce, *args, use_reentrant=False)
        else:
            total = total + _chunk_ce(*args)
    return total / (b * s)


def multi_exit_loss(params, cfg: ArchConfig, exit_hiddens, labels,
                    head_params=None):
    """(weighted mean of the exits' CE: weight 1.0 at the last layer,
    ``EXIT_WEIGHT`` elsewhere; {exit: CE})."""
    head = head_params if head_params is not None else params["lm_head"]
    loss = torch.zeros((), dtype=torch.float32, device=labels.device)
    denom = 0.0
    per_exit = {}
    for e, h in exit_hiddens.items():
        w = 1.0 if e == cfg.n_layers else EXIT_WEIGHT
        ce = chunked_ce_loss(head, h, labels)
        per_exit[e] = ce
        loss = loss + w * ce
        denom += w
    return loss / denom, per_exit


def make_loss_fn(cfg: ArchConfig):
    """``loss_fn(params, batch) -> (loss, metrics)``: the multi-exit CE
    plus ``cfg.router_aux_coef`` times the MoE's load-balance loss;
    metrics ``ce_<exit>``, ``moe_aux`` and ``moe_dropped``. ``batch`` is
    ``{"tokens", "labels"}`` [B, S] (and ``"audio"`` [B, frames, d] for
    the encoder-decoder)."""
    model = model_for(cfg)

    def loss_fn(params, batch):
        if model is EncDecLM:
            hiddens, aux = model.forward_train(params, cfg, batch["audio"],
                                               batch["tokens"])
            head = params["decoder"]["lm_head"]
        else:
            hiddens, aux = model.forward_train(params, cfg, batch["tokens"])
            head = params["lm_head"]
        loss, per_exit = multi_exit_loss(params, cfg, hiddens,
                                         batch["labels"], head_params=head)
        loss = loss + cfg.router_aux_coef * aux.moe_aux
        metrics = {"ce_" + str(e): v for e, v in per_exit.items()}
        metrics["moe_aux"] = aux.moe_aux
        metrics["moe_dropped"] = aux.moe_dropped
        return loss, metrics

    return loss_fn


def make_train_step(cfg: ArchConfig, opt: Optimizer, *,
                    on_part: Optional[Callable[[str], None]] = None):
    """``train_step(state, batch) -> (state, metrics)``: the loss of
    ``make_loss_fn``, its gradients with respect to every param by
    autograd, ``opt``'s update applied. The new state holds new tensors
    (the old params are not modified); metrics are detached 0-d tensors:
    ``loss``, ``ce_<exit>``, ``moe_aux``, ``moe_dropped``. ``on_part``,
    if given, is called with ``"forward"``, ``"backward"`` and
    ``"optimizer"`` as each part of the step ends (a timing hook)."""
    loss_fn = make_loss_fn(cfg)
    mark = on_part or (lambda _: None)

    def train_step(state: TrainState, batch):
        with partitioned(state.params, batch):
            return _step(state, batch)

    def _step(state: TrainState, batch):
        flat = {k: v.detach().requires_grad_() for k, v
                in flatten_dict(state.params).items()}
        with torch.enable_grad():
            loss, metrics = loss_fn(unflatten_dict(flat), batch)
            mark("forward")
            grads = torch.autograd.grad(loss, list(flat.values()))
        mark("backward")
        with torch.no_grad():
            updates, opt_state = opt.update(
                unflatten_dict(dict(zip(flat, grads))), state.opt_state,
                state.params)
            params = apply_updates(state.params, updates)
        mark("optimizer")
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


def make_serve_step(cfg: ArchConfig, *, exit_layer: Optional[int] = None):
    """``serve_step(params, cache, tokens [B], pos [B]) -> (logits [B, V],
    cache)``, through the first ``exit_layer`` layers (all by default).
    The cache is updated in place and returned."""
    model = model_for(cfg)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        with partitioned(params, cache):
            return model.serve_step(params, cfg, tokens, cache, pos,
                                    exit_layer=exit_layer)

    return serve_step


def make_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, {"tokens": [B, S]}) -> (logits [B, V] at the
    last position, cache)``; the cache is each layer's K/V (GQA), latents
    (MLA) or recurrent state (RWKV-6, Mamba-2), and the shared block's
    K/V, as ``serve_step`` takes it. For the encoder-decoder,
    ``{"audio": [B, frames, d], "tokens": [B, S]}`` -> logits [B, V] only,
    as the reference returns: the encoder, then the decoder's dense pass."""
    model = model_for(cfg)

    @torch.no_grad()
    def prefill_step(params, batch):
        with partitioned(params, batch):
            return _prefill(params, batch)

    def _prefill(params, batch):
        if model is EncDecLM:
            enc_out = EncDecLM.encode(params, cfg, batch["audio"])
            hiddens, _ = EncDecLM._decode_dense(params["decoder"], cfg,
                                                batch["tokens"], enc_out)
            h = hiddens[cfg.n_layers]
            return DecoderLM.logits(params["decoder"], h[:, -1:])[:, 0]
        h, cache, _ = DecoderLM.prefill(params, cfg, batch["tokens"])
        return DecoderLM.logits(params, h[:, -1:])[:, 0], cache

    return prefill_step
