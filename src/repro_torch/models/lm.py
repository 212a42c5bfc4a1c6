"""Model assembly: decoder LMs of every family and the Whisper enc-dec.

Counterpart of ``repro/models/lm.py`` (``DecoderLM``, ``EncDecLM``,
``build_plan``, ``n_shared_applications``, ``model_for``). Layers are
stacked on a leading axis (``params["blocks"]`` as ``DecoderLM.init``
builds it in the reference), so a JAX param tree maps over 1:1; a Python
loop over the layers takes the place of ``lax.scan``. A layer's cache is
its block's NamedTuple (``GQACache``, ``MLACache``, ``RWKVState`` or
``MambaState``), stacked field by field. ``serve_step(..., exit_layer=e)``
runs the first ``e`` layers and reads logits through exit ``e``'s norm
and the shared LM head — the paper's early-exit dial that GRLE's
scheduler turns. Zamba2's shared attention block (one set of weights
applied every ``shared_attn_every`` layers) keeps one KV cache per
application (``cache["shared"]``, stacked). ``EncDecLM`` runs Whisper: an
encoder over precomputed frame embeddings, then the decoder with
cross-attention to its output, which the serving cache carries as
``enc_out``. ``forward_train`` returns the normed hidden state at every
exit for the training loss; with ``cfg.remat`` and grad enabled each
layer runs under ``torch.utils.checkpoint`` (non-reentrant), the
counterpart of the reference's ``jax.checkpoint`` around its scan body:
the backward recomputes the layer's forward (its attention kernel
launches again).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.blocks import (BLOCK_BY_KIND, ZERO_AUX, AttnBlock,
                                       BlockAux, EncDecBlock, EncoderBlock,
                                       add_aux, block_kind)
from repro_torch.models.config import ArchConfig
from repro_torch.nn import Embedding, Linear, RMSNorm
from repro_torch.nn.initializers import (normal_init, ones_init,
                                         xavier_uniform, zeros_init)


# ------------------------------------------------------------- layer schedule
def build_plan(cfg: ArchConfig, up_to_exit: Optional[int] = None):
    """Ordered events: ('layers', a, b) | ('shared', idx) | ('exit', layer)."""
    n = cfg.n_layers
    every = cfg.shared_attn_every
    shared_marks = set(range(every, n + 1, every)) if every else set()
    exit_marks = set(cfg.exit_layers)
    events = []
    last = 0
    shared_idx = 0
    for m in sorted(shared_marks | exit_marks):
        if m > last:
            events.append(("layers", last, m))
            last = m
        if m in shared_marks:
            events.append(("shared", shared_idx))
            shared_idx += 1
        if m in exit_marks:
            events.append(("exit", m))
            if up_to_exit is not None and m == up_to_exit:
                return events
    if last < n:
        events.append(("layers", last, n))
    return events


def n_shared_applications(cfg: ArchConfig) -> int:
    every = cfg.shared_attn_every
    return len(range(every, cfg.n_layers + 1, every)) if every else 0


def _layer(tree, i: int):
    """Layer ``i``'s slice of a stacked param or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_layer(v, i) for v in tree))
    return tree[i]


def _stack_shapes(tree, n: int):
    """A param-shape tree with a leading axis of ``n`` on every leaf."""
    if isinstance(tree, dict):
        return {k: _stack_shapes(v, n) for k, v in tree.items()}
    return (n, *tree)


def _dtypes(shapes: dict, cfg: ArchConfig, float32_leaves) -> dict:
    """``cfg.torch_dtype`` for every leaf of ``shapes``, float32 for a leaf
    whose path ends in one of ``float32_leaves`` (``w0``, ``router/w``)."""

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in tree.items()}
        f32 = any(path.endswith("/" + tail) for tail in float32_leaves)
        return torch.float32 if f32 else cfg.torch_dtype

    return walk(shapes, "")


# leaves drawn N(0, 0.02), as the reference's normal_init does
_NORMAL_LEAVES = frozenset({"table", "mix", "lora_a", "lora_b", "bonus_u",
                            "cm_mix", "w_uk", "w_uv"})
# other scales of the reference's normal_init: Mamba-2's conv and decay
_NORMAL_SCALE = {"conv_w": 0.5, "a_log": 0.1}
_ZERO_LEAVES = frozenset({"b", "w0", "conv_b", "dt_bias"})


def _init_leaf(generator, name: str, shape, *, device, dtype):
    if name in _NORMAL_LEAVES:
        return normal_init(generator, shape, device=device, dtype=dtype)
    if name in _NORMAL_SCALE:
        return normal_init(generator, shape, device=device, dtype=dtype,
                           scale=_NORMAL_SCALE[name])
    if name in ("w1", "w2", "w3"):
        # MoE experts [..., e, in, out]: std 1/sqrt(in), as the reference;
        # drawn a leading slice at a time, so that the float32 draw of a
        # layer stack (~21 GB for DeepSeek-MoE-16B's w1) never materializes
        out = torch.empty(shape, device=device, dtype=dtype)
        for i in range(shape[0]):
            out[i] = normal_init(generator, shape[1:], device=device,
                                 dtype=dtype,
                                 scale=1.0 / math.sqrt(shape[-2]))
        return out
    if name == "scale":
        return ones_init(generator, shape, device=device, dtype=dtype)
    if name in _ZERO_LEAVES:
        return zeros_init(generator, shape, device=device, dtype=dtype)
    if name != "w":
        raise ValueError(f"no initializer for param leaf {name!r}")
    # "w": Xavier-uniform per [in, out] matrix, also inside a layer stack,
    # each float32 draw cast into its slice of the leaf, so that init peaks
    # at the params plus one matrix's draw (Chameleon-34B's 68.6 GB of
    # bf16 params on an 80 GB card)
    if math.prod(shape[:-2]) == 1:
        return _staged_matrix(generator, shape, device=device, dtype=dtype)
    out = torch.empty(shape, device=device, dtype=dtype)
    for mat in out.view(-1, *shape[-2:]):
        mat.copy_(xavier_uniform(generator, shape[-2:], device=device))
    return out


_STAGE_BYTES = 64 << 20


def _staged_matrix(generator, shape, *, device, dtype):
    """One unstacked Xavier matrix, cast on its device a block of rows at a
    time into host memory and copied back once its float32 draw is freed,
    so that on the card the draw and the leaf never share the device: the
    LM head is drawn last, when every other leaf is in place, and its draw
    is twice the leaf (2.1 GB for Chameleon-34B's 1.1 GB head). On the CPU
    the copy back is a no-op. Bit for bit the cast of the draw."""
    draw = xavier_uniform(generator, shape, device=device)
    host = torch.empty(shape, dtype=dtype)
    rows = max(1, _STAGE_BYTES // (4 * math.prod(shape[1:])))
    for i in range(0, shape[0], rows):
        host[i:i + rows] = draw[i:i + rows].to(dtype).cpu()
    del draw
    return host.to(device)


def _init_tree(generator, shapes: dict, dtypes: dict, device) -> dict:
    def build(tree, dt, name=""):
        if isinstance(tree, dict):
            return {k: build(v, dt[k], k) for k, v in tree.items()}
        return _init_leaf(generator, name, tree, device=device, dtype=dt)

    return build(shapes, dtypes)


def _stack(items):
    """Stack a list of per-layer cache NamedTuples field by field."""
    return type(items[0])(*(torch.stack(f) for f in zip(*items)))


def _repeat(one, n: int):
    """A cache NamedTuple with each field repeated on a new leading axis."""
    return type(one)(*(a.unsqueeze(0).repeat(n, *([1] * a.dim()))
                       for a in one))


def _as_aux(aux: BlockAux, device) -> BlockAux:
    return BlockAux(*(torch.as_tensor(a, dtype=torch.float32, device=device)
                      for a in aux))


def _train_layer(apply_dense, layer_params, cfg: ArchConfig, x, *extra):
    """One layer's dense pass for training -> (x, aux); under
    ``torch.utils.checkpoint`` when ``cfg.remat`` and grad is enabled."""

    def run(h):
        h, _, aux = apply_dense(layer_params, cfg, h, *extra)
        return h, aux

    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(run, x, use_reentrant=False)
    return run(x)


def _write_back(old, new) -> None:
    """Copy a block's returned cache fields into its layer's slice where
    the block returned new tensors (the in-place ones are the slice)."""
    for o, u in zip(old, new):
        if u is not o:
            o.copy_(u)


# ---------------------------------------------------------------- decoder LM
class DecoderLM:
    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        """The param tree's names and shapes, in the reference's layout:
        ``blocks`` leaves carry a leading ``n_layers`` axis and
        ``exit_norms`` one of ``max(len(exit_layers), 1)``; Zamba2's
        ``shared_block`` is one ``AttnBlock``, not stacked."""
        block = BLOCK_BY_KIND[block_kind(cfg)]
        n_exits = max(len(cfg.exit_layers), 1)
        shapes = {
            "embed": {"table": (cfg.vocab, cfg.d_model)},
            "blocks": _stack_shapes(block.param_shapes(cfg), cfg.n_layers),
            "final_norm": {"scale": (cfg.d_model,)},
            "lm_head": {"w": (cfg.d_model, cfg.vocab)},
            "exit_norms": {"scale": (n_exits, cfg.d_model)},
        }
        if cfg.shared_attn_every:
            shapes["shared_block"] = AttnBlock.param_shapes(cfg)
        return shapes

    @staticmethod
    def param_dtypes(cfg: ArchConfig) -> dict:
        """The param tree's leaf dtypes: ``cfg.torch_dtype``, except the
        blocks' ``FLOAT32_LEAVES`` (RWKV-6's ``w0`` and ``bonus_u``,
        Mamba-2's ``a_log`` and ``dt_bias``, the MoE's ``router/w``), which
        are float32 in any model, as in the reference."""
        f32 = BLOCK_BY_KIND[block_kind(cfg)].FLOAT32_LEAVES
        if cfg.shared_attn_every:
            f32 = f32 | AttnBlock.FLOAT32_LEAVES
        return _dtypes(DecoderLM.param_shapes(cfg), cfg, f32)

    @staticmethod
    def init(generator: torch.Generator, cfg: ArchConfig, *, device=None):
        """Random params from ``generator`` in ``param_dtypes(cfg)`` (the
        reference's distributions: Xavier-uniform weights, zero biases,
        ``w0``, ``conv_b`` and ``dt_bias``, N(0, 0.02) embedding, RWKV
        mixes, LoRAs, bonus and MLA's up-projections; normal experts with std
        1/sqrt(in), Mamba conv with std 0.5 and ``a_log`` with std 0.1;
        unit norm scales), on the card unless ``device="cpu"``."""
        return _init_tree(generator, DecoderLM.param_shapes(cfg),
                          DecoderLM.param_dtypes(cfg),
                          resolve_device(device))

    @staticmethod
    def _exit_head(params, cfg: ArchConfig, x, exit_pos: int):
        idx = cfg.exit_layers.index(exit_pos)
        norm = {"scale": params["exit_norms"]["scale"][idx]}
        return RMSNorm.apply(norm, x, eps=cfg.norm_eps)

    @staticmethod
    def _head(params, cfg: ArchConfig, x, exit_layer: int):
        """The normed hidden read at ``exit_layer``: the final norm at the
        last layer, else that exit's norm."""
        if exit_layer == cfg.n_layers:
            return RMSNorm.apply(params["final_norm"], x, eps=cfg.norm_eps)
        return DecoderLM._exit_head(params, cfg, x, exit_layer)

    @staticmethod
    def logits(params, hidden):
        return Linear.apply(params["lm_head"], hidden)

    # ------------------------------------------------------------- training
    @staticmethod
    def forward_train(params, cfg: ArchConfig, tokens):
        """tokens [B, S] -> ({exit_layer: normed hidden [B,S,D]}, aux).

        The ``build_plan`` events in order: the layers (each checkpointed
        under ``cfg.remat``), Zamba2's shared block, and at each exit the
        hidden through that exit's norm (the final norm at the last
        layer, which is always present). Hidden states, not logits: the
        loss computes chunked CE against the shared LM head. ``aux`` sums
        the MoE's load-balance loss and dropped fraction over the layers
        and the shared block's applications, as float32 tensors.
        """
        block = BLOCK_BY_KIND[block_kind(cfg)]
        x = Embedding.apply(params["embed"], tokens)
        aux, hiddens = ZERO_AUX, {}
        for ev in build_plan(cfg):
            if ev[0] == "layers":
                for i in range(ev[1], ev[2]):
                    x, a = _train_layer(block.apply_dense,
                                        _layer(params["blocks"], i), cfg, x)
                    aux = add_aux(aux, a)
            elif ev[0] == "shared":
                x, _, a = AttnBlock.apply_dense(params["shared_block"], cfg,
                                                x)
                aux = add_aux(aux, a)
            else:
                hiddens[ev[1]] = DecoderLM._head(params, cfg, x, ev[1])
        if cfg.n_layers not in hiddens:
            hiddens[cfg.n_layers] = RMSNorm.apply(params["final_norm"], x,
                                                  eps=cfg.norm_eps)
        return hiddens, _as_aux(aux, x.device)

    # ----------------------------------------------------------------- cache
    @staticmethod
    def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, device=None,
                   dtype=None):
        """Zeroed per-layer caches, stacked: ``{"layers": cache}`` with each
        field of the block's cache NamedTuple on a leading ``n_layers``
        axis — ``GQACache`` k, v [n_layers, B, seq_len, KVH, hd] (under a
        window a ring of min(seq_len, window) rows),
        ``MLACache`` c_kv [n_layers, B, seq_len, r] and k_pe, ``RWKVState``
        or ``MambaState`` (no ``seq_len`` axis); with a shared block also
        ``"shared"``, one ``GQACache`` per application on a leading axis."""
        device = resolve_device(device)
        block = BLOCK_BY_KIND[block_kind(cfg)]
        cache = {"layers": _repeat(block.init_cache(
            cfg, batch, seq_len, device=device, dtype=dtype), cfg.n_layers)}
        n_sh = n_shared_applications(cfg)
        if n_sh:
            cache["shared"] = _repeat(AttnBlock.init_cache(
                cfg, batch, seq_len, device=device, dtype=dtype), n_sh)
        return cache

    # --------------------------------------------------------------- prefill
    @staticmethod
    def prefill(params, cfg: ArchConfig, tokens):
        """tokens [B, S] -> (final-normed hidden [B,S,D], cache, aux): the
        caches stacked as ``init_cache`` lays them out — the K/V (or MLA
        latents) of each layer's ln1 output over the S tokens (see
        ``models/blocks.py``; under a window GQA's K/V as the
        ``window``-row ring that ``serve_step`` continues,
        ``models/attention.py::ring_rows``), or each layer's recurrent
        state after them;
        the shared block's K/V per application — and the MoE's load-balance
        loss and dropped fraction summed over the layers (the shared
        block's not counted, as in the reference)."""
        block = BLOCK_BY_KIND[block_kind(cfg)]
        x = Embedding.apply(params["embed"], tokens)
        caches, shared, aux = [], [], ZERO_AUX
        for ev in build_plan(cfg):
            if ev[0] == "shared":
                x, c, _ = AttnBlock.apply_dense(params["shared_block"], cfg,
                                                x, want_cache=True)
                shared.append(c)
                continue
            if ev[0] != "layers":
                continue
            for i in range(ev[1], ev[2]):
                x, c, a = block.apply_dense(_layer(params["blocks"], i), cfg,
                                            x, want_cache=True)
                caches.append(c)
                aux = add_aux(aux, a)
        h = RMSNorm.apply(params["final_norm"], x, eps=cfg.norm_eps)
        cache = {"layers": _stack(caches)}
        if shared:
            cache["shared"] = _stack(shared)
        return h, cache, _as_aux(aux, x.device)

    # ---------------------------------------------------------------- decode
    @staticmethod
    def serve_step(params, cfg: ArchConfig, tokens, cache, pos, *,
                   exit_layer: Optional[int] = None):
        """One decode step. tokens [B], pos [B] -> (logits [B, V], cache).

        ``exit_layer`` runs the first ``exit_layer`` layers only (the
        early-exit serving path), with the shared block's applications
        among them; the deeper layers' caches are left untouched. The
        layers that run update ``cache`` in place (a block that returns new
        state tensors has them copied into its layer's slice), and the
        returned cache is the same tensors.
        """
        exit_layer = exit_layer or cfg.n_layers
        block = BLOCK_BY_KIND[block_kind(cfg)]
        x = Embedding.apply(params["embed"], tokens[:, None])
        for ev in build_plan(cfg, up_to_exit=exit_layer):
            if ev[0] == "shared":
                sh = _layer(cache["shared"], ev[1])
                x, new, _ = AttnBlock.apply_decode(params["shared_block"],
                                                   cfg, x, sh, pos)
                _write_back(sh, new)
                continue
            if ev[0] == "exit":
                if ev[1] == exit_layer:     # requested exit reached
                    break
                continue                    # intermediate exits pass through
            for i in range(ev[1], ev[2]):
                layer_cache = _layer(cache["layers"], i)
                x, new, _ = block.apply_decode(_layer(params["blocks"], i),
                                               cfg, x, layer_cache, pos)
                _write_back(layer_cache, new)
        h = DecoderLM._head(params, cfg, x, exit_layer)
        return DecoderLM.logits(params, h)[:, 0], cache


# -------------------------------------------------------------- Whisper-style
class EncDecLM:
    """Encoder-decoder over precomputed audio-frame embeddings (the
    frontend is a stub, as in the reference: [B, frames, d] comes in)."""

    @staticmethod
    def param_shapes(cfg: ArchConfig) -> dict:
        """``encoder`` (``EncoderBlock`` leaves on a leading
        ``enc_layers`` axis), ``enc_norm``, and ``decoder``, a
        ``DecoderLM`` tree of ``EncDecBlock`` layers."""
        return {"encoder": _stack_shapes(EncoderBlock.param_shapes(cfg),
                                         cfg.enc_layers),
                "enc_norm": {"scale": (cfg.d_model,)},
                "decoder": DecoderLM.param_shapes(cfg)}

    @staticmethod
    def param_dtypes(cfg: ArchConfig) -> dict:
        return _dtypes(EncDecLM.param_shapes(cfg), cfg,
                       EncDecBlock.FLOAT32_LEAVES)

    @staticmethod
    def init(generator: torch.Generator, cfg: ArchConfig, *, device=None):
        """Random params from ``generator``, as ``DecoderLM.init`` draws
        them, on the card unless ``device="cpu"``."""
        return _init_tree(generator, EncDecLM.param_shapes(cfg),
                          EncDecLM.param_dtypes(cfg), resolve_device(device))

    @staticmethod
    def encode(params, cfg: ArchConfig, audio_embeds):
        """audio_embeds [B, frames, d] -> the encoder's normed output (each
        layer checkpointed under ``cfg.remat`` with grad enabled)."""

        def layer(p, cfg, h):
            return EncoderBlock.apply(p, cfg, h), None, ZERO_AUX

        x = audio_embeds
        for i in range(cfg.enc_layers):
            x, _ = _train_layer(layer, _layer(params["encoder"], i), cfg, x)
        return RMSNorm.apply(params["enc_norm"], x, eps=cfg.norm_eps)

    @staticmethod
    def _decode_dense(dparams, cfg: ArchConfig, tokens, enc_out):
        """tokens [B, S] against enc_out -> ({exit layer: normed hidden
        [B,S,d]}, aux) at every exit (and the last layer); each layer
        checkpointed under ``cfg.remat`` with grad enabled."""
        x = Embedding.apply(dparams["embed"], tokens)
        aux, hiddens, last = ZERO_AUX, {}, 0
        exits = list(cfg.exit_layers)
        if cfg.n_layers not in exits:
            exits.append(cfg.n_layers)
        for e in exits:
            for i in range(last, e):
                x, a = _train_layer(EncDecBlock.apply_dense,
                                    _layer(dparams["blocks"], i), cfg, x,
                                    enc_out)
                aux = add_aux(aux, a)
            last = e
            hiddens[e] = DecoderLM._head(dparams, cfg, x, e)
        return hiddens, _as_aux(aux, x.device)

    @staticmethod
    def forward_train(params, cfg: ArchConfig, audio_embeds, tokens):
        """audio_embeds [B, frames, d], tokens [B, S] -> ({exit layer:
        normed hidden}, aux): the encoder, then the decoder's dense pass
        against its output."""
        enc_out = EncDecLM.encode(params, cfg, audio_embeds)
        return EncDecLM._decode_dense(params["decoder"], cfg, tokens, enc_out)

    @staticmethod
    def init_cache(cfg: ArchConfig, batch: int, seq_len: int, *, device=None,
                   dtype=None):
        """``{"layers": GQACache}`` of the decoder's self-attention,
        stacked, and ``"enc_out"`` zeros [B, n_audio_frames, d] (the
        reference's serving path decodes against them)."""
        device = resolve_device(device)
        one = EncDecBlock.init_cache(cfg, batch, seq_len, device=device,
                                     dtype=dtype)
        return {"layers": _repeat(one, cfg.n_layers),
                "enc_out": torch.zeros(
                    (batch, cfg.n_audio_frames, cfg.d_model),
                    dtype=dtype or cfg.torch_dtype, device=device)}

    @staticmethod
    def serve_step(params, cfg: ArchConfig, tokens, cache, pos, *,
                   exit_layer: Optional[int] = None):
        """One decode step of the decoder against ``cache["enc_out"]``:
        tokens [B], pos [B] -> (logits [B, V], cache), the first
        ``exit_layer`` layers' self-attention caches updated in place."""
        exit_layer = exit_layer or cfg.n_layers
        dparams = params["decoder"]
        enc_out = cache["enc_out"]
        x = Embedding.apply(dparams["embed"], tokens[:, None])
        for i in range(exit_layer):
            layer_cache = _layer(cache["layers"], i)
            x, new, _ = EncDecBlock.apply_decode(
                _layer(dparams["blocks"], i), cfg, x, layer_cache, pos,
                enc_out)
            _write_back(layer_cache, new)
        h = DecoderLM._head(dparams, cfg, x, exit_layer)
        return DecoderLM.logits(dparams, h)[:, 0], cache


def model_for(cfg: ArchConfig):
    """``EncDecLM`` for a config with an encoder, else ``DecoderLM``."""
    return EncDecLM if cfg.enc_layers else DecoderLM
