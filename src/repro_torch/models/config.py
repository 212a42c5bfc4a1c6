"""Architecture configuration shared by every assigned model family.

A copy of ``repro/models/config.py``: ``ArchConfig`` (fields, defaults,
``__post_init__`` and ``reduced``), with ``torch_dtype`` in place of
``jnp_dtype``, and the assigned input shapes ``ShapeSpec`` /
``INPUT_SHAPES``. Pure data: a config or shape built here equals the
reference's field by field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    d_ff: int
    vocab: int
    # attention
    attn_kind: str = "gqa"           # gqa | mla | none
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None     # sliding-window attention (decode + train)
    # MLA (DeepSeek-V2)
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128
    # MoE
    n_experts: int = 0               # routed experts
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden (fine-grained)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    first_dense_layers: int = 1      # DeepSeek keeps layer 0 dense
    # SSM
    ssm_kind: str = "none"           # none | rwkv6 | mamba2
    d_state: int = 64
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # hybrid (Zamba2): shared attention+MLP block applied every k layers
    shared_attn_every: int = 0
    # encoder-decoder (Whisper)
    enc_layers: int = 0
    n_audio_frames: int = 1500       # stub conv-frontend output length
    # multimodal stub (Chameleon): VQ image tokens share the text vocab
    frontend: str = "none"           # none | audio | vision
    # early exits (the paper's mechanism, lifted to transformers)
    exit_layers: Tuple[int, ...] = ()
    # numerics
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = True
    # distribution: shard params/optimizer over the data axis too (FSDP/ZeRO
    # in addition to tensor parallelism on the model axis)
    fsdp: bool = False

    def __post_init__(self):
        if self.attn_kind == "gqa" and self.n_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if not self.exit_layers and self.n_layers:
            # default: paper-style candidate exits at ~{1/4, 1/2, 3/4, 1}·L
            ls = sorted({max(1, self.n_layers // 4), self.n_layers // 2,
                         3 * self.n_layers // 4, self.n_layers})
            object.__setattr__(self, "exit_layers", tuple(ls))

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.dtype]

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def kv_head_dim(self) -> int:
        return self.head_dim

    def reduced(self, *, n_layers: int = 2, d_model: int = 256,
                d_ff: int = 512, vocab: int = 512, n_experts: int = 4,
                **over) -> "ArchConfig":
        """CPU-smoke-test variant of the same family (assignment spec)."""
        ch = dict(
            n_layers=n_layers, d_model=d_model, d_ff=d_ff, vocab=vocab,
            dtype="float32", remat=False, exit_layers=(),
        )
        if self.n_heads:
            heads = max(2, min(4, self.n_heads))
            kvh = max(1, min(heads, self.n_kv_heads))
            while heads % kvh:
                kvh -= 1
            ch.update(n_heads=heads, n_kv_heads=kvh, head_dim=d_model // heads)
        if self.attn_kind == "mla":
            ch.update(kv_lora_rank=64, rope_head_dim=16, nope_head_dim=32,
                      v_head_dim=32, head_dim=0)
        if self.is_moe:
            ch.update(n_experts=n_experts,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      top_k=min(self.top_k, 2), moe_d_ff=128)
        if self.ssm_kind != "none":
            ch.update(d_state=16, ssm_head_dim=32, ssm_chunk=32)
        if self.shared_attn_every:
            ch.update(shared_attn_every=2)
        if self.enc_layers:
            ch.update(enc_layers=2, n_audio_frames=16)
        ch.update(over)
        return dataclasses.replace(self, **ch)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape."""
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.mode == "decode"


INPUT_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
