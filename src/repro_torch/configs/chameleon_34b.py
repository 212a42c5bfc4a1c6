"""Chameleon-34B early-fusion VLM: VQ image tokens share the text vocab
[arXiv:2405.09818]. VQ tokenizer / vision encoder is a stub — input_specs()
provides interleaved token ids directly.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, d_ff=22016, vocab=65536,
    attn_kind="gqa", n_heads=64, n_kv_heads=8, frontend="vision",
    fsdp=True,
)
