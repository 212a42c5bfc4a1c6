"""Whisper-medium enc-dec audio backbone [arXiv:2212.04356].

Conv/mel frontend is a stub: input_specs() provides precomputed frame
embeddings [B, 1500, d_model].
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-medium", family="audio",
    n_layers=24, d_model=1024, d_ff=4096, vocab=51865,
    attn_kind="gqa", n_heads=16, n_kv_heads=16,
    enc_layers=24, n_audio_frames=1500, frontend="audio",
)
