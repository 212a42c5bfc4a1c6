"""StableLM-2 dense decoder [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, d_ff=6912, vocab=50304,
    attn_kind="gqa", n_heads=32, n_kv_heads=32,
)
