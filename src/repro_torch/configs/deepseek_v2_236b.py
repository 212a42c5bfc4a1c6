"""DeepSeek-V2-236B: MLA (kv_lora=512) + 2 shared + 160 routed top-6
[arXiv:2405.04434]."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, d_ff=1536, vocab=102400,
    attn_kind="mla", n_heads=128,
    kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
    n_experts=160, n_shared_experts=2, top_k=6, moe_d_ff=1536,
    fsdp=True,
)
