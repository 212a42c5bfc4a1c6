"""Assigned architecture configs (a copy of ``repro/configs``).

Every entry cites its source (model card / paper) and matches the assigned
dimensions exactly. ``get_arch(id)`` returns the full ArchConfig;
``get_arch(id, reduced=True)`` returns the CPU smoke-test variant
(≤2 layers, d_model ≤ 512, ≤4 experts).
"""
from __future__ import annotations

import importlib

ARCH_IDS = (
    "stablelm_3b",
    "whisper_medium",
    "llama3_2_1b",
    "rwkv6_7b",
    "qwen1_5_0_5b",
    "deepseek_moe_16b",
    "zamba2_2_7b",
    "deepseek_v2_236b",
    "chameleon_34b",
    "internlm2_20b",
)

_ALIASES = {i.replace("_", "-"): i for i in ARCH_IDS}
_ALIASES.update({
    "stablelm-3b": "stablelm_3b",
    "whisper-medium": "whisper_medium",
    "llama3.2-1b": "llama3_2_1b",
    "rwkv6-7b": "rwkv6_7b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "zamba2-2.7b": "zamba2_2_7b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "chameleon-34b": "chameleon_34b",
    "internlm2-20b": "internlm2_20b",
})


def get_arch(arch_id: str, *, reduced: bool = False):
    name = _ALIASES.get(arch_id, arch_id)
    if name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    cfg = mod.CONFIG
    return cfg.reduced() if reduced else cfg
