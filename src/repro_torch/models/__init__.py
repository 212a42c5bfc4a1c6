"""Decoder LMs of the dense GQA families (PyTorch port of ``repro.models``)."""
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import DecoderLM, build_plan, model_for

__all__ = ["ArchConfig", "DecoderLM", "build_plan", "model_for"]
