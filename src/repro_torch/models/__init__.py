"""LMs of every family of the model zoo (PyTorch port of ``repro.models``)."""
from repro_torch.models.config import ArchConfig
from repro_torch.models.lm import DecoderLM, EncDecLM, build_plan, model_for

__all__ = ["ArchConfig", "DecoderLM", "EncDecLM", "build_plan", "model_for"]
