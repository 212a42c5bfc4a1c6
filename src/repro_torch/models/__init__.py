"""LMs of every family of the model zoo (PyTorch port of ``repro.models``)."""
from repro_torch.models.config import INPUT_SHAPES, ArchConfig, ShapeSpec
from repro_torch.models.lm import DecoderLM, EncDecLM, build_plan, model_for

__all__ = ["ArchConfig", "ShapeSpec", "INPUT_SHAPES", "DecoderLM", "EncDecLM",
           "build_plan", "model_for"]
