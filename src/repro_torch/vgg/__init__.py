"""The paper's multi-exit VGG-16: model, two-stage training, exit profiling
(PyTorch port)."""
from repro_torch.vgg.model import N_EXITS, VGG16_STAGES, VGG16EE
from repro_torch.vgg.train import profile_exits, train_vgg_ee

__all__ = ["N_EXITS", "VGG16EE", "VGG16_STAGES", "profile_exits",
           "train_vgg_ee"]
