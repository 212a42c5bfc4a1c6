"""LM inference steps and agent checkpoints (the LM training half of
``repro.train`` is not ported)."""
from repro_torch.train.checkpoint import (restore_agent_state,
                                          restore_checkpoint,
                                          save_agent_state, save_checkpoint)
from repro_torch.train.steps import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step", "restore_agent_state",
           "restore_checkpoint", "save_agent_state", "save_checkpoint"]
