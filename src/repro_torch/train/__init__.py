"""LM inference steps, agent and population checkpoints (the LM training
half of ``repro.train`` is not ported)."""
from repro_torch.train.checkpoint import (restore_agent_state,
                                          restore_checkpoint,
                                          restore_population,
                                          save_agent_state, save_checkpoint,
                                          save_population)
from repro_torch.train.steps import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step", "restore_agent_state",
           "restore_checkpoint", "restore_population", "save_agent_state",
           "save_checkpoint", "save_population"]
