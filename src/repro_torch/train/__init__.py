"""LM train, prefill and serve steps; LM, agent and population
checkpoints."""
from repro_torch.train.checkpoint import (restore_agent_state,
                                          restore_checkpoint,
                                          restore_lm_params,
                                          restore_population,
                                          save_agent_state, save_checkpoint,
                                          save_population)
from repro_torch.train.steps import (EXIT_WEIGHT, TrainState,
                                     chunked_ce_loss, make_loss_fn,
                                     make_prefill_step, make_serve_step,
                                     make_train_state, make_train_step,
                                     multi_exit_loss)

__all__ = ["EXIT_WEIGHT", "TrainState", "chunked_ce_loss", "make_loss_fn",
           "make_prefill_step", "make_serve_step", "make_train_state",
           "make_train_step", "multi_exit_loss", "restore_agent_state",
           "restore_checkpoint", "restore_lm_params", "restore_population",
           "save_agent_state", "save_checkpoint", "save_population"]
