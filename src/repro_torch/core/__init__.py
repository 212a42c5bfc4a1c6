"""GCN actor, quantizer, replay ring and agent API (PyTorch port)."""
from repro_torch.core.bridge import (agent_state_from_numpy,
                                     agent_state_from_params,
                                     params_from_numpy)
from repro_torch.core.devreplay import (DeviceReplay, replay_add,
                                        replay_init, replay_sample)
from repro_torch.core.graph import MECGraph, build_graph
from repro_torch.core.policy import (METHOD_SPECS, AgentDef, AgentState,
                                     StepAux, agent_def, make_exit_mask)
from repro_torch.core.quantize import max_candidates, one_hot_candidates

__all__ = [
    "agent_state_from_numpy", "agent_state_from_params", "params_from_numpy",
    "DeviceReplay", "replay_add", "replay_init", "replay_sample",
    "MECGraph", "build_graph", "METHOD_SPECS", "AgentDef", "AgentState",
    "StepAux", "agent_def", "make_exit_mask", "max_candidates",
    "one_hot_candidates",
]
