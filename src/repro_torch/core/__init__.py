"""Actors (GCN, DROO's MLP), quantizers, replay rings and the agent API
(PyTorch port of ``repro.core``)."""
from repro_torch.core.bridge import (agent_state_from_numpy,
                                     agent_state_from_params,
                                     params_from_numpy)
from repro_torch.core.devreplay import (DeviceReplay, replay_add,
                                        replay_init, replay_sample)
from repro_torch.core.graph import MECGraph, build_graph, pad_graph
from repro_torch.core.policy import (METHOD_SPECS, AgentDef, AgentState,
                                     MLPActor, StepAux, actor_family,
                                     agent_def, init_params, make_exit_mask)
from repro_torch.core.quantize import (binary_order_preserving,
                                       max_candidates, one_hot_candidates)
from repro_torch.core.replay import ReplayBuffer
from repro_torch.core.agent import OffloadingAgent, make_agent

__all__ = [
    "agent_state_from_numpy", "agent_state_from_params", "params_from_numpy",
    "MECGraph", "build_graph", "pad_graph",
    "one_hot_candidates", "binary_order_preserving", "max_candidates",
    "ReplayBuffer",
    "DeviceReplay", "replay_init", "replay_add", "replay_sample",
    "AgentDef", "AgentState", "StepAux", "agent_def",
    "METHOD_SPECS", "actor_family", "init_params", "make_exit_mask",
    "MLPActor", "OffloadingAgent", "make_agent",
]
