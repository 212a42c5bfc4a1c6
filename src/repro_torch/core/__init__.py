"""GCN actor, quantizer and agent API, decision half (PyTorch port)."""
from repro_torch.core.bridge import agent_state_from_numpy, params_from_numpy
from repro_torch.core.graph import MECGraph, build_graph
from repro_torch.core.policy import (METHOD_SPECS, AgentDef, AgentState,
                                     agent_def, make_exit_mask)
from repro_torch.core.quantize import max_candidates, one_hot_candidates

__all__ = [
    "agent_state_from_numpy", "params_from_numpy", "MECGraph", "build_graph",
    "METHOD_SPECS", "AgentDef", "AgentState", "agent_def", "make_exit_mask",
    "max_candidates", "one_hot_candidates",
]
