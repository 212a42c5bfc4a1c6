"""Dynamic MEC environment (paper §III), PyTorch port."""
from repro_torch.mec.config import MECConfig, ScenarioParams
from repro_torch.mec.env import (MECEnv, MECState, SlotResult, SlotTasks,
                                 SlotUniforms, assemble_slot)
from repro_torch.mec.metrics import RunningMetrics
from repro_torch.mec.profiles import (CANDIDATE_EXITS, VGG16_TABLE_I,
                                      exit_profile_gpu, llm_exit_profile)
from repro_torch.mec.scenarios import (DYNAMIC_SCENARIOS, PAPER_FIGURES,
                                       SCENARIOS, make_scenario)

__all__ = [
    "MECConfig", "ScenarioParams", "MECEnv", "MECState", "SlotResult",
    "SlotTasks", "SlotUniforms", "assemble_slot", "RunningMetrics",
    "CANDIDATE_EXITS", "VGG16_TABLE_I", "exit_profile_gpu",
    "llm_exit_profile", "DYNAMIC_SCENARIOS", "PAPER_FIGURES", "SCENARIOS",
    "make_scenario",
]
