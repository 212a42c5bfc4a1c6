"""Dynamic MEC environment (paper §III), PyTorch port."""
from repro_torch.mec.config import MECConfig, ScenarioParams
from repro_torch.mec.env import (MECEnv, MECState, SlotResult, SlotTasks,
                                 assemble_slot)
from repro_torch.mec.profiles import (CANDIDATE_EXITS, VGG16_TABLE_I,
                                      exit_profile_gpu)
from repro_torch.mec.scenarios import PAPER_FIGURES, SCENARIOS, make_scenario

__all__ = [
    "MECConfig", "ScenarioParams", "MECEnv", "MECState", "SlotResult",
    "SlotTasks", "assemble_slot", "CANDIDATE_EXITS", "VGG16_TABLE_I",
    "exit_profile_gpu", "PAPER_FIGURES", "SCENARIOS", "make_scenario",
]
