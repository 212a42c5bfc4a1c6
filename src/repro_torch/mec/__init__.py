"""Dynamic MEC environment (paper §III), PyTorch port."""
from repro_torch.mec.config import (PRIMITIVE_FIELDS, MECConfig,
                                    ScenarioParams, derive_params)
from repro_torch.mec.env import (MECEnv, MECState, SlotResult, SlotTasks,
                                 SlotUniforms, assemble_slot)
from repro_torch.mec.metrics import RunningMetrics
from repro_torch.mec.profiles import (CANDIDATE_EXITS, VGG16_TABLE_I,
                                      exit_profile_gpu,
                                      exit_profile_roofline,
                                      llm_exit_profile)
from repro_torch.mec.scenarios import (DYNAMIC_SCENARIOS, PAPER_FIGURES,
                                       SCENARIOS, ScenarioSpace, expand_grid,
                                       interpolate_params, make_scenario,
                                       scenario_params, scenario_space)

__all__ = [
    "MECConfig", "MECEnv", "MECState", "SlotTasks", "SlotResult",
    "SlotUniforms", "assemble_slot",
    "ScenarioParams", "PRIMITIVE_FIELDS", "derive_params",
    "VGG16_TABLE_I", "CANDIDATE_EXITS", "exit_profile_gpu",
    "exit_profile_roofline", "llm_exit_profile",
    "RunningMetrics", "make_scenario", "SCENARIOS",
    "PAPER_FIGURES", "DYNAMIC_SCENARIOS", "expand_grid",
    "ScenarioSpace", "scenario_space", "scenario_params",
    "interpolate_params",
]
