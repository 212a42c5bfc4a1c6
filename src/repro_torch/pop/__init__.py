"""Population-scale training (PyTorch port of ``repro.pop``): agent
populations over a scenario curriculum, with PBT exploit/explore as
surgery on stacked leaves.

* ``population`` — the ``Population`` (stacked ``AgentState`` on a
  leading P axis + per-member hyperparameters as *state data*) and the
  ``PopulationDriver`` that runs one generation for all members through
  one driver's captured graphs;
* ``pbt`` — truncation-select exploit/explore as gathers and ``where``s
  on the member axis;
* ``curriculum`` — auto-curriculum over a ``ScenarioSpace``
  (``uniform=True`` is the domain-randomized control arm);
* ``trainer`` — the generation loop, with bit-exact checkpoint/resume,
  telemetry and run-history records.
"""
from repro_torch.pop.curriculum import Curriculum, CurriculumState
from repro_torch.pop.pbt import PBTConfig, PBTStats, pbt_update
from repro_torch.pop.population import (MemberHypers, Population,
                                        PopulationDriver, default_hypers,
                                        exit_mask_from_tau, init_population,
                                        sample_hypers)
from repro_torch.pop.trainer import (PopTrainState, PopulationTrainer,
                                     compare_curriculum_dr, format_comparison)

__all__ = [
    "MemberHypers", "Population", "PopulationDriver", "init_population",
    "default_hypers", "sample_hypers", "exit_mask_from_tau",
    "PBTConfig", "PBTStats", "pbt_update",
    "Curriculum", "CurriculumState",
    "PopulationTrainer", "PopTrainState", "compare_curriculum_dr",
    "format_comparison",
]
