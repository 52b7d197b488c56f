from repro_torch.ft.checkpoint import (checkpoint_step, restore_checkpoint,
                                       restore_serving_extra,
                                       restore_serving_state, save_checkpoint,
                                       save_serving_state)
from repro_torch.ft.elastic import ElasticController
from repro_torch.ft.faults import FaultEvent, FaultInjector, FaultPlan
from repro_torch.ft.health import EngineHealthMonitor, HealthConfig

__all__ = ["checkpoint_step", "restore_checkpoint", "restore_serving_extra",
           "restore_serving_state", "save_checkpoint", "save_serving_state",
           "ElasticController", "EngineHealthMonitor", "HealthConfig",
           "FaultEvent", "FaultInjector", "FaultPlan"]
