from repro_torch.serving.costmodel import (CostModelConfig, EngineCostModel,
                                           SwapCostConfig, SwapCostModel)
from repro_torch.serving.kv_tier import (HostKVTier, SwapRecord,
                                         TieredSharedAllocator)
from repro_torch.serving.kvcache import BlockPool, SlotAllocator
from repro_torch.serving.paged import (GARBAGE_PAGE, PagedBlockAllocator,
                                       SharedPagedAllocator)
from repro_torch.serving.paged_engine import (PagedEngineConfig,
                                              PagedModelRunner,
                                              PagedRealEngine)
from repro_torch.serving.real_cluster import (RealClusterConfig,
                                              serve_real_cluster)
from repro_torch.serving.real_engine import RealModelEngine
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.simulator import SimResult
from repro_torch.serving.step_plan import (PlannerConfig, PrefillLane,
                                           StepPlan, StepPlanner,
                                           check_plan_invariants)

__all__ = ["CostModelConfig", "EngineCostModel", "SwapCostConfig",
           "SwapCostModel", "HostKVTier", "SwapRecord",
           "TieredSharedAllocator", "BlockPool", "SlotAllocator",
           "GARBAGE_PAGE", "PagedBlockAllocator", "SharedPagedAllocator",
           "PagedEngineConfig", "PagedModelRunner", "PagedRealEngine",
           "RealClusterConfig", "RealModelEngine", "serve_real_cluster",
           "SimResult",
           "Request", "RequestState", "PlannerConfig", "PrefillLane",
           "StepPlan", "StepPlanner", "check_plan_invariants"]
