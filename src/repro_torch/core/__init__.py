"""Gimbal core (copies of the reference's pure-numpy modules).

- traces:      async engine runtime-trace collection (§4.1)
- scheduler:   pressure-aware DP-engine selection, Algorithm 1 (§4.2-4.3)
- queue_policy: SJF-with-aging intra-engine ordering, Algorithm 2 (§4.4)
- profiler:    online B[l,e] / A[l,s,e] expert-traffic statistics (§5.1)
- placement:   source-aware greedy expert placement (§5.2-5.3)
- forecast:    online source→expert traffic forecasting + prefetch pricing
- minlp:       offline placement reference + (beta, gamma) calibration (§6)
- coordinator: the cross-level feedback loop (§3)
- metrics:     O(1)-memory streaming latency percentiles
"""
from repro_torch.core.coordinator import CoordinatorConfig, GimbalCoordinator
from repro_torch.core.forecast import (ExpertTrafficForecaster,
                                       ForecastConfig, PrefetchConfig,
                                       PrefetchCostModel)
from repro_torch.core.metrics import (P2Quantile, ReservoirQuantile,
                                      StreamingMetrics, StreamingStat,
                                      WindowedSeries, merged_quantile)
from repro_torch.core.minlp import (CalibrationResult, anneal_layer,
                                    brute_force_layer, calibrate,
                                    solve_reference)
from repro_torch.core.placement import (PlacementConfig, PlacementManager,
                                        assignment_to_permutation,
                                        default_distance_matrix,
                                        greedy_layer_placement,
                                        layer_objective,
                                        torus_distance_matrix,
                                        total_objective)
from repro_torch.core.profiler import ExpertProfiler
from repro_torch.core.queue_policy import (QueueConfig, order_queue,
                                           order_queue_fcfs)
from repro_torch.core.scheduler import (BaselineScheduler, GimbalScheduler,
                                        SchedulerConfig)
from repro_torch.core.traces import (EngineTrace, PrefixSummary,
                                     PrefixSummaryDelta, TraceTable,
                                     diff_prefix_summary)

__all__ = [
    "CoordinatorConfig", "GimbalCoordinator",
    "ExpertTrafficForecaster", "ForecastConfig",
    "PrefetchConfig", "PrefetchCostModel", "CalibrationResult",
    "anneal_layer", "brute_force_layer", "calibrate", "solve_reference",
    "PlacementConfig", "PlacementManager", "assignment_to_permutation",
    "default_distance_matrix", "greedy_layer_placement", "layer_objective",
    "torus_distance_matrix", "total_objective", "ExpertProfiler",
    "QueueConfig", "order_queue", "order_queue_fcfs", "BaselineScheduler",
    "GimbalScheduler", "SchedulerConfig", "EngineTrace", "PrefixSummary",
    "PrefixSummaryDelta", "diff_prefix_summary", "TraceTable",
    "P2Quantile", "ReservoirQuantile", "StreamingStat", "StreamingMetrics",
    "WindowedSeries", "merged_quantile",
]
