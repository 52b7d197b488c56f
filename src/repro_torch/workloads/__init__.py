from repro_torch.workloads.burstgpt import (DISTRIBUTIONS, generate_trace,
                                      length_cdf)
from repro_torch.workloads.scenarios import (SCENARIOS, LoadShape, Scenario,
                                       build_real_slice,
                                       check_scenario_invariants,
                                       get_scenario, register_scenario,
                                       retime_arrivals, run_scenario)
from repro_torch.workloads.sessions import (SessionConfig, generate_sessions,
                                      session_stats)

__all__ = ["DISTRIBUTIONS", "generate_trace", "length_cdf",
           "SCENARIOS", "LoadShape", "Scenario", "build_real_slice",
           "check_scenario_invariants", "get_scenario",
           "register_scenario", "retime_arrivals", "run_scenario",
           "SessionConfig", "generate_sessions", "session_stats"]
