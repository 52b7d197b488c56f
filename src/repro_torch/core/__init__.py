"""Gimbal control-plane pieces the paged data plane needs (copies of the
reference's pure-Python modules): trace collection and queue ordering."""
from repro_torch.core.queue_policy import (QueueConfig, order_queue,
                                           order_queue_fcfs)
from repro_torch.core.traces import (EngineTrace, PrefixSummary,
                                     PrefixSummaryDelta, TraceTable,
                                     diff_prefix_summary)

__all__ = ["QueueConfig", "order_queue", "order_queue_fcfs", "EngineTrace",
           "PrefixSummary", "PrefixSummaryDelta", "TraceTable",
           "diff_prefix_summary"]
