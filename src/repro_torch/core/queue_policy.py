"""Intra-engine SJF-with-aging queue ordering (paper §4.4, Algorithm 2).

Prefill token count is the job-size proxy (known at arrival — no output
length prediction); requests waiting >= theta_age are promoted to high
priority to prevent starvation. Stable sort keeps FIFO order within ties.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence


@dataclasses.dataclass(frozen=True)
class QueueConfig:
    theta_age_s: float = 5.0   # paper §6: P99 TTFT under high load < 4.9s


def order_queue(waiting: Sequence, now: float,
                cfg: QueueConfig = QueueConfig()) -> List:
    """Algorithm 2. ``waiting`` items need .arrival_time and .prompt_len.

    Returns a new list: aged requests first (FIFO among themselves), then
    SJF by prefill length (FIFO tie-break). Priority ascending == earlier.
    """
    def priority(r):
        w = now - r.arrival_time
        if w >= cfg.theta_age_s:
            return (0, r.arrival_time)        # high priority, FIFO
        return (1, r.prompt_len, r.arrival_time)

    return sorted(waiting, key=priority)


def order_queue_fcfs(waiting: Sequence, now: float) -> List:
    """Baseline: first-come-first-served (vLLM default)."""
    return sorted(waiting, key=lambda r: r.arrival_time)
