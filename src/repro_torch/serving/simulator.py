"""Serving-result container shared by the simulator and the real cluster.

Only ``SimResult`` is copied so far: the discrete-event ``simulate`` loop and
the simulated engines it drives come in a later slice under this module
name (ROADMAP.md Queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.serving.request import Request


@dataclasses.dataclass
class SimResult:
    name: str
    requests: List[Request] = dataclasses.field(default_factory=list)
    duration_s: float = 0.0
    signals: Dict = dataclasses.field(default_factory=dict)
    # the engines the run used — telemetry source for the scenario
    # invariant pack (not part of the serialized result)
    engines: Optional[List] = dataclasses.field(default=None, repr=False)

    def _arr(self, fn):
        done = [r for r in self.requests if r.finish_time > 0]
        return np.asarray([fn(r) for r in done]) if done else np.zeros(1)

    @property
    def mean_ttft(self):
        return float(self._arr(lambda r: r.ttft).mean())

    @property
    def p99_ttft(self):
        return float(np.percentile(self._arr(lambda r: r.ttft), 99))

    @property
    def mean_tpot(self):
        a = self._arr(lambda r: r.tpot)
        return float(a[a > 0].mean()) if (a > 0).any() else 0.0

    @property
    def mean_e2e(self):
        return float(self._arr(lambda r: r.e2e).mean())

    @property
    def throughput(self):
        n_done = sum(1 for r in self.requests if r.finish_time > 0)
        return n_done / max(self.duration_s, 1e-9)
