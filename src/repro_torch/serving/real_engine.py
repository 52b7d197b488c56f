"""Real-data-plane DP engine on a dense, slot-indexed KV cache.

Same control-plane surface as the paged engine (traces, queue policy, KV
accounting, routing statistics), but the model's KV cache is one dense
``(max_slots, max_len)`` row per request: one-shot prefill of each admitted
request into a one-row cache spliced into its slot, then one batched decode
step over every slot per engine step (the model's ``build_model`` entry
points: ``models/transformer.py::prefill`` and ``decode_step`` for the
decoder families, decode attention through the flash-decode kernel;
``models/xlstm.py``'s for xLSTM, whose "cache" is its recurrent states,
which the splice leaves in place: ``_splice``).
Routing statistics are the router's real outputs, so the Gimbal
coordinator runs unmodified against this plane.

Every slot decodes on every step, idle ones included, and the dense decode
passes no token mask: idle slots' routing counts in B and A, as in the
reference (ROADMAP.md Queue C).

The engine runs on ``device`` (``cuda`` by default, where the CUDA kernels
launch; ``cpu`` runs their plain versions); ``params`` must live there.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.bridge import tree_leaves
from repro_torch.core.queue_policy import QueueConfig, order_queue
from repro_torch.core.traces import EngineTrace
from repro_torch.models import build_model
from repro_torch.models.transformer import identity_placement
from repro_torch.serving.engine_util import drain_window_stats
from repro_torch.serving.kvcache import SlotAllocator
from repro_torch.serving.request import Request, RequestState


def _stats_to_numpy(stats):
    return {k: v.cpu().numpy() for k, v in stats.items()}


def _splice(big, small, slot: int) -> None:
    """Write the one-row prefilled cache ``small`` into slot ``slot`` of
    ``big``, in place, by the reference's rule (``RealModelEngine.
    _prefill_into_slot``'s ``put``), over any nesting of dicts and lists: a
    leaf of ``ndim >= 2`` with the same ``ndim`` and the same leading size
    as the engine's is written at ``[:, slot]``; every other leaf is left as
    it was. The transformer's leaves are ``(n_super, batch, ...)``, so all
    of them are spliced. xLSTM's states are ``(batch, ...)``: their leading
    sizes differ (1 against ``max_slots``), so none is, and the slot decodes
    on from its old state, as the reference's does (ROADMAP.md Queue C)."""
    if isinstance(big, dict):
        for k in big:
            _splice(big[k], small[k], slot)
    elif isinstance(big, list):
        for b, s in zip(big, small):
            _splice(b, s, slot)
    elif big.ndim >= 2 and big.ndim == small.ndim \
            and small.shape[0] == big.shape[0]:
        big[:, slot] = small[:, 0]


class RealModelEngine:
    def __init__(self, engine_id: int, cfg, params, *, max_slots: int = 8,
                 max_len: int = 128, n_sources: int = 2, seed: int = 0,
                 ragged_dispatch: Optional[bool] = None,
                 device: str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RealModelEngine: device 'cuda' requested but "
                               "no CUDA device is available; pass "
                               "device='cpu' to run the plain CPU versions")
        for leaf in tree_leaves(params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"RealModelEngine: params live on "
                                 f"{leaf.device}, engine on {self.device}")
        self.engine_id = engine_id
        self.cfg = cfg
        self.fns = build_model(cfg)
        self.params = params
        self.max_slots = max_slots
        self.max_len = max_len
        self.n_sources = n_sources
        # MoE dispatch of this engine's model calls: the sort-based ragged
        # path (default) or the capacity-padded one
        self.ragged_dispatch = ragged_dispatch is not False
        self.cache = self.fns.init_cache(max_slots, max_len,
                                         device=self.device)
        self.slots = SlotAllocator(max_slots)
        self.lengths = np.zeros(max_slots, np.int32)
        self.active = np.zeros(max_slots, bool)
        self.req_of_slot: Dict[int, Request] = {}
        # no prefix cache and no lane fusion on the slot-indexed plane:
        # declared (always 0, one dispatch per prefill) so cluster telemetry
        # sums stay honest across engine types
        self.prefix_hit_tokens = 0
        self.prefill_dispatches = 0
        self.prefill_lanes_total = 0
        # tokens through the model: prompts prefilled, and live slots
        # decoded (serve_real_cluster's progress marker reads both)
        self.total_prefill_tokens = 0
        self.total_decode_tokens = 0
        self.waiting: List[Request] = []
        self.placement = identity_placement(cfg).numpy()
        self.qcfg = QueueConfig(theta_age_s=5.0)
        self.step_count = 0
        self.stats_log: List[Dict] = []

    def _model_kw(self, batch: int):
        return dict(placement=torch.as_tensor(self.placement,
                                              device=self.device),
                    source_ids=torch.full((batch,), self.engine_id,
                                          dtype=torch.int32,
                                          device=self.device),
                    n_sources=self.n_sources,
                    collect_stats=self.cfg.moe.enabled,
                    ragged=self.ragged_dispatch)

    # ---- admission -----------------------------------------------------
    def enqueue(self, req: Request, now: float) -> None:
        req.engine_id = self.engine_id
        req.dispatch_time = now
        if req.prompt_len >= self.max_len:
            # an over-long prompt would overflow the slot's cache rows:
            # reject it up front with an error state instead
            req.state = RequestState.FINISHED
            req.error = "prompt_exceeds_max_len"
            req.finish_time = now
            return
        self.waiting.append(req)

    def _admit(self, now: float) -> None:
        self.waiting = order_queue(self.waiting, now, self.qcfg)
        admitted = []
        for r in self.waiting:
            slot = self.slots.acquire(r.req_id)
            if slot is None:
                break
            self._prefill_into_slot(r, slot, now)
            admitted.append(r)
        for r in admitted:
            self.waiting.remove(r)

    def _prefill_into_slot(self, req: Request, slot: int, now: float) -> None:
        toks = torch.as_tensor([req.prompt_tokens], dtype=torch.int32,
                               device=self.device)
        batch = {"tokens": toks,
                 "lengths": torch.full((1,), toks.shape[1],
                                       dtype=torch.int32, device=self.device)}
        cache1 = self.fns.init_cache(1, self.max_len, device=self.device)
        logits, cache1, stats = self.fns.prefill(self.params, batch, cache1,
                                                 **self._model_kw(1))
        _splice(self.cache, cache1, slot)
        self.prefill_dispatches += 1
        self.prefill_lanes_total += 1
        self.total_prefill_tokens += req.prompt_len
        tok = int(torch.argmax(logits[0]))
        req.prefill_done = req.prompt_len
        req.generated = 1
        req.output_tokens = [tok]
        req.first_token_time = now
        req.state = RequestState.RUNNING
        self.lengths[slot] = req.prompt_len
        self.active[slot] = True
        self.req_of_slot[slot] = req
        if stats is not None:
            self.stats_log.append(_stats_to_numpy(stats))

    # ---- one step --------------------------------------------------------
    def step(self, now: float):
        self._admit(now)
        if not self.active.any():
            return None
        tokens = np.zeros(self.max_slots, np.int32)
        for slot, req in self.req_of_slot.items():
            tokens[slot] = req.output_tokens[-1]
        logits, self.cache, stats = self.fns.decode(
            self.params, torch.as_tensor(tokens, device=self.device),
            self.cache, torch.as_tensor(self.lengths, device=self.device),
            **self._model_kw(self.max_slots))
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self.total_decode_tokens += len(self.req_of_slot)
        finished = []
        for slot in list(self.req_of_slot):
            req = self.req_of_slot[slot]
            req.output_tokens.append(int(nxt[slot]))
            req.generated += 1
            self.lengths[slot] += 1
            if req.done or self.lengths[slot] >= self.max_len - 1:
                req.state = RequestState.FINISHED
                req.finish_time = now
                finished.append(req)
                self.active[slot] = False
                self.lengths[slot] = 0
                del self.req_of_slot[slot]
                self.slots.release(req.req_id)
        if stats is not None:
            self.stats_log.append(_stats_to_numpy(stats))
        self.step_count += 1
        return finished

    # ---- traces ----------------------------------------------------------
    def trace(self, now: float, *,
              full_prefix_summary: bool = False) -> EngineTrace:
        del full_prefix_summary     # no prefix cache on this plane
        # remaining prefill of admitted-but-unfinished prefills (one-shot
        # prefill makes it usually 0, but it is measured, not hardcoded),
        # queue pressure in prefill tokens still owed, and token-level KV
        # occupancy, not slot count
        return EngineTrace(
            engine_id=self.engine_id,
            remaining_prefill_tokens=float(
                sum(r.remaining_prefill for r in self.req_of_slot.values())),
            waiting_prefill_tokens=float(
                sum(r.remaining_prefill for r in self.waiting)),
            kv_usage=float(self.lengths.sum()) / (self.max_slots
                                                  * self.max_len),
            n_running=int(self.active.sum()),
            n_waiting=len(self.waiting),
            timestamp=now,
        )

    def window_stats(self):
        """Accumulated (B, A) since the last call: feeds the coordinator."""
        return drain_window_stats(self.stats_log)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting) or bool(self.active.any())
