"""Request lifecycle for the serving stack (real engine + simulator)."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


class RequestState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"        # prefill in progress or decoding
    PREEMPTED = "preempted"    # evicted under KV pressure; will recompute
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    req_id: int
    prompt_len: int
    max_new_tokens: int
    arrival_time: float
    prompt_tokens: Optional[List[int]] = None   # real engine only

    state: RequestState = RequestState.WAITING
    engine_id: int = -1
    prefill_done: int = 0          # tokens of prompt already prefilled
    generated: int = 0
    output_tokens: Optional[List[int]] = None

    dispatch_time: float = -1.0
    first_token_time: float = -1.0
    finish_time: float = -1.0
    n_preemptions: int = 0
    preempt_written: int = 0       # KV tokens lost at the last recompute
                                   # preemption — the anti-thrash gate
                                   # demands this much projected headroom
                                   # back before re-admitting
    error: Optional[str] = None    # set when FINISHED is a rejection, a shed
                                   # admission, or a quarantined recovery —
                                   # e.g. a prompt exceeding KV capacity

    # ---- crash recovery (real plane) ----------------------------------
    # Tokens already emitted before the serving engine failed, folded into
    # the prompt by export_for_resume(): a healthy engine then re-prefills
    # prompt+emitted and the next sampled token continues the stream
    # token-exactly under deterministic decode (prefill/decode logit
    # parity). The folded tokens leave max_new_tokens, so engine-local
    # bookkeeping (generated, written KV, done) needs no special cases.
    resume_output: Optional[List[int]] = None
    orig_prompt_len: int = -1      # prompt_len before any resume folding
    n_recoveries: int = 0          # times exported off a failed engine
    redispatch_attempts: int = 0   # failed re-dispatch tries (backoff books)

    def export_for_resume(self) -> None:
        """Prepare this request to leave a failed/draining engine: fold the
        already-emitted tokens into the prompt and reset to a fresh WAITING
        request a healthy engine can serve from scratch."""
        if self.orig_prompt_len < 0:
            self.orig_prompt_len = self.prompt_len
        emitted = list(self.output_tokens or [])
        if emitted:
            self.resume_output = (self.resume_output or []) + emitted
            self.prompt_tokens = list(self.prompt_tokens) + emitted
            self.prompt_len += len(emitted)
            self.max_new_tokens -= len(emitted)
        self.output_tokens = None
        self.prefill_done = 0
        self.generated = 0
        self.state = RequestState.WAITING
        self.engine_id = -1
        self.n_recoveries += 1

    @property
    def full_output_tokens(self) -> List[int]:
        """The client-visible output stream: tokens emitted before any
        engine failure plus those emitted after re-dispatch."""
        return list(self.resume_output or []) + list(self.output_tokens or [])

    # ---- trace-signal helpers -----------------------------------------
    @property
    def remaining_prefill(self) -> int:
        return max(self.prompt_len - self.prefill_done, 0)

    @property
    def context_len(self) -> int:
        return self.prefill_done + self.generated

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens

    # ---- metrics --------------------------------------------------------
    @property
    def ttft(self) -> float:
        return self.first_token_time - self.arrival_time

    @property
    def tpot(self) -> float:
        """Mean decode latency per output token, excluding the first."""
        if self.generated <= 1:
            return 0.0
        return (self.finish_time - self.first_token_time) / (self.generated - 1)

    @property
    def e2e(self) -> float:
        return self.finish_time - self.arrival_time
