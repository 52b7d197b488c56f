"""Engine step-cost model for the simulated data plane.

Grounded in the same roofline constants as §Roofline (EXPERIMENTS.md):
prefill is compute-bound (2*N_active FLOPs/token against the engine's TP
group peak), decode is memory-bound (active weights + running KV read per
step), the MoE expert FFN portion is scaled by the per-rank load imbalance
under the current expert placement, and cross-DP all-to-all bytes pay the
interconnect. Defaults approximate the paper's testbed scale (Qwen3-30B-A3B,
DP=2 engines x TP=2, EP over 4 devices).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class CostModelConfig:
    """Calibrated to the paper's operating point: Qwen3-30B-A3B on a
    DP=2 x TP=2 node, ~90 running requests/engine and ~27% KV usage at
    RPS=4 (paper §7.3 'we inspect the RPS=4 Random traces')."""

    active_params: float = 3.35e9      # Qwen3-30B-A3B active
    bytes_per_param: float = 2.0
    kv_bytes_per_token: float = 96e3   # 48L * 2 * 4kv * 128hd * 2B
    # per-engine (TP group) effective hardware
    peak_flops: float = 1.8e14
    flops_efficiency: float = 0.45     # eff ~5.9e13 FLOP/s
    hbm_bw: float = 3.3e11             # effective bytes/s for decode reads
    step_overhead_s: float = 0.005     # scheduler+launch overhead per step
    moe_fraction: float = 0.70         # share of step in expert FFNs
    n_moe_layers: int = 48
    top_k: int = 8
    d_model: int = 2048
    # all-to-all: per-layer latency floor + remote-fraction-scaled term
    a2a_lat_local_s: float = 50e-6
    a2a_lat_remote_s: float = 200e-6
    a2a_bytes_per_token: float = 2 * 2048 * 2.0  # dispatch+combine, bf16
    interconnect_bw: float = 6.0e10    # effective cross-DP a2a bytes/s

    @property
    def eff_flops(self) -> float:
        return self.peak_flops * self.flops_efficiency


class EngineCostModel:
    def __init__(self, cfg: CostModelConfig = CostModelConfig()):
        self.cfg = cfg

    def prefill_time(self, tokens: int) -> float:
        fl = 2.0 * self.cfg.active_params * tokens
        return fl / self.cfg.eff_flops

    def decode_time(self, n_seqs: int, total_context: int) -> float:
        if n_seqs == 0:
            return 0.0
        weight_read = self.cfg.active_params * self.cfg.bytes_per_param
        kv_read = total_context * self.cfg.kv_bytes_per_token
        mem = (weight_read + kv_read) / self.cfg.hbm_bw
        comp = 2.0 * self.cfg.active_params * n_seqs / self.cfg.eff_flops
        return max(mem, comp)

    def recompute_tokens_equivalent(self, seconds: float) -> float:
        """Prefill tokens recomputable in ``seconds`` (for swap pricing)."""
        return seconds * self.cfg.eff_flops / (2.0 * self.cfg.active_params)

    def step_time(self, prefill_tokens: int, n_decode: int,
                  decode_context: int, moe_imbalance: float = 1.0,
                  remote_frac: float = 0.0) -> float:
        """moe_imbalance: max/mean per-rank expert load (>=1); remote_frac:
        fraction of routed tokens crossing DP groups under the placement."""
        tokens = prefill_tokens + n_decode
        base = self.prefill_time(prefill_tokens) + \
            self.decode_time(n_decode, decode_context)
        # imbalance stretches only the expert-FFN share of the step
        moe_pen = base * self.cfg.moe_fraction * (moe_imbalance - 1.0)
        comm = self.cfg.n_moe_layers * (
            self.cfg.a2a_lat_local_s + remote_frac * self.cfg.a2a_lat_remote_s)
        # dispatch+combine bytes cross the interconnect once per MoE layer
        comm += (tokens * self.cfg.top_k * remote_frac
                 * self.cfg.a2a_bytes_per_token * self.cfg.n_moe_layers
                 / self.cfg.interconnect_bw)
        return self.cfg.step_overhead_s + base + moe_pen + comm


@dataclasses.dataclass
class SwapCostConfig:
    """Priors for the swap-vs-recompute decision; every rate is an EMA
    seed that measured observations replace within a few transfers."""

    d2h_bw: float = 2.0e10        # device -> host bytes/s (pinned copies)
    h2d_bw: float = 2.0e10        # host -> device bytes/s
    swap_lat_s: float = 0.5e-3    # fixed per-transfer launch/sync latency
    prefill_tps: float = 5.0e5    # chunked-prefill tokens/s seed
    decode_step_s: float = 5.0e-3  # one decode dispatch seed
    ema: float = 0.25             # observation weight


class SwapCostModel:
    """Measured swap-vs-recompute cost model for preemption decisions.

    The classic trade: preempting a request either *recomputes* its
    prefill later (compute-heavy; decode-phase victims additionally
    replay each generated token as a full decode step) or *swaps* its KV
    pages to the host tier and reloads them (I/O-heavy). Both sides are
    priced from EMAs of what this engine actually measured — transfer
    bandwidth from timed ``save_pages``/``load_pages`` callbacks, prefill
    throughput and decode step time from timed dispatches — so the
    per-request decision in :meth:`prefer_swap` tracks the hardware it
    runs on instead of a datasheet.
    """

    def __init__(self, cfg: SwapCostConfig = SwapCostConfig()):
        self.cfg = cfg
        self.d2h_bw = cfg.d2h_bw
        self.h2d_bw = cfg.h2d_bw
        self.prefill_tps = cfg.prefill_tps
        self.decode_step_s = cfg.decode_step_s
        self.n_observed = 0

    def _ema(self, old: float, new: float) -> float:
        return (1.0 - self.cfg.ema) * old + self.cfg.ema * new

    # ---- observations ----------------------------------------------------
    def observe_transfer(self, nbytes: int, seconds: float,
                         kind: str = "out") -> None:
        if nbytes <= 0 or seconds <= 0:
            return
        rate = nbytes / max(seconds - self.cfg.swap_lat_s, 1e-9)
        if kind == "out":
            self.d2h_bw = self._ema(self.d2h_bw, rate)
        else:
            self.h2d_bw = self._ema(self.h2d_bw, rate)
        self.n_observed += 1

    def observe_prefill(self, tokens: int, seconds: float) -> None:
        if tokens <= 0 or seconds <= 0:
            return
        self.prefill_tps = self._ema(self.prefill_tps, tokens / seconds)
        self.n_observed += 1

    def observe_decode(self, seconds: float) -> None:
        if seconds <= 0:
            return
        self.decode_step_s = self._ema(self.decode_step_s, seconds)
        self.n_observed += 1

    # ---- pricing ---------------------------------------------------------
    def transfer_time(self, nbytes: int, kind: str = "out") -> float:
        bw = self.d2h_bw if kind == "out" else self.h2d_bw
        return self.cfg.swap_lat_s + nbytes / max(bw, 1e-9)

    def swap_round_trip(self, nbytes: int) -> float:
        """Full cost of the swap choice: copy out now + copy back later."""
        return (self.transfer_time(nbytes, "out")
                + self.transfer_time(nbytes, "in"))

    def recompute_time(self, prefill_tokens: int,
                       decode_steps: int = 0) -> float:
        """Cost of the recompute choice: re-prefill the prompt, then
        replay each already-generated token as one decode dispatch."""
        return (prefill_tokens / max(self.prefill_tps, 1e-9)
                + decode_steps * self.decode_step_s)

    def prefer_swap(self, prefill_tokens: int, decode_steps: int,
                    nbytes: int) -> bool:
        return self.swap_round_trip(nbytes) \
            < self.recompute_time(prefill_tokens, decode_steps)
