"""Source-aware expert placement walkthrough (paper §5 + Fig. 6).

Collects a routing window, solves placement three ways — EPLB-style
load-only, Gimbal greedy, and the offline MINLP reference — then shows the
objective decomposition, the migration plan, and the (beta, gamma)
calibration.

PYTHONPATH=src python -m repro_torch.examples.placement_demo
"""
import numpy as np

from repro_torch.core import (PlacementConfig, calibrate,
                        default_distance_matrix, greedy_layer_placement,
                        layer_objective, solve_reference)
from repro_torch.serving.routing_sim import SourceExpertTraffic


def main():
    L, E, S, G = 4, 32, 2, 4
    rng = np.random.default_rng(0)
    tr = SourceExpertTraffic(L, E, S, seed=0)
    A = rng.poisson(tr.pref * 5000).astype(np.float64)     # (L, S, E)
    B = A.sum(axis=1)
    D = default_distance_matrix(S, G)
    prev = np.stack([np.arange(E) // (E // G)] * L)
    cfg = PlacementConfig(mig_cost_tokens=500.0)

    print(f"window: {int(B.sum())} routed entries, {L} layers x {E} experts"
          f" on {G} EP ranks / {S} DP sources\n")
    print(f"{'policy':<18}{'C_load':>12}{'C_comm':>12}{'C_mig':>10}"
          f"{'moves':>8}")
    for name, solver in (
        ("incumbent", lambda l: prev[l]),
        ("eplb(load-only)", lambda l: greedy_layer_placement(
            B[l], np.zeros_like(A[l]), D, prev[l],
            PlacementConfig(alpha=0.0, beta=1.0, gamma=0.0))),
        ("gimbal greedy", lambda l: greedy_layer_placement(
            B[l], A[l], D, prev[l], cfg)),
    ):
        cl = cc = cm = moves = 0.0
        for l in range(L):
            a = solver(l)
            o = layer_objective(a, B[l], A[l], D, prev[l], cfg)
            cl, cc, cm = cl + o[0], cc + o[1], cm + o[2]
            moves += int(np.sum(a != prev[l]))
        print(f"{name:<18}{cl:12.3e}{cc:12.3e}{cm:10.0f}{moves:8.0f}")

    ref = solve_reference(B, A, D, prev, cfg)
    cl = cc = cm = 0.0
    for l in range(L):
        o = layer_objective(ref[l], B[l], A[l], D, prev[l], cfg)
        cl, cc, cm = cl + o[0], cc + o[1], cm + o[2]
    print(f"{'MINLP reference':<18}{cl:12.3e}{cc:12.3e}{cm:10.0f}")

    res = calibrate(B, A, D, prev, ref_cfg=cfg)
    print(f"\ncalibration: (alpha, beta, gamma) = (1.0, {res.beta}, "
          f"{res.gamma}) — agreement {res.agreement:.1%} "
          f"(paper >= 80%), comm excess {res.comm_excess:+.2%}")


if __name__ == "__main__":
    main()
