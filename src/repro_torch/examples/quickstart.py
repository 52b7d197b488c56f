"""Quickstart: train a tiny MoE LM for a few steps, then serve one request
with the trained params.

PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

It runs on the card (``device="cuda"``) unless the caller asks for the CPU;
without a card and without ``--device cpu`` it raises.
"""
import argparse
import time

import torch

from repro_torch.bridge import tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import make_batch, step_generator
from repro_torch.models import build_model
from repro_torch.train import AdamWConfig, make_train_state, make_train_step


def main(device: str = "cuda"):
    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    fns = build_model(cfg)
    params = fns.init(torch.Generator(device).manual_seed(0), device=device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {cfg.name} (smoke) — {n_params/1e6:.2f}M params, "
          f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}")

    state = make_train_state(params, AdamWConfig(lr=1e-3))
    step = make_train_step(lambda p, b: fns.loss(p, b), AdamWConfig(lr=1e-3))

    B, S = 8, 32
    for i in range(30):
        batch = make_batch(cfg, B, S, step_generator(0, i), device)
        t0 = time.time()
        state, metrics = step(state, batch)
        if i % 5 == 0:
            print(f"step {i:3d} loss={float(metrics['loss']):.4f} "
                  f"ce={float(metrics['ce']):.4f} "
                  f"({(time.time()-t0)*1000:.0f} ms)")

    # serve one request with the trained params
    cache = fns.init_cache(1, 64, device=device)
    prompt = torch.randint(0, cfg.vocab_size, (1, 8),
                           generator=torch.Generator().manual_seed(0),
                           dtype=torch.int64).to(torch.int32).to(device)
    lengths = torch.tensor([8], dtype=torch.int32, device=device)
    logits, cache, _ = fns.prefill(state.params, {"tokens": prompt,
                                                  "lengths": lengths}, cache)
    out = [int(torch.argmax(logits[0]))]
    for _ in range(8):
        logits, cache, _ = fns.decode(
            state.params, torch.tensor([out[-1]], dtype=torch.int32,
                                       device=device), cache, lengths)
        out.append(int(torch.argmax(logits[0])))
        lengths = lengths + 1
    print("generated token ids:", out)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(device=ap.parse_args().device)
