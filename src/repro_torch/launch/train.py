"""Training launcher: the smoke-size model of ``--arch``, trained on random
batches, on the card unless asked for the CPU.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \
      --steps 50 --checkpoint /tmp/ck
  PYTHONPATH=src python -m repro_torch.launch.train ... --resume
  PYTHONPATH=src python -m repro_torch.launch.train ... --device cpu

``--resume`` continues from the checkpoint's step, with the checkpoint's
params and optimizer state. Step i's batch is drawn from a
``torch.Generator`` seeded from ``--seed`` and i (:func:`step_generator`),
so a resumed run sees the batches an uninterrupted one would.
"""
from __future__ import annotations

import argparse
import time

import torch


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step``'s batch: ``seed`` folded with the
    step, so each step's data depends on the two alone."""
    return torch.Generator().manual_seed(seed * 1_000_003 + step)


def make_batch(cfg, batch: int, seq: int, generator: torch.Generator,
               device="cuda"):
    """Random tokens and next-token labels (B, seq); stand-in embeddings
    (B, seq, D) in bf16 for an embedding-input config and for the
    encoder-decoder's frames, as the reference's launcher draws them.
    Drawn on the CPU, then moved, so every device sees the same batch."""
    toks = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                         generator=generator, dtype=torch.int64) \
        .to(torch.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.input_mode == "embeddings" or cfg.family == "encdec":
        out["embeddings"] = torch.randn((batch, seq, cfg.d_model),
                                        generator=generator) \
            .to(torch.bfloat16)
        if cfg.family != "encdec":
            del out["tokens"]
    return {k: v.to(device) for k, v in out.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-compression", choices=["none", "int8"],
                    default="none")
    ap.add_argument("--moment-dtype", default="bfloat16")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="run the kernels on the card (cuda) or their plain "
                         "versions on the CPU")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_smoke_config
    from repro_torch.ft import (checkpoint_step, restore_checkpoint,
                                save_checkpoint)
    from repro_torch.models import build_model
    from repro_torch.train import (AdamWConfig, make_train_state,
                                   make_train_step)

    cfg = get_smoke_config(args.arch)
    fns = build_model(cfg)
    params = fns.init(torch.Generator(args.device).manual_seed(args.seed),
                      device=args.device)
    ocfg = AdamWConfig(lr=args.lr, moment_dtype=args.moment_dtype)
    state = make_train_state(params, ocfg)
    start = 0
    if args.resume and args.checkpoint and \
            checkpoint_step(args.checkpoint) is not None:
        start = checkpoint_step(args.checkpoint)
        state = restore_checkpoint(args.checkpoint, state)
        print(f"resumed from step {start}")

    step_fn = make_train_step(
        lambda p, b: fns.loss(p, b), ocfg,
        grad_compression=None if args.grad_compression == "none"
        else args.grad_compression)

    for i in range(start, args.steps):
        batch = make_batch(cfg, args.batch, args.seq,
                           step_generator(args.seed, i), args.device)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d} loss={loss:.4f} "
                  f"({(time.time() - t0) * 1e3:.0f} ms)")
        if args.checkpoint and (i + 1) % args.checkpoint_every == 0:
            save_checkpoint(args.checkpoint, state, step=i + 1)
            print(f"checkpointed at step {i + 1}")


if __name__ == "__main__":
    main()
