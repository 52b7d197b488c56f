"""The numbers the benchmark reads do not move with the architecture
adapters: at smoke size on the CPU, for each cell, the SHA-256 of every
leaf that ``harness.program_params`` makes, the reference's served gaps
and routing ids on two fixed sequences with and without the fp8 control,
and the model FLOPs of the cell's full configuration at three points
(``costs.model_flops`` before the split, the adapter's ``model_flops``
since). The constants are what the Qwen3 harness read before it was split
into adapters; the weights, the reference's order of operations and the
FLOP formula are held to them bit for bit.

Run as a script, it prints the digest of every leaf of a cell's weights
at the size the cell runs, on the card, for one seed::

    python3 servebench/test_servebench_golden.py --workload <cell> \\
        --seed <n> [--size full|smoke] [--device cuda|cpu]
"""
import argparse
import hashlib
import sys
from pathlib import Path

import pytest
import torch

SEED = 2 ** 31 + 4242
SEQS = [
    {"prompt": [5, 17, 230, 41, 9, 77, 310, 2, 101, 64, 488, 3],
     "output": [12, 400, 56, 7, 250, 33]},
    {"prompt": [300, 1, 1, 8, 199, 42, 511, 6, 90],
     "output": [71, 5, 460, 18, 222]},
]
# (tokens, summed live context, logits) of a step
POINTS = [(1, 1, 1), (2048, 2048 * 2049 // 2, 1), (2176, 3_500_000, 136)]

# cell -> (dtype, shape, SHA-256 of the bytes) of each leaf of the port's
# tree, in its order
LEAVES = {
    "qwen3moe_burst_prefill": [
        ("bfloat16", (512, 64),
         "0483abcd038bcc72d991741348f2b8d7c64f64ea68f838083cb818d55d296b1b"),
        ("bfloat16", (64, 512),
         "41d3abc0b80f5d4fd2cef53fb7e98ff1d69060da21ad43b1edbeb05b6fb5acc9"),
        ("float32", (2, 64),
         "6cb85cf4eaab7eda148e2eac18bf2e2a70d430acf4508a8ad1995905bd0ed747"),
        ("bfloat16", (2, 64, 64),
         "d54c825efdd68f2d1c9f3e1dc5357cd6c2dbbdd9ba334caf3c72867d79aa87f0"),
        ("bfloat16", (2, 64, 32),
         "038751bd6cdd9a0363b616699688361460a4b31ac8c768d591c47bb24d3bc4e8"),
        ("bfloat16", (2, 64, 32),
         "07759ba83d2ed7d4d5e1e6e50b490cfb109eced3db796c0d5b5fb4dcfafc2359"),
        ("bfloat16", (2, 64, 64),
         "5ead52bf262eab48929588b230d076bd64b20963072de95779c13a1dd0ba33d2"),
        ("float32", (2, 16),
         "c087dc1cb2e99f4a6646e7496e9085715feacaf26b359a11cf55c99b4351b71b"),
        ("float32", (2, 16),
         "08e089ee0a389ed8f80439f2c0eeef9ae5c76694388381af5ab51c4ba4c377b3"),
        ("float32", (2, 64),
         "45d07c38ed911cba71f452c5724d629c21e5765dd0257e3c18af4a6af26beecc"),
        ("float32", (2, 64, 8),
         "f62d15cf872c5b8e4eda274a280faa22500b5037acc16d778e6426a2ee7d99d9"),
        ("bfloat16", (2, 8, 64, 32),
         "419161bd81137c412f5b541580bc23ee6e9f3b511ddf87e3c2e70dbd2fc3691a"),
        ("bfloat16", (2, 8, 64, 32),
         "cca8b20272f076761a42e09368cc720e69855cea56de123761e5d16d72d2254e"),
        ("bfloat16", (2, 8, 32, 64),
         "27541dd1944fb2f720ce9057a34ad2ef4ca2a3898a635d77b1b510dbe1ca0e34"),
        ("float32", (64,),
         "92a350beeeea17c09cec3b0fd7c569019402ab91fbc7405d86223faf25505480"),
    ],
    "qwen3dense_burst_prefill": [
        ("bfloat16", (512, 64),
         "0483abcd038bcc72d991741348f2b8d7c64f64ea68f838083cb818d55d296b1b"),
        ("bfloat16", (64, 512),
         "41d3abc0b80f5d4fd2cef53fb7e98ff1d69060da21ad43b1edbeb05b6fb5acc9"),
        ("float32", (2, 64),
         "6cb85cf4eaab7eda148e2eac18bf2e2a70d430acf4508a8ad1995905bd0ed747"),
        ("bfloat16", (2, 64, 64),
         "d54c825efdd68f2d1c9f3e1dc5357cd6c2dbbdd9ba334caf3c72867d79aa87f0"),
        ("bfloat16", (2, 64, 32),
         "038751bd6cdd9a0363b616699688361460a4b31ac8c768d591c47bb24d3bc4e8"),
        ("bfloat16", (2, 64, 32),
         "07759ba83d2ed7d4d5e1e6e50b490cfb109eced3db796c0d5b5fb4dcfafc2359"),
        ("bfloat16", (2, 64, 64),
         "5ead52bf262eab48929588b230d076bd64b20963072de95779c13a1dd0ba33d2"),
        ("float32", (2, 16),
         "c087dc1cb2e99f4a6646e7496e9085715feacaf26b359a11cf55c99b4351b71b"),
        ("float32", (2, 16),
         "08e089ee0a389ed8f80439f2c0eeef9ae5c76694388381af5ab51c4ba4c377b3"),
        ("float32", (2, 64),
         "45d07c38ed911cba71f452c5724d629c21e5765dd0257e3c18af4a6af26beecc"),
        ("bfloat16", (2, 64, 128),
         "f9d1e9c59100302d15d5085ed011f4703044b18ee4d99571f9e90de624e20c64"),
        ("bfloat16", (2, 64, 128),
         "0ce542498279a0ed7893495098c13ec396d2104c923db2ea3826dc3fa667b9fb"),
        ("bfloat16", (2, 128, 64),
         "ad5fe5e1ea60df59747ab7aeb81fca8e10ad36c3ece8ae9c43e67b56d1a3606f"),
        ("float32", (64,),
         "92a350beeeea17c09cec3b0fd7c569019402ab91fbc7405d86223faf25505480"),
    ],
}
# cell -> control -> output -> per sequence: the gaps, or the routing ids'
# (shape, SHA-256 of the int64 bytes)
REFERENCE = {
    "qwen3moe_burst_prefill": {
        False: {
            "served": [
                [2.0642518997192383, 1.9975324869155884, 4.328592300415039,
                 4.289649486541748, 1.8956423997879028, 3.4321722984313965],
                [1.1579827070236206, 3.044813632965088, 2.2678213119506836,
                 2.2411954402923584, 3.054837942123413],
            ],
            "routing": [
                ((2, 12, 2),
         "00406becd3f111799ca26a2865a963906d9238f662d318d550d2e6e4f24afc6d"),
                ((2, 9, 2),
         "281f0e68df871763f17b9eda56fc42c1d5c7e4fd613ce89f284859796fe7c8f7"),
            ],
        },
        True: {
            "served": [
                [2.0642518997192383, 1.9975324869155884, 4.328592300415039,
                 4.289649486541748, 1.8956423997879028, 3.4321722984313965],
                [1.1579827070236206, 3.044813632965088, 2.2678213119506836,
                 2.2411954402923584, 3.054837942123413],
            ],
            "control": [
                [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                [0.0, 0.0, 0.0, 0.0, 0.0],
            ],
            "routing": [
                ((2, 12, 2),
         "00406becd3f111799ca26a2865a963906d9238f662d318d550d2e6e4f24afc6d"),
                ((2, 9, 2),
         "281f0e68df871763f17b9eda56fc42c1d5c7e4fd613ce89f284859796fe7c8f7"),
            ],
            "routing_control": [
                ((2, 12, 2),
         "5226573d5f835004c5b312cc214271d061cac92d1d7d1ca62ea377aad668ab4b"),
                ((2, 9, 2),
         "aa752a0dffa68207c19c475a37f6cd5117f8ba759ed5b7d92ed84880a8efd563"),
            ],
        },
    },
    "qwen3dense_burst_prefill": {
        False: {
            "served": [
                [2.750103235244751, 3.4450998306274414, 3.698772430419922,
                 3.1416308879852295, 3.3876237869262695, 3.991647958755493],
                [2.5276501178741455, 2.4766674041748047, 3.436595916748047,
                 3.0732498168945312, 3.110225200653076],
            ],
        },
        True: {
            "served": [
                [2.750103235244751, 3.4450998306274414, 3.698772430419922,
                 3.1416308879852295, 3.3876237869262695, 3.991647958755493],
                [2.5276501178741455, 2.4766674041748047, 3.436595916748047,
                 3.0732498168945312, 3.110225200653076],
            ],
            "control": [
                [0.0, 0.0, 0.05107378959655762, 0.0, 0.0, 0.0],
                [0.0, 0.0, 0.07251429557800293, 0.0, 0.0],
            ],
        },
    },
}
FLOPS = {
    "qwen3moe_burst_prefill": [1987772416, 3209164226560, 3743540051968],
    "qwen3dense_burst_prefill": [5875367936, 9897050636288, 10933394997248],
}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _sha(t: torch.Tensor) -> str:
    t = t.detach().contiguous().cpu()
    raw = t if t.dtype == torch.int64 else t.view(torch.uint8)
    return hashlib.sha256(raw.numpy().tobytes()).hexdigest()


def leaf_digests(cell, seed: int, device):
    """Leaf path -> (dtype, shape, SHA-256) of the weights that
    ``program_params`` makes for ``cell``, in the tree's order."""
    from servebench import harness
    mcfg = cell.arch.program.model_config(cell.config)
    tree = harness.program_params(cell.arch, cell.config, mcfg, seed, device)
    return {path: (str(v.dtype).removeprefix("torch."), tuple(v.shape),
                   _sha(v)) for path, v in _flat(tree)}


@pytest.mark.parametrize("cell", sorted(LEAVES))
def test_the_weights_are_the_same_bit_for_bit(cell):
    from servebench import harness
    c = harness.load_cell(cell, size="smoke")
    got = leaf_digests(c, SEED, "cpu")
    assert len(got) == len(LEAVES[cell])
    for (path, g), want in zip(got.items(), LEAVES[cell]):
        assert g == want, path


@pytest.mark.parametrize("control", [False, True])
@pytest.mark.parametrize("cell", sorted(REFERENCE))
def test_the_reference_reads_the_same_gaps_and_routing(cell, control):
    from servebench import harness, reference
    c = harness.load_cell(cell, size="smoke")
    got = reference.served_gaps(c.arch.ref, c.config, SEED, SEQS, "cpu",
                                control=control)
    want = REFERENCE[cell][control]
    assert sorted(got) == sorted(want)
    for key, per_seq in want.items():
        for g, w in zip(got[key], per_seq, strict=True):
            if key in ("served", "control"):
                assert torch.equal(g, torch.tensor(w, dtype=torch.float32)), \
                    (key, g.tolist(), w)
            else:
                assert (tuple(g.shape), _sha(g)) == w, key


@pytest.mark.parametrize("cell", sorted(FLOPS))
def test_the_model_flops_are_the_same(cell):
    from servebench import harness
    c = harness.load_cell(cell)
    assert [c.arch.program.model_flops(c.config, *p)
            for p in POINTS] == FLOPS[cell]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Print the SHA-256 of every "
                                 "leaf of a cell's weights, one a line.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--size", choices=("full", "smoke"), default="full")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    from servebench import harness
    cell = harness.load_cell(args.workload, size=args.size)
    for path, (dtype, shape, sha) in leaf_digests(
            cell, args.seed, args.device).items():
        print(path, dtype, "x".join(map(str, shape)), sha, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
