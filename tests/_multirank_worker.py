"""One rank of ``tests/test_torch_multirank.py``: joins a gloo world on the
CPU through a file rendezvous, runs the port's dense-cache entry points
under each case's policy on its shard of the params, the cache and the
batch, and holds what it gets against the reference's single-device run
(computed by the parent, passed in as tensors): its rows' logits and its
cache block within 1e-5 (float32), the statistics exactly.

    python tests/_multirank_worker.py JOB.json RANK

Imports only ``torch`` and ``repro_torch``; it records whether any module
of ``jax`` or of the reference was loaded. Writes ``{case: {"ok", "msg",
"max_err"}}`` and ``"imports"`` to the job's ``out`` path with its rank.
"""
import dataclasses
import json
import os
import sys
import traceback

import torch


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def run_case(case, mesh, data_dir):
    from repro_torch.configs import get_smoke_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.models import build_model

    cfg = reduced(get_smoke_config(case["arch"]), n_layers=case["layers"],
                  dtype="float32")
    blob = torch.load(f"{data_dir}/{case['data']}.pt")
    B, L = case["B"], case["L"]
    pol = sh.make_policy(cfg, ShapeConfig("cell", L, B, "decode"), mesh,
                         "serve")
    pol = dataclasses.replace(pol, **case.get("overrides", {}))
    for k, v in case.get("expect", {}).items():
        got = getattr(pol, k)
        if (list(got) if isinstance(got, tuple) else got) != v:
            raise AssertionError(f"policy {k} = {got}, expected {v}")
    params = blob["params"]
    local = sh.shard_params(params, sh.make_param_specs(params, cfg, pol),
                            pol)
    fns = build_model(cfg)
    abstract = fns.init_cache(B, L, kv_dtype=case["kv_dtype"], device="meta")
    cspecs = sh.cache_specs_tree(cfg, pol, abstract)
    cache = sh.local_zeros(abstract, cspecs, pol, "cpu")
    rows = lambda t: pol.take_block(t, pol.batch_axes, 0)  # noqa: E731
    kw = dict(source_ids=rows(blob["src"]), n_sources=2, policy=pol,
              ragged=case["ragged"])
    tol = case["tol"]
    worst = 0.0

    def held(step, logits, stats):
        nonlocal worst
        ref = rows(blob["logits"][step])
        e = _err(logits, ref)
        worst = max(worst, e)
        if not torch.allclose(logits, ref, rtol=tol, atol=tol):
            raise AssertionError(f"step {step}: logits differ by {e}")
        for k in ("expert_counts", "source_expert"):
            if k in blob["stats"][step] and not torch.equal(
                    stats[k], blob["stats"][step][k]):
                raise AssertionError(f"step {step}: {k} differ")

    lengths = rows(blob["lengths"])
    batch = {"tokens": rows(blob["tokens"]), "lengths": lengths}
    dkw = {}
    if "embeddings" in blob:         # the encoder-decoder
        batch["embeddings"] = rows(blob["embeddings"])
        dkw["enc_lengths"] = rows(blob["enc_lengths"])
    logits, cache, stats = fns.prefill(local, batch, cache, **kw)
    held(0, logits, stats)
    for i, tok in enumerate(blob["decode_tokens"]):
        logits, cache, stats = fns.decode(local, rows(tok), cache,
                                          lengths + i, **kw, **dkw)
        held(i + 1, logits, stats)
    blocks = sh._zip_trees(lambda t, s: sh.local_block(t, s, pol),
                           blob["cache"], cspecs)
    pairs = []
    sh._zip_trees(lambda t, r: pairs.append((t, r)), cache, blocks)
    for j, (t, ref) in enumerate(pairs):
        if t.shape != ref.shape:
            raise AssertionError(f"cache leaf {j}: shape {tuple(t.shape)}, "
                                 f"spec block {tuple(ref.shape)}")
        if t.dtype == torch.int8:         # codes: within one of the rule
            ok = (t.int() - ref.int()).abs().max() <= 1
        else:
            worst = max(worst, _err(t, ref))
            ok = torch.allclose(t, ref, rtol=tol, atol=tol)
        if not ok:
            raise AssertionError(f"cache leaf {j} differs: {_err(t, ref)}")
    return worst


def main(run=run_case):
    """Joins the job's world and runs ``run(case, mesh, data_dir)`` on
    each case in order."""
    job = json.load(open(sys.argv[1]))
    rank = int(sys.argv[2])
    sys.path.insert(0, job["src"])
    from repro_torch.launch.mesh import make_device_mesh

    torch.set_num_threads(1)
    mesh = make_device_mesh(job["shape"], job["axes"], "cpu",
                            init_method=f"file://{job['store']}", rank=rank,
                            world_size=job["world"], timeout_s=120)
    results = {}

    def write():
        results["imports"] = sorted(
            m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "repro"))
        with open(f"{job['out']}.{rank}.json", "w") as f:
            json.dump(results, f)

    for case in job["cases"]:
        try:
            results[case["name"]] = {
                "ok": True, "msg": "",
                "max_err": run(case, mesh, job["data"])}
        except Exception:               # noqa: BLE001 - reported per case
            results[case["name"]] = {"ok": False,
                                     "msg": traceback.format_exc()[-2000:],
                                     "max_err": None}
            # the other ranks wait in a collective of this case: leaving
            # closes the connections, which fails their wait at once
            write()
            print(results[case["name"]]["msg"], flush=True)
            os._exit(1)
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    write()


if __name__ == "__main__":
    main()
