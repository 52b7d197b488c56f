"""The port stands alone, and what it leaves out fails loudly."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_smoke_config, reduced
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.serving import (PagedEngineConfig, PagedModelRunner,
                                 PagedRealEngine, Request)

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_importing_the_port_loads_no_jax_and_no_reference():
    # msgpack and zstandard are absent where the kernels run
    code = (
        "import sys\n"
        "import repro_torch.bridge, repro_torch.serving\n"
        "import repro_torch.models.transformer, repro_torch.kernels.ops\n"
        "import repro_torch.core, repro_torch.ft\n"
        "import repro_torch.serving.real_cluster\n"
        "import repro_torch.kernels.kv_pack\n"
        "import repro_torch.kernels.flash_decode, repro_torch.models.api\n"
        "import repro_torch.distributed.sharding, repro_torch.launch.mesh\n"
        "import repro_torch.launch.cells, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.collective_analysis\n"
        "import repro_torch.launch.cost, repro_torch.launch.roofline\n"
        "import repro_torch.launch.roofline_run\n"
        "import repro_torch.launch.perf_run, repro_torch.counting\n"
        "import repro_torch.serving.real_engine\n"
        "import repro_torch.serving.engine, repro_torch.serving.routing_sim\n"
        "import repro_torch.serving.simulator, repro_torch.core.minlp\n"
        "import repro_torch.workloads.burstgpt\n"
        "import repro_torch.workloads.sessions\n"
        "import repro_torch.workloads.scenarios\n"
        "import repro_torch.launch.serve, repro_torch.launch.stress\n"
        "import repro_torch.examples.serve_moe\n"
        "import repro_torch.examples.serve_moe_paged\n"
        "import repro_torch.examples.placement_demo\n"
        "import repro_torch.configs.llama4_maverick_400b_a17b\n"
        "from repro_torch.configs import get_config, get_smoke_config\n"
        "get_config('qwen3-moe-30b-a3b'), "
        "get_smoke_config('qwen3-moe-30b-a3b')\n"
        "get_config('llama4-maverick-400b-a17b'), "
        "get_smoke_config('llama4-maverick-400b-a17b')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'msgpack', 'zstandard'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_kernels_models_and_policy_load_no_launch_tooling():
    """The kernels, the models and the policy sit below the launch tooling:
    they reach its counters through ``repro_torch.counting`` only."""
    code = (
        "import sys\n"
        "import repro_torch.kernels.moe_gmm, repro_torch.kernels.kv_pack\n"
        "import repro_torch.kernels.flash_decode\n"
        "import repro_torch.kernels.paged_decode\n"
        "import repro_torch.kernels.source_expert_count\n"
        "import repro_torch.distributed.sharding, repro_torch.models.api\n"
        "import repro_torch.models.transformer, repro_torch.models.moe\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.startswith('repro_torch.launch'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_file_imports_jax_or_the_reference():
    bad = re.compile(r"^\s*(import jax|from jax|from repro\.|import repro\b"
                     r"(?!_torch)|import (msgpack|zstandard)|"
                     r"from (msgpack|zstandard))|"
                     r"import_module\(f?[\"']repro\.", re.M)
    # the ranks of the multi-rank tests run the port alone, too
    workers = sorted((SRC.parent / "tests").glob("_multirank*worker.py"))
    assert len(workers) == 2
    files = list(PORT.rglob("*.py")) + [SRC.parent / "chip_smoke.py"] + \
        workers
    assert len(files) > 10
    for f in files:
        assert not bad.search(f.read_text()), f


def test_config_registry_loads_the_ports_own_configs():
    from repro_torch.configs import ModelConfig, get_config, get_smoke_config
    for cfg in (get_config("qwen3-moe-30b-a3b"),
                get_smoke_config("qwen3-moe-30b-a3b"),
                get_config("llama4-maverick-400b-a17b"),
                get_smoke_config("llama4-maverick-400b-a17b")):
        assert type(cfg) is ModelConfig
        assert type(cfg).__module__ == "repro_torch.configs.base"


def _tiny():
    cfg = reduced(get_smoke_config("qwen3-moe-30b-a3b"), n_layers=2,
                  dtype="float32")
    params = ttfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                              device="cpu")
    return cfg, params


def test_runner_without_device_does_not_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default runs there")
    cfg, _ = _tiny()
    ecfg = PagedEngineConfig()
    assert ecfg.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedModelRunner(cfg, {}, ecfg, n_sources=2)


def test_runner_rejects_params_on_another_device():
    cfg, params = _tiny()
    meta = {"w": torch.empty(2, device="meta")}
    with pytest.raises(ValueError, match="params live on"):
        PagedModelRunner(cfg, meta, PagedEngineConfig(device="cpu"),
                         n_sources=2)
    PagedModelRunner(cfg, params, PagedEngineConfig(device="cpu"),
                     n_sources=2)


def test_int8_pages_serve_on_the_cpu():
    cfg, params = _tiny()
    with pytest.raises(ValueError, match="kv_dtype"):
        ttfm.init_paged_cache(cfg, 4, 8, kv_dtype="fp8", device="cpu")
    ecfg = PagedEngineConfig(device="cpu", kv_dtype="int8", page_size=8,
                             n_pages=32, max_blocks_per_req=8, max_batch=4,
                             token_budget=16, chunk_buckets=(8, 16))
    runner = PagedModelRunner(cfg, params, ecfg, n_sources=2)
    engine = PagedRealEngine(0, cfg, params, ecfg, runner=runner)
    assert engine.pages["pos0"]["k"].dtype == torch.int8
    reqs = [Request(req_id=i, prompt_len=11, max_new_tokens=4,
                    arrival_time=0.0, prompt_tokens=list(range(3 + i, 14 + i)))
            for i in range(3)]
    for r in reqs:
        engine.enqueue(r, 0.0)
    for step in range(100):
        if not engine.has_work:
            break
        engine.step(0.01 * step)
    assert all(len(r.output_tokens) == 4 and not r.error for r in reqs)
    assert all(0 <= t < cfg.vocab_size for r in reqs
               for t in r.output_tokens)
    assert engine.pages["pos0"]["k_scale"].abs().sum() > 0


def test_padded_dispatch_serves_on_the_cpu():
    cfg, params = _tiny()
    runner = PagedModelRunner(cfg, params, PagedEngineConfig(device="cpu"),
                              n_sources=2, ragged_dispatch=False)
    assert runner.ragged_dispatch is False
    moe_p = {k: v[0] for k, v in params["blocks"]["pos0"]["moe"].items()}
    x = torch.randn(2, 3, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    placement = torch.arange(cfg.moe.n_experts, dtype=torch.int32)
    y, st = tmoe.moe_layer(moe_p, cfg, x, placement, ragged=False)
    assert y.shape == x.shape and torch.isfinite(y).all()
    assert int(st["expert_counts"].sum()) == 6 * cfg.moe.top_k
    # with a capacity nothing overflows, the padded path drops no token and
    # gives the dropless ragged path's output
    y_wide, _ = tmoe.moe_layer(moe_p, cfg, x, placement, ragged=False,
                               capacity_factor=64.0)
    y_ragged, _ = tmoe.moe_layer(moe_p, cfg, x, placement)
    torch.testing.assert_close(y_wide, y_ragged, rtol=1e-5, atol=1e-5)


def test_dense_engine_without_device_does_not_fall_back_to_the_cpu():
    from repro_torch.serving import RealModelEngine
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default runs there")
    cfg, params = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RealModelEngine(0, cfg, params)
    with pytest.raises(ValueError, match="params live on"):
        RealModelEngine(0, cfg, {"w": torch.empty(2, device="meta")},
                        device="cpu")


def test_kernel_wrappers_refuse_other_devices():
    from repro_torch.kernels.kv_pack import pack_kv, unpack_kv
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_ragged
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.source_expert_count import source_expert_count
    m = torch.empty(1, 1, 1, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        paged_decode(m, m, m, m, m)
    with pytest.raises(ValueError, match="no kernel"):
        moe_gmm_ragged(m[0], m, m, m, m, n_block=8)
    with pytest.raises(ValueError, match="no kernel"):
        moe_gmm(m, m)
    with pytest.raises(ValueError, match="no kernel"):
        flash_decode(m, m[None], m[None], m[0], m[0, 0])
    with pytest.raises(ValueError, match="no kernel"):
        source_expert_count(m[0], m, n_experts=1, n_sources=1)
    with pytest.raises(ValueError, match="no kernel"):
        pack_kv(m)
    with pytest.raises(ValueError, match="no kernel"):
        unpack_kv(m.to(torch.int8), m[..., 0])
