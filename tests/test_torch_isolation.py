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
from repro_torch.serving import PagedEngineConfig, PagedModelRunner

SRC = Path(__file__).resolve().parents[1] / "src"
PORT = SRC / "repro_torch"


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch.bridge, repro_torch.serving\n"
        "import repro_torch.models.transformer, repro_torch.kernels.ops\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_source_file_imports_jax_or_the_reference():
    bad = re.compile(r"^\s*(import jax|from jax|from repro\.|import repro\b"
                     r"(?!_torch))", re.M)
    files = list(PORT.rglob("*.py")) + [SRC.parent / "chip_smoke.py"]
    assert len(files) > 10
    for f in files:
        assert not bad.search(f.read_text()), f


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


def test_int8_pages_are_not_served_yet():
    cfg, params = _tiny()
    with pytest.raises(NotImplementedError, match="pack_kv"):
        ttfm.init_paged_cache(cfg, 4, 8, kv_dtype="int8", device="cpu")
    runner = PagedModelRunner(
        cfg, params, PagedEngineConfig(device="cpu", kv_dtype="int8"),
        n_sources=2)
    with pytest.raises(NotImplementedError, match="Queue B"):
        runner.init_pages()


def test_padded_dispatch_is_not_served_yet():
    cfg, params = _tiny()
    with pytest.raises(NotImplementedError, match="padded"):
        PagedModelRunner(cfg, params, PagedEngineConfig(device="cpu"),
                         n_sources=2, ragged_dispatch=False)
    moe_p = {k: v[0] for k, v in params["blocks"]["pos0"]["moe"].items()}
    x = torch.zeros(1, 2, cfg.d_model)
    placement = torch.arange(cfg.moe.n_experts, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="padded"):
        tmoe.moe_layer(moe_p, cfg, x, placement, ragged=False)
    y, _ = tmoe.moe_layer(moe_p, cfg, x, placement)
    assert y.shape == x.shape


def test_kernel_wrappers_refuse_other_devices():
    from repro_torch.kernels.moe_gmm import moe_gmm_ragged
    from repro_torch.kernels.paged_decode import paged_decode
    from repro_torch.kernels.source_expert_count import source_expert_count
    m = torch.empty(1, 1, 1, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        paged_decode(m, m, m, m, m)
    with pytest.raises(ValueError, match="no kernel"):
        moe_gmm_ragged(m[0], m, m, m, m, n_block=8)
    with pytest.raises(ValueError, match="no kernel"):
        source_expert_count(m[0], m, n_experts=1, n_sources=1)
