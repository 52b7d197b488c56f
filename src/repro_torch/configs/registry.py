"""Architecture registry: ``--arch <id>`` -> ModelConfig."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

# arch id -> module name in this package
_ARCHS: Dict[str, str] = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "gemma2-2b": "gemma2_2b",
    "qwen3-8b": "qwen3_8b",
    "qwen1.5-32b": "qwen1_5_32b",
    "gemma3-12b": "gemma3_12b",
    "xlstm-125m": "xlstm_125m",
    "hymba-1.5b": "hymba_1_5b",
    "llava-next-34b": "llava_next_34b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}


def list_archs() -> List[str]:
    return list(_ARCHS.keys())


def _module(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; choose from {list_archs()}")
    return importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
