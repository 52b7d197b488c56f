"""Build, load and launch the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exports plain C entry points ``<entry>_launch``
that return the launch's ``cudaError_t``, and ``<name>_error_string``. At
first use the sources are compiled with ``nvcc`` for ``sm_90a`` into
``build/repro_torch_kernels/<hash>/`` at the root of the checkout, one
``nvcc`` per source, all started together and keyed by a hash of the
source, the shared headers ``csrc/*.cuh`` and the flags. The libraries are
loaded with ``ctypes``; pointers and the stream cross as ``c_void_p``.

Nothing here runs when the module is imported: the CPU tests import it on
hosts without ``nvcc`` or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

KERNELS = ("paged_decode", "flash_decode", "moe_gmm", "source_expert_count",
           "kv_pack", "paged_prefill")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# entry point -> (library it lives in, argtypes)
_ENTRIES = {
    # q, k_pages, v_pages, k_scales, v_scales (null for fp pages),
    # block_tables, ctx_lens, scratch, out, B, Hq, Hkv, hd, ps, NB, n_split,
    # split_tokens, scale, dtype, device, stream
    "paged_decode": ("paged_decode", [_P] * 9 + [_I] * 8 + [_F, _I, _I, _P]),
    # x, w, tile_expert, group_sizes, padded_offsets, out, Np, D, F, E, nb,
    # dtype, device, stream
    "moe_gmm": ("moe_gmm", [_P] * 6 + [_I] * 7 + [_P]),
    # x, w, out, E, C, D, F, dtype, device, stream
    "moe_gmm_padded": ("moe_gmm", [_P] * 3 + [_I] * 6 + [_P]),
    # q, k_cache, v_cache, k_scales, v_scales (null for caches in q's
    # type), k_pos, q_pos, scratch, out, lse (null but for a split-K
    # shard), B, Hq, Hkv, hd, L, bstride, n_split, split_tokens, window,
    # scale, softcap, dtype, device, stream
    "flash_decode": ("flash_decode",
                     [_P] * 10 + [_I] * 9 + [_F, _F, _I, _I, _P]),
    # expert_idx, source_ids, b_out, a_out, T, K, E, S, single_block_slots,
    # device, stream
    "source_expert_count": ("source_expert_count",
                            [_P] * 4 + [_I] * 6 + [_P]),
    # x, q_out, s_out, rows, hd, dtype, device, stream
    "pack_kv": ("kv_pack", [_P] * 3 + [_L] + [_I] * 3 + [_P]),
    # k, v, block_tables, positions, valid, pool_k, pool_v, k_scale,
    # v_scale, tokens, S, Hkv, hd, NB, ps, P, dtype, device, stream
    "pack_kv_paged": ("kv_pack", [_P] * 9 + [_L] + [_I] * 8 + [_P]),
    # q, s, out, rows, hd, dtype, device, stream
    "unpack_kv": ("kv_pack", [_P] * 3 + [_L] + [_I] * 3 + [_P]),
    # q, k_pages, v_pages, k_scales, v_scales, block_tables, chunk_starts,
    # ctx_lens, out, B, S, Hq, Hkv, hd, ps, NB, scale, dtype, quant, device,
    # stream
    "paged_prefill": ("paged_prefill",
                      [_P] * 9 + [_I] * 7 + [_F, _I, _I, _I, _P]),
}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_libraries: Dict[str, ctypes.CDLL] = {}
_launchers: Dict[str, tuple] = {}
build_logs: Dict[str, str] = {}     # name -> nvcc/ptxas output of its build


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "host with the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / key / f"lib{name}.so"


def build(names: Iterable[str] = KERNELS) -> float:
    """Compile every library of ``names`` not built yet, one ``nvcc`` each,
    in parallel. Returns the wall seconds spent; raises on a failed build."""
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def _launcher(entry: str):
    if entry not in _launchers:
        name, argtypes = _ENTRIES[entry]
        if name not in _libraries:
            build()
            _libraries[name] = ctypes.CDLL(str(library_path(name)))
        lib = _libraries[name]
        fn = getattr(lib, f"{entry}_launch")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err_str = getattr(lib, f"{name}_error_string")
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        _launchers[entry] = (fn, err_str)
    return _launchers[entry]


def launch(entry: str, *args, device: torch.device) -> None:
    """Run ``<entry>_launch(*args, device, stream)`` on the current stream
    of ``device``; raise if it returns a CUDA error."""
    fn, err_str = _launcher(entry)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*args, device.index or 0, stream)
    if err:
        raise RuntimeError(f"{entry}: CUDA error {err}: "
                           f"{err_str(err).decode()}")


def check_cuda(name: str, tensors: dict, device: torch.device) -> None:
    """Every tensor on ``device`` and contiguous, or raise."""
    for k, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {k} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")


def check_int32(name: str, tensors: dict) -> None:
    for k, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {k} must be int32, got {t.dtype}")
