"""The reference <-> port bridge: configs and params cross unchanged."""
import dataclasses

import jax
import numpy as np
import torch

from repro_torch.bridge import (config_from_dict, params_from_numpy,
                                params_to_numpy, tree_leaves)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def test_params_round_trip_is_bit_exact(tiny_model):
    cfg, params = tiny_model
    ref = _flat(jax.tree.map(np.asarray, params))
    back = _flat(params_to_numpy(params_from_numpy(
        jax.tree.map(np.asarray, params), device="cpu")))
    assert back.keys() == ref.keys()
    assert any(a.dtype.name == "bfloat16" for a in ref.values())
    for k, a in ref.items():
        b = back[k]
        assert b.dtype == a.dtype and b.shape == a.shape, k
        assert a.tobytes() == b.tobytes(), k


def test_params_keep_the_reference_layout(tiny_model):
    cfg, params = tiny_model
    tp = params_from_numpy(params, device="cpu")
    ref = _flat(jax.tree.map(np.asarray, params))
    got = _flat(tp)
    for k, a in ref.items():
        assert tuple(got[k].shape) == a.shape, k
    w = got["blocks/pos0/moe/w_gate"]
    assert w.dtype == torch.bfloat16
    assert w.shape[0] == cfg.n_layers          # stacked (n_super, ...)
    np.testing.assert_array_equal(
        w.float().numpy(), np.asarray(params["blocks"]["pos0"]["moe"]
                                      ["w_gate"], np.float32))


def test_int_and_f32_leaves_round_trip():
    tree = {"a": np.arange(12, dtype=np.int32).reshape(3, 4),
            "b": {"c": np.linspace(-1, 1, 7, dtype=np.float32)}}
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    assert back["a"].dtype == np.int32
    np.testing.assert_array_equal(back["a"], tree["a"])
    np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"])
    assert len(tree_leaves(back)) == 2


def test_config_from_dict(tiny_model):
    cfg, _ = tiny_model
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    assert tcfg.q_dim == cfg.q_dim and tcfg.n_moe_layers == cfg.n_moe_layers
