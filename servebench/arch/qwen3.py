"""Qwen3 and Qwen3-MoE, the program side: the port's configuration, the map
from the port's leaves to the checkpoint's, the MoE shape and the model
FLOPs. The reference side is ``qwen3_ref.py``."""
from __future__ import annotations

from servebench.arch import MoEShape, Slot, period_slots
from servebench.arch.qwen3_ref import routes

MODEL_TYPES = ("qwen3", "qwen3_moe")


def model_config(cfg: dict):
    """The port's ``ModelConfig`` for a configuration file. Every layer
    routes, or none does: the port takes no ``mlp_only_layers`` and no
    sparse step other than 1."""
    from repro_torch.configs.base import ModelConfig, MoEConfig
    moe = MoEConfig()
    if routes(cfg):
        if cfg["decoder_sparse_step"] != 1 or cfg["mlp_only_layers"]:
            raise ValueError(f"{cfg['name']}: every layer has to route")
        moe = MoEConfig(n_experts=cfg["num_experts"],
                        top_k=cfg["num_experts_per_tok"],
                        d_expert=cfg["moe_intermediate_size"],
                        moe_every=cfg["decoder_sparse_step"])
    return ModelConfig(
        name=cfg["name"], family="moe" if moe.enabled else "dense",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["moe_intermediate_size"] if moe.enabled
        else cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], head_dim=cfg["head_dim"], moe=moe,
        rope_theta=float(cfg["rope_theta"]), qk_norm=True,
        norm_eps=float(cfg["rms_norm_eps"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        dtype=cfg["torch_dtype"])


# the port's leaf path -> the checkpoint leaf it holds
_LAYER_MAP = {
    "ln_attn": "input_layernorm", "attn.wq": "q_proj", "attn.wk": "k_proj",
    "attn.wv": "v_proj", "attn.wo": "o_proj", "attn.q_norm": "q_norm",
    "attn.k_norm": "k_norm", "ln_ffn": "post_attention_layernorm",
    "moe.router": "router", "moe.w_gate": "experts.gate_proj",
    "moe.w_up": "experts.up_proj", "moe.w_down": "experts.down_proj",
    "mlp.w_gate": "mlp.gate_proj", "mlp.w_up": "mlp.up_proj",
    "mlp.w_down": "mlp.down_proj",
}
_MODEL_MAP = {"embed.embedding": "embed_tokens", "embed.lm_head": "lm_head",
              "final_norm": "norm"}
_NORMS = {"input_layernorm", "q_norm", "k_norm", "post_attention_layernorm",
          "norm"}


def _less_one(x):
    return x - 1.0


def checkpoint_leaves(path: str, shape, period: int):
    """The slots of the port's leaf ``path``: every layer sits in the
    period, the model's own leaves outside it. The port's norms scale by
    (1 + w), so they hold the checkpoint's weight less one."""
    block = period_slots(path, shape, period)
    if block is None:
        name, layers = _MODEL_MAP[path], [(None, -1)]
    else:
        rel, layers = block
        name = _LAYER_MAP[rel]
    transform = _less_one if name in _NORMS else None
    return [Slot(i, name, layer, transform) for i, layer in layers]


def moe(cfg: dict):
    if not routes(cfg):
        return None
    return MoEShape(experts=cfg["num_experts"],
                    top_k=cfg["num_experts_per_tok"],
                    layers=tuple(range(cfg["num_hidden_layers"])))


def _layer_flops(cfg: dict, n_tokens: int, ctx_sum: int) -> int:
    """FLOPs of one decoder layer over ``n_tokens`` tokens whose live
    contexts (the token itself included) sum to ``ctx_sum``: the
    published widths, the router and the routed experts of each token, and
    attention over each token's live context."""
    d, hd = cfg["hidden_size"], cfg["head_dim"]
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    proj = 2 * d * (hq * hd + 2 * hkv * hd) + 2 * hq * hd * d
    if routes(cfg):
        ffn = 2 * d * cfg["num_experts"] \
            + cfg["num_experts_per_tok"] * 3 * 2 * d \
            * cfg["moe_intermediate_size"]
    else:
        ffn = 3 * 2 * d * cfg["intermediate_size"]
    return n_tokens * (proj + ffn) + 4 * ctx_sum * hq * hd


def model_flops(cfg: dict, n_tokens: int, ctx_sum: int,
                n_logits: int) -> int:
    """FLOPs of the whole model over ``n_tokens`` tokens (contexts summing
    to ``ctx_sum``), ``n_logits`` of which produce an output token through
    the LM head."""
    return cfg["num_hidden_layers"] * _layer_flops(cfg, n_tokens, ctx_sum) \
        + n_logits * 2 * cfg["hidden_size"] * cfg["vocab_size"]
