"""Analytic MODEL_FLOPS per step: the 'useful work' yardstick for the
ratio MODEL_FLOPS / counted FLOPs (``analysis/hlo_cost.py``).

Conventions (the JAX package's ``analysis/model_flops.py``):
  dense train        6 * N * D          (N params, D tokens)
  MoE train          6 * N_active * D
  prefill            2 * N(_active) * D
  decode             2 * N(_active) * B  (one token per sequence)
plus the attention quadratic term (not captured by 6ND):
  causal train       ~12 * L_attn * H * dh * S^2/2 * B   (fwd 4*, bwd 8*, causal /2)
  prefill            ~4  * L_attn * H * dh * S^2/2 * B
  decode             ~4  * L_attn * H * dh * S * B

``exact_param_counts`` reads shapes only: from the port's
``TransformerLM`` (never copying a weight to the host), or from a nested
dict of arrays, tensors or shapes with the key paths that
``models/transformer.params_to_numpy`` emits (``"table"`` for the input
embedding, ``"moe_w*"`` for the expert stacks) — the JAX package's
``Model.params_shape()`` tree has the same paths.
"""
from __future__ import annotations

from repro_torch.configs.base import ATTN, ModelConfig, ShapeConfig


def n_attn_layers(cfg: ModelConfig) -> int:
    if cfg.enc_dec:
        return cfg.n_layers + cfg.n_enc_layers
    return sum(1 for k in cfg.pattern if k == ATTN) * cfg.n_periods


def _shape_tree(params):
    """A ``TransformerLM`` as the nested dict of leaf shapes that
    ``params_to_numpy`` would emit (each layer's leaves as its own entry
    instead of stacked over periods: the counts are the same)."""
    if not hasattr(params, "blocks"):
        return params
    return {"periods": {f"layer{i}": {
                k: ({s: leaf.shape for s, leaf in v.items()}
                    if isinstance(v, dict) else v.shape)
                for k, v in blk.tree().items()}
                for i, blk in enumerate(params.blocks)},
            "final_norm": params.final_norm.shape,
            "head_w": params.head_w.shape,
            "embed": {"table": params.embed.shape}}


def _numel(leaf) -> int:
    shape = getattr(leaf, "shape", leaf)
    n = 1
    for d in shape:
        n *= int(d)
    return n


def exact_param_counts(params_shape, cfg: ModelConfig):
    """(N_total, N_active) from the real params: excludes the input
    embedding table (gather, not matmul) and counts only top_k/E of each
    MoE expert stack as active."""
    total = active = 0

    def walk(path, node):
        nonlocal total, active
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (k,), v)
            return
        if path and path[-1] == "table":
            return                      # input embedding: no matmul flops
        n = _numel(node)
        total += n
        if cfg.moe is not None and path and path[-1].startswith("moe_w"):
            active += n * cfg.moe.top_k / cfg.moe.n_experts
        else:
            active += n
    walk((), _shape_tree(params_shape))
    return total, active


def model_flops(cfg: ModelConfig, shape: ShapeConfig,
                params_shape=None) -> dict:
    if params_shape is not None:
        _, n_act = exact_param_counts(params_shape, cfg)
    else:
        n_act = cfg.active_param_count()
    B, S = shape.global_batch, shape.seq_len
    D = B * S
    L = n_attn_layers(cfg)
    attn_inner = cfg.n_heads * cfg.head_dim

    if shape.kind == "train":
        base = 6.0 * n_act * D
        # 12 * L * (H*dh) * (S/2) per token, over D tokens
        attn = 12.0 * L * attn_inner * (S / 2.0) * D
    elif shape.kind == "prefill":
        base = 2.0 * n_act * D
        attn = 4.0 * L * attn_inner * (S / 2.0) * D
    else:  # decode: one token per sequence, full-depth KV read
        D = B
        base = 2.0 * n_act * B
        attn = 4.0 * L * attn_inner * S * B
    return {"model_flops": base, "attn_flops": attn,
            "model_flops_total": base + attn, "tokens": D}
