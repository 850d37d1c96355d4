"""Architecture registry: maps ``--arch`` ids to ModelConfigs.

All 10 assigned architectures + the paper's own LeNet-5.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import (jamba_1p5_large, kimi_k2_1t, lenet5,
                           moonshot_v1_16b, qwen1p5_0p5b, qwen2_0p5b,
                           qwen2_vl_72b, qwen3_32b, whisper_medium, xlstm_1p3b,
                           yi_6b)
from repro_torch.configs.base import (SHAPE_ORDER, SHAPES, ModelConfig, ShapeConfig,
                                cell_is_skipped)

_MODULES = (
    xlstm_1p3b, yi_6b, qwen1p5_0p5b, qwen2_0p5b, qwen3_32b, whisper_medium,
    qwen2_vl_72b, moonshot_v1_16b, kimi_k2_1t, jamba_1p5_large, lenet5,
)

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}

# The 10 assigned archs (lenet5 is the paper's own, outside the dry-run grid).
ASSIGNED: List[str] = [m.CONFIG.name for m in _MODULES if m.CONFIG.name != "lenet5"]


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests.

    Keeps every structural feature (pattern, MoE, GQA ratio, biases, norms,
    enc-dec) while shrinking widths/depths/embedding tables.
    """
    pattern = cfg.block_pattern
    if pattern is not None:
        n_layers = len(pattern)          # one period
    else:
        n_layers = 2
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, n_experts=min(8, moe.n_experts),
                                  top_k=min(2, moe.top_k), expert_d_ff=64)
    # preserve the GQA ratio where possible
    n_heads = 4
    ratio = max(1, cfg.n_heads // max(1, cfg.n_kv_heads))
    n_kv = max(1, n_heads // min(ratio, n_heads))
    return dataclasses.replace(
        cfg,
        n_layers=n_layers,
        d_model=64,
        head_dim=16,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=256,
        moe=moe,
        n_enc_layers=2 if cfg.enc_dec else 0,
        enc_seq=16 if cfg.enc_dec else 0,
        sharding=dataclasses.replace(cfg.sharding, remat="none"),
    )


def grid_cells(include_skipped: bool = False):
    """Yield (cfg, shape, skip_reason) across the 10x4 assigned grid."""
    for arch in ASSIGNED:
        cfg = REGISTRY[arch]
        for sname in SHAPE_ORDER:
            shape = SHAPES[sname]
            reason = cell_is_skipped(cfg, shape)
            if reason is None or include_skipped:
                yield cfg, shape, reason
