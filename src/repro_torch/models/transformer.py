"""Decoder-only token LM: the dense attention stack (``attn`` mixer with a
SwiGLU ``dense`` FFN), for forward, prefill and KV-cache decode.

The weights live in a :class:`TransformerLM` module: the embedding table,
a ``ModuleList`` of :class:`Block` s (pre-norm attention, then pre-norm
SwiGLU, each added to the residual stream) and the final norm and LM
head, all stored ``(in, out)`` as in the JAX package.  Layer ``l`` is
position ``i`` of period ``j`` of the config's block pattern, with
``l = j * len(pattern) + i``; the JAX package's parameters stack the
periods instead (``params["periods"]["b{i}"]``), and
``params_from_numpy`` / ``params_to_numpy`` carry them across.  Decode
state keeps the JAX layout: ``{"b{i}": {"k", "v": (n_periods, B, S_max,
Hkv, dh)}}``, updated in place.

Blocks of other kinds raise ``NotImplementedError`` naming the ROADMAP.md
item that ports them: MoE FFN (queue 1 item 10(b)), xLSTM (10(c)), Mamba,
whisper, the VLM and LeNet (10(e)).  Weights are serving weights: the
module does not require gradients (training is item 10(d)).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.configs.base import MAMBA, MLSTM, SLSTM
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (apply_norm, dense_init, positions_for,
                                       swiglu)

State = Dict[str, Dict[str, torch.Tensor]]

_UNPORTED = {
    "moe": "the MoE FFN (ROADMAP.md queue 1 item 10(b))",
    MLSTM: "the mLSTM block (ROADMAP.md queue 1 item 10(c))",
    SLSTM: "the sLSTM block (ROADMAP.md queue 1 item 10(c))",
    MAMBA: "the Mamba block (ROADMAP.md queue 1 item 10(e))",
}


def block_specs(cfg):
    """[(mixer, ffn_kind)] for one period."""
    specs = []
    for i, kind in enumerate(cfg.pattern):
        if kind in (MLSTM, SLSTM):
            specs.append((kind, "none"))
            continue
        ffn = "dense" if cfg.moe is None else (
            "moe" if (cfg.moe.period == 1
                      or i % cfg.moe.period == cfg.moe.period - 1)
            else "dense")
        specs.append((kind, ffn))
    return specs


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a config this slice does not run."""
    if cfg.family == "conv":
        raise NotImplementedError(f"{cfg.name}: LeNet is not ported yet "
                                  f"(ROADMAP.md queue 1 item 10(e))")
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder (whisper) "
                                  f"is not ported yet (ROADMAP.md queue 1 "
                                  f"item 10(e))")
    if cfg.input_mode != "tokens":
        raise NotImplementedError(f"{cfg.name}: {cfg.input_mode} inputs are "
                                  f"not ported yet (ROADMAP.md queue 1 item "
                                  f"10(e))")
    for mixer, ffn in block_specs(cfg):
        for kind in (mixer, ffn):
            if kind in _UNPORTED:
                raise NotImplementedError(f"{cfg.name}: {_UNPORTED[kind]} is "
                                          f"not ported yet")


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class Block(nn.Module):
    """One ``attn`` + ``dense`` layer: ``ln``, ``attn`` (a ParameterDict:
    see ``models.attention``), ``ln2``, ``wi_gate``, ``wi_up``,
    ``w_down``."""

    def __init__(self, cfg, dtype: torch.dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.ln = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.attn = nn.ParameterDict(attn.init_attn_params(
            cfg, dtype, generator, device))
        self.ln2 = nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        self.wi_gate = nn.Parameter(dense_init((d, f), dtype, generator,
                                               device))
        self.wi_up = nn.Parameter(dense_init((d, f), dtype, generator, device))
        self.w_down = nn.Parameter(dense_init((f, d), dtype, generator,
                                              device))


class TransformerLM(nn.Module):
    """The weights of a dense token LM.  With a ``generator`` they are
    drawn on ``device`` (truncated normals, fan-in scaled; norms ones,
    biases zeros); without one they are left uninitialised for loading."""

    def __init__(self, cfg, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = _torch_dtype(dtype or cfg.dtype)
        dev = resolve_device(device)
        self.blocks = nn.ModuleList(Block(cfg, dtype, dev, generator)
                                    for _ in range(cfg.n_layers))
        d, vocab = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(dense_init((vocab, d), dtype, generator,
                                             dev))
        self.final_norm = nn.Parameter(torch.ones(d, dtype=dtype, device=dev))
        self.head_w = nn.Parameter(dense_init((d, vocab), dtype, generator,
                                              dev))
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.head_w.device


def init_params(cfg, generator: torch.Generator, dtype=None,
                device=None) -> TransformerLM:
    return TransformerLM(cfg, dtype, device, generator)


# ---------------------------------------------------------------------------
# The JAX package's stacked parameter tree
# ---------------------------------------------------------------------------
def _from_host(a) -> torch.Tensor:
    a = np.array(a)                        # a writable copy
    if a.dtype.name == "bfloat16":         # ml_dtypes' bfloat16, as JAX's
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _layer_items(cfg):
    """(layer, period j, pattern position i) for every block."""
    n = len(block_specs(cfg))
    return [(j * n + i, j, i) for j in range(cfg.n_periods) for i in range(n)]


def params_from_numpy(cfg, tree, device=None, dtype=None) -> TransformerLM:
    """The JAX package's parameter tree (numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as a :class:`TransformerLM` on
    ``device`` (the card unless named), in ``dtype`` (default: the tree's)."""
    if dtype is None:
        name = np.asarray(tree["head_w"]).dtype.name
        dtype = torch.bfloat16 if name == "bfloat16" else getattr(torch, name)
    dtype = _torch_dtype(dtype)
    model = TransformerLM(cfg, dtype, device)

    def put(dst: torch.Tensor, a) -> None:
        dst.copy_(_from_host(a).to(dtype))

    for layer, j, i in _layer_items(cfg):
        src, blk = tree["periods"][f"b{i}"], model.blocks[layer]
        for name in ("ln", "ln2", "wi_gate", "wi_up", "w_down"):
            put(getattr(blk, name), src[name][j])
        if set(src["attn"]) != set(blk.attn):
            raise ValueError(f"attention parameters {sorted(src['attn'])} "
                             f"do not match {cfg.name}'s {sorted(blk.attn)}")
        for name, a in src["attn"].items():
            put(blk.attn[name], a[j])
    put(model.embed, tree["embed"]["table"])
    put(model.final_norm, tree["final_norm"])
    put(model.head_w, tree["head_w"])
    return model


def params_to_numpy(params: TransformerLM):
    """The module's weights as the JAX package's stacked tree of numpy
    arrays (bfloat16 weights as float32, which holds them exactly)."""
    cfg = params.cfg

    def host(t: torch.Tensor) -> np.ndarray:
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.detach().cpu().numpy()

    periods = {}
    for i in range(len(block_specs(cfg))):
        layers = [params.blocks[layer] for layer, _, pi in _layer_items(cfg)
                  if pi == i]
        leaf = {name: np.stack([host(getattr(b, name)) for b in layers])
                for name in ("ln", "ln2", "wi_gate", "wi_up", "w_down")}
        leaf["attn"] = {name: np.stack([host(b.attn[name]) for b in layers])
                        for name in layers[0].attn}
        periods[f"b{i}"] = leaf
    return {"periods": periods, "final_norm": host(params.final_norm),
            "head_w": host(params.head_w),
            "embed": {"table": host(params.embed)}}


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _apply_ffn(cfg, bp: Block, x: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg, x, bp.ln2)
    return x + swiglu(h, bp.wi_gate, bp.wi_up, bp.w_down)


def apply_block_train(cfg, bp: Block, x: torch.Tensor,
                      positions: torch.Tensor, return_cache: bool = False):
    h = apply_norm(cfg, x, bp.ln)
    delta, (k, v) = attn.attention_block(cfg, bp.attn, h, positions,
                                         return_cache=True)
    x = _apply_ffn(cfg, bp, x + delta)
    if return_cache:
        return x, {"k": k, "v": v}
    return x


def apply_block_decode(cfg, bp: Block, x: torch.Tensor,
                       cache_k: torch.Tensor, cache_v: torch.Tensor,
                       pos: int) -> torch.Tensor:
    h = apply_norm(cfg, x, bp.ln)
    delta = attn.decode_attention_block(cfg, bp.attn, h, cache_k, cache_v,
                                        pos)
    return _apply_ffn(cfg, bp, x + delta)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def embed_inputs(cfg, params: TransformerLM, batch):
    tokens = batch["tokens"]
    x = F.embedding(tokens, params.embed)
    positions = positions_for(cfg, tokens.shape[0], tokens.shape[1],
                              device=x.device)
    return x, positions


def forward(cfg, params: TransformerLM, batch) -> torch.Tensor:
    """Forward over the whole sequence -> logits (B, S, V)."""
    x, positions = embed_inputs(cfg, params, batch)
    for bp in params.blocks:
        x = apply_block_train(cfg, bp, x, positions)
    x = apply_norm(cfg, x, params.final_norm)
    return x @ params.head_w


def init_decode_state(cfg, batch: int, max_len: int, dtype=None,
                      device=None) -> State:
    """Zero KV caches, stacked per period as the JAX package stacks them."""
    dtype = _torch_dtype(dtype or cfg.dtype)
    dev = resolve_device(device)
    return {f"b{i}": attn.init_kv_cache(cfg, batch, max_len, cfg.n_periods,
                                        dtype, dev)
            for i in range(len(block_specs(cfg)))}


def decode_step(cfg, params: TransformerLM, state: State, batch):
    """One-token decode.  batch: ``{"tokens": (B, 1), "pos": int}`` (the
    write index).  Returns (logits (B, V), state), the state's caches
    written in place; the state comes back so that ``Model.decode`` keeps
    the JAX package's signature."""
    pos = int(batch["pos"])
    x = F.embedding(batch["tokens"], params.embed)
    for layer, j, i in _layer_items(cfg):
        st = state[f"b{i}"]
        x = apply_block_decode(cfg, params.blocks[layer], x, st["k"][j],
                               st["v"][j], pos)
    x = apply_norm(cfg, x, params.final_norm)
    return (x @ params.head_w)[:, 0], state


def prefill(cfg, params: TransformerLM, batch):
    """Forward over the prompt, keeping every layer's K/V: returns (the
    last position's logits (B, V), caches in the decode state's layout
    with S_max = S)."""
    x, positions = embed_inputs(cfg, params, batch)
    B, S = batch["tokens"].shape
    caches = init_decode_state(cfg, B, S, x.dtype, x.device)
    for layer, j, i in _layer_items(cfg):
        x, kv = apply_block_train(cfg, params.blocks[layer], x, positions,
                                  return_cache=True)
        caches[f"b{i}"]["k"][j] = kv["k"]
        caches[f"b{i}"]["v"][j] = kv["v"]
    x = apply_norm(cfg, x[:, -1:], params.final_norm)
    return (x @ params.head_w)[:, 0], caches
