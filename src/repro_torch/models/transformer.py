"""Decoder-only LM: stacks of attention (``attn``), Mamba, mLSTM and sLSTM
mixers with a SwiGLU ``dense`` FFN, an MoE FFN or none, per the config's
block pattern, for forward, prefill and decode, on tokens or (the VLM's
backbone) on precomputed embeddings.

The weights live in a :class:`TransformerLM` module: the embedding table
(none where the config's ``input_mode`` is ``embeds``), a ``ModuleList``
of :class:`Block` s and the final norm and LM head, all stored ``(in,
out)`` as in the JAX package.  A block holds one mixer (``ln`` and the
``attn`` or ``mamba`` ParameterDict, the Mamba's ``A_log`` and ``D``
float32 in every model dtype; or the ``mlstm`` or ``slstm`` ParameterDict,
which carry their own norms and FFN) and one FFN (``ln2``
and ``wi_gate``, ``wi_up``, ``w_down``; or ``ln2`` and the MoE's
``router``, float32 in every model dtype, ``moe_wg``, ``moe_wu``,
``moe_wo``; or none), as ``block_specs`` gives them.  Layer ``l`` is
position ``i`` of period ``j`` of the pattern, with ``l = j *
len(pattern) + i``; the JAX package's parameters stack the periods instead
(``params["periods"]["b{i}"]``), and ``params_from_numpy`` /
``params_to_numpy`` carry them across.  Decode state keeps the JAX layout,
stacked over periods and updated in place: ``{"k", "v": (n_periods, B,
S_max, Hkv, dh)}`` for attention, ``{"conv", "ssm"}`` for Mamba (the conv
state in the model's dtype, the SSM state float32), ``{"C", "n", "m"}``
for mLSTM and ``{"h", "c", "nn", "mm"}`` for sLSTM (float32).  Prefill
returns the attention blocks' caches only, as the JAX prefill does: it
emits no recurrent state.

With ``input_mode == "embeds"`` (qwen2-vl: the vision frontend is a stub)
a batch carries ``embeds`` (B, S, d) and ``positions``, (3, B, S) for
M-RoPE's temporal, height and width streams, instead of ``tokens``; a
decode step carries ``embeds`` (B, 1, d), and its position is ``pos`` in
all three streams, as in the JAX package.

Training differentiates a flat dict of the weights instead, keyed as
``named_parameters`` names them (``train_params``; ``params_view`` gives
the forward the module's attributes over it): the module itself stays
frozen for serving.  ``loss_fn`` is the JAX package's float32 logsumexp
minus the label's logit, averaged; ``forward``'s ``remat`` (default the
config's ``sharding.remat``) checkpoints each layer: ``full`` keeps only
its input, ``dots`` also the outputs of its matrix products (``aten.mm``
and ``aten.addmm``, the products without batch dimensions, as
``dots_with_no_batch_dims_saveable`` keeps), ``none`` everything.  The
JAX package checkpoints a period of the pattern, which is a layer for
every pattern of one block.  ``flat_to_numpy`` gives a flat dict (the
gradients) back in the JAX layout, and ``param_groups`` names each key's
JAX leaf for adafactor.

The encoder-decoder (whisper, audio inputs) is ``models/encdec.py``'s
``EncDecLM``, which ``models.model.Model`` builds for it.
"""
from __future__ import annotations

import functools
import types
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ATTN, MAMBA, MLSTM, SLSTM
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (apply_norm, dense_init, positions_for,
                                       swiglu)

State = Dict[str, Dict[str, torch.Tensor]]


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
    """Raise ``NotImplementedError`` for a config the port does not run.
    The conv family (LeNet) runs, as ``models.lenet.LeNet``, and the
    encoder-decoder (whisper, ``audio`` inputs) as
    ``models.encdec.EncDecLM``, which ``models.model`` builds for them."""
    if cfg.family == "conv":
        return
    modes = ("audio",) if cfg.enc_dec else ("tokens", "embeds")
    if cfg.input_mode not in modes:
        raise NotImplementedError(f"{cfg.name}: {cfg.input_mode} inputs "
                                  f"{'with' if cfg.enc_dec else 'without'} "
                                  f"an encoder are not supported")


def _torch_dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


class Block(nn.Module):
    """One layer: a mixer and an FFN as ``spec`` = (mixer, ffn) names them
    (see the module docstring for the parameters of each)."""

    def __init__(self, cfg, spec, dtype: torch.dtype, device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.spec = spec
        mixer, ffn = spec
        d = cfg.d_model
        param = nn.Parameter
        if mixer == ATTN:
            self.ln = param(torch.ones(d, dtype=dtype, device=device))
            self.attn = nn.ParameterDict(attn.init_attn_params(
                cfg, dtype, generator, device))
        elif mixer == MAMBA:
            self.ln = param(torch.ones(d, dtype=dtype, device=device))
            self.mamba = nn.ParameterDict(mamba_mod.init_mamba_params(
                cfg, dtype, generator, device))
        elif mixer == MLSTM:
            self.mlstm = nn.ParameterDict(xlstm_mod.init_mlstm_params(
                cfg, dtype, generator, device))
        elif mixer == SLSTM:
            self.slstm = nn.ParameterDict(xlstm_mod.init_slstm_params(
                cfg, dtype, generator, device))
        else:
            raise ValueError(mixer)
        if ffn == "dense":
            f = cfg.d_ff
            self.ln2 = param(torch.ones(d, dtype=dtype, device=device))
            self.wi_gate = param(dense_init((d, f), dtype, generator, device))
            self.wi_up = param(dense_init((d, f), dtype, generator, device))
            self.w_down = param(dense_init((f, d), dtype, generator, device))
        elif ffn == "moe":
            self.ln2 = param(torch.ones(d, dtype=dtype, device=device))
            for name, t in moe_mod.init_moe_params(cfg, dtype, generator,
                                                   device).items():
                setattr(self, name, param(t))

    def tree(self) -> Dict[str, object]:
        """The block's parameters in the JAX package's per-block layout:
        ``{name: tensor}``, the mixer's ParameterDict as a nested dict."""
        out: Dict[str, object] = dict(self.named_parameters(recurse=False))
        for name, child in self.named_children():
            out[name] = dict(child.items())
        return out


class TransformerLM(nn.Module):
    """The weights of an LM.  With a ``generator`` they are drawn on
    ``device`` (truncated normals, fan-in scaled; norms ones, biases
    zeros, the sLSTM's and mLSTM's forget biases 3, the Mamba's A_log
    log(1 .. ds) and D ones); without one they are left uninitialised for
    loading.  ``embed`` is None for an ``embeds`` config."""

    def __init__(self, cfg, dtype=None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.family == "conv":
            raise ValueError(f"{cfg.name} is a conv config: LeNet, which "
                             f"models.model.build_model builds "
                             f"(models/lenet.py), not a token LM")
        if cfg.enc_dec:
            raise ValueError(f"{cfg.name} is an encoder-decoder: EncDecLM, "
                             f"which models.model.build_model builds "
                             f"(models/encdec.py), not a decoder-only LM")
        check_supported(cfg)
        self.cfg = cfg
        dtype = _torch_dtype(dtype or cfg.dtype)
        dev = resolve_device(device)
        specs = block_specs(cfg)
        self.blocks = nn.ModuleList(
            Block(cfg, specs[i], dtype, dev, generator)
            for _, _, i in _layer_items(cfg))
        d, vocab = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(dense_init((vocab, d), dtype, generator,
                                             dev)) \
            if cfg.input_mode == "tokens" else None
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
    ``device`` (the card unless named), in ``dtype`` (default: the
    tree's).  Each leaf keeps its module's dtype: the MoE router stays
    float32."""
    if dtype is None:
        name = np.asarray(tree["head_w"]).dtype.name
        dtype = torch.bfloat16 if name == "bfloat16" else getattr(torch, name)
    dtype = _torch_dtype(dtype)
    model = TransformerLM(cfg, dtype, device)

    def put(dst: torch.Tensor, a) -> None:
        dst.copy_(_from_host(a).to(dst.dtype))

    def keys(t) -> list:
        return sorted((k, sorted(v) if isinstance(v, dict) else None)
                      for k, v in t.items())

    for layer, j, i in _layer_items(cfg):
        src, dst = tree["periods"][f"b{i}"], model.blocks[layer].tree()
        if keys(src) != keys(dst):
            raise ValueError(f"block b{i}'s parameters {keys(src)} do not "
                             f"match {cfg.name}'s {keys(dst)}")
        for name, t in dst.items():
            if isinstance(t, dict):
                for sub, leaf in t.items():
                    put(leaf, src[name][sub][j])
            else:
                put(t, src[name][j])
    if model.embed is not None:
        put(model.embed, tree["embed"]["table"])
    put(model.final_norm, tree["final_norm"])
    put(model.head_w, tree["head_w"])
    return model


def params_to_numpy(params: TransformerLM):
    """The module's weights as the JAX package's stacked tree of numpy
    arrays (bfloat16 weights as float32, which holds them exactly; the
    float32 router as it is)."""
    return flat_to_numpy(params.cfg, train_params(params))


def _block_tree(flat: Dict[str, torch.Tensor], prefix: str) -> dict:
    """The entries of a flat dict under ``prefix`` (``blocks.3.``) in the
    per-block layout: ``{name: tensor}``, a mixer's parameters as a
    nested dict."""
    out = {}
    for key, t in flat.items():
        if key.startswith(prefix):
            *path, name = key[len(prefix):].split(".")
            node = out
            for part in path:
                node = node.setdefault(part, {})
            node[name] = t
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as numpy, bfloat16 as float32."""
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.detach().cpu().numpy()


def _stack(trees: list):
    """Per-block trees (``_block_tree``) stacked leaf by leaf, as the JAX
    package stacks a block's weights over the layers."""
    if isinstance(trees[0], dict):
        return {k: _stack([tree[k] for tree in trees]) for k in trees[0]}
    return np.stack([_host(t) for t in trees])


def flat_to_numpy(cfg, flat: Dict[str, torch.Tensor]):
    """A flat dict keyed as ``named_parameters`` (the weights, or their
    gradients) as the JAX package's stacked tree of numpy arrays, bfloat16
    as float32."""
    periods = {}
    for i in range(len(block_specs(cfg))):
        periods[f"b{i}"] = _stack([_block_tree(flat, f"blocks.{layer}.")
                                   for layer, _, pi in _layer_items(cfg)
                                   if pi == i])
    out = {"periods": periods, "final_norm": _host(flat["final_norm"]),
           "head_w": _host(flat["head_w"])}
    if "embed" in flat:
        out["embed"] = {"table": _host(flat["embed"])}
    return out


def param_groups(cfg, flat) -> Dict[str, Tuple[str, Optional[int]]]:
    """``{key: (leaf, j)}`` for ``optim.make_optimizer``'s adafactor: the
    JAX package's leaf that holds each key (``periods.b{i}.<name>``,
    stacked over the periods, ``j`` the period; the embedding, final norm
    and head unstacked, ``j`` None)."""
    layers = {layer: (j, i) for layer, j, i in _layer_items(cfg)}
    out = {}
    for key in flat:
        if key.startswith("blocks."):
            _, layer, rest = key.split(".", 2)
            j, i = layers[int(layer)]
            out[key] = (f"periods.b{i}.{rest}", j)
        else:
            out[key] = (key, None)
    return out


def train_params(params: TransformerLM) -> Dict[str, torch.Tensor]:
    """The module's weights as a flat dict keyed as ``named_parameters``:
    tensors detached from the frozen module, sharing its storage."""
    return {k: p.detach() for k, p in params.named_parameters()}


def params_view(cfg, flat: Dict[str, torch.Tensor]):
    """A flat dict of weights with the attributes the forward reads from a
    :class:`TransformerLM` (``blocks[l].attn["wq"]``, ``embed``, ...), so
    that the forward differentiates the dict's tensors themselves."""
    specs = block_specs(cfg)
    blocks = [types.SimpleNamespace(spec=specs[i],
                                    **_block_tree(flat, f"blocks.{layer}."))
              for layer, _, i in _layer_items(cfg)]
    return types.SimpleNamespace(cfg=cfg, blocks=blocks,
                                 embed=flat.get("embed"),
                                 final_norm=flat["final_norm"],
                                 head_w=flat["head_w"],
                                 device=flat["head_w"].device)


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _apply_ffn(cfg, bp: Block, x: torch.Tensor,
               single: bool = False) -> torch.Tensor:
    ffn = bp.spec[1]
    if ffn == "none":
        return x
    h = apply_norm(cfg, x, bp.ln2)
    if ffn == "moe":
        p = {"router": bp.router, "moe_wg": bp.moe_wg, "moe_wu": bp.moe_wu,
             "moe_wo": bp.moe_wo}
        fn = moe_mod.moe_ffn_single if single else moe_mod.moe_ffn
        return x + fn(cfg, p, h)
    return x + swiglu(h, bp.wi_gate, bp.wi_up, bp.w_down)


def apply_block_train(cfg, bp: Block, x: torch.Tensor,
                      positions: torch.Tensor, return_cache: bool = False):
    """One layer over the whole sequence; with ``return_cache`` also the
    attention's K/V (``None`` for a recurrent mixer)."""
    mixer = bp.spec[0]
    cache = None
    if mixer == ATTN:
        h = apply_norm(cfg, x, bp.ln)
        delta, (k, v) = attn.attention_block(cfg, bp.attn, h, positions,
                                             return_cache=True)
        cache = {"k": k, "v": v}
    elif mixer == MAMBA:
        delta, _ = mamba_mod.mamba_block(cfg, bp.mamba,
                                         apply_norm(cfg, x, bp.ln))
    elif mixer == MLSTM:
        delta, _ = xlstm_mod.mlstm_block(cfg, bp.mlstm, x)
    else:
        delta, _ = xlstm_mod.slstm_block(cfg, bp.slstm, x)
    x = _apply_ffn(cfg, bp, x + delta)
    if return_cache:
        return x, cache
    return x


def apply_block_decode(cfg, bp: Block, x: torch.Tensor,
                       state: Dict[str, torch.Tensor],
                       pos: int) -> torch.Tensor:
    """One layer on one token; ``state`` is the layer's slice of the decode
    state (views), written in place."""
    mixer = bp.spec[0]
    if mixer == ATTN:
        h = apply_norm(cfg, x, bp.ln)
        delta = attn.decode_attention_block(cfg, bp.attn, h, state["k"],
                                            state["v"], pos)
    else:
        if mixer == MAMBA:
            delta, new = mamba_mod.mamba_block(
                cfg, bp.mamba, apply_norm(cfg, x, bp.ln), state)
        else:
            block = xlstm_mod.mlstm_block if mixer == MLSTM \
                else xlstm_mod.slstm_block
            delta, new = block(cfg, getattr(bp, mixer), x, state)
        for name, t in new.items():
            state[name].copy_(t)
    return _apply_ffn(cfg, bp, x + delta, single=True)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def embed_inputs(cfg, params: TransformerLM, batch):
    """(x (B, S, d), positions): the embeddings of ``batch["tokens"]`` and
    their positions 0 .. S - 1; for an ``embeds`` config
    ``batch["embeds"]`` (in the model's dtype) and ``batch["positions"]``
    as they come."""
    if cfg.input_mode == "embeds":
        return batch["embeds"].to(params.head_w.dtype), batch["positions"]
    tokens = batch["tokens"]
    x = F.embedding(tokens, params.embed)
    positions = positions_for(cfg, tokens.shape[0], tokens.shape[1],
                              device=x.device)
    return x, positions


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kw):
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, policy: str):
    """``fn`` checkpointed by ``policy`` (none | dots | full) where
    autograd records; as it is otherwise."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn
    if policy == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _dots_policy))
    if policy != "full":
        raise ValueError(f"remat policy {policy!r}")
    return functools.partial(checkpoint, fn, use_reentrant=False)


def forward(cfg, params: TransformerLM, batch, remat=None) -> torch.Tensor:
    """Forward over the whole sequence -> logits (B, S, V); each layer
    checkpointed by ``remat`` (default ``cfg.sharding.remat``) where
    autograd records."""
    policy = remat if remat is not None else cfg.sharding.remat
    x, positions = embed_inputs(cfg, params, batch)
    for bp in params.blocks:
        x = _maybe_remat(functools.partial(apply_block_train, cfg, bp),
                         policy)(x, positions)
    x = apply_norm(cfg, x, params.final_norm)
    return x @ params.head_w


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy: float32 logsumexp of the logits
    minus the label's logit."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.mean(lse - ll)


def loss_fn(cfg, params: TransformerLM, batch, remat=None) -> torch.Tensor:
    """``cross_entropy`` of the forward's logits and ``batch["labels"]``."""
    return cross_entropy(forward(cfg, params, batch, remat), batch["labels"])


def _stacked(state: Dict[str, torch.Tensor], n: int):
    return {k: v.expand(n, *v.shape).clone() for k, v in state.items()}


def init_decode_state(cfg, batch: int, max_len: int, dtype=None,
                      device=None) -> State:
    """The initial decode state, stacked per period as the JAX package
    stacks it: zero KV caches in ``dtype`` (default: the config's) for
    attention, the Mamba's zero conv state in ``dtype`` and SSM state in
    float32, the initial float32 mLSTM / sLSTM states."""
    dtype = _torch_dtype(dtype or cfg.dtype)
    dev = resolve_device(device)
    P = cfg.n_periods

    def one(mixer):
        if mixer == ATTN:
            return attn.init_kv_cache(cfg, batch, max_len, P, dtype, dev)
        if mixer == MAMBA:
            return _stacked(mamba_mod.init_mamba_state(cfg, batch, dtype,
                                                       dev), P)
        if mixer == MLSTM:
            return _stacked(xlstm_mod.init_mlstm_state(cfg, batch, dev), P)
        return _stacked(xlstm_mod.init_slstm_state(cfg, batch, dev), P)

    return {f"b{i}": one(mixer)
            for i, (mixer, _) in enumerate(block_specs(cfg))}


def decode_step(cfg, params: TransformerLM, state: State, batch):
    """One-token decode.  batch: ``{"tokens": (B, 1), "pos": int}`` (the
    write index), or ``{"embeds": (B, 1, d), "pos": int}`` for an
    ``embeds`` config.  Returns (logits (B, V), state), the state written
    in place; the state comes back so that ``Model.decode`` keeps the JAX
    package's signature."""
    pos = int(batch["pos"])
    if cfg.input_mode == "embeds":
        x = batch["embeds"].to(params.head_w.dtype)
    else:
        x = F.embedding(batch["tokens"], params.embed)
    for layer, j, i in _layer_items(cfg):
        layer_state = {k: v[j] for k, v in state[f"b{i}"].items()}
        x = apply_block_decode(cfg, params.blocks[layer], x, layer_state,
                               pos)
    x = apply_norm(cfg, x, params.final_norm)
    return (x @ params.head_w)[:, 0], state


def prefill(cfg, params: TransformerLM, batch):
    """Forward over the prompt, keeping the attention blocks' K/V: returns
    (the last position's logits (B, V), ``{"b{i}": {"k", "v"}}`` for the
    attention positions of the pattern, in the decode state's layout with
    S_max = S; empty for a recurrent-only stack)."""
    x, positions = embed_inputs(cfg, params, batch)
    B, S = x.shape[:2]
    caches = {f"b{i}": attn.init_kv_cache(cfg, B, S, cfg.n_periods, x.dtype,
                                          x.device)
              for i, (mixer, _) in enumerate(block_specs(cfg))
              if mixer == ATTN}
    for layer, j, i in _layer_items(cfg):
        x, kv = apply_block_train(cfg, params.blocks[layer], x, positions,
                                  return_cache=True)
        if kv is not None:
            caches[f"b{i}"]["k"][j] = kv["k"]
            caches[f"b{i}"]["v"][j] = kv["v"]
    x = apply_norm(cfg, x[:, -1:], params.final_norm)
    return (x @ params.head_w)[:, 0], caches
