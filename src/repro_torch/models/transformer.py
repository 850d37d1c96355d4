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

``init_params_shape`` builds the module on the ``meta`` device, with no
draw: the weights' shapes and dtypes for the dry run.  ``forward``,
``loss_fn``, ``prefill`` and ``decode_step`` take a ``ctx`` (a
``sharding.specs.MeshCtx``; the default ``NO_MESH`` is one device, where
every constraint is a no-op and every ``ctx.local`` region calls its
function on the whole tensors).  Under a mesh the weights, batch and
state are DTensors, the residual stream is constrained where the JAX
package constrains it (``act_btd`` after the embedding, each mixer and each
FFN; the logits over the vocab), and the embedding, the cross entropy
and the mixers' kernels run in ``ctx.local`` regions (vocab-parallel
where the table and logits split over ``model``: each rank's rows, the
partial sums reduced over ``model``).
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
from repro_torch.sharding.specs import NO_MESH, P

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
            for name, t in moe_mod.moe_param_draws(cfg, dtype, generator,
                                                   device):
                setattr(self, name, param(t))
                del t          # not held whole through the next draw

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


def init_params_shape(cfg, dtype=None) -> TransformerLM:
    """The module on the ``meta`` device: every weight's shape and dtype,
    nothing allocated and nothing drawn."""
    with torch.device("meta"):
        return TransformerLM(cfg, dtype, "meta")


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
def gathered(ctx, bp):
    """A layer's weights (a ``params_view`` block) whole over the FSDP
    axis, gathered where the layer runs (inside its checkpoint, so a
    recomputation gathers again); the block itself with no FSDP axis (no
    mesh)."""
    if ctx.fsdp_axis is None:
        return bp

    def one(v):
        if isinstance(v, dict):
            return {k: one(t) for k, t in v.items()}
        return ctx.unshard_fsdp(v) if isinstance(v, torch.Tensor) else v
    return types.SimpleNamespace(**{k: one(v) for k, v in vars(bp).items()})


def _delta(ctx, x):
    """A mixer's or FFN's output (partial over ``model``) in the residual
    stream's layout.  Where that is seq-sharded (SP), by way of the whole
    sequence: an all-reduce, then each rank's rows, so that the gradient
    reaches the output projection whole (an all-gather) and not as a
    strided seq shard, which DTensor's matmul rules do not take."""
    return ctx.act_btd(ctx.full_seq(x))


def _apply_ffn(cfg, bp: Block, x: torch.Tensor, single: bool = False,
               ctx=NO_MESH) -> torch.Tensor:
    ffn = bp.spec[1]
    if ffn == "none":
        return x
    h = apply_norm(cfg, x, bp.ln2)
    if ffn == "moe":
        p = {"router": bp.router, "moe_wg": bp.moe_wg, "moe_wu": bp.moe_wu,
             "moe_wo": bp.moe_wo}
        fn = moe_mod.moe_ffn_single if single else moe_mod.moe_ffn
        delta = fn(cfg, p, h, ctx)
    else:
        delta = swiglu(ctx.full_seq(h), bp.wi_gate, bp.wi_up, bp.w_down, ctx)
    # the TP-partial output in the SP layout before the residual add: a
    # reduce-scatter, not an all-reduce and a slice
    return ctx.act_btd(x + _delta(ctx, delta))


def apply_block_train(cfg, bp: Block, x: torch.Tensor,
                      positions: torch.Tensor, return_cache: bool = False,
                      ctx=NO_MESH):
    """One layer over the whole sequence; with ``return_cache`` also the
    attention's K/V (``None`` for a recurrent mixer)."""
    bp = gathered(ctx, bp)
    mixer = bp.spec[0]
    cache = None
    if mixer == ATTN:
        h = apply_norm(cfg, x, bp.ln)
        delta = attn.attention_block(cfg, bp.attn, h, positions,
                                     return_cache=return_cache, ctx=ctx)
        if return_cache:
            delta, (k, v) = delta
            cache = {"k": k, "v": v}
        delta = _delta(ctx, delta)
    elif mixer == MAMBA:
        delta, _ = mamba_mod.mamba_block(cfg, bp.mamba,
                                         apply_norm(cfg, x, bp.ln), None, ctx)
    elif mixer == MLSTM:
        delta, _ = xlstm_mod.mlstm_block(cfg, bp.mlstm, x, None, ctx)
    else:
        delta, _ = xlstm_mod.slstm_block(cfg, bp.slstm, x, None, ctx)
    if mixer != ATTN:
        delta = _delta(ctx, delta)
    x = _apply_ffn(cfg, bp, ctx.act_btd(x + delta), ctx=ctx)
    if return_cache:
        return x, cache
    return x


def apply_block_decode(cfg, bp: Block, x: torch.Tensor,
                       state: Dict[str, torch.Tensor],
                       pos: int, ctx=NO_MESH) -> torch.Tensor:
    """One layer on one token; ``state`` is the layer's slice of the decode
    state (views), written in place."""
    bp = gathered(ctx, bp)
    mixer = bp.spec[0]
    if mixer == ATTN:
        h = apply_norm(cfg, x, bp.ln)
        delta = attn.decode_attention_block(cfg, bp.attn, h, state["k"],
                                            state["v"], pos, ctx)
    else:
        if mixer == MAMBA:
            delta, new = mamba_mod.mamba_block(
                cfg, bp.mamba, apply_norm(cfg, x, bp.ln), state, ctx)
        else:
            block = xlstm_mod.mlstm_block if mixer == MLSTM \
                else xlstm_mod.slstm_block
            delta, new = block(cfg, getattr(bp, mixer), x, state, ctx)
        for name, t in new.items():
            state[name].copy_(t)
    return _apply_ffn(cfg, bp, x + delta, single=True, ctx=ctx)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def embed(ctx, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``; under a mesh vocab-parallel where
    the table's rows split over ``model``: each rank looks up the tokens
    in its rows (zeros elsewhere), a partial sum over ``model``."""
    B, S = tokens.shape
    rows = ctx.fit(P(ctx.dp_axes or None, None), (B, S))[0]
    vocab = ctx.fit(P(ctx.tp_axis), (table.shape[0],))[0]

    def fn(tab, tok):
        if vocab is None:
            return F.embedding(tok, tab)
        n = tab.shape[0]
        local = tok - ctx.rank(vocab) * n
        hit = (local >= 0) & (local < n)
        out = F.embedding(local.clamp(0, n - 1), tab)
        return out * hit[..., None].to(out.dtype)

    return ctx.local(fn, (P(vocab, None), P(rows, None)),
                     P(rows, None, None),
                     out_partial=(vocab,) if vocab is not None else ())(
        table, tokens)


def _positions(cfg, ctx, B: int, S: int, device):
    """``positions_for`` (B, S) (or (3, B, S)); under a mesh a DTensor
    with the batch over the DP axes, each rank's rows made on the rank."""
    rows = ctx.fit(P(ctx.dp_axes or None), (B,))[0]
    spec = P(None, rows, None) if cfg.rope_variant == "mrope" \
        else P(rows, None)
    shape = (3, B, S) if cfg.rope_variant == "mrope" else (B, S)
    return ctx.distribute(lambda local: positions_for(
        cfg, local[-2], local[-1], device=device).contiguous(), shape, spec)


def embed_inputs(cfg, params: TransformerLM, batch, ctx=NO_MESH):
    """(x (B, S, d), positions): the embeddings of ``batch["tokens"]`` and
    their positions 0 .. S - 1; for an ``embeds`` config
    ``batch["embeds"]`` (in the model's dtype) and ``batch["positions"]``
    as they come."""
    if cfg.input_mode == "embeds":
        x, positions = batch["embeds"].to(params.head_w.dtype), \
            batch["positions"]
    else:
        tokens = batch["tokens"]
        x = embed(ctx, params.embed, tokens)
        positions = _positions(cfg, ctx, tokens.shape[0], tokens.shape[1],
                               x.device)
    return ctx.act_btd(x), positions


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


def forward(cfg, params: TransformerLM, batch, remat=None,
            ctx=NO_MESH) -> torch.Tensor:
    """Forward over the whole sequence -> logits (B, S, V); each layer
    checkpointed by ``remat`` (default ``cfg.sharding.remat``) where
    autograd records."""
    policy = remat if remat is not None else cfg.sharding.remat
    x, positions = embed_inputs(cfg, params, batch, ctx)
    for bp in params.blocks:
        x = _maybe_remat(functools.partial(apply_block_train, cfg, bp,
                                           ctx=ctx), policy)(x, positions)
    x = apply_norm(cfg, x, params.final_norm)
    return ctx.logits(ctx.full_seq(x) @ ctx.unshard_fsdp(params.head_w))


def _token_losses(logits: torch.Tensor, labels: torch.Tensor):
    """float32 logsumexp of each position's logits minus its label's."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return lse - ll


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ctx=NO_MESH) -> torch.Tensor:
    """Mean next-token cross entropy: float32 logsumexp of the logits
    minus the label's logit.  Under a mesh each rank takes its rows;
    where the vocab splits over ``model`` the logsumexp and the label's
    logit are reduced over it (the maximum, then the sums)."""
    B, S, V = logits.shape
    spec = ctx.fit(P(ctx.dp_axes or None, None, ctx.tp_axis), (B, S, V))
    rows, vocab = spec[0], spec[2]

    def fn(lg, lab):
        if vocab is None:
            return _token_losses(lg, lab)
        from torch.distributed import _functional_collectives as funcol
        group = ctx.group(vocab)
        lf = lg.to(torch.float32)
        m = funcol.all_reduce(lf.detach().amax(-1), "max", group)
        n = lf.shape[-1]
        local = lab.to(torch.int64) - ctx.rank(vocab) * n
        hit = (local >= 0) & (local < n)
        ll = torch.gather(lf, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        both = torch.stack([torch.exp(lf - m[..., None]).sum(-1),
                            torch.where(hit, ll, 0.0)])
        both = _SumOver.apply(both, group)
        return torch.log(both[0]) + m - both[1]

    loss = torch.mean(ctx.local(fn, (spec, P(rows, None)), P(rows, None))(
        logits, labels))
    return ctx.constrain(loss, P())


class _SumOver(torch.autograd.Function):
    """A sum over a process group's ranks, whose output every rank holds;
    its gradient reaches each rank's summand as it is."""

    @staticmethod
    def forward(ctx, t, group):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def loss_fn(cfg, params: TransformerLM, batch, remat=None,
            ctx=NO_MESH) -> torch.Tensor:
    """``cross_entropy`` of the forward's logits and ``batch["labels"]``."""
    return cross_entropy(forward(cfg, params, batch, remat, ctx),
                         batch["labels"], ctx)


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


def decode_logits(ctx, logits: torch.Tensor) -> torch.Tensor:
    """(B, V) decode logits: batch over DP, vocab over ``model`` under a
    mesh (the JAX package's constraint)."""
    return ctx.constrain(logits, P(ctx.dp_axes or None, ctx.tp_axis))


def decode_step(cfg, params: TransformerLM, state: State, batch,
                ctx=NO_MESH):
    """One-token decode.  batch: ``{"tokens": (B, 1), "pos": int}`` (the
    write index), or ``{"embeds": (B, 1, d), "pos": int}`` for an
    ``embeds`` config.  Returns (logits (B, V), state), the state written
    in place; the state comes back so that ``Model.decode`` keeps the JAX
    package's signature."""
    pos = int(batch["pos"])
    if cfg.input_mode == "embeds":
        x = batch["embeds"].to(params.head_w.dtype)
    else:
        x = embed(ctx, params.embed, batch["tokens"])
    for layer, j, i in _layer_items(cfg):
        layer_state = {k: v[j] for k, v in state[f"b{i}"].items()}
        x = apply_block_decode(cfg, params.blocks[layer], x, layer_state,
                               pos, ctx)
    x = apply_norm(cfg, x, params.final_norm)
    return decode_logits(ctx, (x @ ctx.unshard_fsdp(params.head_w))[:, 0]), \
        state


def prefill(cfg, params: TransformerLM, batch, ctx=NO_MESH):
    """Forward over the prompt, keeping the attention blocks' K/V: returns
    (the last position's logits (B, V), ``{"b{i}": {"k", "v"}}`` for the
    attention positions of the pattern, in the decode state's layout with
    S_max = S; empty for a recurrent-only stack).  Under a mesh the caches
    lie as the decode state does (``ctx.kv_cache_spec``)."""
    x, positions = embed_inputs(cfg, params, batch, ctx)
    B, S = x.shape[:2]
    shape = (cfg.n_periods, B, S, cfg.n_kv_heads, cfg.head_dim)
    spec = P(None, *ctx.kv_cache_spec())

    def cache():
        return {k: ctx.distribute(
            lambda local: torch.zeros(local, dtype=x.dtype, device=x.device),
            shape, spec) for k in ("k", "v")}
    caches = {f"b{i}": cache() for i, (mixer, _) in
              enumerate(block_specs(cfg)) if mixer == ATTN}
    for layer, j, i in _layer_items(cfg):
        x, kv = apply_block_train(cfg, params.blocks[layer], x, positions,
                                  return_cache=True, ctx=ctx)
        if kv is not None:
            for name in ("k", "v"):
                caches[f"b{i}"][name][j] = ctx.constrain(
                    kv[name], ctx.kv_cache_spec())
    x = apply_norm(cfg, ctx.full_seq(x)[:, -1:], params.final_norm)
    return (x @ ctx.unshard_fsdp(params.head_w))[:, 0], caches
