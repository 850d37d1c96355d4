"""Sharding policies: where weights, activations, caches and the ledger
fabric's lanes lie on a mesh.

Axis conventions (``launch/mesh.py``):

  single-pod : (16, 16)      -> ("data", "model")
  multi-pod  : (2, 16, 16)   -> ("pod", "data", "model")
  ledger     : (K,)          -> ("shard",)   [make_shard_mesh]

Policies (the JAX package's ``src/repro/sharding/specs.py``):

  DP    batch over ("pod", "data")      (FL trainers = data-axis groups)
  FSDP  weights and optimizer state over "data"
  TP    matmul contract / output dims over "model"
  EP    MoE experts over "model"
  SP    the residual stream's seq dim over "model" (the big archs)
  KV-SP the decode KV cache's seq dim over "model"

A partition spec (:class:`PartitionSpec`, ``P``) is a tuple with one
entry a tensor dim: an axis name, a tuple of names (the dim split over
each, the first outermost) or ``None``.  ``to_placements`` turns one into
DTensor placements on a ``DeviceMesh``.  The rules read only the mesh's
axis names and sizes (``axis_sizes``), so any object with
``mesh_dim_names`` and ``shape``, or ``axis_names`` and a ``shape``
mapping, will do where no process group exists.

The JAX package stacks a block's weights over the periods of its pattern
(``periods.b{i}.<name>``, a leading period dim that is never sharded);
the port keeps them per layer (``blocks.{l}.<name>``).
``params_pspec_tree`` maps each port key to its JAX leaf through the
model's ``param_groups`` and gives it the JAX leaf's spec without the
leading ``None``.

:class:`MeshCtx` carries a mesh and an architecture's
``ShardingPolicy``.  ``constrain`` redistributes a DTensor to a spec, and
``local`` runs a function on each rank's shards (``local_map``): the
kernels and the ops that DTensor has no sharding rule for run there, on
local tensors, as the TPU kernels run inside GSPMD.  The model code
takes one path: with no mesh (``NO_MESH``, every model function's
default) each helper is a no-op and ``local`` calls the function
itself, so the one-device step runs the same ops.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import ShardingPolicy

#: the ledger fabric's 1-D mesh axis (launch/mesh.make_shard_mesh)
SHARD_LANE_AXIS = "shard"


class PartitionSpec(tuple):
    """One entry a tensor dim: an axis name, a tuple of axis names, or
    ``None`` (replicated).  A tuple of one name is that name, as JAX's
    ``PartitionSpec`` has it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


@dataclasses.dataclass(frozen=True)
class LaneSpec:
    """How ``(K, W)`` lane buffers split over a mesh axis: contiguous
    row blocks, one a device, rows padded to a multiple of the mesh size
    by empty lanes; the word axis stays whole on each device."""

    axis: str = SHARD_LANE_AXIS

    def padded_rows(self, n_rows: int, mesh_size: int) -> int:
        """Rows after padding ``n_rows`` to a multiple of the mesh size."""
        return -(-n_rows // mesh_size) * mesh_size

    def blocks(self, n_rows: int, mesh_size: int):
        """The ``[lo, hi)`` row block of each device, over the padded
        rows."""
        per = self.padded_rows(n_rows, mesh_size) // mesh_size
        return [(i * per, (i + 1) * per) for i in range(mesh_size)]


def shard_lane_spec() -> LaneSpec:
    """The split of shard-lane buffers (kernels/shard_lanes.py): lane
    rows over the ``"shard"`` axis, each device folding its own lanes
    with no traffic between devices."""
    return LaneSpec()


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where one tensor lies."""

    mesh: object
    spec: PartitionSpec

    def placements(self, ndim: Optional[int] = None):
        return to_placements(self.mesh, self.spec, ndim)


def shard_lane_sharding(mesh) -> NamedSharding:
    """``shard_lane_spec``'s split as a sharding: lane rows over
    ``"shard"``, the word dim whole."""
    return NamedSharding(mesh, P(SHARD_LANE_AXIS, None))


# -----------------------------------------------------------------------------
# Meshes and placements
# -----------------------------------------------------------------------------
def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return tuple(names)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis: size}`` in the mesh's axis order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: dict(mesh.shape)[a] for a in axis_names(mesh)}


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def to_placements(mesh, spec, ndim: Optional[int] = None,
                  partial: Sequence[str] = ()):
    """DTensor placements of ``spec`` on ``mesh``: one a mesh axis,
    ``Shard(d)`` where tensor dim d's entry names the axis, ``Partial()``
    for the axes in ``partial`` (a sum still to be taken), ``Replicate()``
    otherwise."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    entries = tuple(spec)
    if ndim is not None:
        entries = entries + (None,) * (ndim - len(entries))
    out = []
    for name in axis_names(mesh):
        dims = [d for d, e in enumerate(entries) if name in _axes(e)]
        if len(dims) > 1:
            raise ValueError(f"spec {spec} names axis {name!r} twice")
        if name in partial:
            if dims:
                raise ValueError(f"axis {name!r} is both sharded and "
                                 f"partial in {spec}")
            out.append(Partial())
        else:
            out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def sanitize_spec(mesh, spec, shape) -> PartitionSpec:
    """Drop spec entries whose mesh-axis product does not divide the dim
    (nh 4 over 16-way TP, vocab 51,865, B = 1 decode: replicated
    instead)."""
    if mesh is None:
        return spec
    sizes = axis_sizes(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        prod = 1
        for a in _axes(entry):
            prod *= sizes[a]
        out.append(entry if entry is not None and dim % prod == 0 else None)
    return P(*out)


def _map_specs(fn, spec_tree, *trees):
    """``fn(spec, *leaves)`` over a nested dict of specs and dicts of the
    same keys."""
    if is_spec(spec_tree):
        return fn(spec_tree, *trees)
    return {k: _map_specs(fn, v, *(t[k] for t in trees))
            for k, v in spec_tree.items()}


def sanitize_pspec_tree(mesh, pspec_tree, shape_tree):
    return _map_specs(lambda s, leaf: sanitize_spec(mesh, s, leaf.shape),
                      pspec_tree, shape_tree)


# -----------------------------------------------------------------------------
# The architecture's context
# -----------------------------------------------------------------------------
class MeshCtx:
    """Carries the mesh and the architecture's ``ShardingPolicy``.

    When ``mesh is None`` every helper is a no-op, so the same model code
    runs on one device with no process group.  ``dp_axes`` overrides the
    batch's axes (``()``: a trainer of the mesh round, whose batch and
    weights are its own on every rank of its data group, so no op of its
    step crosses the data axes)."""

    def __init__(self, mesh, policy, dp_axes=None):
        self.mesh = mesh
        self.policy = policy
        if mesh is not None:
            names = axis_names(mesh)
            self.sizes = axis_sizes(mesh)
            self.has_pod = "pod" in names
            self.dp_axes = (("pod", "data") if self.has_pod else ("data",)) \
                if dp_axes is None else tuple(dp_axes)
            self.fsdp_axis = "data" if policy.fsdp else None
            self.tp_axis = "model" if policy.tensor_parallel else None
            self.ep_axis = "model" if policy.expert_parallel else None
            self.sp_axis = "model" if policy.sequence_parallel else None
            self.model_size = self.sizes.get("model", 1)
            self.data_size = self.sizes.get("data", 1)
        else:
            self.sizes = {}
            self.has_pod = False
            self.dp_axes = ()
            self.fsdp_axis = self.tp_axis = self.ep_axis = self.sp_axis = None
            self.model_size = self.data_size = 1

    # -- helpers -------------------------------------------------------------
    def sharding(self, spec) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, spec)

    def size(self, entry) -> int:
        """Ranks an entry (an axis, a tuple of axes, None) splits over."""
        n = 1
        for a in _axes(entry):
            n *= self.sizes.get(a, 1)
        return n

    def rank(self, axis: str) -> int:
        """This process's coordinate on ``axis``."""
        return self.mesh.get_local_rank(axis)

    def group(self, axis: str):
        return self.mesh.get_group(axis)

    def placements(self, spec, shape, partial: Sequence[str] = ()):
        """``spec`` fitted to ``shape`` (``fit``), as placements."""
        return to_placements(self.mesh, self.fit(spec, shape), len(shape),
                             partial)

    def constrain(self, x, spec):
        """``x`` redistributed to ``spec`` (sanitized for its shape), and
        its gradient laid out so too, whatever layout it reaches this
        point in: JAX's sharding constraint, whose transpose constrains
        the cotangent alike.  ``x`` itself with no mesh or for a plain
        tensor."""
        if self.mesh is None:
            return x
        from torch.distributed.tensor import DTensor
        if not isinstance(x, DTensor):
            return x
        want = self.placements(spec, x.shape)
        if tuple(x.placements) != want:
            x = x.redistribute(self.mesh, want)
        if not (x.requires_grad and torch.is_grad_enabled()):
            return x
        return DTensor.from_local(
            x.to_local(grad_placements=want), self.mesh, want,
            run_check=False, shape=x.shape, stride=x.stride())

    def unshard_fsdp(self, w):
        """A weight whole over the FSDP axis (its shards all-gathered
        there; its gradient reduce-scattered back): what a product takes,
        FSDP's gather at the point of use.  The weight itself where there
        is no FSDP axis or it does not lie over one."""
        if self.mesh is None or self.fsdp_axis is None:
            return w
        from torch.distributed.tensor import DTensor, Replicate
        if not isinstance(w, DTensor):
            return w
        names = axis_names(self.mesh)
        want = tuple(Replicate() if n == self.fsdp_axis else p
                     for p, n in zip(w.placements, names))
        return w if want == tuple(w.placements) \
            else w.redistribute(self.mesh, want)

    def split_product(self, x, w, n: int):
        """``(x @ w).chunk(n, -1)`` for x (B, S, d) and w (d, n·k), each
        part's k columns over the TP axis (where k divides evenly).  A
        shard of w's columns would hold pieces of one part only, so each
        rank multiplies by its own columns of every part, taken from the
        whole w (its gradient a partial sum over the TP axis).  With no
        TP split, the one product and its chunks."""
        B, S, _ = x.shape
        k = w.shape[-1] // n
        rows = self.fit(P(self.dp_axes or None), (B,))[0]
        tp = self.fit(P(self.tp_axis), (k,))[0]

        def fn(x, w):
            if tp is None:
                return (x @ w).chunk(n, -1)
            size = k // self.size(tp)
            lo = self.rank(tp) * size
            return tuple(x @ w[:, i * k + lo:i * k + lo + size]
                         for i in range(n))

        part = P(rows, None, tp)
        return self.local(fn, (P(rows, None, None), P(None, None)),
                          (part,) * n)(x, w)

    def distribute(self, local_fn: Callable, shape, spec, **kw):
        """A DTensor of global ``shape`` laid out by ``spec`` (sanitized
        for it, so every shard is the same size), its local shard made by
        ``local_fn(local_shape, **kw)`` on this rank; with no mesh
        ``local_fn(shape, **kw)``."""
        if self.mesh is None:
            return local_fn(tuple(shape), **kw)
        from torch.distributed.tensor import DTensor
        spec = self.fit(spec, shape)
        local = tuple(n // self.size(e) for n, e in zip(
            shape, tuple(spec) + (None,) * (len(shape) - len(spec))))
        return DTensor.from_local(
            local_fn(local, **kw), self.mesh,
            to_placements(self.mesh, spec, len(shape)), run_check=False,
            shape=torch.Size(shape), stride=_contiguous_strides(shape))

    def fit(self, spec, shape) -> PartitionSpec:
        """``spec`` sanitized for ``shape`` (``sanitize_spec``), and an
        entry over axes of one rank dropped too: a split in one is no
        split, and the steps then take their one-device ops (a 1 x 1 mesh
        runs the unsharded step's ops)."""
        return P(*(e if self.size(e) > 1 else None
                   for e in sanitize_spec(self.mesh, spec, shape)))

    def local(self, fn: Callable, in_specs, out_specs, *,
              out_partial: Sequence[str] = ()):
        """``fn`` over each rank's shards, through ``local_map``:
        ``in_specs`` a spec an argument (a DTensor is redistributed to
        its spec, sanitized for its shape, and handed over as its local
        shard; anything else passes as it is), ``out_specs`` the outputs'
        specs, nested as ``fn`` returns them (a spec a tensor, ``None``
        for anything else; the caller fits them, as the outputs' global
        shapes follow from the inputs').  ``out_partial``: the mesh axes
        over which the outputs are sums still to be taken.  An input's
        gradient is partial over every axis it is replicated over where
        an output is sharded or partial, and replicated where every
        output is replicated too (the ranks along it computed the same
        thing).  With no mesh, ``fn`` itself."""
        if self.mesh is None:
            return fn
        from torch.distributed.tensor import DTensor, Partial, Replicate
        from torch.distributed.tensor.experimental import local_map
        names = axis_names(self.mesh)
        flat = []

        def walk(node):             # in the order local_map flattens
            if is_spec(node) or node is None:
                flat.append(node)
            elif isinstance(node, dict):
                for x in node.values():
                    walk(x)
            else:
                for x in node:
                    walk(x)
        walk(out_specs)
        split = set(out_partial) | {a for spec in flat if spec is not None
                                    for e in spec for a in _axes(e)}
        # local_map reads a tuple as one entry an output, a list as one
        # output's placements
        out_pl = tuple(None if spec is None else
                       list(to_placements(self.mesh, spec, None, out_partial))
                       for spec in flat)

        def wrapped(*args):
            in_pl, grad_pl = [], []
            for spec, a in zip(in_specs, args):
                if not isinstance(a, DTensor):
                    in_pl.append(None)
                    grad_pl.append(None)
                    continue
                pl = self.placements(spec, a.shape)
                in_pl.append(pl)
                grad_pl.append(tuple(Partial() if isinstance(p, Replicate)
                                     and n in split else p
                                     for p, n in zip(pl, names)))
            return local_map(
                fn, out_placements=out_pl if len(out_pl) > 1 else out_pl[0],
                in_placements=tuple(in_pl),
                in_grad_placements=tuple(grad_pl), device_mesh=self.mesh,
                redistribute_inputs=True)(*args)

        return wrapped

    # -- activation specs ----------------------------------------------------
    def act_btd(self, x):
        """Residual stream (B, S, d): DP on batch, SP on seq if enabled."""
        return self.constrain(x, P(self.dp_axes or None, self.sp_axis, None))

    def full_seq(self, x):
        """The residual stream with its whole sequence on each rank, where
        it was seq-sharded (SP): what a product over d takes, the
        all-gather of sequence parallelism; ``x`` itself otherwise."""
        if self.sp_axis is None:
            return x
        return self.constrain(x, P(self.dp_axes or None, None, None))

    def act_heads(self, x):
        """Per-head activations (B, S, H, dh): TP on heads."""
        return self.constrain(x, P(self.dp_axes or None, None, self.tp_axis,
                                   None))

    def act_ffn(self, x):
        """FFN hidden (B, S, ff): TP on ff."""
        return self.constrain(x, P(self.dp_axes or None, None, self.tp_axis))

    def logits(self, x):
        """LM logits (B, S, V): vocab over model (keeps 150k-vocab
        local)."""
        return self.constrain(x, P(self.dp_axes or None, None, self.tp_axis))

    # -- batch specs -----------------------------------------------------------
    def batch_spec(self) -> PartitionSpec:
        return P(self.dp_axes or None)

    def kv_cache_spec(self) -> PartitionSpec:
        """(B, S, Hkv, dh): batch over DP; seq over model if
        kv_seq_shard."""
        if self.policy.kv_seq_shard:
            return P(self.dp_axes or None,
                     "model" if self.mesh is not None else None, None, None)
        return P(self.dp_axes or None, None, self.tp_axis, None)


#: the context of one device with no mesh: the model functions' default
NO_MESH = MeshCtx(None, ShardingPolicy())


def _contiguous_strides(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


# -----------------------------------------------------------------------------
# Parameter partition rules (the JAX package's, on its leaf paths)
# -----------------------------------------------------------------------------
def param_spec(ctx: MeshCtx, path: tuple, shape: tuple) -> PartitionSpec:
    """The spec of one weight given its JAX tree path and shape (a
    stacked leaf, under ``periods`` or ``enc_periods``, carries its
    leading period dim, never sharded)."""
    if ctx.mesh is None:
        return P()
    fsdp, tp = ctx.fsdp_axis, ctx.tp_axis
    name = path[-1]
    joined = "/".join(str(p) for p in path)
    stacked = "periods" in joined or "enc_periods" in joined
    lead = (None,) if stacked else ()

    def spec(*dims):
        out = lead + tuple(dims)
        assert len(out) == len(shape), (joined, shape, out)
        return P(*out)

    ndim = len(shape) - len(lead)

    # embeddings ------------------------------------------------------------
    if name == "table":            # (V, d) input embedding
        return P(tp, fsdp)
    if name == "head_w":           # (d, V) output head
        return P(fsdp, tp)
    if name in ("pos", "dec_pos"):  # learned positions (S, d)
        return P(None, fsdp)

    # norms / biases / small vectors -----------------------------------------
    if ndim == 1:
        return spec(None)

    # MoE expert stacks (E, d, f) / (E, f, d) ---------------------------------
    if name in ("moe_wg", "moe_wu"):   # (E, d, ff_e)
        return spec(ctx.ep_axis, fsdp, None)
    if name == "moe_wo":               # (E, ff_e, d)
        return spec(ctx.ep_axis, None, fsdp)
    if name == "router":               # (d, E)
        return spec(fsdp, None)

    # attention --------------------------------------------------------------
    if name in ("wq", "wk", "wv"):     # (d, H*dh)
        return spec(fsdp, tp)
    if name == "wo":                   # (H*dh, d)
        return spec(tp, fsdp)

    # dense mlp ---------------------------------------------------------------
    if name in ("wi_gate", "wi_up"):   # (d, ff)
        return spec(fsdp, tp)
    if name == "w_down":               # (ff, d)
        return spec(tp, fsdp)

    # mamba -------------------------------------------------------------------
    if name == "in_proj":              # (d, 2*di)
        return spec(fsdp, tp)
    if name == "out_proj":             # (di, d)
        return spec(tp, fsdp)
    if name in ("x_dt", "x_B", "x_C"):  # (di, r/ds)
        return spec(tp, None)
    if name == "dt_proj":              # (r, di)
        return spec(None, tp)
    if name in ("A_log", "conv_w"):    # (di, ds) / (di, k)
        return spec(tp, None)

    # xLSTM -------------------------------------------------------------------
    if name == "up_proj":              # (d, 2*di)
        return spec(fsdp, tp)
    if name == "down_proj":            # (di, d)
        return spec(tp, fsdp)
    if name in ("m_wq", "m_wk", "m_wv"):  # (nh, dh, dh) block-diag per head
        return spec(tp, None, None) \
            if shape[len(lead)] % max(ctx.model_size, 1) == 0 \
            else spec(None, tp, None)
    if name in ("w_gates",):           # (d, n*d) sLSTM input gates
        return spec(fsdp, tp)
    if name == "r_gates":              # (nh, dh, 4*dh) sLSTM recurrent
        return spec(None, None, tp)
    if name in ("ff_up",):             # (d, dff)
        return spec(fsdp, tp)
    if name == "ff_down":              # (dff, d)
        return spec(tp, fsdp)

    # conv / lenet / fallback ---------------------------------------------------
    if ndim == 2:
        return spec(fsdp, tp)
    return P(*([None] * len(shape)))


def jax_path(leaf: str) -> tuple:
    """A ``param_groups`` leaf name as the JAX tree's path (the decoder
    LMs' ``embed`` is the JAX tree's ``embed.table``)."""
    path = tuple(leaf.split("."))
    return ("embed", "table") if path == ("embed",) else path


def params_pspec_tree(ctx: MeshCtx, params_shape, groups=None):
    """Specs of a flat dict of weights (``Model.params_shape``).  With
    ``groups`` (``Model.param_groups``: ``{key: (leaf, j)}``) a key is
    given its JAX leaf's spec, the stacked leaf's leading ``None``
    dropped; without, each key is read as a JAX path joined by dots."""
    out = {}
    for key, t in params_shape.items():
        leaf, j = groups[key] if groups is not None else (key, None)
        path = jax_path(leaf)
        shape = tuple(t.shape)
        if j is None:
            out[key] = param_spec(ctx, path, shape)
            continue
        spec = param_spec(ctx, path, (1,) + shape)
        if len(spec) and spec[0] is not None:
            raise ValueError(f"{leaf}: a stacked leaf's spec {spec} shards "
                             f"its period dim")
        out[key] = P(*spec[1:]) if len(spec) else spec
    return out


def params_sharding_tree(ctx: MeshCtx, params_shape, groups=None):
    if ctx.mesh is None:
        return None
    return {k: NamedSharding(ctx.mesh, s) for k, s in
            params_pspec_tree(ctx, params_shape, groups).items()}


def state_spec(ctx: MeshCtx, path: tuple, shape: tuple) -> PartitionSpec:
    """The spec of a decode-state leaf (leading stacked layer dim)."""
    if ctx.mesh is None:
        return P()
    dp, tp = (ctx.dp_axes or None), ctx.tp_axis
    name = str(path[-1])
    kv_seq = "model" if ctx.policy.kv_seq_shard else None
    table = {
        "k": P(None, dp, kv_seq, None, None),
        "v": P(None, dp, kv_seq, None, None),
        "ek": P(None, dp, None, None, None),
        "ev": P(None, dp, None, None, None),
        "conv": P(None, dp, None, tp),
        "ssm": P(None, dp, tp, None),
        "C": P(None, dp, None, tp, None),
        "n": P(None, dp, None, tp),
        "m": P(None, dp, None),
        "h": P(None, dp, tp),
        "c": P(None, dp, tp),
        "nn": P(None, dp, tp),
        "mm": P(None, dp, tp),
    }
    spec = table.get(name)
    if spec is None or len(spec) != len(shape):
        return P(*([None] * len(shape)))
    return spec


def state_pspec_tree(ctx: MeshCtx, state_shape):
    def _walk(path, node):
        if isinstance(node, dict):
            return {k: _walk(path + (k,), v) for k, v in node.items()}
        return state_spec(ctx, path, tuple(node.shape))
    return _walk((), state_shape)
