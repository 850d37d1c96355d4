"""The port's sharding specs against the JAX package's, for all ten
assigned architectures at full size on the production meshes (16 x 16
``("data", "model")`` and 2 x 16 x 16 ``("pod", "data", "model")``),
with no process group and no devices: both packages' rules read only the
mesh's axis names and sizes, so one stand-in mesh serves both.

  * each weight's sanitized spec equals its JAX leaf's (through
    ``param_groups``; a stacked leaf's spec without its leading ``None``);
  * the decode-state specs at decode_32k and long_500k, the input specs of
    every shape, the optimizer-state specs of each arch's optimizer and
    the trainer-stacked specs (``trainerify_pspecs``) equal the JAX ones;
  * the bytes of weights a card holds, from the specs, equal the JAX
    specs' (and are given against ``ModelConfig.param_count()``);
  * ``Model.params_shape()`` (the ``meta`` device) equals the JAX
    ``init_params_shape`` (``jax.eval_shape``) leaf by leaf;
  * the meshes: the production and wide meshes raise without a process
    group of their size and build under a faked one.
"""
import functools

import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro_torch.configs.base import SHAPES, cell_is_skipped
from repro_torch.configs.registry import ASSIGNED, get_config
from repro_torch.launch.steps import opt_state_pspecs
from repro_torch.models.model import Model
from repro_torch.sharding import specs
from repro_torch.fl.round import trainerify_pspecs, stack_shape

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


class StandInMesh:
    """What both packages' rules read of a mesh: axis names and sizes."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


def _mesh(kind):
    return StandInMesh(*MESHES[kind])


@functools.lru_cache(maxsize=None)
def _jax_model(arch, kind):
    from repro.models.model import Model as JModel
    return JModel(jreg.get_config(arch), _mesh(kind))


@functools.lru_cache(maxsize=None)
def _jax_params_shape(arch):
    return _jax_model(arch, "single").params_shape()


@functools.lru_cache(maxsize=None)
def _port_params_shape(arch):
    return Model(get_config(arch), "cpu").params_shape()


def _port_model(arch, kind):
    return Model(get_config(arch), "cpu", mesh=_mesh(kind))


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _flat_jax(tree, prefix=()):
    """{path tuple: leaf} of a nested dict of specs or shapes."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_jax(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _groups(arch):
    port = Model(get_config(arch), "cpu")
    return port.param_groups(_port_params_shape(arch))


def _jax_param_specs(arch, kind):
    from repro.sharding.specs import sanitize_pspec_tree
    jm = _jax_model(arch, kind)
    ps = _jax_params_shape(arch)
    return sanitize_pspec_tree(jm.ctx.mesh, jm.params_pspecs(ps), ps)


CASES = [(a, k) for a in ASSIGNED for k in MESHES]


@pytest.mark.parametrize("arch,kind", CASES)
def test_param_specs_equal_jax(arch, kind):
    mesh = _mesh(kind)
    port = _port_model(arch, kind)
    pshape = _port_params_shape(arch)
    got = specs.sanitize_pspec_tree(mesh, port.params_pspecs(pshape), pshape)
    want = _jax_param_specs(arch, kind)
    groups = _groups(arch)
    covered = set()
    for key, spec in got.items():
        leaf, j = groups[key]
        path = specs.jax_path(leaf)
        covered.add(path)
        w = tuple(_leaf(want, path))
        if j is not None:
            assert w[0] is None, (key, w)
            w = w[1:]
        assert tuple(spec) == w, (key, spec, w)
    assert covered == set(_flat_jax(want))


@pytest.mark.parametrize("arch,kind", CASES)
def test_state_and_input_specs_equal_jax(arch, kind):
    port, jm = _port_model(arch, kind), _jax_model(arch, kind)
    cfg = get_config(arch)
    for name in ("decode_32k", "long_500k"):
        shape = SHAPES[name]
        if cell_is_skipped(cfg, shape):
            continue
        B, S = shape.global_batch, shape.seq_len
        got = port.decode_state_pspecs(B, S)
        want = jm.decode_state_pspecs(B, S)
        assert {k: tuple(v) for k, v in _flat_jax(got).items()} == \
            {k: tuple(v) for k, v in _flat_jax(want).items()}
        # and the stand-ins' shapes are the JAX state's
        ss, js = port.decode_state_shape(B, S), jm.decode_state_shape(B, S)
        assert {k: tuple(v.shape) for k, v in _flat_jax(ss).items()} == \
            {k: tuple(v.shape) for k, v in _flat_jax(js).items()}
    for name, shape in SHAPES.items():
        got = port.input_pspecs(shape)
        want = jm.input_pspecs(JSHAPES[name])
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}, name
        shapes = {k: tuple(v.shape) for k, v in port.input_specs(shape).items()
                  if k != "pos"}
        jshapes = {k: tuple(v.shape) for k, v in
                   jm.input_specs(JSHAPES[name]).items() if k != "pos"}
        assert shapes == jshapes, name


@pytest.mark.parametrize("arch,kind", CASES)
def test_opt_state_and_trainer_specs_equal_jax(arch, kind):
    from repro.fl.round import trainerify_pspecs as j_trainerify
    from repro.launch.steps import opt_state_pspecs as j_opt_specs
    cfg = get_config(arch)
    port, jm = _port_model(arch, kind), _jax_model(arch, kind)
    pshape = _port_params_shape(arch)
    pspecs = port.params_pspecs(pshape)
    groups = _groups(arch)
    jps = _jax_params_shape(arch)
    jspecs = jm.params_pspecs(jps)
    got = opt_state_pspecs(cfg.optimizer, pspecs, pshape, groups)
    want = j_opt_specs(cfg.optimizer, jspecs, jps)
    assert tuple(got["step"]) == tuple(want["step"]) == ()
    if cfg.optimizer == "adafactor":
        flat = _flat_jax(want["v"])
        for leaf, st in got["v"].items():
            path = specs.jax_path(leaf)
            for name, spec in st.items():
                assert tuple(spec) == tuple(flat[path + (name,)]), (leaf,
                                                                    name)
        assert len(flat) == sum(len(v) for v in got["v"].values())
    else:
        for moment in [k for k in want if k != "step"]:
            for key, spec in got[moment].items():
                leaf, j = groups[key]
                w = tuple(_leaf(want[moment], specs.jax_path(leaf)))
                assert tuple(spec) == (w[1:] if j is not None else w)
    # the trainer-stacked specs: the DP axes lead, stripped inside
    dp = ("pod", "data") if kind == "multi" else ("data",)
    got_t = trainerify_pspecs(pspecs, dp)
    want_t = j_trainerify(jspecs, dp)
    for key, spec in got_t.items():
        leaf, j = groups[key]
        w = tuple(_leaf(want_t, specs.jax_path(leaf)))
        if j is not None:       # the stacked leaf's period dim, after T
            assert w[1] is None
            w = w[:1] + w[2:]
        assert tuple(spec) == w, (key, spec, w)


def _card_bytes(mesh, spec_tree, shape_tree) -> int:
    """Bytes of the leaves a card holds under the sanitized specs."""
    sizes = specs.axis_sizes(mesh)
    total = 0
    for spec, leaf in zip(spec_tree, shape_tree):
        spec = specs.sanitize_spec(mesh, spec, leaf.shape)
        shards = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                shards *= sizes[a]
        total += int(np.prod(leaf.shape, dtype=np.int64)) \
            * _itemsize(leaf.dtype) // shards
    return total


def _itemsize(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    return 2 if name == "bfloat16" else np.dtype(name).itemsize


@pytest.mark.parametrize("arch,kind", CASES)
def test_card_weight_bytes_equal_jax(arch, kind):
    import jax
    mesh = _mesh(kind)
    port = _port_model(arch, kind)
    pshape = _port_params_shape(arch)
    pspecs = port.params_pspecs(pshape)
    keys = sorted(pshape)
    got = _card_bytes(mesh, [pspecs[k] for k in keys],
                      [pshape[k] for k in keys])
    jm = _jax_model(arch, kind)
    jps = _jax_params_shape(arch)
    js = jm.params_pspecs(jps)
    leaves, tree = jax.tree.flatten(jps)
    spec_leaves = tree.flatten_up_to(js)
    want = _card_bytes(mesh, spec_leaves, leaves)
    assert got == want
    # the dry run's record of them (launch/dryrun.weight_bytes)
    from repro_torch.launch.dryrun import weight_bytes
    rec = weight_bytes(port)
    assert rec["weight_bytes"] == got
    assert rec["weight_bytes_over_even"] == got / rec["weight_bytes_even"]
    # the weights a card holds are at least their even share
    n = get_config(arch).param_count()
    assert got >= 2 * n / (16 * 16) * 0.99


@pytest.mark.parametrize("arch", ASSIGNED)
def test_params_shape_equals_jax(arch):
    got = _port_params_shape(arch)
    assert all(t.device.type == "meta" for t in got.values())
    want = _flat_jax(_jax_params_shape(arch))
    groups = _groups(arch)
    n_layers = {}
    for key, t in got.items():
        leaf, j = groups[key]
        path = specs.jax_path(leaf)
        w = want[path]
        shape = tuple(w.shape)
        if j is not None:
            n_layers[path] = n_layers.get(path, 0) + 1
            shape = shape[1:]
        assert tuple(t.shape) == shape, key
        assert str(t.dtype).replace("torch.", "") == str(w.dtype), key
    for path, n in n_layers.items():
        assert want[path].shape[0] == n, path
    assert {specs.jax_path(groups[k][0]) for k in got} == set(want)


def test_spec_helpers():
    P = specs.P
    assert tuple(P(("data",), None)) == ("data", None)
    mesh = StandInMesh((2, 16, 16), ("pod", "data", "model"))
    assert tuple(specs.sanitize_spec(mesh, P(("pod", "data"), "model"),
                                     (64, 24))) == (("pod", "data"), None)
    from torch.distributed.tensor import Partial, Replicate, Shard
    assert specs.to_placements(mesh, P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert specs.to_placements(mesh, P(None, "data"), 2, ("model",)) == (
        Replicate(), Shard(1), Partial())
    with pytest.raises(ValueError):
        specs.to_placements(mesh, P("model", "model"))
    assert specs.shard_lane_sharding("m").spec == P("shard", None)
    ctx = specs.MeshCtx(StandInMesh((16, 16), ("data", "model")),
                        get_config("yi-6b").sharding)
    w = {"head_w": torch.empty(4096, 64000, device="meta")}
    sh = specs.params_sharding_tree(ctx, w)["head_w"]
    assert sh.spec == P("data", "model") and sh.mesh is ctx.mesh
    ctx = specs.MeshCtx(None, get_config("yi-6b").sharding)
    x = torch.zeros(2)
    assert ctx.constrain(x, P("data")) is x and ctx.local(len, (), ()) is len
    st = stack_shape({"a": torch.empty(3, 4, device="meta")}, 5)
    assert st["a"].shape == (5, 3, 4) and st["a"].device.type == "meta"


def test_meshes_need_a_group_of_their_size():
    import torch.distributed as dist
    from repro_torch.launch import mesh
    from repro_torch.launch.dryrun import fake_world
    assert not dist.is_initialized()
    for call in (lambda: mesh.make_production_mesh(device="cpu"),
                 lambda: mesh.make_production_mesh(multi_pod=True,
                                                   device="cpu"),
                 lambda: mesh.make_train_mesh(2, 2, device="cpu")):
        with pytest.raises(RuntimeError, match="found no process group"):
            call()
    assert mesh.make_train_mesh(device="cpu").shape == {"data": 1,
                                                        "model": 1}
    try:
        fake_world(256)
        m = mesh.make_production_mesh(device="cpu")
        assert mesh.mesh_shape(m) == {"data": 16, "model": 16}
        with pytest.raises(RuntimeError, match="world size 256"):
            mesh.make_production_mesh(multi_pod=True, device="cpu")
        fake_world(512)
        m = mesh.make_production_mesh(multi_pod=True, device="cpu")
        assert mesh.mesh_shape(m) == {"pod": 2, "data": 16, "model": 16}
        assert m.size() == 512
    finally:
        dist.destroy_process_group()
