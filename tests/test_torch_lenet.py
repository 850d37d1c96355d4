"""LeNet-5 in the port (``repro_torch.models.lenet``) against the JAX
package's ``repro.models.lenet`` on the CPU, at float32, with the JAX
weights carried across (``params_from_numpy``): torch's RNG cannot
reproduce ``jax.random``.

Tolerance: logits, loss and gradients within rtol 1e-5 / atol 1e-6 of the
largest value.  Both sides compute in float32, the convolutions' and the
dense layers' sums in other orders (XLA's ``conv_general_dilated`` against
``F.conv2d``), which moves a value by a few float32 steps.

Under a mesh (``build_model(cfg, mesh=...)``): the weights' and the
batch's specs equal the JAX facade's; on a one-rank gloo mesh the
logits, loss, gradients and accuracy are bit-equal to the one-device
LeNet's, and on a 2 x 2 mesh of four gloo ranks within the tolerance
``test_lenet_under_a_mesh_equals_one_device`` states.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import lenet as jlenet
from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import make_mnist_like
from repro_torch.models import lenet
from repro_torch.models.model import build_model

torch.set_num_threads(1)

RTOL, ATOL_OF_MAX = 1e-5, 1e-6
LEAVES = ["conv1.b", "conv1.w", "conv2.b", "conv2.w", "fc1.b", "fc1.w",
          "fc2.b", "fc2.w", "fc3.b", "fc3.w"]


def close(got: torch.Tensor, want, what: str = "") -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got.detach().numpy(), want, rtol=RTOL,
        atol=ATOL_OF_MAX * max(float(np.abs(want).max()), 1e-30),
        err_msg=what)


@pytest.fixture(scope="module")
def world():
    cfg = jax_config("lenet5")
    jp = jlenet.init_params(cfg, jax.random.key(3))
    # the JAX init leaves biases at zero: perturb them, or their paths
    # go untested
    g = np.random.default_rng(4)
    jp = {layer: {"w": np.asarray(leaves["w"]),
                  "b": g.normal(size=leaves["b"].shape).astype(np.float32)
                  * 0.1}
          for layer, leaves in jp.items()}
    xs, ys = make_mnist_like(24, seed=5)
    model = build_model(get_config("lenet5"), "cpu")
    return dict(cfg=cfg, jp=jp, xs=xs, ys=ys, model=model,
                tp=lenet.params_from_numpy(jp, "cpu"))


def _jbatch(w):
    return {"images": jnp.asarray(w["xs"]), "labels": jnp.asarray(w["ys"])}


def _tbatch(w):
    return {"images": torch.from_numpy(w["xs"]),
            "labels": torch.from_numpy(w["ys"])}


def test_build_model_gives_lenet():
    """The facade's conv branch: a LeNet with the TinyMLP interface, its
    keys sorted in the JAX tree's leaf order; TransformerLM refuses the
    config."""
    from repro_torch.models import transformer as tt
    cfg = get_config("lenet5")
    model = build_model(cfg, "cpu")
    assert isinstance(model, lenet.LeNet) and model.cfg is cfg
    assert model.device == torch.device("cpu")
    p = model.init_params(0)
    assert list(p) == LEAVES == sorted(p)
    jshapes = jax.tree.map(np.shape, jlenet.init_params_shape(jax_config(
        "lenet5")))
    for k in LEAVES:
        layer, leaf = k.split(".")
        assert tuple(p[k].shape) == jshapes[layer][leaf]
    with pytest.raises(ValueError, match="LeNet"):
        tt.TransformerLM(cfg, device="cpu")
    tt.check_supported(cfg)


def test_init_params_follow_the_jax_init():
    """Same seed, same values; truncated at two of the JAX package's
    scales (fan_in = the second-to-last axis), zero biases."""
    model = lenet.LeNet(device="cpu")
    a, b = model.init_params(7), model.init_params(7)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc1.w"], model.init_params(8)["fc1.w"])
    for name, (shape, _) in lenet.LAYERS.items():
        scale = shape[-2] ** -0.5
        w = a[f"{name}.w"]
        assert float(w.abs().max()) <= 2 * scale + 1e-6
        assert float(w.std()) == pytest.approx(0.88 * scale, rel=0.35)
        assert not a[f"{name}.b"].any()


def test_params_round_trip(world):
    back = lenet.params_to_numpy(world["tp"])
    for layer, leaves in world["jp"].items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(back[layer][leaf], v)


def test_forward_matches_jax(world):
    w = world
    want = jlenet.forward(w["cfg"], jax.tree.map(jnp.asarray, w["jp"]),
                          _jbatch(w))
    got = w["model"].logits(w["tp"], _tbatch(w))
    assert got.shape == (24, 10) and got.dtype == torch.float32
    close(got, want, "logits")


def test_loss_and_gradients_match_jax(world):
    w = world
    jl, jg = jax.value_and_grad(
        lambda p: jlenet.loss_fn(w["cfg"], p, _jbatch(w)))(
            jax.tree.map(jnp.asarray, w["jp"]))
    tp = {k: v.clone().requires_grad_() for k, v in w["tp"].items()}
    tl = w["model"].loss(tp, _tbatch(w))
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-6)
    for k in LEAVES:
        layer, leaf = k.split(".")
        close(tp[k].grad, jg[layer][leaf], k)


def test_accuracy_matches_jax(world):
    """The DON's score: bit-equal to the JAX package's jitted mean."""
    w = world
    want = jax.jit(lambda p, b: jlenet.accuracy(w["cfg"], p, b))(
        jax.tree.map(jnp.asarray, w["jp"]), _jbatch(w))
    got = w["model"].accuracy_fn()(w["tp"], _tbatch(w))
    assert float(got) == float(want)


def test_per_trainer_gradients_vmap(world):
    """The cohort's path: ``vmap(grad(loss))`` over stacked per-trainer
    weights and batches equals a loop over trainers (the convolutions
    batched over their weights)."""
    w = world
    model = w["model"]
    stacked = {k: torch.stack([v, v * 0.5, v + 0.01]) for k, v in
               w["tp"].items()}
    tb = _tbatch(w)
    batches = {k: torch.stack([v[:8], v[8:16], v[16:]]) for k, v in
               tb.items()}
    got = torch.func.vmap(torch.func.grad(model.loss))(stacked, batches)
    for i in range(3):
        one = torch.func.grad(model.loss)(
            {k: v[i] for k, v in stacked.items()},
            {k: v[i] for k, v in batches.items()})
        for k in LEAVES:
            torch.testing.assert_close(got[k][i], one[k], rtol=1e-5,
                                       atol=1e-7)


def test_convolutions_keep_tf32_off():
    """Inside ``fp32_convolutions`` cuDNN may not use TF32; outside, the
    settings are what they were (nothing global flips)."""
    cudnn = torch.backends.cudnn
    before = (cudnn.allow_tf32, cudnn.enabled, cudnn.benchmark,
              cudnn.deterministic)
    with lenet.fp32_convolutions():
        assert not cudnn.allow_tf32
        assert (cudnn.enabled, cudnn.benchmark, cudnn.deterministic) == \
            before[1:]
    assert (cudnn.allow_tf32, cudnn.enabled, cudnn.benchmark,
            cudnn.deterministic) == before


def test_entry_points_need_a_card_by_default(monkeypatch):
    """Without ``device`` LeNet, the facade and the Fig. 3 launcher run
    on the card, and raise where there is none (never the CPU silently)."""
    from repro_torch.launch import fl_mnist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: lenet.LeNet(),
                 lambda: build_model(get_config("lenet5")),
                 lambda: fl_mnist.run(1, 1, say=lambda _: None),
                 lambda: fl_mnist.main(["--tasks", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# -- under a mesh --------------------------------------------------------------
def _mesh_rank(rank, world, d, shape, out):
    """LeNet built under a ``shape`` mesh of ``world`` gloo ranks: its
    logits, loss, gradients and accuracy on the ``world`` fixture's batch
    (laid out by ``input_pspecs``), gathered, and its weights' layout."""
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.steps import shard
    dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                            world_size=world)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    model = build_model(get_config("lenet5"), mesh=mesh)
    params = model.init_params(0)
    xs, ys = make_mnist_like(24, seed=5)
    specs = model.input_pspecs(ShapeConfig("lenet", 1, 24, "train"))
    batch = {k: shard(model.ctx, torch.from_numpy(v), specs[k], "cpu")
             for k, v in (("images", xs), ("labels", ys))}
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = model.loss(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    res = {"logits": model.logits(params, batch).full_tensor(),
           "loss": loss.detach().full_tensor(),
           "grads": {k: g.full_tensor() for k, g in zip(leaves, grads)},
           "accuracy": model.accuracy_fn()(params, batch).full_tensor(),
           "params": {k: v.full_tensor() for k, v in params.items()},
           "placements": {k: tuple(v.placements)
                          for k, v in params.items()},
           "batch": tuple(batch["images"].placements),
           "device": model.device, "ctx": model.ctx.mesh is mesh}
    if rank == 0:
        torch.save(res, out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """One rank on a 1 x 1 mesh, and four on 2 x 2."""
    import torch.multiprocessing as mp
    out = {}
    for shape in ((1, 1), (2, 2)):
        d = tmp_path_factory.mktemp("lenet_mesh")
        world = shape[0] * shape[1]
        mp.start_processes(_mesh_rank, args=(world, str(d), shape,
                                             str(d / "r.pt")),
                           nprocs=world, start_method="spawn")
        out[shape] = torch.load(d / "r.pt", weights_only=False)
    return out


@pytest.fixture(scope="module")
def one_device():
    """The one-device LeNet's logits, loss, gradients and accuracy at
    ``init_params(0)`` on the mesh runs' batch."""
    model = build_model(get_config("lenet5"), "cpu")
    params = model.init_params(0)
    xs, ys = make_mnist_like(24, seed=5)
    batch = {"images": torch.from_numpy(xs), "labels": torch.from_numpy(ys)}
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = model.loss(leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return {"logits": model.logits(params, batch), "loss": loss.detach(),
            "grads": dict(zip(leaves, grads)),
            "accuracy": model.accuracy_fn()(params, batch),
            "params": params}


def test_build_model_builds_lenet_under_a_mesh(mesh_runs):
    """No refusal: a LeNet holding the mesh, on the mesh's device, its
    weights the one-device draw laid out by the specs' fallback (lenet5's
    policy turns FSDP and TP off, so all of them lie whole on every rank)
    and the batch over ``data``."""
    from torch.distributed.tensor import Replicate, Shard
    for shape, r in mesh_runs.items():
        assert r["ctx"] and r["device"] == torch.device("cpu")
        assert set(r["placements"].values()) == {(Replicate(),
                                                  Replicate())}
        assert r["batch"] == ((Shard(0) if shape[0] > 1 else Replicate()),
                              Replicate())


def test_lenet_specs_are_the_jax_specs():
    """On the production mesh (axis names and sizes: both packages' rules
    read nothing else) each weight's spec and the batch's equal the JAX
    facade's."""
    from repro.configs.base import ShapeConfig as JShape
    from repro.models.model import Model as JModel
    from repro_torch.configs.base import ShapeConfig

    class StandInMesh:
        axis_names = ("data", "model")
        shape = {"data": 16, "model": 16}
    model = build_model(get_config("lenet5"), "cpu", mesh=StandInMesh())
    jm = JModel(jax_config("lenet5"), StandInMesh())
    want = jm.params_pspecs()
    got = model.params_pspecs()
    assert sorted(got) == LEAVES
    for k, spec in got.items():
        layer, leaf = k.split(".")
        assert tuple(spec) == tuple(want[layer][leaf]), k
    assert {k: tuple(v) for k, v in model.input_pspecs(
        ShapeConfig("b", 1, 32, "train")).items()} == {
        k: tuple(v) for k, v in jm.input_pspecs(
            JShape("b", 1, 32, "train")).items()}


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_lenet_under_a_mesh_equals_one_device(mesh_runs, one_device, shape):
    """One rank: logits, loss, gradients and accuracy bit-equal to the
    one-device LeNet.  Four (2 x 2): the rows' logits bit-equal (each
    rank runs the one-device ops on its 12 rows); the loss within rtol
    1e-6 and the gradients within rtol 1e-5 / atol 1e-5 of the largest
    value: their sums over the batch (a convolution's over 24 x 28 x 28
    positions) now run in two shards and an all-reduce (3.5e-6 of the
    largest value for ``conv1.w``'s, the farthest)."""
    got, want = mesh_runs[shape], one_device
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    assert torch.equal(got["logits"], want["logits"])
    assert torch.equal(got["accuracy"], want["accuracy"])
    if shape == (1, 1):
        assert torch.equal(got["loss"], want["loss"])
        for k, g in want["grads"].items():
            assert torch.equal(got["grads"][k], g), k
        return
    torch.testing.assert_close(got["loss"], want["loss"], rtol=1e-6,
                               atol=0.0)
    for k, g in want["grads"].items():
        torch.testing.assert_close(
            got["grads"][k], g, rtol=1e-5,
            atol=1e-5 * max(float(g.abs().max()), 1e-30), msg=k)
