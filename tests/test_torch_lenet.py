"""LeNet-5 in the port (``repro_torch.models.lenet``) against the JAX
package's ``repro.models.lenet`` on the CPU, at float32, with the JAX
weights carried across (``params_from_numpy``): torch's RNG cannot
reproduce ``jax.random``.

Tolerance: logits, loss and gradients within rtol 1e-5 / atol 1e-6 of the
largest value.  Both sides compute in float32, the convolutions' and the
dense layers' sums in other orders (XLA's ``conv_general_dilated`` against
``F.conv2d``), which moves a value by a few float32 steps.
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
