"""The port's optimizers, update compression and fault-tolerance runtime
on the CPU against the JAX package (``tests/test_substrate.py``'s cases).

adamw and sgdm are elementwise: the weights after three steps within
float32 noise (rtol 1e-5 / atol 1e-7; the global norm sums in another
order), plus lr * 2^-7 for their bfloat16 moments (a float32 rounding on
either side of a bfloat16 midpoint moves a moment by one step).
adafactor on reduced qwen2-0.5b's JAX-layout leaves (stacked over its
periods, ``param_groups``) with gradients large enough that its rms-1
update clip engages at every step: rtol 1e-5 / atol 1e-7 as well.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced
from repro.models.model import build_model as jax_build
from repro.optim import compression as jc
from repro.optim.optimizers import OptimizerSpec as JSpec
from repro.optim.optimizers import make_optimizer as jax_make_optimizer
from repro.optim.optimizers import spec_for_config as jax_spec_for_config
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import REGISTRY, get_config, reduced_config
from repro_torch.models import transformer as tt
from repro_torch.models.model import build_model
from repro_torch.optim import compression as tc
from repro_torch.optim.optimizers import (OptimizerSpec, make_optimizer,
                                          spec_for_config)
from repro_torch.runtime.fault_tolerance import (ElasticController,
                                                 HeartbeatRegistry,
                                                 RoundDeadline,
                                                 factorize_mesh,
                                                 subset_aggregate_ok)

torch.set_num_threads(1)


def _qwen(dt="float32"):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("qwen2-0.5b")),
                               dtype=dt)
    tcfg = dataclasses.replace(reduced_config(get_config("qwen2-0.5b")),
                               dtype=dt)
    tree = jax.tree.map(np.asarray,
                        jax_build(jcfg).init_params(jax.random.key(0)))
    model = build_model(tcfg, "cpu")
    return tree, model, model.train_params(
        tt.params_from_numpy(tcfg, tree, device="cpu"))


def _grads(tree, seed, scale):
    g = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (g.normal(size=a.shape) * scale).astype(
        np.float32), tree)


def _flat_grads(model, host):
    """The JAX-layout gradient tree as the port's flat dict."""
    m = tt.params_from_numpy(model.cfg, host, device="cpu",
                             dtype=torch.float32)
    return model.train_params(m)


@pytest.mark.parametrize("name,dt", [("adamw", "float32"),
                                     ("adamw", "bfloat16"),
                                     ("sgdm", "float32"),
                                     ("adafactor", "float32"),
                                     ("adafactor", "bfloat16")])
def test_optimizer_steps_match_jax(name, dt):
    tree, model, flat = _qwen(dt)
    kw = dict(name=name, lr=1e-2, factored_min=8)
    jopt = jax_make_optimizer(JSpec(**kw))
    topt = make_optimizer(OptimizerSpec(**kw),
                          groups=model.param_groups(flat))
    jp = jax.tree.map(jnp.asarray, tree)
    js, ts = jopt.init(jp), topt.init(flat)
    if name == "adafactor":
        # the stacked leaves are factored as the JAX tree's are
        assert set(ts["v"]["periods.b0.wi_gate"]) == {"vr", "vc"}
        assert ts["v"]["periods.b0.wi_gate"]["vr"].shape == \
            js["v"]["periods"]["b0"]["wi_gate"]["vr"].shape
    for s in range(3):
        host = _grads(tree, s, scale=50.0)
        jp, js, jgn = jopt.update(jax.tree.map(jnp.asarray, host), js, jp)
        flat, ts, tgn = topt.update(_flat_grads(model, host), ts, flat)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-5)
    tol = dict(rtol=1e-5, atol=1e-7) if dt == "float32" else \
        dict(rtol=2 ** -7, atol=1e-6)
    if name != "adafactor":
        # the moments are kept in bfloat16: a float32 rounding on either
        # side of a bfloat16 midpoint moves a moment by one step, 2^-8 of
        # it, and an update by at most lr * 2^-7
        tol["atol"] = max(tol["atol"], kw["lr"] * 2 ** -7)
    got = tt.flat_to_numpy(model.cfg, flat)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b, np.float32), **tol)
    assert int(ts["step"]) == 3


def test_adafactor_clips_over_the_whole_stacked_leaf():
    """The rms-1 clip takes its RMS over every period of a JAX leaf: a
    per-layer RMS (no groups) moves the weights elsewhere."""
    tree, model, flat = _qwen()
    assert model.cfg.n_periods > 1
    spec = OptimizerSpec(name="adafactor", lr=1e-2, factored_min=8)
    host = _grads(tree, 0, scale=50.0)
    host["periods"]["b0"]["wi_up"][0] *= 1e3     # one layer's update large
    grads = _flat_grads(model, host)
    grouped = make_optimizer(spec, groups=model.param_groups(flat))
    alone = make_optimizer(spec)
    a = grouped.update(grads, grouped.init(flat), flat)[0]
    b = alone.update(grads, alone.init(flat), flat)[0]
    assert not torch.equal(a["blocks.1.wi_up"], b["blocks.1.wi_up"])
    jopt = jax_make_optimizer(JSpec(name="adafactor", lr=1e-2,
                                    factored_min=8))
    jp = jax.tree.map(jnp.asarray, tree)
    want = jopt.update(jax.tree.map(jnp.asarray, host), jopt.init(jp), jp)[0]
    np.testing.assert_allclose(
        a["blocks.1.wi_up"].numpy(),
        np.asarray(want["periods"]["b0"]["wi_up"][1]), rtol=1e-5, atol=1e-7)


def test_spec_for_config():
    for arch in REGISTRY:
        assert spec_for_config(get_config(arch)).name == \
            jax_spec_for_config(jax_get_config(arch)).name


# -- compression ----------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 7, 255, 256, 257, 2000])
def test_int8_quantization_matches_jax_and_its_bound(n):
    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    q, s = tc.quantize_int8(torch.from_numpy(x))
    jq, js = jc.quantize_int8(jnp.asarray(x))
    assert torch.equal(q, torch.from_numpy(np.array(jq)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = tc.dequantize_int8(q, s, x.shape)
    err = np.abs(back.numpy() - x)
    step = np.repeat(s.numpy(), 256)[:n]
    assert np.all(err <= step * 0.5 + 1e-7)
    # stochastic rounding stays within one step
    g = torch.Generator().manual_seed(0)
    qs, ss = tc.quantize_int8(torch.from_numpy(x), generator=g)
    assert np.all(np.abs(tc.dequantize_int8(qs, ss, x.shape).numpy() - x)
                  <= step + 1e-7)


def test_quantize_tree_roundtrip():
    tree = {"a": torch.from_numpy(np.random.default_rng(0).normal(
        size=(17, 9)).astype(np.float32)), "n": {"b": torch.ones(3)}}
    packed, info = tc.quantize_tree(tree)
    back = tc.dequantize_tree(packed, info)
    assert back["a"].shape == (17, 9) and back["n"]["b"].shape == (3,)
    assert float((back["a"] - tree["a"]).abs().max()) < 0.05


def test_error_feedback_conserves_mass():
    """EF invariant: kept + residual == update + old residual."""
    rng = np.random.default_rng(1)
    upd = {"w": torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))}
    resid = tc.init_residual(upd)
    kept, new_resid = tc.ef_compress_tree(upd, resid, frac=0.1)
    torch.testing.assert_close(kept["w"] + new_resid["w"], upd["w"],
                               rtol=1e-6, atol=1e-7)
    assert int((kept["w"] != 0).sum()) <= 8
    jk, _ = jc.ef_compress_tree({"w": jnp.asarray(upd["w"].numpy())},
                                jc.init_residual({"w": jnp.zeros(64)}), 0.1)
    np.testing.assert_array_equal(kept["w"].numpy(), np.asarray(jk["w"]))


# -- fault tolerance ------------------------------------------------------------
def test_heartbeat_and_sweep():
    reg = HeartbeatRegistry(suspect_after=1.0, dead_after=2.0)
    reg.beat("a", now=0.0)
    reg.beat("b", now=0.0)
    assert reg.sweep(now=0.5) == []
    reg.beat("a", now=1.5)
    died = reg.sweep(now=2.5)
    assert died == ["b"] and reg.alive() == ["a"]


def test_round_deadline_straggler_cutoff():
    rd = RoundDeadline(deadline_s=10.0, quorum_frac=2 / 3)
    assert not rd.ready(5, 10, elapsed=5.0)
    assert not rd.ready(5, 10, elapsed=11.0)       # below quorum
    assert rd.ready(7, 10, elapsed=11.0)
    assert rd.ready(10, 10, elapsed=0.1)           # all in -> go early
    assert subset_aggregate_ok(7, 10) and not subset_aggregate_ok(5, 10)


@pytest.mark.parametrize("n", [1, 2, 7, 12, 256, 512, 1000, 4096])
def test_factorize_mesh_valid(n):
    from repro.runtime.fault_tolerance import factorize_mesh as jax_fm
    pod, data, model = factorize_mesh(n)
    assert pod * data * model == n and model <= 16
    assert (pod, data, model) == jax_fm(n)


def test_elastic_controller_remesh(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"w": torch.ones(2)})
    reg = HeartbeatRegistry(dead_after=1.0)
    for i in range(512):
        reg.beat(f"n{i}", now=0.0)
    ec = ElasticController(reg, ck)
    mesh1 = ec.reconcile(now=0.5)
    assert mesh1 is not None and np.prod(mesh1) == 512
    for i in range(256):
        reg.beat(f"n{i}", now=2.0)
    mesh2 = ec.reconcile(now=2.5)
    assert mesh2 is not None and np.prod(mesh2) == 256
    assert ec.events[-1]["resume_step"] == 3
