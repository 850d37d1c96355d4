"""The port's rollup round (``fl/round.py``) on the CPU against the JAX
package's: ``build_fl_round`` at T 3, H 2 with unequal scores, for the
plain and the int8 commit; ``digest_tree`` bit for bit; and the three
round properties of ``tests/test_system.py``.

Tolerances (float32, reduced qwen2-0.5b, sgdm at lr 0.05): the merged
weights within 1e-4 of their value plus 1e-5 (two frameworks' gradients
in another summation order, through two steps); the int8 commit within
one quantization step of the largest delta as well (a delta within
float32 noise of a rounding midpoint may round the other way); the
distances rtol 1e-4 and the loss rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced
from repro.fl.round import FLRoundSpec as JSpec
from repro.fl.round import build_fl_round as jax_round
from repro.fl.round import digest_tree as jax_digest
from repro.models.model import build_model as jax_build
from repro.optim.optimizers import OptimizerSpec as JOpt
from repro.optim.optimizers import make_optimizer as jax_opt
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.aggregation import weighted_average_tree
from repro_torch.fl.round import FLRoundSpec, build_fl_round, digest_tree
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import transformer as tt
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer

torch.set_num_threads(1)


def _worlds():
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("qwen2-0.5b")),
                               dtype="float32")
    tcfg = dataclasses.replace(reduced_config(get_config("qwen2-0.5b")),
                               dtype="float32")
    jm = jax_build(jcfg)
    tree = jax.tree.map(np.asarray, jm.init_params(jax.random.key(0)))
    tm = build_model(tcfg, "cpu")
    flat = tm.train_params(tt.params_from_numpy(tcfg, tree, device="cpu"))
    return jm, tree, tm, flat


def _batches(vocab, T, H, B, S, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (T, H, B, S + 1))
    return {"tokens": toks[..., :-1].astype(np.int32),
            "labels": toks[..., 1:].astype(np.int32)}


def _stack(tree, T):
    if isinstance(tree, dict):
        return {k: _stack(v, T) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.expand((T,) + tree.shape)
    return jnp.stack([jnp.asarray(tree)] * T)


def _row0(params_T):
    return {k: v[0] for k, v in params_T.items()}


def _leaves(tree):
    return [np.asarray(v, np.float32) for v in jax.tree.leaves(tree)]


@pytest.mark.parametrize("compression", ["none", "int8"])
def test_fl_round_matches_jax(compression):
    jm, tree, tm, flat = _worlds()
    T, H, B, S = 3, 2, 2, 12
    kw = dict(name="sgdm", lr=0.05)
    jo, to = jax_opt(JOpt(**kw)), make_optimizer(OptimizerSpec(**kw))
    batches = _batches(tm.cfg.vocab_size, T, H, B, S)
    scores = np.array([1.0, 0.5, 0.25], np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jout, _, jm_ = jax.jit(jax_round(jm, jo, JSpec(T, H, B, compression)))(
        _stack(jparams, T), _stack(jo.init(jparams), T),
        jnp.asarray(scores), {k: jnp.asarray(v) for k, v in batches.items()})
    tout, topt, tm_ = build_fl_round(tm, to, FLRoundSpec(T, H, B,
                                                         compression))(
        _stack(flat, T), _stack(to.init(flat), T), torch.from_numpy(scores),
        {k: torch.from_numpy(v) for k, v in batches.items()})
    got = _leaves(tt.flat_to_numpy(tm.cfg, _row0(tout)))
    want = [a[0] for a in _leaves(jout)]
    start = _leaves(tree)
    for g, w, s0 in zip(got, want, start):
        atol = 1e-5 + (np.abs(w - s0).max() / 127 if compression == "int8"
                       else 0.0)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol)
    np.testing.assert_allclose(tm_["distances"].numpy(),
                               np.asarray(jm_["distances"]), rtol=1e-4)
    np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                               rtol=1e-5)
    assert int(tm_["digest"]) == int(digest_tree(_row0(tout)))
    assert int(topt["step"][0]) == H


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_digest_tree_is_the_jax_digest(dtype):
    g = np.random.default_rng(3)
    shapes = {"a": (17, 9), "b": (4,), "c": {"d": (3, 5, 2), "e": (1,)}}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return g.normal(size=s).astype(np.float32) * 3.0
    host = make(shapes)
    jtree = jax.tree.map(lambda a: jnp.asarray(a, dtype), host)
    ttree = jax.tree.map(lambda a: torch.from_numpy(a).to(
        getattr(torch, dtype)), host)
    want = int(jax_digest(jtree))
    assert int(digest_tree(ttree)) == want
    # a sum: the leaves' order does not matter
    assert int(digest_tree({"z": ttree["a"], "y": ttree["c"],
                            "x": ttree["b"]})) == want


@pytest.fixture(scope="module")
def tiny_lm():
    cfg = reduced_config(get_config("qwen2-0.5b"))
    model = build_model(cfg, "cpu")
    opt = make_optimizer(OptimizerSpec(name="sgdm", lr=0.05, grad_clip=1e9))
    return cfg, model, opt


def _tok_batches(cfg, T, H, B, S, seed=0):
    return {k: torch.from_numpy(v) for k, v in
            _batches(cfg.vocab_size, T, H, B, S, seed).items()}


def test_fl_round_equal_scores_is_param_average(tiny_lm):
    cfg, model, opt = tiny_lm
    T, H, B, S = 4, 1, 2, 16
    fl_round = build_fl_round(model, opt, FLRoundSpec(T, H, B))
    params = model.train_params(model.init_params(0))
    batches = _tok_batches(cfg, T, H, B, S)
    scores = torch.ones(T)
    out_T, _, metrics = fl_round(_stack(params, T),
                                 _stack(opt.init(params), T), scores,
                                 batches)

    def one_step(p, batch):
        _, g = value_and_grad(model, p, batch)
        return opt.update(g, opt.init(p), p)[0]
    locals_ = [one_step(params, {k: v[i, 0] for k, v in batches.items()})
               for i in range(T)]
    want = weighted_average_tree(
        {k: torch.stack([p[k] for p in locals_]) for k in params}, scores)
    for k in params:
        np.testing.assert_allclose(out_T[k][0].float().numpy(),
                                   want[k].float().numpy(), rtol=5e-2,
                                   atol=5e-3)
    assert np.isfinite(float(metrics["loss"]))
    assert int(metrics["digest"]) != 0


def test_fl_round_reputation_downweights_poison(tiny_lm):
    """A zero-score trainer's poisoned params must not move the merge."""
    cfg, model, opt = tiny_lm
    T, H, B, S = 3, 1, 2, 16
    fl_round = build_fl_round(model, opt, FLRoundSpec(T, H, B))
    params = model.train_params(model.init_params(0))
    base_T = {k: v.expand((T,) + v.shape).clone() for k, v in params.items()}
    poison_T = {k: v.clone() for k, v in base_T.items()}
    for v in poison_T.values():
        v[2] = 37.0
    opt_T = _stack(opt.init(params), T)
    batches = _tok_batches(cfg, T, H, B, S)
    scores = torch.tensor([1.0, 1.0, 0.0])
    clean, _, _ = fl_round(base_T, opt_T, scores, batches)
    poisoned, _, _ = fl_round(poison_T, opt_T, scores, batches)
    for k in clean:
        assert float((clean[k].float() - poisoned[k].float()).abs().max()) \
            < 5e-2


def test_fl_round_h_steps_diverge_then_commit(tiny_lm):
    cfg, model, opt = tiny_lm
    T, H, B, S = 2, 4, 2, 16
    fl_round = build_fl_round(model, opt, FLRoundSpec(T, H, B))
    params = model.train_params(model.init_params(0))
    out_T, _, m = fl_round(_stack(params, T), _stack(opt.init(params), T),
                           torch.ones(T), _tok_batches(cfg, T, H, B, S, 3))
    # trainers genuinely diverged during local steps (distances > 0)...
    assert (m["distances"] > 0).all()
    # ...and the commit broadcast made replicas identical again
    for leaf in out_T.values():
        assert torch.equal(leaf[0], leaf[1])


def test_fl_round_launches_each_fl_kernel_once(tiny_lm, monkeypatch):
    """Eq. 1 and Eq. 4 run once a round on the (T, P) stack."""
    from repro_torch.kernels import factory
    cfg, model, opt = tiny_lm
    calls = []
    for op in ("weighted_agg", "model_distance"):
        impl = factory.get_kernel(op)

        def wrapped(*a, _impl=impl, _op=op, **kw):
            calls.append((_op, tuple(a[0].shape)))
            return _impl(*a, **kw)
        monkeypatch.setitem(factory._REGISTRY[op], "cuda", wrapped)
    T, H = 3, 2
    params = model.train_params(model.init_params(0))
    P = sum(v.numel() for v in params.values())
    build_fl_round(model, opt, FLRoundSpec(T, H, 2))(
        _stack(params, T), _stack(opt.init(params), T), torch.ones(T),
        _tok_batches(cfg, T, H, 2, 8))
    assert calls == [("weighted_agg", (T, P)), ("model_distance", (T, P))]
