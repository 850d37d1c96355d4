"""The port's dense token LM (``models.transformer``, the ``Model`` facade
and the serve loop) on the CPU against the JAX package.

The JAX parameters are carried across (``params_from_numpy``), with every
norm scale and bias perturbed so that each of them matters: torch's RNG
cannot reproduce ``jax.random``.  Reduced configs of the four dense token
archs: yi-6b, qwen2-0.5b (QKV bias), qwen1.5-0.5b and qwen3-32b (QK norm).

Tolerances: float32 rtol 1e-5 / atol 1e-5 (the two frameworks sum in
another order; the largest gap seen is 4e-6 on logits of order 3);
bfloat16 rtol 2e-2 / atol 6e-2, a few bfloat16 steps (2^-6 at 2-4) on
logits of order 3: the frameworks round bfloat16 products and elementwise
ops at different places, and two layers compound it.
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
from repro_torch.configs.registry import REGISTRY, get_config, reduced_config
from repro_torch.launch import serve_model
from repro_torch.models import transformer as tt
from repro_torch.models.model import build_model

torch.set_num_threads(1)

DENSE = ["yi-6b", "qwen2-0.5b", "qwen1.5-0.5b", "qwen3-32b"]
F32, BF16 = "float32", "bfloat16"


def _tol(dt):
    return dict(rtol=2e-2, atol=6e-2) if dt == BF16 \
        else dict(rtol=1e-5, atol=1e-5)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _worlds(arch, dt, seed=0):
    """(JAX model, JAX params, port model, port params) on one config in
    ``dt``, the port's weights carried across from the JAX ones."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), dtype=dt)
    tcfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dt)
    jm = jax_build(jcfg)
    g = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key in ("ln", "ln2", "final_norm", "bq", "bk", "bv",
                            "q_norm", "k_norm"):
            a = (a.astype(np.float32)
                 + 0.2 * g.normal(size=a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(
        perturb, jm.init_params(jax.random.key(seed)))
    jp = jax.tree.map(jnp.asarray, tree)
    tm = build_model(tcfg, "cpu")
    return jm, jp, tm, tt.params_from_numpy(tcfg, tree, device="cpu")


def _tokens(seed, B, S, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_decode_match_jax(arch, dt):
    jm, jp, tm, tp = _worlds(arch, dt)
    toks = _tokens(1, 2, 24)
    tol = _tol(dt)
    np.testing.assert_allclose(
        _np(tm.forward(tp, {"tokens": torch.from_numpy(toks)})),
        _np(jm.forward(jp, {"tokens": jnp.asarray(toks)})), **tol)

    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    assert sorted(tcache) == sorted(jcache)
    for b in jcache:
        for kv in ("k", "v"):
            assert tuple(tcache[b][kv].shape) == jcache[b][kv].shape
            np.testing.assert_allclose(_np(tcache[b][kv]),
                                       _np(jcache[b][kv]), **tol)

    # the prefill's caches written into a longer decode state; two steps
    S, extra = toks.shape[1], 4
    jstate = jm.init_decode_state(2, S + extra)
    tstate = tm.init_decode_state(2, S + extra)
    for b in jcache:
        for kv in ("k", "v"):
            jstate[b][kv] = jstate[b][kv].at[:, :, :S].set(jcache[b][kv])
            tstate[b][kv][:, :, :S] = tcache[b][kv]
    nxt = _tokens(2, 2, 2)
    for t in range(2):
        jl, jstate = jm.decode(jp, jstate, {
            "tokens": jnp.asarray(nxt[:, t:t + 1]), "pos": jnp.int32(S + t)})
        tl, tstate = tm.decode(tp, tstate, {
            "tokens": torch.from_numpy(nxt[:, t:t + 1]), "pos": S + t})
        np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    for b in jstate:
        for kv in ("k", "v"):
            np.testing.assert_allclose(_np(tstate[b][kv]),
                                       _np(jstate[b][kv]), **tol)


@pytest.mark.parametrize("arch", DENSE)
def test_params_round_trip(arch):
    _, jp, tm, tp = _worlds(arch, BF16)
    tree = tt.params_to_numpy(tp)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    assert jax.tree.structure(tree) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.shape == b.shape and np.array_equal(a, b)
    back = tt.params_from_numpy(tm.cfg, tree, device="cpu",
                                dtype=torch.bfloat16)
    for (name, a), (_, b) in zip(tp.named_parameters(),
                                 back.named_parameters()):
        assert a.dtype == b.dtype and torch.equal(a, b), name
    # a freshly drawn module survives the round trip bit for bit
    fresh = tm.init_params(3)
    again = tt.params_from_numpy(tm.cfg, tt.params_to_numpy(fresh),
                                 device="cpu", dtype=torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(fresh.parameters(),
                                                 again.parameters()))
    assert not any(p.requires_grad for p in fresh.parameters())


@pytest.mark.parametrize("dt,tol", [(F32, 1e-4), (BF16, 0.15)])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_matches_forward(arch, dt, tol):
    """tests/test_arch_smoke.py's KV-cache check on the port: decoding
    token by token equals the one-shot forward (float32 to 1e-4, bfloat16
    at that test's 0.15), and so does the prefill's last position."""
    cfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dt)
    model = build_model(cfg, "cpu")
    params = model.init_params(0)
    toks = torch.from_numpy(_tokens(5, 1, 9))
    S = 8
    want = model.forward(params, {"tokens": toks})[:, S - 1]
    state = model.init_decode_state(1, S + 4)
    for t in range(S):
        got, state = model.decode(params, state,
                                  {"tokens": toks[:, t:t + 1], "pos": t})
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    last, caches = model.prefill(params, {"tokens": toks[:, :S]})
    np.testing.assert_allclose(_np(last), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(caches["b0"]["k"]),
                               _np(state["b0"]["k"][:, :, :S]),
                               rtol=tol, atol=tol)


def _jax_serve_loop(model, params, prompts, n_tokens):
    """The decode loop of the JAX package's launch/serve_model.py."""
    B, P = prompts.shape
    state = model.init_decode_state(B, P + n_tokens + 1)
    decode = jax.jit(model.decode)
    for t in range(P):
        logits, state = decode(params, state, {
            "tokens": jnp.asarray(prompts[:, t:t + 1], jnp.int32),
            "pos": jnp.int32(t)})
    tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    generated = []
    for t in range(P, P + n_tokens):
        generated.append(np.asarray(tok)[:, 0])
        logits, state = decode(params, state, {"tokens": tok,
                                               "pos": jnp.int32(t)})
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    return np.stack(generated, 1)


def test_generate_matches_jax_serve_loop():
    jm, jp, tm, tp = _worlds("yi-6b", F32, seed=1)
    prompts = np.random.default_rng(0).integers(0, 256, (4, 8))
    want = _jax_serve_loop(jm, jp, prompts, 8)
    got = serve_model.generate(tm, tp, prompts, 8)
    assert got.shape == (4, 8)
    np.testing.assert_array_equal(got, want)


def test_serve_model_main_on_cpu(capsys):
    out = serve_model.main(["--reduced", "--device", "cpu", "--batch", "2",
                            "--prompt-len", "3", "--tokens", "4"])
    assert out["tokens"].shape == (2, 4) and out["tokens_per_s"] > 0
    assert "served 2 x 7 steps" in capsys.readouterr().out


@pytest.mark.parametrize("arch,item", [
    ("moonshot-v1-16b-a3b", "10(b)"), ("kimi-k2-1t-a32b", "10(b)"),
    ("xlstm-1.3b", "10(c)"), ("jamba-1.5-large-398b", "10(e)"),
    ("whisper-medium", "10(e)"), ("qwen2-vl-72b", "10(e)"),
    ("lenet5", "10(e)")])
def test_unported_families_raise(arch, item):
    cfg = reduced_config(REGISTRY[arch])
    with pytest.raises(NotImplementedError, match=item.replace("(", r"\(")
                       .replace(")", r"\)")):
        build_model(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tt.TransformerLM(cfg, device="cpu")
