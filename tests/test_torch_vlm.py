"""The port's VLM backbone (qwen2-vl: M-RoPE over three position streams,
precomputed embeddings in, no embedding table) on the CPU against the JAX
package.

  * ``apply_mrope`` at head dim 16 (the reduced config's: bands of 2, 3
    and 3 frequencies) and 128 (the full model's: 16, 24 and 24) on three
    distinct streams, float32 within rtol/atol 1e-5 (the two compute the
    same float32 angles; cos and sin come from other libraries), bfloat16
    within one bfloat16 step; with three equal streams it is RoPE.
  * The reduced qwen2-vl with the JAX weights carried across (norms and
    QKV biases perturbed): forward, prefill (logits and caches) and three
    decode steps on embeddings, float32 within rtol/atol 1e-5 and
    bfloat16 within rtol 2e-2 / atol 6e-2 (the dense stacks' tolerances,
    tests/test_torch_transformer.py); the prefill's positions a text
    prefix, a 4 x 4 patch grid (t constant, h and w its rows and columns)
    and text, so the three streams differ; ``Model.loss`` and its
    gradients against ``jax.value_and_grad`` (tests/test_torch_train.py's
    tolerances); decoding token by token equals the prefill on text
    positions, where the three streams are equal, as the JAX decode gives
    them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import apply_mrope as jax_mrope
from repro.models.layers import apply_rope as jax_rope
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import transformer as tt
from repro_torch.models.layers import (apply_mrope, apply_rope,
                                       mrope_sections, positions_for)
from repro_torch.models.model import build_model
from test_torch_train import _grads_close
from test_torch_transformer import BF16, F32, _np, _tol, _worlds

torch.set_num_threads(1)

ARCH = "qwen2-vl-72b"


def vision_positions(B, n_text, grid, n_tail):
    """(3, B, S) int32 M-RoPE positions: ``n_text`` text tokens, a ``grid``
    x ``grid`` patch grid (t fixed at the grid's start, h its row, w its
    column), then ``n_tail`` text tokens, each stream going on from its
    largest position so far plus one, as qwen2-vl numbers them."""
    t = list(range(n_text))
    h, w = list(t), list(t)
    start = n_text
    for r in range(grid):
        for c in range(grid):
            t.append(start)
            h.append(start + r)
            w.append(start + c)
    nxt = max(t[-1], h[-1], w[-1]) + 1
    for i in range(n_tail):
        for s in (t, h, w):
            s.append(nxt + i)
    pos = np.array([t, h, w], np.int32)
    return np.broadcast_to(pos[:, None], (3, B, pos.shape[1])).copy()


def _embeds(seed, B, S, d):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("dh", [16, 128])
def test_apply_mrope_matches_jax(dh, dt):
    B, H = 2, 3
    pos = vision_positions(B, 3, 4, 5)
    S = pos.shape[-1]
    assert len({tuple(p) for p in pos[:, 0]}) == 3      # the streams differ
    x = np.random.default_rng(dh).normal(size=(B, S, H, dh)).astype(
        np.float32)
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    want = jax_mrope(jnp.asarray(x).astype(jdt), jnp.asarray(pos), 1e6)
    got = apply_mrope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos), 1e6)
    assert got.dtype == tdt
    tol = dict(rtol=1e-5, atol=1e-5) if dt == F32 else \
        dict(rtol=2 ** -7, atol=2 ** -7)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    assert mrope_sections(dh) == ([2, 3, 3] if dh == 16 else [16, 24, 24])
    # equal streams: M-RoPE is RoPE
    same = np.broadcast_to(pos[0], pos.shape).copy()
    np.testing.assert_allclose(
        _np(apply_mrope(torch.from_numpy(x), torch.from_numpy(same), 1e6)),
        _np(jax_rope(jnp.asarray(x), jnp.asarray(same[0]), 1e6)),
        rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        apply_mrope(torch.from_numpy(x), torch.from_numpy(same), 1e6),
        apply_rope(torch.from_numpy(x), torch.from_numpy(same[0]), 1e6))


def test_positions_for_mrope():
    pos = positions_for(reduced_config(get_config(ARCH)), 2, 5, offset=3)
    assert tuple(pos.shape) == (3, 2, 5)
    assert torch.equal(pos[2, 1], torch.arange(3, 8, dtype=torch.int32))


@pytest.mark.parametrize("dt", [F32, BF16])
def test_vlm_matches_jax(dt):
    """Forward, prefill (logits and caches) and three decode steps of the
    reduced qwen2-vl on embeddings with three distinct position streams."""
    jm, jp, tm, tp = _worlds(ARCH, dt)
    assert "embed" not in jp and tp.embed is None
    B, d = 2, tm.cfg.d_model
    pos = vision_positions(B, 4, 4, 6)
    S = pos.shape[-1]
    emb = _embeds(1, B, S, d)
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    jbatch = {"embeds": jnp.asarray(emb).astype(jdt),
              "positions": jnp.asarray(pos)}
    tbatch = {"embeds": torch.from_numpy(emb).to(tdt),
              "positions": torch.from_numpy(pos)}
    tol = _tol(dt)
    np.testing.assert_allclose(_np(tm.forward(tp, tbatch)),
                               _np(jm.forward(jp, jbatch)), **tol)
    jl, jcache = jm.prefill(jp, jbatch)
    tl, tcache = tm.prefill(tp, tbatch)
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    assert sorted(tcache) == sorted(jcache)
    jstate = jm.init_decode_state(B, S + 3)
    tstate = tm.init_decode_state(B, S + 3)
    for b in jcache:
        for kv in ("k", "v"):
            np.testing.assert_allclose(_np(tcache[b][kv]),
                                       _np(jcache[b][kv]), **tol)
            jstate[b][kv] = jstate[b][kv].at[:, :, :S].set(jcache[b][kv])
            tstate[b][kv][:, :, :S] = tcache[b][kv]
    nxt = _embeds(2, B, 3, d)
    for t in range(3):
        jl, jstate = jm.decode(jp, jstate, {
            "embeds": jnp.asarray(nxt[:, t:t + 1]).astype(jdt),
            "pos": jnp.int32(S + t)})
        tl, tstate = tm.decode(tp, tstate, {
            "embeds": torch.from_numpy(nxt[:, t:t + 1]).to(tdt),
            "pos": S + t})
        np.testing.assert_allclose(_np(tl), _np(jl), **tol)


def test_vlm_loss_and_grads_match_jax():
    jm, jp, tm, tp = _worlds(ARCH, F32)
    B, d = 2, tm.cfg.d_model
    pos = vision_positions(B, 3, 3, 4)
    S = pos.shape[-1]
    labels = np.random.default_rng(3).integers(0, tm.cfg.vocab_size,
                                               (B, S)).astype(np.int32)
    batch = {"embeds": _embeds(4, B, S, d), "positions": pos,
             "labels": labels}
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, {
        k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    tloss, tgrads = value_and_grad(tm, tm.train_params(tp), {
        k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert "embed" not in tgrads
    _grads_close(tt.flat_to_numpy(tm.cfg, tgrads), jgrads, F32)


@pytest.mark.parametrize("dt,tol", [(F32, 1e-4), (BF16, 0.15)])
def test_vlm_decode_matches_prefill_on_text(dt, tol):
    """On text positions (the three streams equal) decoding the embeddings
    one by one gives the prefill's last logits (tests/test_arch_smoke.py's
    tolerances), and the prefill's caches the decode state's."""
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype=dt)
    model = build_model(cfg, "cpu")
    params = model.init_params(0)
    S = 8
    emb = torch.from_numpy(_embeds(5, 1, S, cfg.d_model)).to(
        getattr(torch, dt))
    last, caches = model.prefill(params, {
        "embeds": emb, "positions": positions_for(cfg, 1, S)})
    state = model.init_decode_state(1, S + 2)
    for t in range(S):
        got, state = model.decode(params, state, {"embeds": emb[:, t:t + 1],
                                                  "pos": t})
    np.testing.assert_allclose(_np(got), _np(last), rtol=tol, atol=tol)
    for b, kv in caches.items():
        np.testing.assert_allclose(_np(kv["k"]), _np(state[b]["k"][:, :, :S]),
                                   rtol=tol, atol=tol)
