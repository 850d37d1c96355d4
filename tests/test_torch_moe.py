"""The port's MoE FFN (``kernels.gmm``, ``models.moe``) and the reduced MoE
LMs (moonshot-v1-16b-a3b, kimi-k2-1t-a32b) on the CPU against the JAX
package.

  * ``gmm``'s plain version against ``ref.gmm_ref`` and the Pallas kernel
    in interpret mode, on tests/test_kernels.py:84-89's grid (float32 rtol
    1e-5 / atol 1e-4, bfloat16 one bfloat16 step: rtol 2^-7, the two sum
    in float32 in another order and round once).
  * ``route_topk`` (weights within 1e-6; indices equal, or a near-tie
    under ``ROUTING_GAP``), ``build_dispatch`` exactly, with and without
    dropped tokens; the fixed-order combine bit-equal to the JAX
    combine; ``moe_ffn`` and ``moe_ffn_single`` on the same inputs
    (float32 rtol/atol 1e-5; bfloat16 rtol 2e-2 / atol 6e-2, as the dense
    stacks: the frameworks round the elementwise steps at other places,
    XLA's bfloat16 sigmoid among them, and the largest gap is one or two
    bfloat16 steps of the output's largest values).
  * The whole reduced models with the JAX weights carried across:
    forward, prefill and three decode steps in float32 within rtol/atol
    1e-5; in bfloat16 layer by layer on the JAX model's activations
    (``layerwise_matches_jax``, rtol 2e-2 / atol 6e-2 as the dense
    stacks).  tests/test_torch_transformer.py runs the serve loop's ids
    against the JAX loop's, decoding against the forward and the
    parameter tree's round trip (the router float32) on these archs too.
  * ``gmm``'s form selection, case by case, and no backward through its
    launch (the plain version standing in for it on the CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced
from repro.kernels import ref
from repro.kernels.gmm import gmm as pallas_gmm
from repro.models import moe as jax_moe
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.kernels import gmm as tg
from repro_torch.kernels.factory import get_kernel
from repro_torch.models import moe as t_moe
from repro_torch.models.transformer import _from_host
from test_torch_transformer import (BF16, F32, MOE, _np, _tokens, _tol,
                                    _worlds, layerwise_matches_jax,
                                    routing_agrees)

torch.set_num_threads(1)

FFN_TOL = {F32: dict(rtol=1e-5, atol=1e-5), BF16: _tol(BF16)}


def _gmm_tol(dt):
    return dict(rtol=1e-5, atol=1e-4) if dt == jnp.float32 \
        else dict(rtol=2 ** -7, atol=2 ** -7)


def _torch_of(a) -> torch.Tensor:
    return _from_host(np.asarray(a))


@pytest.mark.parametrize("E,C,d,f,dt", [
    (8, 96, 64, 200, jnp.float32),
    (4, 128, 128, 512, jnp.bfloat16),
    (1, 8, 32, 64, jnp.float32),
])
def test_gmm_plain_matches_jax(E, C, d, f, dt):
    rng = np.random.default_rng(E * C + f)
    xe = jnp.asarray(rng.normal(size=(E, C, d)), dt)
    w = jnp.asarray(rng.normal(size=(E, d, f)), dt)
    want = ref.gmm_ref(xe, w)
    pallas = pallas_gmm(xe, w, block_c=32, block_f=64, interpret=True)
    tx, tw = _torch_of(xe), _torch_of(w)
    before = tg.gmm.launches
    got = get_kernel("gmm")(tx, tw)            # the wrapper, on the CPU
    assert tg.gmm.launches == before           # plain there: no launch
    assert got.dtype == tx.dtype and tuple(got.shape) == (E, C, f)
    assert torch.equal(got, tg.gmm_torch(tx, tw))
    for other in (want, pallas):
        np.testing.assert_allclose(_np(got), _np(other), **_gmm_tol(dt))


def test_gmm_refuses_bad_shapes():
    with pytest.raises(ValueError, match=r"\(E, C, d\)"):
        tg.gmm(torch.zeros(2, 3, 4), torch.zeros(2, 5, 6))
    assert tuple(tg.gmm(torch.zeros(2, 0, 4), torch.zeros(2, 4, 6)).shape) \
        == (2, 0, 6)


def test_route_topk_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 50, 16)).astype(np.float32)
    # token 0: an exact tie between the 4th and the 5th expert, which the
    # two top-k may break either way; the rest agree exactly
    logits[0, 0] = np.arange(16, dtype=np.float32) / 10
    logits[0, 0, 11] = logits[0, 0, 12]
    same, gap = routing_agrees(jnp.asarray(logits), torch.from_numpy(logits),
                               4, "route_topk")
    assert same.reshape(-1)[1:].all() and gap == 0.0
    w, idx = t_moe.route_topk(torch.from_numpy(logits), 4)
    assert idx.shape == (3, 50, 4)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-6)


def _random_routes(rng, B, S, k, E, skew=0.0):
    """Top-k expert ids and weights as route_topk makes them, with expert 0
    favoured by ``skew`` so that some queues overflow."""
    logits = rng.normal(size=(B, S, E)).astype(np.float32)
    logits[..., 0] += skew
    w, idx = jax_moe.route_topk(jnp.asarray(logits), k)
    return np.asarray(idx), np.asarray(w)


@pytest.mark.parametrize("B,S,k,E,cap,skew", [
    (2, 24, 2, 8, 8, 0.0), (3, 40, 6, 16, 8, 2.0), (1, 5, 2, 4, 8, 0.0),
    (2, 64, 2, 8, 8, 3.0)])
def test_build_dispatch_matches_jax(B, S, k, E, cap, skew):
    idx, w = _random_routes(np.random.default_rng(S + k), B, S, k, E, skew)
    want = [jax_moe.build_dispatch(jnp.asarray(idx[b]), jnp.asarray(w[b]), E,
                                   cap) for b in range(B)]
    tok, sw = t_moe.build_dispatch(torch.from_numpy(idx.copy()).long(),
                                   torch.from_numpy(w.copy()), E, cap)
    assert tuple(tok.shape) == (B, E, cap) and sw.dtype == torch.float32
    for b in range(B):
        np.testing.assert_array_equal(tok[b].numpy(), np.asarray(want[b][0]))
        np.testing.assert_array_equal(sw[b].numpy(), np.asarray(want[b][1]))
    # each expert keeps the first cap pairs of its queue
    counts = np.stack([np.bincount(idx[b].reshape(-1), minlength=E)
                       for b in range(B)])
    assert int((sw > 0).sum()) == int(np.minimum(counts, cap).sum())
    if skew >= 2.0:                            # overflowing queues drop
        assert (counts > cap).any()


def _ffn_world(arch, dt, seed=1):
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), dtype=dt)
    tcfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dt)
    p = jax.tree.map(np.asarray, jax_moe.init_moe_params(
        jax.random.key(seed), jcfg, jnp.dtype(dt)))
    return jcfg, tcfg, p, {k: _from_host(v) for k, v in p.items()}


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_jax(arch, dt):
    jcfg, tcfg, p, tp = _ffn_world(arch, dt)
    assert tp["router"].dtype == torch.float32
    rng = np.random.default_rng(2)
    # a shared offset skews the routing: some queues overflow and drop
    x = (rng.normal(size=(3, 100, tcfg.d_model)) + 1.5).astype(np.float32)
    jx = jnp.asarray(x, jnp.dtype(dt))
    tx = _torch_of(jx)
    jl = jnp.einsum("bsd,de->bse", jx.astype(jnp.float32), p["router"])
    same, _ = routing_agrees(jl, tx.to(torch.float32) @ tp["router"],
                             tcfg.moe.top_k, "moe_ffn")
    cap = t_moe.capacity(tcfg, 100)
    _, sw = t_moe.build_dispatch(*[torch.from_numpy(np.array(a)) for a in
                                   jax_moe.route_topk(jl, tcfg.moe.top_k)
                                   [::-1]], tcfg.moe.n_experts, cap)
    assert int((sw > 0).sum()) < 3 * 100 * tcfg.moe.top_k   # drops happen
    before = tg.gmm.launches
    got = t_moe.moe_ffn(tcfg, tp, tx)
    assert tg.gmm.launches == before and got.dtype == tx.dtype
    want = jax_moe.moe_ffn(jcfg, jax.tree.map(jnp.asarray, p), jx)
    np.testing.assert_allclose(_np(got)[same], _np(want)[same], **FFN_TOL[dt])

    x1 = jx[:, :1]
    got1 = t_moe.moe_ffn_single(tcfg, tp, _torch_of(x1))
    want1 = jax_moe.moe_ffn_single(jcfg, jax.tree.map(jnp.asarray, p), x1)
    assert tuple(got1.shape) == (3, 1, tcfg.d_model)
    np.testing.assert_allclose(_np(got1), _np(want1), **FFN_TOL[dt])


@pytest.mark.parametrize("arch", MOE)
def test_moe_lm_matches_jax_float32(arch):
    """Forward, prefill (logits and caches) and three decode steps of the
    whole reduced model, chained, in float32 within rtol/atol 1e-5."""
    jm, jp, tm, tp = _worlds(arch, F32)
    toks = _tokens(1, 2, 24)
    tol = _tol(F32)
    np.testing.assert_allclose(
        _np(tm.forward(tp, {"tokens": torch.from_numpy(toks)})),
        _np(jm.forward(jp, {"tokens": jnp.asarray(toks)})), **tol)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    assert sorted(tcache) == sorted(jcache)
    S = toks.shape[1]
    jstate = jm.init_decode_state(2, S + 3)
    tstate = tm.init_decode_state(2, S + 3)
    for b in jcache:
        for kv in ("k", "v"):
            np.testing.assert_allclose(_np(tcache[b][kv]),
                                       _np(jcache[b][kv]), **tol)
            jstate[b][kv] = jstate[b][kv].at[:, :, :S].set(jcache[b][kv])
            tstate[b][kv][:, :, :S] = tcache[b][kv]
    nxt = _tokens(2, 2, 3)
    for t in range(3):
        jl, jstate = jm.decode(jp, jstate, {
            "tokens": jnp.asarray(nxt[:, t:t + 1]), "pos": jnp.int32(S + t)})
        tl, tstate = tm.decode(tp, tstate, {
            "tokens": torch.from_numpy(nxt[:, t:t + 1]), "pos": S + t})
        np.testing.assert_allclose(_np(tl), _np(jl), **tol)


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("arch", MOE)
def test_moe_lm_layerwise_matches_jax(arch, dt):
    gap = layerwise_matches_jax(arch, dt, _tokens(4, 2, 24))
    assert gap < 1e-6


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("arch", MOE)
def test_combine_is_bit_equal_to_jax_combine(arch, dt):
    """The fixed-order combine (each token's slot rows in ascending expert
    order, one add per rank from zeros) against the JAX combine (a
    scatter-add over the (expert, slot) table, src/repro/models/moe.py:
    118-127) on the same weighted slot rows and the JAX dispatch, with
    dropped pairs: bit-equal."""
    jcfg, tcfg, p, _ = _ffn_world(arch, dt)
    m = tcfg.moe
    E, k, d = m.n_experts, m.top_k, tcfg.d_model
    B, S = 3, 100
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(B, S, d)) + 1.5).astype(np.float32)
    w, idx = jax_moe.route_topk(jnp.einsum("bsd,de->bse", x, p["router"]),
                                k)
    cap = t_moe.capacity(tcfg, S)
    slot_token, slot_w = jax.vmap(
        lambda i, ww: jax_moe.build_dispatch(i, ww, E, cap))(idx, w)
    assert int((slot_w > 0).sum()) < B * S * k             # drops happen
    ye = jnp.asarray(rng.normal(size=(B, E, cap, d)), jnp.dtype(dt))
    ye = ye * slot_w[..., None].astype(ye.dtype)

    def combine_row(y_row, tok_row):                   # the JAX combine
        return jnp.zeros((S, d), y_row.dtype).at[tok_row.reshape(E * cap)
                                                 ].add(y_row.reshape(-1, d))
    want = jax.vmap(combine_row)(ye, slot_token)
    _, _, pair_row = t_moe._dispatch(torch.from_numpy(np.array(idx)),
                                     torch.from_numpy(np.array(w)), E, cap)
    rows = _torch_of(ye).transpose(0, 1).reshape(E * B * cap, d)
    got = t_moe.combine(torch.cat([rows, rows.new_zeros(1, d)]), pair_row)
    assert got.dtype == rows.dtype
    np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype,C,d,f,aligned,want", [
    (torch.bfloat16, 1920, 2048, 1408, True, "wgmma"),   # moonshot prefill
    (torch.bfloat16, 1920, 1408, 2048, True, "wgmma"),
    (torch.bfloat16, 33, 72, 200, True, "wgmma"),
    (torch.bfloat16, 8, 2048, 1408, True, "stream"),     # moonshot decode
    (torch.bfloat16, 32, 1104, 40, True, "stream"),
    (torch.bfloat16, 1920, 2048, 1408, False, "wmma"),   # TMA cannot read
    (torch.bfloat16, 1920, 2044, 1408, True, "wmma"),
    (torch.bfloat16, 65, 40, 33, True, "wmma"),
    (torch.bfloat16, 8, 2048, 1404, True, "skinny"),
    (torch.bfloat16, 8, 2048, 1408, False, "skinny"),
    (torch.float32, 1920, 2048, 1408, True, "simt"),
    (torch.float32, 8, 2048, 1408, True, "skinny"),
    (torch.float32, 33, 64, 64, True, "simt"),
])
def test_gmm_form(dtype, C, d, f, aligned, want):
    """The kernel's form is a pure function of the dtype, C, d, f and the
    tensors' alignment: TMA takes bfloat16 rows of a multiple of 16 bytes
    on 16-byte boundaries (wgmma above SKINNY_C rows, stream up to it)."""
    assert tg.form(dtype, C, d, f, aligned) == want
    assert set(tg.FORMS) == {"simt", "wmma", "wgmma", "skinny", "stream"}


def test_gmm_kernel_has_no_backward(monkeypatch):
    """The launch sits in an autograd.Function whose backward is the
    ``gmm_bwd`` op (the plain versions stand in for the launches on the
    CPU): its gradients equal the plain version's own, which itself
    differentiates (tests/test_torch_moe_bwd.py holds the gradient)."""
    monkeypatch.setattr(tg, "_launch", tg.gmm_torch)
    g = np.random.default_rng(0)
    xe = torch.from_numpy(g.normal(size=(2, 40, 16)).astype(np.float32))
    w = torch.from_numpy(g.normal(size=(2, 16, 8)).astype(np.float32))
    out = tg._KernelGmm.apply(xe.requires_grad_(), w.requires_grad_())
    torch.testing.assert_close(out, tg.gmm_torch(xe, w))
    out.sum().backward()
    got = xe.grad.clone(), w.grad.clone()
    xe.grad = w.grad = None
    tg.gmm(xe, w).sum().backward()
    assert torch.isfinite(xe.grad).all() and xe.grad.abs().sum() > 0
    assert torch.equal(got[0], xe.grad) and torch.equal(got[1], w.grad)


def test_moe_ffn_differentiates_on_the_cpu():
    """The CPU path (plain gmm, fixed-order combine) carries gradients to
    the input and every weight, as training through the plain versions
    needs (ROADMAP.md queue 1 item 10(d))."""
    _, tcfg, _, tp = _ffn_world(MOE[0], F32)
    tp = {k: v.clone().requires_grad_() for k, v in tp.items()}
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 20, tcfg.d_model)).astype(np.float32)).requires_grad_()
    t_moe.moe_ffn(tcfg, tp, x).square().sum().backward()
    for t in (x, tp["moe_wg"], tp["moe_wu"], tp["moe_wo"]):
        assert torch.isfinite(t.grad).all() and t.grad.abs().sum() > 0
