"""The port's xLSTM (``kernels.slstm_scan``, ``models.xlstm``) and the
reduced xlstm-1.3b on the CPU against the JAX package.

  * ``slstm_scan``'s plain version against the Pallas kernel in interpret
    mode (through ``expand_block_diag``) and against the model's
    ``_slstm_scan``, on tests/test_slstm_kernel.py:22's grid plus S = 1 and
    S = 37: float32 rtol/atol 1e-5 (sums in another order).
  * ``mlstm_mix`` chunked (S = 512, two chunks of 256) and whole-sequence
    (S = 37), its single-token step, ``mlstm_block`` and ``slstm_block``
    with and without a state (the decode path), on the same inputs:
    float32 rtol 1e-5, atol 1e-5 of the largest |value|; bfloat16 rtol
    2e-2, atol 2^-5 of the largest |value| (four bfloat16 steps there: XLA
    rounds the scaled k projection once where the port rounds twice, and
    the mLSTM's sums and normaliser err in proportion to their largest
    terms).
  * The whole reduced model with the JAX weights carried across: forward,
    prefill and three decode steps chained in float32 within rtol/atol
    1e-4, not 1e-5: eight exponential-gated layers amplify float32
    rounding, so that the JAX model itself moves its logits by more than
    1e-5 when its embedding table moves by one float32 step
    (``test_xlstm_chain_tolerance_is_the_models_own``), while every block
    on the same inputs stays within 1e-5 (above, and the layer-by-layer
    check); in bfloat16 layer by layer on the JAX model's activations.
    tests/test_torch_transformer.py runs the serve loop's ids, decoding
    against the forward and the parameter tree's round trip on it too.
  * bfloat16 prefill against decode: the port's gap no wider than the JAX
    model's own plus one bfloat16 step of the logits.
  * The kernel's wrapper on the CPU, the launch replaced by the plain
    version: batches over ``MAX_BATCH`` rows split into grid-form launches
    of ``MAX_BATCH``, and a backward through the launch raises.
  * The cluster form's choice (``slstm_scan.form``, case by case), its
    split of h into bfloat16 pieces (three sum back exactly, two within
    2^-16), and a plain mirror of its arithmetic (``slstm_cluster_torch``)
    against the plain version and the Pallas kernel (interpret mode) within
    ``KERNEL_TOL``, on the reduced xlstm and on heads up to 512 wide.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced
from repro.kernels.slstm_scan import expand_block_diag as jax_expand
from repro.kernels.slstm_scan import slstm_scan as pallas_slstm
from repro.models import xlstm as jx
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.kernels import slstm_scan as ts
from repro_torch.kernels.factory import get_kernel
from repro_torch.models import xlstm as tx
from repro_torch.models.transformer import _from_host
from test_torch_transformer import (BF16, F32, _np, _tokens, _worlds,
                                    layerwise_matches_jax)

torch.set_num_threads(1)

ARCH = "xlstm-1.3b"
# (rtol, atol as a share of the largest |want|): the mLSTM's sums and its
# normaliser err in proportion to their largest terms, not to each output
BLOCK_TOL = {F32: (1e-5, 1e-5), BF16: (2e-2, 2 ** -5)}
CHAIN_TOL = dict(rtol=1e-4, atol=1e-4)


def _held(got, want, dt):
    rtol, share = BLOCK_TOL[dt]
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=share * float(np.abs(want).max()))


def _t(a) -> torch.Tensor:
    return _from_host(np.asarray(a))


def _cfgs(dt=F32):
    return (dataclasses.replace(jax_reduced(jax_get_config(ARCH)), dtype=dt),
            dataclasses.replace(reduced_config(get_config(ARCH)), dtype=dt))


@pytest.mark.parametrize("B,S,block_t", [(2, 32, 8), (1, 64, 16), (3, 16, 16),
                                         (2, 1, 1), (2, 37, 37)])
def test_slstm_scan_plain_matches_jax(B, S, block_t):
    jcfg, _ = _cfgs()
    cfg = jax_reduced(JAX_REGISTRY[ARCH])
    rng = np.random.default_rng(S)
    nh, d = cfg.n_heads, cfg.d_model
    dh = d // nh
    r_gates = rng.normal(0, 0.3, (nh, dh, 4 * dh)).astype(np.float32)
    wx = rng.normal(0, 0.5, (B, S, 4 * d)).astype(np.float32)
    state = jx.init_slstm_state(cfg, B)
    # a live state: the scan continues one that has run
    state = {k: jnp.asarray(rng.normal(0, 0.5, v.shape), jnp.float32)
             if k != "mm" else v for k, v in state.items()}
    want_y, want_state = jx._slstm_scan(jcfg, {"r_gates": r_gates},
                                        jnp.asarray(wx), state)
    r_exp = jax_expand(jnp.asarray(r_gates))
    assert np.array_equal(_np(ts.expand_block_diag(torch.from_numpy(r_gates))),
                          np.asarray(r_exp))
    p_y, p_carry = pallas_slstm(jnp.asarray(wx), r_exp, state["h"],
                                state["c"], state["nn"], state["mm"], nh=nh,
                                block_t=block_t, interpret=True)
    args = [torch.from_numpy(wx), torch.from_numpy(r_gates)] + \
        [_t(state[k]) for k in ("h", "c", "nn", "mm")]
    before = ts.slstm_scan.launches
    y, carry = get_kernel("slstm_scan")(*args)      # the wrapper, on the CPU
    assert ts.slstm_scan.launches == before
    assert y.dtype == torch.float32 and tuple(y.shape) == (B, S, d)
    tol = dict(rtol=1e-5, atol=1e-5)
    for want, wcarry in ((want_y, [want_state[k] for k in
                                   ("h", "c", "nn", "mm")]), (p_y, p_carry)):
        np.testing.assert_allclose(_np(y), np.asarray(want), **tol)
        for got, w in zip(carry, wcarry):
            np.testing.assert_allclose(_np(got), np.asarray(w), **tol)


def test_slstm_scan_bfloat16_and_refusals():
    """bfloat16 wx and weights enter the float32 recurrence exactly; bad
    shapes and a batch the kernel cannot hold are refused."""
    rng = np.random.default_rng(0)
    wx = torch.from_numpy(rng.normal(0, 0.5, (2, 5, 64)).astype(np.float32))
    r = torch.from_numpy(rng.normal(0, 0.3, (2, 8, 32)).astype(np.float32))
    st = [torch.zeros(2, 16) for _ in range(3)] + [torch.full((2, 16), -1e30)]
    y16, _ = ts.slstm_scan(wx.bfloat16(), r.bfloat16(), *st)
    y32, _ = ts.slstm_scan(wx.bfloat16().float(), r.bfloat16().float(), *st)
    assert y16.dtype == torch.float32 and torch.equal(y16, y32)
    with pytest.raises(ValueError, match=r"\(B, S, 4d\)"):
        ts.slstm_scan(wx[..., :60], r, *st)
    with pytest.raises(TypeError, match="float32"):
        ts.slstm_scan(wx, r, *[s.double() for s in st])
    with pytest.raises(ValueError, match="batch rows"):
        ts.plan(ts.MAX_BATCH + 1, 512)
    with pytest.raises(ValueError, match="shared memory"):
        ts.plan(16, 1024)
    assert ts.plan(8, 512) == (16, 4 * (512 * 64 + 8 * 512 + 8 * 8 * 64))
    assert ts.plan(2, 12)[0] == 4


def _mlstm_inputs(S, dt, seed=0):
    jcfg, tcfg = _cfgs(dt)
    p = jax.tree.map(np.asarray, jx.init_mlstm_params(
        jax.random.key(seed), jcfg, jnp.dtype(dt)))
    rng = np.random.default_rng(seed)
    for k in ("b_ig", "b_fg", "ln", "gn"):
        p[k] = (p[k].astype(np.float32) + 0.3 * rng.normal(size=p[k].shape)
                ).astype(p[k].dtype)
    x = rng.normal(size=(2, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, p, {k: _t(v) for k, v in p.items()}, \
        jnp.asarray(x, jnp.dtype(dt))


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("S", [512, 37, 1])
def test_mlstm_mix_matches_jax(S, dt):
    """Chunked (two chunks of 256), whole-sequence and single-step, from
    the initial state and from a live one."""
    jcfg, tcfg, p, tp, x = _mlstm_inputs(S, dt)
    di = int(jcfg.d_model * jcfg.mlstm_proj_factor)
    rng = np.random.default_rng(1)
    xs = jnp.asarray(rng.normal(size=(2, S, di)), jnp.dtype(dt))
    live = {"C": rng.normal(0, 0.3, (2, 4, di // 4, di // 4)),
            "n": rng.normal(0, 0.3, (2, 4, di // 4)),
            "m": rng.normal(0, 1.0, (2, 4))}
    for state in (jx.init_mlstm_state(jcfg, 2),
                  {k: jnp.asarray(v, jnp.float32) for k, v in live.items()}):
        want_y, want_st = jx.mlstm_mix(jax.tree.map(jnp.asarray, p), x, xs,
                                       state)
        y, st = tx.mlstm_mix(tp, _t(x), _t(xs),
                             {k: _t(v) for k, v in state.items()})
        assert y.dtype == _t(xs).dtype
        _held(y, want_y, dt)
        for k in want_st:
            _held(st[k], want_st[k], dt)


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_blocks_match_jax(kind, dt):
    """The residual blocks on the same inputs: forward (no state) and two
    decode steps carrying the state."""
    jcfg, tcfg, p, tp, x = _mlstm_inputs(24, dt, seed=2)
    if kind == "slstm":
        p = jax.tree.map(np.asarray, jx.init_slstm_params(
            jax.random.key(3), jcfg, jnp.dtype(dt)))
        rng = np.random.default_rng(3)
        for k in ("ln", "ln2", "b_gates"):
            p[k] = (p[k].astype(np.float32) + 0.3 * rng.normal(
                size=p[k].shape)).astype(p[k].dtype)
        tp = {k: _t(v) for k, v in p.items()}
    jblock = jx.mlstm_block if kind == "mlstm" else jx.slstm_block
    tblock = tx.mlstm_block if kind == "mlstm" else tx.slstm_block
    jinit = jx.init_mlstm_state if kind == "mlstm" else jx.init_slstm_state
    jp = jax.tree.map(jnp.asarray, p)
    want, none = jblock(jcfg, jp, x, None, None)
    got, tnone = tblock(tcfg, tp, _t(x))
    assert none is None and tnone is None
    _held(got, want, dt)
    jst = jinit(jcfg, 2)
    tst = {k: _t(v) for k, v in jst.items()}
    for t in range(2):
        want, jst = jblock(jcfg, jp, x[:, t:t + 1], jst, None)
        got, tst = tblock(tcfg, tp, _t(x[:, t:t + 1]), tst)
        _held(got, want, dt)
        for k in jst:
            assert tst[k].dtype == torch.float32
            _held(tst[k], jst[k], dt)


def test_xlstm_lm_matches_jax_float32():
    """Forward, prefill (which emits no recurrent state, as the JAX
    prefill) and three decode steps of the whole reduced model, chained,
    in float32 within CHAIN_TOL; the decode state in the JAX layout."""
    jm, jp, tm, tp = _worlds(ARCH, F32)
    toks = _tokens(1, 2, 24)
    np.testing.assert_allclose(
        _np(tm.forward(tp, {"tokens": torch.from_numpy(toks)})),
        _np(jm.forward(jp, {"tokens": jnp.asarray(toks)})), **CHAIN_TOL)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), **CHAIN_TOL)
    assert jcache == {} and tcache == {}
    jstate = jm.init_decode_state(2, 30)
    tstate = tm.init_decode_state(2, 30)
    assert jax.tree.structure(jstate) == jax.tree.structure(
        jax.tree.map(np.asarray, tstate, is_leaf=torch.is_tensor))
    for t in range(3):
        jl, jstate = jm.decode(jp, jstate, {
            "tokens": jnp.asarray(toks[:, t:t + 1]), "pos": jnp.int32(t)})
        tl, tstate = tm.decode(tp, tstate, {
            "tokens": torch.from_numpy(toks[:, t:t + 1]), "pos": t})
        np.testing.assert_allclose(_np(tl), _np(jl), **CHAIN_TOL)
    for b in jstate:
        for k in jstate[b]:
            assert tuple(tstate[b][k].shape) == jstate[b][k].shape
            np.testing.assert_allclose(_np(tstate[b][k]), _np(jstate[b][k]),
                                       **CHAIN_TOL)


def test_xlstm_chain_tolerance_is_the_models_own():
    """CHAIN_TOL's reason: the JAX model against itself, its embedding
    table moved by one float32 step, moves its float32 logits by more than
    1e-5 (3.6e-5 on these inputs), and less than CHAIN_TOL."""
    jm, jp, _, _ = _worlds(ARCH, F32)
    toks = jnp.asarray(_tokens(1, 2, 24))
    base = _np(jm.forward(jp, {"tokens": toks}))
    moved = dict(jp, embed={"table": jnp.nextafter(jp["embed"]["table"],
                                                   jnp.inf)})
    gap = float(np.abs(_np(jm.forward(moved, {"tokens": toks})) - base).max())
    assert 1e-5 < gap < CHAIN_TOL["atol"], gap


@pytest.mark.parametrize("dt", [F32, BF16])
def test_xlstm_lm_layerwise_matches_jax(dt):
    assert layerwise_matches_jax(ARCH, dt, _tokens(4, 2, 24)) == 0.0


def _scan_inputs(B, S=9, nh=4, dh=16, seed=0):
    """wx, r and a state the scan can reach (the plain scan's after 5
    steps from the initial state; see the sLSTM gauge)."""
    rng = np.random.default_rng(seed)
    d = nh * dh
    wx = torch.from_numpy(rng.normal(0, 0.5, (B, S, 4 * d)).astype(np.float32))
    r = torch.from_numpy((rng.normal(size=(nh, dh, 4 * dh))
                          * dh ** -0.5).astype(np.float32))
    st = [torch.zeros(B, d) for _ in range(3)] + [torch.full((B, d), -1e30)]
    warm = torch.from_numpy(rng.normal(0, 0.5, (B, 5, 4 * d)).astype(
        np.float32))
    return wx, r, list(ts.slstm_scan_torch(warm, r, *st)[1])


@pytest.mark.parametrize("dtype,B,dh,want", [
    (torch.bfloat16, 8, 512, "cluster"),   # xlstm-1.3b: 16 blocks a head
    (torch.bfloat16, 1, 64, "cluster"),
    (torch.bfloat16, 16, 128, "cluster"),
    (torch.bfloat16, 33, 256, "cluster"),  # rows past 16: a grid row more
    (torch.float32, 8, 512, "grid"),       # float32 r is not exact in bf16
    (torch.bfloat16, 8, 16, "grid"),       # the reduced xlstm's heads
    (torch.bfloat16, 2, 12, "grid"),
    (torch.bfloat16, 8, 32, "grid"),       # a quarter of K under one k16
    (torch.bfloat16, 8, 96, "grid"),       # not whole k16 steps a quarter
    (torch.bfloat16, 8, 1024, "grid"),     # 32 blocks: past a cluster
    (torch.float16, 8, 512, "grid"),
])
def test_slstm_scan_form(dtype, B, dh, want):
    """The form is a function of the shape: the cluster form for bfloat16
    heads of a multiple of 64 up to 512 dimensions, the grid form else."""
    assert ts.form(dtype, B, 4, dh) == want


def test_split_pieces_sum_back():
    """h's bfloat16 pieces: each a bfloat16 value; three sum back to a
    float32 h exactly, two leave under 2^-16 of |h| (the cluster form's
    ``PIECES``); over magnitudes from 1e-24 to 1e24 (the scan's h lies in
    [-1, 1]; below about 2^-110 a third piece would fall under bfloat16's
    normal range)."""
    rng = np.random.default_rng(7)
    h = torch.from_numpy((rng.choice([-1.0, 1.0], 200_000)
                          * rng.uniform(1, 2, 200_000)
                          * np.exp(rng.uniform(-55, 55, 200_000)))
                         .astype(np.float32))
    h = torch.cat([h, torch.tensor([0.0, -1.0, 1.0, 1e-20, -0.75])])
    for n in (2, 3):
        pieces = ts.split_pieces(h, n)
        assert len(pieces) == n
        for piece in pieces:
            assert torch.equal(piece.to(torch.bfloat16).float(), piece)
        total = sum(piece.double() for piece in pieces)
        if n == 3:
            assert torch.equal(total, h.double())
        else:
            assert ((total - h.double()).abs()
                    <= 2.0 ** -16 * h.double().abs()).all()
    assert ts.PIECES == 2


@pytest.mark.parametrize("B,S,block_t", [(2, 32, 8), (1, 64, 16), (3, 16, 16),
                                         (2, 1, 1), (2, 37, 37)])
def test_slstm_cluster_mirror_matches_jax(B, S, block_t):
    """The cluster form's arithmetic (``slstm_cluster_torch``: h in
    bfloat16 pieces, products in float32, summed in the kernel's order)
    against the Pallas kernel in interpret mode and the plain version on
    the same inputs, bfloat16 weights, from a live state: within
    ``KERNEL_TOL``, the tolerance the kernel is held to on the card."""
    cfg = jax_reduced(JAX_REGISTRY[ARCH])
    rng = np.random.default_rng(S + 100)
    nh, d = cfg.n_heads, cfg.d_model
    dh = d // nh
    r16 = torch.from_numpy(rng.normal(0, 0.3, (nh, dh, 4 * dh)).astype(
        np.float32)).bfloat16()
    wx = rng.normal(0, 0.5, (B, S, 4 * d)).astype(np.float32)
    state = {k: rng.normal(0, 0.5, (B, d)).astype(np.float32)
             for k in ("h", "c", "nn")}
    state["mm"] = np.full((B, d), -1e30, np.float32)
    args = [torch.from_numpy(wx), r16] + [torch.from_numpy(state[k]) for k
                                          in ("h", "c", "nn", "mm")]
    y, carry = ts.slstm_cluster_torch(*args)
    p_y, p_carry = pallas_slstm(
        jnp.asarray(wx), jax_expand(jnp.asarray(_np(r16.float()))),
        *(jnp.asarray(state[k]) for k in ("h", "c", "nn", "mm")), nh=nh,
        block_t=block_t, interpret=True)
    want_y, want_carry = ts.slstm_scan_torch(*args)
    for want, wcarry in ((want_y, want_carry), (p_y, p_carry)):
        np.testing.assert_allclose(_np(y), _np(want), **ts.KERNEL_TOL)
        for got, w in zip(carry, wcarry):
            np.testing.assert_allclose(_np(got), _np(w), **ts.KERNEL_TOL)


@pytest.mark.parametrize("B,S,nh,dh", [(2, 24, 4, 16), (3, 17, 2, 64),
                                       (9, 6, 1, 128), (1, 5, 4, 512)])
def test_slstm_cluster_mirror_on_reduced_xlstm(B, S, nh, dh):
    """The mirror on the reduced xlstm's sLSTM layer (its initial weights,
    bfloat16, and its state's initial value, then a live one) and on heads
    wide enough for the K quarters (64 up to xlstm-1.3b's 512): within
    ``KERNEL_TOL`` of the plain version."""
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)),
                              d_model=nh * dh, n_heads=nh)
    g = torch.Generator().manual_seed(B * S + dh)
    p = tx.init_slstm_params(cfg, torch.bfloat16, g, "cpu")
    x = torch.randn(B, S, cfg.d_model, generator=g).bfloat16()
    wx = x @ p["w_gates"] + p["b_gates"]
    st = tx.init_slstm_state(cfg, B, "cpu")
    state = [st[k] for k in ("h", "c", "nn", "mm")]
    for _ in range(2):
        y, carry = ts.slstm_cluster_torch(wx, p["r_gates"], *state)
        want_y, want_carry = ts.slstm_scan_torch(wx, p["r_gates"], *state)
        for got, want in zip((y, *carry), (want_y, *want_carry)):
            torch.testing.assert_close(got, want, **ts.KERNEL_TOL)
        state = list(want_carry)


@pytest.mark.parametrize("B", [17, 33])
def test_slstm_scan_batches_run_in_launches_of_max_batch(B, monkeypatch):
    """A batch over MAX_BATCH rows runs as launches of MAX_BATCH rows, each
    on its own slices of wx and the state: with each launch replaced by the
    plain version, the result equals one plain call over the batch, up to
    float32 rounding of the recurrent product (the CPU's batched einsum
    blocks its sums by the batch's size: 6e-8 apart on these inputs)."""
    calls = []

    def rows(wx, r, h, c, n, m):
        calls.append(wx.shape[0])
        return ts.slstm_scan_torch(wx, r, h, c, n, m)

    monkeypatch.setattr(ts, "_launch_rows", rows)
    wx, r, state = _scan_inputs(B)
    y, carry = ts._launch(wx, r, *state)
    want_y, want_carry = ts.slstm_scan_torch(wx, r, *state)
    assert calls == [ts.MAX_BATCH] * (B // ts.MAX_BATCH) + [B % ts.MAX_BATCH]
    for got, want in zip((y, *carry), (want_y, *want_carry)):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_slstm_scan_kernel_has_no_backward(monkeypatch):
    """The kernel's launch sits in an autograd.Function whose backward is
    the ``slstm_scan_bwd`` op over the states the forward saved (the plain
    versions on the CPU stand in for the launches): its gradient equals
    the plain version's own (tests/test_torch_slstm_bwd.py holds the
    gradient at its hard shapes)."""
    def rows(wx, r, h, c, n, m, states=None):
        y, carry, st = ts.slstm_states_torch(wx, r, h, c, n, m)
        if states is not None:
            states.copy_(st)
        return y, carry
    monkeypatch.setattr(ts, "_launch_rows", rows)
    wx, r, state = _scan_inputs(3)
    wx.requires_grad_()
    y, *carry = ts._KernelScan.apply(wx, r, *state)
    assert y.requires_grad
    (y.sum() + carry[1].sum()).backward()
    got = wx.grad.clone()
    wx.grad = None
    # the plain version on the CPU differentiates
    y, carry = ts.slstm_scan(wx, r, *state)
    (y.sum() + carry[1].sum()).backward()
    assert torch.isfinite(wx.grad).all() and wx.grad.abs().sum() > 0
    torch.testing.assert_close(got, wx.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed,B,S", [(0, 1, 64), (1, 2, 64), (3, 2, 48)])
def test_xlstm_bfloat16_prefill_decode_gap_is_the_models_own(seed, B, S):
    """The reduced xlstm in bfloat16: the last prompt token's logits from
    the prefill against those of S decode steps from the initial state.
    The JAX model (jitted) and the port, on the same weights and tokens,
    sit apart by about as much; the port by no more than the JAX model
    plus one bfloat16 step of the logits' magnitude (0.0547 and 0.0547,
    0.0703 and 0.0469, 0.2305 and 0.0859 on these inputs)."""
    jm, jp, tm, tp = _worlds(ARCH, BF16, seed=seed)
    toks = _tokens(seed + 10, B, S)
    jl, _ = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    jstate = jm.init_decode_state(B, S)
    tstate = tm.init_decode_state(B, S)
    decode = jax.jit(jm.decode)
    for t in range(S):
        jd, jstate = decode(jp, jstate, {
            "tokens": jnp.asarray(toks[:, t:t + 1]), "pos": jnp.int32(t)})
        td, tstate = tm.decode(tp, tstate, {
            "tokens": torch.from_numpy(toks[:, t:t + 1]), "pos": t})
    jgap = float(np.abs(_np(jd).astype(np.float32)
                        - _np(jl).astype(np.float32)).max())
    tgap = float(np.abs(_np(td).astype(np.float32)
                        - _np(tl).astype(np.float32)).max())
    top = float(np.abs(_np(jl).astype(np.float32)).max())
    step = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert tgap <= jgap + step, (tgap, jgap, step)
