"""whisper's encoder-decoder in the port (``models.encdec``, the ``Model``
facade's ``enc_dec`` branch) and the cross attention it brings
(``flash_attention`` with Sq != Skv) on the CPU against the JAX package.

The JAX parameters are carried across (``encdec.params_from_numpy``),
every norm scale perturbed so that each matters.  On the CPU the
attention is the plain version (``flash_attention_torch``,
``flash_attention_bwd_torch``); the kernels' Sq / Skv launch arguments
are checked with the launch recorded, not run (no card here).

Tolerances:

  * attention alone: float32 rtol 1e-5 / atol 1e-5 (another summation
    order over up to 1,500 keys); bfloat16 ``KERNEL_TOL`` (rtol 2^-7,
    atol 1e-4: both sides sum in float32 and round once, and may
    straddle one rounding point).  Its gradient: float32 rtol 1e-4 plus
    1e-5 of the largest of the three gradients (``BWD_TOL``); bfloat16
    rtol 2^-7 plus 2^-7 of the largest, the plain backward taking D from
    the rounded output as the kernel does (JAX's from float32).
  * the model (two encoder and two decoder layers): float32 rtol 1e-5 /
    atol 1e-5 on logits, the loss within 1e-5; gradients rtol 1e-4 plus
    1e-3 of each leaf's largest value; bfloat16 rtol 2e-2 / atol 6e-2 on
    logits (a few bfloat16 steps: the frameworks round products and
    elementwise ops at other places, and four layers compound it), the
    loss within 1e-2, each gradient leaf within 5e-2 of its norm (L2).
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced
from repro.models import attention as jax_attn
from repro.models import encdec as jax_ed
from repro.models.model import build_model as jax_build
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve_model, train
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import attention as t_attn
from repro_torch.models import encdec
from repro_torch.models import transformer as tt
from repro_torch.models.model import Model, build_model

torch.set_num_threads(1)

F32, BF16 = "float32", "bfloat16"
ARCH = "whisper-medium"
NORMS = ("ln", "ln2", "ln_x", "final_norm", "enc_final_norm")


def _tol(dt):
    return dict(rtol=2e-2, atol=6e-2) if dt == BF16 \
        else dict(rtol=1e-5, atol=1e-5)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dt) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dt))


def _j(a, dt):
    return jnp.asarray(np.asarray(a, np.float32), jnp.dtype(dt))


def _worlds(dt, seed=0, **cut):
    """(JAX model, JAX params, port model, port params) of the reduced
    whisper in ``dt`` (with ``cut``'s fields replaced), the port's weights
    carried across from the JAX ones, the norm scales perturbed."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(ARCH)), dtype=dt,
                               **cut)
    tcfg = dataclasses.replace(reduced_config(get_config(ARCH)), dtype=dt,
                               **cut)
    jm = jax_build(jcfg)
    g = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key in NORMS:
            a = (a.astype(np.float32)
                 + 0.2 * g.normal(size=a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(
        perturb, jm.init_params(jax.random.key(seed)))
    tm = build_model(tcfg, "cpu")
    return jm, jax.tree.map(jnp.asarray, tree), tm, \
        encdec.params_from_numpy(tcfg, tree, device="cpu")


def _batch(cfg, seed, S=12, B=2):
    g = np.random.default_rng(seed)
    toks = g.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"audio_embeds": g.normal(size=(B, cfg.enc_seq, cfg.d_model))
            .astype(np.float32),
            "tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _tb(batch, dt):
    return {k: _t(v, dt) if k == "audio_embeds" else torch.from_numpy(v)
            for k, v in batch.items()}


def _jb(batch, dt):
    return {k: _j(v, dt) if k == "audio_embeds" else jnp.asarray(v)
            for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The attention at Sq != Skv: the plain versions against the core of JAX's
# cross_attention_block
# ---------------------------------------------------------------------------
H, HKV, DH = 4, 2, 16
ATTN_CFG = types.SimpleNamespace(n_heads=H, head_dim=DH, q_dim=H * DH,
                                 d_model=H * DH)


def _jax_core(dt):
    """JAX's cross_attention_block with identity projections: q (B, Sq,
    H·dh) as the block's input, k and v (B, Skv, Hkv, dh) as the encoder's
    keys and values (the identities are exact in either dtype)."""
    eye = jnp.eye(H * DH, dtype=jnp.dtype(dt))
    return lambda x, k, v: jax_attn.cross_attention_block(
        ATTN_CFG, {"wq": eye, "wo": eye}, x, k, v)


def _attn_case(Sq, Skv, seed, B=2):
    g = np.random.default_rng(seed)
    return [g.normal(size=(B, s, n, DH)).astype(np.float32)
            for s, n in ((Sq, H), (Skv, HKV), (Skv, HKV), (Sq, H))]


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("Skv", [1, 16, 129, 1500])
@pytest.mark.parametrize("Sq", [1, 7, 16, 300])
def test_cross_attention_matches_jax(Sq, Skv, dt):
    """flash_attention_torch at (Sq, Skv), not causal, against JAX's
    cross attention, and flash_attention_bwd_torch against jax.vjp of it
    (tolerances in the module docstring)."""
    q, k, v, do = _attn_case(Sq, Skv, Sq * 7 + Skv)
    B = q.shape[0]
    core = _jax_core(dt)
    jo, vjp = jax.vjp(core, _j(q.reshape(B, Sq, H * DH), dt), _j(k, dt),
                      _j(v, dt))
    jdq, jdk, jdv = vjp(_j(do.reshape(B, Sq, H * DH), dt))
    tq, tk, tv, tdo = (_t(a, dt) for a in (q, k, v, do))
    to = fa.flash_attention_torch(tq, tk, tv, causal=False)
    assert to.dtype == tq.dtype and to.shape == tq.shape
    tol = fa.KERNEL_TOL[torch.bfloat16] if dt == BF16 \
        else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(to).reshape(B, Sq, H * DH), _np(jo),
                               **tol)
    got = fa.flash_attention_bwd_torch(tq, tk, tv, to, None, tdo, False)
    want = [_np(jdq).reshape(B, Sq, H, DH), _np(jdk), _np(jdv)]
    top = max(float(np.abs(w).max()) for w in want)
    rtol, of_top = (2 ** -7, 2 ** -7) if dt == BF16 else (1e-4, 1e-5)
    for a, w in zip(got, want):
        assert a.dtype == tq.dtype and tuple(a.shape) == w.shape
        np.testing.assert_allclose(_np(a), w, rtol=rtol, atol=of_top * top)


def test_causal_with_sq_ne_skv_raises(monkeypatch):
    """A causal call with Sq != Skv raises in every entry (no mask is
    made up for it), and before any launch; Sq == Skv stays causal."""
    q, k, v, do = (torch.from_numpy(a) for a in _attn_case(3, 5, 0))
    for call in (lambda: fa.flash_attention(q, k, v, causal=True),
                 lambda: fa.flash_attention_torch(q, k, v, True),
                 lambda: fa.flash_attention_bwd_torch(q, k, v, q, None, do,
                                                      True),
                 lambda: fa.flash_attention_bwd(q, k, v, q, None, do, True)):
        with pytest.raises(ValueError, match="Sq == Skv"):
            call()
    calls = []
    monkeypatch.setattr(fa, "check_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(fa._build, "launch",
                        lambda name, dev, *args: calls.append(name))
    lse = torch.zeros(2, H, 3)
    with pytest.raises(ValueError, match="Sq == Skv"):
        fa._launch(q, k, v, True)
    with pytest.raises(ValueError, match="Sq == Skv"):
        fa._launch_bwd(q, k, v, q, lse, do, True)
    assert calls == []
    # k, v of another batch or width still raise as before
    with pytest.raises(ValueError, match="Skv"):
        fa.flash_attention(q, k[:1], v[:1], causal=False)


@pytest.mark.parametrize("dtype,dh", [(torch.bfloat16, 64),
                                      (torch.float32, 16)])
def test_launchers_take_sq_and_skv(monkeypatch, dtype, dh):
    """The forward and backward launchers get Sq and Skv (the launch
    recorded, not run): the forward's logsumexp (B, H, Sq), the
    backward's scratch (2, B, H, bwd_rows(Sq)), dk and dv at Skv, and each
    launch counted in its form and its kind (``cross``)."""
    calls = []
    monkeypatch.setattr(fa, "check_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(fa._build, "launch",
                        lambda name, dev, *args: calls.append((name, args)))
    for wrapper in (fa.flash_attention, fa.flash_attention_bwd):
        monkeypatch.setattr(wrapper, "form_launches", {})
        monkeypatch.setattr(wrapper, "kind_launches", {})
    B, Sq, Skv = 2, 7, 129
    q, o, do = (torch.zeros(B, Sq, H, dh, dtype=dtype) for _ in range(3))
    k, v = (torch.zeros(B, Skv, HKV, dh, dtype=dtype) for _ in range(2))
    out, lse = fa._launch(q, k, v, False, lse=True)
    assert out.shape == q.shape and lse.shape == (B, H, Sq)
    dq, dk, dv = fa._launch_bwd(q, k, v, o, lse, do, False)
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    (fwd, fargs), (bwd, bargs) = calls
    chosen = fa.form(dtype, dh)
    # (q, k, v, B, Sq, Skv, H, Hkv, dh, scale, causal, dtype, form, out,
    # lse)
    assert fwd == "attn_flash_attention"
    assert fargs[3:9] == (B, Sq, Skv, H, HKV, dh) and fargs[10] == 0
    assert fargs[12] == fa.FORMS[chosen]
    # (q, k, v, o, dO, lse, B, Sq, Skv, H, Hkv, dh, scale, causal, dtype,
    # form, rows, dq, dk, dv)
    assert bwd == "attn_flash_attention_bwd"
    assert bargs[6:12] == (B, Sq, Skv, H, HKV, dh) and bargs[13] == 0
    assert bargs[15] == fa.FORMS[chosen]
    for wrapper in (fa.flash_attention, fa.flash_attention_bwd):
        assert wrapper.form_launches == {chosen: 1}
        assert wrapper.kind_launches == {"cross": 1}
    assert [fa.kind(7, 7, True), fa.kind(7, 7, False),
            fa.kind(1, 7, False)] == ["causal", "square", "cross"]
    assert fa.bwd_rows(Sq, chosen) == (128 if chosen == "wgmma" else Sq)


@pytest.mark.parametrize("what,shape,causal,bwd,want_ms", [
    ("cross attention at the serving prefill", (8, 4096, 1500), False,
     False, 0.204),
    ("the encoder's attention", (8, 1500, 1500), False, False, 0.075),
    ("the decoder's self attention", (8, 4096, 4096), True, False, 0.278),
    ("cross attention's backward at training", (4, 4096, 1500), False,
     True, 0.254)])
def test_bounds_at_whisper_medium(what, shape, causal, bwd, want_ms):
    """The registered costs count 4·B·H·Sq·Skv·dh (10· for the
    backward), halved only when causal, so the bounds at whisper-medium's
    shapes (16 heads of 64, bfloat16) over 989 TFLOP/s are the
    operations'; from meta tensors."""
    B, Sq, Skv = shape
    m = dict(dtype=torch.bfloat16, device="meta")
    q = torch.empty(B, Sq, 16, 64, **m)
    k = torch.empty(B, Skv, 16, 64, **m)
    args = (q, k, k, q, torch.empty(B, 16, Sq, device="meta"), q, causal) \
        if bwd else (q, k, k, causal)
    b = chip_smoke.cost_bound("flash_attention_bwd" if bwd
                              else "flash_attention", *args)
    assert b["bound_by"] == "operations", what
    assert round(b["bound_ms"], 3) == want_ms, (what, b["bound_ms"])
    flops, n_bytes = (fa.flash_attention_bwd_cost if bwd
                      else fa.flash_attention_cost)(*args)
    assert flops == (10 if bwd else 4) * B * 16 * Sq * Skv * 64 / (
        2 if causal else 1)
    per = (4 if bwd else 2) * 2 * 16 * 64
    assert n_bytes == per * B * (Sq + Skv) + (4 * B * 16 * Sq if bwd else 0)


# ---------------------------------------------------------------------------
# The attention blocks and the model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dt", [F32, BF16])
def test_attention_blocks_match_jax(dt):
    """cross_attention_block, encode_cross_kv and bidir_attention_block
    against JAX's on one layer's weights of the reduced whisper."""
    jm, jp, tm, tp = _worlds(dt)
    cfg = tm.cfg
    g = np.random.default_rng(3)
    x = g.normal(size=(2, 9, cfg.d_model))
    enc = g.normal(size=(2, cfg.enc_seq, cfg.d_model))
    jblk = jax.tree.map(lambda a: a[1], jp["periods"]["b0"])
    tblk = tp.blocks[1]
    tol = _tol(dt)
    jk, jv = jax_attn.encode_cross_kv(jm.cfg, jblk["xattn"], _j(enc, dt))
    tk, tv = t_attn.encode_cross_kv(cfg, tblk.xattn, _t(enc, dt))
    for a, b in ((tk, jk), (tv, jv)):
        assert tuple(a.shape) == b.shape == (2, cfg.enc_seq, cfg.n_kv_heads,
                                             cfg.head_dim)
        np.testing.assert_allclose(_np(a), _np(b), **tol)
    np.testing.assert_allclose(
        _np(t_attn.cross_attention_block(cfg, tblk.xattn, _t(x, dt), tk,
                                         tv)),
        _np(jax_attn.cross_attention_block(jm.cfg, jblk["xattn"],
                                           _j(x, dt), jk, jv)), **tol)
    eblk = jax.tree.map(lambda a: a[0], jp["enc_periods"]["b0"])
    np.testing.assert_allclose(
        _np(t_attn.bidir_attention_block(cfg, tp.enc_blocks[0].attn,
                                         _t(enc, dt))),
        _np(jax_attn.bidir_attention_block(jm.cfg, eblk["attn"],
                                           _j(enc, dt))), **tol)


@pytest.mark.parametrize("dt", [F32, BF16])
def test_encode_forward_loss_match_jax(dt):
    jm, jp, tm, tp = _worlds(dt)
    batch = _batch(tm.cfg, 1)
    tol = _tol(dt)
    np.testing.assert_allclose(
        _np(encdec.encode(tm.cfg, tp, _t(batch["audio_embeds"], dt))),
        _np(jax_ed.encode(jm.cfg, jp, _j(batch["audio_embeds"], dt))), **tol)
    tlog = tm.forward(tp, _tb(batch, dt))
    jlog = jm.forward(jp, _jb(batch, dt))
    assert tuple(tlog.shape) == jlog.shape == (2, 12, tm.cfg.vocab_size)
    assert tlog.dtype == getattr(torch, dt)
    np.testing.assert_allclose(_np(tlog), _np(jlog), **tol)
    tl, jl = float(tm.loss(tp, _tb(batch, dt))), float(
        jm.loss(jp, _jb(batch, dt)))
    assert abs(tl - jl) <= (1e-2 if dt == BF16 else 1e-5) * abs(jl)


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v, np.float32))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


@pytest.mark.parametrize("dt", [F32, BF16])
def test_grads_match_jax(dt):
    """value_and_grad of the port's loss against jax.value_and_grad, leaf
    by leaf in the JAX layout (``flat_to_numpy``), ``wi_up``'s zero
    gradients included."""
    jm, jp, tm, tp = _worlds(dt)
    batch = _batch(tm.cfg, 2)
    jloss, jgrads = jax.value_and_grad(
        lambda p: jm.loss(p, _jb(batch, dt)))(jp)
    flat = tm.train_params(tp)
    loss, grads = value_and_grad(tm, flat, _tb(batch, dt))
    assert sorted(grads) == sorted(flat)
    assert all(grads[k].dtype == flat[k].dtype for k in flat)
    assert abs(float(loss) - float(jloss)) <= \
        (1e-2 if dt == BF16 else 1e-5) * abs(float(jloss))
    got, want = _leaves(encdec.flat_to_numpy(tm.cfg, grads)), _leaves(jgrads)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        if "wi_up" in path:
            assert not g.any() and not w.any(), path
        elif dt == F32:
            np.testing.assert_allclose(
                g, w, rtol=1e-4, atol=1e-3 * float(np.abs(w).max()),
                err_msg=path)
        else:
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= 5e-2, (path, err)


def test_remat_policies_give_equal_results():
    """remat none / dots / full: the same loss and gradients, bit for
    bit, on the decoder layers (the encoder is never checkpointed)."""
    _, _, tm, tp = _worlds(F32)
    batch = _tb(_batch(tm.cfg, 4), F32)
    flat = tm.train_params(tp)
    out = {r: value_and_grad(tm, flat, batch, r)
           for r in ("none", "dots", "full")}
    for r in ("dots", "full"):
        assert torch.equal(out[r][0], out["none"][0])
        for k in flat:
            assert torch.equal(out[r][1][k], out["none"][1][k]), (r, k)


@pytest.mark.parametrize("enc_dec, unread, raises", [
    (True, ["blocks.0.wi_up", "enc_blocks.1.wi_up"], False),
    (True, ["blocks.0.wi_up", "blocks.0.w_down"], True),
    (False, ["blocks.0.wi_up"], True)])
def test_value_and_grad_zeroes_only_the_unread_weights(enc_dec, unread,
                                                      raises):
    """A weight the loss does not reach gets a zero gradient only where
    it is an encoder-decoder's ``wi_up`` (``encdec.unread``); any other
    raises, naming it."""
    class Stub:
        cfg = types.SimpleNamespace(enc_dec=enc_dec)

        def loss(self, leaves, batch, remat):
            return sum(p.sum() for k, p in leaves.items()
                       if k not in unread)

    params = {k: torch.ones(3) for k in ["embed", *unread]}
    if raises:
        with pytest.raises(RuntimeError, match="does not reach"):
            value_and_grad(Stub(), params, {})
        return
    loss, grads = value_and_grad(Stub(), params, {})
    assert float(loss) == 3.0 and torch.equal(grads["embed"], torch.ones(3))
    assert all(torch.equal(grads[k], torch.zeros(3)) for k in unread)


def test_encode_takes_frames_in_the_models_dtype():
    """The port runs the encoder in the weights' dtype and refuses frames
    of another (the JAX package would promote a bfloat16 encoder to
    float32 frames); frames in the model's dtype are JAX's encode."""
    jm, jp, tm, tp = _worlds(BF16)
    batch = _batch(tm.cfg, 9)
    with pytest.raises(TypeError, match="model's dtype"):
        encdec.encode(tm.cfg, tp, torch.from_numpy(batch["audio_embeds"]))
    np.testing.assert_allclose(
        _np(encdec.encode(tm.cfg, tp, _t(batch["audio_embeds"], BF16))),
        _np(jax_ed.encode(jm.cfg, jp, _j(batch["audio_embeds"], BF16))),
        **_tol(BF16))


@pytest.mark.parametrize("dt", [F32, BF16])
def test_prefill_is_the_forwards_last_logits(dt):
    """Model.prefill returns (forward(...)[:, -1], None), as the JAX
    facade does, and equals JAX's prefill."""
    jm, jp, tm, tp = _worlds(dt)
    batch = _tb(_batch(tm.cfg, 5), dt)
    del batch["labels"]
    logits, state = tm.prefill(tp, batch)
    assert state is None
    assert torch.equal(logits, tm.forward(tp, batch, remat="none")[:, -1])
    jl, jstate = jm.prefill(jp, _jb({k: v.float().numpy()
                                     if k == "audio_embeds" else v.numpy()
                                     for k, v in batch.items()}, dt))
    assert jstate is None
    np.testing.assert_allclose(_np(logits), _np(jl), **_tol(dt))


@pytest.mark.parametrize("dt", [F32, BF16])
def test_decode_step_matches_jax(dt):
    """Four decode steps on a state whose ek / ev JAX filled (encode and
    encode_cross_kv a layer), copied into the port's state: logits and
    the written caches against JAX's."""
    jm, jp, tm, tp = _worlds(dt)
    cfg = tm.cfg
    batch = _batch(cfg, 6, S=4)
    enc = jax_ed.encode(jm.cfg, jp, _j(batch["audio_embeds"], dt))
    jstate = jm.init_decode_state(2, 8)
    for layer in range(cfg.n_layers):
        blk = jax.tree.map(lambda a: a[layer], jp["periods"]["b0"])
        ek, ev = jax_attn.encode_cross_kv(jm.cfg, blk["xattn"], enc)
        jstate["ek"] = jstate["ek"].at[layer].set(ek)
        jstate["ev"] = jstate["ev"].at[layer].set(ev)
    tstate = tm.init_decode_state(2, 8)
    assert sorted(tstate) == sorted(jstate)
    for name in jstate:
        assert tuple(tstate[name].shape) == jstate[name].shape
        assert tstate[name].dtype == getattr(torch, dt)
    for name in ("ek", "ev"):
        tstate[name].copy_(_t(_np(jstate[name]), dt))
    tol = _tol(dt)
    for t in range(4):
        tok = batch["tokens"][:, t:t + 1]
        jl, jstate = jm.decode(jp, jstate, {"tokens": jnp.asarray(tok),
                                            "pos": jnp.int32(t)})
        tl, tstate = tm.decode(tp, tstate, {"tokens": torch.from_numpy(tok),
                                            "pos": t})
        assert tuple(tl.shape) == (2, cfg.vocab_size)
        np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tstate[name]), _np(jstate[name]),
                                   **tol)


def test_decode_equals_the_forward_token_by_token():
    """In float32, decoding token by token from a state filled by encode
    and encode_cross_kv gives the one-shot forward's logits at each
    position."""
    _, _, tm, tp = _worlds(F32)
    cfg = tm.cfg
    batch = _tb(_batch(cfg, 7, S=6), F32)
    want = tm.forward(tp, batch)
    state = chip_smoke.whisper_cross_state(tm, tp,
                                           tm.init_decode_state(2, 6),
                                           batch["audio_embeds"])
    for t in range(6):
        got, state = tm.decode(tp, state, {"tokens": batch["tokens"][:, t:t
                                                                     + 1],
                                           "pos": t})
        torch.testing.assert_close(got, want[:, t], rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The facade, the layouts
# ---------------------------------------------------------------------------
def test_params_round_trip_and_groups():
    """params_to_numpy gives the JAX tree back; param_groups names each
    flat key's JAX leaf and layer; a tree of another config is refused."""
    jm, jp, tm, tp = _worlds(F32)
    back = encdec.params_to_numpy(tp)
    want = _leaves(jp)
    got = _leaves(back)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=path)
    groups = tm.param_groups(tm.train_params(tp))
    assert groups["blocks.1.xattn.wq"] == ("periods.b0.xattn.wq", 1)
    assert groups["enc_blocks.0.ln2"] == ("enc_periods.b0.ln2", 0)
    assert groups["embed"] == ("embed.table", None)
    assert groups["dec_pos"] == ("dec_pos", None)
    tree = jax.tree.map(np.asarray, jp)
    del tree["periods"]["b0"]["wi_up"]
    with pytest.raises(ValueError, match="wi_up"):
        encdec.params_from_numpy(tm.cfg, tree, device="cpu")


def test_whisper_builds_and_the_decoder_lm_refuses_it():
    cfg = reduced_config(get_config(ARCH))
    model = build_model(cfg, "cpu")
    assert isinstance(model, Model) and model.cfg is cfg
    params = model.init_params(0)
    assert isinstance(params, encdec.EncDecLM)
    assert len(params.enc_blocks) == cfg.n_enc_layers
    assert len(params.blocks) == cfg.n_layers
    assert params.dec_pos.shape == (encdec.DEC_POSITIONS, cfg.d_model)
    assert not any(p.requires_grad for p in params.parameters())
    with pytest.raises(ValueError, match="encdec"):
        tt.TransformerLM(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="tokens"):
        tt.check_supported(dataclasses.replace(cfg, input_mode="tokens"))
    # whisper-medium's full size, counted from the config alone
    full = get_config(ARCH)
    assert 1.0e9 < full.param_count() < 1.1e9


def test_launchers_keep_refusing_whisper():
    """The serving and training launchers drive token LMs, as the JAX
    package's do: whisper runs through Model and build_train_step."""
    for main in (serve_model.main, train.main):
        with pytest.raises(ValueError, match="token-LM"):
            main(["--arch", ARCH, "--reduced", "--device", "cpu"])
