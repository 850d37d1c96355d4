"""The port's Mamba mixer (``kernels.ssm_scan``, ``models.mamba``) and the
reduced jamba (one 8-layer period: Mamba with dense and MoE FFNs, and an
attention layer) on the CPU against the JAX package.

  * ``ssm_scan_torch`` (a sequential float32 loop) against the JAX chunked
    scan (``mamba_mix``'s ``associative_scan`` within chunks of 128 and
    ``lax.scan`` across them; its S = 1 decode branch) at S 1, 37, 128,
    256 and 300, from zeros and from a given state, on the same products:
    rtol 1e-5 / atol 1e-5 on the output and the last state (the two
    associate the products of the decays differently in float32; the
    largest gap seen is under 1e-6).
  * ``_causal_conv``, ``mamba_mix`` and ``mamba_block``, forward and a
    decode step from a given state, the new conv and SSM states included:
    float32 rtol/atol 1e-5; bfloat16 rtol 2e-2 / atol 6e-2 (the dense
    stacks' bfloat16 tolerance: the frameworks round the bfloat16
    products and the gate at other places).
  * The reduced jamba with the JAX weights carried across (every norm, the
    Mamba's conv_b, dt_bias, D and A_log perturbed): forward, prefill and
    three decode steps chained in float32 within rtol/atol 1e-5; layer by
    layer in float32 and bfloat16 (``layerwise_matches_jax``: the MoE's
    selections compared first, equal in both); ``Model.loss`` and its
    gradients against ``jax.value_and_grad`` through the plain versions
    (float32: loss rtol 1e-5, each gradient leaf rtol 1e-4 with atol 1e-3
    of its largest entry, tests/test_torch_train.py's tolerances;
    bfloat16: loss rtol 1e-2, the whole gradient no farther from the
    float32 one than 1.5x the JAX package's bfloat16 gradient, as the
    xLSTM stack's).
  * The wrapper: the plain version for CPU tensors; elsewhere the kernel
    (through the autograd Function where autograd records) or a refusal
    of a state size or a width it was not built for, no fallback.
    tests/test_torch_ssm_bwd.py holds the gradient.

tests/test_torch_transformer.py runs the serve loop's ids against the JAX
loop's, decoding against the forward and the parameter tree's round trip
(A_log and D float32) on jamba too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced
from repro.models import mamba as jax_mamba
from repro.models.model import build_model as jax_build
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.kernels import ssm_scan as sm
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import mamba as t_mamba
from repro_torch.models import transformer as tt
from repro_torch.models.transformer import _from_host
from test_torch_train import _batch, _grads_close, _leaves
from test_torch_transformer import (BF16, F32, _np, _tokens, _tol, _worlds,
                                    layerwise_matches_jax)

torch.set_num_threads(1)

ARCH = "jamba-1.5-large-398b"
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(dt=F32):
    return (dataclasses.replace(jax_reduced(jax_get_config(ARCH)), dtype=dt),
            dataclasses.replace(reduced_config(get_config(ARCH)), dtype=dt))


def _mamba_params(jcfg, seed=0):
    """The JAX Mamba parameters (numpy; conv_b, dt_bias, D and A_log
    perturbed) and the same as port tensors."""
    p = jax_mamba.init_mamba_params(jax.random.key(seed), jcfg,
                                    jnp.dtype(jcfg.dtype))
    g = np.random.default_rng(seed)
    out = {}
    for k, v in p.items():
        a = np.asarray(v)
        if k in ("conv_b", "dt_bias", "D", "A_log"):
            a = (a.astype(np.float32)
                 + 0.2 * g.normal(size=a.shape)).astype(a.dtype)
        out[k] = a
    return out, {k: _from_host(v) for k, v in out.items()}


def _jnp(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _port_products(tp, xz):
    """The mixer's products on the port side, as ``models.mamba`` takes
    them."""
    x32 = xz.to(torch.float32)
    dt_pre = (x32 @ tp["x_dt"].float()) @ tp["dt_proj"].float()
    return dt_pre, x32 @ tp["x_B"].float(), x32 @ tp["x_C"].float()


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 37, 128, 256, 300])
def test_ssm_scan_plain_matches_jax(S, with_state):
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba_params(jcfg, seed=S)
    B, di, ds = 2, 2 * jcfg.d_model, jcfg.mamba_d_state
    xz = _normal(1, (B, S, di))
    h0 = _normal(2, (B, di, ds), 0.5) if with_state else None
    want, want_h = jax_mamba.mamba_mix(jcfg, _jnp(jp), jnp.asarray(xz),
                                       None if h0 is None
                                       else jnp.asarray(h0))
    x = torch.from_numpy(xz)
    dt_pre, Bm, Cm = _port_products(tp, x)
    got, got_h = sm.ssm_scan_torch(
        x, dt_pre, tp["dt_bias"], Bm, Cm, tp["A_log"], tp["D"],
        None if h0 is None else torch.from_numpy(h0))
    assert got.dtype == torch.float32 and got_h.shape == (B, di, ds)
    np.testing.assert_allclose(_np(got), _np(want), **SCAN_TOL)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **SCAN_TOL)


def _scan_args(tp, x):
    """``ssm_scan``'s arguments for the stream x, in its order."""
    dt_pre, Bm, Cm = _port_products(tp, x)
    return x, dt_pre, tp["dt_bias"], Bm, Cm, tp["A_log"], tp["D"]


def test_ssm_scan_wrapper_and_softplus():
    """On CPU tensors the op is its plain version; the softplus is JAX's
    logaddexp(v, 0), not F.softplus's threshold form (they part above
    20)."""
    jcfg, _ = _cfgs()
    _, tp = _mamba_params(jcfg)
    args = _scan_args(tp, torch.from_numpy(_normal(3, (2, 19,
                                                       2 * jcfg.d_model))))
    a = sm.ssm_scan(*args)
    b = sm.ssm_scan_torch(*args)
    assert all(torch.equal(u, w) for u, w in zip(a, b))
    v = torch.linspace(-40.0, 40.0, 161)
    np.testing.assert_allclose(_np(sm.softplus(v)),
                               _np(jax.nn.softplus(jnp.asarray(v.numpy()))),
                               rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="Bm"):
        sm.ssm_scan(*args[:3], args[3][:, :3], *args[4:])


def _meta_args(ds=sm.DS, grad=False, B=2, S=5, di=16):
    m = dict(device="meta", dtype=torch.float32)
    return (torch.empty(B, S, di, **m).requires_grad_(grad),
            torch.empty(B, S, di, **m), torch.empty(di, **m),
            torch.empty(B, S, ds, **m), torch.empty(B, S, ds, **m),
            torch.empty(di, ds, **m), torch.empty(di, **m))


def test_ssm_scan_refuses_off_the_cpu(monkeypatch):
    """Off the CPU the wrapper launches the kernel or raises, with no
    fallback to the plain version: where autograd records the call goes
    through the autograd Function ``_KernelSsm``, whose forward reaches
    the launch's CUDA check (nothing is raised about a missing backward);
    without autograd it is the launch alone.  A state size the kernels
    were not built for, and a di off their 16-byte rows, are refused by
    the forward and by the backward.  Meta tensors stand in for the
    card's: they reach the same checks."""
    with pytest.raises(ValueError, match="CUDA") as exc:
        sm.ssm_scan(*_meta_args(grad=True))
    names = [entry.name for entry in exc.traceback]
    assert "forward" in names and names[-2:] == ["_launch", "check_cuda"]
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA") as exc:
        sm.ssm_scan(*_meta_args(grad=True))
    assert "forward" not in [entry.name for entry in exc.traceback]
    with pytest.raises(ValueError, match="CUDA"):
        sm.ssm_scan(*_meta_args())
    monkeypatch.setattr(sm, "check_cuda", lambda *t: torch.device("cuda"))
    for ds, di, match in ((8, 16, "built for ds = 16"),
                          (sm.DS, 12, "multiple of 8")):
        args = _meta_args(ds=ds, di=di)
        with pytest.raises(ValueError, match=match):
            sm.ssm_scan(*args)
        ckpt = torch.empty(2, 1, di, ds, device="meta")
        with pytest.raises(ValueError, match=match):
            sm.ssm_scan_bwd(*args, None, ckpt, torch.empty_like(args[0]))


@pytest.mark.parametrize("dt", [F32, BF16])
def test_causal_conv_matches_jax(dt):
    jcfg, _ = _cfgs(dt)
    jp, tp = _mamba_params(jcfg)
    di, k = 2 * jcfg.d_model, jcfg.mamba_d_conv
    x = _normal(4, (2, 11, di))
    state = _normal(5, (2, k - 1, di))
    jx = jnp.asarray(x).astype(jnp.dtype(dt))
    tx = torch.from_numpy(x).to(getattr(torch, dt))
    for st in (None, state):
        want, want_st = jax_mamba._causal_conv(
            _jnp(jp), jx, None if st is None
            else jnp.asarray(st).astype(jnp.dtype(dt)))
        got, got_st = t_mamba._causal_conv(
            tp, tx, None if st is None
            else torch.from_numpy(st).to(getattr(torch, dt)))
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))
        np.testing.assert_array_equal(_np(got_st), _np(want_st))


@pytest.mark.parametrize("dt", [F32, BF16])
def test_mamba_mix_and_block_match_jax(dt):
    """``mamba_mix`` on the post-conv stream, then the whole block over a
    sequence (no state) and two decode steps from a given state, the new
    conv and SSM states held too."""
    jcfg, tcfg = _cfgs(dt)
    jp, tp = _mamba_params(jcfg, seed=1)
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    tol = _tol(dt)
    di, d = 2 * jcfg.d_model, jcfg.d_model
    xz = _normal(6, (2, 40, di))
    want, want_h = jax_mamba.mamba_mix(jcfg, _jnp(jp),
                                       jnp.asarray(xz).astype(jdt))
    got, got_h = t_mamba.mamba_mix(tcfg, tp, torch.from_numpy(xz).to(tdt))
    assert got.dtype == tdt and got_h.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(got_h), _np(want_h), **tol)

    x = _normal(7, (2, 13, d))
    want, none = jax_mamba.mamba_block(jcfg, _jnp(jp),
                                       jnp.asarray(x).astype(jdt))
    got, tnone = t_mamba.mamba_block(tcfg, tp, torch.from_numpy(x).to(tdt))
    assert none is None and tnone is None
    np.testing.assert_allclose(_np(got), _np(want), **tol)

    jst = jax_mamba.init_mamba_state(jcfg, 2, jdt)
    jst = {"conv": jnp.asarray(_normal(8, jst["conv"].shape)).astype(jdt),
           "ssm": jnp.asarray(_normal(9, jst["ssm"].shape, 0.5))}
    tst = t_mamba.init_mamba_state(tcfg, 2, tdt, "cpu")
    assert {k: (v.shape, v.dtype) for k, v in tst.items()} == \
        {"conv": (jst["conv"].shape, tdt),
         "ssm": (jst["ssm"].shape, torch.float32)}
    tst = {k: _from_host(np.asarray(v)) for k, v in jst.items()}
    for step in range(2):
        x1 = _normal(10 + step, (2, 1, d))
        want, jst = jax_mamba.mamba_block(jcfg, _jnp(jp),
                                          jnp.asarray(x1).astype(jdt), jst)
        got, tst = t_mamba.mamba_block(tcfg, tp, torch.from_numpy(x1).to(tdt),
                                       tst)
        np.testing.assert_allclose(_np(got), _np(want), **tol)
        assert tst["conv"].dtype == tdt
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(_np(tst[k]), _np(jst[k]), **tol,
                                       err_msg=f"step {step} {k}")


def test_jamba_matches_jax_float32():
    """Forward, prefill (logits and the attention layer's caches) and
    three decode steps of the whole reduced jamba, chained, in float32
    within rtol/atol 1e-5.  The prefill emits no Mamba state (as the JAX
    prefill emits none), so both decodes start it from zeros."""
    jm, jp, tm, tp = _worlds(ARCH, F32)
    toks = _tokens(1, 2, 24)
    tol = _tol(F32)
    np.testing.assert_allclose(
        _np(tm.forward(tp, {"tokens": torch.from_numpy(toks)})),
        _np(jm.forward(jp, {"tokens": jnp.asarray(toks)})), **tol)
    jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tl, tcache = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    assert sorted(tcache) == sorted(jcache) == ["b4"]
    S = toks.shape[1]
    jstate = jm.init_decode_state(2, S + 3)
    tstate = tm.init_decode_state(2, S + 3)
    assert sorted(tstate) == sorted(jstate)
    for b in jstate:
        for name, v in jstate[b].items():
            assert tuple(tstate[b][name].shape) == v.shape, (b, name)
            assert str(tstate[b][name].dtype).split(".")[-1] == \
                str(v.dtype), (b, name)
    for kv in ("k", "v"):
        np.testing.assert_allclose(_np(tcache["b4"][kv]),
                                   _np(jcache["b4"][kv]), **tol)
        jstate["b4"][kv] = jstate["b4"][kv].at[:, :, :S].set(jcache["b4"][kv])
        tstate["b4"][kv][:, :, :S] = tcache["b4"][kv]
    nxt = _tokens(2, 2, 3)
    for t in range(3):
        jl, jstate = jm.decode(jp, jstate, {
            "tokens": jnp.asarray(nxt[:, t:t + 1]), "pos": jnp.int32(S + t)})
        tl, tstate = tm.decode(tp, tstate, {
            "tokens": torch.from_numpy(nxt[:, t:t + 1]), "pos": S + t})
        np.testing.assert_allclose(_np(tl), _np(jl), **tol)
    for name in ("conv", "ssm"):
        np.testing.assert_allclose(_np(tstate["b0"][name]),
                                   _np(jstate["b0"][name]), **tol)


@pytest.mark.parametrize("dt", [F32, BF16])
def test_jamba_layerwise_matches_jax(dt):
    """Layer by layer on the JAX model's activations: each Mamba layer,
    its dense or MoE FFN (the experts each token selects equal to the JAX
    package's), the attention layer and its caches, the head; prefill
    and three decode steps (the Mamba's conv and SSM states held)."""
    assert layerwise_matches_jax(ARCH, dt, _tokens(4, 2, 24)) == 0.0


@pytest.mark.parametrize("dt", [F32, BF16])
def test_jamba_loss_and_grads_match_jax(dt):
    """Float32: each gradient leaf as tests/test_torch_train.py holds the
    dense stacks'.  bfloat16: the stack's gradient is the model's own noise
    (the JAX package's bfloat16 gradient sits 0.1-0.5 of a leaf's norm from
    its float32 one), so the port's is held to the float32 gradient no
    farther than 1.5x the JAX package's bfloat16 gradient sits from it,
    over the whole tree, as the xLSTM stack's is."""
    jm, jp, tm, tp = _worlds(ARCH, dt)
    flat = tm.train_params(tp)
    batch = _batch(tm.cfg, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, jb))(jp)
    tloss, tgrads = value_and_grad(tm, flat, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=1e-5 if dt == F32 else 1e-2)
    got = tt.flat_to_numpy(tm.cfg, tgrads)
    assert got["periods"]["b0"]["mamba"]["A_log"].dtype == np.float32
    groups = tm.param_groups(tgrads)
    assert groups["blocks.1.mamba.A_log"] == ("periods.b1.mamba.A_log", 0)
    if dt == F32:
        _grads_close(got, jgrads, dt)
        return
    j32 = jax_build(dataclasses.replace(jm.cfg, dtype=F32))
    ref = jax.grad(lambda p: j32.loss(p, jb))(
        jax.tree.map(lambda a: a.astype(jnp.float32), jp))

    def whole(tree):
        return np.concatenate([v.reshape(-1) for _, v in _leaves(tree)])
    r = whole(ref)
    port = np.linalg.norm(whole(got) - r) / np.linalg.norm(r)
    own = np.linalg.norm(whole(jgrads) - r) / np.linalg.norm(r)
    assert port <= 1.5 * own, (port, own)


def test_every_launcher_signature_matches_its_source():
    """Each launcher's ctypes argument types (``_build._SIGNATURES``, the
    stream last) count the parameters of its C function in ``csrc/``: a
    missing one makes ctypes pass the stream as a 32-bit int, and the
    launch reads a stream pointer with garbage in its upper half."""
    import re
    from repro_torch.kernels import _build
    params = {}
    for src in _build.sources():
        for m in re.finditer(r"^int (\w+)\(([^)]*)\)\s*\{", src.read_text(),
                             re.M):
            params[m.group(1)] = len(m.group(2).split(","))
    assert set(_build._SIGNATURES) <= set(params)
    for name, sig in _build._SIGNATURES.items():
        assert len(sig) == params[name], name


def test_ssm_scan_bound_at_jambas_prefill():
    """The kernels line's bound at jamba's prefill (4, 4,096, 16,384, 16),
    bfloat16 x, from shapes alone (meta tensors): the exponentials
    (B·S·di·(ds + 1) = 4.56e9) over the SFUs' 16 an SM a clock at 1.98
    GHz take 1.09 ms, above the bytes (x and out 2 bytes, dt_pre 4, a
    (b, t, channel): 2.15 GB, 0.64 ms) and the float32 FLOPs (0.38 ms)."""
    B, S, di, ds = 4, 4096, 16384, sm.DS
    m = dict(device="meta")
    args = (torch.empty(B, S, di, dtype=torch.bfloat16, **m),
            torch.empty(B, S, di, **m), torch.empty(di, **m),
            torch.empty(B, S, ds, **m), torch.empty(B, S, ds, **m),
            torch.empty(di, ds, **m), torch.empty(di, **m))
    assert sm.exp_count(args[0], args[5]) == B * S * di * (ds + 1)
    flops, n_bytes = sm.ssm_scan_cost(*args)
    assert flops == sm.FLOPS_PER_STATE * B * S * di * ds
    assert 2.15e9 < n_bytes < 2.16e9
    b = sm.bound_ms(*args)
    assert b["bound_by"] == "operations"
    assert round(b["bound_ms"], 3) == 1.091 and b["bound_ms"] == b["exps_ms"]
    assert round(b["bytes_ms"], 3) == 0.643
