"""The port's attention and layers on the CPU against the JAX package.

* ``flash_attention`` (the factory op's plain version, which the CPU
  runs) against the Pallas kernel in interpret mode on the grid of
  tests/test_kernels.py, causal and not, in float32 and bfloat16, at that
  file's tolerances (rtol 1e-4 / atol 1e-5 in float32, 2e-2 in bfloat16:
  the sums run in another order), and against ``ref.flash_attention_ref``
  at lengths and head widths the Pallas kernel does not take (S = 7,
  4,097; dh 80).
* ``attention_block`` against the JAX one on both of its branches (the
  dense one at S <= 2 * chunk, the blocked one beyond), and the decode
  block, with nonzero QKV biases and QK-norm scales.
* ``rms_norm``, ``layer_norm``, ``apply_rope`` and ``swiglu``.
* The kernel's form selection, case by case.

The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.kernels import factory
from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers

torch.set_num_threads(1)

F32, BF16 = "float32", "bfloat16"


def _tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == BF16 \
        else dict(rtol=1e-4, atol=1e-5)


def _pair(a: np.ndarray, dt: str):
    """The same values as a JAX array and a torch tensor of dtype ``dt``
    (bfloat16 rounded once, on the numpy side)."""
    if dt == BF16:
        a = np.asarray(a, np.float32).astype(ml_dtypes.bfloat16)
        return jnp.asarray(a), torch.from_numpy(
            a.view(np.int16)).view(torch.bfloat16)
    a = np.asarray(a, np.float32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _qkv(g, B, S, H, Hkv, dh, dt):
    return [_pair(g.normal(size=(B, S, n, dh)), dt) for n in (H, Hkv, Hkv)]


# -- flash_attention -----------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("B,S,H,Hkv,dh", [
    (2, 256, 4, 2, 64),
    (1, 512, 8, 8, 32),
    (2, 256, 8, 2, 64),
    (1, 128, 4, 1, 128),       # MQA
])
def test_flash_attention_vs_pallas(B, S, H, Hkv, dh, dt, causal):
    g = np.random.default_rng(S + H + dh)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(g, B, S, H, Hkv, dh, dt)
    want = jax_flash(jq, jk, jv, causal=causal, block_q=128, block_k=128,
                     interpret=True)
    got = factory.get_kernel("flash_attention")(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hkv,dh,dt", [
    (2, 7, 4, 2, 16, F32),
    (1, 4097, 2, 1, 16, F32),
    (1, 4097, 2, 2, 8, BF16),
    (2, 33, 4, 1, 80, F32),        # qwen3-32b's head width
    (1, 65, 6, 2, 80, BF16),
    (1, 1, 2, 1, 128, F32),
])
def test_flash_attention_vs_ref_any_length(B, S, H, Hkv, dh, dt, causal):
    g = np.random.default_rng(S * dh)
    (jq, tq), (jk, tk), (jv, tv) = _qkv(g, B, S, H, Hkv, dh, dt)
    want = ref.flash_attention_ref(jq, jk, jv, causal=causal)
    got = tfa.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


def test_flash_attention_factory_and_checks():
    assert factory.available_impls("flash_attention") == ("cuda", "torch")
    q = torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError, match="multiple of Hkv"):
        tfa.flash_attention(q, torch.zeros(1, 4, 2, 8),
                            torch.zeros(1, 4, 2, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa._launch(q, q, q, True)
    # the plain version carries gradients on the CPU
    g = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(g.normal(size=(1, 5, 2, 8)).astype(
        np.float32)).requires_grad_() for _ in range(3))
    tfa.flash_attention(q, k, v).sum().backward()
    assert torch.isfinite(q.grad).all() and q.grad.abs().sum() > 0


def _rows_plain(q, k, v, r0, r1):
    """The plain version's steps for causal query rows [r0, r1) of one
    head, q, k, v (S, dh)."""
    s = (q[r0:r1].float() @ k[:r1].float().T) * q.shape[1] ** -0.5
    live = torch.arange(r0, r1)[:, None] >= torch.arange(r1)[None]
    p = torch.softmax(torch.where(live, s, tfa.NEG_INF), dim=-1)
    return (p @ v[:r1].float()).to(q.dtype)


def _rows_tiled(q, k, v, r0, r1, fault):
    """The card kernel's arithmetic for the same rows: an online softmax in
    float32 over tiles of 64 keys, one rounding at the end; ``fault``
    breaks it as a wrong kernel would."""
    S, dh = q.shape
    qf, rows = q[r0:r1].float(), torch.arange(r0, r1)[:, None]
    m = torch.full((r1 - r0, 1), tfa.NEG_INF)
    lsum, acc = torch.zeros(r1 - r0, 1), torch.zeros(r1 - r0, dh)
    for k0 in range(0, r1, 64):
        s = (qf @ k[k0:k0 + 64].float().T) * dh ** -0.5
        live = torch.arange(k0, min(k0 + 64, r1))[None] <= rows
        if fault == "late rows drop tile 0" and k0 == 0:
            live = live & (rows < S // 2)
        s = torch.where(live, s, tfa.NEG_INF)
        m_new = torch.maximum(m, s.max(-1, keepdim=True).values)
        p = torch.where(live, torch.exp(s - m_new), 0.0)
        if fault == "P in bfloat16":
            p = p.to(torch.bfloat16).float()
        corr = torch.exp(m - m_new)
        for _ in range(2 if fault == "tile 1 twice" and k0 == 64 else 1):
            lsum = lsum * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p @ v[k0:k0 + 64].float()
            corr = torch.ones_like(corr)
        m = m_new
    return (acc / lsum.clamp(min=1e-30)).to(q.dtype)


@pytest.mark.parametrize("fault", [None, "late rows drop tile 0",
                                   "tile 1 twice", "P in bfloat16"])
@pytest.mark.parametrize("S,spans", [(4096, [(0, 4096)]),
                                     (32768, [(0, 256), (32512, 32768)])])
def test_kernel_bound_rejects_faults(S, spans, fault):
    """KERNEL_TOL in bfloat16, which the card holds the kernel to, at one
    head of the card checks' shapes (yi-6b's layer, every row;
    prefill_32k's sequence, its first and last 256 rows): the kernel's
    arithmetic stays inside it, and a kernel with one of these faults lands
    more than 2x outside."""
    g = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn(S, 128, generator=g).to(torch.bfloat16)
               for _ in range(3))
    tol = tfa.KERNEL_TOL[torch.bfloat16]
    of_bound = 0.0
    for r0, r1 in spans:
        want = _rows_plain(q, k, v, r0, r1).float()
        got = _rows_tiled(q, k, v, r0, r1, fault).float()
        of_bound = max(of_bound, float(
            ((got - want).abs() / (tol["atol"] + tol["rtol"] * want.abs()))
            .max()))
    assert of_bound <= 1.0 if fault is None else of_bound > 2.0


# -- layers ----------------------------------------------------------------------
@pytest.mark.parametrize("dt", [F32, BF16])
def test_layers_match_jax(dt):
    g = np.random.default_rng(1)
    jx, tx = _pair(g.normal(size=(2, 5, 3, 16)), dt)
    js, ts = _pair(1 + 0.1 * g.normal(size=16), dt)
    jb, tb = _pair(0.1 * g.normal(size=16), dt)
    tol = _tol(dt) if dt == BF16 else dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tlayers.rms_norm(tx, ts)),
                               _np(jlayers.rms_norm(jx, js)), **tol)
    np.testing.assert_allclose(_np(tlayers.layer_norm(tx, ts, tb)),
                               _np(jlayers.layer_norm(jx, js, jb)),
                               **(_tol(dt) if dt == BF16
                                  else dict(rtol=1e-5, atol=1e-5)))
    pos = g.integers(0, 5000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        _np(tlayers.apply_rope(tx, torch.from_numpy(pos), 5e6)),
        _np(jlayers.apply_rope(jx, jnp.asarray(pos), 5e6)),
        **(_tol(dt) if dt == BF16 else dict(rtol=1e-5, atol=1e-5)))
    jh, th = _pair(g.normal(size=(2, 5, 16)), dt)
    (jwg, twg), (jwu, twu) = (_pair(g.normal(size=(16, 24)) / 4, dt)
                              for _ in range(2))
    jwd, twd = _pair(g.normal(size=(24, 16)) / 5, dt)
    np.testing.assert_allclose(
        _np(tlayers.swiglu(th, twg, twu, twd)),
        _np(jlayers.swiglu(jh, jwg, jwu, jwd)),
        **(_tol(dt) if dt == BF16 else dict(rtol=1e-5, atol=1e-5)))
    assert np.array_equal(tlayers.rope_freqs(80, 1e6),
                          jlayers.rope_freqs(80, 1e6))


def test_dense_init_is_a_truncated_normal():
    """Bounds +-2 standard deviations of fan_in^-0.5, in absolute units
    (``trunc_normal_`` takes them so), and the truncated normal's spread."""
    g = torch.Generator().manual_seed(0)
    w = tlayers.dense_init((400, 300), torch.float32, g, "cpu")
    scale = 400 ** -0.5
    assert float(w.abs().max()) <= 2 * scale
    assert float(w.abs().max()) > 1.9 * scale
    # the standard normal cut at +-2 has standard deviation 0.8796
    assert abs(float(w.std()) / scale - 0.8796) < 0.01
    same = tlayers.dense_init((400, 300), torch.float32,
                              torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(w, same)


# -- attention blocks --------------------------------------------------------------
def _cfgs(arch, dt):
    return (dataclasses.replace(jax_reduced(jax_get_config(arch)), dtype=dt),
            dataclasses.replace(reduced_config(get_config(arch)), dtype=dt))


def _attn_params(jcfg, dt, seed):
    """JAX-initialised attention params with every bias and norm scale
    perturbed, as (JAX dict, torch dict)."""
    p = jattn.init_attn_params(jax.random.key(seed), jcfg, jnp.float32)
    g = np.random.default_rng(seed)
    out = {}
    for name, a in p.items():
        a = np.asarray(a)
        if a.ndim == 1:
            a = a + 0.2 * g.normal(size=a.shape)
        out[name] = _pair(a, dt)
    return ({k: v[0] for k, v in out.items()},
            {k: v[1] for k, v in out.items()})


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("S", [8, 24])       # JAX: dense / blocked branch
@pytest.mark.parametrize("arch", ["yi-6b", "qwen2-0.5b", "qwen3-32b"])
def test_attention_block_matches_jax(arch, S, dt):
    jcfg, tcfg = _cfgs(arch, dt)
    jp, tp = _attn_params(jcfg, dt, S)
    g = np.random.default_rng(S)
    jx, tx = _pair(g.normal(size=(2, S, jcfg.d_model)), dt)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    want, (wk, wv) = jattn.attention_block(jcfg, jp, jx, jnp.asarray(pos),
                                           chunk=8, return_cache=True)
    got, (gk, gv) = tattn.attention_block(tcfg, tp, tx,
                                          torch.from_numpy(pos.copy()),
                                          return_cache=True)
    tol = _tol(dt) if dt == BF16 else dict(rtol=1e-5, atol=1e-5)
    for a, b in ((got, want), (gk, wk), (gv, wv)):
        assert a.dtype == tx.dtype
        np.testing.assert_allclose(_np(a), _np(b), **tol)


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("arch", ["yi-6b", "qwen1.5-0.5b", "qwen3-32b"])
def test_decode_attention_block_matches_jax(arch, dt):
    jcfg, tcfg = _cfgs(arch, dt)
    jp, tp = _attn_params(jcfg, dt, 3)
    g = np.random.default_rng(4)
    B, S_max, pos = 2, 12, 5
    jx, tx = _pair(g.normal(size=(B, 1, jcfg.d_model)), dt)
    shape = (B, S_max, jcfg.n_kv_heads, jcfg.head_dim)
    (jck, tck), (jcv, tcv) = (_pair(g.normal(size=shape), dt)
                              for _ in range(2))
    want, wk, wv = jattn.decode_attention_block(jcfg, jp, jx, jck, jcv,
                                                jnp.int32(pos))
    got = tattn.decode_attention_block(tcfg, tp, tx, tck, tcv, pos)
    tol = _tol(dt) if dt == BF16 else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    # the caches are written in place
    np.testing.assert_allclose(_np(tck), _np(wk), **tol)
    np.testing.assert_allclose(_np(tcv), _np(wv), **tol)


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 80, "simt"), (torch.bfloat16, 32, "simt"),
    (torch.bfloat16, 16, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 64, "simt")])
def test_flash_attention_form(dtype, dh, want):
    """The kernel's form is a pure function of the dtype and the head
    width: the wgmma form for bfloat16 at dh 64 or 128."""
    assert tfa.form(dtype, dh) == want
    assert set(tfa.FORMS) == {"simt", "wgmma"}
