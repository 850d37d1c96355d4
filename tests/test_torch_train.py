"""Training through the port (``Model.loss``, ``launch.steps``, the
optimizers) on the CPU against the JAX package.

The JAX weights are carried across (``params_from_numpy``), norm scales
and biases perturbed so that each matters; the port's gradients come back
in the JAX layout through ``flat_to_numpy``.  Reduced qwen2-0.5b (QKV
bias), yi-6b, qwen3-32b (QK norm), moonshot (MoE) and xlstm-1.3b.

Tolerances: the loss in float32 rtol 1e-5, in bfloat16 rtol 1e-2 (a few
bfloat16 steps of logits of order 3, averaged). A gradient leaf in float32
within 1e-4 of its value plus 1e-3 of the leaf's largest |value| (the two
frameworks sum in another order, and the sums over a batch cancel:
xlstm-1.3b's gate biases, four values summed over every position through
the recurrence, sit 1.4e-4 of their largest apart); in bfloat16 within
5e-2 of the leaf's norm in L2 (the frameworks round bfloat16 products and
elementwise ops at different places, and the backward compounds two
forward layers of it); xlstm-1.3b's bfloat16 gradient is the model's own
noise (the JAX package's sits up to 4.4x a leaf's norm from its own
float32 gradient), so it is held to the float32 gradient, over the whole
tree, no farther than 1.5x the JAX package's. The weights after two
optimizer steps (float32): within 2e-5 of their value plus 1e-6, plus 4 lr
for adamw (each of its steps follows a gradient's sign, which a float32
gradient at its noise floor may flip: 2 lr a step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced
from repro.launch.steps import build_train_step as jax_train_step
from repro.models import attention as jax_attn
from repro.models.model import build_model as jax_build
from repro.optim.optimizers import OptimizerSpec as JSpec
from repro.optim.optimizers import make_optimizer as jax_make_optimizer
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch.steps import build_train_step, value_and_grad
from repro_torch.models import attention as t_attn
from repro_torch.models import transformer as tt
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer

torch.set_num_threads(1)

ARCHS = ["qwen2-0.5b", "yi-6b", "qwen3-32b", "moonshot-v1-16b-a3b",
         "xlstm-1.3b"]
F32, BF16 = "float32", "bfloat16"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _worlds(arch, dt, seed=0):
    """(JAX model, JAX params, port model, port flat weights) on one
    reduced config in ``dt``, the port's weights the JAX ones."""
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(arch)), dtype=dt)
    tcfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dt)
    jm = jax_build(jcfg)
    g = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key in ("ln", "ln2", "final_norm", "bq", "bk", "bv",
                            "q_norm", "k_norm", "gn", "b_ig", "b_fg",
                            "b_gates"):
            a = (a.astype(np.float32)
                 + 0.2 * g.normal(size=a.shape)).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(
        perturb, jm.init_params(jax.random.key(seed)))
    tm = build_model(tcfg, "cpu")
    flat = tm.train_params(tt.params_from_numpy(tcfg, tree, device="cpu"))
    return jm, jax.tree.map(jnp.asarray, tree), tm, flat


def _batch(cfg, seed, B=2, S=24):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v, np.float32))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _grads_close(got_tree, want_tree, dt):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        if dt == F32:
            np.testing.assert_allclose(
                g, w, rtol=1e-4, atol=1e-3 * float(np.abs(w).max()),
                err_msg=path)
        else:
            err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
            assert err <= 5e-2, (path, err)


@pytest.mark.parametrize("dt", [F32, BF16])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, dt):
    jm, jp, tm, flat = _worlds(arch, dt)
    batch = _batch(tm.cfg, 1)
    jloss, jgrads = jax.value_and_grad(lambda p: jm.loss(p, {
        k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    tloss, tgrads = value_and_grad(tm, flat, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss),
                               rtol=1e-5 if dt == F32 else 1e-2)
    got = tt.flat_to_numpy(tm.cfg, tgrads)
    if arch != "xlstm-1.3b" or dt == F32:
        _grads_close(got, jgrads, dt)
        return
    # the xLSTM stack's bfloat16 gradient is the model's own noise: held
    # to the float32 gradient no farther than 1.5x the JAX package's
    # bfloat16 gradient sits from it, over the whole tree
    j32 = jax_build(dataclasses.replace(jm.cfg, dtype=F32))
    ref = jax.grad(lambda p: j32.loss(p, {
        k: jnp.asarray(v) for k, v in batch.items()}))(
        jax.tree.map(lambda a: a.astype(jnp.float32), jp))

    def flat(tree):
        return np.concatenate([v.reshape(-1) for _, v in _leaves(tree)])
    r = flat(ref)
    port = np.linalg.norm(flat(got) - r) / np.linalg.norm(r)
    own = np.linalg.norm(flat(jgrads) - r) / np.linalg.norm(r)
    assert port <= 1.5 * own, (port, own)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "moonshot-v1-16b-a3b",
                                  "xlstm-1.3b"])
def test_remat_policies_agree(arch):
    """none, dots and full: the same loss and gradients, bit for bit."""
    _, _, tm, flat = _worlds(arch, F32)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tm.cfg, 2).items()}
    out = {r: value_and_grad(tm, flat, batch, remat=r)
           for r in ("none", "dots", "full")}
    for r in ("dots", "full"):
        assert torch.equal(out[r][0], out["none"][0])
        for k in flat:
            assert torch.equal(out[r][1][k], out["none"][1][k]), (r, k)


def test_model_loss_takes_the_module_and_the_default_remat():
    _, _, tm, flat = _worlds("qwen2-0.5b", F32)
    module = tt.params_from_numpy(tm.cfg, tt.flat_to_numpy(tm.cfg, flat),
                                  device="cpu")
    batch = _batch(tm.cfg, 3)
    full = dataclasses.replace(tm.cfg, sharding=dataclasses.replace(
        tm.cfg.sharding, remat="full"))
    a = tm.loss(module, batch)
    b = build_model(full, "cpu").loss(flat, batch)
    assert torch.equal(a, b)
    assert not any(p.requires_grad for p in module.parameters())


def _attn_inputs(B, S, H, Hkv, dh, seed):
    g = np.random.default_rng(seed)
    return [g.normal(size=(B, S, n, dh)).astype(np.float32)
            for n in (H, Hkv, Hkv)]


@pytest.mark.parametrize("jax_fn", ["full", "blocked"])
def test_attention_and_its_gradient_match_jax(jax_fn):
    """The port's attention (the plain version on the CPU) and its
    gradient against the JAX package's training attention:
    ``full_causal_attention``, and ``blocked_causal_attention`` at chunk
    8 over S 32."""
    q, k, v = _attn_inputs(2, 32, 4, 2, 16, 5)
    w = np.random.default_rng(6).normal(size=(2, 32, 4, 16)).astype(
        np.float32)

    def jf(q_, k_, v_):
        o = jax_attn.full_causal_attention(q_, k_, v_) if jax_fn == "full" \
            else jax_attn.blocked_causal_attention(q_, k_, v_, 8)
        return jnp.sum(o * w), o
    (_, jo), jg = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    to = fa.flash_attention(tq, tk, tv)
    (to * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(to), np.asarray(jo), rtol=1e-5, atol=1e-5)
    for t, j in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(_np(t.grad), np.asarray(j), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,Hkv,dh", [(2, 17, 4, 2, 8), (1, 1, 2, 1, 16),
                                          (1, 40, 6, 3, 24)])
def test_flash_attention_bwd_torch_is_the_gradient(B, S, H, Hkv, dh, causal):
    """The plain backward against autograd through the plain forward:
    float32 within 1e-5; bfloat16 (rounded output, D from it) within
    ``BWD_TOL`` of the float32 gradient rounded to bfloat16, plus the
    output's rounding carried through D (2^-8 of the largest value)."""
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(B, S, H, Hkv, dh,
                                                         S + dh))
    do = torch.from_numpy(np.random.default_rng(S).normal(
        size=(B, S, H, dh)).astype(np.float32))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention_torch(*leaves, causal=causal)
    want = torch.autograd.grad(o, leaves, do)
    got = fa.flash_attention_bwd_torch(q, k, v, o.detach(), None, do, causal)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    bf = [t.to(torch.bfloat16) for t in (q, k, v, do)]
    ob = fa.flash_attention_torch(*bf[:3], causal=causal)
    gb = fa.flash_attention_bwd_torch(*bf[:3], ob, None, bf[3], causal)
    leaves = [t.float().requires_grad_() for t in bf[:3]]
    o32 = fa.flash_attention_torch(*leaves, causal=causal)
    want = torch.autograd.grad(o32, leaves, bf[3].float())
    top = max(float(w.abs().max()) for w in want)
    for a, b in zip(gb, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b, rtol=2 ** -7,
                                   atol=2 ** -7 * top)


@pytest.mark.parametrize("dtype,dh,S,want", [
    (torch.bfloat16, 64, 65, "wgmma"), (torch.bfloat16, 128, 1, "wgmma"),
    (torch.bfloat16, 128, 300, "wgmma"), (torch.bfloat16, 80, 65, "simt"),
    (torch.bfloat16, 40, 7, "simt"), (torch.float32, 64, 65, "simt"),
    (torch.float32, 128, 128, "simt")])
def test_flash_attention_bwd_form(monkeypatch, dtype, dh, S, want):
    """The backward launches in the forward's form (``form``: wgmma for
    bfloat16 at dh 64 or 128, simt otherwise): the launcher gets the
    form's number and a (2, B, H, rows) float32 scratch, S rows for simt
    and S rounded up to 128 for wgmma, and the wrapper counts the launch
    by form.  The launch itself is recorded, not run (no card here)."""
    calls = []
    monkeypatch.setattr(fa, "check_cuda", lambda *t: t[0].device)
    monkeypatch.setattr(fa._build, "launch",
                        lambda name, dev, *args: calls.append((name, args)))
    monkeypatch.setattr(fa.flash_attention_bwd, "launches", 0)
    monkeypatch.setattr(fa.flash_attention_bwd, "form_launches", {})
    B, H, Hkv = 2, 6, 3
    q, o, do = (torch.zeros(B, S, H, dh, dtype=dtype) for _ in range(3))
    k, v = (torch.zeros(B, S, Hkv, dh, dtype=dtype) for _ in range(2))
    lse = torch.zeros(B, H, S)
    scratch = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        t = real_empty(*shape, **kw)
        scratch.append(t)
        return t
    monkeypatch.setattr(torch, "empty", empty)
    for _ in range(2):
        fa._launch_bwd(q, k, v, o, lse, do, True)
    assert fa.form(dtype, dh) == want
    assert fa.flash_attention_bwd.last_form == want
    assert fa.flash_attention_bwd.form_launches == {want: 2}
    assert fa.flash_attention_bwd.launches == 2
    rows = -(-S // 128) * 128 if want == "wgmma" else S
    assert fa.bwd_rows(S, want) == rows
    assert [tuple(t.shape) for t in scratch] == [(2, B, H, rows)] * 2
    assert all(t.dtype == torch.float32 for t in scratch)
    (name, args), _ = calls
    assert name == "attn_flash_attention_bwd"
    # (q, k, v, o, dO, lse, B, Sq, Skv, H, Hkv, dh, scale, causal, dtype,
    # form, rows, dq, dk, dv)
    assert args[6:12] == (B, S, S, H, Hkv, dh)
    assert args[15] == fa.FORMS[want]
    assert args[16] == scratch[0].data_ptr()


def test_attention_block_backward_on_the_cpu_is_plain():
    """On the CPU the attention block differentiates through the plain
    version; the backward op's plain version is registered beside the
    kernel and counted at its cost."""
    from repro_torch.analysis.hlo_cost import counting
    from repro_torch.kernels import factory
    assert factory.available_impls("flash_attention_bwd") == ("cuda",
                                                              "torch")
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(1, 9, 2, 1, 8, 0))
    o = fa.flash_attention_torch(q, k, v)
    with counting() as c:
        factory.get_kernel("flash_attention_bwd")(q, k, v, o, None, o)
    flops, n_bytes = factory.kernel_cost("flash_attention_bwd")(
        q, k, v, o, None, o)
    assert c.launches("flash_attention_bwd") == 1
    assert (c.flops, c.bytes) == (flops, n_bytes) == (
        5 * 2 * 9 * 9 * 8, 4 * 4 * (9 * 2 * 8 + 9 * 8) + 4 * 2 * 9)
    # the attention block's gradient on the CPU: autograd through the
    # plain version
    cfg = reduced_config(get_config("qwen2-0.5b"))
    model = build_model(cfg, "cpu")
    p = {k: t.clone().requires_grad_() for k, t in model.train_params(
        model.init_params(0)).items() if k.startswith("blocks.0.attn.")}
    view = {k.split(".")[-1]: t for k, t in p.items()}
    x = torch.randn(1, 6, cfg.d_model).to(p["blocks.0.attn.wq"].dtype)
    pos = torch.arange(6)[None].expand(1, 6)
    t_attn.attention_block(cfg, view, x, pos).sum().backward()
    assert all(t.grad is not None for t in p.values())


@pytest.mark.parametrize("name", ["sgdm", "adamw", "adafactor"])
def test_train_step_matches_jax(name):
    """One ``build_train_step`` step of each optimizer against the JAX
    package's, float32, on reduced qwen2-0.5b."""
    jm, jp, tm, flat = _worlds("qwen2-0.5b", F32)
    kw = dict(name=name, lr=1e-3, factored_min=8)
    jopt = jax_make_optimizer(JSpec(**kw))
    topt = make_optimizer(OptimizerSpec(**kw),
                          groups=tm.param_groups(flat))
    batch = _batch(tm.cfg, 4)
    jstep = jax.jit(jax_train_step(jm, jopt))
    tstep = build_train_step(tm, topt)
    jstate, tstate = jopt.init(jp), topt.init(flat)
    for s in range(2):
        b = _batch(tm.cfg, 10 + s)
        jp, jstate, jmet = jstep(jp, jstate, {k: jnp.asarray(v)
                                              for k, v in b.items()})
        flat, tstate, tmet = tstep(flat, tstate, {k: torch.from_numpy(v)
                                                  for k, v in b.items()})
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tmet["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-4)
    got = _leaves(tt.flat_to_numpy(tm.cfg, flat))
    for (path, g), (_, w) in zip(got, _leaves(jp)):
        moved = np.abs(g - w)
        bound = 2e-5 * np.abs(w) + 1e-6 + (2 * 2 * 1e-3 if name == "adamw"
                                           else 0.0)
        assert (moved <= bound).all(), (path, float(moved.max()))
    assert int(tstate["step"]) == 2
    del batch
