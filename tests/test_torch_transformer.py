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
from repro.models import attention as jax_attn
from repro.models import mamba as jax_mamba
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.models import xlstm as jax_xlstm
from repro.models.layers import apply_norm as jax_norm
from repro.models.model import build_model as jax_build
from repro_torch.configs.registry import REGISTRY, get_config, reduced_config
from repro_torch.launch import serve_model
from repro_torch.models import attention as t_attn
from repro_torch.models import mamba as t_mamba
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as tt
from repro_torch.models import xlstm as t_xlstm
from repro_torch.models.layers import apply_norm as t_norm
from repro_torch.models.model import build_model

torch.set_num_threads(1)

DENSE = ["yi-6b", "qwen2-0.5b", "qwen1.5-0.5b", "qwen3-32b"]
MOE = ["moonshot-v1-16b-a3b", "kimi-k2-1t-a32b"]
TOKEN_LMS = DENSE + MOE + ["xlstm-1.3b", "jamba-1.5-large-398b"]
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
                            "q_norm", "k_norm", "gn", "b_ig", "b_fg",
                            "b_gates", "conv_b", "dt_bias", "D", "A_log"):
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


@pytest.mark.parametrize("arch", TOKEN_LMS)
def test_params_round_trip(arch):
    _, jp, tm, tp = _worlds(arch, BF16)
    # every leaf keeps the JAX leaf's dtype: the MoE router float32 in a
    # bfloat16 model, not rounded to bfloat16 on the way
    jb = jp["periods"]["b0"]
    for name, t in tp.blocks[0].tree().items():
        for sub, leaf in (t.items() if isinstance(t, dict) else [(None, t)]):
            want = jb[name] if sub is None else jb[name][sub]
            assert str(leaf.dtype).split(".")[-1] == str(want.dtype), name
    if "router" in jb:
        r = np.asarray(jb["router"])
        assert not np.array_equal(r, r.astype(jnp.bfloat16).astype(r.dtype))
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
@pytest.mark.parametrize("arch", TOKEN_LMS)
def test_prefill_then_decode_matches_forward(arch, dt, tol):
    """tests/test_arch_smoke.py's KV-cache check on the port: decoding
    token by token equals the one-shot forward (float32 to 1e-4, bfloat16
    at that test's 0.15), and so does the prefill's last position, and
    the prefill's caches the decode state's (the attention positions of
    the pattern; none for xLSTM).  With 8 tokens no expert queue of the
    MoE stacks overflows (capacity 8), so no path drops a token."""
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
    assert sorted(caches) == [f"b{i}" for i, (m, _) in
                              enumerate(tt.block_specs(cfg)) if m == "attn"]
    for b, kv in caches.items():
        np.testing.assert_allclose(_np(kv["k"]),
                                   _np(state[b]["k"][:, :, :S]),
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


@pytest.mark.parametrize("arch", ["yi-6b"] + MOE + ["xlstm-1.3b",
                                             "jamba-1.5-large-398b"])
def test_generate_matches_jax_serve_loop(arch):
    jm, jp, tm, tp = _worlds(arch, F32, seed=1)
    prompts = np.random.default_rng(0).integers(0, 256, (4, 8))
    want = _jax_serve_loop(jm, jp, prompts, 8)
    got = serve_model.generate(tm, tp, prompts, 8)
    assert got.shape == (4, 8)
    np.testing.assert_array_equal(got, want)


def test_serve_model_main_on_cpu(capsys):
    out = serve_model.main(["--reduced", "--device", "cpu", "--host-mesh",
                            "--batch", "2", "--prompt-len", "3",
                            "--tokens", "4"])
    assert out["tokens"].shape == (2, 4) and out["tokens_per_s"] > 0
    assert "served 2 x 7 steps" in capsys.readouterr().out


@pytest.mark.parametrize("arch,item", [
    ("moonshot-v1-16b-a3b", None), ("kimi-k2-1t-a32b", None),
    ("xlstm-1.3b", None), ("jamba-1.5-large-398b", None),
    ("whisper-medium", None), ("qwen2-vl-72b", None),
    ("lenet5", None)])
def test_unported_families_raise(arch, item):
    """A family still to port would raise naming its ROADMAP.md item (none
    is left); the MoE, xLSTM, hybrid (jamba) and VLM families, ported,
    build; LeNet's conv family builds a LeNet (tests/test_torch_lenet.py)
    and whisper's encoder-decoder an EncDecLM
    (tests/test_torch_encdec.py)."""
    cfg = reduced_config(REGISTRY[arch])
    if cfg.family == "conv":
        from repro_torch.models.lenet import LeNet
        model = build_model(cfg, "cpu")
        assert isinstance(model, LeNet) and model.cfg is cfg
        assert sorted(model.init_params(0)) == list(model.init_params(0))
        return
    if cfg.enc_dec:
        from repro_torch.models.encdec import EncDecLM
        model = build_model(cfg, "cpu")
        params = model.init_params(0)
        assert isinstance(params, EncDecLM) and model.cfg is cfg
        assert len(params.blocks) == cfg.n_layers
        assert len(params.enc_blocks) == cfg.n_enc_layers
        with pytest.raises(ValueError, match="encdec"):
            tt.TransformerLM(cfg, device="cpu")
        return
    if item is None:
        assert build_model(cfg, "cpu").cfg is cfg
        lm = tt.TransformerLM(cfg, device="cpu")
        assert len(lm.blocks) == cfg.n_layers
        assert [b.spec for b in lm.blocks[:len(cfg.pattern)]] == \
            tt.block_specs(cfg)
        return
    with pytest.raises(NotImplementedError, match=item.replace("(", r"\(")
                       .replace(")", r"\)")):
        build_model(cfg, "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tt.TransformerLM(cfg, device="cpu")


# ---------------------------------------------------------------------------
# Layer by layer on the JAX model's activations (the bfloat16 parity of the
# deeper stacks; shared with tests/test_torch_moe.py and test_torch_xlstm.py)
# ---------------------------------------------------------------------------
ROUTING_GAP = 1e-6


def routing_agrees(jax_logits, port_logits, top_k, what):
    """The port's top-k experts against the JAX package's on the same
    router input: where they differ, the gap between the k-th and the
    (k+1)-th gate must be under ROUTING_GAP (a near-tie that either order
    of summation may break); returns the tokens whose routing agrees and
    the largest such gap."""
    jw, ji = jax_moe.route_topk(jax_logits, top_k)
    tw, ti = t_moe.route_topk(port_logits, top_k)
    ji = np.sort(np.asarray(ji), -1)
    ti = np.sort(ti.numpy(), -1)
    same = (ji == ti).all(-1)
    gates = np.sort(np.asarray(jax.nn.softmax(jax_logits, -1)), -1)[..., ::-1]
    gaps = gates[..., top_k - 1] - gates[..., top_k]
    worst = float(gaps[~same].max()) if (~same).any() else 0.0
    assert worst < ROUTING_GAP, (
        f"{what}: routing differs on {int((~same).sum())} tokens with a "
        f"k-th to (k+1)-th gate gap up to {worst}")
    np.testing.assert_allclose(_np(tw)[same], _np(jw)[same], rtol=1e-6,
                               atol=1e-7)
    return same, worst


def _held(port, want, tol, what, rows=None):
    a, b = _np(port), _np(want)
    if rows is not None:
        a, b = a[rows], b[rows]
    np.testing.assert_allclose(a, b, **tol, err_msg=what)


def _ffn_stage(jcfg, spec, bp, blk, x_mid, tol, what, single):
    """Norm, then the FFN on the JAX package's normalised input: the MoE's
    routing compared first, its output held on the tokens routed alike."""
    tdt = getattr(torch, jcfg.dtype)
    ffn = spec[1]
    if ffn == "none":
        return x_mid, 0.0
    hf = jax_norm(jcfg, x_mid, bp["ln2"])
    _held(t_norm(jcfg, _torch(x_mid, tdt), blk.ln2), hf, tol, what + " ln2")
    th = _torch(hf, tdt)
    gap = 0.0
    if ffn == "moe":
        jp = {k: bp[k] for k in ("router", "moe_wg", "moe_wu", "moe_wo")}
        tp = {k: getattr(blk, k) for k in jp}
        jfn = jax_moe.moe_ffn_single if single else jax_moe.moe_ffn
        tfn = t_moe.moe_ffn_single if single else t_moe.moe_ffn
        delta = jfn(jcfg, jp, hf)
        jl = jnp.einsum("bsd,de->bse", hf.astype(jnp.float32), bp["router"])
        same, gap = routing_agrees(jl, th.to(torch.float32) @ blk.router,
                                   jcfg.moe.top_k, what)
        rows = same.reshape(-1) if single else same
        _held(tfn(jcfg, tp, th), delta, tol, what + " moe", rows)
    else:
        delta = jax_tf.swiglu(hf, bp["wi_gate"], bp["wi_up"], bp["w_down"])
        _held(tt.swiglu(th, blk.wi_gate, blk.wi_up, blk.w_down), delta, tol,
              what + " swiglu")
    return x_mid + delta, gap


def _torch(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


def layerwise_matches_jax(arch, dt, toks, n_decode=3, seed=0):
    """The port against the JAX Model layer by layer, each stage fed the
    JAX model's own activations (and, in decode, its state): the mixer
    (with its K/V caches or recurrent state), the FFN's norm and the FFN
    (routing compared first), then the head; the prefill over ``toks``
    and ``n_decode`` decode steps from the prefill's caches.  Holding
    each stage on the same inputs keeps the check at a few rounding steps
    of the working dtype, where the chained stacks (xLSTM above all)
    amplify one rounding difference into large gaps.  Returns the largest
    routing gap met (0 where routing agreed everywhere)."""
    jm, jp, tm, tp = _worlds(arch, dt, seed)
    jcfg, tdt, tol = jm.cfg, getattr(torch, dt), _tol(dt)
    specs = jax_tf.block_specs(jcfg)
    B, S = toks.shape
    jx, pos = jax_tf.embed_inputs(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                  None)
    tx, tpos = tt.embed_inputs(tm.cfg, tp, {"tokens": torch.from_numpy(toks)})
    _held(tx, jx, tol, "embedding")
    state = jm.init_decode_state(B, S + n_decode)
    worst = 0.0

    def layer_params(i, j):
        return jax.tree.map(lambda a: a[j], jp["periods"][f"b{i}"])

    for layer, j, i in tt._layer_items(tm.cfg):
        bp, blk, what = layer_params(i, j), tp.blocks[layer], f"layer {layer}"
        mixer = specs[i][0]
        if mixer == "attn":
            h = jax_norm(jcfg, jx, bp["ln"])
            delta, (k, v) = jax_attn.attention_block(
                jcfg, bp["attn"], h, pos, None, return_cache=True)
            tdelta, (tk, tv) = t_attn.attention_block(
                tm.cfg, blk.attn, t_norm(jcfg, _torch(jx, tdt), blk.ln), tpos,
                return_cache=True)
            _held(tk, k, tol, what + " k")
            _held(tv, v, tol, what + " v")
            for name, c in (("k", k), ("v", v)):
                state[f"b{i}"][name] = state[f"b{i}"][name].at[j, :, :S].set(c)
        elif mixer == "mamba":
            # the JAX prefill emits no Mamba state: decode starts from zeros
            delta, _ = jax_mamba.mamba_block(
                jcfg, bp["mamba"], jax_norm(jcfg, jx, bp["ln"]), None, None)
            tdelta, _ = t_mamba.mamba_block(
                tm.cfg, blk.mamba, t_norm(jcfg, _torch(jx, tdt), blk.ln))
        else:
            fn = jax_xlstm.mlstm_block if mixer == "mlstm" \
                else jax_xlstm.slstm_block
            tfn = t_xlstm.mlstm_block if mixer == "mlstm" \
                else t_xlstm.slstm_block
            delta, _ = fn(jcfg, bp[mixer], jx, None, None)
            tdelta, _ = tfn(tm.cfg, getattr(blk, mixer), _torch(jx, tdt))
        _held(tdelta, delta, tol, what + " " + mixer)
        jx, gap = _ffn_stage(jcfg, specs[i], bp, blk, jx + delta, tol, what,
                             single=False)
        worst = max(worst, gap)
    _held(t_norm(jcfg, _torch(jx, tdt), tp.final_norm) @ tp.head_w,
          jnp.einsum("bsd,dv->bsv", jax_norm(jcfg, jx, jp["final_norm"]),
                     jp["head_w"]), tol, "head")

    nxt = _tokens(seed + 7, B, n_decode)
    for step in range(n_decode):
        t = S + step
        jx = jnp.take(jp["embed"]["table"], jnp.asarray(nxt[:, step:step + 1]),
                      axis=0)
        for layer, j, i in tt._layer_items(tm.cfg):
            bp, blk = layer_params(i, j), tp.blocks[layer]
            what = f"decode {step} layer {layer}"
            mixer = specs[i][0]
            st = {k: v[j] for k, v in state[f"b{i}"].items()}
            tst = {k: _torch(v, tdt if mixer == "attn" or k == "conv"
                             else torch.float32)
                   for k, v in st.items()}
            if mixer == "attn":
                delta, ck, cv = jax_attn.decode_attention_block(
                    jcfg, bp["attn"], jax_norm(jcfg, jx, bp["ln"]), st["k"],
                    st["v"], jnp.int32(t), None)
                new = {"k": ck, "v": cv}
                tdelta = t_attn.decode_attention_block(
                    tm.cfg, blk.attn, t_norm(jcfg, _torch(jx, tdt), blk.ln),
                    tst["k"], tst["v"], t)
            elif mixer == "mamba":
                delta, new = jax_mamba.mamba_block(
                    jcfg, bp["mamba"], jax_norm(jcfg, jx, bp["ln"]), st, None)
                tdelta, tst = t_mamba.mamba_block(
                    tm.cfg, blk.mamba, t_norm(jcfg, _torch(jx, tdt), blk.ln),
                    tst)
            else:
                fn = jax_xlstm.mlstm_block if mixer == "mlstm" \
                    else jax_xlstm.slstm_block
                tfn = t_xlstm.mlstm_block if mixer == "mlstm" \
                    else t_xlstm.slstm_block
                delta, new = fn(jcfg, bp[mixer], jx, st, None)
                tdelta, tnew = tfn(tm.cfg, getattr(blk, mixer),
                                   _torch(jx, tdt), tst)
                tst = tnew
            _held(tdelta, delta, tol, what + " " + mixer)
            for name in new:
                _held(tst[name], new[name], tol, f"{what} state {name}")
                state[f"b{i}"][name] = state[f"b{i}"][name].at[j].set(
                    new[name])
            jx, gap = _ffn_stage(jcfg, specs[i], bp, blk, jx + delta, tol,
                                 what, single=True)
            worst = max(worst, gap)
        _held(t_norm(jcfg, _torch(jx, tdt), tp.final_norm) @ tp.head_w,
              jnp.einsum("bsd,dv->bsv", jax_norm(jcfg, jx, jp["final_norm"]),
                         jp["head_w"]), tol, f"decode {step} head")
    return worst


@pytest.mark.parametrize("dt", [F32, BF16])
def test_dense_layerwise_matches_jax(dt):
    """The layer-by-layer check on a dense stack too (reduced yi-6b)."""
    assert layerwise_matches_jax("yi-6b", dt, _tokens(3, 2, 20)) == 0.0
