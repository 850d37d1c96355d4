"""The gradient of the Mamba selective scan, ``ssm_scan_bwd``, on the CPU:

  * the plain version (``ssm_scan_bwd_torch``, the explicit reverse scan
    in float32) against autograd through ``ssm_scan_torch`` at S 1, 37,
    128 and 300, from zeros and from a state, float32 and bfloat16 x,
    di 16 and 200, the last state's gradient given or not: float32 rtol
    1e-5 with atol 1e-5 of the largest gradient of its tensor (both take
    the same float32 operations, a few of the sums in another order);
    bfloat16 dx is rounded once from those float32 values, so it may land
    one bfloat16 step (rtol 2^-7) apart;
  * the mixer's whole gradient against ``jax.vjp`` of the JAX package's
    ``mamba_mix`` (its products, softplus, scan and skip), through the
    port's products and the autograd Function ``_KernelSsm`` with its
    forward launch stood in by the plain versions (``ssm_scan_torch`` and
    ``ssm_checkpoints_torch``) and its backward the factory's
    ``ssm_scan_bwd`` (the plain version on CPU tensors), at the same S,
    states, dtypes and widths; the JAX scan in chunks of 64 (S 128: two
    chunks through ``lax.scan``; 37 and 300: one chunk; 1: its decode
    step): float32 rtol 1e-4 with atol 1e-4 of the largest gradient (the
    two associate the decays' products differently, which the forward's
    test holds at 1e-5, and the gradient adds the sums over the channels
    and the steps); bfloat16 rtol 2^-6 with atol 1e-2 of the largest (the
    bfloat16 weights' gradients are rounded from float32 sums taken in
    another order, so a rounding may land a step or two apart);
  * the saved states, the cost and bound of the gradient at jamba's
    training scan from meta tensors, and the wrapper's contract off the
    CPU;
  * the Python mirrors of the kernels' layout against the constants of
    ``csrc/ssm.cuh``, ``ssm.cu`` and ``ssm_bwd.cu`` (the saved-state
    spacing, a backward thread's channels and states, a block's
    channels), and the scratch the launcher allocates for the backward
    (``part_bc``, ``part_ch``) at the shapes those constants give.

The kernel against the plain version is a card test
(tests/test_torch_gpu.py, chip_smoke.py phase 21) at ``kernel_bwd_tol``.
"""
import re
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jax_mamba
from repro_torch.kernels import factory
from repro_torch.kernels import ssm_scan as sm

torch.set_num_threads(1)

SS = [1, 37, 128, 300]
DTYPES = [torch.float32, torch.bfloat16]
WIDTHS = [16, 200]
RANK = 4                                  # the products' dt rank
JAX_CHUNK = 64


def plain_tol(want: torch.Tensor) -> dict:
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    if want.dtype == torch.bfloat16:
        return dict(rtol=2 ** -7, atol=1e-5 * scale)
    return dict(rtol=1e-5, atol=1e-5 * scale)


def jax_tol(want: np.ndarray) -> dict:
    scale = float(np.abs(want.astype(np.float32)).max()) if want.size \
        else 0.0
    if want.dtype == jnp.bfloat16:
        return dict(rtol=2 ** -6, atol=1e-2 * scale)
    return dict(rtol=1e-4, atol=1e-4 * scale)


def _rng(S, di, h0, dtype):
    return np.random.default_rng(
        [S, di, int(h0), DTYPES.index(dtype)])


def scan_inputs(B, S, di, dtype, h0, g):
    """The scan's arguments from numpy: dt_pre ~ N(-1, 1) (softplus about
    0.05 to 2), A_log log(1 .. 16) perturbed, D and dt_bias perturbed."""
    ds = sm.DS

    def f32(*shape, scale=1.0, loc=0.0):
        return torch.from_numpy((loc + scale * g.normal(size=shape))
                                .astype(np.float32))
    a_log = np.log(np.arange(1, ds + 1, dtype=np.float32))[None] \
        + 0.2 * g.normal(size=(di, ds))
    return (f32(B, S, di).to(dtype), f32(B, S, di, loc=-1.0),
            f32(di, scale=0.5), f32(B, S, ds), f32(B, S, ds),
            torch.from_numpy(a_log.astype(np.float32)),
            f32(di, scale=0.2, loc=1.0),
            f32(B, di, ds, scale=0.5) if h0 else None)


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("di", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("S", SS)
def test_plain_backward_matches_autograd(S, h0, dtype, di, with_dh):
    g = _rng(S, di, h0, dtype)
    args = scan_inputs(2, S, di, dtype, h0, g)
    dout = torch.from_numpy(g.normal(size=(2, S, di)).astype(np.float32)
                            ).to(dtype)
    dh = torch.from_numpy(g.normal(size=(2, di, sm.DS)).astype(np.float32)
                          ) if with_dh else None
    leaves = [a.clone().requires_grad_() if a is not None else None
              for a in args]
    out, h = sm.ssm_scan_torch(*leaves)
    loss = (out.float() * dout.float()).sum()
    if dh is not None:
        loss = loss + (h * dh).sum()
    live = [t for t in leaves if t is not None]
    want = torch.autograd.grad(loss, live)
    ckpt = sm.ssm_checkpoints_torch(*args[:4], args[5], args[7])
    got = sm.ssm_scan_bwd_torch(*args, ckpt, dout, dh)
    assert (got[-1] is None) == (not h0)
    names = ["dx", "ddt_pre", "ddt_bias", "dBm", "dCm", "dA_log", "dD",
             "dh0"]
    for name, a, b in zip(names, [t for t in got if t is not None], want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a, b, **plain_tol(b),
                                   msg=lambda m, n=name: f"{n}: {m}")
    # the op's CPU path is the plain version
    again = factory.get_kernel("ssm_scan_bwd")(*args, ckpt, dout, dh)
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(again, got))


def _mix_params(di, dtype, g):
    """The mixer's weights (numpy float32; the projections in ``dtype``
    on both sides, A_log and D float32)."""
    ds = sm.DS

    def w(*shape, scale):
        return (scale * g.normal(size=shape)).astype(np.float32)
    a_log = np.log(np.arange(1, ds + 1, dtype=np.float32))[None] \
        + 0.2 * g.normal(size=(di, ds))
    return {"x_dt": w(di, RANK, scale=di ** -0.5),
            "dt_proj": w(RANK, di, scale=RANK ** -0.5),
            "dt_bias": w(di, scale=0.5) - 1.0,
            "x_B": w(di, ds, scale=di ** -0.5),
            "x_C": w(di, ds, scale=di ** -0.5),
            "A_log": a_log.astype(np.float32),
            "D": (1.0 + w(di, scale=0.2)).astype(np.float32)}


def _port_mix(p, xz, h0):
    """``models.mamba.mamba_mix``'s products, then ``_KernelSsm``."""
    x32 = xz.to(torch.float32)
    dt_pre = (x32 @ p["x_dt"].float()) @ p["dt_proj"].float()
    Bm, Cm = x32 @ p["x_B"].float(), x32 @ p["x_C"].float()
    return sm._KernelSsm.apply(xz, dt_pre, p["dt_bias"], Bm, Cm, p["A_log"],
                               p["D"], h0)


@pytest.mark.parametrize("di", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("S", SS)
def test_mixer_gradient_matches_jax_vjp(S, h0, dtype, di, monkeypatch):
    g = _rng(S, di, h0, dtype)
    B, ds = 2, sm.DS
    p = _mix_params(di, dtype, g)
    xz = g.normal(size=(B, S, di)).astype(np.float32)
    state = (0.5 * g.normal(size=(B, di, ds))).astype(np.float32) \
        if h0 else None
    dout = g.normal(size=(B, S, di)).astype(np.float32)
    dh = g.normal(size=(B, di, ds)).astype(np.float32)
    jdt = jnp.dtype(str(dtype).split(".")[1])
    low = {"x_dt", "dt_proj", "dt_bias", "x_B", "x_C"}
    jp = {k: jnp.asarray(v).astype(jdt if k in low else jnp.float32)
          for k, v in p.items()}
    cfg = types.SimpleNamespace(mamba_d_state=ds)
    chunk = JAX_CHUNK if S % JAX_CHUNK == 0 else S

    def jax_mix(params, x, st):
        return jax_mamba.mamba_mix(cfg, params, x, st, chunk=chunk)
    jx = jnp.asarray(xz).astype(jdt)
    jst = None if state is None else jnp.asarray(state)
    if jst is None:
        (jout, jlast), vjp = jax.vjp(lambda a, b: jax_mix(a, b, None), jp, jx)
        jgrads = vjp((jnp.asarray(dout).astype(jdt), jnp.asarray(dh)))
    else:
        (jout, jlast), vjp = jax.vjp(jax_mix, jp, jx, jst)
        jgrads = vjp((jnp.asarray(dout).astype(jdt), jnp.asarray(dh)))

    saved = []

    def stand_in(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0, ckpt=False):
        out = sm.ssm_scan_torch(x, dt_pre, dt_bias, Bm, Cm, A_log, D, h0)
        saved.append(sm.ssm_checkpoints_torch(x, dt_pre, dt_bias, Bm, A_log,
                                              h0))
        return (*out, saved[-1]) if ckpt else out
    monkeypatch.setattr(sm, "_launch", stand_in)
    tp = {k: torch.from_numpy(v).to(dtype if k in low else torch.float32)
          .requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(xz).to(dtype).requires_grad_()
    tst = None if state is None \
        else torch.from_numpy(state).requires_grad_()
    before = sm.ssm_scan_bwd.launches
    out, last = _port_mix(tp, tx, tst)
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               **jax_tol(np.asarray(jout)))
    np.testing.assert_allclose(last.detach().numpy(), np.asarray(jlast),
                               rtol=1e-4, atol=1e-4)
    assert len(saved) == 1 and saved[0].shape == (B, sm.n_chunks(S), di,
                                                  ds)
    torch.autograd.backward(
        (out, last), (torch.from_numpy(dout).to(dtype),
                      torch.from_numpy(dh)))
    assert sm.ssm_scan_bwd.launches == before     # the CPU's plain version
    jparams, jxz = jgrads[0], jgrads[1]
    pairs = [(f"d{k}", tp[k].grad, jparams[k]) for k in p] + \
        [("dxz", tx.grad, jxz)]
    if tst is not None:
        pairs.append(("dstate", tst.grad, jgrads[2]))
    for name, got, want in pairs:
        want = np.asarray(want)
        assert str(got.dtype).split(".")[1] == str(want.dtype), name
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32),
                                   **jax_tol(want), err_msg=name)


def test_saved_states_are_the_chunks_entries():
    """``ssm_checkpoints_torch``: the state entering steps 0, CHUNK, 2
    CHUNK ..., h0 first (zeros without one), as the plain scan over the
    steps before reaches it."""
    g = np.random.default_rng(3)
    args = scan_inputs(2, 2 * sm.CHUNK + 5, 24, torch.float32, True, g)
    ckpt = sm.ssm_checkpoints_torch(*args[:4], args[5], args[7])
    assert ckpt.shape == (2, 3, 24, sm.DS) and ckpt.dtype == torch.float32
    torch.testing.assert_close(ckpt[:, 0], args[7])
    for j in (1, 2):
        cut = [a[:, :j * sm.CHUNK] if a is not None and a.dim() == 3
               and a.shape[1] == args[0].shape[1] else a for a in args]
        torch.testing.assert_close(ckpt[:, j], sm.ssm_scan_torch(*cut)[1])
    zeros = sm.ssm_checkpoints_torch(*args[:4], args[5], None)
    assert not zeros[:, 0].any()
    assert sm.ssm_checkpoints_torch(
        *[a[:, :0] if a.dim() == 3 else a for a in args[:4]], args[5]
    ).shape == (2, 0, 24, sm.DS)


def _meta_training_scan(dtype=torch.bfloat16):
    """jamba's training scan (2 x 4,096 tokens, d_inner 16,384, d_state
    16) as meta tensors, with its saved states and dout."""
    B, S, di, ds = 2, 4096, 16384, sm.DS
    m = dict(device="meta")
    return (torch.empty(B, S, di, dtype=dtype, **m),
            torch.empty(B, S, di, **m), torch.empty(di, dtype=dtype, **m),
            torch.empty(B, S, ds, **m), torch.empty(B, S, ds, **m),
            torch.empty(di, ds, **m), torch.empty(di, **m), None,
            torch.empty(B, sm.n_chunks(S), di, ds, **m),
            torch.empty(B, S, di, dtype=dtype, **m), None)


def test_ssm_scan_bwd_bound_at_jambas_training_scan():
    """The backward's bound at jamba's training scan (2, 4,096, 16,384,
    16), bfloat16 x, from shapes alone, counting what the gradient needs:
    the bytes (x, dout and dx 2 bytes, dt_pre and ddt_pre 4, a (b, t,
    channel); 537 MB of saved states read once; no partial sums: 2.42 GB)
    take 0.723 ms, above the exponentials (B·S·di·(ds + 1) = 2.28e9: each
    decay once and the softplus's, over the SFUs' 16 an SM a clock at 1.98
    GHz: 0.546 ms) and the float32 FLOPs (16 a state, the step back and
    the channel sums: 0.513 ms)."""
    args = _meta_training_scan()
    B, S, di = args[0].shape
    assert sm.bwd_exp_count(args[0], args[5]) == B * S * di * 17
    flops, n_bytes = sm.ssm_scan_bwd_cost(*args)
    assert sm.BWD_FLOPS_PER_STATE == 16
    assert flops == sm.BWD_FLOPS_PER_STATE * B * S * di * sm.DS
    # the saved states the bound counts: every 16th step's, whatever
    # spacing the kernel saves at (CHUNK; its denser states are its cost)
    assert sm.BOUND_CHUNK == 16
    assert 4 * B * -(-S // sm.BOUND_CHUNK) * di * sm.DS == 536_870_912
    assert 4 * args[8].numel() == 536_870_912 * sm.BOUND_CHUNK // sm.CHUNK
    assert 2.41e9 < n_bytes < 2.43e9
    b = sm.bwd_bound_ms(*args)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == b["bytes_ms"]
    assert round(b["bound_ms"], 3) == 0.723
    assert round(b["exps_ms"], 3) == 0.546
    assert round(b["flops_ms"], 3) == 0.513
    # the factory's registered cost is this one
    assert factory.kernel_cost("ssm_scan_bwd")(*args) == (flops, n_bytes)



CSRC = Path(sm.__file__).parent / "csrc"


def _constexprs(*sources) -> dict:
    """The namespace-level integer ``constexpr`` constants of ``sources``
    (in ``csrc/``, read in order, a later one seeing the earlier ones'),
    evaluated as Python integers."""
    env = {}
    for name in sources:
        text = (CSRC / name).read_text()
        for m in re.finditer(r"^constexpr int (\w+) = ([^;]+);", text,
                             re.M):
            env[m.group(1)] = eval(m.group(2).replace("/", "//"),
                                   {"__builtins__": {}}, dict(env))
    return env


def test_layout_mirrors_match_the_source():
    """ssm_scan's constants are the kernels': the state size and the
    saved-state spacing (ssm.cuh), the forward's block and tile (ssm.cu),
    the backward's threads a channel, channels a thread, warps and
    channels a block (ssm_bwd.cu), and the scratch shapes that follow."""
    head = _constexprs("ssm.cuh")
    fwd = _constexprs("ssm.cuh", "ssm.cu")
    bwd = _constexprs("ssm.cuh", "ssm_bwd.cu")
    assert (head["kDs"], head["kChunk"]) == (sm.DS, sm.CHUNK)
    assert (fwd["kChannels"], fwd["kTile"]) == (sm.CHANNELS, sm.TILE)
    assert fwd["kTile"] % head["kChunk"] == 0
    assert (bwd["kGroups"], bwd["kCh"], bwd["kWarps"], bwd["kChannels"]) \
        == (sm.BWD_LANES, sm.BWD_THREAD_CHANNELS, sm.BWD_WARPS,
            sm.BWD_CHANNELS)
    assert bwd["kK"] == sm.CHUNK
    assert bwd["kSt"] * bwd["kGroups"] == sm.DS
    # a thread owns one channel of its block for the per-channel work
    assert bwd["kChannels"] == bwd["kThreads"]
    assert sm.bwd_scratch_shapes(2, 4096, 16384) == {
        "part_bc": (2, 4096, 16384 // bwd["kChannels"], bwd["kSums"]),
        "part_ch": (2, 16384, bwd["kPartCh"])}


@pytest.mark.parametrize("B,S,di", [(2, 37, 200), (1, 8, 64), (3, 1, 72),
                                    (2, 0, 128)])
def test_launcher_allocates_the_scratch_the_kernel_takes(B, S, di,
                                                         monkeypatch):
    """``_launch_bwd`` hands the kernel part_bc (B, S, ceil(di /
    kChannels), 2 ds) and part_ch (B, di, ds + 2) float32, in the places
    of its C signature, and every output at its shape: the launch stood
    in by a recorder on CPU tensors."""
    bwd = _constexprs("ssm.cuh", "ssm_bwd.cu")
    made, calls = [], []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        made.append(t)
        return t
    monkeypatch.setattr(torch, "empty", recording_empty)
    monkeypatch.setattr(sm, "check_cuda", lambda *ts: ts[0].device)
    monkeypatch.setattr(sm._build, "launch",
                        lambda name, dev, *args: calls.append((name, args)))
    g = np.random.default_rng(B * 1000 + S)
    args = scan_inputs(B, S, di, torch.bfloat16, True, g)
    ckpt = torch.zeros(B, sm.n_chunks(S), di, sm.DS)
    dout = torch.zeros(B, S, di, dtype=torch.bfloat16)
    got = sm._launch_bwd(*args, ckpt, dout, torch.zeros(B, di, sm.DS))
    assert [name for name, _ in calls] == ["ssm_scan_bwd"]
    ptrs = calls[0][1]
    by_ptr = {t.data_ptr(): t for t in made if t.numel()}
    assert ptrs[10:15] == (B, S, di, sm.DS, 1)
    scratch = {"part_bc": (B, S, -(-di // bwd["kChannels"]), bwd["kSums"]),
               "part_ch": (B, di, bwd["kPartCh"])}
    for at, (name, shape) in zip((15, 16), scratch.items()):
        t = by_ptr.get(ptrs[at])
        if t is None:                       # an empty tensor (S = 0)
            assert 0 in shape
            continue
        assert tuple(t.shape) == shape and t.dtype == torch.float32, name
    dx, ddt_pre, ddt_bias, dBm, dCm, dA_log, dD, dh0 = got
    assert dx.shape == (B, S, di) and dx.dtype == torch.bfloat16
    assert ddt_pre.shape == (B, S, di) and dBm.shape == dCm.shape \
        == (B, S, sm.DS)
    assert dA_log.shape == (di, sm.DS) and dD.shape == ddt_bias.shape \
        == (di,) and dh0.shape == (B, di, sm.DS)
