"""The gradient of the sLSTM time scan, ``slstm_scan_bwd``, on the CPU:
the plain version (a reverse loop of ``_cell_bwd`` over the saved states)
against autograd through ``slstm_scan_torch``, at the hard shapes (S = 1,
S not a multiple of any tile, batches over ``MAX_BATCH`` rows, both
forms' head widths) in float32 and bfloat16, from the initial state and
from states a scan reached (the gauge of tests/test_torch_xlstm.py: never
random (c, n, m)); the max's tie and the clamp's cut one step at a time;
the saved states; the autograd Function's backward with the launches
stood in by the plain versions; the launch plan and the cost; the
backward cluster form's arithmetic (``slstm_cluster_bwd_torch``) against
the plain version and the JAX package's autodiff; the form chooser.

Tolerances: the plain version follows autograd op by op but adds a few
gradients in another order (the max's two branches, the carries), so in
float32 it sits within rtol 1e-5 / atol 1e-5 of the largest gradient; in
bfloat16 dwx and dr are rounded once from those float32 sums, so a
rounding may land one bfloat16 step (2^-8 relative) apart.  The kernel
against the plain version is a card test (tests/test_torch_gpu.py,
chip_smoke.py phase 20) at ``kernel_bwd_tol``, and so is its CPU mirror
here: the pieces and the grouping are the kernel's, the sums' order
within an mma and exp / log from another library are not.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import reduced_config as jax_reduced
from repro.models import xlstm as jx
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.kernels import factory
from repro_torch.kernels import slstm_scan as ss
from repro_torch.models import xlstm as tx

torch.set_num_threads(1)

SHAPES = [(1, 1, 1, 8), (2, 7, 2, 4), (3, 37, 2, 16), (2, 5, 1, 64),
          (17, 3, 1, 8), (2, 2, 2, 128)]
DTYPES = [torch.float32, torch.bfloat16]


def tol(want: torch.Tensor) -> dict:
    scale = float(want.float().abs().max()) if want.numel() else 0.0
    if want.dtype == torch.bfloat16:
        return dict(rtol=2 ** -7, atol=1e-5 * scale)
    return dict(rtol=1e-5, atol=1e-5 * scale)


def scan_inputs(B, S, nh, dh, dtype, seed=0, warm=3):
    """wx, r and a state the scan reaches after ``warm`` steps from the
    initial one (``warm`` 0: the initial state, m = -1e30)."""
    g = np.random.default_rng(seed)
    d = nh * dh
    wx = torch.from_numpy((g.normal(size=(B, S + warm, 4 * d)) * 0.8)
                          .astype(np.float32)).to(dtype)
    r = torch.from_numpy((g.normal(size=(nh, dh, 4 * dh)) * dh ** -0.5)
                         .astype(np.float32)).to(dtype)
    state = (torch.zeros(B, d), torch.zeros(B, d), torch.zeros(B, d),
             torch.full((B, d), -1e30))
    if warm:
        _, state = ss.slstm_scan_torch(wx[:, :warm], r, *state)
    return wx[:, warm:].contiguous(), r, [t.clone() for t in state]


def output_grads(B, S, d, seed=1):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.normal(size=s).astype(np.float32))
            for s in ((B, S, d),) + ((B, d),) * 4]


def autograd_grads(wx, r, state, grads):
    wg, rg = wx.clone().requires_grad_(), r.clone().requires_grad_()
    sg = [t.clone().requires_grad_() for t in state]
    y, carry = ss.slstm_scan_torch(wg, rg, *sg)
    total = sum((o * g).sum() for o, g in zip((y, *carry), grads))
    total.backward()
    return [wg.grad, rg.grad] + [t.grad for t in sg]


@pytest.mark.parametrize("warm", [0, 3], ids=["initial", "reached"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_slstm_scan_bwd_torch_is_autograds(shape, dtype, warm):
    B, S, nh, dh = shape
    wx, r, state = scan_inputs(B, S, nh, dh, dtype, warm=warm)
    grads = output_grads(B, S, nh * dh)
    want = autograd_grads(wx, r, state, grads)
    y, _, states = ss.slstm_states_torch(wx, r, *state)
    got = ss.slstm_scan_bwd_torch(wx, r, *state, y, states, *grads)
    assert [t.dtype for t in got] == [t.dtype for t in want]
    for name, a, b in zip(("dwx", "dr", "dh0", "dc0", "dn0", "dm0"), got,
                          want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a, b, **tol(b), msg=lambda m: f"{name}: "
                                   f"{m}")


def test_slstm_states_are_the_scans():
    """The saved states: step t's (c, n, m), the last one the final
    state, y the same as the plain scan's."""
    wx, r, state = scan_inputs(2, 6, 2, 8, torch.float32)
    y, carry, states = ss.slstm_states_torch(wx, r, *state)
    want_y, want_carry = ss.slstm_scan_torch(wx, r, *state)
    assert torch.equal(y, want_y)
    assert states.shape == (2, 3, 6, 16)
    for k in range(3):
        assert torch.equal(states[:, k, -1], want_carry[k + 1])
    _, part = ss.slstm_scan_torch(wx[:, :4], r, *state)
    for k in range(3):
        assert torch.equal(states[:, k, 3], part[k + 1])


def _one_step(prev, wx_t, r, dh, dc, dn, dm):
    """autograd of one slstm_cell step: (dgates as d wx_t, d prev)."""
    wg = wx_t.clone().requires_grad_()
    pg = [t.clone().requires_grad_() for t in prev]
    (h, c, n, m), _ = ss.slstm_cell(r, tuple(pg), wg)
    ((h * dh).sum() + (c * dc).sum() + (n * dn).sum()
     + (m * dm).sum()).backward()
    return wg.grad, [t.grad for t in pg[1:]]


def test_cell_bwd_splits_a_max_tie_and_stops_at_the_clamp():
    """``torch.maximum`` gives each side half of a tie's gradient and
    ``torch.clamp(n, min=1e-6)`` none below it: ``_cell_bwd`` on a step
    built to tie (ii set to log_sigmoid(ff) + m exactly) and on one whose
    n falls under the clamp (m far above ii, n 0) equals autograd."""
    B, nh, dh = 2, 1, 4
    d = nh * dh
    r = torch.zeros(nh, dh, 4 * dh)
    g = torch.Generator().manual_seed(0)
    zi, ff, oo = (torch.randn(B, d, generator=g) for _ in range(3))
    m = torch.randn(B, d, generator=g)
    tie = torch.nn.functional.logsigmoid(ff) + m        # t1, exactly
    clamp_m = torch.full((B, d), 30.0)
    cases = {
        "tie": ((torch.zeros(B, d), torch.randn(B, d, generator=g),
                 torch.rand(B, d, generator=g) + 0.5, m),
                torch.cat([zi, tie, ff, oo], -1)),
        "clamp": ((torch.zeros(B, d), torch.zeros(B, d), torch.zeros(B, d),
                   clamp_m), torch.cat([zi, torch.zeros(B, d),
                                        torch.full((B, d), 20.0), oo], -1)),
    }
    for name, (prev, wx_t) in cases.items():
        grads = [torch.randn(B, d, generator=g) for _ in range(4)]
        want_g, want_prev = _one_step(prev, wx_t, r, *grads)
        got_g, *got_prev = ss._cell_bwd(r, prev, wx_t, *grads)
        torch.testing.assert_close(got_g, want_g, rtol=1e-6, atol=1e-7,
                                   msg=name)
        for a, b in zip(got_prev, want_prev):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7,
                                       msg=name)
    # the cases do reach the edges they are named for
    (_, _, n, m_new), _ = ss.slstm_cell(r, cases["clamp"][0],
                                        cases["clamp"][1])
    assert bool((n < 1e-6).all())
    _, ii, ff_, _ = cases["tie"][1].chunk(4, -1)
    assert torch.equal(torch.nn.functional.logsigmoid(ff_) + m, ii)


def _rows_with_states(wx, r, h, c, n, m, states=None):
    """The grid-form launch stood in by the plain version, writing the
    saved states as the kernel does."""
    y, carry, st = ss.slstm_states_torch(wx, r, h, c, n, m)
    if states is not None:
        states.copy_(st)
    return y, carry


@pytest.mark.parametrize("B", [3, 17])
def test_kernel_backward_runs_the_gradient_op(B, monkeypatch):
    """A backward through ``_KernelScan`` (the card's path: the forward
    writes the states, the backward resolves the factory's
    ``slstm_scan_bwd`` with them), the launches stood in by the plain
    versions, equals autograd through the plain scan; a batch over
    MAX_BATCH rows saves its states launch by launch."""
    factory.get_kernel("slstm_scan_bwd")      # the registry, loaded
    calls = []

    def bwd(*args):
        calls.append(tuple(args[7].shape))
        return ss.slstm_scan_bwd_torch(*args)
    monkeypatch.setattr(ss, "_launch_rows", _rows_with_states)
    monkeypatch.setitem(factory._REGISTRY["slstm_scan_bwd"], "cuda", bwd)
    wx, r, state = scan_inputs(B, 5, 2, 4, torch.float32)
    grads = output_grads(B, 5, 8)
    want = autograd_grads(wx, r, state, grads)
    wg, rg = wx.clone().requires_grad_(), r.clone().requires_grad_()
    sg = [t.clone().requires_grad_() for t in state]
    y, *carry = ss._KernelScan.apply(wg, rg, *sg)
    sum((o * g).sum() for o, g in zip((y, *carry), grads)).backward()
    assert calls == [(B, 3, 5, 8)]
    for a, b in zip([wg.grad, rg.grad] + [t.grad for t in sg], want):
        torch.testing.assert_close(a, b, **tol(b))


def test_unused_final_state_grads_are_zeros(monkeypatch):
    """The model discards the final state: its gradients reach the
    backward as zeros."""
    factory.get_kernel("slstm_scan_bwd")
    seen = []

    def bwd(*args):
        seen.append([float(t.abs().sum()) for t in args[9:]])
        return ss.slstm_scan_bwd_torch(*args)
    monkeypatch.setattr(ss, "_launch_rows", _rows_with_states)
    monkeypatch.setitem(factory._REGISTRY["slstm_scan_bwd"], "cuda", bwd)
    wx, r, state = scan_inputs(2, 4, 1, 8, torch.float32)
    wg = wx.clone().requires_grad_()
    y, *_ = ss._KernelScan.apply(wg, r, *state)
    y.sum().backward()
    assert seen == [[0.0] * 4]
    torch.testing.assert_close(
        wg.grad, autograd_grads(wx, r, state, [torch.ones(2, 4, 8)]
                                + [torch.zeros(2, 8)] * 4)[0])


@pytest.mark.parametrize("B,dh,U,smem", [
    (16, 512, 16, 202_752), (4, 512, 16, 150_528), (1, 16, 16, 6_528),
    (2, 6, 2, 4_424)])
def test_bwd_plan(B, dh, U, smem):
    """U as the forward grid form's; the block's shared memory: r's
    columns (rows padded by one), h_{t-1}, the partial sums and the gate
    gradients."""
    assert ss.bwd_plan(B, dh) == (U, smem)


def test_bwd_plan_refuses():
    with pytest.raises(ValueError, match="batch rows"):
        ss.bwd_plan(17, 64)
    with pytest.raises(ValueError, match="shared memory"):
        ss.bwd_plan(16, 1024)


def test_slstm_scan_bwd_cost():
    """16·B·S·d·dh FLOPs (dh_{t-1}'s and dr's products), x PIECES in
    bfloat16; the inputs read and the gradients written once."""
    B, S, nh, dh = 2, 5, 2, 8
    d = nh * dh
    meta = dict(device="meta")
    args = [torch.empty(B, S, 4 * d, dtype=torch.bfloat16, **meta),
            torch.empty(nh, dh, 4 * dh, dtype=torch.bfloat16, **meta)] + \
        [torch.empty(B, d, **meta)] * 4 + \
        [torch.empty(B, S, d, **meta), torch.empty(B, 3, S, d, **meta),
         torch.empty(B, S, d, **meta)] + [torch.empty(B, d, **meta)] * 4
    flops, n_bytes = factory.kernel_cost("slstm_scan_bwd")(*args)
    assert flops == 16 * B * S * d * dh * ss.PIECES
    assert n_bytes == (2 * 2 * B * S * 4 * d + 2 * 2 * nh * dh * 4 * dh
                       + 4 * (5 * B * S * d + 12 * B * d))


def test_xlstm_gradients_through_the_kernel_path(monkeypatch):
    """The reduced xlstm's sLSTM block: gradients with the scan on its
    card path (forward and backward launches stood in by the plain
    versions) equal the plain path's, input and every weight."""
    import dataclasses

    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.models import xlstm
    cfg = dataclasses.replace(reduced_config(get_config("xlstm-1.3b")),
                              dtype="float32")
    g = torch.Generator().manual_seed(0)
    p = xlstm.init_slstm_params(cfg, torch.float32, g, "cpu")
    x = torch.randn(2, 9, cfg.d_model, generator=g)

    def grads():
        pp = {k: v.clone().requires_grad_() for k, v in p.items()}
        xx = x.clone().requires_grad_()
        delta, _ = xlstm.slstm_block(cfg, pp, xx)
        delta.square().sum().backward()
        return [xx.grad] + [pp[k].grad for k in sorted(pp)]
    want = grads()
    factory.get_kernel("slstm_scan")
    monkeypatch.setattr(ss, "_launch_rows", _rows_with_states)
    monkeypatch.setitem(factory._REGISTRY["slstm_scan"], "cuda",
                        lambda *a: (lambda y, *c: (y, tuple(c)))(
                            *ss._KernelScan.apply(*a)))
    got = grads()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def _close_to(got, want, what):
    for name, a, b in zip(("dwx", "dr", "dh0", "dc0", "dn0", "dm0"), got,
                          want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a, b, **ss.kernel_bwd_tol(b),
                                   msg=lambda m: f"{what} {name}: {m}")


@pytest.mark.parametrize("warm", [0, 3], ids=["initial", "reached"])
@pytest.mark.parametrize("shape", [
    (2, 9, 4, 16),        # the reduced xlstm's heads: one block, one tile
    (1, 1, 4, 64),        # S of 1: the gates from h0 alone
    (6, 17, 1, 64),       # rows past one cluster's 4
    (3, 37, 2, 128),
    (2, 33, 4, 512),      # xlstm-1.3b's head: 16 blocks, 4 m-tiles a warp
    (2, 512, 4, 64)],     # a long S
    ids=str)
def test_cluster_bwd_mirror_is_the_plain_backward(shape, warm):
    """The backward cluster form's arithmetic (gates from h's two
    bfloat16 pieces, dgates' two pieces against r, the warps' and the
    blocks' partial sums in the kernel's order) within ``kernel_bwd_tol``
    of the plain backward on the same saved forward."""
    B, S, nh, dh = shape
    wx, r, state = scan_inputs(B, S, nh, dh, torch.bfloat16, warm=warm)
    grads = output_grads(B, S, nh * dh)
    y, _, states = ss.slstm_states_torch(wx, r, *state)
    args = (wx, r, *state, y, states, *grads)
    _close_to(ss.slstm_cluster_bwd_torch(*args),
              ss.slstm_scan_bwd_torch(*args), f"mirror at {shape}")


@pytest.mark.parametrize("B,S,nh,dh", [(2, 24, 4, 16), (3, 17, 2, 64),
                                       (1, 5, 4, 512)])
def test_cluster_bwd_mirror_on_reduced_xlstm(B, S, nh, dh):
    """The mirror on the reduced xlstm's sLSTM layer (its initial weights
    in bfloat16, its initial state, then the state that scan left) and on
    heads the cluster form takes: within ``kernel_bwd_tol`` of the plain
    backward."""
    cfg = dataclasses.replace(reduced_config(get_config("xlstm-1.3b")),
                              d_model=nh * dh, n_heads=nh)
    g = torch.Generator().manual_seed(B * S + dh)
    p = tx.init_slstm_params(cfg, torch.bfloat16, g, "cpu")
    x = torch.randn(B, S, cfg.d_model, generator=g).bfloat16()
    wx = x @ p["w_gates"] + p["b_gates"]
    st = tx.init_slstm_state(cfg, B, "cpu")
    state = [st[k] for k in ("h", "c", "nn", "mm")]
    grads = output_grads(B, S, cfg.d_model, seed=B + S)
    for _ in range(2):
        y, carry, states = ss.slstm_states_torch(wx, p["r_gates"], *state)
        args = (wx, p["r_gates"], *state, y, states, *grads)
        _close_to(ss.slstm_cluster_bwd_torch(*args),
                  ss.slstm_scan_bwd_torch(*args), f"reduced at {B, S}")
        state = list(carry)


@pytest.mark.parametrize("B,S,nh,dh", [(2, 7, 2, 64), (2, 32, 4, 16)])
def test_cluster_bwd_mirror_matches_jax_autodiff(B, S, nh, dh):
    """The mirror against ``jax.vjp`` of the JAX package's sLSTM scan
    (``models.xlstm._slstm_scan``: per-step and chunked lax.scan, r as
    float32 of the same bfloat16 values), from a reached state, with the
    same output gradients: within ``kernel_bwd_tol``."""
    wx, r, state = scan_inputs(B, S, nh, dh, torch.bfloat16)
    wx = wx.float()
    grads = output_grads(B, S, nh * dh)
    cfg = dataclasses.replace(jax_reduced(jax_get_config("xlstm-1.3b")),
                              d_model=nh * dh, n_heads=nh)

    def scan(wx, r, h, c, n, m):
        y, st = jx._slstm_scan(cfg, {"r_gates": r}, wx,
                               {"h": h, "c": c, "nn": n, "mm": m})
        return y, st["h"], st["c"], st["nn"], st["mm"]
    prims = [jnp.asarray(t.float().numpy()) for t in (wx, r, *state)]
    _, vjp = jax.vjp(scan, *prims)
    want = [torch.from_numpy(np.array(t)) for t in
            vjp(tuple(jnp.asarray(t.numpy()) for t in grads))]
    y, _, states = ss.slstm_states_torch(wx, r, *state)
    got = list(ss.slstm_cluster_bwd_torch(wx, r, *state, y, states, *grads))
    for name, a, b in zip(("dwx", "dr", "dh0", "dc0", "dn0", "dm0"), got,
                          want):
        torch.testing.assert_close(a.float(), b, **ss.kernel_bwd_tol(a),
                                   msg=lambda m: f"{name}: {m}")


def test_cluster_bwd_mirror_refuses_float32_weights():
    wx, r, state = scan_inputs(1, 2, 1, 64, torch.float32)
    y, _, states = ss.slstm_states_torch(wx, r, *state)
    with pytest.raises(TypeError, match="bfloat16"):
        ss.slstm_cluster_bwd_torch(wx, r, *state, y, states,
                                   *output_grads(1, 2, 64))


@pytest.mark.parametrize("dtype,B,nh,dh,want", [
    (torch.bfloat16, 2, 4, 512, "cluster"),   # xlstm-1.3b's training scan
    (torch.bfloat16, 1, 4, 64, "cluster"),
    (torch.bfloat16, 17, 2, 128, "cluster"),  # rows past 16: more clusters
    (torch.bfloat16, 4 * 65535, 1, 64, "cluster"),
    (torch.bfloat16, 4 * 65535 + 1, 1, 64, "grid"),  # past the grid's rows
    (torch.float32, 2, 4, 512, "grid"),       # float32 r: the grid form
    (torch.bfloat16, 2, 4, 16, "grid"),       # the reduced xlstm's heads
    (torch.bfloat16, 2, 4, 96, "grid"),       # not a multiple of 64
    (torch.bfloat16, 2, 4, 1024, "grid"),     # 32 blocks: past a cluster
    (torch.float16, 2, 4, 512, "grid")])
def test_slstm_scan_bwd_form(dtype, B, nh, dh, want):
    """The backward's form is a function of the shape: the cluster form
    where the forward's runs (bfloat16, dh a multiple of 64 up to 512),
    a grid row of clusters a ``BWD_ROWS`` rows; the grid form else."""
    assert ss.bwd_form(dtype, B, nh, dh) == want
