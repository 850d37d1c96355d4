"""The gradient of the MoE expert products, ``gmm_bwd``, on the CPU: the
plain version against autograd through ``gmm_torch``, the split plan of
dw's sum, the autograd Function's backward (with the kernels' launches
stood in by the plain versions, as on a card the kernels run), the
registered cost, and the MoE FFN's gradients through it.

Tolerances: ``gmm_bwd_torch`` takes autograd's own products (float32
einsums, one cast), so it is held to autograd bit for bit in float32 and
in bfloat16.  The kernel against the plain version is a card test
(tests/test_torch_gpu.py, chip_smoke.py phase 20) at ``gm.kernel_tol``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import factory
from repro_torch.kernels import gmm as gm

torch.set_num_threads(1)

# the hard shapes: C of 0 and 1 rows, E of 1, odd C / d / f short of the
# 128-wide tiles and the 32-deep k tile, a C split over blocks
SHAPES = [(1, 0, 8, 8), (1, 1, 8, 8), (2, 1, 5, 3), (3, 33, 17, 9),
          (1, 129, 130, 131), (2, 300, 24, 40), (4, 700, 16, 8)]
DTYPES = [torch.float32, torch.bfloat16]


def _inputs(E, C, d, f, dtype, seed=0):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.normal(size=s).astype(np.float32)).to(dtype)
            for s in ((E, C, d), (E, d, f), (E, C, f))]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gmm_bwd_torch_is_autograds(shape, dtype):
    xe, w, dy = _inputs(*shape, dtype)
    xg, wg = xe.clone().requires_grad_(), w.clone().requires_grad_()
    gm.gmm_torch(xg, wg).backward(dy)
    dx, dw = gm.gmm_bwd_torch(xe, w, dy)
    assert dx.dtype == dtype and dw.dtype == dtype
    assert torch.equal(dx, xg.grad) and torch.equal(dw, wg.grad)


def test_gmm_bwd_refuses_bad_shapes():
    xe, w, dy = _inputs(2, 4, 3, 5, torch.float32)
    with pytest.raises(ValueError, match="dy"):
        gm.gmm_bwd(xe, w, dy[:, :3])
    with pytest.raises(ValueError):
        gm.gmm_bwd(xe, w[:, :2], dy)


@pytest.mark.parametrize("E,C,d,f,want", [
    (64, 1920, 2048, 1408, 1920),    # moonshot's step: tiles enough
    (1, 4096, 128, 128, 256),        # one tile: 16 splits of 256 rows
    (2, 700, 16, 8, 352),            # 2 tiles, C / 256 caps the splits
    (2, 300, 24, 40, 300),           # under two splits of 256 rows
    (3, 255, 40, 40, 255),           # C under BWD_MIN_ROWS: one split
    (1, 0, 8, 8, 1)])
def test_bwd_chunk_plan(E, C, d, f, want):
    """dw's split: one split where its tiles fill the card twice, else
    enough splits of at least BWD_MIN_ROWS rows (a multiple of 32)."""
    chunk = gm.bwd_chunk(E, C, d, f)
    assert chunk == want
    splits = -(-C // chunk) if C else 1
    assert chunk >= C or (chunk % 32 == 0 and chunk >= gm.BWD_MIN_ROWS)
    assert E * splits <= 65535
    assert (splits - 1) * chunk < max(C, 1)       # no empty split


def test_kernel_backward_runs_the_gradient_op(monkeypatch):
    """A backward through ``_KernelGmm`` (the card's path) resolves the
    factory's ``gmm_bwd`` with the saved x and w and the output's
    gradient; with the launches stood in by the plain versions it equals
    autograd through the plain version."""
    calls = []

    def bwd(xe, w, dy):
        calls.append(tuple(dy.shape))
        return gm.gmm_bwd_torch(xe, w, dy)
    factory.get_kernel("gmm_bwd")             # the registry, loaded
    monkeypatch.setattr(gm, "_launch", gm.gmm_torch)
    monkeypatch.setitem(factory._REGISTRY["gmm_bwd"], "cuda", bwd)
    xe, w, dy = _inputs(2, 40, 16, 8, torch.float32)
    xg, wg = xe.clone().requires_grad_(), w.clone().requires_grad_()
    gm._KernelGmm.apply(xg, wg).backward(dy)
    assert calls == [(2, 40, 8)]
    want_x, want_w = xe.clone().requires_grad_(), w.clone().requires_grad_()
    gm.gmm_torch(want_x, want_w).backward(dy)
    assert torch.equal(xg.grad, want_x.grad)
    assert torch.equal(wg.grad, want_w.grad)


def test_gmm_bwd_cost():
    """4·E·C·d·f FLOPs; x, w, dy read and dx, dw written once."""
    xe, w, dy = (torch.empty(s, dtype=torch.bfloat16, device="meta")
                 for s in ((3, 10, 7, ), (3, 7, 5), (3, 10, 5)))
    flops, n_bytes = factory.kernel_cost("gmm_bwd")(xe, w, dy)
    assert flops == 4 * 3 * 10 * 7 * 5
    assert n_bytes == 2 * (2 * 3 * 10 * 7 + 2 * 3 * 7 * 5 + 3 * 10 * 5)
    assert factory.available_impls("gmm_bwd") == ("cuda", "torch")


def test_moe_ffn_gradients_through_the_kernel_path(monkeypatch):
    """The reduced moonshot's MoE FFN: gradients with the gmm wrapper on
    its card path (launches stood in by the plain versions) equal those
    of the plain path, input and every weight."""
    import dataclasses

    from repro_torch.configs.registry import get_config, reduced_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(reduced_config(get_config(
        "moonshot-v1-16b-a3b")), dtype="float32")
    g = torch.Generator().manual_seed(0)
    p = moe.init_moe_params(cfg, torch.float32, g, "cpu")
    x = torch.randn(2, 12, cfg.d_model, generator=g)

    def grads():
        pp = {k: v.clone().requires_grad_() for k, v in p.items()}
        xx = x.clone().requires_grad_()
        moe.moe_ffn(cfg, pp, xx).square().sum().backward()
        return [xx.grad] + [pp[k].grad for k in sorted(pp)]
    want = grads()
    monkeypatch.setattr(gm, "_launch", gm.gmm_torch)
    monkeypatch.setitem(factory._REGISTRY["gmm"], "cuda",
                        lambda xe, w: gm._KernelGmm.apply(xe, w))
    got = grads()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("E,C,d,f,want", [
    (64, 960, 2048, 1408, 960),      # moonshot's gate / up: 6,144 tiles
    (64, 960, 1408, 2048, 960),      # its down product: 5,632 tiles
    (1, 4096, 128, 128, 256),        # one tile: 16 splits of 256 rows
    (2, 700, 16, 8, 384),            # 2 tiles, C / 256 caps the splits:
                                     # 350 rows rounded to the 64-row slice
    (3, 1000, 40, 72, 384),          # 3 tiles, 3 splits
    (2, 300, 24, 40, 300),           # under two splits of 256 rows
    (1, 0, 8, 8, 1)])
def test_bwd_chunk_plan_wgmma(E, C, d, f, want):
    """dw's split in the wgmma form: tiles of 128 x 256, each split a
    multiple of the 64-row k slice, at least BWD_MIN_ROWS rows."""
    chunk = gm.bwd_chunk(E, C, d, f, "wgmma")
    assert chunk == want
    splits = -(-C // chunk) if C else 1
    assert chunk >= C or (chunk % 64 == 0 and chunk >= gm.BWD_MIN_ROWS)
    assert (splits - 1) * chunk < max(C, 1)       # no empty split


@pytest.mark.parametrize("dtype,d,f,aligned,want", [
    (torch.bfloat16, 2048, 1408, True, "wgmma"),   # moonshot's products
    (torch.bfloat16, 1408, 2048, True, "wgmma"),
    (torch.bfloat16, 8, 8, True, "wgmma"),
    (torch.bfloat16, 130, 136, True, "wmma"),      # d off the 8 values
    (torch.bfloat16, 136, 131, True, "wmma"),      # f off the 8 values
    (torch.bfloat16, 2048, 1408, False, "wmma"),   # a pointer off 16 bytes
    (torch.float32, 2048, 1408, True, "simt"),
    (torch.float32, 5, 3, False, "simt")])
def test_gmm_bwd_form(dtype, d, f, aligned, want):
    """The backward's form is a function of the dtype and the rows: the
    TMA / wgmma form for bfloat16 where TMA reads the rows (the forward's
    rule), WMMA for other bfloat16, the CUDA cores for float32."""
    assert gm.bwd_form(dtype, d, f, aligned) == want
