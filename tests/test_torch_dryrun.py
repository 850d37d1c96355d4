"""The dry run (``repro_torch.launch.dryrun``) and the sharded steps.

  * ``run_cell`` on reduced configs on a faked 2 x 2 ``("data", "model")``
    and 2 x 2 x 2 ``("pod", "data", "model")`` mesh (the ``fake``
    process-group backend, fake tensors on the CPU) for a dense (yi-6b),
    an MoE (moonshot), the xLSTM, the hybrid (jamba), the encoder-decoder
    (whisper) and the VLM backbone (qwen2-vl), train steps: every record
    ``ok`` with the JAX record's keys; a card's product FLOPs (the
    matrix products and the kernels' registered costs) times the cards
    within 1.0x-1.05x of the unsharded step's, and all its FLOPs times
    the cards at least the unsharded step's (ops replicated over
    ``model`` raise that total, so it has no upper bound at these widths);
    a tensor-parallel cell has collectives.
  * The mesh round: ``ok`` with tensor parallelism inside a trainer; in
    the pure-DP regime (the trainers take every axis) its only
    collectives are the commit's all-reduces, whose payload is the
    float32 weights and the score, once an axis.
  * Four ``gloo`` processes (``file://`` init) on a real 2 x 2 mesh, in
    float32: reduced yi-6b's and moonshot's ``build_cell`` train steps
    equal the unsharded step; ``weighted_psum_tree`` equals the JAX
    package's ``weighted_average_tree``; the mesh round with T = 2
    trainers equals the one-card ``build_fl_round`` in loss, merged
    weights and distances, and its digest is ``digest_tree`` of the
    gathered merged weights.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.launch import dryrun

ARCHS = ["yi-6b", "moonshot-v1-16b-a3b", "xlstm-1.3b",
         "jamba-1.5-large-398b", "whisper-medium", "qwen2-vl-72b"]
MESHES = {"2x2": (2, 2), "2x2x2": (2, 2, 2)}
TRAIN = ShapeConfig("train_small", 16, 8, "train")
#: the JAX record's keys (src/repro/launch/dryrun.py), ``trace_s`` for
#: its lower / compile times and ``counted`` for ``xla_cost``
RECORD = {"status", "kind", "n_chips", "memory", "fits_hbm", "walk",
          "roofline", "trace_s", "counted"}
WALK = {"flops", "bytes", "collective_bytes", "collectives",
        "collective_counts", "custom_calls"}
ROOFLINE = {"compute_s", "memory_s", "collective_s", "dominant",
            "step_time_lb_s", "model_flops_global", "model_flops_per_chip",
            "useful_flops_ratio", "roofline_fraction"}


@pytest.fixture(scope="module", autouse=True)
def _own_group():
    """The fake group is the process's default group while this module
    runs, and gone after it."""
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _cfg(arch):
    return reduced_config(get_config(arch))


def _unsharded(cfg, shape):
    """The same train step with no mesh, counted on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.hlo_cost import counting
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models.model import Model
    from repro_torch.optim.optimizers import make_optimizer, spec_for_config
    with FakeTensorMode():
        model = Model(cfg, "cpu")
        params = {k: torch.empty(v.shape, dtype=v.dtype) for k, v in
                  model.params_shape().items()}
        opt = make_optimizer(spec_for_config(cfg),
                             groups=model.param_groups(params))
        batch = {k: torch.empty(v.shape, dtype=v.dtype) for k, v in
                 model.input_specs(shape).items()}
        state = opt.init(params)
        with counting() as cost:
            build_train_step(model, opt)(params, state, batch)
    return cost


@pytest.fixture(scope="module")
def records():
    return {}


def _record(records, arch, mesh):
    key = (arch, mesh)
    if key not in records:
        records[key] = dryrun.run_cell(arch, "train_small", mesh, False,
                                       device="cpu", cfg=_cfg(arch),
                                       shape=TRAIN, mesh_shape=MESHES[mesh])
    return records[key]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_is_ok_with_the_jax_records_keys(records, arch, mesh):
    rec = _record(records, arch, mesh)
    assert rec["status"] == "ok", rec.get("error")
    assert RECORD <= set(rec) and WALK <= set(rec["walk"])
    assert ROOFLINE <= set(rec["roofline"])
    assert rec["n_chips"] == int(np.prod(MESHES[mesh]))
    assert rec["memory"]["peak_bytes_est"] > rec["memory"]["weight_bytes"] \
        > 0 and rec["fits_hbm"]
    # tensor parallelism over "model": activations and weights move
    assert rec["walk"]["collective_counts"] and \
        rec["walk"]["collective_bytes"] > 0
    assert rec["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_per_card_flops_times_cards_cover_the_unsharded_step(records, arch,
                                                             mesh):
    rec = _record(records, arch, mesh)
    assert rec["status"] == "ok", rec.get("error")
    whole = _unsharded(_cfg(arch), TRAIN)
    n = rec["n_chips"]
    dots = rec["counted"]["dot_flops"] * n / whole.dot_flops
    assert 1.0 - 1e-9 <= dots <= 1.05, dots
    assert rec["walk"]["flops"] * n >= whole.flops * (1 - 1e-9)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fl_round_cell(mesh):
    cfg = _cfg("yi-6b")
    rec = dryrun.run_fl_round_cell("yi-6b", mesh, 2, 16, False,
                                   device="cpu", cfg=cfg,
                                   mesh_shape=MESHES[mesh], local_batch=2)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_trainers"] == int(np.prod(MESHES[mesh][:-1]))
    assert rec["walk"]["collective_counts"].get("all-reduce")
    # the pure-DP regime: a trainer a rank, its weights whole on it; the
    # commit's all-reduces, one an axis, are the round's only collectives
    axes = ("pod", "data", "model")[-len(MESHES[mesh]):]
    rec = dryrun.run_fl_round_cell("yi-6b", mesh, 2, 16, False,
                                   device="cpu", cfg=cfg,
                                   mesh_shape=MESHES[mesh], local_batch=2,
                                   trainer_axes=axes)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["n_trainers"] == rec["n_chips"]
    assert set(rec["walk"]["collective_counts"]) == {"all-reduce"}
    from repro_torch.models.model import Model
    n_weights = sum(v.numel() for v in
                    Model(cfg, "cpu").params_shape().values())
    assert rec["walk"]["collective_bytes"] == len(axes) * 4 * (n_weights
                                                               + 1)


def test_dryrun_cli_writes_a_record_a_cell(tmp_path, monkeypatch):
    real = dryrun.run_cell

    def small(arch, shape, mesh, verbose=True, **kw):
        return real(arch, "train_small", mesh, verbose, device="cpu",
                    cfg=_cfg(arch), shape=TRAIN, mesh_shape=(2, 2))
    monkeypatch.setattr(dryrun, "run_cell", small)
    dryrun.main(["--arch", "yi-6b", "--shape", "train_4k", "--mesh", "both",
                 "--out", str(tmp_path), "--device", "cpu"])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["yi-6b__train_4k__multi.json",
                     "yi-6b__train_4k__single.json"]
    # a skipped cell is recorded as skipped (cell_is_skipped), not run
    rec = real("yi-6b", "long_500k", "single", False, device="cpu")
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]


# -----------------------------------------------------------------------------
# Four gloo processes on a real 2 x 2 mesh
# -----------------------------------------------------------------------------
def _rank(rank, world, init, out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    from repro_torch.core.aggregation import weighted_psum_tree
    from repro_torch.fl.round import (FLRoundSpec, build_fl_round,
                                      build_fl_round_cell, digest_tree)
    from repro_torch.launch.mesh import make_train_mesh
    from repro_torch.launch.steps import build_cell, build_train_step, place
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import (OptimizerSpec, make_optimizer,
                                              spec_for_config)
    mesh = make_train_mesh(2, 2, device="cpu")
    result = {}
    g = torch.Generator().manual_seed(1)
    for arch in ("yi-6b", "moonshot-v1-16b-a3b"):
        cfg = dataclasses.replace(_cfg(arch), dtype="float32")
        cell = build_cell(cfg, ShapeConfig("t", 16, 4, "train"), mesh,
                          device="cpu")
        base = build_model(cfg, "cpu")
        params = base.train_params(base.init_params(0))
        opt = make_optimizer(spec_for_config(cfg),
                             groups=base.param_groups(params))
        state = opt.init(params)
        toks = torch.randint(0, cfg.vocab_size, (4, 17), generator=g,
                             dtype=torch.int32)
        batch = {"tokens": toks[:, :-1].contiguous(),
                 "labels": toks[:, 1:].contiguous()}
        args = [place(cell.model.ctx, t, s)
                for t, s in zip((params, state, batch), cell.specs)]
        p1, _, m1 = cell.step(*args)
        p2, _, m2 = build_train_step(base, opt)(params, state, batch)
        result[arch] = {
            "loss": (float(m1["loss"].full_tensor()), float(m2["loss"])),
            "grad_norm": (float(m1["grad_norm"].full_tensor()),
                          float(m2["grad_norm"])),
            "params": {k: (p1[k].full_tensor(), p2[k]) for k in p2},
            "lr": opt_lr(cfg)}
    # Eq. 1 over the data axis: rank (d, m) holds trainer d's leaves
    d = mesh.get_local_rank("data")
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * d,
            "b": torch.full((4,), 1.0 + d, dtype=torch.bfloat16)}
    merged = weighted_psum_tree(tree, torch.tensor([0.25, 0.75])[d],
                                mesh.get_group("data"))
    result["psum"] = merged
    # the mesh round, T = 2 trainers (the data axis), TP 2 inside each
    cfg = dataclasses.replace(_cfg("yi-6b"), dtype="float32",
                              optimizer="sgdm")
    model = build_model(cfg, "cpu", mesh=mesh)
    base = build_model(cfg, "cpu")
    params = base.train_params(base.init_params(0))
    opt = make_optimizer(OptimizerSpec(name="sgdm", lr=0.05))
    spec = FLRoundSpec(n_trainers=2, h_local_steps=2, local_batch=2)
    cell = build_fl_round_cell(model, opt, spec, mesh, 8, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 2, 2, 9), generator=g,
                         dtype=torch.int32)
    batches = {"tokens": toks[..., :-1].contiguous(),
               "labels": toks[..., 1:].contiguous()}
    scores = torch.tensor([0.7, 0.3])
    params_T = {k: v.expand((2,) + v.shape).clone()
                for k, v in params.items()}
    st = opt.init(params)
    opt_T = {"m": {k: v.expand((2,) + v.shape).clone()
                   for k, v in st["m"].items()},
             "step": st["step"].expand(2).clone()}
    args = [place(model.ctx, t, s) for t, s in
            zip((params_T, opt_T, scores, batches), cell.specs)]
    pT, _, m = cell.step(*args)
    pR, _, mR = build_fl_round(base, opt, spec)(params_T, opt_T, scores,
                                                batches)
    merged = {k: v.full_tensor()[0] for k, v in pT.items()}
    result["round"] = {
        "loss": (float(m["loss"].full_tensor()), float(mR["loss"])),
        "distances": (m["distances"].full_tensor(), mR["distances"]),
        "params": {k: (merged[k], pR[k][0]) for k in pR},
        "digest": (int(m["digest"]), int(digest_tree(merged)))}
    if rank == 0:
        torch.save(result, out)
    dist.destroy_process_group()


def opt_lr(cfg) -> float:
    from repro_torch.optim.optimizers import spec_for_config
    return spec_for_config(cfg).lr


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    """The four ranks' run (rank 0's results), about 10 s."""
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("gloo")
    out = str(d / "result.pt")
    mp.start_processes(_rank, args=(4, f"file://{d}/pg", out), nprocs=4,
                       start_method="spawn")
    return torch.load(out, weights_only=False)


@pytest.mark.parametrize("arch", ["yi-6b", "moonshot-v1-16b-a3b"])
def test_sharded_train_step_equals_the_unsharded_step(gloo, arch):
    r = gloo[arch]
    # the same loss: the forward's float32 sums split over the ranks
    np.testing.assert_allclose(*r["loss"], rtol=1e-6)
    np.testing.assert_allclose(*r["grad_norm"], rtol=1e-5)
    # adamw's first step moves a weight by lr * g / (|g| + eps): a
    # gradient near 0 may take either sign on either side, so the weights
    # are held to 2 lr, and most of them far closer
    for key, (got, want) in r["params"].items():
        err = (got - want).abs()
        assert float(err.max()) <= 2 * r["lr"], key
        assert float(err.median()) <= 1e-6, key


def test_weighted_psum_tree_equals_jax(gloo):
    import jax.numpy as jnp

    from repro.core.aggregation import weighted_average_tree
    stacked = {"w": np.stack([np.arange(6, dtype=np.float32).reshape(2, 3)
                              + 10 * d for d in (0, 1)]),
               "b": np.stack([np.full((4,), 1.0 + d, np.float32)
                              for d in (0, 1)]).astype(jnp.bfloat16)}
    want = weighted_average_tree(stacked, jnp.asarray([0.25, 0.75]))
    got = gloo["psum"]
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               rtol=1e-6)
    assert got["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["b"].float().numpy(),
                                  np.asarray(want["b"], np.float32))


def test_mesh_round_equals_the_one_card_round(gloo):
    r = gloo["round"]
    np.testing.assert_allclose(*r["loss"], rtol=1e-6)
    np.testing.assert_allclose(r["distances"][0].numpy(),
                               r["distances"][1].numpy(), rtol=1e-4)
    for key, (got, want) in r["params"].items():
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_mesh_round_digest_is_the_merged_weights_digest(gloo):
    got, want = gloo["round"]["digest"]
    assert got == want and 0 <= got < 2 ** 32


def test_kernels_take_their_fake_forms_under_fake_tensor_mode():
    """On fake tensors the model path's wrappers take their kernel's
    route with the launch replaced by its fake form: outputs (and, where
    autograd records, gradients) of the kernel's shapes and dtypes, no
    launch counted, and never the plain version (at 32,768 tokens the
    plain attention's float32 scores alone would be 128 GiB)."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

    from repro_torch.analysis.hlo_cost import counting
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gmm as gm
    from repro_torch.kernels import slstm_scan as ss
    from repro_torch.kernels import ssm_scan as sm
    from repro_torch.kernels.factory import get_kernel
    bf16 = torch.bfloat16
    launches = (fa.flash_attention.launches, gm.gmm.launches,
                ss.slstm_scan.launches, sm.ssm_scan.launches)
    with FakeTensorMode(), counting() as cost:
        q = torch.empty(1, 32768, 32, 128, dtype=bf16, requires_grad=True)
        k = torch.empty(1, 32768, 4, 128, dtype=bf16, requires_grad=True)
        o = get_kernel("flash_attention")(q, k, k, causal=True)
        dq, dk = torch.autograd.grad(o.float().sum(), (q, k))
        xe = torch.empty(8, 512, 64, dtype=bf16, requires_grad=True)
        w = torch.empty(8, 64, 96, dtype=bf16, requires_grad=True)
        y = get_kernel("gmm")(xe, w)
        dx, dw = torch.autograd.grad(y.float().sum(), (xe, w))
        x = torch.empty(2, 64, 256, dtype=bf16)
        f32 = dict(dtype=torch.float32)
        out, h = get_kernel("ssm_scan")(
            x, torch.empty(2, 64, 256, **f32), torch.empty(256, dtype=bf16),
            torch.empty(2, 64, 16, **f32), torch.empty(2, 64, 16, **f32),
            torch.empty(256, 16, **f32), torch.empty(256, **f32))
        st = [torch.empty(2, 128, **f32) for _ in range(4)]
        ys, carry = get_kernel("slstm_scan")(
            torch.empty(2, 16, 512, dtype=bf16),
            torch.empty(2, 64, 256, dtype=bf16), *st)
    for t, shape, dtype in ((o, q.shape, bf16), (dq, q.shape, bf16),
                            (dk, k.shape, bf16), (y, (8, 512, 96), bf16),
                            (dx, xe.shape, bf16), (dw, w.shape, bf16),
                            (out, x.shape, bf16), (h, (2, 256, 16),
                                                   torch.float32),
                            (ys, (2, 16, 128), torch.float32)):
        assert isinstance(t, FakeTensor) and t.shape == shape \
            and t.dtype == dtype
    assert len(carry) == 4
    assert {c.split(" ", 1)[0] for c in cost.custom_calls} == {
        "flash_attention", "flash_attention_bwd", "gmm", "gmm_bwd",
        "ssm_scan", "slstm_scan"}
    assert launches == (fa.flash_attention.launches, gm.gmm.launches,
                        ss.slstm_scan.launches, sm.ssm_scan.launches)


def _attention(kernel, shape, dtype):
    q = torch.empty(shape, dtype=dtype)
    kernel("flash_attention")(q, q, q, causal=True)


def _empty(*shapes, dtype=torch.float32):
    return [torch.empty(s, dtype=dtype) for s in shapes]


_REFUSED = {
    # head widths past the kernel's or not a multiple of 8
    "attention_head_width": (ValueError, lambda kernel: _attention(
        kernel, (1, 64, 4, 12), torch.bfloat16)),
    "attention_dtype": (TypeError, lambda kernel: _attention(
        kernel, (1, 64, 4, 64), torch.float16)),
    # one block a (batch row, head): B * H past the grid's 65,535
    "attention_grid": (ValueError, lambda kernel: _attention(
        kernel, (2, 8, 32768, 64), torch.bfloat16)),
    "gmm_dtype": (TypeError, lambda kernel: kernel("gmm")(*_empty(
        (4, 32, 64), (4, 64, 96), dtype=torch.float16))),
    "ssm_scan_state_width": (ValueError, lambda kernel: kernel("ssm_scan")(
        *_empty((2, 64, 256), (2, 64, 256), (256,), (2, 64, 8), (2, 64, 8),
                (256, 8), (256,)))),
    "slstm_scan_dtype": (TypeError, lambda kernel: kernel("slstm_scan")(
        *_empty((2, 16, 512), (2, 64, 256), dtype=torch.float16),
        *_empty(*[(2, 128)] * 4))),
}


@pytest.mark.parametrize("case", sorted(_REFUSED))
def test_fake_forms_refuse_what_the_launch_refuses(case):
    """The fake forms run their launch's checks of dtype, widths and grid
    (all but the device's and the addresses'), so the dry run records a
    cell the kernel would refuse as failed, not ``ok``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.factory import get_kernel
    error, call = _REFUSED[case]
    with FakeTensorMode(), pytest.raises(error):
        call(get_kernel)


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_heads_that_do_not_split_over_model(kind):
    """Heads that do not divide the TP axis (qwen2-0.5b's 14 over 16;
    here 3 over 2, with the flat q width still even) run replicated over
    ``model``: the forward gathers the flat projection before the heads'
    reshape, and the backward gathers the flat gradient before it reaches
    the heads."""
    cfg = dataclasses.replace(_cfg("qwen2-0.5b"), n_heads=3, n_kv_heads=1)
    rec = dryrun.run_cell("qwen2-0.5b", "small", "2x2", False, device="cpu",
                          cfg=cfg, shape=ShapeConfig("small", 16, 8, kind),
                          mesh_shape=(2, 2))
    assert rec["status"] == "ok", rec.get("error")
