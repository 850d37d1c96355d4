"""The port's work counting (repro_torch/analysis/hlo_cost.py,
model_flops.py) and the factory's kernel costs, against the JAX package.

  * Each program of tests/test_hlo_cost.py (a loop-free ``tanh(x@w)@w``,
    16 trips of a scanned step, a nested 4 x 6 loop, a batched einsum, a
    checkpointed backward) counted by the port: FLOPs within 5 % of
    ``repro.analysis.hlo_cost.analyze`` on the same program compiled by
    XLA, the backward more than 2.5x the forward; bytes equal to a hand
    count of the unfused program (every op's inputs and outputs; XLA's
    fused bytes are another quantity).
  * Under ``torch.func.vmap`` the count sees the batched ops: a cohort
    round over n trainers counts n times one trainer's FLOPs.
  * ``model_flops`` equals the JAX package's for every registry config
    and shape; ``exact_param_counts`` on the port's reduced dense, MoE and
    xLSTM models (and on full-size ones on the meta device: shapes only)
    equals the JAX package's on ``params_shape()``.
  * The factory's kernels count at their registered cost whatever
    implements them: a reduced yi-6b prefill counts the same with the
    factory on "torch" and on "cuda" (its plain versions on the CPU), the
    plain flash_attention's full S x S scores are not counted, and each
    op's cost gives the bound PERF.md section 6 lists at that row's shape
    — exactly the bound of the hand code it replaced in chip_smoke.py.
"""
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.analysis.hlo_cost import analyze as jax_analyze
from repro.analysis.model_flops import exact_param_counts as jax_counts
from repro.analysis.model_flops import model_flops as jax_model_flops
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.configs.registry import REGISTRY as JAX_REGISTRY
from repro.configs.registry import reduced_config as jax_reduced
from repro.models.model import build_model as jax_build_model
from repro_torch.analysis.hlo_cost import analyze, counting
from repro_torch.analysis.model_flops import exact_param_counts, model_flops
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import REGISTRY, get_config, reduced_config
from repro_torch.kernels import factory
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer
from repro_torch.models.model import build_model

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

torch.set_num_threads(1)

FLOP_RTOL = 0.05          # the port's count against XLA's HLO walker
F32 = 4                   # bytes a float32


def _xla(fn, *shapes):
    """repro's HLO walker on ``fn`` compiled by XLA at float32 ``shapes``."""
    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jax_analyze(jax.jit(fn).lower(*specs).compile().as_text())


def _near(ours, theirs):
    assert abs(ours - theirs) / theirs < FLOP_RTOL, (ours, theirs)


def _randn(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


# -- the programs of tests/test_hlo_cost.py -------------------------------------

def test_loop_free_matches_xla():
    d = 128
    got = analyze(lambda x, w: torch.tanh(x @ w) @ w, _randn(d, d),
                  _randn(d, d, seed=1))
    _near(got.flops, _xla(lambda x, w: jnp.tanh(x @ w) @ w, (d, d),
                          (d, d)).flops)
    assert got.flops == 2 * 2 * d ** 3 + d * d
    # mm (two inputs, an output), tanh (one in, one out), mm
    assert got.bytes == (3 + 2 + 3) * d * d * F32
    assert got.transcendentals == d * d


def test_scan_trip_count_multiplies():
    d, L = 64, 16

    def f(x, ws):
        for i in range(ws.shape[0]):          # eager: every trip runs
            x = torch.tanh(x @ ws[i])
        return x

    def body(x, w):
        return jnp.tanh(x @ w), None
    got = analyze(f, _randn(d, d), _randn(L, d, d, seed=1))
    _near(got.flops, _xla(lambda x, ws: jax.lax.scan(body, x, ws)[0],
                          (d, d), (L, d, d)).flops)
    expect = 2 * d ** 3 * L
    assert expect <= got.flops <= expect * 1.2
    assert got.bytes == L * (3 + 2) * d * d * F32     # ws[i] is a view


def test_nested_scan_multiplies_twice():
    d, L1, L2 = 32, 4, 6

    def f(x, ws):
        for _ in range(L1):
            for i in range(ws.shape[0]):
                x = x @ ws[i]
        return x

    def outer(x, ws):
        def inner(x, w):
            return x @ w, None

        def body(x, _):
            return jax.lax.scan(inner, x, ws)[0], None
        return jax.lax.scan(body, x, None, length=L1)[0]
    got = analyze(f, _randn(d, d), _randn(L2, d, d, seed=1))
    _near(got.flops, _xla(outer, (d, d), (L2, d, d)).flops)
    assert got.flops == 2 * d ** 3 * L1 * L2
    assert got.bytes == L1 * L2 * 3 * d * d * F32


def test_dot_flops_with_batch_dims():
    x, y = _randn(4, 8, 16), _randn(4, 16, 8, seed=1)
    got = analyze(lambda x, y: torch.einsum("bij,bjk->bik", x, y), x, y)
    xla = _xla(lambda x, y: jnp.einsum("bij,bjk->bik", x, y), (4, 8, 16),
               (4, 16, 8))
    assert got.flops == 2 * 4 * 8 * 16 * 8 <= xla.flops
    _near(got.flops, xla.flops)
    assert got.bytes == (4 * 8 * 16 + 4 * 16 * 8 + 4 * 8 * 8) * F32


def test_remat_backward_counts_recompute():
    """A checkpointed step's backward re-runs the forward: fwd +
    recompute + the input's gradient product, as XLA's remat scan."""
    d, L = 32, 8

    def loss(x, ws):
        y = x
        for i in range(ws.shape[0]):
            y = checkpoint(lambda a, b: torch.tanh(a @ b), y, ws[i],
                           use_reentrant=False)
        return y.sum()

    def grad(x, ws):
        x = x.detach().requires_grad_(True)
        return torch.autograd.grad(loss(x, ws), x)[0]

    def body(x, w):
        return jnp.tanh(x @ w), None

    def jloss(x, ws):
        return jnp.sum(jax.lax.scan(jax.checkpoint(body), x, ws)[0])
    got = analyze(grad, _randn(d, d), _randn(L, d, d, seed=1))
    _near(got.flops, _xla(jax.grad(jloss), (d, d), (L, d, d)).flops)
    fwd = 2 * d ** 3 * L
    assert got.flops > 2.5 * fwd
    # a step: forward mm + tanh; in the backward the recomputed mm + tanh,
    # tanh_backward (two in, one out) and the gradient's mm; plus the
    # sum (d^2 in, a scalar out) and the scalar ones_like it seeds
    step = (3 + 2) + (3 + 2 + 3 + 3)
    assert got.bytes == (L * step * d * d + d * d + 1 + 1) * F32


def test_fused_aten_ops_count_as_their_parts():
    """softmax reaches the dispatcher as one aten op: it counts as its
    max, subtract, exp, sum and divide (within 5 % of XLA's decomposed
    softmax); log-softmax and layer norm by the module's convention."""
    x = _randn(64, 256)
    n = x.numel()
    got = analyze(lambda x: torch.softmax(x, -1), x)
    _near(got.flops, _xla(lambda x: jax.nn.softmax(x, -1), (64, 256)).flops)
    assert (got.flops, got.transcendentals, got.bytes) == (5 * n, n,
                                                           2 * n * F32)
    got = analyze(lambda x: torch.log_softmax(x, -1), x)
    assert (got.flops, got.transcendentals) == (5 * n, n)
    got = analyze(lambda x: torch.nn.functional.layer_norm(x, (256,)), x)
    assert (got.flops, got.transcendentals) == (7 * n, 0)
    got = analyze(torch.nn.functional.silu, x)
    assert (got.flops, got.transcendentals) == (n, n)


def test_vmapped_cohort_round_counts_n_trainers():
    """torch.func.vmap runs batched ops, and the count sees them: a
    cohort round over n trainers is n times one trainer's FLOPs and
    transcendentals (the bytes are not: every trainer reads the one
    global model)."""
    from repro_torch.fl.cohort import CohortKernels
    from repro_torch.fl.dp import DPConfig
    from repro_torch.models.mlp import TinyMLP
    from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer
    model = TinyMLP(16, 8, 4, device="cpu")
    opt = make_optimizer(OptimizerSpec(name="sgdm", lr=0.1, grad_clip=5.0))
    kernels = CohortKernels(model, opt, DPConfig(noise_multiplier=0.05))
    params = model.init_params(0)

    def round_cost(n):
        g = torch.Generator().manual_seed(1)
        batches = {"x": torch.randn(n, 2, 8, 16, generator=g),
                   "labels": torch.randint(0, 4, (n, 2, 8), generator=g)}
        state = torch.func.vmap(lambda _: opt.init(params))(torch.zeros(n))
        return analyze(kernels.round_step, params, state, batches, 0, 0,
                       torch.zeros(n, dtype=torch.bool),
                       torch.ones(n, dtype=torch.bool), True)
    one = round_cost(1)
    assert one.flops > 0 and one.transcendentals > 0
    for n in (4, 7):
        got = round_cost(n)
        assert got.flops == n * one.flops
        assert got.transcendentals == n * one.transcendentals


# -- model_flops / exact_param_counts -------------------------------------------

@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_model_flops_equals_jax(arch):
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY)
    for name, shape in SHAPES.items():
        assert model_flops(get_config(arch), shape) == jax_model_flops(
            JAX_REGISTRY[arch], JAX_SHAPES[name]), name
    assert {s.kind for s in SHAPES.values()} == {"train", "prefill",
                                                 "decode"}


FAMILIES = ["yi-6b", "moonshot-v1-16b-a3b", "kimi-k2-1t-a32b", "xlstm-1.3b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_exact_param_counts_on_reduced_models(arch):
    cfg = reduced_config(get_config(arch))
    jcfg = jax_reduced(JAX_REGISTRY[arch])
    want = jax_counts(jax_build_model(jcfg).params_shape(), jcfg)
    params = build_model(cfg, "cpu").init_params(0)
    assert exact_param_counts(params, cfg) == want
    # the stacked tree params_to_numpy emits, and a tree of bare shapes
    tree = transformer.params_to_numpy(params)
    assert exact_param_counts(tree, cfg) == want
    shapes = jax.tree.map(lambda a: tuple(a.shape), tree)
    assert exact_param_counts(shapes, cfg) == want
    shape = SHAPES["prefill_32k"]
    assert model_flops(cfg, shape, params) == jax_model_flops(
        jcfg, JAX_SHAPES["prefill_32k"],
        jax_build_model(jcfg).params_shape())


@pytest.mark.parametrize("arch", ["yi-6b", "moonshot-v1-16b-a3b"])
def test_exact_param_counts_read_shapes_only(arch):
    """A full-size model on the meta device (no weight exists anywhere)
    counts as the JAX package's params_shape()."""
    cfg = get_config(arch)
    params = transformer.TransformerLM(cfg, device="meta")
    assert exact_param_counts(params, cfg) == jax_counts(
        jax_build_model(JAX_REGISTRY[arch]).params_shape(),
        JAX_REGISTRY[arch])


# -- the factory's kernels ---------------------------------------------------

def _prefill_cost(impl, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_KERNEL_IMPL", impl)
    cfg = reduced_config(get_config("yi-6b"))
    model = build_model(cfg, "cpu")
    params = model.init_params(0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)))
    with counting() as cost:
        logits, _ = model.prefill(params, {"tokens": tokens})
    return cfg, cost, logits


def test_prefill_counts_the_same_whatever_implements_a_kernel(monkeypatch):
    cfg, plain, logits = _prefill_cost("torch", monkeypatch)
    _, kernels, logits_k = _prefill_cost("cuda", monkeypatch)
    assert torch.equal(logits, logits_k)
    assert (plain.flops, plain.bytes, plain.transcendentals) == \
        (kernels.flops, kernels.bytes, kernels.transcendentals)
    assert plain.custom_calls == kernels.custom_calls
    assert plain.launches("flash_attention") == cfg.n_layers
    assert factory._COUNTER is None


def test_a_kernel_counts_its_cost_not_its_plain_version():
    """The plain flash_attention computes the whole (S, S) score matrix;
    the count records the causal work of the op's cost, once, and none of
    the plain version's aten ops."""
    B, S, H, Hkv, dh = 2, 64, 4, 2, 16
    q, k, v = _randn(B, S, H, dh), _randn(B, S, Hkv, dh, seed=1), \
        _randn(B, S, Hkv, dh, seed=2)
    flops, n_bytes = factory.kernel_cost("flash_attention")(q, k, v)
    assert flops == 4 * B * H * S * S * dh / 2
    for fn in (fa.flash_attention, fa.flash_attention_torch,
               factory.get_kernel("flash_attention", "torch")):
        got = analyze(fn, q, k, v)
        assert (got.flops, got.bytes, got.transcendentals) == \
            (flops, n_bytes, 0)
        assert got.custom_calls == [
            "flash_attention (2, 64, 4, 16):float32 (2, 64, 2, 16):float32 "
            "(2, 64, 2, 16):float32"]
    # with no count running, the plain version dispatches the full scores
    with counting() as outer:
        with counting() as inner:
            fa.flash_attention(q, k, v)
        torch.tanh(q)
    assert inner.flops == flops
    assert outer.flops == flops + q.numel()
    assert outer.launches("flash_attention") == 1


def test_no_counter_costs_one_global_read():
    assert factory._COUNTER is None
    wrapper = factory.get_kernel("rollup_digest")
    assert wrapper.__wrapped__.__name__ == "rollup_digest"
    words = torch.arange(100, dtype=torch.int32)
    assert int(wrapper(words)) == int(wrapper.__wrapped__(words))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


I32, I64, F64, BF16 = torch.int32, torch.int64, torch.float64, torch.bfloat16
STATE_WORDS, CHUNK = 11 * 262_144, 2048
N_CHUNKS = -(-STATE_WORDS // CHUNK)

#: PERF.md section 6's Bound column (the hand code's, rounded as printed)
#: at each row's shape: (op, arguments, bound ms, bound_by)
PERF_BOUNDS = [
    ("rollup_digest", (_meta(200_788, dtype=I32),), 0.000240, "bytes"),
    ("rollup_chunk_digests", (_meta(STATE_WORDS, dtype=I32), CHUNK),
     0.003445, "bytes"),
    ("dirty_fold", (_meta(STATE_WORDS, dtype=I32), _meta(N_CHUNKS, dtype=I64),
                    CHUNK), 0.003448, "bytes"),
    ("block_pack", (_meta(50_042, dtype=F64), _meta(50_042, dtype=I64),
                    _meta(820, dtype=F64), _meta(820, dtype=I64), 30_000_000,
                    0), 0.000245, "bytes"),
    ("weighted_agg", (_meta(32, 64, 2410), _meta(32, 64)), 0.005988,
     "bytes"),
    ("weighted_agg", (_meta(64, 2410), _meta(64)), 0.000187, "bytes"),
    ("weighted_agg", (_meta(64, 1 << 20), _meta(64)), 0.081382, "bytes"),
    ("model_distance", (_meta(32, 64, 2410), _meta(32, 2410)), 0.005988,
     "bytes"),
    ("model_distance", (_meta(64, 2410), _meta(2410)), 0.000187, "bytes"),
    ("model_distance", (_meta(64, 1 << 20), _meta(1 << 20)), 0.081382,
     "bytes"),
    ("flash_attention", (_meta(8, 4096, 32, 128, dtype=BF16),
                         _meta(8, 4096, 4, 128, dtype=BF16),
                         _meta(8, 4096, 4, 128, dtype=BF16)), 1.111741,
     "operations"),
    ("flash_attention", (_meta(1, 32_768, 32, 128, dtype=BF16),
                         _meta(1, 32_768, 4, 128, dtype=BF16),
                         _meta(1, 32_768, 4, 128, dtype=BF16)), 8.893926,
     "operations"),
    ("flash_attention", (_meta(4, 4096, 16, 128, dtype=BF16),
                         _meta(4, 4096, 16, 128, dtype=BF16),
                         _meta(4, 4096, 16, 128, dtype=BF16)), 0.277935,
     "operations"),
    ("gmm", (_meta(64, 1920, 2048, dtype=BF16),
             _meta(64, 2048, 1408, dtype=BF16)), 0.716552, "operations"),
    ("gmm", (_meta(64, 8, 2048, dtype=BF16), _meta(64, 2048, 1408,
                                                   dtype=BF16)),
     0.111235, "bytes"),
    ("slstm_scan", (_meta(8, 4096, 4 * 2048, dtype=BF16),
                    _meta(4, 512, 2048, dtype=BF16), *[_meta(8, 2048)] * 4),
     0.555870, "operations"),
]


def _hand_bound(op, args):
    """The bound chip_smoke.py computed by hand before the costs existed
    (its rates: 3.35 TB/s, 989 TFLOP/s bf16, 67 T/s for the CUDA cores'
    integer and float32 operations)."""
    hbm, bf16, cores, per_word = 3.35e12, 989e12, 67e12, 4

    def of(n_bytes, ops_s):
        mem, ops = n_bytes / hbm * 1e3, ops_s * 1e3
        return max(mem, ops), "bytes" if mem >= ops else "operations"
    a = args
    if op == "rollup_digest":
        return of(4 * a[0].numel() + 4, per_word * a[0].numel() / cores)
    if op == "rollup_chunk_digests":
        n = a[0].numel()
        return of(4 * n + 4 * -(-n // a[1]), per_word * n / cores)
    if op == "dirty_fold":          # the hand code's shape: every chunk
        n = a[0].numel()
        return of(4 * n + 12 * -(-n // a[2]), per_word * n / cores)
    if op == "batch_seal":
        return of(4 * a[0].numel() + 12 * a[1].numel(),
                  per_word * a[0].numel() / cores)
    if op == "shard_seal":
        k, b = a[1].shape
        sw, sb = int(a[3].sum()), int(a[2].sum())
        return of(4 * sw + 8 * sb + 4 * k * b, per_word * sw / cores)
    if op == "block_pack":
        n, b = a[0].numel(), a[2].numel()
        probes = math.ceil(math.log2(max(n, 2)))
        return of(8 * (2 * n + 3 * b), 2 * ((n + 1) * probes + b * probes)
                  / cores)
    if op == "weighted_agg":
        w, s = a
        return of((w.numel() + w.numel() // w.shape[-2]) * 4 + 4 * s.numel(),
                  2 * w.numel() / cores)
    if op == "model_distance":
        w, g = a
        return of((w.numel() + g.numel()) * 4 + 4 * (w.numel()
                                                     // w.shape[-1]),
                  3 * w.numel() / cores)
    if op == "flash_attention":
        B, S, H, dh = a[0].shape
        flops = 4 * B * H * S * S * dh / 2
        mem = 2 * (2 * B * S * H * dh + 2 * B * S * a[1].shape[2] * dh)
        ops_ms, mem_ms = flops / bf16 * 1e3, mem / hbm * 1e3
        return max(ops_ms, mem_ms), \
            "operations" if ops_ms >= mem_ms else "bytes"
    if op == "gmm":
        E, C, d = a[0].shape
        f = a[1].shape[2]
        ops_ms = 2 * E * C * d * f / bf16 * 1e3
        mem_ms = 2 * (E * C * d + E * d * f + E * C * f) / hbm * 1e3
        return max(ops_ms, mem_ms), \
            "operations" if ops_ms >= mem_ms else "bytes"
    if op == "slstm_scan":
        B, S = a[0].shape[:2]
        nh, dh = a[1].shape[:2]
        d = nh * dh
        ops_ms = 2 * 8 * B * S * d * dh / bf16 * 1e3
        mem_ms = (2 * (B * S * 4 * d + nh * dh * 4 * dh)
                  + 4 * (B * S * d + 8 * B * d)) / hbm * 1e3
        return max(ops_ms, mem_ms), \
            "operations" if ops_ms >= mem_ms else "bytes"
    raise AssertionError(op)


@pytest.mark.parametrize("op,args,bound,by", PERF_BOUNDS,
                         ids=[f"{r[0]}-{i}" for i, r in enumerate(PERF_BOUNDS)])
def test_cost_gives_perf_bound(op, args, bound, by):
    got = chip_smoke.cost_bound(op, *args)
    assert (round(got["bound_ms"], 6), got["bound_by"]) == (bound, by)
    assert (got["bound_ms"], got["bound_by"]) == _hand_bound(op, args)
    # the record phase 18 recomputes it from
    again = chip_smoke.cost_bound(
        op, *chip_smoke.from_cost_args(got["cost_args"]))
    assert again["bound_ms"] == got["bound_ms"]


@pytest.mark.parametrize("op,args", [
    ("batch_seal", (_meta(200_788, dtype=I32), _meta(2_510, dtype=I64))),
    ("batch_seal", (_meta(4_015_760, dtype=I32), _meta(50_096, dtype=I64))),
    ("shard_seal", (_meta(8, 502_044, dtype=I32), _meta(8, 6_262, dtype=I64),
                    torch.full((8,), 6_262), torch.full((8,), 501_970))),
    ("rollup_digest", (_meta(80, dtype=I32),)),
])
def test_cost_gives_the_hand_bound(op, args):
    """The ledger ops whose timed shapes come from the run's workload:
    the registered cost gives the hand code's bound at any shape."""
    got = chip_smoke.cost_bound(op, *args)
    assert (got["bound_ms"], got["bound_by"]) == _hand_bound(op, args)


def test_every_op_has_a_cost():
    ops = set(factory._REGISTRY)
    assert ops == set(factory._COSTS) and len(ops) == 16
    for op in ops:
        for impl in factory.available_impls(op):
            assert hasattr(factory.get_kernel(op, impl), "__wrapped__"), \
                (op, impl)
