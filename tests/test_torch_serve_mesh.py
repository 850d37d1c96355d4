"""The serving launcher on a ``DeviceMesh`` (``launch/serve_model.py``'s
``generate_on_mesh``), in four ``gloo`` processes (``file://``
rendezvous) at ``--reduced --device cpu``:

  * ``--mesh-shape 2x2`` and ``2x1x2``, each at ``--batch 4`` and at
    ``--batch 3`` (which ``data`` 2 does not divide, so the batch runs
    replicated, as batch 4 does over the production mesh's data 16),
    against the port's one-card ``generate`` (``--host-mesh`` with no
    group) and against the JAX launcher's decode loop
    (``src/repro/launch/serve_model.py``: ``build_model`` on
    ``make_host_mesh()``, a jitted ``decode`` with the state donated) on
    the port's initial weights, carried across by
    ``transformer.flat_to_numpy``; reduced yi-6b, and moonshot's MoE and
    the xLSTM stack at 2 x 2, batch 3;
  * the sharded init: the gathered weights equal ``Model.init_params(0)``
    bit for bit, and every rank's local leaf is its shard and no more;
  * with no group the production mesh and ``--multi-pod`` raise, naming
    256 and 512;
  * under ``torchrun``'s environment the launcher starts its own group
    and destroys it.

The configs run in float32 (a patched ``reduced_config``, as
``tests/test_torch_launch_mesh.py`` does): a bfloat16 model split over
``model`` rounds its partial sums where the one-card model does not.
Every step's logits are held to the reference's at ``TOL`` (the
xLSTM's at ``TOL_XLSTM``), and the tokens equal, up to the first step at
which the two top logits of a row of the reference sit within twice that
tolerance of each other (a near-tie, where the last bits of a sum may
pick either token); from there on the two runs may go apart, and nothing
is held.  Every run here holds more than 8 of its 16 steps.
"""
import contextlib
import dataclasses
import socket

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

BASE = ["--reduced", "--device", "cpu"]
#: (arch, mesh shape, batch) of the four-rank runs
RUNS = [("yi-6b", shape, batch) for shape in ("2x2", "2x1x2")
        for batch in (4, 3)] + [("moonshot-v1-16b-a3b", "2x2", 3),
                                ("xlstm-1.3b", "2x2", 3)]
TOL = dict(rtol=1e-5, atol=1e-5)
#: the xLSTM stack's: its exponential gates amplify a rounding, so that
#: weights moved by one float32 ulp of noise move the reduced stack's
#: first logits by 1.9e-5 (2.3e-6 for yi-6b's), and the mesh rounds
#: every split sum otherwise
TOL_XLSTM = dict(rtol=1e-4, atol=5e-4)


def _tol(arch):
    return TOL_XLSTM if arch.startswith("xlstm") else TOL


@contextlib.contextmanager
def _recorded(serve_model):
    """Inside the block the launcher module's reduced configs are float32,
    and every decode step's logits (gathered) and the sharded init's
    weights (gathered, with each local leaf's shape) are kept in the
    record yielded."""
    from repro_torch.models.model import Model
    cfg0, decode0 = serve_model.reduced_config, Model.decode
    init0 = serve_model.init_params_sharded
    rec = {"logits": []}

    def decode(self, params, state, batch):
        logits, state = decode0(self, params, state, batch)
        rec["logits"].append(logits.full_tensor() if hasattr(
            logits, "full_tensor") else logits.clone())
        return logits, state

    def init(model, pspecs, seed=0, **kw):
        out = init0(model, pspecs, seed, **kw)
        rec["init"] = {k: v.full_tensor() for k, v in out.items()}
        rec["local"] = {k: (tuple(v.to_local().shape), tuple(v.shape),
                            tuple(v.placements), tuple(v.device_mesh.shape))
                        for k, v in out.items()}
        return out
    serve_model.reduced_config = lambda cfg: dataclasses.replace(
        cfg0(cfg), dtype="float32")
    Model.decode = decode
    serve_model.init_params_sharded = init
    try:
        yield rec
    finally:
        serve_model.reduced_config = cfg0
        Model.decode = decode0
        serve_model.init_params_sharded = init0


def _args(arch, batch):
    return BASE + ["--arch", arch, "--batch", str(batch)]


def _rank(rank, world, d, out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                            world_size=world)
    from repro_torch.launch import serve_model
    res = {}
    for arch, shape, batch in RUNS:
        with _recorded(serve_model) as rec:
            got = serve_model.main(_args(arch, batch)
                                   + ["--mesh-shape", shape])
        res[(arch, shape, batch)] = dict(rec, tokens=got["tokens"])
    if rank == 0:
        torch.save(res, out)
    dist.destroy_process_group()


def _torchrun_rank(rank, world, port, out):
    """torchrun's environment and no group: the launcher starts one (in
    processes of their own, which have seen no other mesh)."""
    import os
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch import serve_model
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    with _recorded(serve_model):
        got = serve_model.main(_args("yi-6b", 4) + ["--mesh-shape", "2x2"])
    if rank == 0:
        torch.save({"tokens": got["tokens"], "left": dist.is_initialized()},
                   out)


def _spawn(fn, d, *args):
    import torch.multiprocessing as mp
    out = str(d / "result.pt")
    mp.start_processes(fn, args=(4,) + args + (out,), nprocs=4,
                       start_method="spawn")
    return torch.load(out, weights_only=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' runs (rank 0's records)."""
    d = tmp_path_factory.mktemp("serve_mesh")
    return _spawn(_rank, d, str(d))


@pytest.fixture(scope="module")
def one_card():
    """``generate`` through the launcher (``--host-mesh``, no group) at
    each run's arch and batch: its record, and the one-card model's
    config and initial weights."""
    from repro_torch.launch import serve_model
    from repro_torch.models.model import build_model
    out = {}
    for arch, batch in {(a, b) for a, _, b in RUNS}:
        with _recorded(serve_model) as rec:
            got = serve_model.main(_args(arch, batch) + ["--host-mesh"])
            cfg = serve_model.reduced_config(
                serve_model.get_config(arch))
        model = build_model(cfg, "cpu")
        out[(arch, batch)] = dict(
            rec, tokens=got["tokens"], cfg=cfg,
            params=model.train_params(model.init_params(0)))
    return out


def _jax_loop(cfg, params, prompts, n_tokens):
    """The JAX launcher's decode loop (``src/repro/launch/serve_model.py``)
    on ``params`` (the port's flat weights): each step's logits and the
    generated tokens."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config as jax_get_config
    from repro.configs.registry import reduced_config as jax_reduced
    from repro.launch.mesh import make_host_mesh
    from repro.models.model import build_model as jax_build
    from repro_torch.models import transformer as tt
    jcfg = dataclasses.replace(jax_reduced(jax_get_config(cfg.name)),
                               dtype="float32")
    mesh = make_host_mesh()
    model = jax_build(jcfg, mesh)
    logits_all = []
    with mesh:
        jp = jax.tree.map(jnp.asarray, tt.flat_to_numpy(cfg, params))
        B, P = prompts.shape
        state = model.init_decode_state(B, P + n_tokens + 1)
        decode = jax.jit(model.decode, donate_argnums=(1,))
        for t in range(P):
            logits, state = decode(jp, state, {
                "tokens": jnp.asarray(prompts[:, t:t + 1], jnp.int32),
                "pos": jnp.int32(t)})
            logits_all.append(np.asarray(logits, np.float32))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        generated = []
        for t in range(P, P + n_tokens):
            generated.append(np.asarray(tok)[:, 0])
            logits, state = decode(jp, state, {"tokens": tok,
                                               "pos": jnp.int32(t)})
            logits_all.append(np.asarray(logits, np.float32))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
    return logits_all, np.stack(generated, 1)


def _held(logits, tokens, want_logits, want_tokens, tol) -> int:
    """Each step's logits within ``tol`` of ``want_logits``' and the
    generated tokens equal, up to the first near-tie of the reference's
    top two logits; returns the steps held."""
    n = len(want_logits)
    P = n - want_tokens.shape[1]        # the prompt's steps
    assert len(logits) == n
    for s in range(n):
        got, want = np.asarray(logits[s], np.float32), \
            np.asarray(want_logits[s], np.float32)
        np.testing.assert_allclose(got, want, **tol)
        top2 = np.sort(want, -1)[:, -2:]
        if (top2[:, 1] - top2[:, 0] <= 2 * (tol["atol"] + tol["rtol"]
                                            * np.abs(top2[:, 1]))).any():
            return s
        if s >= P - 1 and s - (P - 1) < want_tokens.shape[1]:
            i = s - (P - 1)
            np.testing.assert_array_equal(tokens[:, i], want_tokens[:, i])
    return n


@pytest.mark.parametrize("run", RUNS, ids=["-".join(map(str, r))
                                           for r in RUNS])
def test_mesh_serve_equals_one_card_generate(runs, one_card, run):
    arch, _, batch = run
    got, want = runs[run], one_card[(arch, batch)]
    assert got["tokens"].shape == want["tokens"].shape == (batch, 8)
    held = _held(got["logits"], got["tokens"], want["logits"],
                 want["tokens"], _tol(arch))
    assert held > 8, f"a near-tie at step {held} of 16"


@pytest.mark.parametrize("run", RUNS, ids=["-".join(map(str, r))
                                           for r in RUNS])
def test_mesh_serve_equals_the_jax_loop(runs, one_card, run):
    arch, _, batch = run
    ref = one_card[(arch, batch)]
    cfg = ref["cfg"]
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                (batch, 8))
    want_logits, want_tokens = _jax_loop(cfg, ref["params"], prompts, 8)
    got = runs[run]
    held = _held(got["logits"], got["tokens"], want_logits, want_tokens,
                 _tol(arch))
    assert held > 8, f"a near-tie at step {held} of 16"


@pytest.mark.parametrize("run", RUNS, ids=["-".join(map(str, r))
                                           for r in RUNS])
def test_sharded_init_is_init_params_a_shard_a_rank(runs, one_card, run):
    from torch.distributed.tensor import Shard
    arch, _, batch = run
    got, want = runs[run], one_card[(arch, batch)]["params"]
    assert sorted(got["init"]) == sorted(want)
    for k, w in want.items():
        assert torch.equal(got["init"][k], w), k
    split = 0
    for k, (local, shape, placements, mesh) in got["local"].items():
        n = 1
        for p, size in zip(placements, mesh):
            n *= size if isinstance(p, Shard) else 1
        assert np.prod(local) * n == np.prod(shape), (k, local, shape)
        split += n > 1
    assert split > 0


@pytest.mark.parametrize("flags,world", [([], 256), (["--multi-pod"], 512)])
def test_meshes_wider_than_one_card_raise_without_a_group(flags, world):
    from repro_torch.launch import serve_model
    with pytest.raises(RuntimeError, match=f"world size {world}"):
        serve_model.main(BASE + flags)


def test_mesh_flags_name_one_mesh():
    from repro_torch.launch import serve_model
    with pytest.raises(SystemExit):
        serve_model.main(BASE + ["--host-mesh", "--multi-pod"])


def test_launcher_starts_and_destroys_torchruns_group(runs,
                                                    tmp_path_factory):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    r = _spawn(_torchrun_rank, tmp_path_factory.mktemp("torchrun"), port)
    assert r["left"] is False
    np.testing.assert_array_equal(r["tokens"],
                                  runs[("yi-6b", "2x2", 4)]["tokens"])
