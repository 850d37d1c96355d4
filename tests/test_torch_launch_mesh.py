"""The training launcher on a ``DeviceMesh`` (``launch/train.py``'s mesh
round, ``fl.round.build_fl_round_cell``), in four ``gloo`` processes
(``file://`` rendezvous) at ``--reduced --device cpu``:

  * (a) ``--mesh-shape 2x2``, 3 rounds, against the port's one-card
    round at T 2 (``build_fl_round`` driven through the launcher's own
    loop, ``train.run_rounds``) and the JAX launcher's loop body at T 2
    (``repro.fl.round.build_fl_round``, ``end_of_task_update``) on the
    port's initial weights and the same ``default_rng(17)`` batches;
    each line's digest against ``digest_tree`` of the gathered merged
    weights;
  * (b) ``--mesh-shape 2x1x2``: the trainer dim over ``("pod",
    "data")``, against the same one-card round;
  * (c) the sharded init: the gathered stack's rows equal
    ``Model.init_params(0)`` bit for bit, the optimizer state
    ``opt.init``'s, and no rank's local leaf holds more than one trainer
    row;
  * (d) ``--ckpt-dir`` for 2 rounds, then ``--resume`` to 4: the lines of
    an uninterrupted 4-round run, from one manifest a rank;
  * (e) that checkpoint restored on a 1 x 4 mesh raises, naming both;
  * the launcher under ``torchrun``'s environment starts its own group
    and destroys it.

(a), (b) and (c) run the reduced config in float32, as
``tests/test_torch_dryrun.py``'s mesh round does: a bfloat16 model split
over ``model`` rounds its partial sums where the one-card model does
not.  They run the reputation update with a configured distance-penalty
threshold (``ReputationParams.tau`` = ``TAU``) in place of the default
adaptive one (tau = mean ND): at T 2 with equal scores the two trainers'
distances are equal in exact arithmetic (each is half the distance
between them), and the adaptive penalty (ND_i - tau) / (1 - tau) is 0/0
there, so the last bit of a float32 sum of squares, which the one-card
kernel, the mesh's all-reduce and XLA each order otherwise, sets one
trainer's objective reputation to 0 or leaves it.  With a fixed tau the
update is continuous in the distances.  (d) runs the launcher's defaults
(bfloat16, the adaptive tau) and is exact.

Tolerances: against the one-card round those of
``test_mesh_round_equals_the_one_card_round`` (loss rtol 1e-6, distances
and so the mean reputation rtol 1e-4), through three rounds; against the
JAX loop (its own gradients, in another order of summation, through
three rounds of two steps) the loss rtol 1e-5 and the mean reputation
rtol 1e-4, as ``tests/test_torch_round.py`` holds one JAX round.
"""
import contextlib
import dataclasses
import functools
import os
import socket

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

BASE = ["--reduced", "--device", "cpu"]
TAU = 0.5


@contextlib.contextmanager
def _comparable(train):
    """The launcher module's reduced configs in float32 and its
    reputation update at tau ``TAU``, inside the block."""
    cfg0, rp0 = train.reduced_config, train.ReputationParams
    train.reduced_config = lambda cfg: dataclasses.replace(cfg0(cfg),
                                                           dtype="float32")
    train.ReputationParams = functools.partial(rp0, tau=TAU)
    try:
        yield
    finally:
        train.reduced_config, train.ReputationParams = cfg0, rp0


def _recorded(train):
    """Patches ``train.MeshRound.step`` to keep, on every rank, the first
    round's inputs gathered (``init``, ``opt``), the most trainer rows a
    local leaf of theirs holds (``rows``), and each round's
    ``digest_tree`` of the gathered merged weights (``digests``)."""
    from repro_torch.fl.round import digest_tree
    real = train.MeshRound.step
    rec = {"digests": []}

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        return [tree]

    def full(tree):
        if isinstance(tree, dict):
            return {k: full(v) for k, v in tree.items()}
        return tree.full_tensor()

    def step(self, params_T, opt_T, scores, toks):
        if "init" not in rec:
            rec["init"], rec["opt"] = full(params_T), full(opt_T)
            rec["rows"] = max(v.to_local().shape[0]
                              for v in leaves(params_T) + leaves(opt_T))
            rec["T"] = {v.shape[0] for v in leaves(params_T)}
        out = real(self, params_T, opt_T, scores, toks)
        rec["digests"].append(int(digest_tree(
            {k: v.full_tensor()[0] for k, v in out[0].items()})))
        return out
    train.MeshRound.step = step
    return rec, lambda: setattr(train.MeshRound, "step", real)


def _key(lines):
    return [(ln["round"], ln["loss"], ln["digest"], ln["mean_rep"])
            for ln in lines]


def _rank(rank, world, d, out):
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=rank,
                            world_size=world)
    from repro_torch.launch import train
    res = {}
    for name, shape in (("a", "2x2"), ("b", "2x1x2")):
        rec, undo = _recorded(train)
        with _comparable(train):
            lines = train.main(BASE + ["--mesh-shape", shape, "--rounds",
                                       "3"])
        undo()
        res[name] = dict(rec, lines=lines)
    # (d) 2 rounds, then resume to 4, against 4 uninterrupted
    ck = os.path.join(d, "ck")
    two = BASE + ["--mesh-shape", "2x2"]
    res["d"] = {
        "full": _key(train.main(two + ["--rounds", "4"])),
        "first": _key(train.main(two + ["--rounds", "2", "--ckpt-dir", ck])),
        "rest": _key(train.main(two + ["--rounds", "4", "--ckpt-dir", ck,
                                       "--resume"])),
        "files": sorted(os.listdir(os.path.join(ck, "step_000000003")))}
    # (e) the same checkpoint on another mesh
    try:
        train.main(BASE + ["--mesh-shape", "1x4", "--rounds", "5",
                           "--ckpt-dir", ck, "--resume"])
        res["e"] = None
    except ValueError as e:
        res["e"] = str(e)
    if rank == 0:
        torch.save(res, out)
    dist.destroy_process_group()


def _torchrun_rank(rank, world, port, out):
    """torchrun's environment and no group: the launcher starts one (in
    processes of their own, which have seen no other mesh)."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.launch import train
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    lines = train.main(BASE + ["--mesh-shape", "2x2", "--rounds", "1"])
    if rank == 0:
        torch.save({"lines": _key(lines), "left": dist.is_initialized()},
                   out)


def _spawn(fn, d, *args):
    import torch.multiprocessing as mp
    out = str(d / "result.pt")
    mp.start_processes(fn, args=(4,) + args + (out,), nprocs=4,
                       start_method="spawn")
    return torch.load(out, weights_only=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' runs (rank 0's results)."""
    d = tmp_path_factory.mktemp("launch_mesh")
    return _spawn(_rank, d, str(d))


@pytest.fixture(scope="module")
def one_card():
    """The port's one-card round at T 2 through the launcher's loop, on
    the float32 reduced config at tau ``TAU``, its weights and optimizer
    state from the launcher's seed; the initial weights too."""
    from repro_torch.configs.registry import get_config
    from repro_torch.fl.round import FLRoundSpec
    from repro_torch.launch import train
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer
    with _comparable(train):
        cfg = dataclasses.replace(
            train.reduced_config(get_config("qwen2-0.5b")), optimizer="sgdm")
        model = build_model(cfg, "cpu")
        opt = make_optimizer(OptimizerSpec(name="sgdm", lr=0.05))
        spec = FLRoundSpec(n_trainers=2, h_local_steps=2, local_batch=2)
        lines = train.run_rounds(train.OneCardRound(model, opt, spec),
                                 rounds=3, seq_len=16)
    params = model.train_params(model.init_params(0))
    return {"cfg": cfg, "lines": lines, "params": params,
            "opt": opt.init(params)}


@pytest.mark.parametrize("name", ["a", "b"])
def test_mesh_launcher_equals_the_one_card_round(runs, one_card, name):
    got, want = runs[name]["lines"], one_card["lines"]
    assert [ln["round"] for ln in got] == [0, 1, 2]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-6)
        np.testing.assert_allclose(g["mean_rep"], w["mean_rep"], rtol=1e-4)
    # each digest is the gathered merged weights' (the rounds' weights
    # differ in their last bits from the one-card round's, and so would
    # the digests)
    assert [ln["digest"] for ln in got] == runs[name]["digests"]
    assert runs[name]["T"] == {2}


def test_mesh_launcher_equals_the_jax_loop(runs, one_card):
    """The JAX launcher's loop body at T 2 on the port's initial weights
    and the same batches."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config as jax_get_config
    from repro.configs.registry import reduced_config as jax_reduced
    from repro.core.reputation import ReputationParams as JRep
    from repro.core.reputation import end_of_task_update as jax_update
    from repro.core.reputation import init_book as jax_book
    from repro.fl.round import FLRoundSpec as JSpec
    from repro.fl.round import build_fl_round as jax_round
    from repro.models.model import build_model as jax_build
    from repro.optim.optimizers import OptimizerSpec as JOpt
    from repro.optim.optimizers import make_optimizer as jax_opt
    from repro_torch.models import transformer as tt
    jcfg = dataclasses.replace(jax_reduced(jax_get_config("qwen2-0.5b")),
                               dtype="float32")
    T, H, B, S = 2, 2, 2, 16
    opt = jax_opt(JOpt(name="sgdm", lr=0.05))
    fl_round = jax.jit(jax_round(jax_build(jcfg), opt, JSpec(T, H, B)))
    params = jax.tree.map(jnp.asarray, tt.flat_to_numpy(
        one_card["cfg"], one_card["params"]))
    params_T = jax.tree.map(lambda x: jnp.stack([x] * T), params)
    opt_T = jax.tree.map(lambda x: jnp.stack([x] * T), opt.init(params))
    book, rp = jax_book(T), JRep(tau=TAU)
    rng = np.random.default_rng(17)
    want = []
    for _ in range(3):
        toks = rng.integers(0, jcfg.vocab_size, (T, H, B, S + 1))
        batches = {"tokens": jnp.asarray(toks[..., :-1], jnp.int32),
                   "labels": jnp.asarray(toks[..., 1:], jnp.int32)}
        params_T, opt_T, m = fl_round(params_T, opt_T,
                                      jnp.asarray(book.reputation), batches)
        score_auto = jnp.clip(1.5 - m["loss"] / 10.0, 0.0, 1.0)
        book, _ = jax_update(book, jnp.full((T,), score_auto),
                             jnp.full((T,), float(H)),
                             jnp.full((T,), float(H)), m["distances"],
                             jnp.ones((T,)), rp)
        want.append((float(m["loss"]), float(jnp.mean(book.reputation))))
    for ln, (loss, rep) in zip(runs["a"]["lines"], want):
        np.testing.assert_allclose(ln["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(ln["mean_rep"], rep, rtol=1e-4)


@pytest.mark.parametrize("name", ["a", "b"])
def test_sharded_init_is_init_params_one_row_a_rank(runs, one_card, name):
    r = runs[name]
    assert r["rows"] == 1
    for k, want in one_card["params"].items():
        for row in r["init"][k]:
            assert torch.equal(row, want), k
    for k, want in one_card["opt"]["m"].items():
        for row in r["opt"]["m"][k]:
            assert torch.equal(row, want), k
    assert torch.equal(r["opt"]["step"],
                       one_card["opt"]["step"].expand(2))


def test_sharded_checkpoint_resumes_to_the_uninterrupted_lines(runs):
    d = runs["d"]
    assert [k[0] for k in d["full"]] == [0, 1, 2, 3]
    assert d["first"] + d["rest"] == d["full"]
    assert d["files"] == [f"manifest.rank{r:05d}.json" for r in range(4)]


def test_restore_on_another_mesh_raises_naming_both(runs):
    msg = runs["e"]
    assert msg is not None
    assert "{'data': 2, 'model': 2}" in msg and "{'data': 1, 'model': 4}" \
        in msg


def test_launcher_starts_and_destroys_torchruns_group(runs,
                                                    tmp_path_factory):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    r = _spawn(_torchrun_rank, tmp_path_factory.mktemp("torchrun"), port)
    assert r["lines"] == runs["d"]["full"][:1]
    assert r["left"] is False
