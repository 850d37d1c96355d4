"""The port's checkpointer (``checkpoint/checkpointer.py``) on the CPU:
the JAX package's four checkpoint tests (``tests/test_substrate.py``),
the bit-exact restart of ``tests/test_system.py``, cids equal to the JAX
``Checkpointer``'s, and bfloat16 round trips."""
import os

import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import build_model
from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer

torch.set_num_threads(1)


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"a": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
            "b": torch.ones(2, 2, dtype=torch.bfloat16)}
    ck.save(7, tree, extra={"loss": 1.5})
    got, extra = ck.restore()
    assert torch.equal(got["a"]["w"], tree["a"]["w"])
    assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"],
                                                            tree["b"])
    assert extra["loss"] == 1.5
    assert ck.latest_step() == 7


def test_checkpoint_rotation_and_dedup(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    t = {"w": torch.zeros(4)}
    for s in (1, 2, 3):
        ck.save(s, t)  # identical content -> one blob
    assert len(os.listdir(os.path.join(str(tmp_path), "blobs"))) == 1
    steps = [d for d in os.listdir(str(tmp_path)) if d.startswith("step_")]
    assert len(steps) == 2  # rotated
    got, _ = ck.restore()
    assert torch.equal(got["w"], t["w"])


def test_checkpoint_detects_corruption(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(8)})
    blob_dir = os.path.join(str(tmp_path), "blobs")
    fn = os.path.join(blob_dir, os.listdir(blob_dir)[0])
    with open(fn, "r+b") as f:
        f.seek(0)
        f.write(b"\xff")
    with pytest.raises(IOError):
        ck.restore()


def test_checkpoint_async(tmp_path):
    ck = Checkpointer(str(tmp_path))
    w = torch.arange(4.0)
    ck.save_async(5, {"w": w})
    w.add_(100.0)          # written after the call: not in the checkpoint
    ck.wait()
    got, _ = ck.restore()
    assert torch.equal(got["w"], torch.arange(4.0))


@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
def test_cids_and_layout_match_the_jax_checkpointer(tmp_path, dtype):
    """The same tree gives the same manifest (cids, shapes, dtype names)
    and blobs in both packages; each restores the other's."""
    import ml_dtypes
    g = np.random.default_rng(0)
    host = {"p": {"w": g.normal(size=(5, 3)) * 7, "b": g.normal(size=(4,))},
            "n": g.normal(size=(2, 2, 2))}

    def np_leaf(a):
        if dtype == "bfloat16":
            return a.astype(np.float32).astype(ml_dtypes.bfloat16)
        return a.astype(dtype)

    def torch_leaf(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16) \
            if dtype == "bfloat16" else torch.from_numpy(a.astype(dtype))
    jtree = {"p": {k: np_leaf(v) for k, v in host["p"].items()},
             "n": np_leaf(host["n"])}
    ttree = {"p": {k: torch_leaf(v) for k, v in host["p"].items()},
             "n": torch_leaf(host["n"])}
    jm = JaxCheckpointer(str(tmp_path / "jax")).save(3, jtree)
    tm = Checkpointer(str(tmp_path / "torch")).save(3, ttree)
    assert tm["leaves"] == jm["leaves"]
    assert sorted(os.listdir(tmp_path / "jax" / "blobs")) == \
        sorted(os.listdir(tmp_path / "torch" / "blobs"))
    got, _ = Checkpointer(str(tmp_path / "jax")).restore()
    assert torch.equal(got["p"]["w"], ttree["p"]["w"])
    back, _ = JaxCheckpointer(str(tmp_path / "torch")).restore()
    np.testing.assert_array_equal(np.asarray(back["n"], np.float32),
                                  np.asarray(jtree["n"], np.float32))


def test_checkpoint_restart_bitexact(tmp_path):
    cfg = reduced_config(get_config("qwen2-0.5b"))
    model = build_model(cfg, "cpu")
    opt = make_optimizer(OptimizerSpec(name="adamw"))
    step = build_train_step(model, opt)
    params = model.train_params(model.init_params(1))
    state = opt.init(params)

    def batch(s):
        t = np.random.default_rng(s).integers(0, cfg.vocab_size, (2, 17))
        return {"tokens": torch.from_numpy(t[:, :-1]),
                "labels": torch.from_numpy(t[:, 1:])}
    flat = [batch(s) for s in range(6)]

    ck = Checkpointer(str(tmp_path))
    for b in flat[:3]:
        params, state, _ = step(params, state, b)
    ck.save(3, {"params": params, "opt": state})
    cont_p, cont_s = params, state
    for b in flat[3:]:
        cont_p, cont_s, _ = step(cont_p, cont_s, b)
    restored, _ = ck.restore()
    r_p, r_s = restored["params"], restored["opt"]
    for b in flat[3:]:
        r_p, r_s, _ = step(r_p, r_s, b)
    for k in cont_p:
        assert cont_p[k].dtype == r_p[k].dtype
        assert torch.equal(cont_p[k], r_p[k]), k
    assert torch.equal(cont_s["step"], r_s["step"])


@pytest.fixture
def one_rank_mesh(tmp_path):
    """A (data, model) 1 x 1 ``DeviceMesh`` over a one-rank gloo group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_sharded_checkpoint_roundtrip_and_refusals(tmp_path, one_rank_mesh):
    """A tree of DTensors (and a plain leaf) saved as rank 0's shards:
    one manifest a rank naming each leaf's global shape and placements,
    restored as the same DTensors on the same mesh; restored with no mesh
    it raises, and so does a single-process step restored on a mesh,
    each naming both."""
    import json

    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = one_rank_mesh
    w = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    tree = {"p": {"w": DTensor.from_local(w, mesh, (Shard(0), Replicate()),
                                          run_check=False)},
            "b": torch.ones(2, dtype=torch.bfloat16)}
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save_async(4, tree, extra={"round": 4})
    ck.wait()
    step_dir = tmp_path / "ck" / "step_000000004"
    assert sorted(os.listdir(step_dir)) == ["manifest.rank00000.json"]
    meta = json.loads((step_dir / "manifest.rank00000.json").read_text())
    assert meta["mesh"] == {"data": 1, "model": 1} and meta["world"] == 1
    assert meta["leaves"]["p/w"]["global_shape"] == [3, 4]
    assert meta["leaves"]["p/w"]["placements"] == ["S(0)", "R"]
    got, extra = ck.restore(mesh=mesh)
    assert extra == {"round": 4}
    assert isinstance(got["p"]["w"], DTensor)
    assert tuple(got["p"]["w"].placements) == (Shard(0), Replicate())
    assert torch.equal(got["p"]["w"].to_local(), w)
    assert torch.equal(got["b"], tree["b"])
    with pytest.raises(ValueError, match="saved on a .*'model': 1.* mesh "
                       "of world size 1; restoring on no mesh"):
        ck.restore()
    plain = Checkpointer(str(tmp_path / "plain"))
    plain.save(1, {"w": w})
    with pytest.raises(ValueError, match="saved on no mesh; restoring on "
                       "a .*'model': 1"):
        plain.restore(mesh=mesh)
