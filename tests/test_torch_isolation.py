"""The port stands alone: it imports neither JAX nor the JAX package (the
rollup node path, the sharded fabric, the FL protocol path with its object
stack and agents, the token-LM serving path with whisper's
encoder-decoder, the node service, the token-LM training path with
its launcher, the twins of ``examples/`` and the serving launcher's and
LeNet's mesh route all run without them), and its
entry points run on the CUDA card unless the caller names the CPU.  The
node service keeps every ledger op on the event loop's
thread: no file of ``repro_torch/serve`` hands work to a thread."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.api as pt
from repro_torch.core.ledger import Chain, simulate_load, simulate_workload
from repro_torch.core.oracle import ValidationSlices
from repro_torch.core.reputation import init_book
from repro_torch.core.state import StateArrays
from repro_torch.core.storage import BlobStore
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.core.workloads import make_workload
from repro_torch.device import resolve_device
from repro_torch.examples import (quickstart, serve_demo, serve_quickstart,
                                  train_multi_pod)
from repro_torch.fl.client import ClientConfig, TrainingAgent
from repro_torch.fl.cohort import VectorCohort
from repro_torch.fl.scheduler import Scheduler
from repro_torch.fl.server import AutoDFL
from repro_torch.kernels.shard_lanes import shard_seal, shard_seal_mesh
from repro_torch.data.pipeline import Prefetcher
from repro_torch.launch import serve_model, serve_node, train
from repro_torch.launch.mesh import make_production_mesh, make_shard_mesh
from repro_torch.models import transformer
from repro_torch.models.mlp import TinyMLP
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer
from repro_torch.serve import NodeService, replay_ops

ROOT = Path(__file__).resolve().parents[1]
_IMPORT = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:[.\s]|$)", re.M)

_NODE = """
import sys
import repro_torch.api as pt
from repro_torch.core.workloads import make_workload
wl = make_workload("mixed", 300.0, duration=2.0, seed=1, device="cpu")
c = pt.NodeClient.from_spec(pt.NodeSpec(prover=pt.ProverSpec(agg_width=2)),
                            device="cpu")
rs = c.submit_arrays(wl.txs)
c.flush()
c.run_until(30.0)
assert {c.refresh(r).status for r in rs} == {"finalized"}, "not finalized"
assert len(c.state_root()) == 32
# the sharded fabric, stepped and through the fused loop
from repro_torch.core.fused import FusedWindowLoop
from repro_torch.core.state import default_state_handlers
f = pt.NodeClient.from_spec(pt.NodeSpec(shards=pt.ShardSpec(count=4)),
                            device="cpu")
rs = f.submit_arrays(wl.txs)
f.flush()
f.run_until(30.0)
assert {f.refresh(r).status for r in rs} == {"finalized"}, "not finalized"
assert {r.shard for r in rs} == {0, 1, 2, 3}
assert f.state_root() == c.state_root()
chain, fab = pt.build_stack(pt.NodeSpec(shards=pt.ShardSpec(count=4)),
                            device="cpu")
for fn, h in default_state_handlers().items():
    fab.register_state(fn, h)
loop = FusedWindowLoop(chain, fab)
loop.submit(fab, wl.txs)
loop.flush()
loop.run_until(30.0)
loop.execute()
assert fab.gas_log == f.target.gas_log and fab.state_root() == c.state_root()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("FOREIGN", bad)
"""


_FL = """
import sys
import numpy as np
import torch
from repro_torch.api import FLTaskSpec, NodeSpec
from repro_torch.core.workloads import make_workload
from repro_torch.data.synthetic import gaussian_clusters
from repro_torch.fl.cohort import CohortKernels, VectorCohort
from repro_torch.fl.scheduler import Scheduler
from repro_torch.fl.server import AutoDFL
from repro_torch.launch import serve_model
from repro_torch.models import transformer
from repro_torch.models.mlp import TinyMLP
from repro_torch.models.model import Model, build_model
from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer
x, y = gaussian_clusters(256, 16, 10, seed=1)
vx, vy = gaussian_clusters(50, 16, 10, seed=2)
model = TinyMLP(16, 8, 10, device="cpu")
opt = make_optimizer(OptimizerSpec(name="sgdm", lr=0.1, grad_clip=5.0))
def bf(sel, rnd):
    i = np.random.default_rng(rnd).integers(0, 256, (len(sel), 2, 4))
    return {"x": torch.from_numpy(x[i]), "labels": torch.from_numpy(y[i])}
node = AutoDFL(model, opt, 3, model.accuracy_fn(), {"x": vx, "labels": vy},
               spec=NodeSpec(), device="cpu")
sch = Scheduler(node, seal_every=1, background=make_workload(
    "poisson", 5.0, duration=3.0, seed=0, device="cpu"))
for t in range(2):
    sch.add_task(FLTaskSpec(f"t{t}", rounds=2), VectorCohort(
        model, opt, bf, node.store, behaviors=["good", "malicious", "lazy"],
        local_steps=2, seed=t, device="cpu"))
out = sch.run()
assert sorted(out) == ["t0", "t1"] and node.rollup.n_batches > 0
assert len(node.rollup.state_root()) == 32
# no background, one shared CohortKernels: the default Scheduler takes
# the megastep too
node = AutoDFL(model, opt, 3, model.accuracy_fn(), {"x": vx, "labels": vy},
               spec=NodeSpec(), device="cpu")
sch = Scheduler(node, seal_every=1)
kernels = CohortKernels(model, opt)
for t in range(2):
    sch.add_task(FLTaskSpec(f"t{t}", rounds=2), VectorCohort(
        model, opt, bf, node.store, n_trainers=3, local_steps=2, seed=t,
        kernels=kernels, device="cpu"))
assert sorted(sch.run()) == ["t0", "t1"] and sch.mega_windows == 2
# the same on a sharded fabric: tasks pinned to shards
from repro_torch.api import ShardSpec
node = AutoDFL(model, opt, 3, model.accuracy_fn(), {"x": vx, "labels": vy},
               spec=NodeSpec(shards=ShardSpec(count=2)), device="cpu")
sch = Scheduler(node, seal_every=1)
for t in range(2):
    sch.add_task(FLTaskSpec(f"t{t}", rounds=2), VectorCohort(
        model, opt, bf, node.store, n_trainers=3, local_steps=2, seed=t,
        kernels=kernels, device="cpu"))
assert sorted(sch.run()) == ["t0", "t1"] and sch.mega_windows == 2
assert len(node.rollup.fabric_roots) > 0
# the legacy constructor's object stack, driven by TrainingAgents
from repro_torch.core.ledger import simulate_load
from repro_torch.core.rollup import Rollup
from repro_torch.fl.client import ClientConfig, TrainingAgent
from repro_torch.fl.partition import dirichlet_partition
node = AutoDFL(model, opt, 3, model.accuracy_fn(), {"x": vx, "labels": vy},
               device="cpu")
assert isinstance(node.rollup, Rollup)
def one(c, r):
    i = np.random.default_rng(c * 7 + r).integers(0, 256, 4)
    return {"x": x[i], "labels": y[i]}
agents = [TrainingAgent(ClientConfig(f"trainer{i}", b, local_steps=2),
                        model, opt, node.store, one, seed=i, device="cpu")
          for i, b in enumerate(["good", "malicious", "lazy"])]
res = node.run_task(FLTaskSpec("t0", rounds=2), agents)
assert res.scores.shape == (3,) and len(node.rollup.state_root()) == 32
assert simulate_load("publishTask", 20.0, duration=2.0, device="cpu",
                     engine="object")["submitted"] == 40
assert len(dirichlet_partition(y, 4)) == 4
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("FOREIGN", bad)
"""


_SERVE = """
import sys
import torch
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.launch import serve_model
from repro_torch.models.model import build_model
cfg = reduced_config(get_config("qwen2-0.5b"))
model = build_model(cfg, "cpu")
params = model.init_params(0)
tokens = torch.randint(0, cfg.vocab_size, (2, 9))
logits, caches = model.prefill(params, {"tokens": tokens})
assert logits.shape == (2, cfg.vocab_size) and torch.isfinite(logits).all()
state = model.init_decode_state(2, 12)
for kv in ("k", "v"):
    state["b0"][kv][:, :, :9] = caches["b0"][kv]
logits, state = model.decode(params, state, {"tokens": tokens[:, :1],
                                             "pos": 9})
assert torch.isfinite(logits).all()
out = serve_model.main(["--reduced", "--device", "cpu", "--host-mesh",
                        "--tokens", "3"])
assert out["tokens"].shape == (4, 3)
# the MoE and xLSTM stacks: prefill, one decode step, the serve loop
for arch in ("moonshot-v1-16b-a3b", "xlstm-1.3b"):
    cfg = reduced_config(get_config(arch))
    model = build_model(cfg, "cpu")
    params = model.init_params(0)
    logits, caches = model.prefill(params, {"tokens": tokens})
    assert torch.isfinite(logits).all() and sorted(caches) == (
        ["b0"] if arch.startswith("moonshot") else [])
    state = model.init_decode_state(2, 12)
    logits, state = model.decode(params, state, {"tokens": tokens[:, :1],
                                                 "pos": 0})
    assert torch.isfinite(logits).all()
    out = serve_model.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--host-mesh", "--tokens", "3"])
    assert out["tokens"].shape == (4, 3)
# whisper's encoder-decoder (the audio family): prefill, the cross K / V
# filled from the encoder, one decode step, one train step's gradients
import chip_smoke
from repro_torch.launch.steps import value_and_grad
cfg = reduced_config(get_config("whisper-medium"))
model = build_model(cfg, "cpu")
params = model.init_params(0)
audio = torch.randn(2, cfg.enc_seq, cfg.d_model).to(torch.bfloat16)
batch = {"audio_embeds": audio, "tokens": tokens, "labels": tokens}
logits, none = model.prefill(params, batch)
assert none is None and torch.isfinite(logits.float()).all()
state = chip_smoke.whisper_cross_state(
    model, params, model.init_decode_state(2, 4), audio)
logits, state = model.decode(params, state, {"tokens": tokens[:, :1],
                                             "pos": 0})
assert torch.isfinite(logits.float()).all()
loss, grads = value_and_grad(model, model.train_params(params), batch)
assert torch.isfinite(loss) and sorted(grads) == sorted(
    model.train_params(params))
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("FOREIGN", bad)
"""


_SERVICE = """
import asyncio
import sys
import repro_torch.api as pt
from repro_torch.launch import serve_node
from repro_torch.serve import HttpNodeServer, NodeService, http_rpc, replay_ops
spec = pt.ServeSpec(node=pt.NodeSpec(shards=pt.ShardSpec(count=2,
                                                         fabric=True)),
                    port=0, window=0.5)
async def run():
    server = HttpNodeServer(NodeService(spec, device="cpu"))
    host, port = await server.start()
    for i in range(20):
        st, body = await http_rpc(host, port, "submit", {
            "fn": "submitLocalModel", "sender": f"u{i}", "at": 0.1 * i})
        assert st == 200 and body["result"]["status"] == "queued"
    st, body = await http_rpc(host, port, "flush")
    assert body["result"]["flushed"] == 20
    st, body = await http_rpc(host, port, "receipt", {"ref": 0})
    assert body["result"]["status"] == "finalized"
    svc = server.service
    await server.close()
    return svc
svc = asyncio.run(run())
assert replay_ops(spec.node, svc.ops, device="cpu").state_root() == \
    svc.state_root()
serve_node.main(["--port", "0", "--serve-for", "0.1", "--device", "cpu"])
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("FOREIGN", bad)
"""


_TRAIN = """
import sys, tempfile
import numpy as np
import torch
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import get_config, reduced_config
from repro_torch.data.pipeline import Prefetcher, client_batch_fn
from repro_torch.data.synthetic import make_mnist_like, token_batches
from repro_torch.fl.round import FLRoundSpec, build_fl_round, digest_tree
from repro_torch.launch import train
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import build_model
from repro_torch.optim.compression import ef_compress_tree, quantize_tree
from repro_torch.optim.optimizers import (OptimizerSpec, make_optimizer,
                                          spec_for_config)
from repro_torch.runtime.fault_tolerance import ElasticController
cfg = reduced_config(get_config("qwen2-0.5b"))
model = build_model(cfg, "cpu")
params = model.train_params(model.init_params(0))
for name in ("adamw", "adafactor", "sgdm"):
    opt = make_optimizer(OptimizerSpec(name=name),
                         groups=model.param_groups(params))
    step = build_train_step(model, opt)
    batch = {k: torch.from_numpy(v) for k, v in
             next(token_batches(cfg.vocab_size, 2, 8)).items()}
    p, s, m = step(params, opt.init(params), batch)
    assert np.isfinite(float(m["loss"]))
lines = train.main(["--reduced", "--device", "cpu", "--host-mesh",
                    "--rounds", "2", "--ckpt-dir", tempfile.mkdtemp()])
assert len(lines) == 2
assert spec_for_config(cfg).name == "adamw"
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("FOREIGN", bad)
"""


_EXAMPLES = """
import sys, tempfile
import torch
import torch.distributed as dist
from repro_torch.configs.registry import get_config
from repro_torch.examples import (quickstart, serve_demo, serve_quickstart,
                                  train_multi_pod)
from repro_torch.launch import serve_model
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.model import build_model
cpu = ["--device", "cpu"]
assert len(quickstart.main(cpu + ["--steps", "1"])["losses"]) == 1
assert serve_demo.main(cpu + ["--tokens", "2"]).shape == (4, 2)
assert serve_quickstart.main(cpu)["metrics"]["admitted"] == 6
assert len(train_multi_pod.main(cpu + ["--host-mesh", "--reduced",
                                       "--rounds", "1"])) == 1
# the mesh route: the serving launcher and LeNet on a one-rank gloo mesh
with tempfile.TemporaryDirectory() as d:
    dist.init_process_group("gloo", init_method=f"file://{d}/pg", rank=0,
                            world_size=1)
    out = serve_model.main(["--reduced", "--device", "cpu", "--host-mesh",
                            "--tokens", "2"])
    assert out["tokens"].shape == (4, 2)
    lenet = build_model(get_config("lenet5"), mesh=make_host_mesh("cpu"))
    assert lenet.ctx.mesh is not None and lenet.init_params(0)
    dist.destroy_process_group()
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print("FOREIGN", bad)
"""


def _run_alone(code: str) -> None:
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FOREIGN []" in out.stdout, out.stdout


def test_node_runs_without_jax_or_repro():
    _run_alone(_NODE)


def test_fl_protocol_runs_without_jax_or_repro():
    _run_alone(_FL)


def test_serving_path_runs_without_jax_or_repro():
    _run_alone(_SERVE)


def test_node_service_runs_without_jax_or_repro():
    _run_alone(_SERVICE)


def test_training_runs_without_jax_or_repro():
    _run_alone(_TRAIN)


def test_examples_and_mesh_route_run_without_jax_or_repro():
    _run_alone(_EXAMPLES)


_THREADS = re.compile(r"to_thread|run_in_executor|threading")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "src" / "repro_torch" / "serve").rglob("*.py")))
def test_node_service_keeps_one_thread(path):
    # batch_seal's one process-wide ticket: every ledger op on the event
    # loop's thread and torch's current stream
    assert not _THREADS.findall((ROOT / path).read_text()), path


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT))
    for p in [*(ROOT / "src" / "repro_torch").rglob("*.py"),
              ROOT / "chip_smoke.py"]))
def test_sources_import_neither_jax_nor_repro(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.findall(text), path


def test_entry_points_need_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = pt.NodeSpec()
    fabric = pt.NodeSpec(shards=pt.ShardSpec(count=8))
    model = TinyMLP(8, 4, 3, device="cpu")
    opt = make_optimizer(OptimizerSpec(name="sgdm"))
    val = {"x": np.zeros((10, 8), np.float32),
           "labels": np.zeros(10, np.int32)}
    for call in (lambda: resolve_device(None),
                 lambda: pt.build_ledger(spec),
                 lambda: pt.build_chain(pt.ChainSpec()),
                 lambda: pt.build_chain(pt.ChainSpec(backend="object")),
                 lambda: pt.build_ledger(pt.NodeSpec.from_legacy()),
                 lambda: simulate_load("publishTask", 10.0, duration=1.0),
                 lambda: simulate_load("publishTask", 10.0, duration=1.0,
                                       spec=pt.ChainSpec(backend="object")),
                 lambda: simulate_workload(pt.WorkloadSpec.make(
                     "poisson", 10.0, duration=1.0)),
                 lambda: TrainingAgent(ClientConfig("t0"), model, opt,
                                       BlobStore(), None),
                 lambda: pt.NodeClient.from_spec(spec),
                 lambda: make_workload("poisson", 10.0, duration=1.0),
                 lambda: StateArrays(),
                 lambda: TinyMLP(8, 4, 3),
                 lambda: VectorCohort(model, opt, None, BlobStore(),
                                      n_trainers=2),
                 lambda: ValidationSlices(val, 5),
                 lambda: init_book(4),
                 lambda: AutoDFL(model, opt, 2, model.accuracy_fn(), val),
                 lambda: pt.build_stack(fabric),
                 lambda: pt.NodeClient.from_spec(fabric),
                 lambda: AutoDFL(model, opt, 2, model.accuracy_fn(), val,
                                 engine="vector", n_shards=2),
                 lambda: AutoDFL(model, opt, 2, model.accuracy_fn(), val,
                                 spec=fabric),
                 lambda: make_shard_mesh(),
                 lambda: NodeService(pt.ServeSpec()),
                 lambda: NodeService(pt.ServeSpec(node=fabric)),
                 lambda: replay_ops(spec, []),
                 lambda: serve_node.main(["--port", "0", "--serve-for",
                                          "0"]),
                 lambda: pt.build_node(pt.NodeSpec(n_trainers=2), model, opt,
                                       model.accuracy_fn(), val)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # a tensor off the CPU never takes the plain version: the kernel or
    # a raise
    words = torch.zeros(2, 8, dtype=torch.int32, device="meta")
    starts = torch.zeros(2, 1, dtype=torch.int64, device="meta")
    for fold in (shard_seal, shard_seal_mesh):
        with pytest.raises((RuntimeError, ValueError)):
            fold(words, starts, [1, 1], [8, 8])
    cfg = reduced_config(get_config("yi-6b"))
    whisper = reduced_config(get_config("whisper-medium"))
    for call in (lambda: Model(cfg),
                 lambda: build_model(cfg),
                 lambda: build_model(whisper),
                 lambda: transformer.init_params(cfg, torch.Generator()),
                 lambda: transformer.init_decode_state(cfg, 2, 8),
                 lambda: serve_model.main(["--reduced"]),
                 lambda: quickstart.main([]),
                 lambda: serve_demo.main([]),
                 lambda: serve_quickstart.main([]),
                 lambda: train_multi_pod.main(["--reduced"]),
                 lambda: train.main(["--reduced"]),
                 lambda: make_production_mesh(),
                 lambda: Prefetcher(iter([]))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the CPU is there when asked for
    assert build_model(cfg, "cpu").init_params(0).device.type == "cpu"
    assert pt.build_ledger(spec, device="cpu").device == torch.device("cpu")
    node = AutoDFL(model, opt, 2, model.accuracy_fn(), val,
                   spec=pt.NodeSpec(), device="cpu")
    assert node.book.reputation.device == torch.device("cpu")


def test_unported_backends_raise():
    assert isinstance(pt.build_ledger(pt.ChainSpec(backend="object"),
                                      device="cpu"), Chain)
    with pytest.raises(ValueError, match="digest backend"):
        pt.RollupSpec(digest_backend="pallas")
    model = TinyMLP(8, 4, 3, device="cpu")
    val = {"x": np.zeros((10, 8), np.float32),
           "labels": np.zeros(10, np.int32)}
    node = AutoDFL(model, make_optimizer(OptimizerSpec(name="sgdm")), 2,
                   model.accuracy_fn(), val, spec=pt.NodeSpec(),
                   device="cpu")
    # the fused loop and the megastep are ported: both knobs construct
    for kw in ({"fused": True}, {"megabatch": True}):
        assert Scheduler(node, **kw).mega_windows == 0
    sch = Scheduler(node, fused=False, megabatch=False)
    assert sch.run() == {} and sch.mega_windows == 0
