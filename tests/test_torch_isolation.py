"""The port stands alone: it imports neither JAX nor the JAX package (the
rollup node path and the FL protocol path both run without them), and its
entry points run on the CUDA card unless the caller names the CPU."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.api as pt
from repro_torch.core.oracle import ValidationSlices
from repro_torch.core.reputation import init_book
from repro_torch.core.state import StateArrays
from repro_torch.core.storage import BlobStore
from repro_torch.core.workloads import make_workload
from repro_torch.device import resolve_device
from repro_torch.fl.cohort import VectorCohort
from repro_torch.fl.scheduler import Scheduler
from repro_torch.fl.server import AutoDFL
from repro_torch.models.mlp import TinyMLP
from repro_torch.optim.optimizers import OptimizerSpec, make_optimizer

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
from repro_torch.fl.cohort import VectorCohort
from repro_torch.fl.scheduler import Scheduler
from repro_torch.fl.server import AutoDFL
from repro_torch.models.mlp import TinyMLP
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
    model = TinyMLP(8, 4, 3, device="cpu")
    opt = make_optimizer(OptimizerSpec(name="sgdm"))
    val = {"x": np.zeros((10, 8), np.float32),
           "labels": np.zeros(10, np.int32)}
    for call in (lambda: resolve_device(None),
                 lambda: pt.build_ledger(spec),
                 lambda: pt.build_chain(pt.ChainSpec()),
                 lambda: pt.NodeClient.from_spec(spec),
                 lambda: make_workload("poisson", 10.0, duration=1.0),
                 lambda: StateArrays(),
                 lambda: TinyMLP(8, 4, 3),
                 lambda: VectorCohort(model, opt, None, BlobStore(),
                                      n_trainers=2),
                 lambda: ValidationSlices(val, 5),
                 lambda: init_book(4),
                 lambda: AutoDFL(model, opt, 2, model.accuracy_fn(), val)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the CPU is there when asked for
    assert pt.build_ledger(spec, device="cpu").device == torch.device("cpu")
    node = AutoDFL(model, opt, 2, model.accuracy_fn(), val, device="cpu")
    assert node.book.reputation.device == torch.device("cpu")


def test_unported_backends_raise():
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        pt.build_ledger(pt.ChainSpec(backend="object"), device="cpu")
    with pytest.raises(ValueError, match="digest backend"):
        pt.RollupSpec(digest_backend="pallas")
    model = TinyMLP(8, 4, 3, device="cpu")
    val = {"x": np.zeros((10, 8), np.float32),
           "labels": np.zeros(10, np.int32)}
    node = AutoDFL(model, make_optimizer(OptimizerSpec(name="sgdm")), 2,
                   model.accuracy_fn(), val, device="cpu")
    for kw in ({"fused": True}, {"megabatch": True}):
        with pytest.raises(NotImplementedError, match="queue 1 item 3"):
            Scheduler(node, **kw)
    assert Scheduler(node, fused=False, megabatch=False).mega_windows == 0
