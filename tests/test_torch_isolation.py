"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points run on the CUDA card unless the caller names the CPU."""
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.api as pt
from repro_torch.core.state import StateArrays
from repro_torch.core.workloads import make_workload
from repro_torch.device import resolve_device

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


def test_node_runs_without_jax_or_repro():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", _NODE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FOREIGN []" in out.stdout, out.stdout


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
    for call in (lambda: resolve_device(None),
                 lambda: pt.build_ledger(spec),
                 lambda: pt.build_chain(pt.ChainSpec()),
                 lambda: pt.NodeClient.from_spec(spec),
                 lambda: make_workload("poisson", 10.0, duration=1.0),
                 lambda: StateArrays()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the CPU is there when asked for
    assert pt.build_ledger(spec, device="cpu").device == torch.device("cpu")


def test_unported_backends_raise():
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        pt.build_ledger(pt.ChainSpec(backend="object"), device="cpu")
    with pytest.raises(ValueError, match="digest backend"):
        pt.RollupSpec(digest_backend="pallas")
