"""The port's preset catalog (repro_torch/api/presets.py) against the JAX
package's, on the CPU (the cases of tests/test_presets.py).

Every preset builds through ``build_stack``, serializes as data, runs a
small workload end to end through the public client, reproduces its
state root, and reaches the JAX preset's root and receipts on the same
drive, bit for bit (a payload-free ledger path: hashes included).
``describe_presets()`` equals the JAX package's after JSON.
"""
import json

import pytest
import torch

import repro.api as jx
import repro_torch.api as pt
from repro_torch.core.ledger import LedgerBackend

torch.set_num_threads(1)


def _drive(api, spec, **kw):
    client = api.NodeClient.from_spec(spec, **kw)
    receipts = [client.submit("submitLocalModel", f"t{i % 4}")
                for i in range(12)]
    client.flush()
    client.run_until(8.0)
    return client, [client.refresh(r) for r in receipts]


def _receipt(r):
    d = dict(vars(r))
    d.pop("tx", None)
    return d


@pytest.mark.parametrize("name", sorted(pt.PRESETS))
def test_preset_builds_runs_and_reproduces_its_state_root(name):
    spec = pt.preset(name)
    json.dumps(spec.describe())
    chain, rollup = pt.build_stack(spec, device="cpu")
    target = rollup if rollup is not None else chain
    assert isinstance(target, LedgerBackend)
    assert pt.l1_of(pt.build_ledger(spec, device="cpu")) is not None
    client, receipts = _drive(pt, spec, device="cpu")
    want = "finalized" if spec.rollup is not None else "confirmed"
    assert all(r.status == want for r in receipts), name
    root = client.state_root()
    assert root, f"preset {name!r} must commit account state"
    client2, _ = _drive(pt, spec, device="cpu")
    assert client2.state_root() == root
    # the JAX preset on the same drive: the same root and receipts
    ref, ref_receipts = _drive(jx, jx.preset(name))
    assert root == ref.state_root()
    assert [_receipt(r) for r in receipts] == \
        [_receipt(r) for r in ref_receipts]
    assert client.chain.total_gas == ref.chain.total_gas


def test_describe_presets_matches_the_jax_catalog():
    catalog = pt.describe_presets()
    assert sorted(catalog) == sorted(pt.PRESETS) == sorted(jx.PRESETS)
    assert json.loads(json.dumps(catalog)) == \
        json.loads(json.dumps(jx.describe_presets()))


def test_preset_overrides_replace_fields():
    spec = pt.preset("shard-fabric", shards=pt.ShardSpec(count=2))
    assert spec.shards.count == 2
    assert pt.preset("prover-pipeline").prover.agg_width == 8
    assert pt.preset("prover-pipeline",
                     prover=pt.ProverSpec(agg_width=2)).prover.agg_width == 2
    with pytest.raises(KeyError):
        pt.preset("nope")
