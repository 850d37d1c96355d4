"""Public node API of the port: typed specs, one ledger factory, an
RPC-style client.  Entry points run on the CUDA card unless the caller
passes ``device=``; the names and ``__all__`` are the JAX package's
(``src/repro/api/__init__.py``).

    from repro_torch.api import ChainSpec, NodeSpec, NodeClient, build_ledger

    client = NodeClient.from_spec(NodeSpec())      # vector L1 + rollup
    rcpt = client.submit("submitLocalModel", "trainer0")
    client.flush(); client.run_until(10.0)
    rcpt = client.refresh(rcpt)      # finalized: batch, gas, L1 block,
    for ev in client.events():       # proof/aggregate refs + the typed
        ...                          # BatchSealed/ProofGenerated/... feed
"""
from repro_torch.api.client import (RECEIPT_STATUSES, AccountView,
                                    NodeClient, TxReceipt)
from repro_torch.api.factory import (build_chain, build_ledger, build_node,
                                     build_stack, l1_of)
from repro_torch.api.presets import PRESETS, describe_presets, preset
from repro_torch.api.specs import (AdmissionSpec, ChainSpec, DONSpec,
                                   FLTaskSpec, NodeSpec, ProverSpec,
                                   ReputationSpec, RollupSpec, ServeSpec,
                                   ShardSpec, WorkloadSpec, as_task_spec)
from repro_torch.core.events import (AggregateVerified, BatchSealed,
                                     BlockPacked, EventsDropped, LedgerEvent,
                                     ProofGenerated, WindowSettled)

__all__ = [
    "AccountView", "NodeClient", "TxReceipt", "RECEIPT_STATUSES",
    "build_chain", "build_ledger", "build_node", "build_stack", "l1_of",
    "PRESETS", "describe_presets", "preset",
    "AdmissionSpec", "ChainSpec", "DONSpec", "FLTaskSpec", "NodeSpec",
    "ProverSpec", "ReputationSpec", "RollupSpec", "ServeSpec", "ShardSpec",
    "WorkloadSpec", "as_task_spec",
    "LedgerEvent", "BatchSealed", "ProofGenerated", "AggregateVerified",
    "WindowSettled", "BlockPacked", "EventsDropped",
]
