"""EVM-style gas cost model, calibrated against paper Table I.

L1: every call costs a fixed per-function gas (storage writes + compute).
L2 (zk-rollup): per batch of up to ROLLUP_BATCH calls,
    commit  = base_f + n_calls * percall_f     (calldata posted to L1)
    verify  ~ constant (one SNARK verification per submission)
    execute ~ constant (state-root update)

Host-only module: a copy of ``src/repro/core/gas.py``.

Calibration (least-squares on Table I rows):
    function              L1/call   commit_base  commit/call
    publishTask           182186       39385        4383
    submitLocalModel       50222       37078        1502
    calculateObjectiveRep  53163       36495         233
    calculateSubjectiveRep 39259       35850          34
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

ROLLUP_BATCH = 20

FUNCTIONS = ("publishTask", "submitLocalModel",
             "calculateObjectiveRep", "calculateSubjectiveRep")


@dataclasses.dataclass(frozen=True)
class GasTable:
    # L1 is affine in n (cold-storage premium on the first call, then a
    # constant marginal cost — fits Table I's 5-call and 100-call rows):
    #   l1_total(n) = l1_first_extra + n * l1_marginal
    l1_per_call: Dict[str, int]      # 5-call average (drives the chain sim)
    l1_marginal: Dict[str, int]
    l1_first_extra: Dict[str, int]
    commit_base: Dict[str, int]
    commit_per_call: Dict[str, int]
    verify_single: int = 27272
    verify_multi: int = 29900
    execute_single: int = 23964
    execute_multi: int = 26600


DEFAULT_GAS = GasTable(
    l1_per_call={
        "publishTask": 182186,
        "submitLocalModel": 50222,
        "calculateObjectiveRep": 53163,
        "calculateSubjectiveRep": 39259,
    },
    l1_marginal={
        "publishTask": 177113,
        "submitLocalModel": 40890,
        "calculateObjectiveRep": 42457,
        "calculateSubjectiveRep": 35025,
    },
    l1_first_extra={
        "publishTask": 25366,
        "submitLocalModel": 46658,
        "calculateObjectiveRep": 53530,
        "calculateSubjectiveRep": 21171,
    },
    commit_base={
        "publishTask": 39385,
        "submitLocalModel": 37078,
        "calculateObjectiveRep": 36495,
        "calculateSubjectiveRep": 35850,
    },
    commit_per_call={
        "publishTask": 4383,
        "submitLocalModel": 1502,
        "calculateObjectiveRep": 233,
        "calculateSubjectiveRep": 34,
    },
)


def l1_gas(fn: str, n_calls: int, table: GasTable = DEFAULT_GAS) -> int:
    return table.l1_first_extra[fn] + table.l1_marginal[fn] * n_calls


def n_batches(n_calls: int) -> int:
    return max(1, math.ceil(n_calls / ROLLUP_BATCH))


def l2_gas(fn: str, n_calls: int, table: GasTable = DEFAULT_GAS) -> Dict[str, int]:
    nb = n_batches(n_calls)
    commit = nb * table.commit_base[fn] + n_calls * table.commit_per_call[fn]
    verify = table.verify_single if nb == 1 and n_calls <= 5 else table.verify_multi
    execute = table.execute_single if nb == 1 and n_calls <= 5 else table.execute_multi
    return {"batches": nb, "commit": commit, "verify": verify,
            "execute": execute, "total": commit + verify + execute}


def gas_reduction(fn: str, n_calls: int, table: GasTable = DEFAULT_GAS) -> float:
    return l1_gas(fn, n_calls, table) / l2_gas(fn, n_calls, table)["total"]


# -- vectorized views (SoA engine, core/engine.py) ------------------------------
L1_DEFAULT_GAS = 30_000          # unknown-fn fallback, matches fl/server.py
COMMIT_BASE_DEFAULT = 37_000     # unknown-fn fallbacks, match Rollup._settle
COMMIT_PER_CALL_DEFAULT = 500


def l1_gas_vector(fn_names, table: GasTable = DEFAULT_GAS):
    """Per-fn L1 gas as an int64 array indexable by engine fn_id."""
    import numpy as np
    return np.array([table.l1_per_call.get(n, L1_DEFAULT_GAS)
                     for n in fn_names], np.int64)


def commit_gas_vectors(fn_names, table: GasTable = DEFAULT_GAS):
    """(commit_base, commit_per_call) int64 arrays indexable by fn_id."""
    import numpy as np
    base = np.array([table.commit_base.get(n, COMMIT_BASE_DEFAULT)
                     for n in fn_names], np.int64)
    percall = np.array([table.commit_per_call.get(n, COMMIT_PER_CALL_DEFAULT)
                        for n in fn_names], np.int64)
    return base, percall
