"""Scenario workload generator for the L1/L2 transaction engines.

Every generator is seedable and returns a ``Workload`` — a time-sorted
``TxArrays`` batch plus metadata.  The draws are made on the host with the
same ``numpy.random.Generator`` streams as ``src/repro/core/workloads.py``
(so both packages see the same transactions); the batch is then placed on
``device`` (the card unless named).  Sorting by submit time is the
documented guard against head-of-line blocking skew: both engines pack
blocks FIFO in *submission* order and stall at the first future-timestamped
tx (see engine.VectorChain.produce_block), so workloads always submit in
nondecreasing time order.

Catalog (`SCENARIOS`):
  poisson      — steady-state Poisson arrivals of one function type
  bursty       — baseline Poisson + flash-crowd burst windows
  diurnal      — sinusoidally modulated rate (day/night cycle), via thinning
  mixed        — Table-I function mix at one aggregate rate
  spam         — honest baseline + adversarial spam flood of the cheapest
                 function from a handful of senders
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.core.engine import FnRegistry, TxArrays
from repro_torch.core.gas import DEFAULT_GAS, GasTable, l1_gas_vector

# Table-I-flavoured function mix: model submissions dominate a round, with
# objective/subjective reputation updates trailing and rare task publishes.
TABLE_I_MIX: Dict[str, float] = {
    "publishTask": 0.02,
    "submitLocalModel": 0.55,
    "calculateObjectiveRep": 0.28,
    "calculateSubjectiveRep": 0.15,
}


@dataclasses.dataclass
class Workload:
    name: str
    txs: TxArrays               # sorted by submit_time
    duration: float
    seed: int
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.txs)

    def to_txs(self):
        """Materialize object ``Tx``s for the compatibility engine path."""
        from repro_torch.core.ledger import Tx
        a = self.txs
        names = a.fns.names
        return [Tx(names[f], f"client{s}", {}, g, t)
                for f, s, g, t in zip(a.fn_id.tolist(), a.sender_id.tolist(),
                                      a.gas.tolist(),
                                      a.submit_time.tolist())]


def _assemble(name: str, times: np.ndarray, fn_ids: np.ndarray,
              senders: np.ndarray, fns: FnRegistry, gas_table: GasTable,
              duration: float, seed: int, device=None,
              **meta) -> Workload:
    order = np.argsort(times, kind="stable")
    gas_vec = l1_gas_vector(fns.names, gas_table)
    txs = TxArrays.from_numpy(times[order], gas_vec[fn_ids[order]],
                              fn_ids[order], senders[order], fns, device)
    return Workload(name, txs, duration, seed, dict(meta))


def _poisson_times(rng, rate: float, duration: float) -> np.ndarray:
    n = rng.poisson(rate * duration)
    return rng.uniform(0.0, duration, n)


def poisson_workload(rate: float, duration: float = 30.0,
                     fn: str = "submitLocalModel", seed: int = 0,
                     n_senders: int = 64,
                     gas_table: GasTable = DEFAULT_GAS,
                     device=None) -> Workload:
    """Steady-state Poisson arrivals of one function type."""
    rng = np.random.default_rng(seed)
    times = _poisson_times(rng, rate, duration)
    fns = FnRegistry([fn])
    return _assemble("poisson", times, np.zeros(len(times), np.int32),
                     rng.integers(0, n_senders, len(times)), fns, gas_table,
                     duration, seed, device, rate=rate, fn=fn)


def bursty_workload(base_rate: float, burst_rate: float,
                    duration: float = 30.0, burst_start: float = 10.0,
                    burst_len: float = 5.0, fn: str = "submitLocalModel",
                    seed: int = 0, n_senders: int = 64,
                    gas_table: GasTable = DEFAULT_GAS,
                    device=None) -> Workload:
    """Flash crowd: Poisson baseline plus a burst window at burst_rate."""
    rng = np.random.default_rng(seed)
    t_base = _poisson_times(rng, base_rate, duration)
    burst_start = min(burst_start, duration)
    burst_len = min(burst_len, duration - burst_start)   # clip to window
    n_burst = rng.poisson(max(0.0, burst_rate - base_rate) * burst_len)
    t_burst = burst_start + rng.uniform(0.0, burst_len, n_burst)
    times = np.concatenate([t_base, t_burst])
    fns = FnRegistry([fn])
    return _assemble("bursty", times, np.zeros(len(times), np.int32),
                     rng.integers(0, n_senders, len(times)), fns, gas_table,
                     duration, seed, device, base_rate=base_rate,
                     burst_rate=burst_rate, burst_start=burst_start,
                     burst_len=burst_len, fn=fn)


def diurnal_workload(mean_rate: float, duration: float = 30.0,
                     period: Optional[float] = None, depth: float = 0.8,
                     fn: str = "submitLocalModel", seed: int = 0,
                     n_senders: int = 64,
                     gas_table: GasTable = DEFAULT_GAS,
                     device=None) -> Workload:
    """Sinusoidal day/night rate via Poisson thinning:
    lambda(t) = mean_rate * (1 + depth * sin(2 pi t / period))."""
    assert 0.0 <= depth <= 1.0
    rng = np.random.default_rng(seed)
    period = period or duration
    peak = mean_rate * (1.0 + depth)
    cand = _poisson_times(rng, peak, duration)
    lam = mean_rate * (1.0 + depth * np.sin(2 * np.pi * cand / period))
    keep = cand[rng.uniform(0.0, peak, len(cand)) < lam]
    fns = FnRegistry([fn])
    return _assemble("diurnal", keep, np.zeros(len(keep), np.int32),
                     rng.integers(0, n_senders, len(keep)), fns, gas_table,
                     duration, seed, device, mean_rate=mean_rate,
                     period=period,
                     depth=depth, fn=fn)


def mixed_function_workload(rate: float, duration: float = 30.0,
                            mix: Optional[Dict[str, float]] = None,
                            seed: int = 0, n_senders: int = 64,
                            gas_table: GasTable = DEFAULT_GAS,
                            device=None) -> Workload:
    """Aggregate Poisson rate split across the Table-I function mix."""
    mix = mix or TABLE_I_MIX
    rng = np.random.default_rng(seed)
    times = _poisson_times(rng, rate, duration)
    fns = FnRegistry(mix.keys())
    p = np.array(list(mix.values()), np.float64)
    p = p / p.sum()
    fn_ids = rng.choice(len(p), size=len(times), p=p)
    return _assemble("mixed", times, fn_ids.astype(np.int32),
                     rng.integers(0, n_senders, len(times)), fns, gas_table,
                     duration, seed, device, rate=rate, mix=dict(mix))


def adversarial_spam_workload(honest_rate: float, spam_rate: float,
                              duration: float = 30.0,
                              spam_start: float = 5.0,
                              spam_len: float = 10.0,
                              fn: str = "submitLocalModel",
                              spam_fn: str = "calculateSubjectiveRep",
                              n_spammers: int = 4, seed: int = 0,
                              n_senders: int = 64,
                              gas_table: GasTable = DEFAULT_GAS,
                              device=None) -> Workload:
    """Adversarial spam: a few senders flood the cheapest function during a
    window, racing honest traffic for block gas."""
    rng = np.random.default_rng(seed)
    t_h = _poisson_times(rng, honest_rate, duration)
    spam_start = min(spam_start, duration)
    spam_len = min(spam_len, duration - spam_start)      # clip to window
    n_s = rng.poisson(spam_rate * spam_len)
    t_s = spam_start + rng.uniform(0.0, spam_len, n_s)
    fns = FnRegistry([fn, spam_fn])
    times = np.concatenate([t_h, t_s])
    fn_ids = np.concatenate([np.zeros(len(t_h), np.int32),
                             np.full(n_s, fns.id(spam_fn), np.int32)])
    senders = np.concatenate([
        rng.integers(n_spammers, n_spammers + n_senders, len(t_h)),
        rng.integers(0, n_spammers, n_s)])
    return _assemble("spam", times, fn_ids, senders, fns, gas_table,
                     duration, seed, device, honest_rate=honest_rate,
                     spam_rate=spam_rate, spam_fn=spam_fn,
                     n_spammers=n_spammers)


SCENARIOS: Dict[str, Callable[..., Workload]] = {
    "poisson": poisson_workload,
    "bursty": lambda rate, **kw: bursty_workload(
        base_rate=rate, burst_rate=4.0 * rate, **kw),
    "diurnal": lambda rate, **kw: diurnal_workload(mean_rate=rate, **kw),
    "mixed": mixed_function_workload,
    "spam": lambda rate, **kw: adversarial_spam_workload(
        honest_rate=rate, spam_rate=4.0 * rate, **kw),
}


def make_workload(name: str, rate: float, duration: float = 30.0,
                  seed: int = 0, device=None, **kw) -> Workload:
    """Scenario ``name`` from the catalog, its batch on ``device`` (the
    CUDA card unless named; raises without one)."""
    try:
        factory = SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"catalog: {sorted(SCENARIOS)}") from None
    return factory(rate, duration=duration, seed=seed, device=device, **kw)
