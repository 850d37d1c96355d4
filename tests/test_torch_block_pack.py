"""The port's ``block_pack`` (its plain version, which the wrapper takes
for CPU tensors) against the JAX package's ``block_pack_np`` and
``block_pack_jax``, and against the port's own stepped
``VectorChain.produce_block``; the CUDA kernels' algorithm (a jump table
of every pointer's gas stop, then a walk of one step a block) as a torch
mirror, ``block_pack_walk_torch``, on the same grid and on seeded random
streams.

Tolerance: none.  Stop pointers are integers and must be equal, element
for element, on every case (the 2^40 gas limit needs int64 compares).
``block_pack_pallas`` is not compared: under JAX 0.9 it cannot run
(``pl.load`` is gone; ROADMAP.md, queue 3).
"""
import numpy as np
import pytest
import torch

from repro.kernels.block_pack import block_pack_jax, block_pack_np
from repro_torch.core.engine import FnRegistry, TxArrays, VectorChain
from repro_torch.kernels import block_pack as bp
from repro_torch.kernels.factory import available_impls, get_kernel

torch.set_num_threads(1)

CASES = [
    (1, 1, 0, 9_000_000),
    (100, 7, 1, 9_000_000),
    (1000, 33, 2, 300_000),            # gas-capped: head-of-line carry
    (513, 16, 3, 2**40),               # limit above any cumsum: time-bound
    (64, 5, 4, 21_000),                # ~one tx per block
]


def _pack_stream(n_txs, n_blocks, seed, gas_limit):
    """Random mempool + block grid (tests/test_kernels.py's generator)."""
    g = np.random.default_rng(seed)
    submit = np.cumsum(g.exponential(0.02, n_txs))
    tmax = np.maximum.accumulate(submit)
    gcum = np.cumsum(g.integers(21_000, 120_000, n_txs).astype(np.int64))
    times = np.cumsum(g.uniform(0.05, 1.5, n_blocks))
    n_vis = np.sort(g.integers(0, n_txs + 1, n_blocks)).astype(np.int64)
    return tmax, gcum, times, n_vis, gas_limit


def _torch_args(tmax, gcum, times, n_vis, gas_limit):
    return (torch.from_numpy(tmax), torch.from_numpy(gcum),
            torch.from_numpy(times), torch.from_numpy(n_vis), gas_limit)


@pytest.mark.parametrize("start", ["zero", "first_stop"])
@pytest.mark.parametrize("n_txs,n_blocks,seed,gas_limit", CASES)
def test_block_pack_matches_jax(n_txs, n_blocks, seed, gas_limit, start):
    args = _pack_stream(n_txs, n_blocks, seed, gas_limit)
    ptr0 = 0 if start == "zero" else int(block_pack_np(*args, 0)[0])
    want = block_pack_np(*args, ptr0)
    np.testing.assert_array_equal(block_pack_jax(*args, ptr0), want)
    targs = _torch_args(*args)
    for fn in (bp.block_pack_torch, bp.block_pack):
        got = fn(*targs, ptr0)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def test_block_pack_empty_mempool():
    """N = 0: every block packs nothing, every stop stays at ptr0."""
    args = (np.zeros(0), np.zeros(0, np.int64), np.arange(1.0, 5.0),
            np.zeros(4, np.int64), 9_000_000)
    want = block_pack_np(*args, 0)
    np.testing.assert_array_equal(want, np.zeros(4, np.int64))
    np.testing.assert_array_equal(block_pack_jax(*args, 0), want)
    np.testing.assert_array_equal(bp.block_pack(*_torch_args(*args), 0)
                                  .numpy(), want)


def test_block_pack_head_of_line_stalls():
    """A future-stamped head tx stalls the queue behind it (the running
    max), and so does a tx whose gas alone exceeds the limit."""
    submit = np.array([0.1, 5.0, 0.2, 0.3])          # tx 1 is future
    tmax = np.maximum.accumulate(submit)
    gcum = np.cumsum(np.array([10, 10, 500, 10], np.int64))
    times = np.array([1.0, 2.0, 6.0, 7.0, 8.0])
    n_vis = np.full(5, 4, np.int64)
    for limit in (100, 1000):
        args = (tmax, gcum, times, n_vis, limit)
        want = block_pack_np(*args, 0)
        got = bp.block_pack(*_torch_args(*args), 0).numpy()
        np.testing.assert_array_equal(got, want)
    # limit 100: tx 2 (gas 500) never fits, the queue stays behind it
    np.testing.assert_array_equal(
        bp.block_pack(*_torch_args(tmax, gcum, times, n_vis, 100), 0)
        .numpy(), [1, 1, 2, 2, 2])


def test_block_pack_matches_stepped_produce_block():
    """The packing decision IS produce_block's, B blocks at once."""
    g = np.random.default_rng(11)
    n = 200
    fns = FnRegistry()
    batch = TxArrays.from_numpy(
        np.cumsum(g.exponential(0.05, n)),
        g.integers(21_000, 90_000, n).astype(np.int64),
        np.full(n, fns.id("bgPing"), np.int32), np.zeros(n, np.int32), fns,
        "cpu")
    chain = VectorChain(device="cpu")
    chain.submit_arrays(batch)
    chain.run_until(float(batch.submit_time[-1]) + 2.0)
    stepped = [(b.start, b.stop) for b in chain.blocks[1:]]
    times = torch.tensor([b.time for b in chain.blocks[1:]],
                         dtype=torch.float64)
    chain2 = VectorChain(device="cpu")
    chain2.submit_arrays(batch)
    chain2._consolidate()
    stops = bp.block_pack(chain2._tmax[:n], chain2._gcum[:n], times,
                          torch.full(times.shape, n, dtype=torch.int64),
                          chain2.block_gas_limit, 0).tolist()
    assert list(zip([0] + stops[:-1], stops)) == stepped


def test_block_pack_factory_and_checks():
    assert available_impls("block_pack") == ("cuda", "torch")
    assert get_kernel("block_pack") is bp.block_pack
    assert get_kernel("block_pack", "torch") is bp.block_pack_torch
    args = _torch_args(*_pack_stream(10, 3, 0, 9_000_000))
    with pytest.raises(TypeError, match="tmax"):
        bp.block_pack(args[0].float(), *args[1:], 0)
    with pytest.raises(ValueError, match="ptr0"):
        bp.block_pack(*args, 11)
    before = bp.block_pack.launches
    bp.block_pack(*args, 0)
    assert bp.block_pack.launches == before     # CPU: no launch


@pytest.mark.parametrize("start", ["zero", "first_stop"])
@pytest.mark.parametrize("n_txs,n_blocks,seed,gas_limit", CASES)
def test_jump_table_walk_matches_jax(n_txs, n_blocks, seed, gas_limit,
                                     start):
    """The kernels' algorithm (``block_pack_walk_torch``: the jump table of
    every pointer's gas stop, then one step a block) equals
    ``block_pack_np`` bit for bit on the grid above."""
    args = _pack_stream(n_txs, n_blocks, seed, gas_limit)
    ptr0 = 0 if start == "zero" else int(block_pack_np(*args, 0)[0])
    got = bp.block_pack_walk_torch(*_torch_args(*args), ptr0)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), block_pack_np(*args, ptr0))


def _random_stream(g):
    """A mempool with future-stamped txs (stalls on the running max) and
    txs whose gas alone exceeds the limit, or none at all; a start
    pointer anywhere in it."""
    n = int(g.choice([0, 1, int(g.integers(2, 400))]))
    submit = np.cumsum(g.exponential(0.02, n))
    for i in g.integers(0, max(n, 1), int(g.integers(0, 3)) if n else 0):
        submit[i] += g.uniform(0, 5)
    gas = g.integers(21_000, 120_000, n).astype(np.int64)
    limit = int(g.choice([0, 21_000, 300_000, 9_000_000, 2**40]))
    for i in g.integers(0, max(n, 1), int(g.integers(0, 3)) if n else 0):
        gas[i] = limit + int(g.integers(1, 10**6))
    n_blocks = int(g.integers(1, 60))
    times = np.cumsum(g.uniform(0.05, 1.5, n_blocks))
    n_vis = np.sort(g.integers(0, n + 1, n_blocks)).astype(np.int64)
    return (np.maximum.accumulate(submit), np.cumsum(gas), times, n_vis,
            limit), int(g.integers(0, n + 1))


@pytest.mark.parametrize("seed", range(8))
def test_jump_table_walk_random_streams(seed):
    """50 seeded random streams a case: stalls, oversized txs, ptr0 > 0,
    empty mempools and limits from 0 to 2^40; the walk equals
    ``block_pack_np`` and the plain version bit for bit, and the table's
    entry i is never below i."""
    g = np.random.default_rng(1000 + seed)
    for _ in range(50):
        args, ptr0 = _random_stream(g)
        want = block_pack_np(*args, ptr0)
        targs = _torch_args(*args)
        np.testing.assert_array_equal(
            bp.block_pack_walk_torch(*targs, ptr0).numpy(), want)
        np.testing.assert_array_equal(
            bp.block_pack_torch(*targs, ptr0).numpy(), want)
        table = bp.jump_table(targs[1], args[4])
        assert table.shape == (len(args[1]) + 1,)
        assert (table >= torch.arange(len(args[1]) + 1)).all()


def test_walk_table_staging_threshold():
    """The walk reads the table from shared memory up to about 56,000
    entries (the fused node run's 50,042 txs among them) and from device
    memory past it."""
    assert bp.table_staged(50_042) and bp.table_staged(0)
    assert not bp.table_staged(300_000)
    n = bp.SMEM_LIMIT // 4 - bp.WALK_CHUNK - 1
    assert bp.table_staged(n) and not bp.table_staged(n + 1)
