"""The io probes (ofdm_ls_mrc_tpu_torch.tools.dma_probe) against the JAX
``tools/dma_probe.make_io_fn`` kernels run in TPU interpret mode.

Inputs are made with numpy from a seed.  Tolerance 1e-5 max-abs/max|want|:
sums of a few float32 values taken in another order (the burn adds 1e-9
of values of order one, below float32 resolution at the sums' scale).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from ofdm_ls_mrc_tpu_torch.tools import dma_probe

TOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_dma_probe", REPO / "tools" / "dma_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_TOOL = _jax_tool()


def max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def planes(s, a, n1, n2, seed):
    rng = np.random.default_rng(seed)
    yre = rng.standard_normal((s, a, n1, n2)).astype(np.float32)
    yim = rng.standard_normal((s, a, n1, n2)).astype(np.float32)
    bias = rng.standard_normal((n1, n2)).astype(np.float32)
    w = (0.1 * rng.standard_normal((n2, n2))).astype(np.float32)
    return yre, yim, bias, w


# (S, A, n1, n2, ts): S = 5 is not a multiple of ts = 2 (ragged last window).
SHAPE = (5, 3, 2, 128, 2)


@pytest.mark.parametrize("compute", [0, 2])
@pytest.mark.parametrize("variant", ["auto", "manual2", "manual3s", "manual4", "manual2s"])
def test_probe_matches_jax_kernel(variant, compute):
    s, a, n1, n2, ts = SHAPE
    yre, yim, bias, w = planes(s, a, n1, n2, seed=compute)
    with pltpu.force_tpu_interpret_mode():
        fn = JAX_TOOL.make_io_fn(variant, s, a, n1, n2, ts, compute=compute)
        want = [np.asarray(o) for o in fn(jnp.asarray(yre), jnp.asarray(yim),
                                          jnp.asarray(bias), jnp.asarray(w))]
    f = n1 * n2
    args = (torch.from_numpy(yre.reshape(s, a, f)), torch.from_numpy(yim.reshape(s, a, f)),
            torch.from_numpy(bias.reshape(f)), torch.from_numpy(w))
    plain = dma_probe.io_probe_plain(*args, compute)
    wrapped = dma_probe.io_probe(*args, variant=variant, ts=ts, compute=compute)
    for got, ref, jax_out in zip(plain, wrapped, want):
        assert max_rel(got.numpy().reshape(s, n1, n2), jax_out) < TOL
        np.testing.assert_array_equal(ref.numpy(), got.numpy())


def test_burn_is_chained_bf16_products():
    """burn_plain == n chained products with bf16 rounding after each, the
    JAX tool's burn (tools/dma_probe.py:54-60), on the same rows."""
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((6, 128)).astype(np.float32)
    w = (0.1 * rng.standard_normal((128, 128))).astype(np.float32)
    acc = jnp.asarray(rows).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    for _ in range(3):
        acc = jnp.dot(acc, wb, preferred_element_type=jnp.float32).astype(jnp.bfloat16)
    want = np.asarray(acc.astype(jnp.float32))
    got = dma_probe.burn_plain(torch.from_numpy(rows), torch.from_numpy(w), 3).numpy()
    # One bf16 step (2^-8 relative) where the two sums round apart.
    assert max_rel(got, want) < 2 ** -7


@pytest.mark.parametrize("variant,want", [("auto", (0, False)), ("manual2", (2, False)),
                                          ("manual3s", (3, True)), ("manual4", (4, False))])
def test_parse_variant(variant, want):
    assert dma_probe.parse_variant(variant) == want


def test_probe_rejects_what_the_kernels_do_not_take():
    y = torch.zeros((16, 16, 1024))
    b, w = torch.zeros(1024), torch.zeros((128, 128))
    for variant in ("manual1", "manual5", "manuals", "bogus"):
        with pytest.raises(ValueError, match="unknown variant"):
            dma_probe.io_probe(y, y, b, w, variant=variant)
    with pytest.raises(ValueError, match="shared memory"):  # 3 x 128 KB slots
        dma_probe.io_probe(y, y, b, w, variant="manual3", ts=8)
    with pytest.raises(ValueError, match="ts="):
        dma_probe.io_probe(y, y, b, w, variant="manual2", ts=3)
    with pytest.raises(ValueError, match="ts="):
        dma_probe.io_probe(y[:1], y[:1], b, w, variant="manual2", ts=2)
    with pytest.raises(ValueError, match="multiple of 128"):
        dma_probe.io_probe(y[..., :100], y[..., :100], b[:100], w)
    wide = torch.zeros((2, 257, 128))   # the antennas of a window are one TMA box
    with pytest.raises(ValueError, match="TMA box"):
        dma_probe.io_probe(wide, wide, b[:128], w, variant="manual2", ts=1)


def test_shared_memory_sizes():
    """The Python side's sizes follow the kernels' layout: the ring's
    mbarriers (8 bytes each: per stage one full barrier, or one per symbol
    in the "s" form, and one empty barrier; rounded up to 128 bytes), ring
    slots of 2 planes x ts x A x 128 floats, plus the burn's bf16 W, row
    buffers and per-symbol sums."""
    burn = 128 * 128 * 2 + 4 * 128 * 4
    assert dma_probe.smem_bytes("auto", 2, 16, 0) == 0
    assert dma_probe.smem_bytes("auto", 2, 16, 2) == 16 * 512 + burn + 512
    assert dma_probe.ring_barrier_bytes(3, 2, False) == 128         # 3 full + 3 empty: 48
    assert dma_probe.ring_barrier_bytes(2, 4, True) == 128          # 2 x 4 full + 2 empty: 80
    assert dma_probe.ring_barrier_bytes(4, 8, True) == 384          # 4 x 8 full + 4 empty: 288
    assert dma_probe.ring_barrier_bytes(3, 8, True) == 256          # 3 x 8 full + 3 empty: 216
    assert dma_probe.smem_bytes("manual3", 2, 16, 0) == 128 + 3 * 2 * 2 * 16 * 512
    assert dma_probe.smem_bytes("manual2s", 4, 8, 1) == (128 + 2 * 2 * 4 * 8 * 512 + burn
                                                         + 4 * 512)
    # The tool's default window fits every depth with the burn at 16
    # antennas; ts = 8 (128 KB a slot) fits none.
    for depth in dma_probe.DEPTHS:
        assert dma_probe.smem_bytes(f"manual{depth}", 2, 16, 2) <= dma_probe.SMEM_LIMIT
    assert dma_probe.smem_bytes("manual2", 8, 16, 0) > dma_probe.SMEM_LIMIT


# ---------------------------------------------------------------------------
# The ring's schedule and barriers (csrc/io_probe.cu io_manual_kernel)
# ---------------------------------------------------------------------------

class MBarrier:
    """An mbarrier as PTX defines it: a phase completes when its pending
    arrivals and its transaction bytes both reach zero, which re-arms the
    arrivals; a wait on parity P passes once the last phase of parity P has
    completed, that is while the current phase's parity is not P."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def arrive(self, expect_tx=0):
        self.tx += expect_tx
        self.pending -= 1
        assert self.pending >= 0, "more arrivals than the barrier counts"
        self._complete()

    def complete_tx(self, nbytes):
        self.tx -= nbytes
        self._complete()

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def passed(self, parity):
        return (self.phase & 1) != parity


def run_block(block, grid, items, depth, ts, per_symbol, antennas, warps, rng):
    """One block of the kernel, its producer lane, its consumer warps and
    its copies in flight stepped in a random order; returns the items each
    warp reduced, asserting on the way that every read follows its full
    barrier and every refill its empty barrier."""
    sched = dma_probe.ring_schedule(block, grid, items, depth)
    nfull = ts if per_symbol else 1
    full = [[MBarrier(1) for _ in range(nfull)] for _ in range(depth)]
    empty = [MBarrier(warps) for _ in range(depth)]
    slot = [np.full((ts, 2, antennas), -1) for _ in range(depth)]
    released = np.zeros((depth, warps), int)   # uses of a stage each warp has released
    copies = []                                # in flight: (stage, symbols, plane, item, barrier)
    reduced = [[] for _ in range(warps)]

    def producer():
        for it, (item, s, parity) in enumerate(sched):
            yield lambda s=s, parity=parity: empty[s].passed(parity ^ 1)
            use = it // depth
            assert np.all(released[s] == use), "refill before every warp released the slot"
            for b, bar in enumerate(full[s]):    # arm, then one copy a plane
                bar.arrive(expect_tx=(ts // nfull) * 2 * antennas * 512)
                syms = [b] if per_symbol else list(range(ts))
                for plane in range(2):
                    copies.append((s, syms, plane, item, bar))

    def consumer(w):
        for it, (item, s, parity) in enumerate(sched):
            for k in range(ts):
                bar = full[s][k if per_symbol else 0]
                if per_symbol or k == 0:
                    yield lambda bar=bar, parity=parity: bar.passed(parity)
                assert np.all(slot[s][k] == item), "read before the symbol landed"
            reduced[w].append(item)
            yield lambda: True                 # the reduce (and burn) in progress
            assert np.all(slot[s] == item), "slot overwritten while it was read"
            released[s, w] += 1
            empty[s].arrive()

    actors = [producer()] + [consumer(w) for w in range(warps)]
    waits = [lambda: True] * len(actors)
    while actors or copies:
        ready = [i for i, cond in enumerate(waits) if cond()]
        choices = [("actor", i) for i in ready] + [("copy", i) for i in range(len(copies))]
        assert choices, "deadlock"
        kind, i = choices[rng.integers(len(choices))]
        if kind == "copy":
            s, syms, plane, item, bar = copies.pop(i)
            slot[s][syms, plane, :] = item
            bar.complete_tx(len(syms) * antennas * 512)
            continue
        try:
            waits[i] = next(actors[i])
        except StopIteration:
            del actors[i], waits[i]
    return reduced


@pytest.mark.parametrize("per_symbol", [False, True])
@pytest.mark.parametrize("depth", dma_probe.DEPTHS)
def test_ring_schedule_and_barriers(depth, per_symbol):
    """A Python mirror of the kernel's ring for every window height: each
    item's stage and phase parity, every read after its full barrier, every
    refill after its empty barrier, and each item reduced once, over a
    ragged item count across blocks (23 items on 4 blocks)."""
    rng = np.random.default_rng(10 * depth + per_symbol)
    items, grid, warps, antennas = 23, 4, 3, 2
    for ts in dma_probe.TS_CHOICES:
        done = []
        for block in range(grid):
            sched = dma_probe.ring_schedule(block, grid, items, depth)
            for it, (item, stage, parity) in enumerate(sched):
                assert item == block + it * grid
                assert (stage, parity) == (it % depth, (it // depth) % 2)
            reduced = run_block(block, grid, items, depth, ts, per_symbol, antennas, warps, rng)
            assert all(r == [item for item, _, _ in sched] for r in reduced)
            done += reduced[0]
        assert sorted(done) == list(range(items)), ts


def test_ring_schedule_of_a_block_past_the_items_is_empty():
    assert dma_probe.ring_schedule(5, 4, 3, 2) == []
    assert dma_probe.ring_schedule(0, 132, 1, 3) == [(0, 0, 0)]


def test_tool_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dma_probe.main(["--variants", "auto"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_frame_bytes_and_symbols_view():
    assert dma_probe.frame_bytes(101, 16, 1024) == (101 * 16 * 1024 * 8, 101 * 1024 * 8)
    y = torch.arange(2 * 3 * 4 * 128, dtype=torch.float32).reshape(2, 3, 4, 128)
    s = dma_probe.as_symbols(y)
    assert s.shape == (6, 4, 128) and s.data_ptr() == y.data_ptr()
    torch.testing.assert_close(s[4], y[1, 1])
