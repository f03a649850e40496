"""The data kernels' one-launch split form (``csrc/fft_split.cuh``
ring_loop): the exact ``fft_mrc`` and ``mrc_demod`` at F = 16384 and 32768,
the bf16 ``fft_mrc_bf16`` at F = 8192 to 32768, on the CPU.

The kernel is a persistent grid that takes tiles by ticket (a column tile:
the column pass of one column group of one antenna row of one symbol; a row
tile: SPLIT_K1 bins k1 of one symbol over every antenna, or the bf16
kernel's SPEED_RING_K1) and meets its two passes in a ring of
``fft_plan.split_ring`` symbol slots.  It has no
interpret mode, so these tests hold its Python mirror (``fft_plan``'s
``ring_ticket`` and ``split_ring``) to what the kernel needs:

1. every tile is taken once, and every wait (a row tile on its symbol's
   column tiles, a column tile on the row tiles of the slot's last symbol)
   targets smaller tickets, over F, frames K, symbols S and antennas A;
2. a persistent grid of any size, tiles of random durations, each block
   holding its next ticket while it runs the current one, ends (no
   deadlock) and never writes a slot before the row tiles of its last
   symbol have read it;
3. the ring, run tile by tile in ticket order on small frames (float32 and
   int16 rows, R = 2 slots), equals the plain versions within TOL = 2e-5
   max-rel (the kernels' bound against their plain versions, chip_smoke.py
   KERNEL_TOL: both sides float32 FFTs taken in another order); the bf16
   ring's mirror is tests/test_torch_large_fft.py's
   (``emulate_speed_ring``);
4. the ring's sizing and constants agree with the kernel header, and the
   wrappers hand the kernels the ring (at most SPLIT_RING_BYTES at 16
   antennas), not the chunked scratch.
The kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 15).
"""

import contextlib
import heapq
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ofdm_ls_mrc_tpu.golden.io import plane_to_sc16
from ofdm_ls_mrc_tpu_torch.kernels import build
from ofdm_ls_mrc_tpu_torch.ops import fft_plan as fp
from ofdm_ls_mrc_tpu_torch.ops import fused_mrc
from ofdm_ls_mrc_tpu_torch.ops import pipeline as pipe
from ofdm_ls_mrc_tpu_torch.ops.cplx import CArray
from test_torch_large_fft import column_twiddles

SIZES = fp.SPLIT_FFT_SIZES
# (F, bins k1 of a row tile): the exact kernels' rings, then the bf16 ring's
# (ids keep the exact cases' names).
ROW_TILES = ([pytest.param(f, fp.SPLIT_K1, id=str(f)) for f in SIZES]
             + [pytest.param(f, fp.SPEED_RING_K1, id=f"{f}-bf16") for f in fp.SPEED_SPLIT_SIZES])
TIGHT = [(2, 1), (3, 2), (5, 4)]   # (slots, lag): the tightest rings
TOL = 2e-5
CSRC = Path(fp.__file__).resolve().parent.parent / "csrc"
SCHEDULES = [(k, s, a) for k in (1, 2) for s in (1, 3, 100) for a in (1, 2, 16, 64)]


def schedule(f: int, items: int, antennas: int, slots_lag=None, k1: int = fp.SPLIT_K1):
    """(slots, lag, ct, rt, tiles): tiles[t] = (column?, item, index) of
    ticket t, row tiles of k1 bins k1."""
    slots, lag = slots_lag or fp.split_ring(items, antennas, f, k1=k1)
    ct, rt = fp.split_ring_tiles(antennas, f, k1)
    tiles = [fp.ring_ticket(t, items, lag, ct, rt) for t in range(items * (ct + rt))]
    return slots, lag, ct, rt, tiles


def ticket_maps(tiles):
    """{item: [tickets]} of the column tiles and of the row tiles."""
    cols, rows = {}, {}
    for t, (column, item, _) in enumerate(tiles):
        (cols if column else rows).setdefault(item, []).append(t)
    return cols, rows


# -- 1. the schedule -------------------------------------------------------------

@pytest.mark.parametrize("k,s,a", SCHEDULES)
@pytest.mark.parametrize("f,k1", ROW_TILES)
def test_ring_schedule_takes_every_tile_once_and_waits_backwards(f, k1, k, s, a):
    items = k * s
    slots, lag, ct, rt, tiles = schedule(f, items, a, k1=k1)
    assert rt == f // 128 // k1
    assert len(set(tiles)) == len(tiles) == items * (ct + rt)
    assert set(tiles) == ({(True, i, j) for i in range(items) for j in range(ct)}
                          | {(False, i, j) for i in range(items) for j in range(rt)})
    assert 1 <= lag <= items and (items <= slots or lag < slots)
    cols, rows = ticket_maps(tiles)
    for t, (column, item, _) in enumerate(tiles):
        if column:
            if item >= slots:  # the slot's last symbol: all its row tiles before
                assert max(rows[item - slots]) < t
        else:                  # this symbol's column tiles before
            assert max(cols[item]) < t


# -- 2. a persistent grid over the schedule -------------------------------------

def run_grid(f, items, antennas, blocks, seed, slots_lag=None, k1=fp.SPLIT_K1):
    """Event simulation of the kernel's grid: each block takes the next
    ticket when it starts a tile (and holds it while the tile runs), a tile
    is (work, wait, work) with random durations, the waits as ring_loop's.
    Returns (the time the grid ends, the slot faults seen)."""
    slots, lag, ct, rt, tiles = schedule(f, items, antennas, slots_lag, k1)
    rng = np.random.default_rng(seed)
    cols_done = np.zeros(items, int)
    rows_done = np.zeros(items, int)
    owner = {}          # slot -> the item whose columns were written last
    faults = []
    counter = 0
    clock = 0.0
    events = []         # (time, seq, block, stage)
    waiting = {}        # block -> (ticket, stage)
    held = {}           # block -> (current ticket, next ticket)
    seq = 0

    def take():
        nonlocal counter
        counter += 1
        return counter - 1

    def ready(t):
        column, item, _ = tiles[t]
        if column:
            return item < slots or rows_done[item - slots] == rt
        return cols_done[item] == ct

    def push(when, b, stage):
        nonlocal seq
        heapq.heappush(events, (when, seq, b, stage))
        seq += 1

    def start(b, now):
        t, _ = held[b]
        if t >= len(tiles):
            return
        push(now + rng.uniform(1, 4), b, "wait")

    for b in range(blocks):
        held[b] = (take(), take())
        start(b, 0.0)
    while events or waiting:
        if not events:
            raise AssertionError(f"deadlock: {len(waiting)} blocks waiting, no tile runs")
        clock, _, b, stage = heapq.heappop(events)
        t, nxt = held[b]
        column, item, _ = tiles[t]
        if stage == "wait":
            if not ready(t):
                waiting[b] = t
                continue
            stage = "go"
        if stage == "go":
            slot = item % slots
            if column:
                if owner.get(slot, item) != item and rows_done[owner[slot]] != rt:
                    faults.append((t, item, owner[slot]))
                owner[slot] = item
            elif owner.get(slot) != item:
                faults.append((t, item, owner.get(slot)))
            push(clock + rng.uniform(1, 12 if not column else 5), b, "end")
            continue
        # stage == "end": hand the slot on, take the next ticket
        if column:
            cols_done[item] += 1
        else:
            if owner.get(item % slots) != item:
                faults.append((t, item, owner.get(item % slots)))
            rows_done[item] += 1
        held[b] = (nxt, take())
        start(b, clock)
        for w, tw in list(waiting.items()):
            if ready(tw):
                del waiting[w]
                push(clock, w, "go")
    assert np.all(cols_done == ct) and np.all(rows_done == rt)
    return clock, faults


@pytest.mark.parametrize("blocks", [1, 2, 7, 264])
@pytest.mark.parametrize("k,s,a", [(1, 1, 16), (2, 3, 1), (2, 3, 64), (1, 100, 16)])
@pytest.mark.parametrize("f,k1", ROW_TILES)
def test_ring_grid_ends_and_never_overwrites_a_slot_early(f, k1, k, s, a, blocks):
    _, faults = run_grid(f, k * s, a, blocks, seed=f + blocks + a, k1=k1)
    assert faults == []


@pytest.mark.parametrize("slots_lag,k1", [
    *(pytest.param(sl, fp.SPLIT_K1, id=f"slots_lag{i}") for i, sl in enumerate(TIGHT)),
    *(pytest.param(sl, fp.SPEED_RING_K1, id=f"slots_lag{i}-bf16") for i, sl in enumerate(TIGHT))])
def test_ring_grid_at_the_tightest_rings(slots_lag, k1):
    """Few slots and the largest lag a ring of them allows, 64 antennas
    (the slot past the L2 share): still no early overwrite, no deadlock,
    with the exact row tiles and the bf16 ones (8192: two a symbol)."""
    for f in ((32768,) if k1 == fp.SPLIT_K1 else (8192, 32768)):
        _, faults = run_grid(f, 12, 64, 264, seed=sum(slots_lag), slots_lag=slots_lag, k1=k1)
        assert faults == []


# -- 3. the ring on small frames against the plain versions -----------------------

def max_rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def ring_mirror(y: np.ndarray, h: np.ndarray, gain: np.ndarray, scale: float, conj: bool,
                slots: int, lag: int, per_frame_h: bool):
    """The ring kernel tile by tile in ticket order (a valid order: every
    wait points back), complex64: y [K, S, A, F] rows (widened, unscaled),
    h [K or 1, A, F], gain [K or 1, F] (fft_mrc: inv; mrc_demod: 1 /
    hsqrd).  Returns eq [K S, F] in natural order and the slots' owners at
    each row tile's read."""
    k_, s_, a_, f = y.shape
    n1, n2 = fp.split_factors(f)
    c = fp.split_columns(n1)
    items = k_ * s_
    ct, rt = fp.split_ring_tiles(a_, f)
    tw = column_twiddles(f)                                  # [n1, 128]
    ring = np.full((slots, a_, n1, n2), np.nan, np.complex64)
    owner = [-1] * slots
    eq = np.zeros((items, f), np.complex64)
    for t in range(items * (ct + rt)):
        column, item, idx = fp.ring_ticket(t, items, lag, ct, rt)
        slot = item % slots
        frame, sym = divmod(item, s_)
        if column:
            a, c0 = idx // (n2 // c), (idx % (n2 // c)) * c
            x = y[frame, sym, a].reshape(n1, n2)[:, c0:c0 + c]
            ring[slot, a, :, c0:c0 + c] = np.fft.fft(x, axis=0) * tw[:, c0:c0 + c]
            owner[slot] = item
            continue
        assert owner[slot] == item
        hk = h[frame if per_frame_h else 0]
        k1 = fp.SPLIT_K1 * idx + np.arange(fp.SPLIT_K1)
        bins = (k1[:, None] + n1 * np.arange(n2)[None, :]).reshape(-1)
        yk = np.fft.fft(ring[slot][:, k1, :], axis=-1).reshape(a_, -1)   # [A, k1 x k2]
        w = np.conj(hk[:, bins]) if conj else hk[:, bins]
        eq[item, bins] = (yk * w).sum(axis=0) * gain[frame if per_frame_h else 0, bins] * scale
    return eq


def ring_frames(f, dtype, k=2, s=3, a=2, seed=0):
    """Rows [K, S, A, F] as planes (f32, or sc16 int16), their complex64
    widening, and a random unconjugated estimate h [K, A, F] with inv."""
    rng = np.random.default_rng(seed + f)
    z = 0.1 * (rng.standard_normal((k, s, a, f)) + 1j * rng.standard_normal((k, s, a, f)))
    if dtype == "int16":
        re, im = plane_to_sc16(z.real), plane_to_sc16(z.imag)
    else:
        re, im = z.real.astype(np.float32), z.imag.astype(np.float32)
    h = (rng.standard_normal((k, a, f)) + 1j * rng.standard_normal((k, a, f))).astype(np.complex64)
    inv = (1.0 / np.sum(np.abs(h) ** 2, axis=1)).astype(np.float32)
    return re, im, (re.astype(np.float32) + 1j * im.astype(np.float32)).astype(np.complex64), h, inv


@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("f", SIZES)
def test_ring_mirror_matches_fused_pipeline_plain(f, dtype):
    """fft_mrc's ring at R = 2 (every slot rewritten in the launch) over K =
    2 frames of S = 3 symbols against ``fused_pipeline_plain``."""
    re, im, y, h, inv = ring_frames(f, dtype)
    k, s, a, _ = y.shape
    scale = pipe._scale(CArray(torch.from_numpy(re), torch.from_numpy(im)))
    eq = ring_mirror(y, h, inv, scale, True, slots=2, lag=1, per_frame_h=True)
    got = eq.reshape(k, s, f)[..., pipe.reference_order_index(f)]
    want = pipe.fused_pipeline_plain(
        CArray(torch.from_numpy(re), torch.from_numpy(im)),
        CArray(torch.from_numpy(h.real.copy()), torch.from_numpy(h.imag.copy())),
        torch.from_numpy(inv)).to_numpy()
    assert max_rel(got, want) < TOL


@pytest.mark.parametrize("dtype", ["f32", "int16"])
@pytest.mark.parametrize("f", SIZES)
def test_ring_mirror_matches_fused_demod_plain(f, dtype):
    """mrc_demod's ring at R = 2 over S = 5 symbols (hc conjugated already,
    gain 1 / hsqrd, true order) against ``fused_demod_plain``."""
    re, im, y, h, inv = ring_frames(f, dtype, k=1, s=5, a=3, seed=1)
    hc, hsqrd = np.conj(h[0]), (1 / inv[0]).astype(np.float32)
    scale = pipe._scale(CArray(torch.from_numpy(re), torch.from_numpy(im)))
    eq = ring_mirror(y, hc[None], (1 / hsqrd)[None], scale, False, slots=2, lag=1,
                     per_frame_h=False)
    want = fused_mrc.fused_demod_plain(
        CArray(torch.from_numpy(re[0]), torch.from_numpy(im[0])),
        CArray(torch.from_numpy(hc.real.copy()), torch.from_numpy(hc.imag.copy())),
        torch.from_numpy(hsqrd)).to_numpy()
    assert max_rel(eq, want) < TOL


# -- 4. sizing, the header, the wrappers -----------------------------------------

@pytest.mark.parametrize("f", fp.SPEED_SPLIT_SIZES)
def test_speed_ring_sizing(f):
    """The bf16 ring, bf16 slots: in L2 at 16 antennas (80 / 40 / 20 slots
    at 8192 / 16384 / 32768), in device memory past SPEED_RING_L2_ANTENNAS
    (64 antennas, also at 8192 where the share would hold 20 slots): its row
    tiles take every antenna in series, 64 antenna products a tile."""
    assert fp.split_ring_bytes_per_value(fp.SPEED_RING_K1) == 2
    assert fp.split_ring_bytes_per_value(fp.SPLIT_K1) == 4
    for a in (1, 16):
        slots, lag = fp.split_ring(100, a, f, k1=fp.SPEED_RING_K1)
        assert slots * 2 * a * f * 2 <= fp.SPLIT_RING_BYTES and 1 <= lag <= slots // 2
    assert fp.split_ring(100, 16, f, k1=fp.SPEED_RING_K1)[0] == {8192: 80, 16384: 40,
                                                                 32768: 20}[f]
    slots, lag = fp.split_ring(100, 64, f, k1=fp.SPEED_RING_K1)
    assert slots * 2 * 64 * f * 2 > fp.SPLIT_RING_BYTES and lag == slots // 2
    assert slots * 2 * 64 * f * 2 <= fp.SPLIT_SCRATCH_BYTES


@pytest.mark.parametrize("a", [1, 2, 16, 64])
@pytest.mark.parametrize("f", SIZES)
def test_split_ring_sizing(f, a):
    """R slots of [2, A, F] float32: where SPLIT_RING_BYTES holds
    SPLIT_RING_MIN_SLOTS or more, as many as it holds (the ring stays in
    L2: 10 at 16 x 32768, 20 at 16 x 16384); else as many as the chunked
    form's SPLIT_SCRATCH_BYTES holds (64 antennas); never more than there
    are symbols; 1 <= L <= R // 2, so L < R wherever a slot is reused."""
    slot_bytes = 2 * a * f * 4
    in_l2 = fp.SPLIT_RING_BYTES // slot_bytes >= fp.SPLIT_RING_MIN_SLOTS
    for items in (1, 2, 3, 100, 2000):
        slots, lag = fp.split_ring(items, a, f)
        assert 1 <= slots <= items and 1 <= lag <= max(1, slots // 2)
        assert slots >= min(items, fp.SPLIT_RING_MIN_SLOTS)
        assert slots * slot_bytes <= (fp.SPLIT_RING_BYTES if in_l2 else fp.SPLIT_SCRATCH_BYTES)
        if items > slots:
            assert lag < slots
    if a == 16:
        assert in_l2 and fp.split_ring(100, a, f)[0] == (10 if f == 32768 else 20)
    if a == 64:
        assert not in_l2 and fp.split_ring(100, a, f) == ((32, 16) if f == 32768 else (64, 32))


def test_ring_constants_match_the_header():
    """The ring's schedule, tiles and shared memory as the header and the
    exact kernels' sources hold them (row tiles of SPLIT_K1 bins k1, F =
    16384 and 32768); the bf16 kernel's below."""
    text = (CSRC / "fft_split.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kRingBlocks") == fp.SPLIT_RING_BLOCKS
    assert "return N1 / kRowK1;" in text                                   # ring_row_tiles
    assert "template <int N1, int kRowK1 = kK1, typename Kernel, typename... Extra>" in text
    assert "constexpr int kTeamThreads = kK1 * kRowLanes;" in text
    assert "constexpr int kHStageFloats = 2 * kK1 * kN2;" in text
    assert "constexpr int kGainFloats = kK1 * kN2;" in text
    assert ("return row_smem_bytes(kMaxTeams) / sizeof(float) +\n"
            "         static_cast<size_t>(kMaxTeams) * kHStageFloats;") in text
    assert "return wfft::Geo<N1>::kTwiddles + RowGeo::kTwiddles;" in text   # ring_twiddles
    assert ("return (ring_gain_offset() + kGainFloats) * sizeof(float) +\n"
            "         static_cast<size_t>(ring_twiddles<N1>()) * sizeof(float2);") in text
    for f in SIZES:
        n1, n2 = fp.split_factors(f)
        twiddles = len(fp.pass_twiddles_np(n1)) + len(fp.pass_twiddles_np(n2))
        assert fp.split_ring_smem_bytes(f) == fp.split_smem_bytes(fp.SPLIT_TEAMS) + 4 * (
            fp.SPLIT_TEAMS * 2 * fp.SPLIT_K1 * fp.SPLIT_N2 + fp.SPLIT_K1 * fp.SPLIT_N2
            + 2 * twiddles)
        # kRingBlocks blocks an SM fit the H100's 228 KB (1 KB reserved a block).
        assert fp.SPLIT_RING_BLOCKS * (fp.split_ring_smem_bytes(f) + 1024 + 8) <= 233472
        assert fp.split_column_smem_bytes(n1) <= fp.split_ring_smem_bytes(f)
    # ring_ticket: the same three regimes as fft_plan.ring_ticket.
    assert "const long long head = static_cast<long long>(lag) * ct;" in text
    assert "const long long both = static_cast<long long>(items - lag) * (ct + rt);" in text
    assert "return r < ct ? Ticket{true, step, r} : Ticket{false, step - lag, r - ct};" in text
    assert "return {false, items - lag + static_cast<int>(t / rt), static_cast<int>(t % rt)};" \
        in text
    # The C entry refuses a schedule the kernel cannot run.
    assert "p.lag > p.items || (p.items > p.slots && p.lag >= p.slots)" in text
    for name in ("fft_mrc.cu", "mrc_demod.cu"):
        src = (CSRC / name).read_text()
        assert "_rows_kernel" not in src and "run_split" not in src
        assert "split::launch_ring<N1>" in src


def test_bf16_ring_constants_match_the_header():
    """The same checks over the bf16 row tiles (RT = N1 / SPEED_RING_K1) and
    F = 8192: the header's generic schedule, the bf16 kernel's source and
    ``speed_ring_smem_bytes``."""
    text = (CSRC / "fft_split.cuh").read_text()
    assert "return N1 / kRowK1;" in text                                   # ring_row_tiles
    assert "template <int N1, int kRowK1 = kK1, typename Kernel, typename... Extra>" in text
    src = (CSRC / "fft_mrc_bf16.cu").read_text()
    assert "constexpr int kRingK1 = kChunkRows / 2;" in src and fp.SPEED_RING_K1 == 16
    assert "split::ring_loop<N1, E, kRingK1, __nv_bfloat16, true>(" in src   # bf16 slots
    assert "CU_TENSOR_MAP_SWIZZLE_128B" in src
    assert "const cuuint32_t box[2] = {64, 2 * kRingK1};" in src
    assert "return sizeof(S) == 4 ? k1 * kN2 : (k1 >> 3) * 16 * kN2 + (k1 & 7) * kN2;" in text
    assert "split::launch_ring<N1, kRingK1>(fft_mrc_bf16_ring_kernel<N1, float>" in src
    assert "static constexpr int kBytes = kBar + kBars * 8 + kAlign;" in src
    assert "static constexpr int kBars = 5;" in src
    assert "speed_rows_kernel" not in src and "launch_rows" not in src
    for f in fp.SPEED_SPLIT_SIZES:
        n1, n2 = fp.split_factors(f)
        twiddles = len(fp.pass_twiddles_np(n1)) + len(fp.pass_twiddles_np(n2))
        region = max(fp.split_column_smem_bytes(n1), 2 * 64 * 128 * 2)
        assert fp.speed_ring_smem_bytes(f) == (-(-region // 1024) * 1024 + 65536
                                               + 8 * twiddles + 40 + 1024)
        assert fp.SPLIT_RING_BLOCKS * (fp.speed_ring_smem_bytes(f) + 1024 + 8) <= 233472
        assert fp.speed_smem_bytes(f, False) == fp.speed_ring_smem_bytes(f)
        assert fp.split_ring_tiles(16, f, fp.SPEED_RING_K1)[1] == n1 // 16


class _Lib:
    """A kernel library that records its calls and launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    """Route CPU tensors to the kernel path with a recording library, and
    record every ring the wrappers allocate."""
    lib, rings = _Lib(), []
    real = pipe._split_ring

    def split_ring(*args):
        out = real(*args)
        rings.append(out)
        return out

    monkeypatch.setattr(pipe, "_device_route", lambda x, name: True)
    monkeypatch.setattr(fused_mrc, "_device_route", lambda x, name: True)
    monkeypatch.setattr(pipe, "_split_ring", split_ring)
    monkeypatch.setattr(fused_mrc, "_split_ring", split_ring)
    monkeypatch.setattr(build, "load_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: type("S", (), {
        "cuda_stream": 0})())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    return lib, rings


@pytest.mark.parametrize("f", SIZES)
def test_wrappers_hand_the_data_kernels_the_ring(fake_card, f):
    """fused_pipeline (exact) and fused_demod at 16 x F x 100: the scratch
    is the ring [2, R, 16, F] within SPLIT_RING_BYTES (not the chunked [2,
    chunk, 16, F], 419 MB at 32768) with zeroed counters [1 + 2 items], and
    the C entries get its pointer, R, L and the counters."""
    lib, rings = fake_card
    s, a = 100, 16
    row = torch.zeros((1, 1, f))
    y = CArray(row.expand(s, a, f), row.expand(s, a, f))     # any strides, rows contiguous
    h = CArray(torch.zeros((a, f)), torch.zeros((a, f)))
    inv = torch.ones(f)
    pipe.fused_pipeline(y, h, inv)
    fused_mrc.fused_demod(y, h, inv)
    assert [name for name, _ in lib.calls] == ["ofdm_fft_mrc", "ofdm_mrc_demod"]
    for (name, args), (ring, counters, slots, lag) in zip(lib.calls, rings):
        assert tuple(ring.shape) == (2, slots, a, f)
        assert ring.numel() * 4 <= fp.SPLIT_RING_BYTES
        assert (slots, lag) == fp.split_ring(s, a, f)
        assert counters.dtype == torch.int32 and tuple(counters.shape) == (1 + 2 * s,)
        assert not counters.any()
        assert args[-5:] == (ring.data_ptr(), slots, lag, counters.data_ptr(), 0)
    # The pilot keeps the chunked scratch.
    scratch, chunk = pipe._split_scratch(1, a, f, pipe.SPLIT_FFT_SIZES, torch.device("cpu"))
    assert tuple(scratch.shape) == (2, chunk, a, f)


@pytest.mark.parametrize("a", [16, 64])
@pytest.mark.parametrize("f", fp.SPEED_SPLIT_SIZES)
def test_wrappers_hand_the_bf16_kernel_the_ring(fake_card, f, a):
    """fused_pipeline(exact=False) at F = 8192 to 32768: one call of
    ofdm_fft_mrc_bf16 with the ring of split_ring's bf16 row tiles [2, R,
    A, F], zeroed counters [1 + 2 items], W's image in place of W and no
    chunked scratch; below 8192 W and no ring."""
    lib, rings = fake_card
    s = 4
    row = torch.zeros((1, 1, f))
    y = CArray(row.expand(s, a, f), row.expand(s, a, f))
    h = CArray(torch.zeros((a, f)), torch.zeros((a, f)))
    pipe.fused_pipeline(y, h, torch.ones(f), exact=False)
    assert [name for name, _ in lib.calls] == ["ofdm_fft_mrc_bf16"]
    (_, args), (ring, counters, slots, lag) = lib.calls[0], rings[-1]
    assert (slots, lag) == fp.split_ring(s, a, f, k1=fp.SPEED_RING_K1)
    assert tuple(ring.shape) == (2, slots, a, f) and ring.dtype == torch.bfloat16
    assert not counters.any()
    assert tuple(counters.shape) == (1 + 2 * s,)
    assert args[14] is None and args[15] == fp.speed_w_image(torch.device("cpu")).data_ptr()
    assert args[-5:] == (ring.data_ptr(), slots, lag, counters.data_ptr(), 0)
    lib.calls.clear()
    small = CArray(torch.zeros((s, a, 4096)), torch.zeros((s, a, 4096)))
    pipe.fused_pipeline(small, CArray(torch.zeros((a, 4096)), torch.zeros((a, 4096))),
                        torch.ones(4096), exact=False)
    args = lib.calls[0][1]
    assert args[14] == fp.speed_w(torch.device("cpu")).data_ptr() and args[15] is None
    assert args[-5:] == (None, 0, 0, None, 0)


def test_ring_refuses_a_misaligned_estimate(fake_card):
    """The row tiles copy h and the gains (inv, hsqrd) in 16-byte pieces:
    a plane or gain vector that starts 4 bytes off raises, before any launch."""
    lib, _ = fake_card
    f, a = 16384, 2
    y = CArray(torch.zeros((1, a, f)), torch.zeros((1, a, f)))
    flat = torch.zeros(a * f + 1)
    good = CArray(torch.zeros((a, f)), torch.zeros((a, f)))
    bad_h = CArray(flat[1:].view(a, f), flat[1:].view(a, f))
    bad_gain = torch.ones(f + 1)[1:]
    for h, gain in ((bad_h, torch.ones(f)), (good, bad_gain)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            pipe.fused_pipeline(y, h, gain)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fused_mrc.fused_demod(y, h, gain)
    assert lib.calls == []
