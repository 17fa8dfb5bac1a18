"""The cut path of the port's device MinHash sketches (`mash.cut_sketches`,
kernels `sketch_cut` and `sketch_select` of `csrc/sketch.cu`): its host
rules (chunk plan, cut, rows, staging, fallback rule) and its sketches
against the torch path (`mash._sketch_torch`, which
`tests/test_torch_sketch.py` holds to the JAX package). Imports no JAX.

On the CPU the cut runs the kernels' plain versions; the ``gpu`` cases run
the kernels on the card against those plain versions, the torch path and
the benchmark's plain-torch reference (`portbench/reference/sketches.py`):

    python -m pytest --noconftest tests/test_torch_sketch_cut.py -m gpu
"""
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.reference import sketches as ref  # noqa: E402
from portbench.reference.minimizers import seed_tables  # noqa: E402
from seqwin_tpu_torch import mash  # noqa: E402
from seqwin_tpu_torch.engine import timeline  # noqa: E402
from seqwin_tpu_torch.ops.hashing import M64  # noqa: E402

N = 255  # an invalid base, as the parsers write N
CPU = torch.device('cpu')


def _codes(rng, n):
    return rng.integers(0, 4, size=n).astype(np.uint8)


def _random(rng):
    """Assemblies of one to three records, some with N runs."""
    out = []
    for _ in range(5):
        recs = [_codes(rng, int(rng.integers(5_000, 25_000))) for _ in range(int(rng.integers(1, 4)))]
        for r in recs[:1]:
            at = int(rng.integers(0, len(r) - 50))
            r[at:at + 40] = N
        out.append(recs)
    return out


def _short(rng):
    """An assembly shorter than k beside whole ones, and one with no records."""
    return [[_codes(rng, 12)], _random(rng)[0], [], [np.zeros(0, np.uint8), _codes(rng, 9)]]


def _all_n(rng):
    return [[np.full(3_000, N, np.uint8)], _random(rng)[0], [np.full(40, N, np.uint8)] * 3]


def _few_distinct(rng):
    """Streams with fewer distinct k-mers than the sketch size, under a cut
    of all-ones (shorter than the cut's count)."""
    return [[_codes(rng, 150)], [_codes(rng, 90), _codes(rng, 60)]]


def _repeat(rng):
    """A low-complexity record: a 37-base unit 300 times, 37 distinct k-mers
    over 11,100 positions: too few distinct under a cut below all-ones."""
    return [_random(rng)[0], [np.tile(_codes(rng, 37), 300)]]


# A 4-base unit all of whose 21-mers hash below 0.102 x 2^64 (found by search
# over units of 1 to 4 bases): tiled, every position of it passes a cut above
# that, so its counter passes the slots.
OVERFLOW_UNIT = np.array([0, 3, 2, 1], np.uint8)


def _overflow(rng):
    """200 bases of the unit and 180 random: at sketch size 10 the cut is
    40/380 of all-ones, the unit's 181 k-mers all pass it beside about 17
    random ones, and the counter passes the 160 slots."""
    return [[np.concatenate([np.tile(OVERFLOW_UNIT, 50), _codes(rng, 180)])], _random(rng)[0]]


def _oversized(rng):
    """Assemblies longer than the chunk budget among shorter ones."""
    return [[_codes(rng, 3_000)], [_codes(rng, 30_000), _codes(rng, 4_000)], [_codes(rng, 2_000)],
            [_codes(rng, 2_500)], [_codes(rng, 25_000)]]


CASES = {
    # name: (make, k, sketch size, chunk budget, fallbacks expected)
    'random': (_random, 21, 1000, 1 << 26, False),
    'random_small_chunks': (_random, 21, 200, 30_000, False),
    'shorter_than_k': (_short, 21, 50, 1 << 26, False),
    'all_n': (_all_n, 21, 1000, 1 << 26, False),
    'fewer_distinct_than_size': (_few_distinct, 15, 1000, 1 << 26, False),
    'low_complexity_repeat': (_repeat, 21, 50, 1 << 26, True),
    'candidate_overflow': (_overflow, 21, 10, 1 << 26, True),
    'larger_than_the_chunk_budget': (_oversized, 21, 1000, 10_000, False),
}
KS = (15, 21, 32, 33, 63)
SIZES = (50, 1000, 5000)


def _case(name):
    make, k, size, budget, fallback = CASES[name]
    return make(np.random.default_rng(sum(map(ord, name)))), k, size, budget, fallback


def _assert_equal(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == np.uint64, i
        np.testing.assert_array_equal(g, w, err_msg=f'sketch {i}')


def _counters(assemblies, k, size, budget):
    """(counter, distinct) of each assembly by the plain kernels."""
    lengths = [mash.stream_bases(r) for r in assemblies]
    rows = mash.cut_rows(lengths, mash.chunk_plan(lengths, budget), size)
    cap = mash.cand_cap(size)
    counts = torch.zeros(len(lengths), dtype=torch.int32)
    cand = torch.empty(len(lengths) * cap, dtype=torch.int64)
    for a0, a1 in mash.chunk_plan(lengths, budget):
        buf = np.empty(int(rows[a1 - 1, 0] + rows[a1 - 1, 1]), np.uint8)
        mash.stage_chunk(buf, assemblies[a0:a1], rows[a0:a1, 0])
        mash.sketch_cut_plain(torch.from_numpy(buf), torch.from_numpy(rows[a0:a1]), k,
                              cand[a0 * cap:a1 * cap], counts[a0:a1], cap)
    out = mash.sketch_select_plain(cand, counts, cap, size)
    return out[:, size + 1].numpy(), out[:, size].numpy(), rows, cap


# --------------------------------------------------------------------- rules

@pytest.mark.parametrize('lengths, budget, want', [
    ([10, 20, 30], 100, [(0, 3)]),
    ([49, 50], 100, [(0, 2)]),           # 49 + 1 + 50: the budget exactly
    ([50, 50], 100, [(0, 1), (1, 2)]),
    ([150, 10, 10], 100, [(0, 1), (1, 3)]),
    ([10, 150, 10], 100, [(0, 1), (1, 2), (2, 3)]),
    ([0, 0, 5, 0], 100, [(0, 4)]),
    ([], 100, []),
])
def test_chunk_plan_packs_whole_assemblies(lengths, budget, want):
    plan = mash.chunk_plan(lengths, budget)
    assert plan == want
    for a0, a1 in plan:
        assert a1 - a0 == 1 or sum(lengths[a0:a1]) + (a1 - a0 - 1) <= budget


@pytest.mark.parametrize('length, size', [
    (0, 1000), (1, 1000), (4_000, 1000), (4_001, 1000), (4_700_000, 1000),
    (10**9, 50), (10**9, 5000), (14_337, 5000), (14_336, 5000), (2**40, 28_672),
])
def test_cut_threshold(length, size):
    m = min(mash.CUT_FACTOR * size, mash.cand_cap(size) // 2)
    tau = mash.cut_threshold(length, size)
    if m >= length:
        assert tau == M64
    else:
        assert tau == (2**64 - 1) * m // length < M64
        assert tau * length <= (2**64 - 1) * m < (tau + 1) * length


def test_the_cut_keeps_about_its_count():
    """Uniform values below the cut of a 4.7 Mbp stream: about 4 x 1000."""
    vals = np.random.default_rng(7).integers(0, 2**64 - 1, size=4_700_000, dtype=np.uint64)
    kept = int(np.count_nonzero(vals < np.uint64(mash.cut_threshold(len(vals), 1000))))
    assert 3_700 < kept < 4_300 < mash.cand_cap(1000)


@pytest.mark.parametrize('distinct, counter, tau, size, cap, want', [
    (1000, 4000, 5, 1000, 16000, False),           # enough distinct below the cut
    (999, 3000, 5, 1000, 16000, True),             # too few under a cut below all-ones
    (999, 3000, M64, 1000, 16000, False),  # every valid hash let through
    (1500, 16001, 5, 1000, 16000, True),           # the counter passed the slots
    (1500, 16000, 5, 1000, 16000, False),
    (0, 0, 5, 50, 800, True),                      # nothing valid under a cut
    (0, 0, M64, 50, 800, False),
])
def test_needs_fallback(distinct, counter, tau, size, cap, want):
    got = mash.needs_fallback(np.array([distinct]), np.array([counter]),
                              np.array([tau], dtype=np.uint64), size, cap)
    assert got.tolist() == [want]


@pytest.mark.parametrize('seed', range(4))
def test_rows_tile_every_position_once(seed):
    """The block -> assembly search of `sketch_cut` over `cut_rows`, as the
    kernel does it, covers every position of every assembly once."""
    rng = np.random.default_rng(seed)
    lengths = [int(x) for x in rng.integers(0, 4 * mash.CUT_TILE, size=30)]
    lengths[3] = 0
    lengths[7] = 9 * mash.CUT_TILE
    plan = mash.chunk_plan(lengths, 5 * mash.CUT_TILE)
    rows = mash.cut_rows(lengths, plan, 1000)
    for a0, a1 in plan:
        r = rows[a0:a1]
        assert r[0, 0] == 0 and np.all(r[1:, 0] == r[:-1, 0] + r[:-1, 1] + 1)
        blocks = int(r[-1, 2]) + -(-lengths[a1 - 1] // mash.CUT_TILE)
        seen = [np.zeros(n, np.int64) for n in lengths[a0:a1]]
        for b in range(blocks):
            lo, hi = 0, a1 - a0 - 1
            while lo < hi:
                mid = (lo + hi + 1) >> 1
                lo, hi = (mid, hi) if r[mid, 2] <= b else (lo, mid - 1)
            t0 = (b - int(r[lo, 2])) * mash.CUT_TILE
            assert 0 <= t0 < r[lo, 1]
            seen[lo][t0:t0 + mash.CUT_TILE] += 1
        assert all(np.all(s == 1) for s in seen)
    assert rows[:, 3].view(np.uint64).tolist() == [mash.cut_threshold(n, 1000) for n in lengths]


@pytest.mark.parametrize('threads', [0, 3])
def test_stage_chunk_lays_out_the_streams(threads, monkeypatch):
    """Each assembly's stream at its offset, as `_sketch_torch` joins it,
    one 255 between assemblies, every byte written over stale contents; in
    pieces over a pool's threads or in series."""
    assemblies, *_ = _case('shorter_than_k')
    assemblies = assemblies + _repeat(np.random.default_rng(1))
    lengths = [mash.stream_bases(r) for r in assemblies]
    rows = mash.cut_rows(lengths, [(0, len(lengths))], 50)
    n = int(rows[-1, 0] + rows[-1, 1])
    buf = np.full(n + 7, 9, np.uint8)  # stale bytes beyond the chunk stay
    monkeypatch.setattr(mash, 'STAGE_PIECE', 1_000)
    if threads:
        with ThreadPoolExecutor(threads) as pool:
            mash.stage_chunk(buf[:n], assemblies, rows[:, 0], pool)
    else:
        mash.stage_chunk(buf[:n], assemblies, rows[:, 0])
    assert np.all(buf[n:] == 9) and not np.any(buf[:n] == 9)
    for recs, (off, length, _, _) in zip(assemblies, rows):
        joined = np.concatenate([np.concatenate([r, [N]]) for r in recs])[:-1] if recs else []
        np.testing.assert_array_equal(buf[off:off + length], joined)
        if off + length < n:
            assert buf[off + length] == N


def test_select_plain_rows():
    """A row of `sketch_select`: the least distinct ascending, all-ones
    past them, the distinct count, the counter (above the slots here)."""
    cap, size = 6, 4
    vals = np.array([9, 3, 2**64 - 2, 3, 7, 1,
                     5, 5, 0, 0, 0, 0,
                     4, 4, 4, 0, 2, 8], np.uint64)
    cand = torch.from_numpy(vals.view(np.int64).copy())
    counts = torch.tensor([6, 2, 9], dtype=torch.int32)
    got = mash.sketch_select_plain(cand, counts, cap, size).numpy()
    assert got[0, :4].view(np.uint64).tolist() == [1, 3, 7, 9] and got[0, 4:].tolist() == [5, 6]
    assert got[1, :4].tolist() == [5, -1, -1, -1] and got[1, 4:].tolist() == [1, 2]
    assert got[2, :4].tolist() == [0, 2, 4, 8] and got[2, 4:].tolist() == [4, 9]


@pytest.mark.parametrize('bad', ['codes', 'rows', 'cand', 'counts', 'short_cand', 'rows_shape'])
def test_the_wrappers_refuse_what_the_kernels_do_not_take(bad):
    t = {'codes': torch.zeros(10, dtype=torch.uint8), 'rows': torch.zeros((1, 4), dtype=torch.int64),
         'cand': torch.zeros(8, dtype=torch.int64), 'counts': torch.zeros(1, dtype=torch.int32)}
    if bad == 'short_cand':
        t['cand'] = t['cand'][:7]
    elif bad == 'rows_shape':
        t['rows'] = torch.zeros((2, 2), dtype=torch.int64)
    else:
        t[bad] = t[bad].double()
    with pytest.raises(ValueError):
        mash.sketch_cut(t['codes'], t['rows'], 21, t['cand'], t['counts'], 8, 1)
    if bad in ('cand', 'counts', 'short_cand'):
        with pytest.raises(ValueError):
            mash.sketch_select(t['cand'], t['counts'], 8, 4)


# ------------------------------------------------------- sketches on the CPU

@pytest.mark.parametrize('case', sorted(CASES))
def test_cut_gives_the_torch_paths_sketches(case, monkeypatch):
    assemblies, k, size, budget, fallback = _case(case)
    monkeypatch.setattr(mash, 'CHUNK_BASES', budget)
    got, candidates, fallbacks = mash.cut_sketches(assemblies, k, size, CPU)
    _assert_equal(got, mash.device_sketches(assemblies, k, size, device='cpu'))
    counters, distinct, rows, cap = _counters(assemblies, k, size, budget)
    assert candidates == int(counters.sum())
    redo = mash.needs_fallback(distinct, counters, rows[:, 3].view(np.uint64), size, cap)
    assert fallbacks == int(redo.sum()) and (fallbacks > 0) == fallback
    if case == 'candidate_overflow':
        assert counters[0] > cap
    if case == 'low_complexity_repeat':
        assert redo.tolist() == [False, True]
    if case == 'larger_than_the_chunk_budget':
        assert (mash.chunk_plan([mash.stream_bases(r) for r in assemblies], budget)
                == [(0, 1), (1, 2), (2, 4), (4, 5)])


@pytest.mark.parametrize('size', SIZES)
@pytest.mark.parametrize('k', KS)
def test_cut_gives_the_torch_paths_sketches_over_k_and_size(k, size, monkeypatch):
    rng = np.random.default_rng(k * 10_000 + size)
    assemblies = [[_codes(rng, int(rng.integers(20_000, 40_000)))] for _ in range(3)]
    assemblies[1].append(np.full(30, N, np.uint8))
    assemblies[1].append(_codes(rng, 2_000))
    monkeypatch.setattr(mash, 'CHUNK_BASES', 50_000)
    got, candidates, fallbacks = mash.cut_sketches(assemblies, k, size, CPU)
    _assert_equal(got, mash.device_sketches(assemblies, k, size, device='cpu'))
    assert fallbacks == 0 and 0 < candidates


def test_the_cpu_and_spaced_seeds_take_the_torch_path():
    assemblies, k, size, *_ = _case('random')
    stats = {}
    mash.device_sketches(assemblies, k, size, device='cpu', stats=stats)
    mash.device_sketches(assemblies, 0, size, seed_pattern='1101011', device='cpu', stats=stats)
    assert stats == {}


# ---------------------------------------------------------------- the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('case', sorted(CASES))
def test_kernels_match_their_plain_versions_on_the_card(case):
    """`sketch_cut` against `sketch_cut_plain` chunk by chunk (counters and
    the set of kept values), `sketch_select` against `sketch_select_plain`
    on the kernel's candidates."""
    dev = _cuda()
    assemblies, k, size, budget, _ = _case(case)
    lengths = [mash.stream_bases(r) for r in assemblies]
    plan = mash.chunk_plan(lengths, budget)
    rows = mash.cut_rows(lengths, plan, size)
    cap = mash.cand_cap(size)
    counts = torch.zeros(len(lengths), dtype=torch.int32, device=dev)
    cand = torch.full((len(lengths) * cap,), -1, dtype=torch.int64, device=dev)
    counts_p = torch.zeros(len(lengths), dtype=torch.int32)
    cand_p = torch.full((len(lengths) * cap,), -1, dtype=torch.int64)
    for a0, a1 in plan:
        buf = np.empty(int(rows[a1 - 1, 0] + rows[a1 - 1, 1]), np.uint8)
        mash.stage_chunk(buf, assemblies[a0:a1], rows[a0:a1, 0])
        r = torch.from_numpy(rows[a0:a1])
        blocks = int(rows[a1 - 1, 2]) + -(-lengths[a1 - 1] // mash.CUT_TILE)
        mash.sketch_cut(torch.from_numpy(buf).to(dev), r.to(dev), k, cand[a0 * cap:a1 * cap],
                        counts[a0:a1], cap, blocks)
        mash.sketch_cut_plain(torch.from_numpy(buf), r, k, cand_p[a0 * cap:a1 * cap],
                              counts_p[a0:a1], cap)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(counts.cpu().numpy(), counts_p.numpy())
    got, want = cand.cpu().view(-1, cap), cand_p.view(-1, cap)
    for a, c in enumerate(counts_p.tolist()):
        if c <= cap:
            np.testing.assert_array_equal(np.sort(got[a, :c].numpy()), np.sort(want[a, :c].numpy()))
    out = mash.sketch_select(cand, counts, cap, size)
    np.testing.assert_array_equal(out.cpu().numpy(),
                                  mash.sketch_select_plain(cand.cpu(), counts.cpu(), cap, size).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize('case', sorted(CASES))
def test_sketches_on_the_card(case, monkeypatch):
    """`device_sketches` on the card (the cut path) against the torch path
    on the CPU and the plain-torch reference; the forced cases redo an
    assembly, the others none."""
    dev = _cuda()
    assemblies, k, size, budget, fallback = _case(case)
    launches = mash.sketch_cut.launches, mash.sketch_select.launches
    monkeypatch.setattr(mash, 'CHUNK_BASES', budget)
    stats = {}
    got = mash.device_sketches(assemblies, k, size, device=dev, stats=stats)
    assert mash.sketch_select.launches == launches[1] + 1 and mash.sketch_cut.launches > launches[0]
    _assert_equal(got, mash.device_sketches(assemblies, k, size, device='cpu'))
    tables = seed_tables(k, dev)
    _assert_equal(got, [ref.sketch(r, k, size, tables, dev) for r in assemblies])
    assert (stats['fallbacks'] > 0) == fallback


@pytest.mark.gpu
@pytest.mark.parametrize('size', SIZES)
@pytest.mark.parametrize('k', KS)
def test_sketches_on_the_card_over_k_and_size(k, size):
    dev = _cuda()
    rng = np.random.default_rng(k * 10_000 + size)
    assemblies = [[_codes(rng, int(rng.integers(20_000, 400_000)))] for _ in range(6)]
    assemblies[1].append(np.full(30, N, np.uint8))
    assemblies[1].append(_codes(rng, 2_000))
    stats = {}
    got = mash.device_sketches(assemblies, k, size, device=dev, stats=stats)
    assert stats['fallbacks'] == 0
    _assert_equal(got, mash.device_sketches(assemblies, k, size, device='cpu'))
    tables = seed_tables(k, dev)
    _assert_equal(got, [ref.sketch(r, k, size, tables, dev) for r in assemblies])


@pytest.mark.gpu
@pytest.mark.parametrize('case', ['random', 'low_complexity_repeat'])
def test_the_threshold_span_counts_the_cut(case):
    """`threshold.sketches` carries the cut's candidates and fallbacks."""
    from seqwin_tpu_torch.pipeline.kmers import _device_jaccard

    dev = _cuda()
    assemblies, k, size, _, fallback = _case(case)
    config = SimpleNamespace(device_backend='torch', device=dev, kmerlen=k, sketchsize=size,
                             seed_pattern=None, n_cpu=1)
    with timeline.recording():
        timeline.drain_spans()
        _device_jaccard(None, config, records=assemblies)
        spans = timeline.drain_spans()
    (span,) = [s for s in spans if s.name == 'threshold.sketches']
    assert span.attrs['candidates'] > 0
    assert (span.attrs['fallbacks'] > 0) == fallback
