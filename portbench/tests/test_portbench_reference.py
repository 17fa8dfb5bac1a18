"""The reference's minimizers against a plain per-position loop, on records
with repeats (ties), N runs and short records; the control found wrong."""
import numpy as np
import pytest
import torch

from portbench import compare
from portbench.reference.minimizers import M64, MULTISEED, SEEDS, record_minimizers, seed_tables, srol


def _loop(codes, k, w):
    """Per position: the canonical hash from scratch; per window of w valid
    k-mers the rightmost least; emitted when its position advances."""
    valid, hashes = [], []
    for p in range(len(codes) - k + 1):
        kmer = codes[p:p + k]
        if any(c > 3 for c in kmer):
            continue
        fwd = rev = 0
        for j, c in enumerate(kmer):
            fwd ^= srol(SEEDS[c], k - 1 - j)
            rev ^= srol(SEEDS[3 - c], j)
        valid.append(p)
        hashes.append((fwd + rev) & M64)
    out, last = [], -1
    for i in range(w - 1, len(valid)):
        m = min(range(i - w + 1, i + 1), key=lambda j: (hashes[j], -j))
        if valid[m] > last and hashes[m] != M64:
            last = valid[m]
            t = (hashes[m] * ((1 ^ (k * MULTISEED)) & M64)) & M64
            out.append((t ^ (t >> 27), valid[m]))
    return out


def _case(kind, rng):
    if kind == 'repeats':
        return np.tile(np.array([0, 1, 2, 3, 3, 2, 1, 0], np.uint8), 40)
    if kind == 'homopolymer':
        return np.zeros(150, np.uint8)
    codes = rng.integers(0, 4, size=400).astype(np.uint8)
    if kind == 'n_runs':
        codes[50:60] = 255
        codes[200:203] = 255
    return codes


@pytest.mark.parametrize('kind', ['random', 'repeats', 'homopolymer', 'n_runs'])
@pytest.mark.parametrize('k, w', [(5, 4), (21, 10), (7, 50)])
def test_minimizers_match_a_plain_loop(kind, k, w):
    codes = _case(kind, np.random.default_rng(k * w))
    ids, pos = record_minimizers(torch.from_numpy(codes), k, w, seed_tables(k, 'cpu'))
    got = list(zip((ids.numpy().view(np.uint64)).tolist(), pos.tolist()))
    assert got == _loop(codes.tolist(), k, w)


def test_short_records_emit_nothing():
    tables = seed_tables(21, 'cpu')
    for n in (0, 10, 21, 21 + 200 - 2):
        ids, _ = record_minimizers(torch.zeros(n, dtype=torch.uint8), 21, 200, tables)
        assert ids.numel() == 0


def test_the_control_is_found_wrong():
    from portbench.control import readings
    from portbench.tests.conftest import tiny_bench_dict

    numbers = readings('tiny.cli', 13, 'cpu', bench=tiny_bench_dict(), n_cpu=2)
    assert not compare.passes(numbers)
    assert numbers['rows_differing'] > 0 and numbers['threshold_gap'] > 0


@pytest.mark.gpu
def test_minimizers_on_the_card_match_the_cpu(cuda):
    codes = _case('n_runs', np.random.default_rng(3))
    for k, w in ((21, 200), (5, 4)):
        a = record_minimizers(torch.from_numpy(codes), k, w, seed_tables(k, 'cpu'))
        b = record_minimizers(torch.from_numpy(codes).to(cuda), k, w, seed_tables(k, cuda))
        assert all(torch.equal(x, y.cpu()) for x, y in zip(a, b))
