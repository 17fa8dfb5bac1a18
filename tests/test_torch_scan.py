"""seqwin_tpu_torch's chunk scan against the JAX package's
`hybrid.scan_chunk_device` (XLA phase 1), and its copied host patches
against the original."""
import numpy as np
import pytest
import torch

from seqwin_tpu.engine import hybrid as jax_hybrid
from seqwin_tpu_torch.engine import hybrid
from seqwin_tpu_torch.ops import u64


def _records(rng, n_asm=4):
    """Per assembly: a few records with N runs, short and empty records."""
    per_asm = []
    for a in range(n_asm):
        recs = []
        for n_rec, frac, run in [(1500, 0.0, 80), (0, 0.0, 0), (30, 0.0, 0),
                                 (2000, 0.03, 0), (700, 0.3, 0)][: 3 + a % 3]:
            c = rng.integers(0, 4, size=n_rec).astype(np.uint8)
            c[rng.random(n_rec) < frac] = 255
            if run:
                s = int(rng.integers(0, n_rec - run))
                c[s:s + run] = 255
            recs.append(c)
        per_asm.append(recs)
    offsets = np.cumsum([0] + [len(r) for r in per_asm]).astype(np.uintp)
    return [c for recs in per_asm for c in recs], offsets


@pytest.mark.parametrize('k,w,rec_base', [(7, 10, 0), (21, 50, 3), (4, 3, 0), (1, 4, 2), (21, 200, 0)])
def test_scan_chunk_matches_jax(monkeypatch, k, w, rec_base):
    monkeypatch.setenv('SEQWIN_TPU_PHASE1', 'xla')
    monkeypatch.setenv('SEQWIN_TPU_EXTRACT', 'topk')
    records, offsets = _records(np.random.default_rng(k * 5 + w))
    # a chunk starting at global record ``rec_base``: ``rec_base`` leading
    # one-record assemblies come before it, so the assembly table is shifted
    offsets = np.concatenate([np.arange(rec_base, dtype=np.uintp), offsets + rec_base])
    j_oh, j_pos, j_rec, j_count, j_asm = jax_hybrid.scan_chunk_device(
        records, k, w, rec_base, min_chunk=1 << 12, record_offsets=offsets)
    oh, pos, rec, count, asm = hybrid.scan_chunk_device(
        records, k, w, rec_base, record_offsets=offsets, device='cpu')
    assert count == j_count > 50
    np.testing.assert_array_equal(u64.to_numpy(oh), np.asarray(j_oh)[:count])
    np.testing.assert_array_equal(pos.numpy(), np.asarray(j_pos)[:count])
    np.testing.assert_array_equal(rec.numpy(), np.asarray(j_rec)[:count])
    np.testing.assert_array_equal(asm.numpy(), np.asarray(j_asm)[:count])


def test_scan_chunk_empty():
    assert hybrid.scan_chunk_device([np.zeros(0, np.uint8)], 7, 10, device='cpu')[3] == 0


@pytest.mark.parametrize('k,w', [(7, 10), (21, 200), (1, 4), (5, 64)])
def test_host_patches_copy_equals_original(k, w):
    records, _ = _records(np.random.default_rng(k + w), n_asm=3)
    codes, starts = hybrid._host_layout(records, sum(len(c) for c in records) + 37, offset=5)
    codes[starts[starts < len(codes)]] |= 64
    got = hybrid.host_patches(starts, k, w, len(codes), codes=codes)
    want = jax_hybrid.host_patches(starts, k, w, len(codes), codes=codes)
    assert len(want[0]) > 50
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    j_codes, j_starts = jax_hybrid._host_layout(records, len(codes), offset=5)
    np.testing.assert_array_equal(starts, j_starts)
    np.testing.assert_array_equal(hybrid._asm_table([0, 2, 5, 9], 1, 7, 9),
                                  jax_hybrid._asm_table([0, 2, 5, 9], 1, 7, 9))


def test_canon_at_emitted_matches_host_hash():
    from seqwin_tpu.ops.host_hash import canon_at

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=3000).astype(np.uint8)
    codes[0] |= 64
    pos = np.sort(rng.choice(3000 - 40, size=200, replace=False))
    for k in (1, 21, 33, 40):
        got = hybrid._canon_at_emitted(torch.from_numpy(codes), torch.from_numpy(pos), k)
        np.testing.assert_array_equal(u64.to_numpy(got), canon_at(codes, pos, k))


@pytest.mark.parametrize('k', [1, 21, 31])
def test_rot_seed_tables_match_jax(k):
    from seqwin_tpu_torch.engine.phase1 import rot_seed_tables

    tabs = rot_seed_tables(k, torch.device('cpu'))
    assert tabs.shape == (2, k, 4) and tabs.is_contiguous()
    fwd, rev = jax_hybrid._rot_seed_tables(k)
    np.testing.assert_array_equal(u64.to_numpy(tabs[0]), fwd[:, :4])
    np.testing.assert_array_equal(u64.to_numpy(tabs[1]), rev[:, :4])


def _random_codes(rng, n, n_frac=0.0, run_frac=0.0):
    """`tests/test_hybrid.py`'s record generator: random bases, scattered
    Ns and N runs."""
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    if n_frac > 0:
        codes[rng.random(n) < n_frac] = 255
    if run_frac > 0:
        for _ in range(max(1, int(n * run_frac / 20))):
            s = int(rng.integers(0, n))
            codes[s:s + int(rng.integers(1, 40))] = 255
    return codes


def _hybrid_cases():
    """The case mix of `tests/test_hybrid.py`: (k, w, records)."""
    cases = []
    for k, w in [(7, 10), (21, 200), (8, 1), (1, 4)]:
        rng = np.random.default_rng(k * 31 + w)
        cases.append((k, w, [_random_codes(rng, n, f, r) for n, f, r in [
            (500, 0.0, 0.0), (1500, 0.02, 0.0), (30, 0.0, 0.0), (k + w - 2, 0.0, 0.0),
            (2048, 0.0, 0.3), (4000, 0.05, 0.1)]]))
    for seed in range(2):
        rng = np.random.default_rng(seed)
        k, w = int(rng.integers(3, 25)), int(rng.integers(1, 80))
        cases.append((k, w, [_random_codes(rng, int(rng.integers(10, 3000)), 0.03, 0.2)
                             for _ in range(int(rng.integers(1, 8)))]))
    rng = np.random.default_rng(99)
    c2 = np.full(800, 255, dtype=np.uint8)
    for a, b in ((100, 180), (200, 260), (300, 700)):
        c2[a:b] = rng.integers(0, 4, b - a)
    c1 = _random_codes(rng, 2000)
    c1[500:520] = 255
    cases.append((11, 16, [c1, c2, _random_codes(rng, 64)]))
    rng = np.random.default_rng(21)
    cases.append((7, 4, [np.zeros(0, np.uint8), rng.integers(0, 4, 500).astype(np.uint8),
                         np.zeros(0, np.uint8), rng.integers(0, 4, 3).astype(np.uint8),
                         rng.integers(0, 4, 800).astype(np.uint8), np.zeros(0, np.uint8)]))
    cases.append((7, 4, [np.zeros(0, np.uint8), np.zeros(0, np.uint8)]))
    return cases


@pytest.mark.parametrize('case', range(10), ids=[
    'k7_w10', 'k21_w200', 'k8_w1', 'k1_w4', 'random0', 'random1', 'edge_patterns',
    'empty_and_tiny', 'empty_only', 'single_short'])
def test_scan_records_hybrid_matches_jax(monkeypatch, case):
    """`scan_records_hybrid` against the JAX package's, arrays and dtypes."""
    monkeypatch.setenv('SEQWIN_TPU_PHASE1', 'xla')
    monkeypatch.setenv('SEQWIN_TPU_EXTRACT', 'topk')
    cases = _hybrid_cases() + [(5, 3, [np.arange(12, dtype=np.uint8) % 4])]
    k, w, records = cases[case]
    got = hybrid.scan_records_hybrid(records, k, w, device='cpu')
    want = jax_hybrid.scan_records_hybrid(records, k, w)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
