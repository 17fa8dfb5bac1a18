"""The port's device MinHash sketches (`mash.device_sketches`), their Jaccard
matrix (`mash.sketch_jaccard_matrix`) and the threshold's two expectations
(`pipeline/kmers._expected_frac`) against the benchmark's plain-torch
reference (`portbench/reference/sketches.py`), which decides the sketch
cell's `correct`. Imports no JAX. Every comparison is exact: sketches are
integers, and each Jaccard index is the same ratio of integers in float64.

On the CPU at small sizes; the ``gpu`` case runs the 171-assembly set of
the benchmark's configuration ``salmonella171_mash`` (k=21, sketch size 1000)
on the card:

    python -m pytest --noconftest tests/test_torch_sketch_reference.py -m gpu
"""
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import spec  # noqa: E402
from portbench.reference import fasta  # noqa: E402
from portbench.reference import sketches as ref  # noqa: E402
from portbench.reference.minimizers import seed_tables  # noqa: E402
from portbench.reference.pipeline import SKETCH_SIZE  # noqa: E402
from seqwin_tpu_torch import mash  # noqa: E402
from seqwin_tpu_torch.pipeline.kmers import _expected_frac  # noqa: E402

N = 255  # an invalid base, as the parsers write N


def _codes(rng, n, n_runs=0):
    """``n`` random codes with ``n_runs`` runs of N."""
    c = rng.integers(0, 4, size=n).astype(np.uint8)
    for _ in range(n_runs):
        at = int(rng.integers(0, max(1, n - 40)))
        c[at:at + int(rng.integers(1, 40))] = N
    return c


def _mutated(rng, c, rate):
    c = c.copy()
    idx = rng.integers(0, len(c), size=int(len(c) * rate))
    c[idx] = (c[idx] + rng.integers(1, 4, size=idx.size).astype(np.uint8)) % 4
    return c


def _multi_record(rng):
    """Targets from one ancestor, non-targets from a root 8% away; two to
    four records each, with N runs."""
    anc = _codes(rng, 9_000)
    root = _mutated(rng, anc, 0.08)
    out = []
    for base, rate in ((anc, 0.01),) * 3 + ((root, 0.02),) * 4:
        g = _mutated(rng, base, rate)
        cuts = np.sort(rng.choice(np.arange(100, len(g) - 100), size=int(rng.integers(1, 4)),
                                  replace=False))
        recs = np.split(g, cuts)
        for r in recs:
            r[rng.random(len(r)) < 0.002] = N
        out.append(recs)
    return out, 3


def _short_and_empty(rng):
    """No records; one record shorter than k; an empty record beside a
    k-mer's worth; all N; and two whole assemblies."""
    g = _codes(rng, 3_000, n_runs=2)
    return [[g], [], [_codes(rng, 12)], [np.zeros(0, np.uint8), _codes(rng, 21)],
            [np.full(500, N, np.uint8)], [_mutated(rng, g, 0.01)]], 2


def _identical_and_disjoint(rng):
    """An assembly, its copy, the same records in another order, and one
    that shares no k-mer with it."""
    a, b = _codes(rng, 2_500, n_runs=1), _codes(rng, 1_800)
    return [[a, b], [a.copy(), b.copy()], [b, a], [_codes(rng, 4_000)]], 2


def _repeats(rng):
    """Low-complexity records: each k-mer many times, so few distinct."""
    unit = _codes(rng, 37)
    return [[np.tile(unit, 60)], [np.tile(unit, 30), _codes(rng, 300)], [np.tile(unit[:19], 90)]], 1


CASES = {
    # name: (assemblies, n_tar), k, sketch size
    'multi_record_n_runs_size_below': (_multi_record, 21, 200),
    'multi_record_n_runs_size_above': (_multi_record, 21, 20_000),
    'multi_record_n_runs_small_k': (_multi_record, 9, 500),
    'short_and_empty': (_short_and_empty, 21, 100),
    'identical_and_disjoint': (_identical_and_disjoint, 21, 300),
    'repeats_size_below': (_repeats, 11, 20),
    'repeats_size_above': (_repeats, 11, 1_000),
}


def _reference(assemblies, k, size, device):
    tables = seed_tables(k, device)
    sketches = [ref.sketch(recs, k, size, tables, device) for recs in assemblies]
    n = len(sketches)
    mtx = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for j in range(i, n):
            mtx[i, j] = mtx[j, i] = ref.jaccard(sketches[i], sketches[j], size)
    return sketches, mtx


def _assert_matches(assemblies, n_tar, k, size, device, stats=None):
    got = mash.device_sketches(assemblies, k, size, device=device, stats=stats)
    want, want_mtx = _reference(assemblies, k, size, device)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == np.uint64, i
        np.testing.assert_array_equal(g, w, err_msg=f'sketch {i}')
    mtx = mash.sketch_jaccard_matrix(got, size, device=device)
    assert mtx.dtype == np.float64
    np.testing.assert_array_equal(mtx, want_mtx)
    expected = (1 - _expected_frac(mtx[:n_tar, :n_tar]), _expected_frac(mtx[n_tar:, :n_tar]))
    assert expected == ref.expectations(want, n_tar, size)
    return got, mtx


@pytest.mark.parametrize('case', sorted(CASES))
def test_sketches_match_the_reference(case):
    make, k, size = CASES[case]
    assemblies, n_tar = make(np.random.default_rng(sum(map(ord, case))))
    got, mtx = _assert_matches(assemblies, n_tar, k, size, 'cpu')
    lens = [len(s) for s in got]
    if 'size_below' in case:
        assert max(lens) == size
    if 'size_above' in case:
        assert 0 < max(lens) < size
    if case == 'short_and_empty':
        assert lens[1:5] == [0, 0, 1, 0] and mtx[1, 1] == mtx[1, 2] == 0.0
    if case == 'identical_and_disjoint':
        assert mtx[0, 1] == mtx[0, 2] == 1.0 and mtx[0, 3] == 0.0


@pytest.mark.gpu
def test_sketches_of_the_171_assemblies_on_the_card(tmp_path):
    """Every sketch of the benchmark's 171-assembly set (803.7 Mbp) and the
    whole 171 x 171 Jaccard matrix on the card, against the reference; the
    sketches come from the cut path (kernels `sketch_cut` and
    `sketch_select`) with no assembly redone."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    bench = spec.benchmark()
    cell = spec.cell(bench, 's171_sketch')
    config = cell['config']
    gen = spec.module('datagen', config['generator'])
    data = gen.generate(tmp_path, 2718281849, **config['generator_params'])
    with ThreadPoolExecutor(max_workers=8) as ex:
        assemblies = [codes for _, codes in ex.map(fasta.read_records, data['paths'])]
    assert sum(map(len, (r for recs in assemblies for r in recs))) == sum(data['record_lengths'])
    launches, stats = mash.sketch_select.launches, {}
    got, mtx = _assert_matches(assemblies, sum(data['is_target']), config['kmerlen'],
                               SKETCH_SIZE, 'cuda', stats)
    assert mash.sketch_select.launches == launches + 1 and stats['fallbacks'] == 0
    assert len(got) == 171 and all(len(s) == SKETCH_SIZE == 1000 for s in got)
    print(json.dumps({'assemblies': len(got), 'pairs': int(np.triu_indices(len(got))[0].size),
                      'jaccard_min': float(mtx.min()), 'jaccard_max': float(mtx.max()),
                      **stats, 'device': torch.cuda.get_device_name(0)}))
