"""seqwin_tpu_torch's pandas-free host layer against the JAX package's
pandas-based one: BLAST hit reduction and metrics, the BLAST table parse,
the CSV writers, the `makeblastdb` stdin stream and the `mash dist` parse.
Only these tests import pandas."""
import gzip
import io
import subprocess
from dataclasses import astuple
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import seqwin_tpu.assemblies as jax_assemblies
import seqwin_tpu.mash as jax_mash
import seqwin_tpu.pipeline.markers as jax_markers
import seqwin_tpu_torch.assemblies as assemblies
import seqwin_tpu_torch.mash as mash
import seqwin_tpu_torch.pipeline.markers as markers
from seqwin_tpu.config import BLASTCONFIG
from seqwin_tpu_torch import ncbi
from seqwin_tpu_torch.utils import write_csv


def _columns(df: pd.DataFrame) -> dict:
    return {c: df[c].to_numpy() for c in df.columns}


def _assert_table_equal(got: dict, want: pd.DataFrame):
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        assert got[c].dtype == w.dtype, c
        np.testing.assert_array_equal(got[c], w, err_msg=c)


def _random_hit_table(rng: np.random.Generator, n_rows: int, n_query: int = 5) -> pd.DataFrame:
    """Hit tables of the JAX package's tests (small integer bitscores force
    ties), with float nident means over groups of many rows."""
    return pd.DataFrame(dict(
        qseqid=rng.integers(0, n_query, n_rows),
        assembly_idx=rng.integers(0, 4, n_rows),
        bitscore=rng.integers(50, 55, n_rows).astype(np.float64),
        nident=rng.integers(80, 120, n_rows),
        mismatch=rng.integers(0, 10, n_rows),
        gaps=rng.integers(0, 3, n_rows),
        record_id=[f'rec{i}' for i in range(n_rows)],
        is_target=rng.integers(0, 2, n_rows).astype(bool),
    ))


@pytest.mark.parametrize('seed', range(8))
def test_best_hits_match_jax(seed):
    rng = np.random.default_rng(seed)
    table = _random_hit_table(rng, int(rng.integers(1, 200)))
    _assert_table_equal(markers._best_hits_per_assembly(_columns(table)),
                        jax_markers._best_hits_per_assembly(table))


def test_best_hits_tie_goes_to_first_reported():
    """PARITY.md's pinned tie rule: equal bitscores go to the hit BLAST
    reported first."""
    table = pd.DataFrame(dict(
        qseqid=[0, 0, 0], assembly_idx=[1, 1, 1], bitscore=[99.0, 99.0, 42.0],
        nident=[10, 20, 30], record_id=['first', 'second', 'third'],
        is_target=[True, True, True],
    ))
    best = markers._best_hits_per_assembly(_columns(table))
    _assert_table_equal(best, jax_markers._best_hits_per_assembly(table))
    assert list(best['record_id']) == ['first'] and list(best['n_hits']) == [3]


@pytest.mark.parametrize('seed', range(6))
def test_get_metrics_match_jax(seed):
    """Per query: the best-hit rows through `_get_metrics`, exactly; groups
    up to a few hundred rows so the means take numpy's pairwise sums."""
    rng = np.random.default_rng(100 + seed)
    table = _random_hit_table(rng, int(rng.integers(50, 2000)), n_query=3)
    table['assembly_idx'] = rng.integers(0, 600, len(table))
    best = jax_markers._best_hits_per_assembly(table)
    n_tar, n_neg = int(rng.integers(300, 700)), int(rng.integers(1, 700))
    for q, group in best.groupby('qseqid', sort=False):
        group = group.drop(columns='qseqid').reset_index(drop=True)
        marker_len = int(rng.integers(150, 400))
        got = markers._get_metrics(_columns(group), marker_len, n_tar, n_neg)
        want = jax_markers._get_metrics(group, marker_len, n_tar, n_neg)
        assert astuple(got) == astuple(want)
    assert astuple(markers._get_metrics(None, 100, 2, 2)) == astuple(
        jax_markers._get_metrics(None, 100, 2, 2))


def _tag(asm: int, is_target: bool, rec: str) -> str:
    sep = BLASTCONFIG.header_sep
    return f'{asm}{sep}{BLASTCONFIG.bool2str[is_target]}{sep}{rec}'


@pytest.mark.parametrize('seed', [None, 0, 1, 2])
def test_eval_markers_with_mocked_blast(monkeypatch, tmp_path, seed):
    """The same raw hits through both packages' `eval_markers` (blast()
    mocked): equal per-query tables, equal metrics. ``None`` is the JAX
    package's hand-made table (a query with no hit, repeats, a non-target)."""
    if seed is None:
        raw = pd.DataFrame(dict(
            qseqid=[0, 0, 0, 2],
            sseqid=[_tag(0, True, 'r0'), _tag(0, True, 'r0b'), _tag(1, True, 'r1'),
                    _tag(2, False, 'r2')],
            nident=[100, 90, 95, 50], mismatch=[0, 5, 2, 10], gaps=[0, 1, 0, 2],
            bitscore=[200.0, 180.0, 190.0, 77.0],
        ))
        n_seqs = 3
    else:
        rng = np.random.default_rng(seed)
        n = int(rng.integers(20, 400))
        n_seqs = 6
        asm = rng.integers(0, 12, n)
        raw = pd.DataFrame(dict(
            qseqid=rng.integers(0, n_seqs, n),
            sseqid=[_tag(int(a), bool(a < 5), f'rec{i}@x') for i, a in enumerate(asm)],
            nident=rng.integers(150, 200, n), mismatch=rng.integers(0, 10, n),
            gaps=rng.integers(0, 4, n), bitscore=rng.integers(300, 304, n).astype(float),
        ))
    seqs = [('ACGT' * 60)[:180 + 7 * i] for i in range(n_seqs)]
    monkeypatch.setattr(jax_markers, 'blast', lambda *a, **k: raw.copy())
    monkeypatch.setattr(markers, 'blast', lambda *a, **k: _columns(raw))
    for title in (BLASTCONFIG.title_all, BLASTCONFIG.title_neg_only):
        db = tmp_path / title
        want_blast, want_metrics = jax_markers.eval_markers(seqs, db, n_tar=5, n_neg=7)
        got_blast, got_metrics = markers.eval_markers(seqs, db, n_tar=5, n_neg=7)
        assert [astuple(m) for m in got_metrics] == [astuple(m) for m in want_metrics]
        for got, want in zip(got_blast, want_blast, strict=True):
            assert (got is None) == (want is None)
            if want is not None:
                _assert_table_equal(got, want)


def test_blast_tsv_parse_matches_read_csv():
    """`ncbi.read_tsv` gives the columns and dtypes `pd.read_csv` infers on
    `-outfmt 6` text: integer counts, float evalue/bitscore, str ids and
    sequences; NA tokens and an empty table. Values equal pandas' but for
    the e-values, which are read correctly rounded (pandas' parser can be an
    ulp off there) and reach no output file."""
    rng = np.random.default_rng(7)
    lines = []
    for i in range(300):
        lines.append('\t'.join((
            str(int(rng.integers(0, 40))), _tag(int(rng.integers(0, 9)), bool(i % 2), f'c{i}'),
            str(int(rng.integers(100, 300))), str(int(rng.integers(0, 9))), str(int(rng.integers(0, 3))),
            '1', str(int(rng.integers(100, 300))), str(int(rng.integers(1, 10 ** 6))),
            str(int(rng.integers(1, 10 ** 6))), f'{rng.random() * 10.0 ** -rng.integers(0, 180):.3g}',
            f'{rng.random() * 500:.1f}', ''.join(rng.choice(list('ACGT-'), 30)),
        )))
    text = '\n'.join(lines) + '\n'
    cols = BLASTCONFIG.columns
    want = pd.read_csv(io.StringIO(text), sep='\t', header=None, names=cols, index_col=False)
    evalues = [float(line.split('\t')[cols.index('evalue')]) for line in lines]
    want['evalue'] = np.array(evalues)
    _assert_table_equal(ncbi.read_tsv(text, cols), want)
    # missing fields turn ints into floats and strings into NaN
    na = 'NA\t3\tx\n7\tnan\tNA\n'
    want = pd.read_csv(io.StringIO(na), sep='\t', header=None, names=('a', 'b', 'c'), index_col=False)
    got = ncbi.read_tsv(na, ('a', 'b', 'c'))
    assert [got[c].dtype for c in 'abc'] == [want[c].to_numpy().dtype for c in 'abc']
    np.testing.assert_array_equal(got['a'], want['a'].to_numpy())
    assert got['c'][0] == 'x' and np.isnan(got['c'][1]) and np.isnan(want['c'][1])
    want = pd.read_csv(io.StringIO(''), sep='\t', header=None, names=cols, index_col=False)
    _assert_table_equal(ncbi.read_tsv('', cols), want)


@pytest.mark.parametrize('scale', ['small', 'large', 'digits'])
def test_tsv_floats_read_correctly_rounded(scale):
    """A float column is float64, as pandas infers it, and each value is
    `float` of its field: small e-values, subnormals, 18+ digit mantissas,
    signs, bare points, and exponents past the double's range."""
    rng = np.random.default_rng({'small': 1, 'large': 2, 'digits': 3}[scale])
    n = 3000
    if scale == 'small':
        vals = [f'{rng.random() * 10.0 ** -int(rng.integers(0, 320)):.{rng.integers(1, 18)}g}'
                for _ in range(n)]
    elif scale == 'large':
        vals = [f'{rng.random() * 10.0 ** int(rng.integers(0, 300)):.{rng.integers(1, 18)}g}'
                for _ in range(n)]
    else:
        vals = [f'{"-" if i % 3 == 0 else ""}{rng.integers(0, 10 ** 12)}{rng.integers(0, 10 ** 9)}.'
                f'{rng.integers(0, 10 ** 9):09d}' for i in range(n)]
        vals += ['+7', '1.', '.5', '-0.0', '123456789012345678901234567890e-320', '1e-400']
    text = '\n'.join(vals) + '\n'
    got = ncbi.read_tsv(text, ['a'])['a']
    assert got.dtype == pd.read_csv(io.StringIO(text), header=None, names=['a'])['a'].dtype
    np.testing.assert_array_equal(got, np.array([float(v) for v in vals]))


def test_blast_batches_concatenate(monkeypatch):
    """Batches of blastn output are read and joined in order."""
    calls = []

    def fake_run_tool(*argv, stdin=None, check=True):
        calls.append(stdin)
        n = len(calls)
        out = f'{n}\t0@y@r\t9\t0\t0\t1\t9\t1\t9\t1e-5\t{n}.5\tACGT\n'
        return subprocess.CompletedProcess(argv, 0, stdout=out, stderr='')

    monkeypatch.setattr(ncbi, 'run_tool', fake_run_tool)
    table = ncbi.blast(['A', 'C', 'G'], Path('db'), columns=BLASTCONFIG.columns, batch_size=2)
    assert calls == ['>0\nA\n>1\nC\n', '>2\nG\n']
    assert table['qseqid'].tolist() == [1, 2] and table['bitscore'].tolist() == [1.5, 2.5]


def test_signatures_csv_matches_pandas(tmp_path):
    """`write_csv` writes what `DataFrame.to_csv(index=False,
    lineterminator='\\n')` writes for signature rows: all-None metric columns
    as empty fields, floats in the shortest repr, quoting of headers that
    hold commas or quotes."""
    rng = np.random.default_rng(3)
    names = ('fasta_header', 'length', *markers._METRIC_NAMES, 'rep_ratio', 'n_nodes')
    floats = [0.0, 1.0, 0.1, 1 / 3, 1e-5, 2.5e-7, 123456789.0, 1e16, 1.5e17, np.float64(0.7)]
    for blast_run in (False, True):
        rows = []
        for i in range(40):
            header = f'{i}-rec{i}{",x" if i % 7 == 0 else ""}{chr(34) if i % 11 == 0 else ""}-{i}:{i + 300}'
            metrics = ([floats[int(rng.integers(0, len(floats)))] * rng.random() if i % 3 else
                        floats[i % len(floats)] for _ in markers._METRIC_NAMES] if blast_run
                       else [None] * len(markers._METRIC_NAMES))
            rows.append((header, int(rng.integers(200, 900)), *metrics,
                         int(rng.integers(1, 9)) / 8, int(rng.integers(3, 40))))
        for n in (len(rows), 0):
            got_path = tmp_path / f'got_{blast_run}_{n}.csv'
            want_path = tmp_path / f'want_{blast_run}_{n}.csv'
            write_csv(got_path, names, rows[:n])
            pd.DataFrame(rows[:n], columns=names).to_csv(
                want_path, index=False, encoding='utf-8', lineterminator='\n')
            assert got_path.read_bytes() == want_path.read_bytes()


def _fastas(tmp_path: Path, n: int) -> list[Path]:
    paths = []
    for i in range(n):
        p = tmp_path / (f'a{i},x.fasta' if i == 1 else f'a{i}.fasta')
        p.write_text(f'>rec{i} extra\nACGT\n>rec{i}b\nTTTT\n')
        paths.append(p)
    gz = tmp_path / f'a{n}.fasta.gz'
    gz.write_bytes(gzip.compress(b'>recz\nGGGG\n'))
    return paths + [gz]


def test_assemblies_csv_matches_pandas(tmp_path):
    paths = _fastas(tmp_path, 4)
    got, want = tmp_path / 'got.csv', tmp_path / 'want.csv'
    assemblies.Assemblies(paths[:3], paths[3:]).to_csv(got)
    jax_assemblies.Assemblies(paths[:3], paths[3:]).to_csv(
        want, columns=('path', 'is_target'), index=True)
    assert got.read_bytes() == want.read_bytes()


class _FakeProc:
    """Stub makeblastdb process: records stdin bytes, exits 0."""

    def __init__(self):
        self.stdin = io.BytesIO()
        self.returncode = 0

    def communicate(self):
        return b'fake stdout', b''


@pytest.mark.parametrize('neg_only', [False, True])
def test_makeblastdb_stream_matches_jax(monkeypatch, tmp_path, neg_only):
    """The stdin byte stream (assemblies in index order, headers tagged
    `{idx}@{y/n}@`) equals the JAX package's, with Popen stubbed."""
    paths = _fastas(tmp_path, 4)
    streams = []
    for mod, prefix in ((jax_assemblies, 'jax'), (assemblies, 'port')):
        fake = _FakeProc()
        monkeypatch.setattr(subprocess, 'Popen', lambda *a, **k: fake)
        db = mod.Assemblies(paths[:3], paths[3:]).makeblastdb(
            prefix=tmp_path / prefix, neg_only=neg_only, overwrite=False, n_cpu=2)
        assert db.name == (BLASTCONFIG.title_neg_only if neg_only else BLASTCONFIG.title_all)
        streams.append(fake.stdin.getvalue())
    assert streams[0] == streams[1] and streams[0].count(b'>') == (3 if neg_only else 9)


def test_windowed_ordered_preserves_submission_order():
    import time
    from concurrent.futures import ThreadPoolExecutor

    def job(i):
        time.sleep(0.02 if i % 3 == 0 else 0.0)
        return i

    with ThreadPoolExecutor(max_workers=4) as ex:
        got = list(assemblies._windowed_ordered(ex, job, ((i,) for i in range(20)), window=3))
    assert got == list(range(20))


@pytest.fixture
def no_process_pools(monkeypatch):
    """Creating a multiprocessing pool or a process pool executor raises."""
    import concurrent.futures
    import multiprocessing.pool

    def refuse(*args, **kwargs):
        raise AssertionError('a process pool was created')

    monkeypatch.setattr(multiprocessing.pool.Pool, '__init__', refuse)
    monkeypatch.setattr(concurrent.futures.ProcessPoolExecutor, '__init__', refuse)


@pytest.mark.parametrize('forbid_fork', [False, True])
def test_fetch_seq_matches_jax(request, tmp_path, forbid_fork):
    """Marker sequences sliced out of the FASTAs (`load_fasta`: lower case
    read upper, a gzipped file among them), in span order, in two threads;
    with every process pool refused too."""
    rng = np.random.default_rng(5)
    paths = []
    for i in range(4):
        p = tmp_path / (f's{i}.fa.gz' if i == 3 else f's{i}.fa')
        recs = [''.join(rng.choice(list('ACGTacgtn'), int(rng.integers(50, 400)))) for _ in range(3)]
        text = ''.join(f'>r{j}\n' + '\n'.join(r[o:o + 60] for o in range(0, len(r), 60)) + '\n'
                       for j, r in enumerate(recs))
        p.write_bytes(gzip.compress(text.encode()) if i == 3 else text.encode())
        paths.append(p)
    spans = [(int(rng.integers(0, 4)), int(rng.integers(0, 3)), s, s + int(rng.integers(1, 40)))
             for s in rng.integers(0, 40, 16)]
    want = jax_assemblies.Assemblies(paths[:2], paths[2:]).fetch_seq(spans, n_cpu=1)
    if forbid_fork:
        request.getfixturevalue('no_process_pools')
    got = assemblies.Assemblies(paths[:2], paths[2:]).fetch_seq(spans, n_cpu=2)
    assert got == want and all(got)
    assert {a for a, _, _, _ in spans} == {0, 1, 2, 3}


def test_mash_dist_parse_matches_jax(monkeypatch):
    out = ('a.fa\tb.fa\t0.01\t0\t900/1000\n'
           'b.fa\ta.fa\t0.25\t1.5e-30\t1/1000\n')

    def fake_run_tool(*argv, stdin=None, check=True):
        return subprocess.CompletedProcess(argv, 0, stdout=out, stderr='')

    monkeypatch.setattr(jax_mash, 'run_tool', fake_run_tool)
    monkeypatch.setattr(mash, 'run_tool', fake_run_tool)
    want = jax_mash.dist(Path('x.msh'))
    # p-values are read correctly rounded, where pandas' parser is an ulp off
    want['pval'] = np.array([0.0, float('1.5e-30')])
    _assert_table_equal(mash.dist(Path('x.msh')), want)
