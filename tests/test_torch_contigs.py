"""Draft assemblies of many contigs: the port's whole CLI job against the
benchmark's plain reference, and the contig generator that makes them.

The job (`cli.main` with the benchmark's traffic ``cli``) runs on contig
sets from `portbench/datagen/golden171_contigs.py`, re-cut where a case
needs a contig of a given length, an N run at a contig's head or tail, an
empty record or a chunk budget at a given place. Its outputs are compared
with `portbench.reference.pipeline.run` through `portbench.compare`, which
decides the benchmark's ``correct``: every layer exact. Imports no JAX.

On the CPU at small sizes; the ``gpu`` case runs 8 of the configuration
``salmonella171_contigs``'s genomes (4.7 Mbp, 50-300 contigs each) on the
card:

    python -m pytest --noconftest tests/test_torch_contigs.py -m gpu
"""
import dataclasses
import hashlib
import importlib
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import compare, outputs, spec  # noqa: E402
from portbench.datagen import golden171_contigs as gen  # noqa: E402
from portbench.datagen import golden171_proxy as proxy  # noqa: E402
from portbench.datagen.golden171_proxy import write_fasta  # noqa: E402
from portbench.reference import fasta, pipeline  # noqa: E402

build_mod = importlib.import_module('seqwin_tpu_torch.graph.build')

K, W = 21, 200
ARGV = json.loads((ROOT / 'portbench' / 'traffic' / 'cli.json').read_text())['argv']
PARAMS = dict(n_tar=3, n_neg=4, genome_len=40_000, tar_snp_rate=0.005, neg_snp_rate=0.01,
              neg_root_divergence=0.08, n_run=[10, 300], contigs_per_genome=[5, 30],
              contig_len=[100, 20_000])
SEED = 3141592653589  # above 2^32


@pytest.fixture(scope='module')
def drafts(tmp_path_factory):
    """The generator's contig set: (paths, is_target, record lengths)."""
    data = gen.generate(tmp_path_factory.mktemp('drafts'), SEED, **PARAMS)
    return data['paths'], data['is_target'], data['record_lengths']


def _genomes(paths):
    """Each file's genome bases (its records joined) and record lengths."""
    out = []
    for p in paths:
        _, recs = fasta.read_records(p)
        out.append((np.concatenate(recs), [len(r) for r in recs]))
    return out


def _codes(g):
    """Base codes for `write_fasta` (N as 4)."""
    return np.where(g > 3, 4, g).astype(np.uint8)


def _short_contigs(n):
    """A contig of ``n`` bases at each genome's head, middle and tail."""
    def cut(g, lens, i):
        total = len(g)
        cuts = set(np.cumsum(lens)[:-1].tolist())
        for a in (0, total // 2, total - n):
            cuts -= set(range(a + 1, a + n))
            cuts |= {a, a + n}
        cuts = sorted(cuts - {0, total})
        assert list(np.diff([0, *cuts, total])).count(n) >= 3
        return g, cuts
    return cut


def _n_run(where):
    """A 40-base N run at the head (or tail) of each genome's second contig."""
    def cut(g, lens, i):
        bounds = np.cumsum(lens)
        g = g.copy()
        if where == 'head':
            g[bounds[0]:bounds[0] + 40] = 4
        else:
            g[bounds[1] - 40:bounds[1]] = 4
        return g, bounds[:-1].tolist()
    return cut


def _empty(g, lens, i):
    """Empty records: one between two contigs, one last, one first in every
    other file."""
    cuts = np.cumsum(lens)[:-1].tolist()
    cuts = sorted(cuts + [cuts[len(cuts) // 2], len(g)] + ([0] if i % 2 else []))
    return g, cuts


def _keep(g, lens, i):
    return g, np.cumsum(lens)[:-1].tolist()


def _budget_between(lens0):
    """The first chunk full at the end of the first file's third contig."""
    return int(sum(lens0[:3]))


def _budget_inside(lens0):
    """The budget ends inside the first file's longest contig after its
    first, so that contig opens the next chunk."""
    bounds = np.cumsum(lens0)
    j = max(range(1, len(lens0)), key=lambda j: (lens0[j] <= bounds[j - 1], lens0[j]))
    budget = int(bounds[j - 1] + lens0[j] // 2)
    assert lens0[j] <= budget
    return budget


def _budget_below_longest(lens0):
    """The first file's longest contig above the budget: scanned in blocks."""
    return int(max(lens0)) - 1


CASES = {
    # name: (re-cut of each genome, chunk budget from the first file's lengths)
    'as_generated': (_keep, None),
    'contig_shorter_than_k': (_short_contigs(K - 1), None),
    'contig_shorter_than_a_window': (_short_contigs(K + W - 2), None),
    'contig_of_exactly_one_window': (_short_contigs(K + W - 1), None),
    'n_run_across_a_head': (_n_run('head'), None),
    'n_run_across_a_tail': (_n_run('tail'), None),
    'empty_records': (_empty, None),
    'budget_between_contigs': (_keep, _budget_between),
    'budget_inside_a_contig': (_keep, _budget_inside),
    'contig_above_the_budget': (_keep, _budget_below_longest),
}


def _cpu_cli(monkeypatch):
    from seqwin_tpu_torch import cli

    orig = cli.config_from_args
    monkeypatch.setattr(cli, 'config_from_args',
                        lambda args: dataclasses.replace(orig(args), device='cpu'))
    return cli


def _job_against_reference(cli, work: Path, paths, is_target, device, n_cpu):
    """Run one CLI job over ``paths`` and compare it with the reference; the
    comparison numbers, rows by layer, and the job's outputs."""
    lists = []
    for key, want in (('tar', True), ('neg', False)):
        lists.append(work / f'{key}_paths.txt')
        lists[-1].write_text(''.join(f'{p}\n' for p, t in zip(paths, is_target) if t == want))
    assert cli.main(['--tar-paths', str(lists[0]), '--neg-paths', str(lists[1]),
                     '--prefix', str(work), '--title', 'job', '-k', str(K), '-w', str(W),
                     *ARGV, '-p', str(n_cpu)]) == 0
    got = outputs.read(work / 'job')
    want = pipeline.run(paths, is_target, K, W, ARGV, device, n_cpu=n_cpu)
    return compare.compare(want, got), compare.layers(want, got), got


@pytest.mark.parametrize('case', list(CASES))
def test_contig_job_matches_the_reference(case, drafts, tmp_path, monkeypatch):
    recut, budget = CASES[case]
    paths, is_target, _ = drafts
    genomes = _genomes(paths)
    new_paths, n_records = [], 0
    for i, (p, (g, lens)) in enumerate(zip(paths, genomes)):
        g, cuts = recut(g, lens, i)
        parts = np.split(_codes(g), cuts)
        new_paths.append(tmp_path / p.name)
        write_fasta(new_paths[-1], [(f'c{i}_{j}', r) for j, r in enumerate(parts)])
        n_records += len(parts)
        if 'empty' in case:
            assert sum(len(r) == 0 for r in parts) == 2 + i % 2
    if budget is not None:
        monkeypatch.setattr(build_mod, 'DEFAULT_CHUNK_BASES', budget(genomes[0][1]))
    cli = _cpu_cli(monkeypatch)
    numbers, by_layer, got = _job_against_reference(cli, tmp_path, new_paths, is_target, 'cpu', 2)
    assert by_layer == {'graph': 0, 'subgraphs': 0, 'markers': 0, 'files': 0}
    assert numbers == {'rows_differing': 0, 'threshold_gap': 0}
    assert len(got.record_offsets) == len(paths) + 1 and int(got.record_offsets[-1]) == n_records
    assert got.markers  # the comparison reaches the markers and their files


# --- the generator ---

# sha256 over (file name, bytes) of every file of `PARAMS` at `SEED`
DIGEST = '26c8632da39916923898b8ab365067d904e275a445587bee6e2d9239f23038e1'


def _digest(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


@pytest.mark.parametrize('threads', [1, 8])
def test_bytes_for_a_fixed_seed(tmp_path, threads):
    data = gen.generate(tmp_path, SEED, threads=threads, **PARAMS)
    assert _digest(data['paths']) == DIGEST
    assert data['is_target'] == [True] * 3 + [False] * 4


@pytest.mark.parametrize('params', [
    PARAMS,
    # the configuration's law at its genome length
    dict(PARAMS, n_tar=1, n_neg=1, genome_len=4_700_000, contigs_per_genome=[50, 300],
         contig_len=[500, 1_000_000]),
    # bounds that clip often: many contigs at the floor, a few at the ceiling
    dict(PARAMS, contigs_per_genome=[30, 30], contig_len=[1_000, 2_000]),
], ids=['small', 'published', 'clipped'])
def test_contigs_within_bounds_and_summing_to_the_genome(tmp_path, params):
    data = gen.generate(tmp_path, 7, **params)
    lo, hi = params['contig_len']
    lens, at = data['record_lengths'], 0
    for p in data['paths']:
        ids, recs = fasta.read_records(p)
        n = len(recs)
        assert params['contigs_per_genome'][0] <= n <= params['contigs_per_genome'][1]
        assert sum(lens[at:at + n]) == params['genome_len']
        assert all(lo <= x <= hi for x in lens[at:at + n])
        # record_lengths is what was written
        assert [len(r) for r in recs] == lens[at:at + n]
        assert ids == [f'{ids[0].rsplit("_", 1)[0]}_{j}' for j in range(n)]
        at += n
    assert at == len(lens)


def test_impossible_bounds_are_refused(tmp_path):
    with pytest.raises(ValueError):
        gen.generate(tmp_path, 1, **dict(PARAMS, contigs_per_genome=[2, 2],
                                         contig_len=[100, 1_000]))


@pytest.mark.parametrize('content_seed', [None, 171])
def test_genome_bases_are_the_two_record_proxys(tmp_path, content_seed):
    """For one seed each genome's records, joined, are `golden171_proxy`'s
    with two records a genome: only the cut differs."""
    base = {k: v for k, v in PARAMS.items() if k not in ('contigs_per_genome', 'contig_len')}
    a = gen.generate(tmp_path / 'a', 29, content_seed=content_seed, **PARAMS)
    b = proxy.generate(tmp_path / 'b', 29, records_per_genome=2, content_seed=content_seed,
                       **base)
    assert a['is_target'] == b['is_target']
    for pa, pb in zip(a['paths'], b['paths']):
        assert pa.name == pb.name
        ra, rb = fasta.read_records(pa)[1], fasta.read_records(pb)[1]
        assert len(ra) > 2 and len(rb) == 2
        np.testing.assert_array_equal(np.concatenate(ra), np.concatenate(rb))


def test_seeds_differ_in_layout(tmp_path):
    a = gen.generate(tmp_path / 'a', 1, **PARAMS)
    b = gen.generate(tmp_path / 'b', 2, **PARAMS)
    assert a['record_lengths'] != b['record_lengths']


@pytest.mark.gpu
def test_eight_published_genomes_on_the_card(tmp_path):
    """8 of the configuration's genomes (3 targets, 5 non-targets) at 4.7 Mbp
    in 50-300 contigs each: the CLI job on the card against the reference
    on the card, every layer exact."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    from seqwin_tpu_torch import cli

    config = spec.cell(spec.benchmark(), 's171_contigs')['config']
    assert (config['kmerlen'], config['windowsize']) == (K, W)
    params = dict(config['generator_params'], n_tar=3, n_neg=5)
    data = gen.generate(tmp_path / 'fasta', 2718281849, **params)
    with ThreadPoolExecutor(max_workers=8) as ex:
        written = [len(r) for _, recs in ex.map(fasta.read_records, data['paths']) for r in recs]
    assert written == data['record_lengths'] and 400 <= len(written) <= 2400
    numbers, by_layer, got = _job_against_reference(cli, tmp_path, data['paths'],
                                                    data['is_target'], 'cuda', 4)
    assert by_layer == {'graph': 0, 'subgraphs': 0, 'markers': 0, 'files': 0}
    assert numbers == {'rows_differing': 0, 'threshold_gap': 0}
    assert got.markers
    print(json.dumps({'records': len(written), 'markers': len(got.markers),
                      'device': torch.cuda.get_device_name(0)}))
