"""seqwin_tpu_torch's build timeline (``SEQWIN_TPU_TORCH_TIMELINE=1``,
`engine/timeline.py`) against the JAX package's (``SEQWIN_TPU_TIMELINE=1``):
off by default, its gate, and the event names, order and attributes of a
three-chunk build."""
import importlib
from collections import defaultdict

import numpy as np
import pytest

from seqwin_tpu.engine import timeline as jax_timeline
from seqwin_tpu.graph.build import build as jax_build
from seqwin_tpu_torch.engine import timeline
from seqwin_tpu_torch.graph.build import build

build_mod = importlib.import_module('seqwin_tpu_torch.graph.build')

K, W = 21, 50
BUDGET = 40_000


@pytest.fixture(scope='module')
def fastas(tmp_path_factory):
    """Three assemblies of two records (one with an N run) that pack into
    three chunks at the 40 kbp budget."""
    tmp = tmp_path_factory.mktemp('timeline')
    rng = np.random.default_rng(3)
    alpha = np.frombuffer(b'ACGTN', dtype=np.uint8)
    paths = []
    for i in range(3):
        recs = [rng.integers(0, 4, size=n).astype(np.uint8) for n in (22_000, 15_000)]
        recs[0][5000:5100] = 4
        p = tmp / f'g{i}.fa'
        p.write_text(''.join(f'>g{i}_{j}\n' + alpha[r].tobytes().decode() + '\n'
                             for j, r in enumerate(recs)))
        paths.append(p)
    return paths, [True, True, False]


@pytest.fixture
def clean_timelines(monkeypatch):
    monkeypatch.delenv('SEQWIN_TPU_TORCH_TIMELINE', raising=False)
    monkeypatch.delenv('SEQWIN_TPU_TIMELINE', raising=False)
    timeline.reset()
    jax_timeline.reset()
    yield
    monkeypatch.delenv('SEQWIN_TPU_TORCH_TIMELINE', raising=False)
    monkeypatch.delenv('SEQWIN_TPU_TIMELINE', raising=False)
    timeline.reset()
    jax_timeline.reset()


def test_timeline_off_by_default(fastas, clean_timelines):
    paths, targets = fastas
    build(paths, K, W, targets, device='cpu')
    assert not timeline.enabled()
    assert timeline.drain() == []


def test_timeline_gate_is_reread(fastas, clean_timelines, monkeypatch):
    """`reset()` re-reads the variable and clears; a build re-reads it when
    it starts and keeps what is recorded."""
    assert not timeline.enabled()
    monkeypatch.setenv('SEQWIN_TPU_TORCH_TIMELINE', '1')
    assert not timeline.enabled()  # cached until re-read
    timeline.reset()
    assert timeline.enabled()
    timeline.mark('before', x=1)
    monkeypatch.delenv('SEQWIN_TPU_TORCH_TIMELINE')
    assert timeline.enabled()
    timeline.reset()
    assert not timeline.enabled() and timeline.drain() == []
    monkeypatch.setenv('SEQWIN_TPU_TORCH_TIMELINE', '1')
    timeline.mark('ignored')
    paths, targets = fastas
    build(paths, K, W, targets, device='cpu')
    events = timeline.drain()
    assert events and 'ignored' not in [e for _, e, _ in events]
    assert [t for t, _, _ in events] == sorted(t for t, _, _ in events)


def _per_chunk(events):
    """Event names per chunk (by rec_base), and the chunk-free events."""
    chunks, rest = defaultdict(list), []
    for _, name, attrs in events:
        if 'rec_base' in attrs:
            chunks[attrs['rec_base']].append(name)
        else:
            rest.append((name, attrs.get('n_chunks')))
    return dict(chunks), rest


def test_timeline_events_match_jax(fastas, clean_timelines, monkeypatch):
    paths, targets = fastas
    monkeypatch.setattr(build_mod, 'DEFAULT_CHUNK_BASES', BUDGET)
    monkeypatch.setattr(importlib.import_module('seqwin_tpu.graph.build'),
                        'DEFAULT_CHUNK_BASES', BUDGET)
    monkeypatch.setenv('SEQWIN_TPU_TORCH_TIMELINE', '1')
    monkeypatch.setenv('SEQWIN_TPU_TIMELINE', '1')
    jax_timeline.reset()
    got = build(paths, K, W, targets, n_cpu=2, device='cpu')
    want = jax_build(paths, K, W, targets, n_cpu=2)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    got_chunks, got_rest = _per_chunk(timeline.drain())
    want_chunks, want_rest = _per_chunk(jax_timeline.drain())
    assert sorted(got_chunks) == sorted(want_chunks) == [0, 2, 4]
    assert got_chunks == want_chunks
    assert all(names == ['prep_start', 'h2d_submit', 'h2d_returned', 'dispatched']
               for names in got_chunks.values())
    assert got_rest == want_rest == [('counts_fetch_start', 3), ('counts_fetched', None),
                                     ('agg_merge_nodes_done', None), ('agg_kn_d2h_done', None)]


# --- the span recorder (`timeline.span`) ---

SPAN_TABLE = (
    'run', 'run.assemblies', 'run.save_results',
    'phase.build_graph', 'phase.threshold', 'phase.subgraphs', 'phase.markers',
    'build', 'io.parse', 'build.ingest_wait', 'hybrid.host_prep', 'hybrid.patches',
    'build.prep_wait', 'build.dispatch', 'build.blocks', 'block.sync', 'build.counts_fetch',
    'build.aggregate',
    'threshold.sketches', 'sketch.join', 'sketch.fetch', 'threshold.jaccard',
    'subgraphs.edges', 'subgraphs.search', 'subgraphs.compact',
    'markers.candidates', 'markers.candidate_args', 'markers.fetch_seq', 'markers.write',
)
MARKS = {'prep_start', 'h2d_submit', 'h2d_returned', 'dispatched', 'counts_fetch_start',
         'counts_fetched', 'agg_merge_nodes_done', 'agg_kn_d2h_done'}


def _annotations(prof):
    """(name, start ns, end ns) of a stopped profiler's host annotations."""
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


def test_span_off_records_nothing(clean_timelines):
    from torch.profiler import ProfilerActivity, profile

    assert timeline.span('a') is timeline.span('b', parent=None, x=1)  # one shared context
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timeline.span('seqwin.off') as s:
            s.set(n=1)
            assert not s and timeline.current() is None
    assert timeline.spans() == [] and timeline.drain() == []
    assert 'seqwin.off' not in [name for name, _, _ in _annotations(prof)]


@pytest.fixture
def slow_prep(monkeypatch):
    """Every chunk's host prep takes 0.2 s more, so the main thread waits on
    the last one (`build.prep_wait`) however the threads are scheduled."""
    import time

    orig = build_mod.pinned_host_prep

    def prep(*args):
        time.sleep(0.2)
        return orig(*args)

    monkeypatch.setattr(build_mod, 'pinned_host_prep', prep)


def test_build_spans_from_prep_threads(fastas, clean_timelines, monkeypatch, slow_prep):
    """A three-chunk build: the prep pool's `hybrid.host_prep` spans, on
    threads of their own, are children of the build's span; the main
    thread's waits are spans too."""
    import threading

    paths, targets = fastas
    monkeypatch.setattr(build_mod, 'DEFAULT_CHUNK_BASES', BUDGET)
    monkeypatch.setenv('SEQWIN_TPU_TORCH_TIMELINE', '1')
    build(paths, K, W, targets, n_cpu=2, device='cpu')
    spans = timeline.spans()
    main = threading.get_native_id()
    (root,) = [s for s in spans if s.name == 'build']
    preps = [s for s in spans if s.name == 'hybrid.host_prep']
    assert sorted(s.attrs['rec_base'] for s in preps) == [0, 2, 4]
    assert all(s.thread != main and s.parent == root.id for s in preps)
    assert all(s.attrs['bases'] > 0 for s in preps)
    names = {s.name for s in spans}
    assert {'build.ingest_wait', 'build.prep_wait', 'build.dispatch', 'io.parse',
            'build.counts_fetch', 'build.aggregate'} <= names
    assert all(s.run == root.id for s in spans)
    assert all(root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns for s in spans)
    parses = [s for s in spans if s.name == 'io.parse']
    assert len(parses) == 3 and all(s.parent == root.id and s.attrs['records'] == 2
                                    for s in parses)


@pytest.mark.parametrize('recording', [True, False])
def test_patch_spans(fastas, clean_timelines, monkeypatch, recording):
    """A three-chunk build: one `hybrid.patches` a chunk, inside that chunk's
    `hybrid.host_prep` on the same thread, with the chunk's record starts,
    the windows `host_patches` returned and the positions it hashed;
    nothing when off."""
    import threading

    from seqwin_tpu_torch.engine import hybrid
    from seqwin_tpu_torch.ops import host_hash

    calls, lock, local = [], threading.Lock(), threading.local()
    orig_hash, orig_patches = host_hash.canon_at, hybrid.host_patches

    def canon_at(codes, pos, k):
        local.hashed += len(pos)
        return orig_hash(codes, pos, k)

    def host_patches(starts, *args, **kwargs):
        local.hashed = 0
        irr_pos, patch_z = orig_patches(starts, *args, **kwargs)
        with lock:
            calls.append((len(starts), len(irr_pos), local.hashed))
        return irr_pos, patch_z

    monkeypatch.setattr(host_hash, 'canon_at', canon_at)
    monkeypatch.setattr(hybrid, 'host_patches', host_patches)
    monkeypatch.setattr(build_mod, 'DEFAULT_CHUNK_BASES', BUDGET)
    if recording:
        monkeypatch.setenv('SEQWIN_TPU_TORCH_TIMELINE', '1')
    paths, targets = fastas
    build(paths, K, W, targets, n_cpu=2, device='cpu')
    assert len(calls) == 3 and all(q > 0 and r >= q for _, q, r in calls)
    spans = timeline.spans()
    if not recording:
        assert spans == []
        return
    by_id = {s.id: s for s in spans}
    patches = [s for s in spans if s.name == 'hybrid.patches']
    assert len(patches) == 3
    for s in patches:
        prep = by_id[s.parent]
        assert prep.name == 'hybrid.host_prep' and prep.thread == s.thread
        assert prep.start_ns <= s.start_ns <= s.end_ns <= prep.end_ns
        assert set(s.attrs) == {'records', 'windows', 'ranks'}
    assert sorted((s.attrs['records'], s.attrs['windows'], s.attrs['ranks'])
                  for s in patches) == sorted(calls)


def _genome(rng, root, snp):
    g = root.copy()
    idx = rng.integers(0, len(g), size=int(len(g) * snp))
    g[idx] = (g[idx] + rng.integers(1, 4, size=idx.size)) % 4
    return g


@pytest.fixture(scope='module')
def cli_lists(tmp_path_factory):
    """Three targets and three non-targets of 60 kbp in two records, one of
    45 kbp (above the 40 kbp budget the CLI test sets: the block path) and
    one of 15 kbp (a deferred chunk); the path lists."""
    tmp = tmp_path_factory.mktemp('timeline_cli')
    rng = np.random.default_rng(12)
    alpha = np.frombuffer(b'ACGTN', dtype=np.uint8)
    root = rng.integers(0, 4, size=60_000).astype(np.uint8)
    neg_root = _genome(rng, root, 0.08)
    lists = []
    for role, base, snp in (('tar', root, 0.005), ('neg', neg_root, 0.01)):
        paths = []
        for i in range(3):
            g = _genome(rng, base, snp)
            p = tmp / f'{role}{i}.fa'
            p.write_text(''.join(f'>{role}{i}_{j}\n' + alpha[r].tobytes().decode() + '\n'
                                 for j, r in enumerate((g[:45_000], g[45_000:]))))
            paths.append(str(p))
        lists.append(tmp / f'{role}.txt')
        lists[-1].write_text('\n'.join(paths) + '\n')
    return lists


def _cpu_cli(monkeypatch):
    import dataclasses

    from seqwin_tpu_torch import cli

    orig = cli.config_from_args
    monkeypatch.setattr(cli, 'config_from_args',
                        lambda args: dataclasses.replace(orig(args), device='cpu'))
    return cli


def test_cli_run_records_every_span(cli_lists, clean_timelines, monkeypatch, tmp_path,
                                    slow_prep):
    cli = _cpu_cli(monkeypatch)
    monkeypatch.setattr(build_mod, 'DEFAULT_CHUNK_BASES', BUDGET)
    monkeypatch.setenv('SEQWIN_TPU_TORCH_TIMELINE', '1')
    tar, neg = cli_lists
    assert cli.main(['--tar-paths', str(tar), '--neg-paths', str(neg), '--prefix', str(tmp_path),
                     '--title', 'spans', '-k', '21', '-w', '50', '--no-blast',
                     '--sketch-mode', 'device', '-p', '2']) == 0
    assert (tmp_path / 'spans' / 'signatures.fasta').stat().st_size > 0
    spans = timeline.spans()
    by_id = {s.id: s for s in spans}
    (run,) = [s for s in spans if s.name == 'run']
    assert run.parent is None and run.attrs == {'title': 'spans'}
    assert set(SPAN_TABLE) <= {s.name for s in spans}
    assert all(s.run == run.id for s in spans)
    phases = [s for s in spans if s.name.startswith('phase.')]
    assert len(phases) == 4 and all(s.parent == run.id for s in phases)
    # the markers phase's children, and no process pool under the phase
    markers = next(s for s in phases if s.name == 'phase.markers')
    for name in ('markers.candidates', 'markers.fetch_seq'):
        assert by_id[next(s for s in spans if s.name == name).parent] is markers

    def under_markers(s):
        while s.parent is not None:
            s = by_id[s.parent]
            if s is markers:
                return True
        return False

    assert not [s.name for s in spans if s.name.startswith('pool.') and under_markers(s)]
    fetch = next(s for s in spans if s.name == 'markers.fetch_seq')
    assert fetch.attrs['assemblies'] >= 1 and fetch.attrs['bytes'] > 0
    assert fetch.attrs['threads'] == min(2, fetch.attrs['assemblies'])
    # the subgraphs' nodes, out of the kept graph's; their rows, and one
    # largest run an assembly a subgraph at most
    cands = next(s for s in spans if s.name == 'markers.candidates')
    args = next(s for s in spans if s.name == 'markers.candidate_args')
    assert by_id[args.parent] is cands
    assert 2 * cands.attrs['subgraphs'] <= args.attrs['nodes'] <= args.attrs['graph_nodes']
    assert args.attrs['nodes'] <= cands.attrs['rows']
    assert cands.attrs['subgraphs'] <= cands.attrs['locs'] <= 6 * cands.attrs['subgraphs']
    assert cands.attrs['locs'] <= cands.attrs['rows']
    blocks = [s for s in spans if s.name == 'build.blocks']
    assert len(blocks) == 6 and all(s.attrs['blocks'] >= 2 for s in blocks)
    assert all(by_id[s.parent].name == 'build.blocks'
               for s in spans if s.name == 'block.sync')
    assert next(s for s in spans if s.name == 'run.save_results').attrs['bytes'] > 0


def _burn(n):
    return sum(i * i for i in range(n))


def test_pool_map_spans(clean_timelines, monkeypatch):
    """`utils.pool_map` with two processes: its three spans children of the
    caller's span, in order, and the workers' CPU seconds on `pool.stop`;
    the results in job order."""
    from seqwin_tpu_torch.utils import pool_map

    monkeypatch.setenv('SEQWIN_TPU_TORCH_TIMELINE', '1')
    with timeline.span('caller') as caller:
        out = pool_map(_burn, [(200_000 + i,) for i in range(8)], processes=2, total=8)
    assert out == [_burn(200_000 + i) for i in range(8)]
    spans = timeline.spans()
    pools = [s for s in spans if s.name.startswith('pool.')]
    assert [s.name for s in pools] == ['pool.start', 'pool.map', 'pool.stop']
    assert all(s.parent == caller.id for s in pools)
    assert pools[0].attrs == {'processes': 2}
    assert pools[1].attrs == {'processes': 2, 'jobs': 8, 'chunksize': 1}
    assert pools[2].attrs['child_cpu_s'] > 0


@pytest.mark.parametrize('recording', [True, False])
def test_sketch_spans(cli_lists, clean_timelines, monkeypatch, tmp_path, recording):
    """A ``--sketch-mode device`` run: one ``sketch.join`` and one
    ``sketch.fetch`` an assembly inside ``threshold.sketches``, then
    ``threshold.jaccard``, with their attributes; nothing when off."""
    cli = _cpu_cli(monkeypatch)
    if recording:
        monkeypatch.setenv('SEQWIN_TPU_TORCH_TIMELINE', '1')
    tar, neg = cli_lists
    assert cli.main(['--tar-paths', str(tar), '--neg-paths', str(neg), '--prefix', str(tmp_path),
                     '--title', 'sketch', '-k', '21', '-w', '50', '--no-blast',
                     '--sketch-mode', 'device', '-p', '2']) == 0
    spans = timeline.spans()
    if not recording:
        assert spans == [] and timeline.drain() == []
        return
    by_id = {s.id: s for s in spans}
    (sketches,) = [s for s in spans if s.name == 'threshold.sketches']
    (jaccard,) = [s for s in spans if s.name == 'threshold.jaccard']
    assert by_id[sketches.parent].name == by_id[jaccard.parent].name == 'phase.threshold'
    assert sketches.end_ns <= jaccard.start_ns
    joins = [s for s in spans if s.name == 'sketch.join']
    fetches = [s for s in spans if s.name == 'sketch.fetch']
    assert len(joins) == len(fetches) == sketches.attrs['assemblies'] == 6
    assert all(s.parent == sketches.id for s in joins + fetches)
    # six assemblies of two records (45 and 15 kbp), one separator between
    assert [s.attrs for s in joins] == [{'records': 2, 'bytes': 60_001}] * 6
    assert sketches.attrs == {'assemblies': 6, 'bases': 6 * 60_001, 'h2d_bytes': 6 * 60_001}
    assert fetches[0].attrs == {}
    assert jaccard.attrs == {'pairs': 21, 'blocks': 1}


def test_spans_share_the_profilers_clock(tmp_path, clean_timelines, monkeypatch):
    """Every span of the main thread contains its profiler event to within
    100 us at each end: a build of one record in blocks, where no other
    thread runs Python beside the main one once the file is parsed (a
    thread that does can take the interpreter between the two stamps)."""
    import threading

    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(5)
    fa = tmp_path / 'long.fa'
    fa.write_text('>long\n' + np.frombuffer(b'ACGT', np.uint8)[
        rng.integers(0, 4, size=3 * BUDGET)].tobytes().decode() + '\n')
    monkeypatch.setattr(build_mod, 'DEFAULT_CHUNK_BASES', BUDGET)
    monkeypatch.setenv('SEQWIN_TPU_TORCH_TIMELINE', '1')
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timeline.span('warm-up'):  # the profiler's first event of a thread is slow
            pass
        timeline.drain_spans()
        build([fa], K, W, [True], device='cpu')
    events = _annotations(prof)
    main = [s for s in timeline.spans() if s.thread == threading.get_native_id()]
    assert {'build', 'build.blocks', 'block.sync', 'hybrid.host_prep',
            'build.aggregate'} <= {s.name for s in main}
    for s in main:
        _, a, b = min((e for e in events if e[0] == s.name), key=lambda e: abs(e[1] - s.start_ns))
        assert 0 <= a - s.start_ns <= 100_000 and 0 <= s.end_ns - b <= 100_000, s


def test_drain_returns_marks_only(fastas, clean_timelines, monkeypatch):
    paths, targets = fastas
    monkeypatch.setenv('SEQWIN_TPU_TORCH_TIMELINE', '1')
    build(paths, K, W, targets, device='cpu')
    marks = timeline.drain()
    assert marks and all(len(m) == 3 and m[1] in MARKS for m in marks)
    assert timeline.drain() == []
    spans = timeline.spans()
    assert spans and timeline.spans() == spans  # a copy, nothing cleared
    assert timeline.drain_spans() == spans and timeline.spans() == []
    timeline.mark('x')
    with timeline.span('y'):
        pass
    timeline.reset()
    assert timeline.drain() == [] and timeline.spans() == []


def test_profile_dir_trace_holds_pool_thread_spans(cli_lists, clean_timelines, tmp_path):
    """`Config.profile_dir` switches the recorder on for the run and adds the
    prep pool's spans, which the profiler does not see, to `trace.json`."""
    import json
    import os

    from seqwin_tpu_torch import Config, run

    tar, neg = cli_lists
    prof = tmp_path / 'prof'
    run(Config(tar_paths=tar, neg_paths=neg, prefix=tmp_path, title='p', run_mash=False,
               run_blast=False, n_cpu=2, windowsize=50, device='cpu', profile_dir=prof))
    assert not timeline.enabled()  # off again after the run
    doc = json.loads((prof / 'trace.json').read_text())
    pid = os.getpid()
    preps = [e for e in doc['traceEvents'] if e.get('name') == 'hybrid.host_prep']
    assert preps and all(e['pid'] == pid and e['tid'] != pid and e['dur'] > 0 for e in preps)
    names = {e['args']['name'] for e in doc['traceEvents']
             if e.get('ph') == 'M' and e.get('name') == 'thread_name' and e.get('pid') == pid}
    assert any(n.endswith('(seqwin spans)') for n in names)
    # the main thread's spans are the profiler's own events, on the same time base
    agg = [e for e in doc['traceEvents'] if e.get('name') == 'build.aggregate']
    assert len(agg) == 1 and agg[0]['tid'] == pid
    assert min(e['ts'] for e in preps) < agg[0]['ts']
    log = (tmp_path / 'p' / 'seqwin.log').read_text()
    assert ' - Device busy 0.000 ms' in log
