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
    monkeypatch.setenv('SEQWIN_TPU_TORCH_CHUNK_BASES', str(BUDGET))
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
