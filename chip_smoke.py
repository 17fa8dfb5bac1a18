#!/usr/bin/env python3
"""Smoke test of seqwin_tpu_torch on one CUDA GPU.

Run from the repository root on a machine with an H100 and nvcc:

    python3 chip_smoke.py [--seed 0] [--profile]

Phases, each fatal on failure (non-zero exit, no ``ok`` line):

1. Environment and build: the card's name and power limit, then the
   package's CUDA kernel built with nvcc from ``seqwin_tpu_torch/csrc``.
2. Each kernel against its plain torch version on the card, on seeded
   streams with N runs, short and empty records and small-k tie cases over a
   (k, w) grid, plus one 2^25-position chunk at k=21, w=200. Exact equality
   is required; both versions are timed with CUDA events.
3. The GPU build against the package's CPU build on a reduced synthetic
   dataset (8 assemblies x ~1 Mbp): all five outputs byte-equal.
4. The main path at a real size: 64 genomes x 3 Mbp (192 Mbp), k=21,
   w=200, through `build_deferred`, the host penalty threshold the pipeline
   uses without mash, `filter_edges` and `compact_kmers`; output invariants
   and per-kernel launch counts are checked against the chunks the build
   scanned. ``--profile`` traces one more run with torch.profiler and prints
   the device-time table and the package's host spans.

It prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. It imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
K, W = 21, 200
GRID = [(1, 4), (4, 3), (7, 10), (21, 200), (31, 16), (2, 9), (3, 17)]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
NON_TENSOR_OPS_PER_S = 67e12   # H100 SXM peak outside the tensor cores


def log(*a):
    print(*a, flush=True)


def smi() -> str:
    res = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout.strip() else 'nvidia-smi unavailable'


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def aug_stream(records: list[np.ndarray]) -> np.ndarray:
    """Concatenated records with bit 6 at each record start."""
    codes = np.concatenate(records) if records else np.zeros(0, np.uint8)
    starts = np.cumsum([0] + [len(r) for r in records[:-1]])
    codes[starts[starts < len(codes)]] |= 64
    return codes


def mixed_records(rng, scale: int = 1) -> list[np.ndarray]:
    """Records with N runs, scattered Ns, short, empty and heavy-N records."""
    recs = []
    for n_rec, frac in [(900, 0.0), (2500, 0.02), (0, 0.0), (40, 0.0), (1300, 0.1),
                        (3, 0.0), (5000, 0.0), (2000, 0.4)]:
        n_rec *= scale
        c = rng.integers(0, 4, size=n_rec).astype(np.uint8)
        c[rng.random(n_rec) < frac] = 255
        if n_rec > 1000:
            s = int(rng.integers(0, n_rec - 100))
            c[s:s + int(rng.integers(1, 100))] = 255
        recs.append(c)
    return recs


def phase_build():
    from seqwin_tpu_torch.engine import _kernels, phase1

    t0 = time.perf_counter()
    phase1._lib()
    log(f'[build] phase1_z built and loaded in {time.perf_counter() - t0:.2f} s')
    txt = _kernels.BUILD_DIR / 'phase1_z.ptxas.txt'
    if txt.exists():
        log('[build] ptxas phase1_z: ' + ' | '.join(
            ln.strip() for ln in txt.read_text().splitlines() if 'Used' in ln or 'spill' in ln))


def phase_kernels(seed: int) -> dict:
    import torch

    from seqwin_tpu_torch.engine.phase1 import phase1_z, phase1_z_plain

    dev = torch.device('cuda')
    worst = 0
    for k, w in GRID:
        rng = np.random.default_rng(seed + 7 * k + w)
        codes = torch.from_numpy(aug_stream(mixed_records(rng, scale=4))).to(dev)
        zk = phase1_z(codes, k, w)
        zp = phase1_z_plain(codes, k, w)
        torch.cuda.synchronize()
        bad = int((zk != zp).sum())
        worst = max(worst, int((zk.long() - zp.long()).abs().max()))
        log(f'[kernel] phase1_z k={k} w={w} n={codes.numel()} mismatches={bad} '
            f'emitting={int((zp >= 0).sum())}')
        if bad:
            raise AssertionError(f'phase1_z k={k} w={w}: {bad} mismatches')

    # one main-path chunk: 2^25 positions, 3 Mbp-scale records with N runs
    rng = np.random.default_rng(seed)
    n = 1 << 25
    lens = np.full(n // 3_000_000, 3_000_000)
    recs = [rng.integers(0, 4, size=int(L)).astype(np.uint8) for L in lens]
    recs.append(rng.integers(0, 4, size=n - int(lens.sum())).astype(np.uint8))
    for r in recs:
        for s in rng.integers(0, len(r) - 200, size=4):
            r[s:s + int(rng.integers(1, 200))] = 255
    codes = torch.from_numpy(aug_stream(recs)).to(dev)
    zk = phase1_z(codes, K, W)
    zp = phase1_z_plain(codes, K, W)
    torch.cuda.synchronize()
    bad = int((zk != zp).sum())
    worst = max(worst, int((zk.long() - zp.long()).abs().max()))
    if bad:
        raise AssertionError(f'phase1_z 2^25 chunk: {bad} mismatches')
    ms = cuda_ms(lambda: phase1_z(codes, K, W), iters=20)
    plain_ms = cuda_ms(lambda: phase1_z_plain(codes, K, W), iters=3, warmup=1)
    # least work: read 1 B and write 4 B per position; ~20 integer ops per
    # position for a rolling hash and an amortised O(1) sliding minimum
    bytes_s = 5 * n / HBM_BYTES_PER_S
    ops_s = 20 * n / NON_TENSOR_OPS_PER_S
    bound_ms = max(bytes_s, ops_s) * 1e3
    log(f'[kernel] phase1_z n=2^25 k={K} w={W}: mismatches=0 kernel {ms:.3f} ms, '
        f'plain {plain_ms:.3f} ms, bound {bound_ms * 1e3:.1f} us '
        f'({"bytes" if bytes_s >= ops_s else "operations"})')
    return dict(name='phase1_z', route='cuda',
                source='seqwin_tpu_torch/csrc/phase1_z.cu',
                replaces='seqwin_tpu/engine/pallas_scan.py:202',
                launches=None, mismatches=0, max_abs_err=float(worst),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_us=bound_ms * 1e3,
                bound_by='bytes' if bytes_s >= ops_s else 'operations',
                library_ms=None, n=n)


def write_fasta(path: Path, records: list[tuple[str, np.ndarray]]):
    """80-column FASTA; code 4 is written as N."""
    alphabet = np.frombuffer(b'ACGTN', dtype=np.uint8)
    with open(path, 'wb') as f:
        for rid, g in records:
            f.write(f'>{rid}\n'.encode())
            seq = alphabet[np.minimum(g, 4)]
            full = len(seq) // 80
            body = np.full((full, 81), ord('\n'), np.uint8)
            body[:, :80] = seq[:full * 80].reshape(full, 80)
            f.write(body.tobytes())
            if len(seq) > full * 80:
                f.write(seq[full * 80:].tobytes() + b'\n')


def synth(tmp: Path, n_genomes: int, genome_len: int, rng, n_records: int = 1,
          n_runs: int = 0, empty_record: bool = False):
    """Shared base genome, ~0.5% SNPs per genome, the first half targets."""
    base = rng.integers(0, 4, size=genome_len).astype(np.uint8)
    paths, targets = [], []
    for i in range(n_genomes):
        g = base.copy()
        idx = rng.integers(0, genome_len, size=genome_len // 200)
        g[idx] = (g[idx] + rng.integers(1, 4, size=idx.size)) % 4
        for s in rng.integers(0, genome_len - 500, size=n_runs):
            g[s:s + int(rng.integers(1, 500))] = 4
        cuts = np.sort(rng.integers(0, genome_len, size=n_records - 1))
        recs = [(f'g{i}_r{j}', part) for j, part in enumerate(np.split(g, cuts))]
        if empty_record and i == 1:
            recs.insert(1, (f'g{i}_empty', np.zeros(0, np.uint8)))
        p = tmp / f'g{i}.fasta'
        write_fasta(p, recs)
        paths.append(p)
        targets.append(i < n_genomes // 2)
    return paths, targets


def phase_cpu_vs_gpu(seed: int):
    from seqwin_tpu_torch.graph import build

    rng = np.random.default_rng(seed + 1)
    with tempfile.TemporaryDirectory() as td:
        paths, targets = synth(Path(td), 8, 1_000_000, rng, n_records=3, n_runs=3,
                               empty_record=True)
        t0 = time.perf_counter()
        gpu = build(paths, K, W, targets, n_cpu=8, device='cuda')
        t_gpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = build(paths, K, W, targets, n_cpu=8, device='cpu')
        t_cpu = time.perf_counter() - t0
    for name, a, b in zip(('kmers', 'nodes', 'edges', 'record_offsets'), gpu[:4], cpu[:4]):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f'GPU build {name} differs from the CPU build')
    if gpu[4] != cpu[4]:
        raise AssertionError('GPU build record_ids differ from the CPU build')
    log(f'[cpu-vs-gpu] 8 x 1 Mbp: byte-equal kmers={len(gpu[0])} nodes={len(gpu[1])} '
        f'edges={len(gpu[2])} (gpu {t_gpu:.2f} s, cpu {t_cpu:.2f} s)')


def main_path(paths, targets):
    """build_deferred + the pipeline's device consumption without mash:
    host float64 threshold, edge filter, kept-k-mer compaction."""
    import torch

    from seqwin_tpu_torch.graph import build_deferred, kept_node_layout

    t0 = time.perf_counter()
    graph, offsets, record_ids = build_deferred(paths, K, W, targets, n_cpu=8)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    nodes = graph.nodes
    n_tar = sum(targets)
    n_neg = len(targets) - n_tar
    frac_tar = nodes['n_tar'] / n_tar
    frac_neg = nodes['n_neg'] / n_neg
    nodes['penalty'] = ((1 - frac_tar) ** 2 + frac_neg ** 2) ** 0.5
    # no-mash threshold estimate (stringency 5, cap 0.2, edge multiplier 0.3)
    s_tar = np.sum(nodes['n_tar'])
    e_absence_tar = 1 - np.sum(frac_tar * nodes['n_tar']) / s_tar
    e_presence_neg = np.sum(frac_neg * nodes['n_tar']) / s_tar
    penalty_th = min(0.5 * (e_absence_tar * e_presence_neg) ** 0.5, 0.2)
    edge_weight_th = 0.3 * (1 - penalty_th) * n_tar
    edges = graph.filter_edges(edge_weight_th)
    # compact the k-mers of the nodes that survive the edge filter
    # (pipeline/kmers.py:203), the superset of what subgraph search keeps
    keep_hashes = np.unique(np.concatenate([edges['first'], edges['second']]))
    keep, out_nodes, total = kept_node_layout(nodes, keep_hashes)
    kmers = graph.compact_kmers(keep, total)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return dict(graph=graph, nodes=nodes, edges=edges, kmers=kmers, total=total,
                secs=secs, build_s=t_build, penalty_th=float(penalty_th),
                edge_weight_th=float(edge_weight_th))


def phase_main(seed: int, profile: bool, card: str) -> dict:
    import torch

    from seqwin_tpu_torch.engine.phase1 import phase1_z

    n_genomes, genome_len = 64, 3_000_000
    rng = np.random.default_rng(seed + 2)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        paths, targets = synth(Path(td), n_genomes, genome_len, rng)
        log(f'[main] datagen {time.perf_counter() - t0:.1f} s ({n_genomes} x {genome_len} bp)')
        launches = {'phase1_z': 0}
        phase1_z.launches = 0
        run = main_path(paths, targets)
        launches['phase1_z'] = phase1_z.launches
        second = main_path(paths, targets)
        if profile:
            from torch.profiler import ProfilerActivity, profile as tprof

            with tprof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                main_path(paths, targets)
            avg = prof.key_averages()
            log(avg.table(sort_by='cuda_time_total', row_limit=15))
            # a span with device work inside also has a device-side entry
            # of the same name and no CPU time: keep the CPU one
            spans = {name: max((dict(calls=e.count, cpu_ms=e.cpu_time_total / 1e3)
                                for e in avg if e.key == name),
                               key=lambda d: d['cpu_ms'], default=None)
                     for name in ('hybrid.host_prep', 'build.aggregate')}
            log('[profile] host spans ' + json.dumps(spans))

    nodes, edges, kmers, graph = run['nodes'], run['edges'], run['kmers'], run['graph']
    h = nodes['hash']
    if not np.all(h[1:] > h[:-1]):
        raise AssertionError('nodes not strictly sorted by unsigned hash')
    if int(np.sum(nodes['stop'] - nodes['start'])) != graph.n_kmers:
        raise AssertionError('node ranges do not cover the k-mer stream')
    full_edges = graph.materialize_edges()
    ef, es = full_edges['first'], full_edges['second']
    if not np.all(ef <= es):
        raise AssertionError('edge with first > second')
    if not np.all((ef[1:] > ef[:-1]) | ((ef[1:] == ef[:-1]) & (es[1:] > es[:-1]))):
        raise AssertionError('edges not strictly sorted by (first, second)')
    if len(kmers) != run['total']:
        raise AssertionError('kept k-mer count differs from the node layout total')
    if not (len(edges) and len(kmers)):
        raise AssertionError('empty filtered graph')
    chunks = graph.n_chunks
    if launches['phase1_z'] != chunks:
        raise AssertionError(f"phase1_z launched {launches['phase1_z']} times for {chunks} chunks")
    res = dict(secs=run['secs'], secs_second=second['secs'], build_s=run['build_s'],
               build_s_second=second['build_s'], bases=n_genomes * genome_len,
               minimizers=graph.n_kmers, nodes=graph.n_nodes, edges=graph.n_edges,
               kept_edges=len(edges), kept_kmers=len(kmers),
               launches=launches, penalty_th=run['penalty_th'],
               edge_weight_th=run['edge_weight_th'], chunks=chunks)
    res['minimizers_per_s'] = graph.n_kmers / second['secs']
    log(f"[main] 192 Mbp k={K} w={W}: {run['secs']:.2f} s first run, "
        f"{second['secs']:.2f} s second (build_deferred {second['build_s']:.2f} s); "
        f"{res['minimizers_per_s']:.4g} minimizers/s; minimizers={graph.n_kmers} "
        f"nodes={graph.n_nodes} edges={graph.n_edges} kept_edges={len(edges)} "
        f"kept_kmers={len(kmers)} chunks={chunks} launches={launches}; "
        f"on {card}")
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--profile', action='store_true',
                    help='trace one more main-path run with torch.profiler')
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    try:
        import seqwin_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: seqwin_tpu_torch not importable from {REPO}: {e}', file=sys.stderr)
        return 1

    name = torch.cuda.get_device_name(0)
    card = smi()
    log(f'[env] {name}; torch {torch.__version__} cuda {torch.version.cuda}; {card}')
    phase_build()
    kernel = phase_kernels(args.seed)
    phase_cpu_vs_gpu(args.seed)
    main_res = phase_main(args.seed, args.profile, card)
    kernel['launches'] = main_res['launches'][kernel['name']]
    log(json.dumps({'kernels': [kernel]}))
    log(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
