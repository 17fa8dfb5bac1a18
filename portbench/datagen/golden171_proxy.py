"""The golden171 proxy: synthetic Salmonella-like assemblies made from a seed.

Upstream Seqwin's integration test runs 171 Salmonella assemblies (72
targets, 99 non-targets). They cannot be fetched here, so this generator
re-makes a data set of the same count and length: targets derive from one
random ancestor with ``tar_snp_rate`` substitutions each, non-targets from a
root that differs from the ancestor at ``neg_root_divergence`` of its
positions, with ``neg_snp_rate`` substitutions each. Every genome gets one run
of N (``n_run`` bases long, bounds inclusive-exclusive) and is written as
``records_per_genome`` records (2: cut at a random point in its middle half;
1: the complete genome), as an 80-column FASTA.

The same seed gives the same bytes. Seeds may be any non-negative integer
(numpy's `SeedSequence` takes arbitrarily large ones). The ancestor and the
non-target root come from the seed's first child sequence, and each genome
from a child of its own, so the genomes are made and written in parallel
threads and the bytes do not depend on how many. With ``content_seed`` set,
the genomes are those of ``content_seed`` and the run's seed only orders
them (targets among targets, non-targets among non-targets): every seed then
gives the same set of genomes and sizes, in another order.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

_TO_TEXT = bytes.maketrans(bytes(range(5)), b'ACGTN')  # codes 0..4; newlines stay


def write_fasta(path: Path, records: list[tuple[str, np.ndarray]]) -> None:
    """80-column FASTA of base codes 0..3 and 4 (written as N)."""
    with open(path, 'wb') as f:
        for rid, g in records:
            f.write(f'>{rid}\n'.encode())
            full = len(g) // 80
            body = np.full((full, 81), ord('\n'), np.uint8)
            body[:, :80] = g[:full * 80].reshape(full, 80)
            f.write(body.tobytes().translate(_TO_TEXT))
            if len(g) > full * 80:
                f.write(g[full * 80:].tobytes().translate(_TO_TEXT) + b'\n')


def _mutate(g: np.ndarray, rng: np.random.Generator, rate: float) -> None:
    idx = rng.integers(0, len(g), size=int(len(g) * rate))
    g[idx] = (g[idx] + rng.integers(1, 4, size=idx.size)) % 4


def generate(out_dir: Path, seed: int, n_tar: int, n_neg: int, genome_len: int,
             records_per_genome: int, tar_snp_rate: float, neg_snp_rate: float,
             neg_root_divergence: float, n_run: list[int], content_seed: int | None = None,
             threads: int = 8) -> dict:
    """Write the assemblies into ``out_dir``.

    Returns ``paths`` (targets first), ``is_target`` and ``record_lengths``
    (bases of every record, in scan order)."""
    if records_per_genome not in (1, 2):
        raise ValueError('records_per_genome must be 1 or 2')
    out_dir.mkdir(parents=True, exist_ok=True)
    if content_seed is None:
        root, slot = np.random.SeedSequence(seed), np.arange(n_tar + n_neg)
    else:
        order = np.random.default_rng(seed)
        root = np.random.SeedSequence(content_seed)
        slot = np.concatenate([order.permutation(n_tar), n_tar + order.permutation(n_neg)])
    shared, *per_genome = root.spawn(1 + n_tar + n_neg)
    rng = np.random.default_rng(shared)
    ancestor = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    neg_root = ancestor.copy()
    _mutate(neg_root, rng, neg_root_divergence)
    paths, record_lengths = [None] * len(slot), [None] * len(slot)

    def one(i: int) -> None:
        rng = np.random.default_rng(per_genome[i])
        tar = i < n_tar
        g = (ancestor if tar else neg_root).copy()
        _mutate(g, rng, tar_snp_rate if tar else neg_snp_rate)
        n0 = int(rng.integers(0, genome_len - 500))
        g[n0:n0 + int(rng.integers(n_run[0], n_run[1]))] = 4
        cut = int(rng.integers(genome_len // 4, 3 * genome_len // 4))
        parts = [g[:cut], g[cut:]] if records_per_genome == 2 else [g]
        at = int(slot[i])
        paths[at] = out_dir / f'{"tar" if tar else "neg"}_{at:03d}.fasta'
        write_fasta(paths[at], [(f'proxy_{i}_{j}', r) for j, r in enumerate(parts)])
        record_lengths[at] = [len(r) for r in parts]

    with ThreadPoolExecutor(max_workers=min(threads, os.cpu_count() or 1)) as ex:
        list(ex.map(one, range(n_tar + n_neg)))
    return dict(paths=paths, is_target=[i < n_tar for i in range(len(slot))],
                record_lengths=[n for lens in record_lengths for n in lens])
