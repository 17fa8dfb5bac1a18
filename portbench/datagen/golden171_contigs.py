"""The golden171 proxy as draft assemblies: each genome cut into contigs.

Upstream Seqwin fetches its genomes from NCBI at ``--level contig`` by
default, and a Salmonella draft comes as tens to hundreds of contigs. This
generator makes the genome bases of `golden171_proxy` (with
``records_per_genome`` 2) for the same seed and parameters: the same
`SeedSequence` children, ancestor, non-target root, substitutions and N run
(which may fall in any contig). It then cuts each genome into contigs from
a child stream of the genome's own sequence:

- the number of contigs is uniform in ``contigs_per_genome`` (inclusive);
- lengths are log-normal (sigma `SIGMA`), scaled to the genome and clipped
  to ``contig_len`` (inclusive): one scale, found by bisection, makes the
  clipped lengths sum to the genome; the rounding's remainder goes, one
  base each, to the contigs with the largest fractions below the upper
  bound, so the lengths sum to ``genome_len`` exactly.

Contigs carry no repeats and no scaffold gaps. Records are written as
``proxy_<genome>_<contig>`` in 80-column FASTA. The same seed gives the
same bytes, whatever the number of threads.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from .golden171_proxy import _mutate, write_fasta

SIGMA = 1.6


def _contig_lengths(rng: np.random.Generator, genome_len: int, contigs_per_genome: list[int],
                   contig_len: list[int]) -> np.ndarray:
    """int64 lengths of one genome's contigs, in order (the module
    docstring's law)."""
    lo, hi = contig_len
    n = int(rng.integers(contigs_per_genome[0], contigs_per_genome[1] + 1))
    if not n * lo <= genome_len <= n * hi:
        raise ValueError(f'{n} contigs of {lo} to {hi} bases cannot make {genome_len}')
    x = rng.lognormal(0.0, SIGMA, size=n)
    x /= x.sum()
    # sum(clip(s * x, lo, hi)) grows with s from n * lo (s = 0) to n * hi
    # (s = b): bisect for the genome's length
    a, b = 0.0, hi / x.min()
    for _ in range(200):
        s = 0.5 * (a + b)
        if np.clip(s * x, lo, hi).sum() < genome_len:
            a = s
        else:
            b = s
    lens = np.clip(b * x, lo, hi)
    out = np.floor(lens).astype(np.int64)
    rem = genome_len - int(out.sum())
    room = np.flatnonzero(out < hi)
    if not 0 <= rem <= len(room):
        raise ValueError('contig lengths do not round to the genome length')
    frac = lens[room] - out[room]
    out[room[np.argsort(-frac, kind='stable')[:rem]]] += 1
    return out


def generate(out_dir: Path, seed: int, n_tar: int, n_neg: int, genome_len: int,
             tar_snp_rate: float, neg_snp_rate: float, neg_root_divergence: float,
             n_run: list[int], contigs_per_genome: list[int], contig_len: list[int],
             content_seed: int | None = None, threads: int = 8) -> dict:
    """Write the assemblies into ``out_dir``.

    Returns ``paths`` (targets first), ``is_target`` and ``record_lengths``
    (bases of every record, in scan order)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    # `golden171_proxy.generate`'s streams, draw for draw
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
        # the layout's own stream: a child of the genome's sequence
        (layout,) = per_genome[i].spawn(1)
        lens = _contig_lengths(np.random.default_rng(layout), genome_len, contigs_per_genome,
                              contig_len)
        parts = np.split(g, np.cumsum(lens)[:-1])
        at = int(slot[i])
        paths[at] = out_dir / f'{"tar" if tar else "neg"}_{at:03d}.fasta'
        write_fasta(paths[at], [(f'proxy_{i}_{j}', r) for j, r in enumerate(parts)])
        record_lengths[at] = lens.tolist()

    with ThreadPoolExecutor(max_workers=min(threads, os.cpu_count() or 1)) as ex:
        list(ex.map(one, range(n_tar + n_neg)))
    return dict(paths=paths, is_target=[i < n_tar for i in range(len(slot))],
                record_lengths=[n for lens in record_lengths for n in lens])
