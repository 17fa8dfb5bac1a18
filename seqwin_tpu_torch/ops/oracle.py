"""Slow, obviously-correct NumPy oracle for the minimizer pipeline.

Counterpart: `seqwin_tpu/ops/oracle.py` (copied; the port never imports the
JAX package).

This module re-derives the behavioral contract of the reference's native core
(the reference's `cpp/vendor/btllib/minimizer.cpp:14-90`,
the reference's `cpp/src/seqwin/graph.cpp:59-339`) in plain Python/NumPy. It is
the differential-test baseline for the device engines and the
``backend='oracle'`` build. It is intentionally simple, not fast.

Distilled minimizer semantics (proved equivalent to the btllib ring-buffer
algorithm; see `engine/minimizer.py` for the parallel formulation):

1. Valid k-mer positions of a record are those whose k-base window contains no
   invalid base (`nthash_kmer.hpp:491-511` N-skip == compaction over valid
   windows).
2. Records shorter than ``k + w - 1`` bases emit nothing
   (`minimizer.cpp:56-58`).
3. For each window of ``w`` consecutive *valid* k-mers, the candidate is the
   rightmost k-mer attaining the window-minimum canonical hash
   (rescan uses ``<=`` -> rightmost tie wins, incremental newest-entry update
   uses ``<=`` -> same; `minimizer.cpp:32-42`).
4. A candidate is emitted iff its position exceeds every previously emitted
   position and its hash != 2^64-1 (`minimizer.cpp:44-48`). Equivalently: the
   candidate k-mer index strictly exceeds the running max of all previous
   window candidates.
"""
from __future__ import annotations

import numpy as np

from .hashing import CODE_TAB, M64, SEEDS, SEEDS_COMP, out_hash_mult, srol1


def encode(seq: str | bytes) -> np.ndarray:
    """ASCII sequence -> base codes (0..3, 255 invalid)."""
    if isinstance(seq, str):
        seq = seq.encode('latin1')
    return CODE_TAB[np.frombuffer(seq, dtype=np.uint8)]


def kmer_hashes(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-position (canonical, out, valid) for all k-mer starts, via the
    sequential rolling recurrence (`nthash_kmer.hpp:22-133`)."""
    n = len(codes)
    n_kmers = max(0, n - k + 1)
    canon = np.zeros(n_kmers, dtype=np.uint64)
    out = np.zeros(n_kmers, dtype=np.uint64)
    valid = np.zeros(n_kmers, dtype=bool)
    if n_kmers == 0:
        return canon, out, valid
    bad = np.concatenate(([0], np.cumsum(codes > 3)))
    mult = out_hash_mult(k)
    for p in range(n_kmers):
        if bad[p + k] - bad[p] != 0:
            continue
        f = 0
        r = 0
        for j in range(k):
            f = srol1(f) ^ SEEDS[codes[p + j]]
            r = srol1(r) ^ SEEDS_COMP[codes[p + k - 1 - j]]
        c = (f + r) & M64
        t = (c * mult) & M64
        canon[p] = c
        out[p] = t ^ (t >> 27)
        valid[p] = True
    return canon, out, valid


def minimize(codes: np.ndarray, k: int, w: int) -> list[tuple[int, int, int]]:
    """Minimizers of one record: list of (min_hash, out_hash, pos)."""
    n = len(codes)
    if k > n or w > n - k + 1:
        return []
    canon, out, valid = kmer_hashes(codes, k)
    pos = np.flatnonzero(valid)
    mh = canon[pos]
    oh = out[pos]
    emitted: list[tuple[int, int, int]] = []
    last_pos = -1
    for i in range(w - 1, len(pos)):
        m = i - w + 1
        for j in range(i - w + 2, i + 1):
            if mh[j] <= mh[m]:
                m = j
        if int(pos[m]) > last_pos and int(mh[m]) != M64:
            last_pos = int(pos[m])
            emitted.append((int(mh[m]), int(oh[m]), int(pos[m])))
    return emitted


def build_graph(
    record_seqs: list[list[np.ndarray]],
    k: int,
    w: int,
    is_targets: list[bool],
):
    """Single-threaded reference graph build over encoded records.

    Args:
        record_seqs: per assembly, the list of encoded records (base codes).
        k, w: minimizer parameters.
        is_targets: parallel to record_seqs.

    Returns:
        (kmers, nodes, edges, record_offsets) numpy structured arrays matching
        the contract of the reference's `src/seqwin/graph/__init__.py:119-138`
        (penalty left 0).
    """
    from ..graph.dtypes import EDGE_DTYPE, KMER_DTYPE, NODE_DTYPE

    entries: list[tuple[int, int, int, int]] = []  # (out_hash, pos, rec, asm)
    edge_asms: dict[tuple[int, int], set[int]] = {}
    record_offsets = [0]
    rec = 0
    for ai, records in enumerate(record_seqs):
        for codes in records:
            mins = minimize(codes, k, w)
            for _, oh, pos in mins:
                entries.append((oh, pos, rec, ai))
            for t in range(len(mins) - 1):
                u, v = mins[t][1], mins[t + 1][1]
                if v < u:
                    u, v = v, u
                edge_asms.setdefault((u, v), set()).add(ai)
            rec += 1
        record_offsets.append(rec)

    order = sorted(range(len(entries)), key=lambda i: (entries[i][0], i))
    kmers = np.zeros(len(entries), dtype=KMER_DTYPE)
    node_rows = []
    i = 0
    while i < len(order):
        h = entries[order[i]][0]
        j = i
        seen_t: set[int] = set()
        seen_n: set[int] = set()
        while j < len(order) and entries[order[j]][0] == h:
            _, pos, r, a = entries[order[j]]
            kmers[j] = (pos, r)
            (seen_t if is_targets[a] else seen_n).add(a)
            j += 1
        node_rows.append((h, i, j, len(seen_t), len(seen_n), 0.0))
        i = j
    nodes = np.array(node_rows, dtype=NODE_DTYPE) if node_rows else np.zeros(0, dtype=NODE_DTYPE)
    edges = np.array(
        [(u, v, len(a)) for (u, v), a in sorted(edge_asms.items())], dtype=EDGE_DTYPE
    ) if edge_asms else np.zeros(0, dtype=EDGE_DTYPE)
    return kmers, nodes, edges, np.array(record_offsets, dtype=np.uintp)


def minimize_btllib_style(codes: np.ndarray, k: int, w: int) -> list[tuple[int, int, int]]:
    """Literal simulation of the btllib ring-buffer algorithm
    (`minimizer.cpp:14-90`), used to cross-check the distilled `minimize`."""
    n = len(codes)
    if k > n or w > n - k + 1:
        return []
    canon, out, valid = kmer_hashes(codes, k)
    stream = [(int(canon[p]), int(out[p]), int(p)) for p in np.flatnonzero(valid)]
    buf: list[tuple[int, int, int] | None] = [None] * (w + 1)
    minimizers: list[tuple[int, int, int]] = []
    min_cur: int | None = None  # buffer slot of current min
    min_pos_prev = -1
    for idx, entry in enumerate(stream):
        buf[idx % (w + 1)] = entry
        if idx + 1 < w:
            continue
        left = idx + 1 - w
        left_entry = buf[left % (w + 1)]
        cur_entry = None if min_cur is None else buf[min_cur % (w + 1)]
        if (
            min_cur is None
            or cur_entry is None
            or cur_entry[2] < left_entry[2]  # slid out of window
            or min_cur < left
        ):
            min_cur = left
            for i in range(left, idx + 1):
                if buf[i % (w + 1)][0] <= buf[min_cur % (w + 1)][0]:
                    min_cur = i
        elif buf[idx % (w + 1)][0] <= buf[min_cur % (w + 1)][0]:
            min_cur = idx
        cur = buf[min_cur % (w + 1)]
        if cur[2] > min_pos_prev and cur[0] != M64:
            min_pos_prev = cur[2]
            minimizers.append(cur)
    return minimizers
