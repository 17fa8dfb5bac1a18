"""The decomposition of the phase-1 CUDA kernel (`csrc/phase1.cu`), modelled
on the CPU: the rolling ntHash with zero seeds for codes > 3 or, as the
kernel takes them, the seeds of their low two bits, and the kernel's
tiling (tile T, per-thread runs of R positions, segments of w from the
tile's halo start) with its segmented prefix/suffix rightmost argmin, its
O(1) clean mask and its pfx epilogue. Both are held against the port's plain
versions and the JAX package's phase 1 (XLA, and the Pallas kernel in
interpret mode)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seqwin_tpu.engine import hybrid
from seqwin_tpu.engine.pallas_scan import L, pallas_phase1, phase1_shapes
from seqwin_tpu_torch.engine import phase1
from seqwin_tpu_torch.ops.hashing import SEEDS, SROL_PERIOD, srol

from chip_smoke import edge_stream
from test_torch_phase1 import _flat

NONE = ((1 << 64) - 1, -1)  # the all-ones hash, no position


def _design_records(rng):
    """The mixed-record case mix of tests/test_pallas_scan.py plus
    homopolymer and short tandem-repeat records, where ties are everywhere."""
    recs = []
    for n_rec, frac in [(900, 0.0), (2500, 0.02), (40, 0.0), (1300, 0.1)]:
        c = rng.integers(0, 4, size=n_rec).astype(np.uint8)
        c[rng.random(n_rec) < frac] = 255
        recs.append(c)
    recs.append(np.full(300, 0, np.uint8))
    homo = np.full(400, 2, np.uint8)
    homo[170:173] = 255
    recs.append(homo)
    for period in range(2, 8):
        recs.append(np.resize(rng.integers(0, 4, size=period), 60 * period).astype(np.uint8))
    return recs


# --- (a) the rolling recurrences ---------------------------------------------

def _sror1(x: int) -> int:
    return srol(x, SROL_PERIOD - 1)


def _roll_stream(codes: np.ndarray, k: int, bad_seeds: str):
    """(canon, valid) of every position by rolling from position 0, with
    validity from the last blocking byte. A code > 3 takes zero seeds
    (``bad_seeds='zero'``) or those of its low two bits (``'low2'``)."""

    def fwd_seed(c):
        return SEEDS[c & 3] if c <= 3 or bad_seeds == 'low2' else 0

    def rev_seed(c):
        return SEEDS[3 - (c & 3)] if c <= 3 or bad_seeds == 'low2' else 0

    n = len(codes)
    byte = [int(codes[q]) if q < n else 255 for q in range(n + k)]
    f = r = 0
    last = -1
    for j in range(k):
        code = byte[j] & 63
        f ^= srol(fwd_seed(code), k - 1 - j)
        r ^= srol(rev_seed(code), j)
        last = j if code > 3 else j - 1 if byte[j] & 64 else last
    canon, valid = [], []
    for q in range(n):
        canon.append((f + r) & ((1 << 64) - 1))
        valid.append(last < q)
        cl, cin = byte[q] & 63, byte[q + k]
        ce = cin & 63
        f = srol(f, 1) ^ srol(fwd_seed(cl), k) ^ fwd_seed(ce)
        r = _sror1(r ^ rev_seed(cl) ^ srol(rev_seed(ce), k))
        last = q + k if ce > 3 else q + k - 1 if cin & 64 else last
    return np.array(canon, dtype=np.uint64), np.array(valid)


@pytest.mark.parametrize('bad_seeds', ['zero', 'low2'])
@pytest.mark.parametrize('k', [1, 2, 21, 31])
def test_rolling_hash_matches_plain_and_jax(k, bad_seeds):
    codes = _flat(_design_records(np.random.default_rng(k)))
    canon, valid = _roll_stream(codes, k, bad_seeds)
    t = torch.from_numpy(codes)
    _, want, want_valid = phase1._phase1_plain(t, k, 8)
    np.testing.assert_array_equal(valid, want_valid.numpy())
    np.testing.assert_array_equal(canon[valid], want.numpy().view(np.uint64)[valid])
    _, lo, hi = hybrid.scan_phase1(jnp.asarray(codes), k, 8, with_hashes=True)
    jax_canon = np.asarray(lo).astype(np.uint64) | (np.asarray(hi).astype(np.uint64) << np.uint64(32))
    np.testing.assert_array_equal(canon[valid], jax_canon[valid])
    assert valid.sum() > 3000 and (~valid).sum() > 100


# --- (b) the kernel's tiling -------------------------------------------------

def _rmin(l, r):
    """Rightmost argmin of (hash, index) pairs, l left of r: r wins ties."""
    return r if r[0] <= l[0] else l


def _seg_exclusive(vals, heads, rev: bool):
    """The kernel's block-wide exclusive segmented scan: Hillis-Steele over
    warps of 32 lanes in scan order (reverse thread order when ``rev``),
    then each warp folds the earlier warps' totals."""
    order = list(range(len(vals)))[::-1] if rev else list(range(len(vals)))

    def join(a, b):  # a earlier in scan order than b
        return _rmin(b, a) if rev else _rmin(a, b)

    out = [None] * len(vals)
    carry_warps = []
    for w0 in range(0, len(order), 32):
        lanes = order[w0:w0 + 32]
        v = [vals[t] for t in lanes]
        f = [heads[t] for t in lanes]
        o = 1
        while o < 32:
            v, f = ([v[l] if l < o or f[l] else join(v[l - o], v[l]) for l in range(32)],
                    [f[l] or (l >= o and f[l - o]) for l in range(32)])
            o *= 2
        c = NONE
        for tv, tf in carry_warps:
            c = tv if tf else join(c, tv)
        for l, t in enumerate(lanes):
            e, ef = (NONE, False) if l == 0 else (v[l - 1], f[l - 1])
            out[t] = e if ef else join(c, e)
        carry_warps.append((v[31], f[31]))
    return out


def _block_exclusive(vals, op, identity):
    out, acc = [], identity
    for v in vals:
        out.append(acc)
        acc = op(acc, v)
    return out


def kernel_run(nh: int) -> int:
    """Positions per thread in the kernel: ceil(nh / 256), made odd."""
    return -(-nh // 256) | 1


def _model_tile(codes, n, k, w, tile, run, t0, tabs):
    """One CTA: z, canon (0 where invalid), zpfx and lrank of outputs
    [t0, t0 + tile), computed as `phase1_kernel` computes them."""
    ftab, rtab = tabs
    base, nh = t0 - (w - 1), tile + w - 1
    cs = [int(codes[q]) if 0 <= q < n else 255 for q in range(base, base + nh + k - 1)]
    rk = [srol(ftab[0][c], 1) for c in range(4)]
    sd = [ftab[k - 1][c] for c in range(4)]


    n_thr = -(-(-(-nh // run)) // 32) * 32  # whole warps, as 256 threads are
    runs = [(min(t * run, nh), min(t * run + run, nh)) for t in range(n_thr)]
    hs, blk = [0] * nh, [0] * nh
    fagg, fhead, ragg, rhead, last_blk = [], [], [], [], []
    for s, e in runs:
        fa, fh, ra, rh, lb = NONE, False, NONE, False, -1
        if s < e:
            f = r = 0
            last = -1
            for j in range(k):
                c = cs[s + j]
                f ^= ftab[j][c & 3]
                r ^= rtab[j][c & 3]
                last = s + j if c & 63 > 3 else s + j - 1 if c & 64 else last
            off = s % w
            i = s
            while True:
                c = cs[i]
                valid = last < i
                h = (f + r) & ((1 << 64) - 1)
                hs[i] = h
                blk[i] = (0 if valid else 1) | (2 if c & 64 else 0)
                if blk[i]:
                    lb = i
                if off == 0:
                    fa, fh = (h, i), True
                else:
                    fa = _rmin(fa, (h, i))
                if not rh:
                    ra = _rmin(ra, (h, i))
                    rh = off == w - 1
                i += 1
                if i == e:
                    break
                off = 0 if off == w - 1 else off + 1
                cl, cin = c & 3, cs[i + k - 1]
                ce = cin & 3
                f = srol(f, 1) ^ rk[cl] ^ sd[ce]
                r = _sror1(r ^ sd[cl ^ 3] ^ rk[ce ^ 3])
                last = i + k - 1 if cin & 63 > 3 else i + k - 2 if cin & 64 else last
        fagg.append(fa), fhead.append(fh), ragg.append(ra), rhead.append(rh), last_blk.append(lb)
    fcarry = _seg_exclusive(fagg, fhead, rev=False)
    rcarry = _seg_exclusive(ragg, rhead, rev=True)
    lbs = _block_exclusive(last_blk, max, -1)
    sidx = [0] * nh
    for (s, e), sfx in zip(runs, rcarry):
        off = (e - 1) % w
        for i in range(e - 1, s - 1, -1):
            sfx = (hs[i], i) if off == w - 1 else _rmin((hs[i], i), sfx)
            sidx[i] = sfx[1]
            off = w - 1 if off == 0 else off - 1
    zs = [None] * tile
    zmax = []
    for (s, e), pfx, lb in zip(runs, fcarry, lbs):
        off, zm = s % w, -1
        for i in range(s, e):
            pfx = (hs[i], i) if off == 0 else _rmin(pfx, (hs[i], i))
            if blk[i]:
                lb = i
            off = 0 if off == w - 1 else off + 1
            j = i - (w - 1)
            if j < 0:
                continue
            si = sidx[j]
            best = _rmin((hs[si] if si >= 0 else NONE[0], si), pfx)
            zs[j] = base + best[1] if lb < j and best[0] != NONE[0] else -1
            zm = max(zm, zs[j])
        zmax.append(zm)
    assert None not in zs
    canon = [0 if blk[j + w - 1] & 1 else hs[j + w - 1] for j in range(tile)]
    # pfx epilogue: each thread scans its own outputs [s-(w-1), e-(w-1))
    spans = [(max(s - (w - 1), 0), max(e - (w - 1), max(s - (w - 1), 0))) for s, e in runs]
    before = _block_exclusive(zmax, max, -1)
    zp, cnts = list(zs), []
    for (js, je), m in zip(spans, before):
        cnt = 0
        for j in range(js, je):
            v = max(m, zp[j])
            cnt += v > m
            m = v
            zp[j] = v
        cnts.append(cnt)
    accs = _block_exclusive(cnts, lambda a, b: a + b, 0)
    lr = [0] * tile
    for (js, je), m, acc in zip(spans, before, accs):
        for j in range(js, je):
            acc += zp[j] > m
            m = zp[j]
            lr[j] = acc
    return zs, canon, zp, lr


def model_phase1(codes: np.ndarray, k: int, w: int, tile: int, run: int):
    """(z, canon, zpfx, lrank) of the whole stream through the kernel model,
    z and canon cut at n, zpfx and lrank as [tiles, tile]."""
    n = len(codes)
    tabs = phase1.rot_seed_tables(k, torch.device('cpu')).numpy().view(np.uint64)
    tabs = [[[int(x) for x in row] for row in part] for part in tabs]
    out = [_model_tile(codes, n, k, w, tile, run, t0, tabs) for t0 in range(0, n, tile)]
    z = np.concatenate([np.array(o[0], np.int64) for o in out])[:n].astype(np.int32)
    canon = np.concatenate([np.array(o[1], np.uint64) for o in out])[:n]
    return (z, canon, np.array([o[2] for o in out], np.int32),
            np.array([o[3] for o in out], np.int32))


# (k, w, T, R): w = 1; w above R; w not dividing T; w above T; k in {1, 21, 31};
# R = 1, even R, and the kernel's own tile and run
DESIGN = [(1, 1, 64, 3), (21, 1, 64, 5), (1, 4, 64, 1), (4, 3, 64, 4),
          (21, 200, 256, 9), (21, 200, 128, 7), (31, 17, 96, 5), (2, 9, 100, 3),
          (3, 17, 64, 11), (31, 300, 64, 33), (7, 10, 512, 17),
          (21, 200, phase1._TILE, kernel_run(phase1._TILE + 199))]


@pytest.mark.parametrize('k,w,tile,run', DESIGN)
def test_kernel_model_matches_plain_and_jax(k, w, tile, run):
    """Records, tie-heavy records and tile-edge streams in the Pallas
    kernel's padded layout: the model against `phase1_zc_plain`,
    `pfx_from_z`, and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(k * 13 + w + tile + run)
    records = _design_records(rng)
    total = sum(len(c) for c in records)
    rtotal, n, offset = phase1_shapes(total, k, w)
    padded = _flat(records, n, offset)
    # the model runs up to the padding's first w + k bytes: every later
    # window holds padding, so z is -1 there either way
    m = min(n, offset + total + w + k)
    edges = edge_stream(rng, max(2, 4096 // tile), tile, k, w)
    model_z = []
    for codes, least in ((padded[:m], 300), (edges, 20)):
        z, canon, zpfx, lrank = model_phase1(codes, k, w, tile, run)
        model_z.append(z)
        t = torch.from_numpy(codes)
        want_z, want_c = phase1.phase1_zc_plain(t, k, w)
        np.testing.assert_array_equal(z, want_z.numpy())
        np.testing.assert_array_equal(canon, want_c.numpy().view(np.uint64))
        want_p, want_r = phase1.pfx_from_z(want_z, tile)
        np.testing.assert_array_equal(zpfx, want_p.numpy())
        np.testing.assert_array_equal(lrank, want_r.numpy())
        assert (z >= 0).sum() > least
    pz, _, _ = pallas_phase1(jnp.asarray(padded.reshape(rtotal, L)), k, w,
                             interpret=True, with_hashes=False)
    pz = np.asarray(pz)
    np.testing.assert_array_equal(model_z[0], pz[:m])
    assert (pz[m:] == -1).all()


def test_kernel_run_is_odd_and_covers_the_span():
    for nh in (1, 255, 256, 257, 2247, 4295, 8595):
        r = kernel_run(nh)
        assert r % 2 == 1 and 256 * r >= nh and 256 * (r - 2) < nh
