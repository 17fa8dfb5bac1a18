"""seqwin_tpu_torch's pfx emission extraction (`hybrid.scan_phase2_pfx` over
kernel B3's tile staircases) against the JAX package's `scan_phase2_pfx` and
against the port's own mask extraction (`hybrid.scan_chunk_device`)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seqwin_tpu.engine import hybrid as jhybrid
from seqwin_tpu_torch.engine.hybrid import (
    _emission_mask,
    chunk_host_prep,
    pfx_from_z,
    scan_chunk_device,
    scan_phase2_pfx,
)
from seqwin_tpu_torch.engine.phase1 import phase1_pfx, phase1_z_plain

from test_torch_phase1 import _records

OFFSETS = np.array([0, 3, 8], dtype=np.uintp)  # two assemblies over 8 records


def _port_pfx(records, k, w, ts=None, offsets=OFFSETS):
    """Host prep, plain phase 1, exact counts, pfx extraction; returns the
    streams, the exact count and the host prep."""
    prep = chunk_host_prep(records, k, w, 0, offsets)
    codes, starts, irr_pos, patch_z, asm_tab = prep
    t = torch.from_numpy(codes)
    z_clean = phase1_z_plain(t, k, w)
    z = z_clean.clone()
    z[torch.from_numpy(irr_pos).long()] = torch.from_numpy(patch_z)
    count = int(_emission_mask(z).sum())
    clean = int(_emission_mask(z_clean).sum())
    if ts is None:
        zpfx, lrank, ts = phase1_pfx(t, k, w)
    else:
        zpfx, lrank = pfx_from_z(z_clean, ts)
    e_oh, e_pos, e_rec, dev_count, e_asm = scan_phase2_pfx(
        zpfx, lrank, t, torch.from_numpy(irr_pos), torch.from_numpy(patch_z),
        torch.from_numpy(starts), 0, torch.from_numpy(asm_tab), max(count, clean), count, k)
    assert int(dev_count) == count
    return (e_oh, e_pos, e_rec, e_asm), count, prep


@pytest.mark.parametrize('k,w,ts', [(9, 12, 512), (4, 3, 2048), (21, 200, 1000), (7, 10, 3000)])
def test_pfx_extraction_matches_jax(k, w, ts):
    """Streams with N runs, heavy-N and short records (many host patches)."""
    records = _records(np.random.default_rng(k * 3 + w))
    (e_oh, e_pos, e_rec, e_asm), count, prep = _port_pfx(records, k, w, ts)
    codes, starts, irr_pos, patch_z, asm_tab = prep
    n = len(codes)
    assert len(irr_pos) > 100
    z, _, _ = jhybrid.scan_phase1(jnp.asarray(codes), k, w, with_hashes=False)
    zpfx, lrank = jhybrid.pfx_from_z(z, 0, ts)
    pcap = 1 << max(8, int(len(irr_pos)).bit_length())
    pp = np.full(pcap, n, np.int32)
    pz = np.full(pcap, -1, np.int32)
    pp[:len(irr_pos)], pz[:len(irr_pos)] = irr_pos, patch_z
    st = np.full(64, n, np.int32)
    st[:len(starts)] = starts
    at = np.zeros(64, np.int32)
    at[:len(asm_tab)] = asm_tab
    emit_cap = 1 << int(count).bit_length()
    j_oh, j_pos, j_rec, j_count, j_asm = jhybrid.scan_phase2_pfx(
        zpfx, lrank, jnp.asarray(codes), jnp.asarray(pp), jnp.asarray(pz),
        jnp.asarray(st), jnp.int32(0), jnp.asarray(at), emit_cap, k, 0, ts)
    assert int(j_count) == count > 20
    np.testing.assert_array_equal(e_oh.numpy().view(np.uint64), np.asarray(j_oh)[:count])
    np.testing.assert_array_equal(e_pos.numpy(), np.asarray(j_pos)[:count])
    np.testing.assert_array_equal(e_rec.numpy(), np.asarray(j_rec)[:count])
    np.testing.assert_array_equal(e_asm.numpy(), np.asarray(j_asm)[:count])
    assert (np.asarray(j_rec)[count:] == -1).all()


def _edge_cases():
    rng = np.random.default_rng(0)
    k, w = 5, 4
    nb = rng.integers(0, 4, 9000).astype(np.uint8)
    nb[2040:2055] = 255                     # N run across a kernel tile edge
    tile_n = rng.integers(0, 4, 9000).astype(np.uint8)
    tile_n[2048:4096] = 255                 # a whole kernel tile of Ns
    alt = rng.integers(0, 4, 400).astype(np.uint8)
    alt[::2] = 255
    polyn = np.zeros(500, np.uint8)
    polyn[250] = 255
    return [
        (k, w, [np.full(100, 255, np.uint8)]),
        (k, w, [rng.integers(0, 4, k + w - 1).astype(np.uint8)]),
        (k, w, [rng.integers(0, 4, k + w - 2).astype(np.uint8)]),
        (k, w, [np.zeros(500, np.uint8)]),
        (k, w, [polyn]),
        (k, w, [alt]),
        (k, w, [rng.integers(0, 4, 200).astype(np.uint8), np.zeros(0, np.uint8),
                rng.integers(0, 4, 200).astype(np.uint8)]),
        (9, 300, [rng.integers(0, 4, 1000).astype(np.uint8)]),
        (9, 12, [nb]),
        (9, 12, [tile_n]),
        (21, 200, _records(rng)),
        (2, 9, _records(rng)),
    ]


@pytest.mark.parametrize('case', range(len(_edge_cases())))
def test_pfx_extraction_matches_mask_extraction(case):
    """All-N, sub-window and constant records, blockers at tile edges, a
    tile of Ns, empty records, and the mixed records at the kernel's tile."""
    k, w, records = _edge_cases()[case]
    offsets = np.array([0, len(records)], dtype=np.uintp)
    got, count, _ = _port_pfx(records, k, w, offsets=offsets)
    want = scan_chunk_device(records, k, w, 0, record_offsets=offsets, device='cpu')
    assert want[3] == count
    for a, b in zip(got, (want[0], want[1], want[2], want[4])):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_pfx_overflow_with_patch_suppression_reports_it():
    """When the clean emission count alone exceeds emit_cap, patch
    suppressions must not pull the device count back under the cap (the
    JAX package's regression case): the multi-device build then sees a count
    that differs from its pre-pass and raises."""
    n, ts = 1 << 12, 1 << 10
    z = np.full(n, -1, np.int32)
    z[:40] = np.arange(40)       # 39 clean emissions
    z[5] = -1                    # position 5 is a patched (irregular) window
    zpfx, lrank = pfx_from_z(torch.from_numpy(z), ts)
    args = (torch.zeros(n, dtype=torch.uint8), torch.tensor([5]), torch.tensor([35]),
            torch.tensor([0]), 0, torch.zeros(1, dtype=torch.int32))
    j_zpfx, j_lrank = jhybrid.pfx_from_z(jnp.asarray(z), 0, ts)
    pp = np.full(256, n, np.int32)
    pz = np.full(256, -1, np.int32)
    pp[0], pz[0] = 5, 35
    _, _, _, j_count, _ = jhybrid.scan_phase2_pfx(
        j_zpfx, j_lrank, jnp.zeros(n, jnp.uint8), jnp.asarray(pp), jnp.asarray(pz),
        jnp.asarray(np.array([0, n], np.int32)), jnp.int32(0), jnp.zeros(2, jnp.int32),
        32, 3, 0, ts)
    *_, dev_count, _ = scan_phase2_pfx(zpfx, lrank, *args, 32, 32, 3)
    assert int(dev_count) == int(j_count) > 32
    # with a sufficient cap the result is exact: 0..4, the patch's 35
    # (suppressing clean 6..35), then 36..39
    _, e_pos, _, dev_count, _ = scan_phase2_pfx(zpfx, lrank, *args, 64, 10, 3)
    assert int(dev_count) == 10
    assert e_pos.tolist() == [0, 1, 2, 3, 4, 35, 36, 37, 38, 39]
