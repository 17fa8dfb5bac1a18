"""seqwin_tpu_torch's phase-1 hash and pfx modes (kernels B2 and B3 and their
plain versions) against the JAX package's XLA phase 1 with hashes
(`hybrid.scan_phase1`), its `pfx_from_z`, and its Pallas kernel in interpret
mode."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seqwin_tpu.engine import hybrid
from seqwin_tpu.engine.pallas_scan import L, pallas_phase1, phase1_shapes
from seqwin_tpu_torch.engine import phase1
from seqwin_tpu_torch.engine.hybrid import pfx_from_z

from chip_smoke import edge_stream
from test_torch_phase1 import GRID, _flat, _records


def _canon_u64(lo, hi):
    return np.asarray(lo).astype(np.uint64) | (np.asarray(hi).astype(np.uint64) << np.uint64(32))


# (2, 9) and (3, 17) add tie-heavy small k
@pytest.mark.parametrize('k,w', GRID + [(2, 9), (3, 17)])
def test_phase1_zc_plain_matches_xla_scan(k, w):
    codes = _flat(_records(np.random.default_rng(k * 5 + w)))
    want_z, lo, hi = hybrid.scan_phase1(jnp.asarray(codes), k, w, with_hashes=True)
    t = torch.from_numpy(codes)
    z, canon = phase1.phase1_zc_plain(t, k, w)
    valid = phase1._phase1_plain(t, k, w)[2].numpy()
    np.testing.assert_array_equal(z.numpy(), np.asarray(want_z))
    got = canon.numpy().view(np.uint64)
    np.testing.assert_array_equal(got[valid], _canon_u64(lo, hi)[valid])
    assert (got[~valid] == 0).all()
    assert valid.sum() > 1000
    if k >= 4:  # about half of all hashes have the top bit set
        assert (got[valid] >> np.uint64(63)).mean() > 0.3


def test_phase1_zc_matches_pallas_interpret():
    """The (R, 128) layout the Pallas kernel scans in its hash mode."""
    k, w = 7, 10
    records = _records(np.random.default_rng(3))
    total = sum(len(c) for c in records)
    rtotal, n, offset = phase1_shapes(total, k, w)
    codes = _flat(records, n, offset)
    want_z, lo, hi = pallas_phase1(jnp.asarray(codes.reshape(rtotal, L)), k, w,
                                   interpret=True, with_hashes=True)
    t = torch.from_numpy(codes)
    z, canon = phase1.phase1_zc(t, k, w)
    np.testing.assert_array_equal(z.numpy(), np.asarray(want_z))
    want = _canon_u64(lo, hi)
    cand = np.unique(np.asarray(want_z)[np.asarray(want_z) >= 0])
    np.testing.assert_array_equal(canon.numpy().view(np.uint64)[cand], want[cand])
    valid = phase1._phase1_plain(t, k, w)[2].numpy()
    valid[len(want):] = False
    np.testing.assert_array_equal(canon.numpy().view(np.uint64)[:len(want)][valid[:len(want)]],
                                  want[valid[:len(want)]])


@pytest.mark.parametrize('ts', [512, 2048, 1000, 3])
def test_pfx_from_z_matches_jax(ts):
    """Tile staircases at tile sizes that divide the stream and that do not
    (the tail tile padded with -1)."""
    codes = _flat(_records(np.random.default_rng(ts)))
    z, _, _ = hybrid.scan_phase1(jnp.asarray(codes), 9, 12, with_hashes=False)
    want_p, want_r = hybrid.pfx_from_z(z, 0, ts)
    got_p, got_r = pfx_from_z(torch.from_numpy(np.array(z)), ts)
    assert got_p.dtype == torch.int32 and got_r.dtype == torch.int32
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


def test_pfx_tiles_restart_without_carry():
    """Each tile's prefix-max starts from its own first entry: the previous
    tile's maximum is never carried in, and lrank counts from -1."""
    z = torch.tensor([5, -1, 2, 3, -1, 4, -1, -1], dtype=torch.int32)
    zpfx, lrank = pfx_from_z(z, 3)
    assert zpfx.tolist() == [[5, 5, 5], [3, 3, 4], [-1, -1, -1]]
    assert lrank.tolist() == [[1, 1, 1], [1, 1, 2], [0, 0, 0]]


@pytest.mark.parametrize('k,w', [(4, 3), (21, 200)])
def test_mode_wrappers_take_plain_on_cpu(k, w):
    t = torch.from_numpy(_flat(_records(np.random.default_rng(k + w))))
    before = (phase1.phase1_zc.launches, phase1.phase1_pfx.launches)
    z, canon = phase1.phase1_zc(t, k, w)
    pz, pc = phase1.phase1_zc_plain(t, k, w)
    assert torch.equal(z, pz) and torch.equal(canon, pc)
    zpfx, lrank, ts = phase1.phase1_pfx(t, k, w)
    want_p, want_r = pfx_from_z(phase1.phase1_z_plain(t, k, w), ts)
    assert zpfx.shape == (-(-t.numel() // ts), ts)
    assert torch.equal(zpfx, want_p) and torch.equal(lrank, want_r)
    assert (phase1.phase1_zc.launches, phase1.phase1_pfx.launches) == before


@pytest.mark.parametrize('fn', [phase1.phase1_zc, phase1.phase1_pfx])
def test_mode_wrappers_check_input(fn):
    t = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(TypeError):
        fn(t.to(torch.int32), 3, 4)
    with pytest.raises(ValueError):
        fn(torch.zeros(32, dtype=torch.uint8)[::2], 3, 4)
    with pytest.raises(ValueError):
        fn(t, 3, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


# (21, 4500): a window longer than the kernel's tile
@pytest.mark.gpu
@pytest.mark.parametrize('k,w', GRID + [(2, 9), (3, 17), (21, 4500)])
@pytest.mark.parametrize('stream', ['records', 'edges'])
def test_mode_kernels_match_plain_on_gpu(cuda_device, k, w, stream):
    """Seeded records, and tile-edge streams (homopolymers, period-2..7
    repeats, record starts and N runs around tile and segment edges) at the
    kernel's tile."""
    rng = np.random.default_rng(k + w)
    codes = (_flat(_records(rng)) if stream == 'records'
             else edge_stream(rng, 24, phase1._TILE, k, w))
    codes = torch.from_numpy(codes).to(cuda_device)
    before = (phase1.phase1_zc.launches, phase1.phase1_pfx.launches)
    z, canon = phase1.phase1_zc(codes, k, w)
    zpfx, lrank, ts = phase1.phase1_pfx(codes, k, w)
    assert (phase1.phase1_zc.launches, phase1.phase1_pfx.launches) == (before[0] + 1, before[1] + 1)
    pz, pc = phase1.phase1_zc_plain(codes, k, w)
    torch.testing.assert_close(z, pz, rtol=0, atol=0)
    torch.testing.assert_close(canon, pc, rtol=0, atol=0)
    want_p, want_r = pfx_from_z(pz, ts)
    torch.testing.assert_close(zpfx, want_p, rtol=0, atol=0)
    torch.testing.assert_close(lrank, want_r, rtol=0, atol=0)
