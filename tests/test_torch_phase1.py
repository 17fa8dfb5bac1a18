"""seqwin_tpu_torch's phase-1 z stream against the JAX package's XLA phase 1
(`hybrid.scan_phase1`) and its Pallas kernel (interpret mode)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seqwin_tpu.engine import hybrid
from seqwin_tpu.engine.pallas_scan import L, pallas_phase1, phase1_shapes
from seqwin_tpu_torch.engine import phase1

GRID = [(1, 4), (4, 3), (7, 10), (21, 200), (31, 16)]


def _records(rng):
    """N runs, scattered Ns, short, empty and heavy-N records."""
    recs = []
    for n_rec, frac, run in [(900, 0.0, 0), (2500, 0.02, 60), (0, 0.0, 0),
                             (40, 0.0, 0), (1300, 0.1, 0), (3, 0.0, 0),
                             (1800, 0.4, 0), (1200, 0.0, 300)]:
        c = rng.integers(0, 4, size=n_rec).astype(np.uint8)
        c[rng.random(n_rec) < frac] = 255
        if run:
            s = int(rng.integers(0, n_rec - run))
            c[s:s + run] = 255
        recs.append(c)
    return recs


def _flat(records, n=None, offset=0):
    total = sum(len(c) for c in records)
    codes = np.full(n or total, 255, dtype=np.uint8)
    starts = offset + np.cumsum([0] + [len(c) for c in records[:-1]])
    off = offset
    for c in records:
        codes[off:off + len(c)] = c
        off += len(c)
    codes[starts[starts < offset + total]] |= 64
    return codes


# (2, 9) and (3, 17) add tie-heavy small k; about half of all hashes have the
# top bit set, so a signed compare anywhere picks wrong minima
@pytest.mark.parametrize('k,w', GRID + [(2, 9), (3, 17)])
def test_phase1_matches_xla_scan(k, w):
    codes = _flat(_records(np.random.default_rng(k * 7 + w)))
    want, _, _ = hybrid.scan_phase1(jnp.asarray(codes), k, w, with_hashes=False)
    want = np.asarray(want)
    t = torch.from_numpy(codes)
    np.testing.assert_array_equal(phase1.phase1_z_plain(t, k, w).numpy(), want)
    np.testing.assert_array_equal(phase1.phase1_z(t, k, w).numpy(), want)
    assert (want >= 0).sum() > 1000


@pytest.mark.parametrize('k,w', GRID)
def test_phase1_matches_pallas_interpret(k, w):
    """The same padded (R, 128) layout the Pallas kernel scans."""
    records = _records(np.random.default_rng(k * 11 + w))
    total = sum(len(c) for c in records)
    rtotal, n, offset = phase1_shapes(total, k, w)
    codes = _flat(records, n, offset)
    want, _, _ = pallas_phase1(jnp.asarray(codes.reshape(rtotal, L)), k, w,
                               interpret=True, with_hashes=False)
    got = phase1.phase1_z(torch.from_numpy(codes), k, w)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_phase1_wrapper_checks_input():
    t = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(TypeError):
        phase1.phase1_z(t.to(torch.int32), 3, 4)
    with pytest.raises(ValueError):
        phase1.phase1_z(torch.zeros(32, dtype=torch.uint8)[::2], 3, 4)
    with pytest.raises(ValueError):
        phase1.phase1_z(t, 0, 4)
    before = phase1.phase1_z.launches
    phase1.phase1_z(t, 3, 4)
    assert phase1.phase1_z.launches == before  # CPU tensors take the plain version


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('k,w', GRID + [(2, 9), (3, 17)])
def test_phase1_kernel_matches_plain_on_gpu(cuda_device, k, w):
    codes = torch.from_numpy(_flat(_records(np.random.default_rng(k + w)))).to(cuda_device)
    before = phase1.phase1_z.launches
    got = phase1.phase1_z(codes, k, w)
    assert phase1.phase1_z.launches == before + 1
    torch.testing.assert_close(got, phase1.phase1_z_plain(codes, k, w), rtol=0, atol=0)
