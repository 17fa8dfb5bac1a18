"""seqwin_tpu_torch's unsigned 64-bit helpers against numpy uint64, and the
port's copied constants and dtypes against the JAX package's."""
import numpy as np
import pytest
import torch

from seqwin_tpu.graph import dtypes as jax_dtypes
from seqwin_tpu.ops import hashing as jax_hashing
from seqwin_tpu_torch.graph import dtypes
from seqwin_tpu_torch.ops import hashing, u64

M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


@pytest.fixture(scope='module')
def pair():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2 ** 64, size=4000, dtype=np.uint64)
    b = rng.integers(0, 2 ** 64, size=4000, dtype=np.uint64)
    # edge values: 0, 1, 2^63 - 1, 2^63, 2^63 + 1, all ones, and ties
    edge = np.array([0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 63 + 1, 2 ** 64 - 1], dtype=np.uint64)
    a[:36] = np.repeat(edge, 6)
    b[:36] = np.tile(edge, 6)
    b[36:100] = a[36:100]
    assert (a >= np.uint64(2 ** 63)).mean() > 0.4
    return a, b


def test_roundtrip_and_as_signed(pair):
    a, _ = pair
    t = u64.from_numpy(a)
    assert t.dtype == torch.int64
    np.testing.assert_array_equal(u64.to_numpy(t), a)
    for x in [0, 1, 2 ** 63 - 1, 2 ** 63, 2 ** 64 - 1, 0x90B45D39FB6DA1FA]:
        assert np.int64(u64.as_signed(x)).view(np.uint64) == np.uint64(x)


@pytest.mark.parametrize('s', [0, 1, 27, 33, 63])
def test_shr_is_logical(pair, s):
    a, _ = pair
    got = u64.to_numpy(u64.shr(u64.from_numpy(a), s))
    np.testing.assert_array_equal(got, a >> np.uint64(s))


def test_unsigned_order(pair):
    a, b = pair
    ta, tb = u64.from_numpy(a), u64.from_numpy(b)
    np.testing.assert_array_equal(u64.lt(ta, tb).numpy(), a < b)
    np.testing.assert_array_equal(u64.le(ta, tb).numpy(), a <= b)
    np.testing.assert_array_equal(u64.to_numpy(u64.umin(ta, tb)), np.minimum(a, b))
    np.testing.assert_array_equal(u64.to_numpy(u64.umax(ta, tb)), np.maximum(a, b))
    order = torch.sort(u64.key(ta), stable=True).indices.numpy()
    np.testing.assert_array_equal(order, np.argsort(a, kind='stable'))


def test_wrapping_arithmetic(pair):
    a, b = pair
    ta, tb = u64.from_numpy(a), u64.from_numpy(b)
    mult = hashing.out_hash_mult(21)
    with np.errstate(over='ignore'):
        np.testing.assert_array_equal(u64.to_numpy(ta + tb), a + b)
        np.testing.assert_array_equal(u64.to_numpy(ta * u64.as_signed(mult)), a * np.uint64(mult))
    np.testing.assert_array_equal(u64.to_numpy(ta ^ tb), a ^ b)


def test_constants_equal_jax_package():
    for name in ('M64', 'M33', 'M31', 'SROL_PERIOD', 'SEEDS', 'SEEDS_COMP',
                 'COMP_CODE', 'MULTISEED', 'MULTISHIFT', 'SEED_N'):
        assert getattr(hashing, name) == getattr(jax_hashing, name), name
    np.testing.assert_array_equal(hashing.CODE_TAB, jax_hashing.CODE_TAB)
    for k in (1, 4, 7, 21, 31, 64):
        assert hashing.out_hash_mult(k) == jax_hashing.out_hash_mult(k)
    rng = np.random.default_rng(1)
    for x in rng.integers(0, 2 ** 64, size=50, dtype=np.uint64):
        for d in (0, 1, 5, 32, 33, 500, 1022, 1023):
            assert hashing.srol(int(x), d) == jax_hashing.srol(int(x), d)


def test_dtypes_equal_jax_package():
    assert dtypes.KMER_DTYPE == jax_dtypes.KMER_DTYPE
    assert dtypes.NODE_DTYPE == jax_dtypes.NODE_DTYPE
    assert dtypes.EDGE_DTYPE == jax_dtypes.EDGE_DTYPE
