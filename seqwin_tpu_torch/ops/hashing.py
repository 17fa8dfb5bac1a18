"""ntHash v2 constants and scalar primitives.

Counterpart: `seqwin_tpu/ops/hashing.py` (copied; the port never imports the
JAX package). The numeric contract mirrors btllib's ntHash v2:

- ``srol`` is a split rotation: the low 33 bits and the high 31 bits of a
  64-bit word rotate independently; its order is lcm(33, 31) = 1023.
- ``fwd(p) = XOR_{j<k} srol^(k-1-j)(SEED[s[p+j]])``,
  ``rev(p) = XOR_{j<k} srol^j(SEED[comp(s[p+j])])``,
  ``canonical = (fwd + rev) mod 2^64``.
- The node id is ``t = canonical * (1 ^ k*MULTISEED); out = t ^ (t >> 27)``.
"""
from __future__ import annotations

import numpy as np

M64 = (1 << 64) - 1
M33 = (1 << 33) - 1
M31 = (1 << 31) - 1
SROL_PERIOD = 1023  # lcm(33, 31)

SEED_A = 0x3C8BFBB395C60474
SEED_C = 0x3193C18562A02B4C
SEED_G = 0x20323ED082572324
SEED_T = 0x295549F54BE24456
SEED_N = 0x0000000000000000
MULTISEED = 0x90B45D39FB6DA1FA
MULTISHIFT = 27

# Base codes: A=0, C=1, G=2, T=3; 255 = invalid.
SEEDS = (SEED_A, SEED_C, SEED_G, SEED_T)
COMP_CODE = (3, 2, 1, 0)
SEEDS_COMP = tuple(SEEDS[c] for c in COMP_CODE)


def _build_code_tab() -> np.ndarray:
    """ASCII -> 2-bit base code, 255 for invalid: upper/lowercase ACGT, U as
    T, plus the low-ASCII codes 1='T', 3='G', 4/5='A', 7='C'."""
    tab = np.full(256, 255, dtype=np.uint8)
    for chars, code in ((b'Aa', 0), (b'Cc', 1), (b'Gg', 2), (b'TtUu', 3)):
        for ch in chars:
            tab[ch] = code
    for ch, code in ((1, 3), (3, 2), (4, 0), (5, 0), (7, 1)):
        tab[ch] = code
    return tab


CODE_TAB = _build_code_tab()


def srol1(x: int) -> int:
    """One split left-rotation (`hashing_internals.hpp:29-35`)."""
    m = ((x & 0x8000000000000000) >> 30) | ((x & 0x100000000) >> 32)
    return ((x << 1) & 0xFFFFFFFDFFFFFFFF) | m


def srol(x: int, d: int) -> int:
    """Split left-rotation by ``d`` (low 33 and high 31 bits independently)."""
    d33 = d % 33
    d31 = d % 31
    lo = x & M33
    hi = x >> 33
    lo = ((lo << d33) | (lo >> (33 - d33))) & M33 if d33 else lo
    hi = ((hi << d31) | (hi >> (31 - d31))) & M31 if d31 else hi
    return (hi << 33) | lo


def out_hash_mult(k: int) -> int:
    """The (mod 2^64) multiplier for the second hash: ``1 ^ (k * MULTISEED)``."""
    return (1 ^ (k * MULTISEED)) & M64
