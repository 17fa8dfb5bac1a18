"""Published peaks of one NVIDIA H100 SXM and the least work of kernel B1.

The peaks are NVIDIA's data sheet figures at the full 700 W (a card set
lower runs slower; the harness prints its power limit beside the result):
HBM3 at 3.35 TB/s, and 32-bit integer instructions at 64 per SM per clock
on 132 SMs at the 1980 MHz boost clock (16.73 Tops/s).

Kernel B1 (`phase1_z`) reads one base code and writes one int32 per
position (5 bytes), and its least algorithm takes 50 32-bit instructions
per position (rolling forward and reverse hash, canonical add, validity,
prefix and suffix argmin and their combine, clean, z). The bound of a run of
B1 is the longer of bytes over the memory rate and instructions over the
integer rate: at 2^25 positions 0.1003 ms, bound by instructions.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

B1_BYTES_PER_POS = 5
B1_OPS_PER_POS = 50
# the demangled name of kernel B1 in a device trace (template mode 0 = z)
B1_KERNEL = 'phase1_kernel<0>'


def b1_bound_s(positions: int) -> float:
    """Least seconds B1 can take over ``positions`` positions."""
    return max(B1_BYTES_PER_POS * positions / HBM_BYTES_PER_S,
               B1_OPS_PER_POS * positions / INT32_OPS_PER_S)
