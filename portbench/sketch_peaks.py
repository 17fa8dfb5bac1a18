"""The least work of the device MinHash sketches (``--sketch-mode device``),
over the published H100 peaks of `peaks.py`.

The estimator computes, for every position of an assembly's stream, the
canonical ntHash of the k-mer there and keeps the ``sketchsize`` least
distinct values of the valid ones. The least algorithm reads each base code
once and rolls the hash along the stream, as kernel B1 does, counting a
64-bit operation as the 32-bit instructions it takes:
- bytes: 1 a position, the uint8 code read once; the sketch written back
  is 8 KB an assembly, nothing beside 4.7 Mbp;
- 32-bit instructions: 34 a position. The split rotations of the forward
  and the reverse hash, 6 each (two 32-bit shifts or funnels, masks and a
  merge per 33/31 part); their two 3-input XORs, 2 each; four seed picks by
  code, 2 each (one 32-bit load or select per half); the 64-bit canonical
  add, 2; the byte load and the code test, 2; validity over the k-window,
  3 (update the last invalid position, compare); the compare of the hash
  against the running bottom-k bound, 3 (a 64-bit unsigned compare, 2, and
  its predicate with validity, 1). The bound starts at the all-ones value,
  so the strict compare also leaves that value out. A hash below the bound
  enters the sketch: with the bound falling as the least values of a
  stream of N distinct hashes arrive, that happens about
  ``sketchsize * ln(N / sketchsize)`` times, ~8,500 in 4.7 Mbp (0.2% of
  the positions), and is not counted.
The bound is the longer of bytes over the memory rate and instructions over
the integer rate: instructions bound it, 2.03 ns a kilobase, 1.63 ms over
the 803.7 Mbp of the 171-assembly set. It reads the bases of the records,
whatever implements the sketches; the separators between records are no
work of the estimator.
"""
from __future__ import annotations

from portbench.peaks import HBM_BYTES_PER_S, INT32_OPS_PER_S

SKETCH_BYTES_PER_POS = 1
SKETCH_OPS_PER_POS = 34


def sketch_bound_s(positions: int) -> float:
    """Least seconds the sketches of ``positions`` bases can take."""
    return max(SKETCH_BYTES_PER_POS * positions / HBM_BYTES_PER_S,
               SKETCH_OPS_PER_POS * positions / INT32_OPS_PER_S)
