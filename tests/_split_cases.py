"""Matrices whose rows K15 splits (``csrc_segment.split_rows``), for the
``segment`` path's tests on the CPU and on the card (no tests here, and no
JAX: the card's tests import it too).

Each case is a host CSRC with ``n`` rows:

  one_row           every lower slot in the last row (n - 1 of them);
  around_threshold  rows of HEAVY_SLOTS - 1, HEAVY_SLOTS, HEAVY_SLOTS + 1,
                    2 * CHUNK_SLOTS, 2 * CHUNK_SLOTS + 1 and a few hundred
                    slots among rows of a few;
  kronecker         Graph500's Kronecker graph at SCALE 11 (A, B, C = 0.57,
                    0.19, 0.19, edgefactor 16, labels permuted), drawn by
                    ``chip_smoke.kronecker_pattern``;
  rectangular       around_threshold with a rectangular tail of 40 columns.

Values are multiples of 1/4 in [-2, 2] where ``dyadic`` (then every sum of
the kernels and of the plain chain is exact, in any order), else standard
normal; ``au`` is drawn apart from ``al`` unless ``symmetric``.
"""
import numpy as np

from repro_torch import convert
from repro_torch.kernels import csrc_segment as seg

from _smoke import chip_smoke

SPLIT_CASES = ("one_row", "around_threshold", "kronecker", "rectangular")


def _threshold_pairs(rng):
    n = 4000
    lengths = [seg.HEAVY_SLOTS - 1, seg.HEAVY_SLOTS, seg.HEAVY_SLOTS + 1,
               2 * seg.CHUNK_SLOTS, 2 * seg.CHUNK_SLOTS + 1, 333, 5 * 64 + 7]
    rows = np.arange(len(lengths)) * 400 + 1000
    hi, lo = [], []
    for row, length in zip(rows, lengths):
        lo.append(rng.choice(row, size=length, replace=False))
        hi.append(np.full(length, row))
    short = rng.integers(1, n, size=3 * n)
    short = short[~np.isin(short, rows)]      # the lengths above stay exact
    hi.append(short)
    lo.append((rng.random(short.shape[0]) * short).astype(np.int64))
    return n, np.concatenate(hi), np.concatenate(lo)


def split_case(case, dyadic=True, symmetric=True, seed=0):
    """The host CSRC of ``case`` (see the module's docstring)."""
    rng = np.random.default_rng(seed)
    if case == "one_row":
        n = 3000
        ia, ja, _ = chip_smoke()._lower_from_pairs(
            n, np.full(n - 1, n - 1), np.arange(n - 1))
    elif case == "kronecker":
        n, ia, ja = chip_smoke().kronecker_pattern(11, seed)
    elif case in ("around_threshold", "rectangular"):
        n, hi, lo = _threshold_pairs(rng)
        ia, ja, _ = chip_smoke()._lower_from_pairs(n, hi, lo)
    else:
        raise ValueError(f"no split case {case!r}")
    k = ja.shape[0]

    def values(size):
        if dyadic:
            return (rng.integers(-8, 9, size=size) / 4.0).astype(np.float32)
        return rng.standard_normal(size, dtype=np.float32)

    al = values(k)
    au = al if symmetric else values(k)
    tail = 40 if case == "rectangular" else 0
    per_row = rng.integers(0, 4, size=n) if tail else np.zeros(n, np.int64)
    iar = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(per_row, out=iar[1:])
    jar = rng.integers(0, max(tail, 1), size=int(iar[-1])).astype(np.int32)
    return convert.csrc_from_arrays(
        n=n, m=n + tail, numerically_symmetric=symmetric,
        ad=values(n) + 4.0, ia=ia, ja=ja, al=al, au=au, iar=iar, jar=jar,
        ar=values(int(iar[-1])))
