"""Row partitioning for the parallel CSRC product (paper §3).

The paper found that nnz-balanced partitioning ("the deviation from the average
number of non-zeros per row is minimized") beats row-count partitioning
because flops per row are proportional to nnz.  We reuse the same algorithm
at every granularity of the device mapping:

  * shard level  — rows → mesh shards (the paper's "threads");
  * tile level   — rows inside a shard → kernel row tiles.

Effective ranges (paper §3.1, the *effective* accumulation method) are the
set of destination rows a partition actually writes: its own rows (gather
term) plus the scatter targets ja[p].  For band matrices these are contiguous
windows, which become halo windows exchanged between neighbor shards.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .csrc import CSRC, _np, bandwidth, nnz_per_row


@dataclasses.dataclass(frozen=True)
class RowPartition:
    """A p-way contiguous row partition."""
    starts: np.ndarray          # (p+1,) row boundaries; part t owns [starts[t], starts[t+1])
    # effective write range per part: [eff_lo[t], eff_hi[t]) covers every row
    # part t writes (own rows + scatter targets).
    eff_lo: np.ndarray          # (p,)
    eff_hi: np.ndarray          # (p,)
    nnz_per_part: np.ndarray    # (p,)

    @property
    def p(self) -> int:
        return len(self.starts) - 1

    def rows(self, t: int) -> Tuple[int, int]:
        return int(self.starts[t]), int(self.starts[t + 1])


def partition_rows_by_nnz(M: CSRC, p: int) -> RowPartition:
    """Contiguous p-way split minimizing per-part nnz deviation (greedy
    prefix walk against the ideal quantile, as in the paper's non-zero balanced
    implementation)."""
    n = M.n
    w = nnz_per_row(M).astype(np.int64)
    csum = np.concatenate([[0], np.cumsum(w)])
    total = csum[-1]
    starts = np.zeros(p + 1, dtype=np.int64)
    for t in range(1, p):
        target = total * t / p
        # row index whose prefix is closest to the target quantile
        idx = int(np.searchsorted(csum, target))
        idx = min(max(idx, int(starts[t - 1]) + 1), n - (p - t))
        # snap to whichever neighbor is closer
        if idx > 0 and abs(csum[idx - 1] - target) < abs(csum[idx] - target):
            idx = max(idx - 1, int(starts[t - 1]) + 1)
        starts[t] = idx
    starts[p] = n

    eff_lo = np.zeros(p, dtype=np.int64)
    eff_hi = np.zeros(p, dtype=np.int64)
    ja = _np(M.ja)
    ia = _np(M.ia)
    for t in range(p):
        r0, r1 = int(starts[t]), int(starts[t + 1])
        lo, hi = r0, r1
        s0, s1 = int(ia[r0]), int(ia[r1])
        if s1 > s0:
            lo = min(lo, int(ja[s0:s1].min()))
        eff_lo[t], eff_hi[t] = lo, hi
    nnz_part = np.array([int(np.sum(w[int(starts[t]):int(starts[t + 1])]))
                         for t in range(p)], dtype=np.int64)
    return RowPartition(starts=starts, eff_lo=eff_lo, eff_hi=eff_hi,
                        nnz_per_part=nnz_part)


def partition_rows_by_count(M: CSRC, p: int) -> RowPartition:
    """Row-count split (the paper's inferior baseline — kept for benchmarks)."""
    n = M.n
    starts = np.linspace(0, n, p + 1).astype(np.int64)
    ja = _np(M.ja)
    ia = _np(M.ia)
    eff_lo = np.zeros(p, dtype=np.int64)
    eff_hi = np.zeros(p, dtype=np.int64)
    for t in range(p):
        r0, r1 = int(starts[t]), int(starts[t + 1])
        lo = r0
        s0, s1 = int(ia[r0]), int(ia[r1])
        if s1 > s0:
            lo = min(lo, int(ja[s0:s1].min()))
        eff_lo[t], eff_hi[t] = lo, r1
    w = nnz_per_row(M)
    nnz_part = np.array([int(np.sum(w[int(starts[t]):int(starts[t + 1])]))
                         for t in range(p)], dtype=np.int64)
    return RowPartition(starts=starts, eff_lo=eff_lo, eff_hi=eff_hi,
                        nnz_per_part=nnz_part)


def load_imbalance(part: RowPartition) -> float:
    """max/mean nnz per part — 1.0 is perfect balance."""
    m = part.nnz_per_part
    return float(m.max() / max(1.0, m.mean()))


def interval_boundaries(part: RowPartition) -> np.ndarray:
    """Paper §3.1 method 4 (*interval*): the union of all effective-range
    endpoints splits y into intervals, each accumulated by one thread.
    Returns the sorted unique boundary list."""
    pts = np.unique(np.concatenate([part.eff_lo, part.eff_hi,
                                    part.starts[:1], part.starts[-1:]]))
    return pts


def halo_widths(part: RowPartition) -> List[int]:
    """For the *effective/halo* strategy: how far below its own range each
    shard writes (band matrices ⇒ this is the halo a shard must send to its
    left neighbors)."""
    return [int(part.starts[t] - part.eff_lo[t]) for t in range(part.p)]


# ---------------------------------------------------------------------------
# Shard geometry of the mesh strategies (core/distributed.py): the row
# ranges and diagonals every shard layout is cut along
# ---------------------------------------------------------------------------

def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


def halo_geometry(M: CSRC, p: int) -> Tuple[int, int]:
    """(ns, h) of the *effective/halo* strategy's equal-row shards: rows per
    shard (8-aligned) and the halo width (the 8-aligned bandwidth).  Raises
    ValueError when the band does not fit inside one shard (fall back to
    allreduce / reduce_scatter)."""
    ns = _round_up(-(-M.n // p), 8)
    band = bandwidth(M)
    h = max(8, _round_up(band, 8))
    if h > ns:
        raise ValueError(
            f"band {band} exceeds shard rows {ns}; halo strategy needs "
            "band <= n/p (fall back to allreduce/reduce_scatter)")
    return ns, h


def halo_slot_spans(M: CSRC, p: int, ns: int) -> List[Tuple[int, int]]:
    """Lower-slot range of each equal-row shard (slots are row-major)."""
    ia = _np(M.ia).astype(np.int64)
    return [(int(ia[min(M.n, t * ns)]), int(ia[min(M.n, (t + 1) * ns)]))
            for t in range(p)]


def shard_diagonal(M: CSRC, starts, width: int) -> np.ndarray:
    """(p, width) float32: shard t's own diagonal entries at their global
    rows [starts[t], starts[t+1]), zero elsewhere."""
    p = len(starts) - 1
    ad = np.zeros((p, width), np.float32)
    ad_full = _np(M.ad)
    for t in range(p):
        r0, r1 = int(starts[t]), int(starts[t + 1])
        ad[t, r0:r1] = ad_full[r0:r1]
    return ad


def halo_diagonal(M: CSRC, p: int, ns: int, h: int, width: int) -> np.ndarray:
    """(p, width) float32 local diagonals of the halo shards: shard t's own
    rows at local rows [h, h + ns), the halo rows zero."""
    ad = np.zeros((p, width), np.float32)
    ad_full = _np(M.ad)
    for t in range(p):
        r0, r1 = t * ns, min(M.n, (t + 1) * ns)
        if r1 > r0:
            ad[t, h:h + (r1 - r0)] = ad_full[r0:r1]
    return ad
