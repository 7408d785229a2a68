"""Plain PyTorch oracles: the ``segment`` path and the in-package reference.

The CSRC product (paper Fig. 2a):

    y[i]      = ad[i] * x[i]
    y[i]     += al[p] * x[ja[p]]     (gather term,   p in row i's slots)
    y[ja[p]] += au[p] * x[i]         (scatter term,  transpose contribution)
    y[i]     += ar[q] * x[n + jar[q]]  (rectangular tail, paper Fig. 2b)

The scatter term is one ``index_add_`` into a float32 destination — every
slot's contribution is materialized, then summed by destination row, the
paper's local-buffers strategy expressed functionally.  On a CUDA tensor
``index_add_`` sums with atomics, so the order of additions varies from
run to run; on dyadic values float32 sums are order-independent and the
result is exact.

Matrix index arrays are int32 in the container; they are widened to int64
once per call (``index_add_`` / advanced indexing want int64).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.csrc import CSRC, _np, row_of_slot


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum ``data`` rows by ``ids`` into ``num_segments`` float32 rows; an
    id equal to ``num_segments`` is dropped (the padding sentinel)."""
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                      dtype=torch.float32, device=data.device)
    out.index_add_(0, ids.long(), data.to(torch.float32))
    return out[:num_segments]


def row_index(M: CSRC) -> torch.Tensor:
    """Row of each lower slot (expanded ``ia``), on the matrix's device."""
    return torch.from_numpy(row_of_slot(M)).to(M.ad.device)


def csrc_spmv_arrays(ad, row_idx, ja, al, au, x, n: int,
                     num_symmetric: bool = False):
    """CSRC product on raw tensors.

    Args:
      ad: (n,) diagonal. row_idx: (k,) row of each lower slot (expanded ia).
      ja: (k,) col of each lower slot. al/au: (k,) values. x: (n,) source.
      num_symmetric: if True, au is ignored and al is used for the upper
        half (the paper's one-fewer-load optimization for numerically
        symmetric matrices).
    Returns: (n,) y.
    """
    upper = al if num_symmetric else au
    row_idx = row_idx.long()
    ja = ja.long()
    y = ad * x[:n]
    y = y + segment_sum(al * x[ja], row_idx, n)
    y = y + segment_sum(upper * x[row_idx], ja, n)
    return y


def _rect_rows(M: CSRC) -> torch.Tensor:
    row_r = np.repeat(np.arange(M.n, dtype=np.int32), np.diff(_np(M.iar)))
    return torch.from_numpy(row_r).to(M.ad.device)


def csrc_spmv(M: CSRC, x, use_numeric_symmetry: bool = True,
              row_idx=None):
    """CSRC product from the container (handles the rectangular tail).
    ``row_idx`` is the expanded ``ia`` on the matrix's device, for callers
    that apply the same matrix repeatedly; derived per call when absent."""
    num_sym = bool(M.numerically_symmetric and use_numeric_symmetry)
    row_idx = row_index(M) if row_idx is None else row_idx
    y = csrc_spmv_arrays(M.ad, row_idx, M.ja, M.al, M.au, x, M.n, num_sym)
    if M.jar.shape[0]:
        y = y + segment_sum(M.ar * x[M.n + M.jar.long()], _rect_rows(M), M.n)
    return y


def csrc_spmv_transpose(M: CSRC, x):
    """A^T x — paper §5: swap al and au, same cost."""
    return csrc_spmv_arrays(M.ad, row_index(M), M.ja, M.au, M.al, x, M.n,
                            False)


def colorful_spmv(M: CSRC, x, coloring):
    """The paper's colorful method: colors are processed serially; within a
    color the write targets are disjoint, so each color's scatter is one
    ``index_add_`` pair.  x of shape (n,) or (n, r).  The per-color slot
    batches are normally precomputed once in the schedule artifact; this
    wrapper derives them from ``coloring`` for ad-hoc use."""
    from repro_torch.core.schedule import color_slot_batches, colorful_apply
    slots, ptr = color_slot_batches(M, coloring)
    return colorful_apply(M, x, slots, ptr)


def csr_spmv_arrays(row_idx, ja, a, x, n: int):
    """Plain CSR product (the paper's baseline): y[i] += a[p] * x[ja[p]]."""
    return segment_sum(a * x[ja.long()], row_idx, n)


def csr_from_csrc(M: CSRC):
    """Expand a CSRC container to full CSR arrays (baseline construction).

    Returns numpy (row_idx, col_idx, vals) covering diag + both halves +
    tail, sorted by row — what a standard CSR of the same matrix would
    store."""
    ros = row_of_slot(M)
    ja = _np(M.ja)
    rows = [np.arange(M.n, dtype=np.int32), ros, ja]
    cols = [np.arange(M.n, dtype=np.int32), ja, ros]
    vals = [_np(M.ad), _np(M.al), _np(M.au)]
    if M.jar.shape[0]:
        row_r = np.repeat(np.arange(M.n, dtype=np.int32),
                          np.diff(_np(M.iar)))
        rows.append(row_r)
        cols.append(_np(M.jar) + M.n)
        vals.append(_np(M.ar))
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = np.concatenate(vals)
    order = np.lexsort((cols, rows))
    return rows[order], cols[order], vals[order]


def csrc_spmm(M: CSRC, X, use_numeric_symmetry: bool = True,
              row_idx=None):
    """Multi-RHS product: X is (m, B), returns (n, B)."""
    row_idx = (row_index(M) if row_idx is None else row_idx).long()
    ja = M.ja.long()
    num_sym = bool(M.numerically_symmetric and use_numeric_symmetry)
    upper = M.al if num_sym else M.au
    y = M.ad[:, None] * X[:M.n]
    y = y + segment_sum(M.al[:, None] * X[ja], row_idx, M.n)
    y = y + segment_sum(upper[:, None] * X[row_idx], ja, M.n)
    if M.jar.shape[0]:
        y = y + segment_sum(M.ar[:, None] * X[M.n + M.jar.long()],
                            _rect_rows(M), M.n)
    return y
