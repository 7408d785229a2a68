"""Fused streaming forms of the CSRC products: the block-ELL grids
(rectangular and flat) and the nnz-split chunks.

The same per-tile-window computation as the streaming kernels, evaluated
as one fused expression over all (tile, slot) pairs: one gather + one
``index_add_`` per product term, then the unchanged ``overlap_add``
accumulation.  In this package these fused forms **are the plain PyTorch
versions** of the streaming CUDA kernels (K1 in csrc_spmv.py, K2 in
csrc_spmm.py, K5/K6 in csrc_spmv_flat.py): the CPU tests run them, and on
the card the kernels are held against them.  The flat grid differs only in
where a slot row's tile comes from: ``tile_of_step`` instead of the row
index of the rectangular stream.  The nnz-split form (the plain version of
K9/K10 in csrc_spmv_nnzsplit.py) is one gather and one segment sum over
``chunk·r_pad + lrow`` into the (C, r_pad) partials.

``blockell_spmv_stream`` / ``blockell_spmm_stream`` (``kernel`` path),
``flat_spmv_stream`` / ``flat_spmm_stream`` (``flat`` path) and
``nnzsplit_spmv_stream`` / ``nnzsplit_spmm_stream`` (``nnzsplit`` path) are
the executors a ``variant='stream'`` plan binds.  They dispatch on where the
tensor lives: a CUDA tensor launches K1/K2, K5/K6 or K9/K10, a CPU tensor
takes the fused form.

Sentinel discipline (shared with the packer): padded slots carry value 0
and column sentinel ``w_pad``; the fused gather clamps the sentinel into
range (0 · x = 0) and the fused scatter maps it to segment id NT·W, one
past the last real segment, which the segment sum drops — never an add
into a neighboring tile's window.
"""
from __future__ import annotations

import torch

from repro_torch.core.blockell import BlockEll, pad_x
from repro_torch.kernels import csrc_spmm as rect_mm_mod
from repro_torch.kernels import csrc_spmv as rect_mod
from repro_torch.kernels import csrc_spmv_flat as flat_mod
from repro_torch.kernels import csrc_spmv_nnzsplit as nz_mod
from repro_torch.kernels.ref import segment_sum


def _windowed_indices(tile, cols, rows, *, tm: int, w_pad: int, nt: int):
    """Global padded-x gather indices and per-tile segment ids.

    ``tile`` is the row tile of each slot row ((G, 1) int64); ``cols`` /
    ``rows`` are the (G, S) window-local index streams.  The x window of
    tile b starts at padded coordinate (b+1)·tm, so global gather index =
    (b+1)·tm + local; window segment id = b·W + local with the column
    sentinel (== W) routed to the drop segment NT·W.
    """
    xbase = (tile + 1) * tm
    segbase = tile * w_pad
    gcols = (xbase + cols).reshape(-1)
    grows = (xbase + rows).reshape(-1)
    seg_rows = (segbase + rows).reshape(-1)
    seg_cols = torch.where(cols >= w_pad,
                           torch.full_like(cols, nt * w_pad),
                           segbase + cols).reshape(-1)
    return gcols, grows, seg_rows, seg_cols


def _windowed_product(x_full, vl, vu, gcols, grows, seg_rows, seg_cols,
                      *, nt: int, w_pad: int):
    """The fused streaming core: two gathers, two segment sums, (NT, W[, B])."""
    limit = x_full.shape[0] - 1
    xg = x_full[torch.clamp(gcols, max=limit)]
    xi = x_full[grows]
    if x_full.ndim == 2:
        vl, vu = vl[:, None], vu[:, None]
    c_rows = (vl * xg).to(torch.float32)
    c_cols = (vu * xi).to(torch.float32)
    wins = segment_sum(c_rows, seg_rows, nt * w_pad)
    wins = wins + segment_sum(c_cols, seg_cols, nt * w_pad)
    return wins.reshape((nt, w_pad) + tuple(x_full.shape[1:]))


def _diag_windows(ad, x_full, *, nt: int, tm: int, w_pad: int):
    xt = x_full[w_pad:w_pad + nt * tm]
    adf = ad.to(torch.float32).reshape(nt, tm)
    if x_full.ndim == 2:
        diag = adf[..., None] * xt.reshape(nt, tm, -1)
    else:
        diag = adf * xt.reshape(nt, tm)
    out = torch.zeros((nt, w_pad) + tuple(x_full.shape[1:]),
                      dtype=torch.float32, device=x_full.device)
    out[:, w_pad - tm:] = diag
    return out


def _rect_streams(pack: BlockEll):
    nt = pack.vals_l.shape[0]
    tile = torch.arange(nt, dtype=torch.int64,
                        device=pack.vals_l.device)[:, None]
    cols = pack.col_local.to(torch.int64)
    rows = pack.row_in_win.to(torch.int64)
    vl = pack.vals_l.reshape(-1)
    vu = vl if pack.num_symmetric else pack.vals_u.reshape(-1)
    idx = _windowed_indices(tile, cols, rows, tm=pack.tm,
                            w_pad=pack.w_pad, nt=nt)
    return nt, vl, vu, idx


def windows_fused(pack: BlockEll, x: torch.Tensor) -> torch.Tensor:
    """Per-tile windows (NT, W) for x (n,), (NT, W, B) for x (n, B), by the
    fused form — the plain version of K1 and K2."""
    nt, vl, vu, idx = _rect_streams(pack)
    x_full = pad_x(pack, x.to(torch.float32))
    wins = _windowed_product(x_full, vl, vu, *idx, nt=nt, w_pad=pack.w_pad)
    return wins + _diag_windows(pack.ad, x_full, nt=nt, tm=pack.tm,
                                w_pad=pack.w_pad)


def blockell_spmv_stream(pack: BlockEll, x: torch.Tensor,
                         k_step_sublanes: int = 8) -> torch.Tensor:
    return rect_mod.blockell_spmv(pack, x, k_step_sublanes=k_step_sublanes,
                                  variant="stream")


def blockell_spmm_stream(pack: BlockEll, X: torch.Tensor,
                         k_step_sublanes: int = 8) -> torch.Tensor:
    return rect_mm_mod.blockell_spmm(pack, X,
                                     k_step_sublanes=k_step_sublanes,
                                     variant="stream")


def _flat_streams(pack):
    tile = pack.tile_of_step.to(torch.int64)[:, None]
    cols = pack.col_local.to(torch.int64)
    rows = pack.row_in_win.to(torch.int64)
    vl = pack.vals_l.reshape(-1)
    vu = vl if pack.num_symmetric else pack.vals_u.reshape(-1)
    idx = _windowed_indices(tile, cols, rows, tm=pack.tm,
                            w_pad=pack.w_pad, nt=pack.nt)
    return vl, vu, idx


def flat_windows_fused(pack, x: torch.Tensor) -> torch.Tensor:
    """Per-tile windows (NT, W) for x (n,), (NT, W, B) for x (n, B), of a
    flat pack by the fused form — the plain version of K5 and K6."""
    vl, vu, idx = _flat_streams(pack)
    x_full = pad_x(pack, x.to(torch.float32))
    wins = _windowed_product(x_full, vl, vu, *idx, nt=pack.nt,
                             w_pad=pack.w_pad)
    return wins + _diag_windows(pack.ad, x_full, nt=pack.nt, tm=pack.tm,
                                w_pad=pack.w_pad)


def flat_spmv_stream(pack, x: torch.Tensor) -> torch.Tensor:
    return flat_mod.flat_spmv(pack, x, variant="stream")


def flat_spmm_stream(pack, X: torch.Tensor) -> torch.Tensor:
    return flat_mod.flat_spmm(pack, X, variant="stream")


def nnzsplit_partials_fused(pack, x: torch.Tensor) -> torch.Tensor:
    """Per-chunk partials (C, r_pad) for x (n,), (C, r_pad, B) for x (n, B),
    by the fused form: one gather of ``x[src]``, one segment sum over
    ``chunk·r_pad + lrow`` — the plain version of K9 and K10."""
    nc, r_pad = pack.num_chunks, pack.r_pad
    x = x.to(torch.float32)
    seg = (torch.arange(nc, dtype=torch.int64, device=x.device)[:, None]
           * r_pad + pack.lrow.to(torch.int64)).reshape(-1)
    xg = x[pack.src.reshape(-1).to(torch.int64)]
    vals = pack.vals.reshape(-1).to(torch.float32)
    c = vals[:, None] * xg if x.ndim == 2 else vals * xg
    partial = segment_sum(c, seg, nc * r_pad)
    return partial.reshape((nc, r_pad) + tuple(x.shape[1:]))


def nnzsplit_spmv_stream(pack, x: torch.Tensor) -> torch.Tensor:
    return nz_mod.nnzsplit_spmv(pack, x, variant="stream")


def nnzsplit_spmm_stream(pack, X: torch.Tensor) -> torch.Tensor:
    return nz_mod.nnzsplit_spmm(pack, X, variant="stream")
