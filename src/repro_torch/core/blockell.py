"""Block-ELL packing of a CSRC matrix for the windowed kernels.

The paper's per-thread row ranges become per-*tile* row ranges; the paper's
"effective range" of a thread becomes the tile's **window** — a contiguous
slice of x/y that covers every column the tile touches.  Windows are
uniform-width and end-aligned to the tile's last row, so the window start
is an affine function of the tile id:

    window(b) = [ (b+1)·TM - W,  (b+1)·TM )       (original coordinates)

W = round_up(TM + bandwidth, max(128, TM)).  This holds because CSRC stores
only the lower triangle: every stored column j of row i satisfies
i - band <= j <= i.

Slots are padded per row-tile to a common count S (multiple of the k-step),
ELL-style.  Padded slots carry value 0, the sentinel column W and the row
W-1, and trail every real slot of their tile (checked by
:func:`check_slot_order`); the one-hot kernels add nothing for them on
either side.  Their bytes are the layout's (:func:`padding_bytes`).

Layout (NT = ceil(n / TM) row tiles, S slots per tile):

    vals_l     (NT, S)  f32|bf16   lower values (diag excluded)
    vals_u     (NT, S)  f32|bf16   aligned upper values (== vals_l if
                                   numerically symmetric)
    col_local  (NT, S)  i32|i16    j - win_lo(b)   in [0, W)   (W = sentinel)
    row_in_win (NT, S)  i32|i16    i - win_lo(b)   in [W-TM, W)
    ad         (NT, TM) f32|bf16   diagonal, row-tiled

The geometry, dtypes and fill order are those of the JAX package's pack,
array for array, so schedule artifacts are interchangeable between the two
packages.  The 128 in the window rounding and the k-step is the pack unit
of that shared format, not a property of the card.

Packing is numpy on the host; the pack holds host tensors until
``BlockEll.to(device)`` binds it to an executor's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from .csrc import CSRC, _np, bandwidth, row_of_slot

_STREAMS = ("vals_l", "vals_u", "col_local", "row_in_win", "ad")


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class BlockEll:
    n: int
    tm: int
    nt: int
    w_pad: int
    s: int                      # padded slots per tile
    vals_l: torch.Tensor        # (NT, S)
    vals_u: torch.Tensor        # (NT, S)  (== vals_l when num_symmetric)
    col_local: torch.Tensor     # (NT, S)
    row_in_win: torch.Tensor    # (NT, S)
    ad: torch.Tensor            # (NT, TM)
    num_symmetric: bool
    pad_ratio: float            # NT*S / k  (ELL padding overhead; 1.0 = none)

    @property
    def n_pad(self) -> int:
        return self.nt * self.tm

    @property
    def device(self) -> torch.device:
        return self.vals_l.device

    def to(self, device) -> "BlockEll":
        """The same pack with its streams on ``device``.  ``vals_u`` keeps
        aliasing ``vals_l`` for numerically symmetric packs (one copy)."""
        device = torch.device(device)
        if all(getattr(self, f).device == device for f in _STREAMS):
            return self
        moved = {f: getattr(self, f).to(device).contiguous()
                 for f in _STREAMS if f != "vals_u"}
        moved["vals_u"] = (moved["vals_l"] if self.vals_u is self.vals_l
                           else self.vals_u.to(device).contiguous())
        return dataclasses.replace(self, **moved)

    def streamed_bytes(self, nrhs: int = 1) -> int:
        """Bytes one product must move through device memory: values +
        indices + the x vector + the window partials, with the x and
        window terms ``nrhs`` wide for a multi-RHS product."""
        def nbytes(a):
            return a.numel() * a.element_size()
        b = nbytes(self.vals_l)
        if not self.num_symmetric:
            b += nbytes(self.vals_u)
        b += nbytes(self.col_local) + nbytes(self.row_in_win)
        b += nbytes(self.ad)
        b += (self.n_pad + self.w_pad) * 4 * nrhs     # x (windows overlap-read)
        b += self.nt * self.w_pad * 4 * nrhs          # window partials out
        return b


def _padding(col_local: torch.Tensor, w_pad: int) -> torch.Tensor:
    """The padded slots: those whose column lies outside [0, W)."""
    return (col_local < 0) | (col_local >= w_pad)


def padding_bytes(pack_) -> int:
    """Bytes of ``pack_.streamed_bytes(nrhs)`` (a :class:`BlockEll` or a
    ``FlatBlockEll``) that its padded slots take in the value and index
    streams: the layout's cost, not the product's.  The product itself
    moves ``streamed_bytes(nrhs) - padding_bytes``."""
    streams = [pack_.vals_l, pack_.col_local, pack_.row_in_win]
    if not pack_.num_symmetric:
        streams.append(pack_.vals_u)
    pad = int(_padding(pack_.col_local, pack_.w_pad).sum())
    return pad * sum(a.element_size() for a in streams)


def check_slot_order(row_in_win: torch.Tensor, col_local: torch.Tensor,
                     w_pad: int) -> None:
    """Raise ValueError unless every row of the slot streams — a row tile's
    S slots on the rectangular grid, a k-step on the flat grid — keeps
    ``row_in_win`` non-decreasing and its padding (a column outside
    [0, W)) after all of its real slots.  The one-hot kernels (K3/K4,
    K7/K8) find a window row's real slots as one run of the staged k-step;
    every packer writes the slots row-major, padding (row W-1, column W)
    last.  Called where a pack is built, loaded or converted, never by a
    value refresh or a device move: they change no index stream."""
    rows = row_in_win.reshape(row_in_win.shape[0], -1)
    if bool((rows[:, 1:] < rows[:, :-1]).any()):
        raise ValueError("row_in_win must be non-decreasing within each "
                         "tile and k-step (row-major slots)")
    pad = _padding(col_local.reshape(col_local.shape[0], -1), w_pad)
    if bool((pad[:, :-1] & ~pad[:, 1:]).any()):
        raise ValueError("padding slots (column outside the window) must "
                         "follow every real slot of a tile and k-step")


def _slot_positions(ros: np.ndarray, tm: int, nt: int):
    """(tile, position-in-tile) of every lower slot.  Slots are row-major,
    so a tile's slots are consecutive and the position is the slot index
    minus the tile's first slot — the fill order of a stable sort by tile."""
    tile = ros // tm
    first = np.searchsorted(tile, np.arange(nt))
    pos = np.arange(ros.shape[0], dtype=np.int64) - first[tile]
    return tile, pos


def pack(M: CSRC, tm: int = 128, k_step: int = 1024,
         w_cap: int = 4096, dtype=torch.float32,
         index_dtype=torch.int32) -> BlockEll:
    """Pack a square CSRC matrix into block-ELL tiles.

    Raises ValueError when the matrix band is too wide for the windowed
    kernel (w_pad would exceed ``w_cap``) — callers fall back to the
    segment path (ref.csrc_spmv), mirroring the paper's finding that
    unbanded matrices (cage15, F1) defeat locality-based strategies.

    ``index_dtype=torch.int16`` halves the index stream (local window
    offsets always fit: w_pad <= w_cap << 32767) — the paper's 16-bit
    index compression (§1, Williams et al.) applied at tile scope.
    """
    if not M.is_square:
        raise ValueError("block-ELL packs the square CSRC part only")
    n = M.n
    band = bandwidth(M)
    # multiple of 128 (pack unit) AND of tm (overlap-add group size)
    w_pad = _round_up(tm + band, max(128, tm))
    if index_dtype == torch.int16 and w_pad + 1 > 32767:
        raise ValueError(f"window {w_pad} overflows int16 indices")
    if w_pad > w_cap:
        raise ValueError(
            f"bandwidth {band} needs window {w_pad} > cap {w_cap}; "
            "use the segment-sum path")
    nt = max(1, -(-n // tm))
    ros = row_of_slot(M)
    ja = _np(M.ja)
    t_idx, p_idx = _slot_positions(ros, tm, nt)
    counts = np.bincount(t_idx, minlength=nt)
    s = max(k_step, _round_up(int(counts.max()) if counts.size else k_step,
                              k_step))

    vals_l = np.zeros((nt, s), dtype=np.float32)
    vals_l[t_idx, p_idx] = _np(M.al)
    col_local = np.full((nt, s), w_pad, dtype=np.int32)       # sentinel
    row_in_win = np.full((nt, s), w_pad - 1, dtype=np.int32)  # inert
    win_lo = ((np.arange(nt) + 1) * tm - w_pad)[t_idx]        # original coords
    col_local[t_idx, p_idx] = ja - win_lo
    row_in_win[t_idx, p_idx] = ros - win_lo

    ad = np.zeros((nt, tm), dtype=np.float32)
    ad.reshape(-1)[:n] = _np(M.ad)

    vl_t = torch.from_numpy(vals_l).to(dtype)
    if M.numerically_symmetric:
        vu_t = vl_t
    else:
        vals_u = np.zeros((nt, s), dtype=np.float32)
        vals_u[t_idx, p_idx] = _np(M.au)
        vu_t = torch.from_numpy(vals_u).to(dtype)

    k = max(1, int(ja.shape[0]))
    col_t = torch.from_numpy(col_local).to(index_dtype)
    row_t = torch.from_numpy(row_in_win).to(index_dtype)
    check_slot_order(row_t, col_t, w_pad)
    return BlockEll(
        n=n, tm=tm, nt=nt, w_pad=w_pad, s=s,
        vals_l=vl_t, vals_u=vu_t,
        col_local=col_t, row_in_win=row_t,
        ad=torch.from_numpy(ad).to(dtype),
        num_symmetric=bool(M.numerically_symmetric),
        pad_ratio=float(nt * s) / k,
    )


def refresh_values(pack_: BlockEll, M: CSRC) -> BlockEll:
    """Refill a pack's value streams (vals_l/vals_u/ad) from a matrix with
    **identical structure** — the FEM time-stepping fast path: no window
    recomputation, no index-stream rebuild.  The refreshed streams land on
    the device the pack lives on."""
    if not (M.is_square and M.n == pack_.n):
        raise ValueError("structure mismatch")
    if bool(M.numerically_symmetric) != pack_.num_symmetric:
        raise ValueError(
            "numeric symmetry changed; the pack layout streams vals_u "
            "conditionally — rebuild instead of refreshing")
    tile, pos = _slot_positions(row_of_slot(M), pack_.tm, pack_.nt)
    vdtype, dev = pack_.vals_l.dtype, pack_.vals_l.device

    def stream(values):
        a = np.zeros((pack_.nt, pack_.s), dtype=np.float32)
        a[tile, pos] = _np(values)
        return torch.from_numpy(a).to(device=dev, dtype=vdtype)

    vals_l = stream(M.al)
    # vals_u aliases vals_l for symmetric packs; skip the fill
    vals_u = vals_l if pack_.num_symmetric else stream(M.au)
    ad = np.zeros((pack_.nt, pack_.tm), dtype=np.float32)
    ad.reshape(-1)[:pack_.n] = _np(M.ad)
    return dataclasses.replace(
        pack_, vals_l=vals_l, vals_u=vals_u,
        ad=torch.from_numpy(ad).to(device=pack_.ad.device,
                                   dtype=pack_.ad.dtype))


def pad_x(pack_, x: torch.Tensor) -> torch.Tensor:
    """Left-pad by W and right-pad to NT*TM (window coordinates); x may be
    (n,) or (n, B)."""
    out = torch.zeros((pack_.w_pad + pack_.n_pad,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    out[pack_.w_pad:pack_.w_pad + pack_.n] = x
    return out


def overlap_add(pack_, wins: torch.Tensor) -> torch.Tensor:
    """Accumulate per-tile windows into y — the paper's *effective*
    accumulation step, as overlap-add (hop TM, frame W).

    Windows are decomposed into r = W/TM groups of stride-r tiles; windows
    inside one group are disjoint and back to back, so each group is one
    reshape plus an in-place add on a slice of y (no scatter, and a fixed
    order of additions: group 0 first).  Takes (NT, W) windows for y (n,)
    and (NT, W, B) windows for y (n, B).  The ``kernel`` and ``flat``
    paths' accumulation step: an ``spmv.accumulate`` range
    (``obs.trace_range``)."""
    nt, w = wins.shape[:2]
    tm = pack_.tm
    r = w // tm
    if w % tm != 0:
        raise ValueError("w_pad must be a multiple of tm for overlap-add")
    tail = tuple(wins.shape[2:])
    with obs.trace_range("spmv.accumulate"):
        y = torch.zeros((pack_.w_pad + pack_.n_pad + w,) + tail,
                        dtype=wins.dtype, device=wins.device)
        for g in range(r):
            group = wins[g::r]                   # (ceil((nt-g)/r), W[, B])
            ng = group.shape[0]
            if ng == 0:
                continue
            # window b starts (padded coords) at (b+1)*tm; group g holds
            # tiles b = g, g+r, g+2r, ... whose windows are back-to-back
            # (stride r*tm = w)
            start = (g + 1) * tm
            y[start:start + ng * w] += group.reshape((ng * w,) + tail)
        return y[pack_.w_pad:pack_.w_pad + pack_.n]


def overlap_add_mm(pack_, wins: torch.Tensor) -> torch.Tensor:
    """Multi-RHS overlap-add: windows (NT, W, B) -> y (n, B)."""
    if wins.ndim != 3:
        raise ValueError("overlap_add_mm takes (NT, W, B) windows")
    return overlap_add(pack_, wins)


def move_layout(lay, names, device):
    """``lay`` (a shard layout) with its tensor fields ``names`` on
    ``device``; a ``vals_u`` that aliases ``vals_l`` (a numerically
    symmetric pack) keeps aliasing it."""
    device = torch.device(device)
    if all(getattr(lay, f).device == device for f in names):
        return lay
    moved = {f: getattr(lay, f).to(device).contiguous() for f in names
             if f != "vals_u"}
    if "vals_u" in names:
        moved["vals_u"] = (moved["vals_l"] if lay.vals_u is lay.vals_l
                           else lay.vals_u.to(device).contiguous())
    return dataclasses.replace(lay, **moved)
