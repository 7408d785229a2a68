"""Flat-grid block-ELL CSRC products: CUDA kernels K5-K8.

The rectangular grid (csrc_spmv.py) pads every row tile to the slot count
of the densest tile, so a skewed matrix — FEM meshes with mixed element
sizes or local refinement — streams mostly padding.  Here each row tile
gets only the k-steps it needs:

  * slots are packed flat as (total_steps, step), step = ks·128 slots;
  * ``tile_of_step`` names each step's row tile and ``first_of_tile`` flags
    a tile's first step; a tile's steps are consecutive and every tile has
    at least one, so its output window is always initialized;
  * the kernels take each tile's step range from ``step_start`` (NT+1,),
    derived once from those two arrays when a pack is built, loaded or
    converted, and validated there — a malformed pack raises before any
    launch.  It is not serialized: the npz layout stays the JAX package's
    ``(total, ks, 128)`` ``flat_*`` arrays.

Geometry (``w_pad``, sentinels, dtypes, fill order) is that of the JAX
package's ``pack_flat``, array for array.

Kernels, selected by ``variant``:

  'stream'  K5 (x (n,)), csrc/flat_spmv_stream.cu, and K6 (X (n, B)),
            csrc/flat_spmm_stream.cu — replace the TPU bodies
            kernels/csrc_spmv_flat.py::_kernel_stream / _kernel_mm_stream.
            Bound by bytes; one block per tile over the tile's steps,
            shared-memory window.  K5 sums each run of equal rows per lane
            (four consecutive slots) and per warp (shuffles,
            csrc/warp_scan.cuh) and adds it once, the column half one
            atomic add per slot; K6 is the same body with a loop over the
            columns (slots read once per pass, runs found once per pass).
            Both need the slot order checked below, as K7/K8 do.
  'onehot'  K7, csrc/flat_spmv_onehot.cu, and K8, csrc/flat_spmm_onehot.cu
            — replace ::_kernel / ::_kernel_mm.  One block per tile (and
            column tile) over the tile's steps, the body of
            csrc/window_runs.cuh: per step, each window row sums its run of
            real slots (the step's rows never decrease) and each column its
            bucket from a stable counting sort by column, in slot order,
            and the window takes the two sums — the TPU body's order, no
            float atomics, bit-identical reruns.  The slot order (rows
            non-decreasing, padding last) is checked with the step ranges
            (``blockell.check_slot_order``, shared with K3/K4's packs).

Their plain PyTorch versions — the fused gather + ``index_add_`` form
(``csrc_spmv_stream.flat_windows_fused``) and the step-by-step one-hot form
(:func:`flat_windows_onehot_plain`) — are taken only for a CPU tensor; a
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.blockell import (_round_up, check_slot_order,
                                       move_layout, overlap_add, pad_x)
from repro_torch.core.csrc import CSRC, _np, bandwidth, row_of_slot
from repro_torch.core.partition import (halo_diagonal, halo_geometry,
                                        halo_slot_spans, shard_diagonal)
from repro_torch.core.plan import LANES, VARIANTS
from . import _build
from ._build import _I, _P
from .csrc_spmm import column_tile
from .csrc_spmv import _operand

K5 = _build.register(_build.Kernel(
    "flat_spmv_stream",
    [_P] * 8 + [_I] * 8 + [_P],
    replaces="src/repro/kernels/csrc_spmv_flat.py:232"))
K7 = _build.register(_build.Kernel(
    "flat_spmv_onehot",
    [_P] * 8 + [_I] * 8 + [_P],
    replaces="src/repro/kernels/csrc_spmv_flat.py:190"))
K6 = _build.register(_build.Kernel(
    "flat_spmm_stream",
    [_P] * 8 + [_I] * 10 + [_P],
    replaces="src/repro/kernels/csrc_spmv_flat.py:345"))
K8 = _build.register(_build.Kernel(
    "flat_spmm_onehot",
    [_P] * 8 + [_I] * 10 + [_P],
    replaces="src/repro/kernels/csrc_spmv_flat.py:302"))

_STREAMS = ("vals_l", "vals_u", "col_local", "row_in_win", "ad",
            "tile_of_step", "first_of_tile", "step_start")


def step_ranges(tile_of_step, first_of_tile, nt: int) -> torch.Tensor:
    """(NT+1,) int32 host tensor: row tile b owns the k-steps
    ``[out[b], out[b+1])``.  Raises ValueError unless each tile's steps are
    contiguous and in tile order, every tile has at least one step, and
    ``first_of_tile`` flags exactly each tile's first step."""
    tile = _np(tile_of_step).astype(np.int64)
    first = _np(first_of_tile)
    if tile.ndim != 1 or first.shape != tile.shape:
        raise ValueError("tile_of_step and first_of_tile must be equal-length "
                         "vectors")
    if tile.size == 0 or tile.min() < 0 or tile.max() >= nt:
        raise ValueError(f"tile_of_step must name tiles in [0, {nt})")
    if (np.diff(tile) < 0).any():
        raise ValueError("the k-steps of a row tile must be contiguous")
    counts = np.bincount(tile, minlength=nt)
    if (counts == 0).any():
        raise ValueError("every row tile needs at least one k-step")
    starts = np.zeros(nt + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    want = np.zeros(tile.size, dtype=first.dtype)
    want[starts[:-1]] = 1
    if not np.array_equal(first, want):
        raise ValueError("first_of_tile must flag each tile's first k-step")
    if starts[-1] >= 2 ** 31:
        raise ValueError("too many k-steps for 32-bit step indices")
    return torch.from_numpy(starts.astype(np.int32))


@dataclasses.dataclass(frozen=True)
class FlatBlockEll:
    n: int
    tm: int
    nt: int
    w_pad: int
    total_steps: int            # Σ_b nk_b  (k-steps overall)
    ks: int                     # 128-slot units per k-step
    vals_l: torch.Tensor        # (total, step)
    vals_u: torch.Tensor        # (total, step)  (== vals_l when num_symmetric)
    col_local: torch.Tensor     # (total, step)
    row_in_win: torch.Tensor    # (total, step)
    ad: torch.Tensor            # (NT, TM)
    tile_of_step: torch.Tensor  # (total,) int32 — row tile of each k-step
    first_of_tile: torch.Tensor  # (total,) int32 — 1 on a tile's first step
    num_symmetric: bool
    pad_ratio: float            # total·step / k
    # (NT+1,) int32, derived from tile_of_step/first_of_tile (step_ranges)
    step_start: Optional[torch.Tensor] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.step_start is None:
            check_slot_order(self.row_in_win, self.col_local, self.w_pad)
            starts = step_ranges(self.tile_of_step, self.first_of_tile,
                                 self.nt)
            object.__setattr__(self, "step_start",
                               starts.to(self.tile_of_step.device))

    @property
    def step(self) -> int:
        return self.ks * LANES

    @property
    def n_pad(self) -> int:
        return self.nt * self.tm

    @property
    def device(self) -> torch.device:
        return self.vals_l.device

    def to(self, device) -> "FlatBlockEll":
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
        window terms ``nrhs`` wide — the terms of
        ``BlockEll.streamed_bytes``."""
        def nbytes(a):
            return a.numel() * a.element_size()
        b = nbytes(self.vals_l)
        if not self.num_symmetric:
            b += nbytes(self.vals_u)
        b += nbytes(self.col_local) + nbytes(self.row_in_win)
        b += nbytes(self.ad)
        b += (self.n_pad + self.w_pad) * 4 * nrhs
        b += self.nt * self.w_pad * 4 * nrhs
        return b


def _step_layout(ros: np.ndarray, *, nt: int, tm: int, step: int):
    """Flat position of every lower slot and the step count of every tile.

    Slots are row-major, so a tile's slots are consecutive: slot q of tile
    t (q = slot − first slot of t) lands in step ``starts[t] + q // step``
    at lane ``q % step``, i.e. at flat position ``starts[t]·step + q`` —
    the order the JAX package's per-slot fill loop produces."""
    tile = ros // tm
    counts = np.bincount(tile, minlength=nt)
    nk = np.maximum(1, -(-counts // step))          # k-steps per tile
    starts = np.zeros(nt + 1, dtype=np.int64)
    np.cumsum(nk, out=starts[1:])
    first_slot = np.searchsorted(tile, np.arange(nt))
    offset = starts[:-1] * step - first_slot        # per tile
    flat = np.arange(ros.shape[0], dtype=np.int64) + offset[tile]
    return tile, flat, nk, starts


def _flat_arrays(ros, ja, al, au, *, nt: int, tm: int, w_pad: int,
                 step: int, pad_steps_to: Optional[int] = None):
    """Fill the flat step arrays for one slot set (rows and columns global
    or shard-local: every slot's column lies inside its tile's window);
    every tile gets at least one k-step.  ``pad_steps_to`` appends inert
    trailing steps — zero values, sentinel indices, assigned to the last
    tile with ``first_of_tile`` 0 — to equalize the shards of a stacked
    layout.  Returns (vals_l, vals_u, col_local, row_in_win) as
    (steps, step) arrays, tile_of_step, first_of_tile and the real step
    count."""
    tile, flat, nk, starts = _step_layout(ros, nt=nt, tm=tm, step=step)
    total = int(starts[-1])
    steps = total if pad_steps_to is None else int(pad_steps_to)
    if steps < total:
        raise ValueError(f"pad_steps_to {steps} < required steps {total}")
    win_lo = ((np.arange(nt, dtype=np.int64) + 1) * tm - w_pad)[tile]

    vals_l = np.zeros(steps * step, np.float32)
    vals_u = np.zeros(steps * step, np.float32)
    col_local = np.full(steps * step, w_pad, np.int32)       # sentinel
    row_in_win = np.full(steps * step, w_pad - 1, np.int32)  # inert
    vals_l[flat] = al
    vals_u[flat] = au
    col_local[flat] = ja - win_lo
    row_in_win[flat] = ros - win_lo
    tile_of_step = np.full(steps, nt - 1, np.int32)
    tile_of_step[:total] = np.repeat(np.arange(nt, dtype=np.int32), nk)
    first = np.zeros(steps, np.int32)
    first[starts[:-1]] = 1
    return (vals_l.reshape(steps, step), vals_u.reshape(steps, step),
            col_local.reshape(steps, step), row_in_win.reshape(steps, step),
            tile_of_step, first, total)


def _value_fill_steps(ros, al, au, *, nt, tm, step, steps, num_symmetric):
    """Value-only refill of the flat step arrays (same-structure refresh):
    the (step, lane) map is re-derived from the slot rows without touching
    an index stream.  Returns (vals_l, vals_u) of shape (steps, step);
    vals_u is vals_l when ``num_symmetric``."""
    vals_l = np.zeros(steps * step, np.float32)
    vals_u = vals_l if num_symmetric else np.zeros(steps * step, np.float32)
    if ros.shape[0]:
        _, flat, _, _ = _step_layout(ros, nt=nt, tm=tm, step=step)
        vals_l[flat] = al
        if not num_symmetric:
            vals_u[flat] = au
    return vals_l.reshape(steps, step), vals_u.reshape(steps, step)


def _diagonal(M: CSRC, nt: int, tm: int) -> np.ndarray:
    ad = np.zeros((nt, tm), np.float32)
    ad.reshape(-1)[:M.n] = _np(M.ad)
    return ad


def pack_flat(M: CSRC, tm: int = 128, ks: int = 8, w_cap: int = 4096,
              dtype=torch.float32, index_dtype=torch.int32) -> FlatBlockEll:
    """Per-tile-exact packing (no cross-tile ELL padding).

    ``dtype=torch.bfloat16`` halves the value streams (plan.value_dtype);
    ``index_dtype=torch.int16`` halves the index streams
    (plan.index_dtype).  Raises ValueError where the JAX package's packer
    refuses: a rectangular matrix, a window past ``w_cap``, or one that
    overflows int16 indices."""
    if not M.is_square:
        raise ValueError("the flat pack packs the square CSRC part only")
    n = M.n
    band = bandwidth(M)
    w_pad = _round_up(tm + band, max(128, tm))
    if index_dtype == torch.int16 and w_pad + 1 > 32767:
        raise ValueError(f"window {w_pad} overflows int16 indices")
    if w_pad > w_cap:
        raise ValueError(f"window {w_pad} > cap {w_cap}")
    nt = max(1, -(-n // tm))
    step = ks * LANES
    ros = row_of_slot(M)
    ja = _np(M.ja)
    (vals_l, vals_u, col_local, row_in_win, tile_of_step, first,
     total) = _flat_arrays(ros, ja, _np(M.al), _np(M.au), nt=nt, tm=tm,
                           w_pad=w_pad, step=step)
    vl_t = torch.from_numpy(vals_l).to(dtype)
    vu_t = (vl_t if M.numerically_symmetric
            else torch.from_numpy(vals_u).to(dtype))
    k = max(1, int(ja.shape[0]))
    return FlatBlockEll(
        n=n, tm=tm, nt=nt, w_pad=w_pad, total_steps=total, ks=ks,
        vals_l=vl_t, vals_u=vu_t,
        col_local=torch.from_numpy(col_local).to(index_dtype),
        row_in_win=torch.from_numpy(row_in_win).to(index_dtype),
        ad=torch.from_numpy(_diagonal(M, nt, tm)).to(dtype),
        tile_of_step=torch.from_numpy(tile_of_step),
        first_of_tile=torch.from_numpy(first),
        num_symmetric=bool(M.numerically_symmetric),
        pad_ratio=float(total * step) / k,
    )


def refresh_flat_values(pack: FlatBlockEll, M: CSRC) -> FlatBlockEll:
    """Refill a flat pack's value streams from a same-structure matrix (FEM
    time stepping); no index stream or tile map is touched.  The refreshed
    streams land on the device the pack lives on."""
    if not (M.is_square and M.n == pack.n):
        raise ValueError("structure mismatch")
    if bool(M.numerically_symmetric) != pack.num_symmetric:
        raise ValueError(
            "numeric symmetry changed; rebuild instead of refreshing")
    vals_l, vals_u = _value_fill_steps(
        row_of_slot(M), _np(M.al), _np(M.au), nt=pack.nt, tm=pack.tm,
        step=pack.step, steps=pack.total_steps,
        num_symmetric=pack.num_symmetric)
    vdtype, dev = pack.vals_l.dtype, pack.vals_l.device
    vl = torch.from_numpy(vals_l).to(device=dev, dtype=vdtype)
    vu = vl if pack.num_symmetric else torch.from_numpy(vals_u).to(
        device=dev, dtype=vdtype)
    return dataclasses.replace(
        pack, vals_l=vl, vals_u=vu,
        ad=torch.from_numpy(_diagonal(M, pack.nt, pack.tm)).to(
            device=pack.ad.device, dtype=pack.ad.dtype))


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def flat_windows_stream_plain(pack: FlatBlockEll,
                              x: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 (x (n,)) and K6 (x (n, B)): the fused gather +
    ``index_add_`` form."""
    from .csrc_spmv_stream import flat_windows_fused
    return flat_windows_fused(pack, x)


def flat_windows_onehot_plain(pack: FlatBlockEll,
                              x: torch.Tensor) -> torch.Tensor:
    """Plain version of K7 (x (n,)) and K8 (x (n, B)), step by step as the
    TPU bodies run: explicit (S, W) one-hot masks per k-step, gather
    ``mask @ xw``, scatter ``maskᵀ @ contrib`` into the step's partial
    window, the diagonal on a tile's first step and ``out += win`` on later
    ones.  Steps are processed in chunks so the masks stay bounded; the
    partials join their tiles in step order (``index_add_``)."""
    from .csrc_spmv import _MASK_ELEMENTS
    nt, step, w_pad, tm = pack.nt, pack.step, pack.w_pad, pack.tm
    x_full = pad_x(pack, x.to(torch.float32))
    x2 = x_full[:, None] if x_full.ndim == 1 else x_full
    nrhs = x2.shape[1]
    dev = x2.device
    iota = torch.arange(w_pad, device=dev)
    out = torch.zeros((nt, w_pad, nrhs), dtype=torch.float32, device=dev)
    # every tile has a first step, where its window starts as the diagonal
    out[:, w_pad - tm:] = (pack.ad.to(torch.float32)[..., None]
                           * x2[w_pad:w_pad + nt * tm].reshape(nt, tm, nrhs))
    chunk = max(1, _MASK_ELEMENTS // (step * w_pad))
    for j0 in range(0, pack.total_steps, chunk):
        sl = slice(j0, min(pack.total_steps, j0 + chunk))
        tiles = pack.tile_of_step[sl].to(torch.int64)
        xw = x2[((tiles + 1) * tm)[:, None] + iota[None, :]]    # (T, W, B)
        cols = pack.col_local[sl].to(torch.int64)
        rows = pack.row_in_win[sl].to(torch.int64)
        vl = pack.vals_l[sl].to(torch.float32)
        vu = vl if pack.num_symmetric else pack.vals_u[sl].to(torch.float32)
        # one-hot over the window; the sentinel (== W) gives a zero row
        oh_cols = (cols[..., None] == iota).to(torch.float32)
        oh_rows = (rows[..., None] == iota).to(torch.float32)
        c_rows = vl[..., None] * (oh_cols @ xw)                 # al * x[ja]
        c_cols = vu[..., None] * (oh_rows @ xw)                 # au * x[i]
        win = oh_rows.transpose(1, 2) @ c_rows
        win = win + oh_cols.transpose(1, 2) @ c_cols
        out.index_add_(0, tiles, win)
    return out[..., 0] if x_full.ndim == 1 else out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _launch_operands(pack: FlatBlockEll, x: torch.Tensor, ndim: int):
    """Checked operands of a launch: x, the six stream pointers (five
    streams and step_start), and the (numerically symmetric, bf16 values,
    int16 indices) flags."""
    if not x.is_cuda:
        raise ValueError("the CUDA kernels take CUDA tensors; a CPU tensor "
                         "goes to the plain version")
    x = _operand(pack, x, ndim)
    bf16, i16 = _build.stream_flags(pack, (pack.total_steps, pack.step))
    ss = pack.step_start
    if (ss.dtype != torch.int32 or tuple(ss.shape) != (pack.nt + 1,)
            or ss.device != x.device or not ss.is_contiguous()):
        raise ValueError("pack.step_start must be a contiguous (NT+1,) int32 "
                         "tensor on the pack's device")
    pointers = (pack.vals_l.data_ptr(), pack.vals_u.data_ptr(),
                pack.col_local.data_ptr(), pack.row_in_win.data_ptr(),
                pack.ad.data_ptr(), ss.data_ptr())
    return x, pointers, (int(pack.num_symmetric), int(bf16), int(i16))


def flat_spmv_stream_cuda(pack: FlatBlockEll, x: torch.Tensor) -> torch.Tensor:
    """Launch K5; returns the (NT, W) windows.  The pack's rows must not
    decrease inside a k-step (checked with the step ranges where the pack
    was built, loaded or converted): K5 sums runs of equal rows per lane
    and warp before adding them.  The slot streams must be 16-byte aligned
    (``_build.check_lane_loads``)."""
    x, pointers, flags = _launch_operands(pack, x, ndim=1)
    _build.check_lane_loads(pack, pack.step)
    out = torch.empty((pack.nt, pack.w_pad), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        K5.launch(*pointers, x.data_ptr(), out.data_ptr(), pack.nt,
                  pack.step, pack.tm, pack.w_pad, pack.n, *flags)
    return out


def flat_spmv_onehot_cuda(pack: FlatBlockEll, x: torch.Tensor) -> torch.Tensor:
    """Launch K7; returns the (NT, W) windows."""
    x, pointers, flags = _launch_operands(pack, x, ndim=1)
    out = torch.empty((pack.nt, pack.w_pad), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        K7.launch(*pointers, x.data_ptr(), out.data_ptr(), pack.nt,
                  pack.step, pack.tm, pack.w_pad, pack.n, *flags)
    return out


def flat_spmm_stream_cuda(pack: FlatBlockEll, X: torch.Tensor) -> torch.Tensor:
    """Launch K6; returns the (NT, W, B) windows.  K6 is K5's body once per
    column: the same row order inside a k-step and 16-byte aligned slot
    streams (``_build.check_lane_loads``)."""
    X, pointers, flags = _launch_operands(pack, X, ndim=2)
    _build.check_lane_loads(pack, pack.step)
    nrhs = X.shape[1]
    out = torch.empty((pack.nt, pack.w_pad, nrhs), dtype=torch.float32,
                      device=X.device)
    with torch.cuda.device(X.device):
        K6.launch(*pointers, X.data_ptr(), out.data_ptr(), pack.nt,
                  pack.step, pack.tm, pack.w_pad, pack.n, nrhs,
                  column_tile(pack.w_pad, nrhs, 2), *flags)
    return out


def flat_spmm_onehot_cuda(pack: FlatBlockEll, X: torch.Tensor) -> torch.Tensor:
    """Launch K8; returns the (NT, W, B) windows."""
    X, pointers, flags = _launch_operands(pack, X, ndim=2)
    nrhs = X.shape[1]
    out = torch.empty((pack.nt, pack.w_pad, nrhs), dtype=torch.float32,
                      device=X.device)
    with torch.cuda.device(X.device):
        K8.launch(*pointers, X.data_ptr(), out.data_ptr(), pack.nt,
                  pack.step, pack.tm, pack.w_pad, pack.n, nrhs,
                  column_tile(pack.w_pad, nrhs, 2), *flags)
    return out


def _windows(pack: FlatBlockEll, x: torch.Tensor, ndim: int,
             variant: str) -> torch.Tensor:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if x.is_cuda:
        launch = {(1, "stream"): flat_spmv_stream_cuda,
                  (1, "onehot"): flat_spmv_onehot_cuda,
                  (2, "stream"): flat_spmm_stream_cuda,
                  (2, "onehot"): flat_spmm_onehot_cuda}[(ndim, variant)]
        return launch(pack, x)
    x = _operand(pack, x, ndim)
    if variant == "stream":
        return flat_windows_stream_plain(pack, x)
    return flat_windows_onehot_plain(pack, x)


def flat_spmv_windows(pack: FlatBlockEll, x: torch.Tensor,
                      variant: str = "onehot") -> torch.Tensor:
    """Per-tile windows (NT, W) before accumulation.  A CUDA ``x`` launches
    the variant's kernel (K5 / K7); a CPU ``x`` takes its plain version."""
    return _windows(pack, x, 1, variant)


def flat_spmv(pack: FlatBlockEll, x: torch.Tensor,
              variant: str = "onehot") -> torch.Tensor:
    """y = A @ x: kernel windows + effective accumulation."""
    return overlap_add(pack, flat_spmv_windows(pack, x, variant=variant))


def flat_spmm_windows(pack: FlatBlockEll, X: torch.Tensor,
                      variant: str = "onehot") -> torch.Tensor:
    """Per-tile windows (NT, W, B) before accumulation.  A CUDA ``X``
    launches the variant's kernel (K6 / K8); a CPU ``X`` takes its plain
    version."""
    return _windows(pack, X, 2, variant)


def flat_spmm(pack: FlatBlockEll, X: torch.Tensor,
              variant: str = "onehot") -> torch.Tensor:
    """Y = A @ X for X (n, B) — the multi-RHS flat-grid product (batched
    serving / block-Krylov shape); returns (n, B)."""
    return overlap_add(pack, flat_spmm_windows(pack, X, variant=variant))


# ---------------------------------------------------------------------------
# Shard layouts for the mesh strategies (core/distributed.py), built through
# core/schedule.py's memoized builders
# ---------------------------------------------------------------------------

_SHARD_STREAMS = ("vals_l", "vals_u", "col_local", "row_in_win", "ad",
                  "tile_of_step", "first_of_tile")


def _stack_shard_packs(slot_sets, *, nt, tm, w_pad, step, num_symmetric,
                       dtype=torch.float32, index_dtype=torch.int32):
    """One flat pack per shard, stacked on a leading shard axis.

    ``slot_sets`` holds (ros, ja, al, au) per shard.  Step counts are
    equalized across shards by padding every shard to the widest with inert
    trailing steps (``_flat_arrays(pad_steps_to=)``).  Returns the uniform
    step count, the stacked tensors and each shard's real step count."""
    per_shard = []
    for ros, _, _, _ in slot_sets:
        counts = np.bincount(ros // tm, minlength=nt)
        per_shard.append(int(np.maximum(1, -(-counts // step)).sum()))
    steps = max(per_shard)
    p = len(slot_sets)
    vl = np.empty((p, steps, step), np.float32)
    vu = vl if num_symmetric else np.empty((p, steps, step), np.float32)
    cl = np.empty((p, steps, step), np.int32)
    rw = np.empty((p, steps, step), np.int32)
    tos = np.empty((p, steps), np.int32)
    first = np.empty((p, steps), np.int32)
    for t, (ros, ja, al, au) in enumerate(slot_sets):
        (vl[t], vu_t, cl[t], rw[t], tos[t], first[t], _) = _flat_arrays(
            ros, ja, al, au, nt=nt, tm=tm, w_pad=w_pad, step=step,
            pad_steps_to=steps)
        if not num_symmetric:
            vu[t] = vu_t
    vl_t = torch.from_numpy(vl).to(dtype)
    arrays = dict(
        vals_l=vl_t,
        vals_u=vl_t if num_symmetric else torch.from_numpy(vu).to(dtype),
        col_local=torch.from_numpy(cl).to(index_dtype),
        row_in_win=torch.from_numpy(rw).to(index_dtype),
        tile_of_step=torch.from_numpy(tos),
        first_of_tile=torch.from_numpy(first))
    return steps, arrays, per_shard


def real_step_count(col_local: torch.Tensor, first_of_tile: torch.Tensor,
                    vals_l: torch.Tensor, vals_u: torch.Tensor,
                    w_pad: int) -> int:
    """The steps of one shard's stacked pack before its inert tail.

    A trailing step is inert when it starts no tile, holds no real slot
    (every column is the sentinel ``w_pad``) and carries zero values: it
    adds only ``0·x`` terms.  The kernels then end the last tile's step
    range here, so a light shard's padding is never walked (the tail all
    belongs to the last tile, whose steps one block runs in turn).  Raises
    ValueError when a step past the last live one carries a value."""
    live = (col_local != w_pad).any(dim=1) | (first_of_tile != 0)
    last = torch.nonzero(live).flatten()
    used = int(last[-1]) + 1 if last.numel() else 0
    if bool((vals_l[used:] != 0).any()) or bool((vals_u[used:] != 0).any()):
        raise ValueError("inert trailing steps must carry zero values")
    return used


def _shard_view(lay, t: int, n: int) -> FlatBlockEll:
    """Shard t of a stacked flat layout as a FlatBlockEll of views.  The
    slot order and the step ranges are checked here, once per shard; the
    last tile's range ends at the shard's real step count
    (:func:`real_step_count`)."""
    col, row = lay.col_local[t], lay.row_in_win[t]
    tile, first = lay.tile_of_step[t], lay.first_of_tile[t]
    vl = lay.vals_l[t]
    vu = vl if lay.vals_u is lay.vals_l else lay.vals_u[t]
    check_slot_order(row, col, lay.w_pad)
    starts = step_ranges(tile, first, lay.nt)
    starts[-1] = real_step_count(col, first, vl, vu, lay.w_pad)
    return FlatBlockEll(
        n=n, tm=lay.tm, nt=lay.nt, w_pad=lay.w_pad, total_steps=lay.steps,
        ks=lay.ks, vals_l=vl, vals_u=vu, col_local=col, row_in_win=row,
        ad=lay.ad[t], tile_of_step=tile, first_of_tile=first,
        num_symmetric=lay.num_symmetric, pad_ratio=1.0,
        step_start=starts.to(tile.device))


def _reference_shapes(lay) -> dict:
    """The JAX package's (p, steps, ks, 128) layout of the slot streams."""
    shape = (lay.p, lay.steps, lay.ks, LANES)
    return {f: shape for f in ("vals_l", "vals_u", "col_local",
                               "row_in_win")}


@dataclasses.dataclass(frozen=True)
class FlatShards:
    """Per-shard flat sub-packs of one matrix in *global* coordinates
    (allreduce / reduce_scatter): shard t's pack holds only the slots of its
    partition rows and its slice of the diagonal, and spans all NT tiles
    (one inert step for each tile it does not own), so its product is a
    full-length partial y.  Streams are stacked (p, steps, ks·128)."""
    p: int
    n: int
    tm: int
    nt: int
    w_pad: int
    steps: int                  # uniform k-steps per shard (padded)
    ks: int
    vals_l: torch.Tensor        # (p, steps, step)
    vals_u: torch.Tensor        # (p, steps, step)  (is vals_l if symmetric)
    col_local: torch.Tensor     # (p, steps, step)
    row_in_win: torch.Tensor    # (p, steps, step)
    ad: torch.Tensor            # (p, NT, TM) shard-owned diagonal
    tile_of_step: torch.Tensor  # (p, steps) int32
    first_of_tile: torch.Tensor  # (p, steps) int32
    num_symmetric: bool

    def shard_pack(self, t: int) -> FlatBlockEll:
        """Shard t's pack as a FlatBlockEll of views (checked once)."""
        return _shard_view(self, t, self.n)

    def to(self, device) -> "FlatShards":
        return move_layout(self, _SHARD_STREAMS, device)

    def reference_shapes(self) -> dict:
        return _reference_shapes(self)


@dataclasses.dataclass(frozen=True)
class FlatHalo:
    """Per-shard flat packs in *local* halo coordinates (the paper's
    effective accumulation): shard t owns ns rows, and its local matrix
    covers rows [r0-h, r1) of y — n_local = ns + h rows, the h halo rows
    first, the y_ext / x_ext layout of ``schedule.build_halo_layout`` run
    by the flat kernels."""
    p: int
    ns: int                     # rows per shard (8-aligned)
    h: int                      # halo width (8-aligned bandwidth)
    n_local: int                # ns + h
    tm: int
    nt: int                     # local row tiles: ceil(n_local / tm)
    w_pad: int
    steps: int
    ks: int
    vals_l: torch.Tensor        # (p, steps, step)
    vals_u: torch.Tensor
    col_local: torch.Tensor
    row_in_win: torch.Tensor
    ad: torch.Tensor            # (p, NT, TM) local-coordinate diagonal
    tile_of_step: torch.Tensor
    first_of_tile: torch.Tensor
    num_symmetric: bool

    def shard_pack(self, t: int) -> FlatBlockEll:
        return _shard_view(self, t, self.n_local)

    def to(self, device) -> "FlatHalo":
        return move_layout(self, _SHARD_STREAMS, device)

    def reference_shapes(self) -> dict:
        return _reference_shapes(self)


def _window(M: CSRC, band: int, tm: int, w_cap: int, index_dtype) -> int:
    w_pad = _round_up(tm + band, max(128, tm))
    if index_dtype == torch.int16 and w_pad + 1 > 32767:
        raise ValueError(f"window {w_pad} overflows int16 indices")
    if w_pad > w_cap:
        raise ValueError(f"window {w_pad} > cap {w_cap}")
    return w_pad


def _slots(M: CSRC):
    return (row_of_slot(M), _np(M.ja).astype(np.int64), _np(M.al),
            _np(M.au))


def _partition_spans(M: CSRC, starts):
    """Lower-slot range of each shard of the row partition ``starts``
    (slots are row-major)."""
    ia = _np(M.ia).astype(np.int64)
    return [(int(ia[starts[t]]), int(ia[starts[t + 1]]))
            for t in range(len(starts) - 1)]


def pack_flat_shards(M: CSRC, starts, tm: int = 128, ks: int = 8,
                     w_cap: int = 4096, dtype=torch.float32,
                     index_dtype=torch.int32) -> FlatShards:
    """Split a square CSRC matrix into per-shard flat packs along the row
    partition ``starts`` ((p+1,) boundaries from the schedule layer).  The
    arrays are the JAX package's ``pack_flat_shards``'."""
    if not M.is_square:
        raise ValueError("the flat shards pack the square CSRC part only")
    n = M.n
    w_pad = _window(M, bandwidth(M), tm, w_cap, index_dtype)
    nt = max(1, -(-n // tm))
    starts = np.asarray(starts, dtype=np.int64)
    p = starts.shape[0] - 1
    ros, ja, al, au = _slots(M)
    steps, arrays, _ = _stack_shard_packs(
        [(ros[s:e], ja[s:e], al[s:e], au[s:e])
         for s, e in _partition_spans(M, starts)],
        nt=nt, tm=tm, w_pad=w_pad, step=ks * LANES,
        num_symmetric=M.numerically_symmetric, dtype=dtype,
        index_dtype=index_dtype)
    ad = shard_diagonal(M, starts, nt * tm)
    return FlatShards(
        p=p, n=n, tm=tm, nt=nt, w_pad=w_pad, steps=steps, ks=ks,
        ad=torch.from_numpy(ad.reshape(p, nt, tm)).to(dtype),
        num_symmetric=bool(M.numerically_symmetric), **arrays)


def pack_flat_halo(M: CSRC, p: int, tm: int = 128, ks: int = 8,
                   w_cap: int = 4096, dtype=torch.float32,
                   index_dtype=torch.int32) -> FlatHalo:
    """Per-shard local flat packs for the halo strategy (the JAX package's
    ``pack_flat_halo``, array for array).  Raises ValueError when the band
    does not fit inside one shard or the local window exceeds ``w_cap``."""
    if not M.is_square:
        raise ValueError("the flat halo packs the square CSRC part only")
    n = M.n
    ns, h = halo_geometry(M, p)
    n_local = ns + h
    # every local row i stores columns in [i-h, i]: local bandwidth <= h
    w_pad = _window(M, h, tm, w_cap, index_dtype)
    nt = max(1, -(-n_local // tm))
    ros, ja, al, au = _slots(M)
    sets = []
    for t, (s, e) in enumerate(halo_slot_spans(M, p, ns)):
        # local row r0+i -> h+i; column j -> j - (r0 - h)
        sets.append((ros[s:e] - t * ns + h, ja[s:e] - (t * ns - h),
                     al[s:e], au[s:e]))
    steps, arrays, _ = _stack_shard_packs(
        sets, nt=nt, tm=tm, w_pad=w_pad, step=ks * LANES,
        num_symmetric=M.numerically_symmetric, dtype=dtype,
        index_dtype=index_dtype)
    ad = halo_diagonal(M, p, ns, h, nt * tm)
    return FlatHalo(
        p=p, ns=ns, h=h, n_local=n_local, tm=tm, nt=nt, w_pad=w_pad,
        steps=steps, ks=ks,
        ad=torch.from_numpy(ad.reshape(p, nt, tm)).to(dtype),
        num_symmetric=bool(M.numerically_symmetric), **arrays)


def _refill(lay, M: CSRC, row_sets, ad: np.ndarray):
    """A stacked layout with its value streams refilled from per-shard
    (rows, al, au) in build order; index streams and tile maps untouched.
    The refilled streams land on the layout's device."""
    if bool(M.numerically_symmetric) != lay.num_symmetric:
        raise ValueError(
            "numeric symmetry changed; rebuild instead of refreshing")
    step = lay.ks * LANES
    vl = np.empty((lay.p, lay.steps, step), np.float32)
    vu = vl if lay.num_symmetric else np.empty_like(vl)
    for t, (ros, al, au) in enumerate(row_sets):
        vl_t, vu_t = _value_fill_steps(
            ros, al, au, nt=lay.nt, tm=lay.tm, step=step, steps=lay.steps,
            num_symmetric=lay.num_symmetric)
        vl[t] = vl_t
        if not lay.num_symmetric:
            vu[t] = vu_t
    vdtype, dev = lay.vals_l.dtype, lay.vals_l.device
    vl_t = torch.from_numpy(vl).to(device=dev, dtype=vdtype)
    return dataclasses.replace(
        lay, vals_l=vl_t,
        vals_u=vl_t if lay.num_symmetric else torch.from_numpy(vu).to(
            device=dev, dtype=vdtype),
        ad=torch.from_numpy(ad.reshape(lay.p, lay.nt, lay.tm)).to(
            device=lay.ad.device, dtype=lay.ad.dtype))


def refresh_flat_shards(fs: FlatShards, M: CSRC, starts) -> FlatShards:
    """Refill a FlatShards stack's value streams from a same-structure
    matrix over the same partition ``starts`` — no index stream, tile map
    or step-count work."""
    if not (M.is_square and M.n == fs.n):
        raise ValueError("structure mismatch")
    starts = np.asarray(starts, dtype=np.int64)
    ros, _, al, au = _slots(M)
    return _refill(fs, M, [(ros[s:e], al[s:e], au[s:e])
                           for s, e in _partition_spans(M, starts)],
                   shard_diagonal(M, starts, fs.nt * fs.tm))


def refresh_flat_halo(lay: FlatHalo, M: CSRC) -> FlatHalo:
    """Refill a FlatHalo stack's value streams from a same-structure matrix
    (local halo rows re-derived from the layout's geometry)."""
    if not M.is_square:
        raise ValueError("structure mismatch")
    ros, _, al, au = _slots(M)
    sets = [(ros[s:e] - t * lay.ns + lay.h, al[s:e], au[s:e])
            for t, (s, e) in enumerate(halo_slot_spans(M, lay.p, lay.ns))]
    return _refill(lay, M, sets, halo_diagonal(M, lay.p, lay.ns, lay.h,
                                                lay.nt * lay.tm))


def flat_local_fn(lay, n_local: int, variant: str = "onehot"):
    """Shard-local flat-grid product over a FlatShards or FlatHalo layout:
    ``fn(t, x)`` runs shard t's product (SpMV or SpMM by x's rank) with the
    plan's ``variant``.  The p shard packs are built here, once."""
    packs = [lay.shard_pack(t) for t in range(lay.p)]
    if any(pk.n != n_local for pk in packs):
        raise ValueError(f"layout rows differ from n_local {n_local}")

    def local_y(t: int, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 2:
            return flat_spmm(packs[t], x, variant=variant)
        return flat_spmv(packs[t], x, variant=variant)

    return local_y


def flat_halo_dims(lay: FlatHalo):
    return lay.ns, lay.h, lay.n_local
