"""The ``segment`` path on the card: CUDA kernel K15, the whole CSRC product
in one pass.

K15 (csrc/csrc_segment_spmm.cu) replaces no TPU body: the JAX package's
``segment`` path is plain jnp (``kernels/ref.py::csrc_spmm``), which XLA
fuses.  As PyTorch calls the same chain writes two (k, B) gathers, their
products, and two ``index_add_`` sums by indices widened to int64 on every
call.  K15 reads the container's arrays as ``SpmvOperator._bind`` put them
on the card (``ia``, ``ja`` int32; ``al``, ``au``, ``ad`` float32; the
rectangular tail ``iar``, ``jar``, ``ar``) and X (m, B) row-major float32,
and writes Y (n, B): a group of lanes owns a row, sums its gather term and
diagonal (and tail) in registers, and adds each slot's transpose term to
``Y[ja[p]]`` by a vector reduction in L2.  Nothing of size (k, B) is
written and no index is widened.  No pack: the path's schedule artifact
is the split of its heavy rows alone (below).

The lane mapping is chosen from X's width, which the code can observe
(:func:`lane_mapping`): a lane takes ``vec`` consecutive columns (4 where
the width and the pointers allow 16-byte accesses, else 2 or 1) and
``lanes`` = min(B / vec, 32) lanes own a row.  B = 1 is one lane a row, B =
8 two lanes of four columns.

A row with more than :data:`HEAVY_SLOTS` lower slots is split
(:func:`split_rows`): its slots are cut into chunks of at most
:data:`CHUNK_SLOTS`, a table of (row, first slot, end slot), the
``segment`` path's schedule artifact (:class:`SegmentSplit`: built once
per matrix, kept by the PlanCache, moved to the card with the schedule).
Where the table is empty (HPCG's stencil: at most 13 lower slots a row)
the product is one launch of the row-owned kernel, taking the same
arguments as before the split existed.
Otherwise it is two: the row-owned kernel, in which a heavy row keeps only
its diagonal and tail, and ``segment_chunk_kernel``, a lane group a chunk,
whose sums join ``Y`` by the same reductions.  So no lane group walks more
than max(HEAVY_SLOTS, CHUNK_SLOTS) slots, whatever the longest row.

The plain version (:func:`segment_product_plain`) is the in-package
reference chain, ``ref.csrc_spmv`` (``ref.csrc_spmv_arrays`` and the tail)
or ``ref.csrc_spmm``; it is taken only for a CPU tensor.  A CUDA tensor
launches K15 or raises; nothing falls back.  ``K15.launches`` counts the
launches (one a product, two where rows are split).  The path's executors
on the card are :class:`SegmentKernel` objects, which check the matrix
once, when the operator binds, take the schedule's split, and refuse
(``TypeError``) one whose arrays K15 does not read as stored
(:func:`kernel_takes`: float32 values, int32 indices).

Summation order: K15 adds with reductions in atomic order, so Y can differ
from run to run by rounding, as the ``index_add_`` chain did (ROADMAP
C44): exact on dyadic values, and within 1e-5 of the row's absolute sum
otherwise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.core.csrc import CSRC
from . import _build, ref
from ._build import _I, _P

K15 = _build.register(_build.Kernel(
    "csrc_segment_spmm",
    [_P] * 10 + [_I] * 7 + [_P, _I, _I, _P],
    replaces="src/repro/kernels/ref.py:94"))

MAX_LANES = 32         # lanes owning one row, at most a warp
# A row with more lower slots than HEAVY_SLOTS is split into chunks of at
# most CHUNK_SLOTS.  16 is the smallest power of two above the 13 lower
# slots of a 27-point stencil's row, so HPCG's matrices keep one launch; on
# the Kronecker graph lower thresholds gain under 3 % (csrc_segment_spmm.cu)
HEAVY_SLOTS = 16
CHUNK_SLOTS = 256

_VALUE_FIELDS = ("ad", "al", "au", "ar")
_INDEX_FIELDS = ("ia", "ja", "iar", "jar")


def kernel_takes(M: CSRC) -> bool:
    """Whether K15 reads ``M``'s arrays as stored: float32 values and
    int32 indices."""
    return (all(getattr(M, f).dtype == torch.float32 for f in _VALUE_FIELDS)
            and all(getattr(M, f).dtype == torch.int32
                    for f in _INDEX_FIELDS))


def lane_mapping(nrhs: int, *pointers: int) -> Tuple[int, int]:
    """``(vec, lanes)`` of a product of width ``nrhs`` whose X and Y start
    at ``pointers``: ``vec`` columns a lane (4, 2 or 1: the widest that
    divides ``nrhs`` and keeps every row of X and Y aligned to its access)
    and ``lanes`` threads a row, min(nrhs / vec, 32)."""
    if nrhs < 1:
        raise ValueError(f"width must be at least 1, got {nrhs}")
    vec = next(v for v in (4, 2, 1)
               if nrhs % v == 0 and all(p % (4 * v) == 0 for p in pointers))
    return vec, min(nrhs // vec, MAX_LANES)


def check_matrix(M: CSRC) -> None:
    """Raise unless K15 can read ``M``: float32 values, int32 indices,
    every array contiguous and of its CSRC length."""
    if not kernel_takes(M):
        raise TypeError(
            "K15 takes float32 values and int32 indices, got "
            + ", ".join(f"{f} {getattr(M, f).dtype}"
                        for f in _VALUE_FIELDS + _INDEX_FIELDS))
    k, kr = M.k, int(M.jar.shape[0])
    shapes = {"ad": M.n, "ia": M.n + 1, "ja": k, "al": k, "au": k,
              "iar": M.n + 1, "jar": kr, "ar": kr}
    for f, size in shapes.items():
        a = getattr(M, f)
        if tuple(a.shape) != (size,) or not a.is_contiguous():
            raise ValueError(f"M.{f} must be contiguous ({size},), got "
                             f"{tuple(a.shape)}")


def operand(M: CSRC, x: torch.Tensor) -> torch.Tensor:
    """x as K15 and its plain version take it: on the matrix's device,
    (m,) or (m, B), float32, contiguous."""
    if x.device != M.device:
        raise ValueError(f"matrix lives on {M.device}, x on {x.device}; "
                         "bind the matrix with its .to(device) first")
    if x.ndim not in (1, 2) or x.shape[0] != M.m:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({M.m},) "
                         f"or ({M.m}, B)")
    return x.to(torch.float32).contiguous()


@dataclasses.dataclass(frozen=True)
class SegmentSplit:
    """The heavy rows of one matrix cut into chunks: ``chunks`` int32
    (chunks, 3), each (row, first slot, end slot); ``heavy``, the lower
    slots a row may hold unsplit; ``rows`` and ``slots``, the split rows
    and their lower slots."""
    chunks: torch.Tensor
    heavy: int
    rows: int
    slots: int

    def to(self, device) -> "SegmentSplit":
        chunks = self.chunks.to(device)
        if chunks is self.chunks:
            return self
        return dataclasses.replace(self, chunks=chunks)


def split_rows(ia: torch.Tensor, heavy: int = HEAVY_SLOTS,
               chunk: int = CHUNK_SLOTS) -> SegmentSplit:
    """The split of the rows with more than ``heavy`` lower slots, on
    ``ia``'s device, in a ``schedule.segment_split`` span with the split
    ``rows``, their lower ``slots`` and the ``chunks``.  A row's chunks
    follow each other in slot order, each ``chunk`` slots but the row's
    last; together they cover the heavy rows' slots once and no other
    slot.  The table is (0, 3) where no row passes ``heavy``."""
    if heavy < 0 or chunk < 1:
        raise ValueError(f"heavy must be >= 0 and chunk >= 1, got {heavy} "
                         f"and {chunk}")
    with obs.span("schedule.segment_split") as span:
        ia = ia.to(torch.int64)
        lengths = ia[1:] - ia[:-1]
        rows = torch.nonzero(lengths > heavy).flatten()
        counts = (lengths[rows] + chunk - 1) // chunk
        row = torch.repeat_interleave(rows, counts)
        first_chunk = torch.cumsum(counts, 0) - counts
        within = (torch.arange(row.numel(), device=ia.device)
                  - torch.repeat_interleave(first_chunk, counts))
        first = ia[row] + within * chunk
        end = torch.minimum(first + chunk, ia[row + 1])
        split = SegmentSplit(
            chunks=torch.stack([row, first, end], dim=1).to(torch.int32),
            heavy=heavy, rows=int(rows.numel()),
            slots=int(lengths[rows].sum()))
        span.labels.update(rows=str(split.rows), slots=str(split.slots),
                           chunks=str(split.chunks.shape[0]))
    return split


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def segment_product_plain(M: CSRC, x: torch.Tensor,
                          row_idx=None) -> torch.Tensor:
    """Plain version of K15: the in-package reference chain (gathers,
    multiplies, ``index_add_``), ``ref.csrc_spmv`` for x (m,) and
    ``ref.csrc_spmm`` for X (m, B).  ``row_idx`` is the expanded ``ia``
    (``ref.row_index``), derived per call when absent."""
    x = operand(M, x)
    if x.ndim == 1:
        return ref.csrc_spmv(M, x, row_idx=row_idx)
    return ref.csrc_spmm(M, x, row_idx=row_idx)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

class SegmentKernel:
    """K15 bound to one matrix on the card: the matrix is checked
    (:func:`check_matrix`) and its pointers and its ``split`` (the
    ``segment`` schedule's artifact; :func:`split_rows` of the matrix
    where none is given, as for a schedule the JAX package wrote, which
    has none) read once, when the path's executor is built; each call
    checks x alone and launches.

    A call runs on the host once an iteration of a one-column solve, whose
    iteration is host-bound on the cube: the lane mapping is kept per
    width and alignment, x is cast only when it is not float32 and
    contiguous, and the device is switched only when it is not current."""

    def __init__(self, M: CSRC, split: Optional[SegmentSplit] = None):
        if M.device.type != "cuda":
            raise ValueError("K15 takes a matrix on the card; a CPU matrix "
                             "goes to the plain version")
        check_matrix(M)
        if split is None:
            split = split_rows(M.ia)
        self.split = split = split.to(M.device)
        chunks = split.chunks
        if (chunks.dtype != torch.int32 or chunks.ndim != 2
                or chunks.shape[1] != 3 or not chunks.is_contiguous()):
            raise ValueError("the split's chunks must be a contiguous int32 "
                             f"(chunks, 3) table, got {chunks.dtype} "
                             f"{tuple(chunks.shape)}")
        self.M = M
        self._device = M.device
        self._arrays = tuple(getattr(M, f).data_ptr() for f in (
            "ia", "ja", "al", "au", "ad", "iar", "jar", "ar"))
        n_chunks = int(chunks.shape[0])
        # the entry point's arguments after the lane mapping
        self._last_args = (int(M.numerically_symmetric),
                           int(M.jar.shape[0] > 0),
                           chunks.data_ptr() if n_chunks else None,
                           n_chunks, split.heavy)
        self._launches = 1 + (n_chunks > 0)
        self._mappings = {}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """y (n,) for x (m,), Y (n, B) for X (m, B); one launch, or two
        where rows are split."""
        M = self.M
        if x.device != self._device:
            if not x.is_cuda:
                raise ValueError("K15 takes CUDA tensors; a CPU tensor goes "
                                 "to the plain version")
            x = operand(M, x)           # raises: another card
        if (x.ndim not in (1, 2) or x.shape[0] != M.m
                or x.dtype != torch.float32 or not x.is_contiguous()):
            x = operand(M, x)
        nrhs = 1 if x.ndim == 1 else x.shape[1]
        y = torch.empty((M.n,) + x.shape[1:], dtype=torch.float32,
                        device=x.device)
        if M.n == 0 or nrhs == 0:
            return y.zero_()
        xp, yp = x.data_ptr(), y.data_ptr()
        key = (nrhs, (xp | yp) & 15)
        mapping = self._mappings.get(key)
        if mapping is None:
            mapping = self._mappings[key] = lane_mapping(nrhs, xp, yp)
        args = (*self._arrays, xp, yp, M.n, M.m, nrhs, *mapping,
                *self._last_args)
        if torch.cuda.current_device() == self._device.index:
            K15.launch(*args, launches=self._launches)
        else:
            with torch.cuda.device(self._device):
                K15.launch(*args, launches=self._launches)
        return y
