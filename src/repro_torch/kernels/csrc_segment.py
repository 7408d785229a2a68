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
written and no index is widened.  No pack and no schedule artifact: the
path keeps ``_no_artifact``.

The lane mapping is chosen from X's width, which the code can observe
(:func:`lane_mapping`): a lane takes ``vec`` consecutive columns (4 where
the width and the pointers allow 16-byte accesses, else 2 or 1) and
``lanes`` = min(B / vec, 32) lanes own a row.  B = 1 is one lane a row, B =
8 two lanes of four columns.

The plain version (:func:`segment_product_plain`) is the in-package
reference chain, ``ref.csrc_spmv`` (``ref.csrc_spmv_arrays`` and the tail)
or ``ref.csrc_spmm``; it is taken only for a CPU tensor.  A CUDA tensor
launches K15 or raises; nothing falls back.  ``K15.launches`` counts the
launches (one per product).  The path's executors on the card are
:class:`SegmentKernel` objects, which check the matrix once, when the
operator binds, and refuse (``TypeError``) one whose arrays K15 does not
read as stored (:func:`kernel_takes`: float32 values, int32 indices).

Summation order: K15 adds with reductions in atomic order, so Y can differ
from run to run by rounding, as the ``index_add_`` chain did (ROADMAP
C44): exact on dyadic values, and within 1e-5 of the row's absolute sum
otherwise.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.csrc import CSRC
from . import _build, ref
from ._build import _I, _P

K15 = _build.register(_build.Kernel(
    "csrc_segment_spmm",
    [_P] * 10 + [_I] * 7 + [_P],
    replaces="src/repro/kernels/ref.py:94"))

MAX_LANES = 32         # lanes owning one row, at most a warp

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
    (:func:`check_matrix`) and its pointers read once, when the ``segment``
    path's executor is built; each call checks x alone and launches.

    A call runs on the host once an iteration of a one-column solve, whose
    iteration is host-bound on the cube: the lane mapping is kept per
    width and alignment, x is cast only when it is not float32 and
    contiguous, and the device is switched only when it is not current."""

    def __init__(self, M: CSRC):
        if M.device.type != "cuda":
            raise ValueError("K15 takes a matrix on the card; a CPU matrix "
                             "goes to the plain version")
        check_matrix(M)
        self.M = M
        self._device = M.device
        self._arrays = tuple(getattr(M, f).data_ptr() for f in (
            "ia", "ja", "al", "au", "ad", "iar", "jar", "ar"))
        self._flags = (int(M.numerically_symmetric),
                       int(M.jar.shape[0] > 0))
        self._mappings = {}

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """y (n,) for x (m,), Y (n, B) for X (m, B); one launch."""
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
                *self._flags)
        if torch.cuda.current_device() == self._device.index:
            K15.launch(*args)
        else:
            with torch.cuda.device(self._device):
                K15.launch(*args)
        return y
