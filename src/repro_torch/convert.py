"""Build this package's objects from the JAX package's, handed over as numpy
arrays and plain Python values.

The caller does the ``np.asarray`` on the other package's arrays: nothing
here ever sees (or imports) a foreign array type.  bfloat16 streams cross
as widened float32 plus the dtype's name, the way the schedule npz layer
stores them.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import blockell
from repro_torch.core.csrc import CSRC, _t
from repro_torch.core.plan import ExecutionPlan

_VALUE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tensor(a, dtype=None) -> torch.Tensor:
    return _t(np.asarray(a, dtype=dtype))


def csrc_from_arrays(*, n: int, m: int, ad, ia, ja, al, au, iar, jar, ar,
                     numerically_symmetric: bool) -> CSRC:
    """A :class:`CSRC` from the eight arrays of another container."""
    return CSRC(n=int(n), m=int(m), ad=_tensor(ad), ia=_tensor(ia),
                ja=_tensor(ja), al=_tensor(al), au=_tensor(au),
                iar=_tensor(iar), jar=_tensor(jar), ar=_tensor(ar),
                numerically_symmetric=bool(numerically_symmetric))


def blockell_from_arrays(*, n: int, tm: int, nt: int, w_pad: int, s: int,
                         vals_l, vals_u, col_local, row_in_win, ad,
                         num_symmetric: bool, pad_ratio: float,
                         value_dtype: str = "float32") -> blockell.BlockEll:
    """A :class:`~repro_torch.core.blockell.BlockEll` from a foreign pack.
    Value streams arrive as float32 arrays and are narrowed to
    ``value_dtype`` ('float32' or 'bfloat16'); index streams keep the
    integer dtype they arrive in.  The slot order is checked here
    (``blockell.check_slot_order``): a malformed pack raises ValueError."""
    vdt = _VALUE_DTYPES[value_dtype]

    def values(a):
        return _tensor(a, np.float32).to(vdt)

    col_t, row_t = _tensor(col_local), _tensor(row_in_win)
    blockell.check_slot_order(row_t, col_t, int(w_pad))
    vl = values(vals_l)
    return blockell.BlockEll(
        n=int(n), tm=int(tm), nt=int(nt), w_pad=int(w_pad), s=int(s),
        vals_l=vl, vals_u=vl if num_symmetric else values(vals_u),
        col_local=col_t, row_in_win=row_t,
        ad=values(ad), num_symmetric=bool(num_symmetric),
        pad_ratio=float(pad_ratio))


def flat_from_arrays(*, n: int, tm: int, nt: int, w_pad: int,
                     total_steps: int, ks: int, vals_l, vals_u, col_local,
                     row_in_win, ad, tile_of_step, first_of_tile,
                     num_symmetric: bool, pad_ratio: float,
                     value_dtype: str = "float32"):
    """A :class:`~repro_torch.kernels.csrc_spmv_flat.FlatBlockEll` from a
    foreign flat pack.  Streams arrive in the ``(total, ks, 128)`` layout
    (or already flat per step) and are stored as (total, ks·128); value
    streams arrive as float32 and are narrowed to ``value_dtype``.  The
    step ranges are derived and validated here: a malformed pack raises
    ValueError."""
    from repro_torch.kernels.csrc_spmv_flat import FlatBlockEll
    vdt = _VALUE_DTYPES[value_dtype]
    shape = (int(total_steps), int(ks) * 128)

    def values(a):
        return _tensor(np.asarray(a, np.float32).reshape(shape)).to(vdt)

    def indices(a):
        return _tensor(np.asarray(a).reshape(shape))

    vl = values(vals_l)
    return FlatBlockEll(
        n=int(n), tm=int(tm), nt=int(nt), w_pad=int(w_pad),
        total_steps=int(total_steps), ks=int(ks),
        vals_l=vl, vals_u=vl if num_symmetric else values(vals_u),
        col_local=indices(col_local), row_in_win=indices(row_in_win),
        ad=_tensor(ad, np.float32).to(vdt),
        tile_of_step=_tensor(tile_of_step, np.int32),
        first_of_tile=_tensor(first_of_tile, np.int32),
        num_symmetric=bool(num_symmetric), pad_ratio=float(pad_ratio))


def nnzsplit_from_arrays(*, n: int, num_chunks: int, ks: int, r_pad: int,
                         vals, lrow, src, chunk_row0, fixup_idx, ad,
                         num_symmetric: bool, pad_ratio: float,
                         value_dtype: str = "float32"):
    """A :class:`~repro_torch.kernels.csrc_spmv_nnzsplit.NnzSplitPack` from
    a foreign nnz-split pack.  ``vals`` / ``lrow`` arrive in the
    ``(C, ks, 128)`` layout and ``src`` as ``(C·S,)`` (or any layout of the
    same entries) and are stored as (C, S); values arrive as float32 and
    are narrowed to ``value_dtype``; index streams keep their integer
    dtype.  The streams are checked here (``lrow`` sorted inside each
    chunk, indices in range, ``fixup_idx`` consistent): a malformed pack
    raises ValueError."""
    from repro_torch.kernels.csrc_spmv_nnzsplit import (NnzSplitPack,
                                                        check_chunk_streams)
    vdt = _VALUE_DTYPES[value_dtype]
    shape = (int(num_chunks), int(ks) * 128)
    lrow_t = _tensor(np.asarray(lrow).reshape(shape))
    src_t = _tensor(np.asarray(src).reshape(shape))
    if lrow_t.dtype != src_t.dtype:
        raise ValueError(f"lrow is {lrow_t.dtype} but src is {src_t.dtype}")
    row0 = _tensor(chunk_row0, np.int32)
    fix = _tensor(fixup_idx, np.int32)
    check_chunk_streams(lrow_t, src_t, row0, fix, n=int(n), r_pad=int(r_pad))
    return NnzSplitPack(
        n=int(n), num_chunks=int(num_chunks), ks=int(ks), r_pad=int(r_pad),
        vals=_tensor(np.asarray(vals, np.float32).reshape(shape)).to(vdt),
        lrow=lrow_t, src=src_t, chunk_row0=row0, fixup_idx=fix,
        ad=_tensor(ad, np.float32).to(vdt),
        num_symmetric=bool(num_symmetric), pad_ratio=float(pad_ratio))


def coloring_from_arrays(*, color_of_row, num_colors: int, rows_by_color,
                         color_ptr, provider: str = "greedy",
                         level_of_row=None, group_of_row=None):
    """A :class:`~repro_torch.core.coloring.Coloring` from a foreign one's
    arrays (numpy, as the JAX package keeps them)."""
    from repro_torch.core.coloring import PROVIDERS, Coloring
    if provider not in PROVIDERS:
        raise ValueError(f"unknown coloring provider {provider!r}")

    def opt(a):
        return None if a is None else np.asarray(a)
    return Coloring(color_of_row=np.asarray(color_of_row),
                    num_colors=int(num_colors),
                    rows_by_color=np.asarray(rows_by_color),
                    color_ptr=np.asarray(color_ptr), provider=provider,
                    level_of_row=opt(level_of_row),
                    group_of_row=opt(group_of_row))


def assembly_schedule_from_arrays(*, structure_digest: str, n: int, k: int,
                                  ne: int, edof: int, ndof_per_node: int,
                                  num_buffers: int, ia, ja, targets,
                                  coloring, buffer_elements, color_slots,
                                  color_targets, sorted_perm,
                                  sorted_targets):
    """An :class:`~repro_torch.assembly.scatter.AssemblySchedule` from a
    foreign one's fields.  ``coloring`` is a
    :class:`~repro_torch.core.coloring.Coloring` or the keyword arrays of
    :func:`coloring_from_arrays`; index streams keep the integer dtypes
    they arrive in (the int16 gate travels with them).  The kernel packs
    are validated and bucketed on construction: a malformed pack raises
    ValueError."""
    from repro_torch.assembly.scatter import AssemblySchedule
    from repro_torch.core.coloring import Coloring
    if not isinstance(coloring, Coloring):
        coloring = coloring_from_arrays(**coloring)
    return AssemblySchedule(
        structure_digest=str(structure_digest), n=int(n), k=int(k),
        ne=int(ne), edof=int(edof), ndof_per_node=int(ndof_per_node),
        num_buffers=int(num_buffers), ia=np.asarray(ia), ja=np.asarray(ja),
        targets=np.asarray(targets), coloring=coloring,
        buffer_elements=np.asarray(buffer_elements),
        color_slots=np.asarray(color_slots),
        color_targets=np.asarray(color_targets),
        sorted_perm=np.asarray(sorted_perm),
        sorted_targets=np.asarray(sorted_targets))


def plan_from_dict(d: Dict) -> ExecutionPlan:
    """An :class:`ExecutionPlan` from another plan's ``to_dict()``."""
    return ExecutionPlan.from_dict(dict(d))
