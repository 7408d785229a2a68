"""Nnz-split CSRC products for unstructured matrices: CUDA kernels K9-K12.

The windowed paths (kernel, flat) pad a per-tile column window that
explodes when ``ja`` spreads across the whole index range (power-law
graphs, random patterns), and row-based balancing loses to hub rows.  Here
work is balanced over *non-zeros*, not rows:

  * the symmetric storage is expanded into one combined stream of 2k
    entries — lower slot p at (i, j) gives (dest=i, src=j, al[p]) and its
    transpose partner (dest=j, src=i, au[p]) — stably sorted by ``dest``;
  * the stream is cut into equal chunks of S = ks·128 entries regardless of
    row boundaries; chunk c covers the rows from ``chunk_row0[c]`` on, and
    each entry stores its chunk-local row ``lrow = dest - chunk_row0[c]``
    (below ``r_pad``) and its gather index ``src``;
  * a kernel reduces each chunk into its own ``r_pad``-wide partial row —
    no cross-chunk accumulation inside the kernel — and the fix-up
    ``y_pad.index_add_(0, fixup_idx, partials)`` merges rows split across
    chunk boundaries; the diagonal closes the product.

Geometry (``r_pad``, padding entries, dtypes, argsort order) is that of the
JAX package's ``pack_nnzsplit``, array for array.  Streams are held as
(C, S); the npz keeps the JAX package's ``(C, ks, 128)`` layout.  Because
the stream is sorted, ``lrow`` never decreases inside a chunk; all four
kernels rely on that, so every pack is checked for it when it is built,
loaded or converted (:func:`check_chunk_streams`).

Kernels, selected by ``variant``, all gather ``x[src]`` themselves (x stays
in L2; the JAX package's gathered ``xg`` stream is never materialized):

  'stream'  K9 (x (n,)), csrc/nnzsplit_spmv_stream.cu, and K10 (X (n, B)),
            csrc/nnzsplit_spmm_stream.cu — replace the TPU bodies
            kernels/csrc_spmv_nnzsplit.py::_kernel_stream /
            _kernel_mm_stream.  Bound by bytes; one block per chunk, a
            warp-segmented sum by ``lrow`` into a shared-memory row; K10
            first copies a warp's 32 X rows into shared memory with the
            column fastest.
  'onehot'  K11, csrc/nnzsplit_spmv_onehot.cu, and K12,
            csrc/nnzsplit_spmm_onehot.cu — replace ::_kernel / ::_kernel_mm.
            One body (csrc/chunk_kernels.cuh ``chunk_runs_kernel``), K11 its
            one-column instance: ``lrow`` is sorted, so each row's entries
            are one run; the thread of each (row, column) sums its run in
            slot order (bound by bytes).  A fixed summation order,
            bit-identical reruns, and K11 equals K12's column 0 bit for
            bit.

Their plain PyTorch versions — the fused gather + ``index_add_`` form
(``csrc_spmv_stream.nnzsplit_partials_fused``) and the chunk-by-chunk
one-hot form (:func:`nnzsplit_partials_onehot_plain`) — are taken only for
a CPU tensor; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.blockell import _round_up, move_layout
from repro_torch.core.csrc import CSRC, _np, row_of_slot
from repro_torch.core.partition import (halo_diagonal, halo_geometry,
                                        halo_slot_spans, shard_diagonal)
from repro_torch.core.plan import LANES, VARIANTS
from . import _build
from ._build import _I, _P
from .csrc_spmm import _SMEM_BUDGET, column_tile

K9 = _build.register(_build.Kernel(
    "nnzsplit_spmv_stream",
    [_P] * 5 + [_I] * 6 + [_P],
    replaces="src/repro/kernels/csrc_spmv_nnzsplit.py:202"))
K11 = _build.register(_build.Kernel(
    "nnzsplit_spmv_onehot",
    [_P] * 5 + [_I] * 6 + [_P],
    replaces="src/repro/kernels/csrc_spmv_nnzsplit.py:190"))
K10 = _build.register(_build.Kernel(
    "nnzsplit_spmm_stream",
    [_P] * 5 + [_I] * 8 + [_P],
    replaces="src/repro/kernels/csrc_spmv_nnzsplit.py:250"))
K12 = _build.register(_build.Kernel(
    "nnzsplit_spmm_onehot",
    [_P] * 5 + [_I] * 8 + [_P],
    replaces="src/repro/kernels/csrc_spmv_nnzsplit.py:238"))

_STREAMS = ("vals", "lrow", "src", "chunk_row0", "fixup_idx", "ad")
# entries the one-hot kernels stage through shared memory per pass
# (csrc/chunk_kernels.cuh kStage)
_STAGE = 512
# one-hot masks of the plain version are built for this many (entry, row)
# pairs at a time
_MASK_ELEMENTS = 1 << 25


@dataclasses.dataclass(frozen=True)
class NnzSplitPack:
    n: int
    num_chunks: int
    ks: int                     # 128-entry units per chunk: S = ks·128
    r_pad: int                  # per-chunk local row window (128-aligned)
    vals: torch.Tensor          # (C, S) dest-sorted combined values
    lrow: torch.Tensor          # (C, S) dest - chunk_row0[chunk]
    src: torch.Tensor           # (C, S) global gather index into x
    chunk_row0: torch.Tensor    # (C,) int32 first dest row of each chunk
    fixup_idx: torch.Tensor     # (C·r_pad,) int32 rows of y_pad
    ad: torch.Tensor            # (n,) diagonal
    num_symmetric: bool
    pad_ratio: float            # allocated entries / real stream entries

    @property
    def s(self) -> int:
        return self.ks * LANES

    @property
    def device(self) -> torch.device:
        return self.vals.device

    def to(self, device) -> "NnzSplitPack":
        """The same pack with its streams on ``device``."""
        device = torch.device(device)
        if all(getattr(self, f).device == device for f in _STREAMS):
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device).contiguous()
                     for f in _STREAMS})

    def streamed_bytes(self, nrhs: int = 1) -> int:
        """Bytes one product moves through device memory — the JAX
        package's terms (value, index and gather streams, fix-up indices,
        partials written and read, diagonal, x and y), with the gathered x
        stream, the partials and x / y ``nrhs`` wide."""
        def nbytes(a):
            return a.numel() * a.element_size()
        b = nbytes(self.vals) + nbytes(self.lrow) + nbytes(self.src)
        b += self.src.numel() * 4 * nrhs             # gathered x stream
        b += nbytes(self.fixup_idx)
        b += self.num_chunks * self.r_pad * 4 * nrhs  # partials written+read
        b += nbytes(self.ad)
        b += 2 * self.n * 4 * nrhs                   # x and y
        return b


def _dest_order(ros: np.ndarray, ja: np.ndarray, n: int) -> np.ndarray:
    """``np.argsort(concat(ros, ja), kind="stable")`` without sorting the
    lower half: ``ros`` already ascends, so row d's combined entries are
    its lower slots in slot order followed by the slots with ``ja == d`` in
    slot order — only ``ja`` needs a stable argsort (torch's multithreaded
    sort of the int32 column indices: the same permutation as numpy's,
    an order of magnitude sooner at tens of millions of slots)."""
    k = ja.shape[0]
    cnt_l = np.bincount(ros, minlength=n)
    cnt_u = np.bincount(ja, minlength=n)
    start = np.zeros(n + 1, np.int64)
    np.cumsum(cnt_l + cnt_u, out=start[1:])
    lstart = np.zeros(n + 1, np.int64)
    np.cumsum(cnt_l, out=lstart[1:])
    ustart = np.zeros(n + 1, np.int64)
    np.cumsum(cnt_u, out=ustart[1:])
    pos = np.empty(2 * k, np.int64)
    pos[:k] = start[ros] + np.arange(k, dtype=np.int64) - lstart[ros]
    by_col = torch.sort(torch.from_numpy(ja.astype(np.int32)),
                        stable=True).indices.numpy()
    col = ja[by_col]
    pos[k + by_col] = (start[col] + cnt_l[col]
                       + np.arange(k, dtype=np.int64) - ustart[col])
    order = np.empty(2 * k, np.int64)
    order[pos] = np.arange(2 * k, dtype=np.int64)
    return order


def _combined_stream(M: CSRC):
    """The dest-sorted scatter stream of the square symmetric part:
    (dest, src, val), the order of the JAX package's stable argsort."""
    ros = row_of_slot(M).astype(np.int64)
    ja = _np(M.ja).astype(np.int64)
    order = _dest_order(ros, ja, M.n)
    dest = np.concatenate([ros, ja])[order]
    src = np.concatenate([ja, ros])[order]
    val = np.concatenate([_np(M.al).astype(np.float32, copy=False),
                          _np(M.au).astype(np.float32, copy=False)])[order]
    return dest, src, val


def _padded_dest(dest, s: int, num_chunks=None):
    """``dest`` padded with its last row to ``num_chunks`` (default: the
    fewest) chunks of ``s`` entries, as (C, s), and the padding length."""
    kk = int(dest.shape[0])
    need = max(1, -(-kk // s))
    nc = need if num_chunks is None else int(num_chunks)
    if nc < need:
        raise ValueError(f"num_chunks {nc} < required {need}")
    pad = nc * s - kk
    fill_dest = int(dest[-1]) if kk else 0
    dest = np.concatenate([dest, np.full(pad, fill_dest, np.int64)])
    return dest.reshape(nc, s), pad


def _chunk_arrays(dest, src, val, *, ks: int, num_chunks=None, r_pad=None):
    """Cut one dest-sorted stream into equal chunks of S = ks·128 entries.
    ``num_chunks`` / ``r_pad`` force the geometry (to equalize the shards of
    a stacked layout).  Padding entries carry val 0, src 0 and the stream's
    last real row.  Returns the per-chunk numpy arrays, streams as (C, S)."""
    s = ks * LANES
    dest, pad = _padded_dest(dest, s, num_chunks)
    nc = dest.shape[0]
    src = np.concatenate([src, np.zeros(pad, np.int64)])
    val = np.concatenate([val, np.zeros(pad, np.float32)])
    chunk_row0 = dest[:, 0].copy()
    span = int((dest[:, -1] - chunk_row0).max()) + 1
    rp = _round_up(max(span, 1), LANES) if r_pad is None else int(r_pad)
    if span > rp:
        raise ValueError(f"chunk row span {span} > r_pad {rp}")
    lrow = (dest - chunk_row0[:, None]).astype(np.int32)
    fixup = (chunk_row0[:, None]
             + np.arange(rp, dtype=np.int64)[None, :]).reshape(-1)
    return dict(num_chunks=nc, r_pad=rp, vals=val.reshape(nc, s),
                lrow=lrow, src=src.reshape(nc, s),
                chunk_row0=chunk_row0.astype(np.int32),
                fixup_idx=fixup.astype(np.int32))


def check_chunk_streams(lrow, src, chunk_row0, fixup_idx, *, n: int,
                        r_pad: int) -> None:
    """Raise ValueError unless the chunk streams are what the kernels
    assume: ``lrow`` in [0, r_pad) and non-decreasing inside each chunk
    (the dest-sorted order the warp-segmented sums of K9/K10 and the row
    runs of K11/K12 rely on), ``src`` in [0, n), and ``fixup_idx`` equal to
    ``chunk_row0[c] + arange(r_pad)`` with ``chunk_row0`` in [0, n)."""
    lr = _np(lrow)
    if lr.ndim != 2:
        raise ValueError("lrow must be a (C, S) stream")
    if lr.size and (lr.min() < 0 or lr.max() >= r_pad):
        raise ValueError(f"lrow must lie in [0, {r_pad})")
    if (np.diff(lr, axis=1) < 0).any():
        raise ValueError("lrow must be non-decreasing inside each chunk "
                         "(a dest-sorted stream)")
    sr = _np(src)
    if sr.size and (sr.min() < 0 or sr.max() >= max(n, 1)):
        raise ValueError(f"src must lie in [0, {n})")
    row0 = _np(chunk_row0).astype(np.int64)
    if row0.shape != (lr.shape[0],) or (row0.size and (
            row0.min() < 0 or row0.max() >= max(n, 1))):
        raise ValueError(f"chunk_row0 must hold one row in [0, {n}) per "
                         "chunk")
    want = (row0[:, None] + np.arange(r_pad, dtype=np.int64)).reshape(-1)
    if not np.array_equal(_np(fixup_idx).astype(np.int64), want):
        raise ValueError("fixup_idx must be chunk_row0[c] + arange(r_pad)")


def pack_nnzsplit(M: CSRC, ks: int = 8, r_cap: int = 4096,
                  dtype=torch.float32,
                  index_dtype=torch.int32) -> NnzSplitPack:
    """Equal-nnz chunking of a square CSRC matrix.

    ``r_cap`` bounds the per-chunk row window: a stream whose chunks skip
    huge row gaps (near-diagonal matrices with a few scattered entries)
    would pad every chunk to the worst gap — those matrices belong to the
    banded paths, so the packer raises (the windowed packers' w_cap gate).
    ``dtype=torch.bfloat16`` / ``index_dtype=torch.int16`` narrow the value
    / index streams (int16 needs n <= 32767)."""
    if not M.is_square:
        raise ValueError("the nnzsplit pack chunks the square CSRC part only")
    n = M.n
    if index_dtype == torch.int16 and n > 32767:
        raise ValueError(f"n {n} overflows int16 gather indices")
    dest, src, val = _combined_stream(M)
    ch = _chunk_arrays(dest, src, val, ks=ks)
    if ch["r_pad"] > r_cap:
        raise ValueError(f"chunk row window {ch['r_pad']} > cap {r_cap}")
    check_chunk_streams(ch["lrow"], ch["src"], ch["chunk_row0"],
                        ch["fixup_idx"], n=n, r_pad=ch["r_pad"])
    kk = max(1, int(dest.shape[0]))
    return NnzSplitPack(
        n=n, num_chunks=ch["num_chunks"], ks=ks, r_pad=ch["r_pad"],
        vals=torch.from_numpy(ch["vals"]).to(dtype),
        lrow=torch.from_numpy(ch["lrow"]).to(index_dtype),
        src=torch.from_numpy(ch["src"]).to(index_dtype),
        chunk_row0=torch.from_numpy(ch["chunk_row0"]),
        fixup_idx=torch.from_numpy(ch["fixup_idx"]),
        ad=torch.from_numpy(_np(M.ad).astype(np.float32)).to(dtype),
        num_symmetric=bool(M.numerically_symmetric),
        pad_ratio=float(ch["num_chunks"] * ks * LANES) / kk,
    )


def refresh_nnzsplit_values(pack: NnzSplitPack, M: CSRC) -> NnzSplitPack:
    """Refill the value stream from a same-structure matrix: the dest order
    is re-derived (same structure, same permutation), values refilled, no
    index stream touched.  The refreshed streams land on the pack's
    device."""
    if not (M.is_square and M.n == pack.n):
        raise ValueError("structure mismatch")
    if bool(M.numerically_symmetric) != pack.num_symmetric:
        raise ValueError(
            "numeric symmetry changed; rebuild instead of refreshing")
    _dest, _src, val = _combined_stream(M)
    pad = pack.num_chunks * pack.s - val.shape[0]
    if pad < 0:
        raise ValueError("structure mismatch: stream longer than pack")
    val = np.concatenate([val, np.zeros(pad, np.float32)])
    dev = pack.vals.device
    return dataclasses.replace(
        pack,
        vals=torch.from_numpy(val.reshape(pack.num_chunks, pack.s)).to(
            device=dev, dtype=pack.vals.dtype),
        ad=torch.from_numpy(_np(M.ad).astype(np.float32)).to(
            device=pack.ad.device, dtype=pack.ad.dtype))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (partials (C, r_pad[, B]))
# ---------------------------------------------------------------------------

def nnzsplit_partials_stream_plain(pack: NnzSplitPack,
                                   x: torch.Tensor) -> torch.Tensor:
    """Plain version of K9 (x (n,)) and K10 (x (n, B)): the fused gather +
    ``index_add_`` form."""
    from .csrc_spmv_stream import nnzsplit_partials_fused
    return nnzsplit_partials_fused(pack, x)


def nnzsplit_partials_onehot_plain(pack: NnzSplitPack,
                                   x: torch.Tensor) -> torch.Tensor:
    """Plain version of K11 (x (n,)) and K12 (x (n, B)), chunk by chunk as
    the TPU bodies run: the products ``vals · x[src]`` and an explicit
    (S, r_pad) one-hot mask of ``lrow`` contracted with them.  Chunks are
    processed in groups so the masks stay bounded."""
    nc, s, r_pad = pack.num_chunks, pack.s, pack.r_pad
    x = x.to(torch.float32)
    x2 = x[:, None] if x.ndim == 1 else x
    dev = x2.device
    iota = torch.arange(r_pad, device=dev)
    out = torch.empty((nc, r_pad, x2.shape[1]), dtype=torch.float32,
                      device=dev)
    group = max(1, _MASK_ELEMENTS // (s * r_pad))
    for c0 in range(0, nc, group):
        sl = slice(c0, min(nc, c0 + group))
        xg = x2[pack.src[sl].to(torch.int64)]                    # (G, S, B)
        c = pack.vals[sl].to(torch.float32)[..., None] * xg
        oh = (pack.lrow[sl].to(torch.int64)[..., None] == iota).to(
            torch.float32)                                       # (G, S, R)
        out[sl] = oh.transpose(1, 2) @ c
    return out[..., 0] if x.ndim == 1 else out


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _operand(pack: NnzSplitPack, x: torch.Tensor, ndim: int) -> torch.Tensor:
    """x as the kernels and their plain versions take it: on the pack's
    device, (n,) or (n, B) with B >= 1, float32, contiguous."""
    if pack.vals.device != x.device:
        raise ValueError(
            f"pack lives on {pack.vals.device}, x on {x.device}; bind the "
            "pack with its .to(device) first")
    if x.ndim != ndim or x.shape[0] != pack.n or x.numel() == 0:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                         f"({pack.n}{', B' if ndim == 2 else ''})")
    return x.to(torch.float32).contiguous()


def chunk_stream_flags(pack: NnzSplitPack, device, nrhs: int) -> tuple:
    """``(values are bf16, indices are int16)`` after checking that the
    pack's streams have the dtypes, shapes, layout and device the kernels
    are instantiated for, and that their offsets fit 32-bit math."""
    vdt, idt = pack.vals.dtype, pack.lrow.dtype
    if vdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pack.vals must be float32 or bfloat16, got {vdt}")
    if idt not in (torch.int32, torch.int16):
        raise TypeError(f"pack.lrow must be int32 or int16, got {idt}")
    want = {"src": idt, "ad": vdt, "chunk_row0": torch.int32,
            "fixup_idx": torch.int32}
    for name, dt in want.items():
        if getattr(pack, name).dtype != dt:
            raise TypeError(f"pack.{name} is {getattr(pack, name).dtype}, "
                            f"expected {dt}")
    shapes = {"vals": (pack.num_chunks, pack.s),
              "lrow": (pack.num_chunks, pack.s),
              "src": (pack.num_chunks, pack.s),
              "chunk_row0": (pack.num_chunks,),
              "fixup_idx": (pack.num_chunks * pack.r_pad,)}
    for name, shape in shapes.items():
        a = getattr(pack, name)
        if (tuple(a.shape) != shape or not a.is_contiguous()
                or a.device != device):
            raise ValueError(f"pack.{name} must be contiguous {shape} on "
                             f"{device}, got {tuple(a.shape)} on {a.device}")
    if pack.r_pad % LANES or pack.s % LANES:
        raise ValueError("r_pad and S must be multiples of 128")
    if max(pack.num_chunks * pack.s,
           pack.num_chunks * pack.r_pad * nrhs) >= 2 ** 31:
        raise ValueError("pack too large for the kernels' 32-bit offsets")
    return (vdt == torch.bfloat16, idt == torch.int16)


def _onehot_tile(r_pad: int, nrhs: int) -> int:
    """Columns per K12 block: the (r_pad, BT) output tile and the
    (stage, BT) staged products share the 64 KB shared-memory budget with
    the pass's r_pad + 1 row pointers
    (csrc/chunk_kernels.cuh ``chunk_runs_smem_bytes``)."""
    free = _SMEM_BUDGET - 4 * (r_pad + 1)
    return max(1, min(nrhs, free // (4 * (r_pad + _STAGE))))


def _launch(kernel, pack: NnzSplitPack, x: torch.Tensor, ndim: int,
            tile: int = 0) -> torch.Tensor:
    if not x.is_cuda:
        raise ValueError("the CUDA kernels take CUDA tensors; a CPU tensor "
                         "goes to the plain version")
    x = _operand(pack, x, ndim)
    nrhs = 1 if ndim == 1 else x.shape[1]
    flags = chunk_stream_flags(pack, x.device, nrhs)
    shape = ((pack.num_chunks, pack.r_pad) if ndim == 1
             else (pack.num_chunks, pack.r_pad, nrhs))
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    args = [pack.vals.data_ptr(), pack.lrow.data_ptr(), pack.src.data_ptr(),
            x.data_ptr(), out.data_ptr(), pack.num_chunks, pack.s,
            pack.r_pad, pack.n]
    if ndim == 2:
        args += [nrhs, tile]
    with torch.cuda.device(x.device):
        kernel.launch(*args, *(int(f) for f in flags))
    return out


def nnzsplit_spmv_stream_cuda(pack: NnzSplitPack,
                              x: torch.Tensor) -> torch.Tensor:
    """Launch K9; returns the (C, r_pad) partials."""
    return _launch(K9, pack, x, 1)


def nnzsplit_spmv_onehot_cuda(pack: NnzSplitPack,
                              x: torch.Tensor) -> torch.Tensor:
    """Launch K11; returns the (C, r_pad) partials."""
    return _launch(K11, pack, x, 1)


def nnzsplit_spmm_stream_cuda(pack: NnzSplitPack,
                              X: torch.Tensor) -> torch.Tensor:
    """Launch K10; returns the (C, r_pad, B) partials."""
    nrhs = X.shape[1] if X.ndim == 2 else 1
    return _launch(K10, pack, X, 2, column_tile(pack.r_pad, nrhs, 1))


def nnzsplit_spmm_onehot_cuda(pack: NnzSplitPack,
                              X: torch.Tensor) -> torch.Tensor:
    """Launch K12; returns the (C, r_pad, B) partials."""
    nrhs = X.shape[1] if X.ndim == 2 else 1
    return _launch(K12, pack, X, 2, _onehot_tile(pack.r_pad, nrhs))


def _partials(pack: NnzSplitPack, x: torch.Tensor, ndim: int,
              variant: str) -> torch.Tensor:
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    if x.is_cuda:
        launch = {(1, "stream"): nnzsplit_spmv_stream_cuda,
                  (1, "onehot"): nnzsplit_spmv_onehot_cuda,
                  (2, "stream"): nnzsplit_spmm_stream_cuda,
                  (2, "onehot"): nnzsplit_spmm_onehot_cuda}[(ndim, variant)]
        return launch(pack, x)
    if x.device.type != "cpu":
        raise ValueError(f"x lives on {x.device}: a CUDA tensor launches "
                         "the kernel, a CPU tensor takes the plain version")
    x = _operand(pack, x, ndim)
    if variant == "stream":
        return nnzsplit_partials_stream_plain(pack, x)
    return nnzsplit_partials_onehot_plain(pack, x)


def fixup(pack: NnzSplitPack, partial: torch.Tensor,
          x: torch.Tensor) -> torch.Tensor:
    """y from the per-chunk partials: scatter-add them at ``fixup_idx``
    into y_pad (n + r_pad rows), then add the diagonal last, as the JAX
    package does.  On a CUDA tensor the adds of a row split across chunks
    land in atomic order.  The ``nnzsplit`` path's accumulation step: an
    ``spmv.accumulate`` range (``obs.trace_range``)."""
    tail = tuple(partial.shape[2:])
    with obs.trace_range("spmv.accumulate"):
        y_pad = torch.zeros((pack.n + pack.r_pad,) + tail,
                            dtype=torch.float32, device=partial.device)
        y_pad.index_add_(0, pack.fixup_idx.to(torch.int64),
                         partial.reshape((-1,) + tail))
        ad = pack.ad.to(torch.float32)
        if tail:
            ad = ad[:, None]
        return y_pad[:pack.n] + ad * x.to(torch.float32)


def nnzsplit_spmv(pack: NnzSplitPack, x: torch.Tensor,
                  variant: str = "onehot") -> torch.Tensor:
    """y = A @ x: kernel partials (K9 / K11 on a CUDA ``x``, their plain
    versions on a CPU one), the fix-up and the diagonal."""
    return fixup(pack, _partials(pack, x, 1, variant), x)


def nnzsplit_spmm(pack: NnzSplitPack, X: torch.Tensor,
                  variant: str = "onehot") -> torch.Tensor:
    """Y = A @ X for X (n, B): B-wide partials (K10 / K12), the fix-up and
    the diagonal; returns (n, B)."""
    return fixup(pack, _partials(pack, X, 2, variant), X)


# ---------------------------------------------------------------------------
# Shard layouts for the mesh strategies (core/distributed.py), built through
# core/schedule.py's memoized builders
# ---------------------------------------------------------------------------

_SHARD_STREAMS = ("vals", "lrow", "src", "chunk_row0", "fixup_idx", "ad")


def _stack_chunked(streams, *, ks: int, r_cap: int, n_check: int):
    """Chunk one dest-sorted stream per shard with equalized (num_chunks,
    r_pad) — the widest shard's chunk count and row window — and check each
    shard's chunks (``check_chunk_streams``, rows below ``n_check``)."""
    s = ks * LANES
    nc = max(max(1, -(-int(d.shape[0]) // s)) for d, _, _ in streams)
    rp = LANES
    for d, _, _ in streams:
        rows = _padded_dest(d, s, nc)[0]
        span = int((rows[:, -1] - rows[:, 0]).max()) + 1
        rp = max(rp, _round_up(span, LANES))
    if rp > r_cap:
        raise ValueError(f"chunk row window {rp} > cap {r_cap}")
    parts = [_chunk_arrays(d, sr, v, ks=ks, num_chunks=nc, r_pad=rp)
             for d, sr, v in streams]
    for c in parts:
        check_chunk_streams(c["lrow"], c["src"], c["chunk_row0"],
                            c["fixup_idx"], n=n_check, r_pad=rp)
    stacked = {key: np.stack([c[key] for c in parts])
               for key in ("vals", "lrow", "src", "chunk_row0", "fixup_idx")}
    return nc, rp, stacked


def _as_shard_tensors(stacked, *, dtype, index_dtype):
    return dict(
        vals=torch.from_numpy(stacked["vals"]).to(dtype),
        lrow=torch.from_numpy(stacked["lrow"]).to(index_dtype),
        src=torch.from_numpy(stacked["src"]).to(index_dtype),
        chunk_row0=torch.from_numpy(stacked["chunk_row0"]),
        fixup_idx=torch.from_numpy(stacked["fixup_idx"]))


def _shard_view(lay, t: int, n: int) -> NnzSplitPack:
    return NnzSplitPack(
        n=n, num_chunks=lay.num_chunks, ks=lay.ks, r_pad=lay.r_pad,
        vals=lay.vals[t], lrow=lay.lrow[t], src=lay.src[t],
        chunk_row0=lay.chunk_row0[t], fixup_idx=lay.fixup_idx[t],
        ad=lay.ad[t], num_symmetric=lay.num_symmetric, pad_ratio=1.0)


def _reference_shapes(lay) -> dict:
    """The JAX package's layout: (p, C, ks, 128) vals / lrow, (p, C·S) src."""
    shape = (lay.p, lay.num_chunks, lay.ks, LANES)
    return {"vals": shape, "lrow": shape,
            "src": (lay.p, lay.num_chunks * lay.ks * LANES)}


@dataclasses.dataclass(frozen=True)
class NnzSplitShards:
    """Per-shard nnz-split sub-packs in *global* coordinates (allreduce /
    reduce_scatter): shard t chunks only the combined entries whose dest row
    it owns, plus its slice of the diagonal, and its product is a
    full-length partial y.  Streams are stacked (p, C, S)."""
    p: int
    n: int
    num_chunks: int             # uniform chunks per shard (padded)
    ks: int
    r_pad: int                  # the widest shard's row window
    vals: torch.Tensor          # (p, C, S)
    lrow: torch.Tensor          # (p, C, S)
    src: torch.Tensor           # (p, C, S)
    chunk_row0: torch.Tensor    # (p, C) int32
    fixup_idx: torch.Tensor     # (p, C·r_pad) int32
    ad: torch.Tensor            # (p, n) shard-owned diagonal, zero elsewhere
    num_symmetric: bool

    def shard_pack(self, t: int) -> NnzSplitPack:
        return _shard_view(self, t, self.n)

    def to(self, device) -> "NnzSplitShards":
        return move_layout(self, _SHARD_STREAMS, device)

    def reference_shapes(self) -> dict:
        return _reference_shapes(self)


@dataclasses.dataclass(frozen=True)
class NnzSplitHalo:
    """Per-shard nnz-split packs in *local* halo coordinates: both halves
    of a slot go to the shard owning the slot's row (its columns then lie in
    [r0-h, r1), the frame the halo exchange provides), and the local product
    is an n_local = ns + h row vector, the halo rows first."""
    p: int
    ns: int
    h: int
    n_local: int
    num_chunks: int
    ks: int
    r_pad: int
    vals: torch.Tensor
    lrow: torch.Tensor
    src: torch.Tensor
    chunk_row0: torch.Tensor
    fixup_idx: torch.Tensor
    ad: torch.Tensor            # (p, n_local) local-coordinate diagonal
    num_symmetric: bool

    def shard_pack(self, t: int) -> NnzSplitPack:
        return _shard_view(self, t, self.n_local)

    def to(self, device) -> "NnzSplitHalo":
        return move_layout(self, _SHARD_STREAMS, device)

    def reference_shapes(self) -> dict:
        return _reference_shapes(self)


def pack_nnzsplit_shards(M: CSRC, starts, ks: int = 8, r_cap: int = 4096,
                         dtype=torch.float32,
                         index_dtype=torch.int32) -> NnzSplitShards:
    """Split the combined stream along the row partition ``starts``: shard
    t takes the entries with dest in [starts[t], starts[t+1]) — one slice
    of the dest-sorted stream.  The JAX package's arrays."""
    if not M.is_square:
        raise ValueError("the nnzsplit shards chunk the square CSRC part "
                         "only")
    n = M.n
    if index_dtype == torch.int16 and n > 32767:
        raise ValueError(f"n {n} overflows int16 gather indices")
    starts = np.asarray(starts, dtype=np.int64)
    p = starts.shape[0] - 1
    dest, src, val = _combined_stream(M)
    cuts = np.searchsorted(dest, starts)
    streams = [(dest[cuts[t]:cuts[t + 1]], src[cuts[t]:cuts[t + 1]],
                val[cuts[t]:cuts[t + 1]]) for t in range(p)]
    nc, rp, stacked = _stack_chunked(streams, ks=ks, r_cap=r_cap, n_check=n)
    return NnzSplitShards(
        p=p, n=n, num_chunks=nc, ks=ks, r_pad=rp,
        ad=torch.from_numpy(shard_diagonal(M, starts, n)).to(dtype),
        num_symmetric=bool(M.numerically_symmetric),
        **_as_shard_tensors(stacked, dtype=dtype, index_dtype=index_dtype))


def _halo_streams(M: CSRC, p: int, ns: int, h: int, n_local: int):
    """Per shard, the combined stream of its rows' slots in local
    coordinates (global row g -> g - (t·ns - h)), dest-sorted in the order
    of the JAX package's stable argsort."""
    ros = row_of_slot(M).astype(np.int64)
    ja = _np(M.ja).astype(np.int64)
    al = _np(M.al).astype(np.float32, copy=False)
    au = _np(M.au).astype(np.float32, copy=False)
    out = []
    for t, (s, e) in enumerate(halo_slot_spans(M, p, ns)):
        off = t * ns - h
        r, j = ros[s:e] - off, ja[s:e] - off
        order = _dest_order(r, j, n_local)
        out.append((np.concatenate([r, j])[order],
                    np.concatenate([j, r])[order],
                    np.concatenate([al[s:e], au[s:e]])[order]))
    return out


def pack_nnzsplit_halo(M: CSRC, p: int, ks: int = 8, r_cap: int = 4096,
                       dtype=torch.float32,
                       index_dtype=torch.int32) -> NnzSplitHalo:
    """Per-shard local packs for the halo strategy.  The band-fits-shard
    gate of the other halo builders applies: unstructured matrices (band
    about n) fail it and take allreduce / reduce_scatter."""
    if not M.is_square:
        raise ValueError("the nnzsplit halo chunks the square CSRC part only")
    ns, h = halo_geometry(M, p)
    n_local = ns + h
    if index_dtype == torch.int16 and n_local > 32767:
        raise ValueError(f"n_local {n_local} overflows int16 indices")
    nc, rp, stacked = _stack_chunked(_halo_streams(M, p, ns, h, n_local),
                                     ks=ks, r_cap=r_cap, n_check=n_local)
    return NnzSplitHalo(
        p=p, ns=ns, h=h, n_local=n_local, num_chunks=nc, ks=ks, r_pad=rp,
        ad=torch.from_numpy(halo_diagonal(M, p, ns, h, n_local)).to(dtype),
        num_symmetric=bool(M.numerically_symmetric),
        **_as_shard_tensors(stacked, dtype=dtype, index_dtype=index_dtype))


def _refresh_stacked(lay, value_streams, ad_rows):
    """``lay`` with ``vals`` (and the diagonal) refilled from per-shard
    value streams in the layout's build order, on the layout's device."""
    vals = np.zeros((lay.p, lay.num_chunks * lay.ks * LANES), np.float32)
    for t, v in enumerate(value_streams):
        if v.shape[0] > vals.shape[1]:
            raise ValueError("structure mismatch: stream longer than pack")
        vals[t, :v.shape[0]] = v
    return dataclasses.replace(
        lay,
        vals=torch.from_numpy(vals.reshape(lay.vals.shape)).to(
            device=lay.vals.device, dtype=lay.vals.dtype),
        ad=torch.from_numpy(ad_rows).to(device=lay.ad.device,
                                        dtype=lay.ad.dtype))


def refresh_nnzsplit_shards(lay: NnzSplitShards, M: CSRC,
                            starts) -> NnzSplitShards:
    """Refill an NnzSplitShards stack's values from a same-structure
    matrix over the same partition — no index stream touched."""
    if not (M.is_square and M.n == lay.n):
        raise ValueError("structure mismatch")
    starts = np.asarray(starts, dtype=np.int64)
    dest, _src, val = _combined_stream(M)
    cuts = np.searchsorted(dest, starts)
    return _refresh_stacked(
        lay, [val[cuts[t]:cuts[t + 1]] for t in range(lay.p)],
        shard_diagonal(M, starts, lay.n))


def refresh_nnzsplit_halo(lay: NnzSplitHalo, M: CSRC) -> NnzSplitHalo:
    """Refill an NnzSplitHalo stack's values from a same-structure matrix
    (the local dest order re-derived from the layout's geometry)."""
    if not M.is_square:
        raise ValueError("structure mismatch")
    streams = _halo_streams(M, lay.p, lay.ns, lay.h, lay.n_local)
    return _refresh_stacked(
        lay, [v for _, _, v in streams],
        halo_diagonal(M, lay.p, lay.ns, lay.h, lay.n_local))


def nnzsplit_local_fn(lay, n_local: int, variant: str = "onehot"):
    """Shard-local nnz-split product over an NnzSplitShards or NnzSplitHalo
    layout: ``fn(t, x)`` runs shard t's product (SpMV or SpMM by x's rank)
    with the plan's ``variant``.  The p shard packs are built here, once."""
    packs = [lay.shard_pack(t) for t in range(lay.p)]
    if any(pk.n != n_local for pk in packs):
        raise ValueError(f"layout rows differ from n_local {n_local}")

    def local_y(t: int, x: torch.Tensor) -> torch.Tensor:
        if x.ndim == 2:
            return nnzsplit_spmm(packs[t], x, variant=variant)
        return nnzsplit_spmv(packs[t], x, variant=variant)

    return local_y


def nnzsplit_halo_dims(lay: NnzSplitHalo):
    return lay.ns, lay.h, lay.n_local
