"""Block-ELL CSRC sparse matrix-vector product: CUDA kernels K1 and K3.

The paper's parallel CSRC SpMV at tile granularity: a row tile plays the
"thread processing a row range", its output *window* the thread's local
buffer restricted to its effective range, and
``core.blockell.overlap_add`` the effective accumulation step.  For
numerically symmetric matrices only ``vals_l`` is streamed (the paper's
one-fewer-load optimization).

Two kernels compute the (NT, W) windows, selected by ``variant``:

  'stream'  K1, csrc/blockell_spmv_stream.cu — replaces the TPU body
            kernels/csrc_spmv.py::_kernel_stream of the JAX package.
            Bound by bytes on the card; one block per tile, x window and
            accumulator in shared memory.  Each lane sums its four
            consecutive slots by row, the warp sums the lanes' runs of
            equal rows with shuffles (csrc/warp_scan.cuh), and a run is
            added once into the window; the column half takes one
            shared-memory atomic add per slot.  Needs the slot order that
            ``blockell.check_slot_order`` checks, as K3 does.
  'onehot'  K3, csrc/blockell_spmv_onehot.cu — replaces
            kernels/csrc_spmv.py::_kernel.  One block per tile over the
            tile's k-steps, the run-and-bucket body of csrc/window_runs.cuh:
            per step each window row sums its run of real slots (a tile's
            rows never decrease and its padding trails) and each column its
            bucket from a stable counting sort by column, in slot order, and
            the window takes the two sums — the TPU body's order, O(S + W)
            work per step, no float atomics.  Bound by a block's latency
            per step.  The slot order is checked wherever a pack is built,
            loaded or converted (``blockell.check_slot_order``).

Each has its plain PyTorch version beside it
(:func:`spmv_windows_stream_plain`, :func:`spmv_windows_onehot_plain`),
taken only when ``x`` lies on the CPU.  A CUDA tensor launches the kernel
or raises; nothing falls back.  ``K1.launches`` / ``K3.launches`` count the
launches.

Summation order: K1 sums with atomics, so the order inside a window
changes from run to run — exact on dyadic values, and within 1e-5 of the
row's absolute sum otherwise.  K3 is identical from run to run.  K3 takes
a k-step of at most 65,535 slots whose shared memory (``runs_smem_bytes``
in window_runs.cuh) fits the card's 227 KB; a larger one raises at launch.
"""
from __future__ import annotations

import torch

from repro_torch.core.blockell import BlockEll, overlap_add, pad_x
from repro_torch.core.plan import LANES, VARIANTS
from . import _build
from ._build import _I, _P

K1 = _build.register(_build.Kernel(
    "blockell_spmv_stream",
    [_P] * 7 + [_I] * 8 + [_P],
    replaces="src/repro/kernels/csrc_spmv.py:97"))
K3 = _build.register(_build.Kernel(
    "blockell_spmv_onehot",
    [_P] * 7 + [_I] * 9 + [_P],
    replaces="src/repro/kernels/csrc_spmv.py:39"))

# one-hot masks of the plain version are built for this many (slot, window
# position) pairs at a time
_MASK_ELEMENTS = 1 << 25


def _k_step(pack: BlockEll, k_step_sublanes: int) -> int:
    k_step = k_step_sublanes * LANES
    if pack.s % k_step != 0:
        raise ValueError(f"slot count {pack.s} must divide into k-steps of "
                         f"{k_step}")
    return k_step


def _operand(pack: BlockEll, x: torch.Tensor, ndim: int) -> torch.Tensor:
    """x as the kernels and their plain versions take it: on the pack's
    device, (n,) or (n, B) with B >= 1, float32, contiguous."""
    if pack.vals_l.device != x.device:
        raise ValueError(
            f"pack lives on {pack.vals_l.device}, x on {x.device}; bind the "
            "pack with its .to(device) first")
    if x.ndim != ndim or x.shape[0] != pack.n or x.numel() == 0:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected "
                         f"({pack.n}{', B' if ndim == 2 else ''})")
    return x.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def spmv_windows_stream_plain(pack: BlockEll, x: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: the fused gather + ``index_add_`` form."""
    from .csrc_spmv_stream import windows_fused
    return windows_fused(pack, x)


def windows_onehot_plain(pack: BlockEll, x: torch.Tensor,
                         k_step: int) -> torch.Tensor:
    """Plain version of the one-hot kernels (K3 for x (n,), K4 for x
    (n, B)): explicit (S, W) one-hot masks and matmuls, k-step by k-step —
    gather ``mask @ xw``, scatter ``maskᵀ @ contrib``, the diagonal joining
    on the first step.  Tiles are processed in chunks so the masks stay
    bounded in memory."""
    nt, s, w_pad, tm = pack.nt, pack.s, pack.w_pad, pack.tm
    x_full = pad_x(pack, x.to(torch.float32))
    x2 = x_full[:, None] if x_full.ndim == 1 else x_full
    nrhs = x2.shape[1]
    dev = x2.device
    iota = torch.arange(w_pad, device=dev)
    out = torch.empty((nt, w_pad, nrhs), dtype=torch.float32, device=dev)
    chunk = max(1, _MASK_ELEMENTS // (k_step * w_pad))
    for t0 in range(0, nt, chunk):
        t1 = min(nt, t0 + chunk)
        start = (torch.arange(t0, t1, device=dev) + 1) * tm
        xw = x2[start[:, None] + iota[None, :]]              # (T, W, B)
        acc = None
        for p0 in range(0, s, k_step):
            sl = slice(p0, p0 + k_step)
            cols = pack.col_local[t0:t1, sl].to(torch.int64)
            rows = pack.row_in_win[t0:t1, sl].to(torch.int64)
            vl = pack.vals_l[t0:t1, sl].to(torch.float32)
            vu = vl if pack.num_symmetric else \
                pack.vals_u[t0:t1, sl].to(torch.float32)
            # one-hot over the window; the sentinel (== W) gives a zero row
            oh_cols = (cols[..., None] == iota).to(torch.float32)
            oh_rows = (rows[..., None] == iota).to(torch.float32)
            xg = oh_cols @ xw                                # x[ja[p], :]
            xi = oh_rows @ xw                                # x[i, :]
            c_rows = vl[..., None] * xg
            c_cols = vu[..., None] * xi
            win = oh_rows.transpose(1, 2) @ c_rows
            win = win + oh_cols.transpose(1, 2) @ c_cols
            if acc is None:
                acc = torch.zeros_like(win)
                acc[:, w_pad - tm:] = (
                    pack.ad[t0:t1].to(torch.float32)[..., None]
                    * xw[:, w_pad - tm:])
            acc = acc + win
        out[t0:t1] = acc
    return out[..., 0] if x_full.ndim == 1 else out


def spmv_windows_onehot_plain(pack: BlockEll, x: torch.Tensor,
                              k_step: int) -> torch.Tensor:
    """Plain version of K3."""
    return windows_onehot_plain(pack, x, k_step)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _kernel_operands(pack: BlockEll, x: torch.Tensor, ndim: int):
    """Checked operands of a launch: x, the five stream pointers, and the
    (numerically symmetric, bf16 values, int16 indices) flags."""
    if not x.is_cuda:
        raise ValueError("the CUDA kernels take CUDA tensors; a CPU tensor "
                         "goes to the plain version")
    x = _operand(pack, x, ndim)
    bf16, i16 = _build.stream_flags(pack, (pack.nt, pack.s))
    pointers = (pack.vals_l.data_ptr(), pack.vals_u.data_ptr(),
                pack.col_local.data_ptr(), pack.row_in_win.data_ptr(),
                pack.ad.data_ptr())
    return x, pointers, (int(pack.num_symmetric), int(bf16), int(i16))


def spmv_windows_stream_cuda(pack: BlockEll, x: torch.Tensor) -> torch.Tensor:
    """Launch K1; returns the (NT, W) windows.  The pack's rows must not
    decrease inside a tile (``blockell.check_slot_order``, run where the
    pack was built, loaded or converted): K1 sums runs of equal rows per
    lane and warp before adding them.  S must be a multiple of 128 and the
    slot streams 16-byte aligned (``_build.check_lane_loads``)."""
    x, pointers, flags = _kernel_operands(pack, x, ndim=1)
    _build.check_lane_loads(pack, pack.s)
    out = torch.empty((pack.nt, pack.w_pad), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        K1.launch(*pointers, x.data_ptr(), out.data_ptr(),
                  pack.nt, pack.s, pack.tm, pack.w_pad, pack.n, *flags)
    return out


def spmv_windows_onehot_cuda(pack: BlockEll, x: torch.Tensor,
                             k_step: int) -> torch.Tensor:
    """Launch K3; returns the (NT, W) windows."""
    x, pointers, flags = _kernel_operands(pack, x, ndim=1)
    out = torch.empty((pack.nt, pack.w_pad), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        K3.launch(*pointers, x.data_ptr(), out.data_ptr(),
                  pack.nt, pack.s, k_step, pack.tm, pack.w_pad, pack.n,
                  *flags)
    return out


def blockell_spmv_windows(pack: BlockEll, x: torch.Tensor,
                          k_step_sublanes: int = 8,
                          variant: str = "onehot") -> torch.Tensor:
    """Per-tile windows (NT, W) before accumulation.  A CUDA ``x`` launches
    the variant's kernel; a CPU ``x`` takes its plain version."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    k_step = _k_step(pack, k_step_sublanes)
    if x.is_cuda:
        if variant == "stream":
            return spmv_windows_stream_cuda(pack, x)
        return spmv_windows_onehot_cuda(pack, x, k_step)
    x = _operand(pack, x, ndim=1)
    if variant == "stream":
        return spmv_windows_stream_plain(pack, x)
    return spmv_windows_onehot_plain(pack, x, k_step)


def blockell_spmv(pack: BlockEll, x: torch.Tensor,
                  k_step_sublanes: int = 8,
                  variant: str = "onehot") -> torch.Tensor:
    """Full product: kernel windows + effective accumulation."""
    wins = blockell_spmv_windows(pack, x, k_step_sublanes=k_step_sublanes,
                                 variant=variant)
    return overlap_add(pack, wins)
