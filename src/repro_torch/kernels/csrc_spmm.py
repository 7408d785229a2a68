"""Block-ELL CSRC sparse matrix × multi-vector (SpMM): CUDA kernels K2 and K4.

Generalizes csrc_spmv.py to B right-hand sides (batched serving, block
Krylov solvers): X (n, B) -> per-tile (W, B) windows -> overlap-add ->
Y (n, B).  The value and index streams amortize over the B columns, so the
bytes per product grow far slower than the flops.

  'stream'  K2, csrc/blockell_spmm_stream.cu — replaces the TPU body
            kernels/csrc_spmm.py::_kernel_stream of the JAX package.
            Bound by bytes; (W, BT) x window and accumulator in shared
            memory, the B axis cut into column tiles of BT columns, K1's
            lanes and warp row runs (csrc/window_kernels.cuh) once per
            column.
  'onehot'  K4, csrc/blockell_spmm_onehot.cu — replaces
            kernels/csrc_spmm.py::_kernel.  K3's run-and-bucket body
            (csrc/window_runs.cuh) with the products formed per column: one
            block per (row tile, column tile), the (W, BT) x and result
            windows in shared memory, a fixed summation order, no float
            atomics; at B = 1 it equals K3 bit for bit.

The plain PyTorch versions (:func:`spmm_windows_stream_plain`,
:func:`spmm_windows_onehot_plain`) are taken only for a CPU tensor; a CUDA
tensor launches the kernel or raises.  ``K2.launches`` / ``K4.launches``
count the launches.
"""
from __future__ import annotations

import torch

from repro_torch.core.blockell import BlockEll, overlap_add_mm
from repro_torch.core.plan import VARIANTS
from . import _build
from ._build import _I, _P
from .csrc_spmv import (_k_step, _kernel_operands, _operand,
                        windows_onehot_plain)

K2 = _build.register(_build.Kernel(
    "blockell_spmm_stream",
    [_P] * 7 + [_I] * 10 + [_P],
    replaces="src/repro/kernels/csrc_spmm.py:70"))
K4 = _build.register(_build.Kernel(
    "blockell_spmm_onehot",
    [_P] * 7 + [_I] * 11 + [_P],
    replaces="src/repro/kernels/csrc_spmm.py:24"))

# shared-memory budget of one block's (W, BT) float32 tiles: small enough
# that several blocks stay resident on an SM
_SMEM_BUDGET = 64 * 1024


def column_tile(w_pad: int, nrhs: int, tiles_in_smem: int) -> int:
    """Columns per block: as many of the B columns as keep
    ``tiles_in_smem`` (W, BT) float32 tiles inside the budget."""
    return max(1, min(nrhs, _SMEM_BUDGET // (4 * w_pad * tiles_in_smem)))


def spmm_windows_stream_plain(pack: BlockEll, X: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: the fused gather + ``index_add_`` form."""
    from .csrc_spmv_stream import windows_fused
    return windows_fused(pack, X)


def spmm_windows_onehot_plain(pack: BlockEll, X: torch.Tensor,
                              k_step: int) -> torch.Tensor:
    """Plain version of K4: (S, W) @ (W, B) and (W, S) @ (S, B) matmuls."""
    return windows_onehot_plain(pack, X, k_step)


def spmm_windows_stream_cuda(pack: BlockEll, X: torch.Tensor) -> torch.Tensor:
    """Launch K2; returns the (NT, W, B) windows.  As for K1, the pack's
    rows must not decrease inside a tile (``blockell.check_slot_order``,
    run where the pack was built, loaded or converted) and its slot
    streams must be 16-byte aligned (``_build.check_lane_loads``)."""
    X, pointers, flags = _kernel_operands(pack, X, ndim=2)
    _build.check_lane_loads(pack, pack.s)
    nrhs = X.shape[1]
    out = torch.empty((pack.nt, pack.w_pad, nrhs), dtype=torch.float32,
                      device=X.device)
    with torch.cuda.device(X.device):
        K2.launch(*pointers, X.data_ptr(), out.data_ptr(),
                  pack.nt, pack.s, pack.tm, pack.w_pad, pack.n, nrhs,
                  column_tile(pack.w_pad, nrhs, 2), *flags)
    return out


def spmm_windows_onehot_cuda(pack: BlockEll, X: torch.Tensor,
                             k_step: int) -> torch.Tensor:
    """Launch K4; returns the (NT, W, B) windows."""
    X, pointers, flags = _kernel_operands(pack, X, ndim=2)
    nrhs = X.shape[1]
    out = torch.empty((pack.nt, pack.w_pad, nrhs), dtype=torch.float32,
                      device=X.device)
    with torch.cuda.device(X.device):
        K4.launch(*pointers, X.data_ptr(), out.data_ptr(),
                  pack.nt, pack.s, k_step, pack.tm, pack.w_pad, pack.n, nrhs,
                  column_tile(pack.w_pad, nrhs, 2), *flags)
    return out


def blockell_spmm_windows(pack: BlockEll, X: torch.Tensor,
                          k_step_sublanes: int = 8,
                          variant: str = "onehot") -> torch.Tensor:
    """Per-tile windows (NT, W, B) before accumulation.  A CUDA ``X``
    launches the variant's kernel; a CPU ``X`` takes its plain version."""
    if variant not in VARIANTS:
        raise ValueError(f"variant {variant!r} not in {VARIANTS}")
    k_step = _k_step(pack, k_step_sublanes)
    if X.is_cuda:
        if variant == "stream":
            return spmm_windows_stream_cuda(pack, X)
        return spmm_windows_onehot_cuda(pack, X, k_step)
    X = _operand(pack, X, ndim=2)
    if variant == "stream":
        return spmm_windows_stream_plain(pack, X)
    return spmm_windows_onehot_plain(pack, X, k_step)


def blockell_spmm(pack: BlockEll, X: torch.Tensor,
                  k_step_sublanes: int = 8,
                  variant: str = "onehot") -> torch.Tensor:
    """Y = A @ X for X (n, B); returns (n, B)."""
    wins = blockell_spmm_windows(pack, X, k_step_sublanes=k_step_sublanes,
                                 variant=variant)
    return overlap_add_mm(pack, wins)
