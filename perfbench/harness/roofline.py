"""The yardstick's peaks and the work each call needs, counted from the
CSRC arrays and the block width alone.

The counts are the least the algorithm moves, the same for every plan the
program may pick: each input byte read once, each output byte written
once, padding and re-reads never counted.
"""
from __future__ import annotations

from typing import Dict, Optional

F32 = 4                     # bytes of a float32 value
IDX = 4                     # bytes of an int32 column index

# Published dense peaks (NVIDIA's H100 data sheet), keyed by the name
# torch.cuda.get_device_name() gives.  A card set below its power limit
# runs slower; the run prints the limit beside its numbers.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}


def peaks_of(device_kind: str) -> Optional[Dict[str, float]]:
    """The peaks of a card by name, None for a card the table lacks."""
    return PEAKS.get(device_kind)


def product_bytes(n: int, k: int, nrhs: int,
                  numerically_symmetric: bool) -> int:
    """One y = A·X: the diagonal and the off-diagonal values (one array
    when al = au), the k column indices, X read and Y written."""
    values = n + k * (1 if numerically_symmetric else 2)
    return F32 * values + IDX * k + 2 * F32 * n * nrhs


def product_flops(n: int, nnz: int, nrhs: int) -> int:
    """A multiply for the diagonal, a multiply-add for every other
    non-zero, per column: 2·nnz − n."""
    return nrhs * (2 * nnz - n)


# Per column, one CG iteration beyond its product: the two dots (p·Ap,
# r·z), the norm of r, the updates of x, r and p (2 each) and z = r / d.
VECTOR_FLOPS_PER_ROW = 13
# x, r and p each read and written once.
VECTOR_STREAMS = 6


def iteration_bytes(n: int, k: int, nrhs: int,
                    numerically_symmetric: bool) -> int:
    return (product_bytes(n, k, nrhs, numerically_symmetric)
            + VECTOR_STREAMS * F32 * n * nrhs)


def iteration_flops(n: int, nnz: int, nrhs: int) -> int:
    return product_flops(n, nnz, nrhs) + VECTOR_FLOPS_PER_ROW * n * nrhs


def bound_s(nbytes: int, flops: int, peaks: Dict[str, float]) -> float:
    """The least time on the card: the larger of the two roofs."""
    return max(nbytes / peaks["hbm_bytes_per_s"],
               flops / peaks["fp32_flops_per_s"])
