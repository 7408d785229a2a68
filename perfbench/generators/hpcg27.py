"""HPCG's 27-point stencil on one process's nx x ny x nz local grid.

HPCG 3.1 (Dongarra, Heroux, Luszczek; ``GenerateProblem_ref.cpp``): row
``i = ix + nx * (iy + ny * iz)``, one non-zero for every grid point of the
3 x 3 x 3 block around it that lies inside the local grid, the
configuration's ``diagonal`` (HPCG: 26) on the diagonal and its
``off_diagonal`` (HPCG: -1) everywhere else, in its ``precision``.  With
one off-diagonal value the matrix is structurally and numerically
symmetric, so only its strict lower triangle is built, in the CSRC layout:
``ia`` row pointers, ``ja`` column indices ascending within a row, ``al`` =
``au`` the values, ``ad`` the diagonal.

Everything is numpy on the host and vectorised over the 13 lower offsets:
O(k) work and no sort.  The same arrays go to the program (through
``repro_torch.core.csrc.from_assembly``) and to the plain reference.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

def lower_offsets(nx: int, ny: int):
    """The 13 neighbour offsets (dx, dy, dz) whose column lies below the
    diagonal, ordered by their linear offset, most negative first, so that
    each row's columns come out ascending."""
    offs = []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                d = dx + nx * dy + nx * ny * dz
                if d < 0:
                    offs.append((d, dx, dy, dz))
    offs.sort()
    return [(dx, dy, dz) for _, dx, dy, dz in offs]


def closed_forms(nx: int, ny: int, nz: int) -> Dict[str, int]:
    """n, nnz, lower slots k and bandwidth from the grid alone."""
    n = nx * ny * nz
    nnz = (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    return {"n": n, "nnz": nnz, "k": (nnz - n) // 2,
            "bandwidth": nx * ny + nx + 1}


def build(cfg: Dict) -> Dict[str, object]:
    """CSRC arrays of the stencil that the configuration ``cfg`` states:
    its ``grid`` = (nx, ny, nz), ``diagonal``, ``off_diagonal``,
    ``precision`` and ``numerically_symmetric``, which has to be true."""
    if cfg["numerically_symmetric"] is not True:
        raise ValueError("the 27-point stencil with one off-diagonal value "
                         "is numerically symmetric")
    dtype = np.dtype(cfg["precision"])
    nx, ny, nz = (int(g) for g in cfg["grid"])
    n = nx * ny * nz
    ix = np.tile(np.arange(nx, dtype=np.int32), ny * nz)
    iy = np.tile(np.repeat(np.arange(ny, dtype=np.int32), nx), nz)
    iz = np.repeat(np.arange(nz, dtype=np.int32), nx * ny)
    rows = np.arange(n, dtype=np.int32)
    offs = lower_offsets(nx, ny)
    cols = np.full((n, len(offs)), -1, dtype=np.int32)
    for c, (dx, dy, dz) in enumerate(offs):
        ok = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
              & (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz))
        d = dx + nx * dy + nx * ny * dz
        cols[ok, c] = rows[ok] + d
    valid = cols >= 0
    counts = valid.sum(axis=1, dtype=np.int64)
    ia = np.zeros(n + 1, dtype=np.int32)
    ia[1:] = np.cumsum(counts)
    ja = cols[valid]                   # row-major: rows in order, columns up
    k = ja.shape[0]
    al = np.full(k, cfg["off_diagonal"], dtype=dtype)
    return {"n": n, "ia": ia, "ja": ja,
            "ad": np.full(n, cfg["diagonal"], dtype=dtype),
            "al": al, "au": al, "numerically_symmetric": True}
