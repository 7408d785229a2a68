"""CSRC (compressed sparse row-column) storage format.

The paper's core data structure (§2): a structurally-symmetric n×n sparse
matrix A is decomposed as A = A_D + A_L + A_U.  Only the *lower* triangle's
combinatorial structure is stored:

  ad (n,)     diagonal values
  ia (n+1,)   row pointers into the lower triangle (CSR-style)
  ja (k,)     column indices of the strictly-lower non-zeros, k = (nnz - n) / 2
  al (k,)     values of the strictly-lower non-zeros  (A_L, row-major)
  au (k,)     values at the *transposed* positions    (A_U, column-major)

i.e. al[p] = A[i, ja[p]] and au[p] = A[ja[p], i] for p in [ia[i], ia[i+1]).
A_L is CSR; A_U is CSC sharing the same (ia, ja).  This halves index memory
vs CSR and lets one pass over the lower half produce both the row (gather)
and column (scatter) contributions of the product.

The rectangular extension (§2.1) represents an n×m matrix (m > n) as
A = [A_S | A_R] where A_S is n×n structurally symmetric (CSRC) and A_R is
n×(m-n) general (auxiliary CSR: iar, jar, ar).

Host-side construction is numpy; the resulting container holds torch
tensors on the host (zero-copy views of the numpy arrays).  ``CSRC.to``
moves them to a device when an executor binds the matrix.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

Array = np.ndarray


def _t(a) -> torch.Tensor:
    """numpy array -> host tensor sharing its memory (a read-only array is
    copied: tensors are writable)."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _np(a) -> Array:
    """Host numpy view of a container field (a device tensor is copied
    back; a host tensor is shared, not copied)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


_ARRAY_FIELDS = ("ad", "ia", "ja", "al", "au", "iar", "jar", "ar")


@dataclasses.dataclass(frozen=True)
class CSRC:
    """Device-ready CSRC matrix (square structurally-symmetric part + optional
    rectangular CSR tail)."""

    n: int                      # number of rows (= cols of the square part)
    m: int                      # total number of columns (m == n if square)
    ad: torch.Tensor             # (n,) diagonal
    ia: torch.Tensor             # (n+1,) lower-triangle row pointers
    ja: torch.Tensor             # (k,) lower-triangle column indices
    al: torch.Tensor             # (k,) lower values
    au: torch.Tensor             # (k,) upper (transpose-position) values
    # Rectangular tail A_R (n × (m-n)) stored as CSR; empty arrays if square.
    iar: torch.Tensor            # (n+1,)
    jar: torch.Tensor            # (kr,) column indices in [0, m-n)
    ar: torch.Tensor             # (kr,)
    numerically_symmetric: bool = False

    @property
    def k(self) -> int:
        return int(self.ja.shape[0])

    @property
    def nnz(self) -> int:
        """Non-zeros of the square part counting both halves + diagonal,
        plus the rectangular tail."""
        return self.n + 2 * self.k + int(self.jar.shape[0])

    @property
    def is_square(self) -> bool:
        return self.m == self.n

    def working_set_bytes(self) -> int:
        """Paper Table 1's ``ws`` column: bytes touched by one product."""
        total = 0
        for a in (self.ad, self.ia, self.ja, self.al, self.au,
                  self.iar, self.jar, self.ar):
            total += a.numel() * a.element_size()
        # source + destination vectors
        total += self.m * self.ad.element_size()
        total += self.n * self.ad.element_size()
        return total

    @property
    def device(self) -> torch.device:
        return self.ad.device

    def to(self, device) -> "CSRC":
        """The same matrix with every array on ``device`` (self when it
        already lives there)."""
        device = torch.device(device)
        if all(getattr(self, f).device == device for f in _ARRAY_FIELDS):
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _ARRAY_FIELDS})


def _dedup_coo(rows: Array, cols: Array, vals: Array, n: int, m: int):
    """Sum duplicate (row, col) entries; return sorted COO."""
    order = np.lexsort((cols, rows))
    rows, cols, vals = rows[order], cols[order], vals[order]
    key = rows.astype(np.int64) * m + cols.astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    out_vals = np.zeros(uniq.shape[0], dtype=vals.dtype)
    np.add.at(out_vals, inv, vals)
    out_rows = (uniq // m).astype(np.int32)
    out_cols = (uniq % m).astype(np.int32)
    return out_rows, out_cols, out_vals


def symmetrize_pattern(rows: Array, cols: Array, vals: Array, n: int):
    """Make the pattern of the square part structurally symmetric by adding
    explicit zeros at missing transpose positions (standard FEM preprocessing:
    global FEM matrices are pattern-symmetric by construction; general inputs
    are padded)."""
    in_sq = (rows < n) & (cols < n)
    r, c, v = rows[in_sq], cols[in_sq], vals[in_sq]
    key = set(zip(r.tolist(), c.tolist()))
    add_r, add_c = [], []
    for (i, j) in key:
        if i != j and (j, i) not in key:
            add_r.append(j)
            add_c.append(i)
    if add_r:
        rows = np.concatenate([rows, np.asarray(add_r, dtype=rows.dtype)])
        cols = np.concatenate([cols, np.asarray(add_c, dtype=cols.dtype)])
        vals = np.concatenate([vals, np.zeros(len(add_r), dtype=vals.dtype)])
    return rows, cols, vals


def from_coo(rows: Array, cols: Array, vals: Array, n: int,
             m: Optional[int] = None, dtype=np.float32,
             pad_pattern: bool = True) -> CSRC:
    """Build a CSRC matrix from COO triplets.

    The square n×n leading block must be (or is padded to be) structurally
    symmetric.  Columns >= n go to the rectangular CSR tail.
    """
    m = n if m is None else m
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    vals = np.asarray(vals, dtype=dtype)
    if rows.size:
        assert rows.max() < n and cols.max() < m, "index out of range"
    if pad_pattern:
        rows, cols, vals = symmetrize_pattern(rows, cols, vals, n)
    rows, cols, vals = _dedup_coo(rows, cols, vals, n, m)

    sq = cols < n
    r_sq, c_sq, v_sq = rows[sq], cols[sq], vals[sq]

    # --- diagonal ---
    ad = np.zeros(n, dtype=dtype)
    diag = r_sq == c_sq
    ad[r_sq[diag]] = v_sq[diag]

    # --- strictly lower triangle, row-major (already lexsorted) ---
    low = c_sq < r_sq
    r_lo, c_lo, v_lo = r_sq[low], c_sq[low], v_sq[low]
    k = r_lo.shape[0]
    ia = np.zeros(n + 1, dtype=np.int32)
    np.add.at(ia, r_lo + 1, 1)
    ia = np.cumsum(ia, dtype=np.int32)
    ja = c_lo.astype(np.int32)
    al = v_lo.astype(dtype)

    # --- upper values aligned to the lower slots: au[p] = A[ja[p], i(p)] ---
    up = c_sq > r_sq
    r_up, c_up, v_up = r_sq[up], c_sq[up], v_sq[up]
    # Lower slot p sits at (i, j) = (row_of_slot[p], ja[p]); its transpose
    # partner is the upper entry at (j, i).  Keys of lower slots are sorted
    # ascending (COO was lexsorted by (row, col)), so align via searchsorted.
    au = np.zeros(k, dtype=dtype)
    row_of_slot = np.repeat(np.arange(n, dtype=np.int32), np.diff(ia))
    if k:
        key_lower = row_of_slot.astype(np.int64) * n + ja.astype(np.int64)
        key_upper = c_up.astype(np.int64) * n + r_up.astype(np.int64)
        pos = np.searchsorted(key_lower, key_upper)
        ok = (pos < k) & (key_lower[np.minimum(pos, k - 1)] == key_upper)
        au[pos[ok]] = v_up[ok].astype(dtype)

    num_sym = bool(k == 0 or np.allclose(al, au))

    # --- rectangular tail ---
    rect = ~sq
    r_rc, c_rc, v_rc = rows[rect], cols[rect] - n, vals[rect]
    kr = r_rc.shape[0]
    iar = np.zeros(n + 1, dtype=np.int32)
    np.add.at(iar, r_rc + 1, 1)
    iar = np.cumsum(iar, dtype=np.int32)
    jar = c_rc.astype(np.int32)
    ar = v_rc.astype(dtype)

    return CSRC(
        n=n, m=m,
        ad=_t(ad), ia=_t(ia), ja=_t(ja),
        al=_t(al), au=_t(au),
        iar=_t(iar), jar=_t(jar), ar=_t(ar),
        numerically_symmetric=num_sym,
    )


def from_coo_symmetric(rows: Array, cols: Array, vals: Array, n: int,
                       dtype=np.float32) -> CSRC:
    """Build a square CSRC matrix from COO triplets whose pattern is
    *already* structurally symmetric — the shape FEM assembly produces by
    construction (every element contributes a dense symmetric block of
    positions).  Skips the O(k) transpose-completion set walk of
    :func:`symmetrize_pattern`; duplicate entries are summed as usual."""
    return from_coo(rows, cols, vals, n=n, m=n, dtype=dtype,
                    pad_pattern=False)


def from_assembly(n: int, ia: Array, ja: Array, ad: Array, al: Array,
                  au: Array, dtype=np.float32) -> CSRC:
    """Assemble-side constructor: build a square CSRC container directly
    from precomputed structure (``ia``/``ja`` — e.g. an
    :class:`repro_torch.assembly.scatter.AssemblySchedule`'s slot layout) and
    freshly scattered value streams.  No dedup, no pattern work — this is
    the value-refresh path FEM time stepping takes every step, so it must
    stay O(k) array conversions only."""
    ia = np.asarray(ia, dtype=np.int32)
    ja = np.asarray(ja, dtype=np.int32)
    ad = np.asarray(ad, dtype=dtype)
    al = np.asarray(al, dtype=dtype)
    au = np.asarray(au, dtype=dtype)
    assert ia.shape == (n + 1,) and ad.shape == (n,)
    assert al.shape == ja.shape == au.shape
    num_sym = bool(ja.shape[0] == 0 or np.array_equal(al, au))
    empty_i = np.zeros(n + 1, dtype=np.int32)
    empty = np.zeros(0, dtype=np.int32)
    return CSRC(
        n=n, m=n,
        ad=_t(ad), ia=_t(ia), ja=_t(ja),
        al=_t(al), au=_t(au),
        iar=_t(empty_i), jar=_t(empty),
        ar=_t(empty.astype(dtype)),
        numerically_symmetric=num_sym,
    )


def from_scipy(A, dtype=np.float32) -> CSRC:
    """Ingest any ``scipy.sparse`` matrix.

    The square leading block is pattern-symmetrized with explicit zeros at
    missing transpose positions (the standard CSRC preprocessing), values
    split into ad / al / au; columns ``>= n`` land in the rectangular CSR
    tail.  scipy is imported lazily — it is an ingestion convenience, not a
    package dependency.
    """
    try:
        import scipy.sparse as sp
    except ImportError as e:   # pragma: no cover - scipy present in CI
        raise ImportError(
            "CSRC.from_scipy requires scipy; install it or build via "
            "from_coo directly") from e
    if not sp.issparse(A):
        raise TypeError(
            f"from_scipy expects a scipy.sparse matrix, got "
            f"{type(A).__name__}")
    n, m = A.shape
    if m < n:
        raise ValueError(
            "CSRC requires m >= n (the rectangular extension stores wide "
            "matrices only); transpose the input first")
    C = A.tocoo()
    return from_coo(C.row, C.col, C.data, n=n, m=m, dtype=dtype,
                    pad_pattern=True)


def from_dense(A: Array, dtype=np.float32) -> CSRC:
    """Build from a dense matrix, keeping exact non-zero pattern (plus the
    symmetrizing explicit zeros)."""
    A = np.asarray(A)
    n, m = A.shape
    assert m >= n, "CSRC requires m >= n (rectangular extension is n x m, m>n)"
    rows, cols = np.nonzero(A)
    vals = A[rows, cols]
    return from_coo(rows, cols, vals, n=n, m=m, dtype=dtype)


def to_dense(M: CSRC) -> Array:
    """Oracle-side expansion back to dense (numpy)."""
    n, m = M.n, M.m
    A = np.zeros((n, m), dtype=_np(M.ad).dtype)
    A[np.arange(n), np.arange(n)] = _np(M.ad)
    ia = _np(M.ia)
    ja = _np(M.ja)
    al = _np(M.al)
    au = _np(M.au)
    row_of_slot = np.repeat(np.arange(n), np.diff(ia))
    A[row_of_slot, ja] = al
    A[ja, row_of_slot] = au
    iar = _np(M.iar)
    if M.jar.shape[0]:
        row_r = np.repeat(np.arange(n), np.diff(iar))
        A[row_r, _np(M.jar) + n] = _np(M.ar)
    return A


def row_of_slot(M: CSRC) -> Array:
    """Expand ia to a per-slot row index (host-side helper)."""
    ia = _np(M.ia)
    return np.repeat(np.arange(M.n, dtype=np.int32), np.diff(ia))


def bandwidth(M: CSRC) -> int:
    """Maximum |i - j| over stored off-diagonal entries (paper §4.2 discusses
    band structure as what drives locality)."""
    if M.k == 0:
        return 0
    ros = row_of_slot(M)
    return int(np.max(ros - _np(M.ja)))


def nnz_per_row(M: CSRC) -> Array:
    """Full (both halves + diag + rect tail) non-zeros per row — the load
    balance metric used for nnz-balanced partitioning."""
    n = M.n
    ia = _np(M.ia)
    lower = np.diff(ia)
    upper = np.bincount(_np(M.ja), minlength=n).astype(np.int64)
    rect = np.diff(_np(M.iar))
    return lower + upper + rect + 1


# ---------------------------------------------------------------------------
# Transpose product support (paper §5: transpose = swap al/au)
# ---------------------------------------------------------------------------

def transpose(M: CSRC) -> CSRC:
    """O(1): swapping al and au yields A_S^T.  Only valid for square CSRC."""
    assert M.is_square, "transpose of the rectangular extension not supported"
    return dataclasses.replace(M, al=M.au, au=M.al)


# ---------------------------------------------------------------------------
# Synthetic matrix generators (benchmark + test suite substrate; the UF
# collection is not available offline, so we generate the same *classes*:
# FEM band matrices, quasi-diagonal, random sparse, dense)
# ---------------------------------------------------------------------------

def poisson2d(nx: int, ny: Optional[int] = None, dtype=np.float32) -> CSRC:
    """5-point Laplacian on an nx×ny grid — the canonical FEM-like band matrix
    (numerically symmetric, bandwidth nx)."""
    ny = nx if ny is None else ny
    n = nx * ny
    rows, cols, vals = [], [], []
    for y in range(ny):
        for x in range(nx):
            i = y * nx + x
            rows.append(i); cols.append(i); vals.append(4.0)
            for dx, dy in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                xx, yy = x + dx, y + dy
                if 0 <= xx < nx and 0 <= yy < ny:
                    j = yy * nx + xx
                    rows.append(i); cols.append(j); vals.append(-1.0)
    return from_coo(np.asarray(rows), np.asarray(cols),
                    np.asarray(vals, dtype=np.float64), n=n, dtype=dtype)


def fem_band(n: int, half_band: int, seed: int = 0, fill: float = 0.6,
             numeric_symmetric: bool = False, dtype=np.float32) -> CSRC:
    """Random band matrix with structurally-symmetric pattern: each row gets
    ~fill·half_band entries inside the band, mirrored. Diagonally dominant."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(n):
        lo = max(0, i - half_band)
        cand = np.arange(lo, i)
        if cand.size:
            take = rng.random(cand.size) < fill
            for j in cand[take]:
                vl = rng.standard_normal()
                vu = vl if numeric_symmetric else rng.standard_normal()
                rows += [i, int(j)]
                cols += [int(j), i]
                vals += [vl, vu]
    rows += list(range(n))
    cols += list(range(n))
    vals += list(2.0 * half_band * np.ones(n))
    return from_coo(np.asarray(rows), np.asarray(cols),
                    np.asarray(vals, dtype=np.float64), n=n, dtype=dtype,
                    pad_pattern=False)


def skewed_band(n: int, wide_band: int, narrow_band: int = 3,
                wide_frac: float = 0.06, seed: int = 0,
                numeric_symmetric: bool = False, dtype=np.float32) -> CSRC:
    """Band matrix with a *skewed* row-length distribution: the first
    ``wide_frac·n`` rows carry a dense band of half-width ``wide_band``,
    the rest a narrow band of ``narrow_band`` — the skewed-FEM shape where
    a rectangular block-ELL grid pads every tile to the densest one and
    the flat-grid kernel does not (docs/DESIGN.md §4)."""
    rng = np.random.default_rng(seed)
    n_wide = max(1, int(round(wide_frac * n)))
    rows, cols, vals = [], [], []
    for i in range(n):
        width = wide_band if i < n_wide else narrow_band
        for j in range(max(0, i - width), i):
            vl = rng.standard_normal()
            vu = vl if numeric_symmetric else rng.standard_normal()
            rows += [i, j]
            cols += [j, i]
            vals += [vl, vu]
    rows += list(range(n))
    cols += list(range(n))
    vals += list(2.0 * wide_band * np.ones(n))
    return from_coo(np.asarray(rows), np.asarray(cols),
                    np.asarray(vals, dtype=np.float64), n=n, dtype=dtype,
                    pad_pattern=False)


def random_symmetric_pattern(n: int, avg_nnz_per_row: int, seed: int = 0,
                             dtype=np.float32) -> CSRC:
    """Unstructured pattern (cage15/F1-like: no band structure)."""
    rng = np.random.default_rng(seed)
    k = n * avg_nnz_per_row // 2
    r = rng.integers(1, n, size=k, dtype=np.int64)
    c = (rng.random(k) * r).astype(np.int64)  # strictly lower
    v = rng.standard_normal(k)
    vu = rng.standard_normal(k)
    rows = np.concatenate([r, c, np.arange(n)])
    cols = np.concatenate([c, r, np.arange(n)])
    vals = np.concatenate([v, vu, np.full(n, float(avg_nnz_per_row) + 1.0)])
    return from_coo(rows, cols, vals, n=n, dtype=dtype, pad_pattern=False)


def powerlaw_laplacian(n: int, attach: int = 4, seed: int = 0,
                       dtype=np.float32) -> CSRC:
    """Graph Laplacian of a Barabási–Albert preferential-attachment graph
    with randomly shuffled vertex labels — the unstructured scenario class
    (social/power/circuit graphs) none of the band-ish generators cover.

    Two properties matter downstream: the power-law degree distribution
    gives a high nnz-per-row CoV (hub rows), and the label shuffle spreads
    ``ja`` across the full index range (bandwidth ~ n), so windowed paths
    either pad explosively or fall infeasible.  All entries are small
    integers (degree diagonal, -1 off-diagonals), exactly representable in
    float32: products against dyadic vectors are accumulation-order
    independent, which is what lets tests compare kernels bit-for-bit
    against the dense oracle."""
    assert n > attach >= 1
    rng = np.random.default_rng(seed)
    edges = []
    repeated: list = []             # endpoint pool; sampling it uniformly
    targets = list(range(attach))   # is preferential attachment by degree
    for source in range(attach, n):
        for t in targets:
            edges.append((source, t))
        repeated.extend(targets)
        repeated.extend([source] * attach)
        seen: set = set()
        targets = []
        while len(targets) < attach:
            x = int(repeated[rng.integers(0, len(repeated))])
            if x not in seen:
                seen.add(x)
                targets.append(x)
    perm = rng.permutation(n)
    e = perm[np.asarray(edges, dtype=np.int64)]         # (ne, 2) relabeled
    u, v = e[:, 0], e[:, 1]
    deg = np.zeros(n, dtype=np.int64)
    np.add.at(deg, u, 1)
    np.add.at(deg, v, 1)
    rows = np.concatenate([u, v, np.arange(n)])
    cols = np.concatenate([v, u, np.arange(n)])
    vals = np.concatenate([-np.ones(2 * e.shape[0]), deg.astype(np.float64)])
    return from_coo(rows, cols, vals, n=n, dtype=dtype, pad_pattern=False)


def paper_example(dtype=np.float32) -> CSRC:
    """The paper's 9×9 conflict-graph example: a structurally-symmetric
    pattern with exactly 12 direct conflicts (stored lower entries) and 7
    indirect conflicts (non-adjacent row pairs sharing a direct neighbor)
    — the counts §3.2 reports for its illustration.  Values are small
    integers so products against dyadic vectors are exact in float32."""
    lower = np.asarray([(1, 0), (2, 0), (4, 0), (6, 0), (2, 1), (4, 1),
                        (4, 2), (6, 2), (7, 3), (8, 3), (7, 5), (8, 6)],
                       dtype=np.int64)
    r, c = lower[:, 0], lower[:, 1]
    deg = np.zeros(9, dtype=np.int64)
    np.add.at(deg, r, 1)
    np.add.at(deg, c, 1)
    rows = np.concatenate([r, c, np.arange(9)])
    cols = np.concatenate([c, r, np.arange(9)])
    vals = np.concatenate([-np.ones(2 * len(lower)),
                           (deg + 1).astype(np.float64)])
    return from_coo(rows, cols, vals, n=9, dtype=dtype, pad_pattern=False)


def dense_matrix(n: int, seed: int = 0, dtype=np.float32) -> CSRC:
    """The paper's dense_1000 control case."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n)).astype(dtype)
    return from_dense(A, dtype=dtype)


def rectangular_fem(n: int, extra_cols: int, half_band: int, seed: int = 0,
                    dtype=np.float32) -> CSRC:
    """Paper §2.1: overlapping-subdomain matrices A = [A_S | A_R]."""
    rng = np.random.default_rng(seed)
    base = fem_band(n, half_band, seed=seed, numeric_symmetric=True,
                    dtype=dtype)
    kr = max(1, n // 4)
    r = rng.integers(0, n, size=kr, dtype=np.int64)
    c = rng.integers(0, extra_cols, size=kr, dtype=np.int64) + n
    v = rng.standard_normal(kr)
    # rebuild with the tail via COO to keep construction single-path
    A = to_dense(base)
    full = np.zeros((n, n + extra_cols), dtype=A.dtype)
    full[:, :n] = A
    full[r, c] = v.astype(A.dtype)
    return from_dense(full, dtype=dtype)


# quickstart-facing alias: CSRC.from_scipy(sp_matrix) reads naturally at
# ingestion call sites
CSRC.from_scipy = staticmethod(from_scipy)
