"""Label spreading on a Graph500 Kronecker graph: the operator
A = I - alpha * D^{-1/2} W D^{-1/2}.

The graph is Graph500's (graph500.org benchmark specification, the
Kronecker generator of its reference code): 2^scale vertices and
edgefactor * 2^scale edges, each edge placed by one draw per level among
the four quadrants of the initiator [[A, B], [C, D]] (D = 1 - A - B - C),
its row bit the draw's half and its column bit the quadrant's side, then
every vertex label permuted at random.  All of it comes from the file's
``graph_seed`` (numpy's PCG64 streams spawned from it), never from a run's
seed, so every run on every machine sees one matrix.

W is the graph's 0/1 adjacency: self-loops are dropped, an edge drawn twice
counts once, and each edge is taken in both directions.  d_i is the degree
of vertex i.  The operator is the one Zhou, Bousquet, Lal, Weston and
Schölkopf ("Learning with Local and Global Consistency", NIPS 2004) solve
for the label scores F = (I - alpha S)^{-1} Y, with S = D^{-1/2} W D^{-1/2}:
a diagonal of 1 and -alpha / sqrt(d_i d_j) on every edge.  Its spectrum
lies in [1 - alpha, 1 + alpha], so it is symmetric positive definite.  An
isolated vertex keeps its diagonal of 1 and no other entry.

Returned as CSRC arrays: ``ia`` row pointers, ``ja`` the strict lower
triangle's columns, ascending within a row, ``al`` = ``au`` the values,
``ad`` the diagonal.  Everything is numpy on the host, vectorised, with one
sort of the edge keys and no ``np.unique``.
"""
from __future__ import annotations

import concurrent.futures
import os
from typing import Dict, Tuple

import numpy as np

BLOCKS = 16     # streams the edges are drawn in: fixed, so that the graph
                # does not depend on how many threads draw it


def kronecker_edges(scale: int, edgefactor: int, initiator,
                    seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Graph500's edge list: (u, v) int32 arrays of edgefactor * 2^scale
    edges over 2^scale vertices, labels permuted, as drawn (self-loops and
    repeats included).  The edges are drawn in BLOCKS independent streams
    spawned from ``seed``, one thread a block, and the labels' permutation
    from one more."""
    a, b, c = (float(p) for p in initiator)
    if not (a > 0 and b > 0 and c > 0 and a + b + c < 1):
        raise ValueError(f"initiator A, B, C must be positive with A + B + C"
                         f" < 1, got {initiator}")
    n = 1 << scale
    m = edgefactor * n
    a32, ab, abc = np.float32(a), np.float32(a + b), np.float32(a + b + c)
    streams = np.random.SeedSequence(int(seed)).spawn(BLOCKS + 1)
    perm = np.random.default_rng(streams[BLOCKS]).permutation(n).astype(
        np.int32)
    u = np.zeros(m, dtype=np.int32)
    v = np.zeros(m, dtype=np.int32)
    ends = np.linspace(0, m, BLOCKS + 1).astype(np.int64)

    def draw(block: int) -> None:
        rng = np.random.default_rng(streams[block])
        ub, vb = u[ends[block]:ends[block + 1]], v[ends[block]:ends[block + 1]]
        for level in range(scale):
            r = rng.random(ub.shape[0], dtype=np.float32)
            # quadrant by r: [0, A) top left, [A, A+B) top right,
            # [A+B, A+B+C) bottom left, the rest bottom right
            low = r >= ab
            right = (r >= abc) | ((r >= a32) & ~low)
            bit = np.int32(1 << level)
            ub += low * bit
            vb += right * bit
        ub[:] = perm[ub]
        vb[:] = perm[vb]

    with concurrent.futures.ThreadPoolExecutor(
            max_workers=min(BLOCKS, os.cpu_count() or 1)) as pool:
        list(pool.map(draw, range(BLOCKS)))
    return u, v


def lower_pattern(n: int, u: np.ndarray, v: np.ndarray) -> Tuple[np.ndarray,
                                                                  np.ndarray]:
    """The strict lower triangle of W from an edge list: (rows, cols), int32,
    sorted by row and then column, self-loops dropped, each pair once."""
    keep = u != v
    row = np.maximum(u, v)[keep].astype(np.int64)
    col = np.minimum(u, v)[keep]
    key = row * n
    key += col
    key.sort()
    first = np.empty(key.shape[0], dtype=bool)
    first[:1] = True
    np.not_equal(key[1:], key[:-1], out=first[1:])
    key = key[first]
    return (key // n).astype(np.int32), (key % n).astype(np.int32)


def build(cfg: Dict) -> Dict[str, object]:
    """CSRC arrays of label spreading on the graph that ``cfg`` states: its
    ``scale``, ``edgefactor``, ``initiator`` (A, B, C), ``graph_seed``,
    ``alpha``, ``precision`` and ``numerically_symmetric``, which has to be
    true."""
    if cfg["numerically_symmetric"] is not True:
        raise ValueError("I - alpha D^-1/2 W D^-1/2 of an undirected graph "
                         "is numerically symmetric")
    alpha = float(cfg["alpha"])
    if not 0 < alpha < 1:
        raise ValueError(f"alpha must lie in (0, 1), got {alpha}")
    dtype = np.dtype(cfg["precision"])
    scale = int(cfg["scale"])
    n = 1 << scale
    u, v = kronecker_edges(scale, int(cfg["edgefactor"]), cfg["initiator"],
                           int(cfg["graph_seed"]))
    rows, cols = lower_pattern(n, u, v)
    del u, v
    lower = np.bincount(rows, minlength=n)
    degree = lower + np.bincount(cols, minlength=n)
    ia = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(lower, out=ia[1:])
    scale_of = 1.0 / np.sqrt(np.maximum(degree, 1).astype(np.float64))
    al = (-alpha * scale_of[rows] * scale_of[cols]).astype(dtype)
    return {"n": n, "ia": ia, "ja": cols,
            "ad": np.ones(n, dtype=dtype),
            "al": al, "au": al, "numerically_symmetric": True}


def summary(arrays: Dict[str, object]) -> Dict[str, int]:
    """n, lower slots k, nnz, the longest lower row and the isolated
    vertices of a built graph: the configuration's ``expected`` block."""
    n, ia, ja = arrays["n"], arrays["ia"], arrays["ja"]
    lower = np.diff(ia)
    degree = lower + np.bincount(ja, minlength=n)
    k = int(ja.shape[0])
    return {"n": int(n), "k": k, "nnz": int(n) + 2 * k,
            "longest_lower_row": int(lower.max()) if n else 0,
            "isolated": int((degree == 0).sum())}
