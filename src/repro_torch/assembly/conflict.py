"""The element conflict graph and its coloring.

FEM assembly is the same scatter race the paper's SpMV scatter term has:
every element adds a dense ``edof × edof`` block into the global matrix,
and two elements sharing a node write the same diagonal entry (and,
sharing two nodes, the same off-diagonal slots).  So the conflict graph is
simply *elements sharing a DOF* — one level, no distance-2 closure needed:
sharing any node already collides on that node's diagonal, and every
off-diagonal collision requires sharing both endpoints.

Coloring reuses the ordering + RACE-style balancing pipeline of
``core/coloring.py`` (:func:`~repro_torch.core.coloring.color_graph`):
within a greedy color no two elements share a DOF, so the per-color
scatter-add is a permutation write — conflict-free without atomics.

The adjacency lists equal the JAX package's array for array (so colorings
are equal move for move); they are built by sorting (node, element)
incidences instead of its Python double loop, which at a 393,216-element
tet mesh appends some 40 M pairs one by one.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.coloring import Coloring, color_graph


def element_dofs(conn: np.ndarray, ndof_per_node: int = 1) -> np.ndarray:
    """(ne, nen·d) global DOF ids per element; node v owns dofs
    [v·d, (v+1)·d) — the interleaved elasticity layout."""
    conn = np.asarray(conn)
    if ndof_per_node == 1:
        return conn.astype(np.int32)
    d = ndof_per_node
    return (conn[:, :, None].astype(np.int64) * d
            + np.arange(d)[None, None, :]).reshape(conn.shape[0], -1).astype(
                np.int32)


def sorted_unique(keys: np.ndarray) -> np.ndarray:
    """``np.unique(keys)`` for a 1-d integer array, by a sort and a
    comparison of neighbours: equal arrays, but numpy 2.3's ``np.unique``
    took 106 s on 33 M int64 keys where ``np.sort`` took 0.5 s
    (``PERF.md`` §6)."""
    keys = np.sort(np.asarray(keys).reshape(-1))
    if keys.shape[0] < 2:
        return keys
    return keys[np.r_[True, keys[1:] != keys[:-1]]]


def element_adjacency(conn: np.ndarray) -> List[np.ndarray]:
    """Adjacency lists of the element conflict graph: e ~ f when the
    elements share at least one node, each list sorted and without e.
    (DOF interleaving is per node, so sharing a node and sharing a DOF are
    the same relation for any ``ndof_per_node``.)

    Incidences (node, element) are sorted by node; every pair of
    incidences of one node is an edge; one sort and de-duplication
    (:func:`sorted_unique`) over the keys ``e·ne + f`` orders all lists
    at once."""
    conn = np.asarray(conn)
    ne = int(conn.shape[0])
    if ne == 0:
        return []
    node = conn.reshape(-1).astype(np.int64)
    elem = np.repeat(np.arange(ne, dtype=np.int64), conn.shape[1])
    inc = sorted_unique(node * ne + elem)      # sorted by (node, element)
    node, elem = inc // ne, inc % ne
    start = np.flatnonzero(np.r_[True, node[1:] != node[:-1]])
    count = np.diff(np.r_[start, node.shape[0]])
    size = np.repeat(count, count)              # group size per incidence
    first = np.repeat(start, count)             # group start per incidence
    total = int(size.sum())
    # incidence i pairs with every incidence of its group, in group order
    offset = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(size) - size, size)
    a = np.repeat(elem, size)
    b = elem[np.repeat(first, size) + offset]
    keep = a != b
    keys = sorted_unique(a[keep] * ne + b[keep])
    src, dst = keys // ne, keys % ne
    bounds = np.searchsorted(src, np.arange(1, ne, dtype=np.int64))
    return np.split(dst, bounds)


def color_elements(conn: np.ndarray, order: str = "degree",
                   balance: bool = True,
                   provider: str = "greedy") -> Coloring:
    """Balanced coloring of the element conflict graph — same machinery
    as the row colorer (greedy first-fit or the RACE recursive
    level-group scheme), different graph.  Tet meshes are where the
    provider choice bites: ~24 elements share one node, so any classic
    coloring needs ≥ 24 colors, while RACE's level groups (BFS wavefronts
    of the mesh) cut the palette to a handful of sweeps."""
    return color_graph(element_adjacency(conn), include_indirect=False,
                       order=order, balance=balance, provider=provider)


def verify_element_coloring(conn: np.ndarray, col: Coloring) -> bool:
    """Chunk-aware invariant: no two elements of one color in *different*
    serial chunks share a node (hence no two share any scatter target,
    diagonal or off-diagonal).  Greedy colorings have singleton chunks —
    the classic per-element disjointness; RACE colorings may share nodes
    inside one level-group chunk, which an order-free scatter-add
    accumulates exactly."""
    conn = np.asarray(conn)
    grp = col.group_of_row
    for c in range(col.num_colors):
        owner: dict = {}
        for e in col.rows(c).tolist():
            g = int(grp[e]) if grp is not None else e
            for v in conn[e].tolist():
                og = owner.get(v)
                if og is not None and og != g:
                    return False
                owner[v] = g
    return True
