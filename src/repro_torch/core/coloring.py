"""The colorful partitioning method (paper §3.2).

Rows are vertices of the conflict graph G[A]; two rows conflict when
processing them concurrently could write the same y position:

  * direct conflict:  row j > i has a stored lower entry in column i
    (thread owning j scatters into y[i] while thread owning i writes y[i]);
  * indirect conflict: rows u, v share a neighbor in the direct graph
    (both scatter into the same third row's y slot).

Two coloring providers build the conflict-free color classes:

``greedy`` — sequential coloring of G[A], **largest-degree-first**
(Welsh–Powell): high-degree vertices are colored while many colors are
still unused, which empirically never needs more colors than the
unordered first-fit on our matrix classes — ``color_rows`` additionally
guards the invariant by falling back to the natural-order result if
degree ordering ever came out worse.  The product is computed
color-by-color (serial across colors, parallel inside); within a color
every write target is unique.

``race`` — the recursive level-group scheme of RACE (Alappat et al.,
arXiv:1907.06487): BFS levels of the conflict graph from a
locality-preserving seed (the lowest-index minimum-degree vertex of each
component — a band end / mesh corner, so levels sweep the rows in index
order), recursively bipartitioned into even/odd level groups.  Same-parity
groups are ≥ 2 levels apart, hence conflict-free against each other; a
group whose induced subgraph is still too large is recursively split the
same way (its sub-parity refines the parent color).  The classes that come
out are unions of *contiguous level ranges* — the locality the paper's
§3.2 criticism asks for — at the price of a weaker intra-class guarantee:
rows of one color are partitioned into **serial chunks** (``group_of_row``,
one chunk per leaf level group) and write targets are only disjoint
*across* chunks.  Inside a chunk the modeled machine runs rows serially,
and the executors scatter with order-free ``index_add_`` (sum
combining), so intra-chunk sharing is numerically exact either way.
``verify_coloring`` checks exactly this chunk-aware invariant (which
degenerates to the classic per-row one for greedy colorings).

On top of either provider sits a RACE-style balancing pass: rows are moved
from over-full color classes into under-full ones (staying conflict-free
at the *classic* distance — strictly stronger than the chunk invariant —
and never adding a color), preferring the class whose members are nearest
in row index.

On the card this maps to: rows of one color form a batch whose scatter is
one ``index_add_`` pair (schedule.colorful_apply) — fewer colors mean fewer
serial launches, and contiguous classes keep the x/y working set in cache
between them.

Everything here is numpy and Python, a copy of the JAX package's module on
this package's ``csrc.row_of_slot``: colorings are equal to the JAX
package's, move for move.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional

import numpy as np

from .csrc import CSRC, _np, row_of_slot

# Coloring providers ``color_graph`` (and everything above it) accepts.
PROVIDERS = ("greedy", "race")

# RACE recursion bounds: a leaf level group bigger than n / (2·p_target)
# rows is recursively re-split (so every color offers ≥ ~2·p chunks of
# modeled parallelism) until the bipartition stops making progress or the
# depth cap is hit.
RACE_P_TARGET = 8
RACE_MAX_DEPTH = 4


@dataclasses.dataclass(frozen=True)
class Coloring:
    color_of_row: np.ndarray     # (n,) color id per row
    num_colors: int
    # rows grouped by color, concatenated; color c owns
    # rows_by_color[color_ptr[c]:color_ptr[c+1]]
    rows_by_color: np.ndarray
    color_ptr: np.ndarray
    # which provider built the classes ('greedy' | 'race')
    provider: str = "greedy"
    # RACE level-group metadata (None for greedy): the top-level BFS level
    # per row, and the serial-chunk id per row — rows sharing (color, group)
    # may share write targets (executed as one serial chunk); rows sharing a
    # color across different groups never do.
    level_of_row: Optional[np.ndarray] = None
    group_of_row: Optional[np.ndarray] = None

    def rows(self, c: int) -> np.ndarray:
        return self.rows_by_color[self.color_ptr[c]:self.color_ptr[c + 1]]

    def class_sizes(self) -> np.ndarray:
        return np.diff(self.color_ptr)


def direct_adjacency(M: CSRC) -> List[np.ndarray]:
    """Adjacency lists of the *direct* conflict graph: i ~ ja[p] for every
    stored lower slot p of row i (symmetric)."""
    n = M.n
    ros = row_of_slot(M)
    ja = _np(M.ja)
    adj: List[List[int]] = [[] for _ in range(n)]
    for i, j in zip(ros.tolist(), ja.tolist()):
        adj[i].append(j)
        adj[j].append(i)
    return [np.unique(np.asarray(a, dtype=np.int64)) for a in adj]


def _mark_forbidden(v: int, adj, color, include_indirect: bool,
                    mask: np.ndarray) -> list:
    """Mark ``mask[c] = True`` for every color already used within conflict
    distance of ``v`` (distance 2 when indirect conflicts are included).

    ``mask`` is the reusable boolean scratch of the greedy/balance hot
    loops — no per-vertex ``set`` is built.  Returns the list of marked
    color arrays so the caller can reset only the touched entries.  (The
    2-hop walk may mark v's own color via the u→v back-edge; both callers
    skip the vertex's current color before consulting the mask, so the
    class assignment is identical to the historical set-based scan.)
    """
    touched = []
    cu = color[adj[v]]
    cu = cu[cu >= 0]
    mask[cu] = True
    touched.append(cu)
    if include_indirect:
        for u in adj[v]:
            cw = color[adj[u]]
            cw = cw[cw >= 0]
            mask[cw] = True
            touched.append(cw)
    return touched


def _forbidden_colors(v: int, adj, color, include_indirect: bool) -> set:
    """Reference (set-returning) view of the forbidden-color scan — kept
    for tests and debugging; the hot loops use :func:`_mark_forbidden`'s
    boolean scratch instead."""
    forbidden = set()
    for u in adj[v]:
        cu = color[u]
        if cu >= 0:
            forbidden.add(int(cu))
        if include_indirect:
            for w in adj[u]:
                cw = color[w]
                if cw >= 0 and w != v:
                    forbidden.add(int(cw))
    return forbidden


def _greedy(adj, order, include_indirect: bool) -> np.ndarray:
    n = len(adj)
    color = np.full(n, -1, dtype=np.int64)
    mask = np.zeros(n + 2, dtype=bool)      # reusable forbidden scratch
    for v in order:
        touched = _mark_forbidden(int(v), adj, color, include_indirect,
                                  mask)
        # first-fit: smallest unmarked color.  With t marked entries (dupes
        # included) some color in [0, t] is free, so the argmax scan stays
        # O(conflict degree) instead of O(n).
        t = sum(a.shape[0] for a in touched)
        color[v] = int(np.argmax(~mask[:t + 1]))
        for a in touched:
            mask[a] = False
    return color


def _balance(adj, color, include_indirect: bool, max_rounds: int = 3):
    """RACE-style balancing: shrink over-full color classes by recoloring
    rows into the feasible under-full class whose members are nearest in row
    index.  Never introduces a new color, never breaks conflict-freeness."""
    n = len(color)
    num_colors = int(color.max()) + 1 if n else 0
    if num_colors <= 1:
        return color
    target = -(-n // num_colors)            # ceil: perfectly balanced size
    # sorted member list per class, maintained incrementally across moves
    # (a full color == d scan per (vertex, class) pair is O(n) per query)
    members: List[List[int]] = [[] for _ in range(num_colors)]
    for v in range(n):                      # ascending v keeps lists sorted
        members[int(color[v])].append(v)
    mask = np.zeros(n + 2, dtype=bool)      # reusable forbidden scratch
    for _ in range(max_rounds):
        sizes = np.bincount(color, minlength=num_colors)
        moved = False
        for v in range(n):                  # ascending row order (locality)
            c = int(color[v])
            if sizes[c] <= target:
                continue
            touched = _mark_forbidden(v, adj, color, include_indirect,
                                      mask)
            best, best_key = -1, None
            for d in range(num_colors):
                if d == c or mask[d] or sizes[d] + 1 > sizes[c] - 1:
                    continue
                # locality: distance from v to the nearest row of class d
                dist = _nearest_distance(members[d], v)
                key = (int(sizes[d]), dist)
                if best_key is None or key < best_key:
                    best, best_key = d, key
            for a in touched:
                mask[a] = False
            if best >= 0:
                sizes[c] -= 1
                sizes[best] += 1
                del members[c][bisect.bisect_left(members[c], v)]
                bisect.insort(members[best], v)
                color[v] = best
                moved = True
        if not moved:
            break
    return color


def _nearest_distance(sorted_members: List[int], v: int) -> int:
    """min |m - v| over a sorted member list; 0 when the class is empty."""
    if not sorted_members:
        return 0
    i = bisect.bisect_left(sorted_members, v)
    best = sorted_members[i] - v if i < len(sorted_members) else None
    if i > 0 and (best is None or v - sorted_members[i - 1] < best):
        best = v - sorted_members[i - 1]
    return int(best)


def _finalize(color: np.ndarray, provider: str = "greedy",
              level_of_row: Optional[np.ndarray] = None,
              group_of_row: Optional[np.ndarray] = None) -> Coloring:
    n = color.shape[0]
    max_color = int(color.max()) + 1 if n else 0
    # stable sort: rows ascend within each color (row-index locality)
    order = np.argsort(color, kind="stable")
    counts = np.bincount(color, minlength=max_color) if n else np.zeros(
        0, np.int64)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return Coloring(color_of_row=color, num_colors=max_color,
                    rows_by_color=order.astype(np.int64), color_ptr=ptr,
                    provider=provider, level_of_row=level_of_row,
                    group_of_row=group_of_row)


# ---------------------------------------------------------------------------
# RACE provider: recursive level-group bipartition (arXiv:1907.06487)
# ---------------------------------------------------------------------------

def _conflict_closure(adj) -> List[np.ndarray]:
    """Distance-2 closure of the direct graph as explicit adjacency lists:
    u ~ w when they are direct neighbors *or* share one (the paper's direct
    + indirect conflicts as a single edge set).  Folding the distance into
    the edges lets the recursion reason purely about distance 1 — induced
    subgraphs preserve every conflict edge between their members, which a
    distance-2 walk over an induced subgraph would not."""
    out: List[np.ndarray] = []
    for v in range(len(adj)):
        nb = [adj[v]] + [adj[int(u)] for u in adj[v]]
        m = np.unique(np.concatenate(nb)) if nb else np.zeros(0, np.int64)
        out.append(m[m != v].astype(np.int64))
    return out


def _bfs_levels(cadj, verts: np.ndarray) -> np.ndarray:
    """BFS levels of the conflict graph induced on ``verts``.

    Seeded per connected component at its lowest-index vertex of minimum
    induced degree (a band end / mesh corner — the locality-preserving
    seed: levels then sweep the rows in index order).  Components number
    their levels independently from 0; no conflict edge crosses
    components, so sharing level ids across them is safe.  Returns the
    level id per position of ``verts``.

    The BFS property carries the whole scheme: a conflict edge inside the
    induced subgraph spans at most one level, so vertices ≥ 2 levels apart
    never conflict.
    """
    local = {int(v): i for i, v in enumerate(verts)}
    nloc = len(verts)
    level = np.full(nloc, -1, dtype=np.int64)
    deg = np.asarray([sum(1 for u in cadj[int(v)] if int(u) in local)
                      for v in verts], dtype=np.int64)
    for s in sorted(range(nloc), key=lambda i: (int(deg[i]), i)):
        if level[s] >= 0:
            continue
        level[s] = 0
        frontier = [s]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for i in frontier:
                for u in cadj[int(verts[i])]:
                    j = local.get(int(u))
                    if j is not None and level[j] < 0:
                        level[j] = d
                        nxt.append(j)
            frontier = nxt
    return level


def _race_partition(cadj, verts: np.ndarray, group_of: np.ndarray,
                    next_group: List[int], depth: int, chunk_target: int,
                    level_out: Optional[np.ndarray] = None):
    """One recursion node of the RACE scheme on the induced subgraph.

    BFS levels become the level groups (conflict distance is already folded
    into ``cadj``); even/odd groups take disjoint sub-palettes, and a group
    larger than ``chunk_target`` is recursively re-split, its sub-parity
    refining the parent color.  Leaf groups get a fresh serial-chunk id in
    ``group_of``.  Returns (colors aligned with ``verts``, palette size).
    """
    nv = len(verts)
    if nv == 0:
        return np.zeros(0, np.int64), 1
    lev = _bfs_levels(cadj, verts)
    if level_out is not None:
        level_out[verts] = lev
    nlev = int(lev.max()) + 1
    color = np.zeros(nv, np.int64)
    if nlev <= 1:
        # indivisible: the induced conflict graph spans one BFS level (a
        # near-clique, or an independent set) — one serial chunk, one color
        group_of[verts] = next_group[0]
        next_group[0] += 1
        return color, 1
    parts = []
    for g in range(nlev):
        idx = np.flatnonzero(lev == g)
        if idx.shape[0] > chunk_target and depth < RACE_MAX_DEPTH:
            sub, npal = _race_partition(cadj, verts[idx], group_of,
                                        next_group, depth + 1, chunk_target)
        else:
            sub, npal = np.zeros(idx.shape[0], np.int64), 1
            group_of[verts[idx]] = next_group[0]
            next_group[0] += 1
        parts.append((g, idx, sub, npal))
    pal = [0, 0]
    for g, _, _, npal in parts:
        pal[g % 2] = max(pal[g % 2], npal)
    for g, idx, sub, _ in parts:
        color[idx] = sub if g % 2 == 0 else pal[0] + sub
    return color, pal[0] + pal[1]


def race_color_graph(adj: list, include_indirect: bool = False,
                     balance: bool = True,
                     p_target: int = RACE_P_TARGET) -> Coloring:
    """RACE-style recursive level-group coloring of a conflict graph.

    Returns the same :class:`Coloring` artifact the greedy provider does,
    with ``provider='race'`` and the level-group metadata filled in; the
    colorful executors and the assembly scatter consume it unchanged.
    """
    n = len(adj)
    adj = [np.asarray(a, dtype=np.int64) for a in adj]
    cadj = _conflict_closure(adj) if include_indirect else adj
    level = np.zeros(n, dtype=np.int64)
    group = np.zeros(n, dtype=np.int64)
    next_group = [0]
    chunk_target = max(1, -(-n // (2 * p_target)))
    color, _ = _race_partition(cadj, np.arange(n), group, next_group, 0,
                               chunk_target, level_out=level)
    if balance and n:
        before = color.copy()
        color = _balance(adj, color, include_indirect)
        moved = np.flatnonzero(color != before)
        if moved.size:
            # a moved row passed the classic forbidden check against its
            # whole destination class, so it forms its own serial chunk
            group[moved] = next_group[0] + np.arange(moved.size)
            next_group[0] += int(moved.size)
    return _finalize(color, provider="race", level_of_row=level,
                     group_of_row=group)


def color_graph(adj: list, include_indirect: bool = False,
                order: str = "degree", balance: bool = True,
                provider: str = "greedy") -> Coloring:
    """Coloring of an arbitrary conflict graph given as adjacency lists.

    This is the machinery behind :func:`color_rows` factored over the
    graph instead of the matrix, so other conflict graphs — notably the
    FEM *element* conflict graph of the assembly layer — reuse
    the identical pipeline.

    ``provider``: 'greedy' (sequential first-fit, the default) or 'race'
    (the recursive level-group scheme, :func:`race_color_graph`).

    ``order`` (greedy only): 'degree' (largest-degree-first, the default),
    'natural' (the legacy unordered first-fit).  Degree ordering guards the
    invariant that it never uses more colors than the natural order by
    computing both and keeping the smaller palette (coloring is a one-time
    precomputation; see core/schedule.py).
    """
    if provider not in PROVIDERS:
        raise ValueError(f"unknown coloring provider {provider!r}; "
                         f"expected one of {PROVIDERS}")
    if provider == "race":
        return race_color_graph(adj, include_indirect=include_indirect,
                                balance=balance)
    n = len(adj)
    if order not in ("degree", "natural"):
        raise ValueError(f"unknown coloring order {order!r}")
    natural = np.arange(n)
    color = _greedy(adj, natural, include_indirect)
    if order == "degree" and n:
        deg = np.asarray([len(a) for a in adj], dtype=np.int64)
        by_degree = np.argsort(-deg, kind="stable")
        cd = _greedy(adj, by_degree, include_indirect)
        if cd.max() <= color.max():
            color = cd
    if balance:
        color = _balance(adj, color, include_indirect)
    return _finalize(color)


def color_rows(M: CSRC, include_indirect: bool = True,
               order: str = "degree", balance: bool = True,
               adj: Optional[list] = None,
               provider: str = "greedy") -> Coloring:
    """Row coloring of the paper's conflict graph (§3.2) via
    :func:`color_graph`.

    With ``include_indirect`` the conflict graph is G'^2 restricted to direct
    edges' 2-hop closure (paper: u,v indirectly conflict when their direct
    neighborhoods intersect) — i.e. distance-2 coloring of the direct graph.
    """
    adj = direct_adjacency(M) if adj is None else adj
    return color_graph(adj, include_indirect=include_indirect,
                       order=order, balance=balance, provider=provider)


def verify_coloring(M: CSRC, col: Coloring) -> bool:
    """Property check of the chunk-aware conflict invariant: inside one
    color, no two rows of *different* serial chunks may share a write
    target (each row writes y[row] and y[ja[slots of row]]).

    Greedy colorings carry no chunk structure (``group_of_row is None``) —
    every row is its own chunk and this degenerates to the classic check
    that all targets inside a color are pairwise distinct.  RACE colorings
    may share targets inside one level-group chunk: the modeled machine
    runs a chunk serially, and the executors scatter with order-free
    ``index_add_``."""
    ia = _np(M.ia)
    ja = _np(M.ja)
    grp = col.group_of_row
    for c in range(col.num_colors):
        owner: dict = {}
        for r in col.rows(c).tolist():
            g = int(grp[r]) if grp is not None else r
            targets = [r] + ja[ia[r]:ia[r + 1]].tolist()
            for t in targets:
                og = owner.get(t)
                if og is not None and og != g:
                    return False
                owner[t] = g
    return True


def balance_stats(col: Coloring) -> dict:
    """Rows-per-color dispersion: max/mean (1.0 = perfectly balanced) and
    std — the quantity the RACE-style pass minimizes."""
    sizes = col.class_sizes().astype(np.float64)
    if sizes.size == 0:
        return {"imbalance": 1.0, "std": 0.0}
    return {"imbalance": float(sizes.max() / max(1.0, sizes.mean())),
            "std": float(sizes.std())}


def reuse_stats(col: Coloring) -> dict:
    """Reuse-distance proxy (the paper's §3.2 locality criticism): the
    row-index strides between consecutive rows of one color in execution
    order.  Big strides inside a color evict x/y cache lines between
    uses; RACE classes are unions of contiguous level ranges, so their
    mean stride stays near 1 while greedy classes stride by ~num_colors."""
    gaps = []
    for c in range(col.num_colors):
        r = col.rows(c)
        if r.shape[0] > 1:
            gaps.append(np.abs(np.diff(r)).astype(np.float64))
    if not gaps:
        return {"mean_stride": 0.0, "p90_stride": 0.0}
    g = np.concatenate(gaps)
    return {"mean_stride": float(g.mean()),
            "p90_stride": float(np.percentile(g, 90))}


def group_stats(col: Coloring) -> dict:
    """Serial-chunk structure of a coloring: chunk count and the largest
    chunk (the modeled machine's per-color span).  A greedy coloring is
    all singleton chunks."""
    if col.group_of_row is None:
        n = int(col.color_of_row.shape[0])
        return {"chunks": n, "max_chunk": 1 if n else 0}
    _, counts = np.unique(col.group_of_row, return_counts=True)
    return {"chunks": int(counts.shape[0]),
            "max_chunk": int(counts.max()) if counts.size else 0}


def conflict_stats(M: CSRC) -> dict:
    """Direct/indirect conflict counts (paper Fig. 3c reports 12 direct and
    7 indirect for its 9×9 example)."""
    adj = direct_adjacency(M)
    n = M.n
    direct = sum(len(a) for a in adj) // 2
    indirect = 0
    for v in range(n):
        direct_v = set(adj[v].tolist())
        two_hop = set()
        for u in adj[v]:
            for w in adj[u]:
                if w > v and w not in direct_v:
                    two_hop.add(int(w))
        indirect += len(two_hop)
    return {"direct": int(direct), "indirect": int(indirect)}
