"""The unified SpMV schedule layer: every structure-dependent precomputation
an :class:`~repro_torch.core.plan.ExecutionPlan` needs to execute, bundled in one
cached, serializable artifact.

The paper's two race-avoidance families — per-thread buffers with four
accumulation variants (§3.1) and conflict-graph coloring (§3.2) — are all
*precomputations over the matrix structure*.  Before this layer each consumer
rebuilt its own piece ad-hoc (the operator packed block-ELL inline, the
distributed layouts re-derived partitions and halo windows, the colorful
path re-ran the greedy colorer).  ``SpmvSchedule`` gives them one home:

  partition        nnz-balanced (or row-count) :class:`RowPartition` with the
                   paper's *effective* write ranges per part
  halo             per-part halo widths (§3.1 effective accumulation;
                   the distributed 'halo' strategy's exchange windows)
  pack             the block-ELL pack for the ``kernel`` path
  flat_pack        the flat-grid pack for the ``flat`` path
  nnzsplit_pack    the chunked combined stream for the ``nnzsplit`` path
  coloring         the conflict-free row classes for the ``colorful`` path,
                   with the per-color slot batches
  segment_split    the ``segment`` path's chunks of rows too long for one
                   lane group (K15's second launch)

A schedule is built **once** per (matrix fingerprint, value digest, plan,
partition width) and stored next to the plan in the tuner's
:class:`~repro_torch.core.tuner.PlanCache` — a serving process that re-registers a
known matrix performs zero pack/partition/coloring work
(``BUILD_COUNTS`` is the probe tests assert that with).

Path-specific artifact contents (the block-ELL pack, the flat-grid pack,
the nnz-split pack, the coloring batches, the segment path's split of
heavy rows) are built and serialized by the path's
:class:`~repro_torch.core.paths.KernelPath` registry entry — this module owns
the common pieces (partition, halo, fingerprinting, cache plumbing) and
delegates the rest, so a newly registered path is schedule-cached with
zero edits here.

Serialization is npz + a JSON meta record (``save_npz`` / ``load_npz``);
``SCHEDULE_VERSION`` gates the on-disk layout — bumping it (e.g. on a pack
format change) invalidates every stored schedule, which is then silently
rebuilt on the next request.

The mesh strategies' per-shard layouts live here too (``ShardedSlots`` /
``HaloLayout`` for the ``index_add_`` shard-local product, and through the
registry's ``ShardSupport`` the flat and nnz-split shard packs), memoized
per exact matrix and geometry and shipped through the PlanCache's npz
layer (``SHARD_LAYOUT_VERSION``), with the JAX package's arrays and keys so
files cross-load.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch

from repro_torch import obs
from . import paths as paths_mod
from .blockell import BlockEll, move_layout
from .csrc import CSRC, _np, row_of_slot
from .partition import (RowPartition, halo_geometry, halo_widths,
                        partition_rows_by_count, partition_rows_by_nnz,
                        shard_diagonal)
# the build probe lives with the registry (the paths' build functions count into it);
# re-exported here because consumers/tests address it as
# ``schedule.BUILD_COUNTS`` — same Counter object.
from .paths import BUILD_COUNTS
from .plan import ExecutionPlan

# version 5: the 'nnzsplit' path's NnzSplitPack artifact joins the npz
# layout (nnzsplit_* arrays + "nnzsplit_pack" meta).  Version-4 files
# load as misses and are rebuilt transparently.
# version 6: the colorful artifact records its coloring provider plus the
# RACE level-group metadata (color_level_of_row / color_group_of_row), and
# the provider joins the colorful path's artifact fields (schedule keys).
# Version-5 files load as misses and are rebuilt transparently.
SCHEDULE_VERSION = 6


@dataclasses.dataclass(frozen=True)
class SpmvSchedule:
    """Everything structure-dependent one plan needs to execute one matrix."""

    fingerprint: str            # matrix-class key (tuner.fingerprint)
    value_digest: str           # exact structure+values digest (this matrix)
    plan: ExecutionPlan
    n: int
    m: int
    p: int                      # partition width the row partition was built for
    partition: RowPartition
    halo: np.ndarray            # (p,) halo width per part (effective ranges)
    # --- path-specific artifact fields (built/serialized by the path's
    # KernelPath registry entry; exactly the fields its build_artifact
    # returns are non-None) ---
    pack: Optional[BlockEll] = None          # 'kernel' path
    coloring: Optional[object] = None        # 'colorful' path
    # device-ready color batches: slot ids grouped by color, concatenated;
    # color c owns color_slots[color_slot_ptr[c]:color_slot_ptr[c+1]].
    color_slots: Optional[np.ndarray] = None
    color_slot_ptr: Optional[np.ndarray] = None
    flat_pack: Optional[object] = None       # 'flat' path (FlatBlockEll)
    nnzsplit_pack: Optional[object] = None   # 'nnzsplit' path (NnzSplitPack)
    # 'segment' path (csrc_segment.SegmentSplit): K15's chunks of heavy rows
    segment_split: Optional[object] = None
    # exact-structure digest (ia/ja/iar/jar only — values excluded): the
    # key of the value-refresh fast path (refresh_schedule)
    structure_digest: str = ""

    def to(self, device) -> "SpmvSchedule":
        """The same schedule with its tensor-bearing artifacts (the
        block-ELL, flat or nnz-split pack, the segment split) on
        ``device``; partition, halo and the coloring batches stay host
        numpy (the colorful executor uploads its batches once, when it is
        bound)."""
        moved = {f: getattr(self, f).to(device)
                 for f in ("pack", "flat_pack", "nnzsplit_pack",
                           "segment_split")
                 if getattr(self, f) is not None}
        if all(moved[f] is getattr(self, f) for f in moved):
            return self
        return dataclasses.replace(self, **moved)

    def key(self) -> str:
        return schedule_key(self.fingerprint, self.value_digest, self.plan,
                            self.p)

    # ------------------------------------------------------------------
    # Serialization (npz arrays + JSON meta); the path-specific section is
    # delegated to the registry entry's save_artifact/load_artifact
    # ------------------------------------------------------------------

    def save_npz(self, path: str):
        meta = {
            "version": SCHEDULE_VERSION,
            "fingerprint": self.fingerprint,
            "value_digest": self.value_digest,
            "plan": self.plan.to_dict(),
            "n": self.n, "m": self.m, "p": self.p,
            "structure_digest": self.structure_digest,
        }
        arrays = {
            "part_starts": np.asarray(self.partition.starts),
            "part_eff_lo": np.asarray(self.partition.eff_lo),
            "part_eff_hi": np.asarray(self.partition.eff_hi),
            "part_nnz": np.asarray(self.partition.nnz_per_part),
            "halo": np.asarray(self.halo),
        }
        entry = paths_mod.get_path(self.plan.path)
        path_meta, path_arrays = entry.save_artifact(self)
        meta.update(path_meta)
        arrays.update(path_arrays)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8),
                **arrays)
        os.replace(tmp, path)

    @classmethod
    def load_npz(cls, path: str) -> "SpmvSchedule":
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            if meta.get("version") != SCHEDULE_VERSION:
                raise ValueError(
                    f"schedule {path}: version {meta.get('version')!r} "
                    f"!= {SCHEDULE_VERSION}")
            plan = ExecutionPlan.from_dict(meta["plan"])
            part = RowPartition(starts=z["part_starts"],
                                eff_lo=z["part_eff_lo"],
                                eff_hi=z["part_eff_hi"],
                                nnz_per_part=z["part_nnz"])
            entry = paths_mod.get_path(plan.path)
            fields = entry.load_artifact(meta, z)
            return cls(fingerprint=meta["fingerprint"],
                       value_digest=meta["value_digest"], plan=plan,
                       n=meta["n"], m=meta["m"], p=meta["p"],
                       structure_digest=meta["structure_digest"],
                       partition=part, halo=z["halo"], **fields)


def value_digest(M: CSRC) -> str:
    """Digest of the exact matrix content (structure AND values).

    The tuner's ``fingerprint`` identifies a matrix *class* (two matrices of
    the same generator share it, so plans transfer).  A schedule embeds the
    matrix values (pack value streams, per-slot al/au), so its cache key
    additionally pins the exact matrix — a same-class matrix with different
    values rebuilds instead of silently reusing another matrix's values.
    A ``schedule.digest`` span.
    """
    with obs.span("schedule.digest", of="value"):
        h = hashlib.sha1()
        for a in (M.ia, M.ja, M.ad, M.al, M.au, M.iar, M.jar, M.ar):
            h.update(np.ascontiguousarray(_np(a)).tobytes())
        return h.hexdigest()[:16]


def structure_digest(M: CSRC) -> str:
    """Digest of the matrix *structure* only (ia/ja/iar/jar + shape).

    Two matrices sharing it differ at most in values — the FEM
    time-stepping shape (re-assembled stiffness on a fixed mesh).  For
    such a pair every structural schedule artifact (partition, halo,
    coloring, pack index streams) is identical; only the value streams
    need refreshing (:func:`refresh_schedule`).  A ``schedule.digest``
    span.
    """
    with obs.span("schedule.digest", of="structure"):
        h = hashlib.sha1()
        h.update(np.asarray([M.n, M.m], np.int64).tobytes())
        for a in (M.ia, M.ja, M.iar, M.jar):
            h.update(np.ascontiguousarray(_np(a)).tobytes())
        return h.hexdigest()[:16]


def plan_artifact_fields(plan: ExecutionPlan) -> tuple:
    """The plan fields the schedule artifact actually depends on.  Two plans
    differing only in accumulation strategy or tuned RHS width (nrhs) share
    one artifact — the pack/partition/coloring are identical.  The
    path-specific tail comes from the registry entry ('kernel'/'flat' pin
    their tile/window geometry; 'segment'/'colorful' add nothing)."""
    entry = paths_mod.get_path(plan.path)
    return (plan.path, plan.partition) + tuple(entry.artifact_fields(plan))


def schedule_key(fingerprint: str, digest: str, plan: ExecutionPlan,
                 p: int) -> str:
    ph = hashlib.sha1(json.dumps(plan_artifact_fields(plan)).encode()
                      ).hexdigest()[:10]
    return f"{fingerprint}.{digest}.p{p}.{ph}"


def color_slot_batches(M: CSRC, coloring):
    """Colorful batches: lower-triangle slot ids grouped by the color of
    their owning row (the per-color gather/scatter index sets the colorful
    path replays serially), rows in ``coloring.rows_by_color`` order and
    each row's slots ascending.  Returns (slots int32, ptr int64) — the
    JAX package's arrays, built without a per-row loop."""
    ia = _np(M.ia).astype(np.int64)
    rows = np.asarray(coloring.rows_by_color, dtype=np.int64)
    counts = ia[rows + 1] - ia[rows]
    total = int(counts.sum())
    first = np.zeros(rows.shape[0] + 1, np.int64)
    np.cumsum(counts, out=first[1:])
    slots = (np.repeat(ia[rows] - first[:-1], counts)
             + np.arange(total, dtype=np.int64)).astype(np.int32)
    cptr = np.asarray(coloring.color_ptr, dtype=np.int64)
    ptr = first[cptr].astype(np.int64)
    return slots, ptr


def colorful_apply(M: CSRC, x: torch.Tensor, color_slots, color_slot_ptr,
                   row_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = A·x color by color over the schedule's slot batches: per color
    one ``index_add_`` of ``al·x[ja]`` into the rows and one of
    ``au·x[row]`` into the columns.

    ``x`` may be (n,) or (n, r); inside one color every write target is
    unique (greedy) or shared only inside one serial chunk (RACE), so the
    adds are exact in any order on dyadic data.  ``color_slots`` may be a
    numpy array or a tensor on ``x``'s device (a bound executor passes the
    batches it uploaded once, and ``row_idx``, the row of each slot)."""
    two_d = x.ndim == 2
    dev = x.device
    if row_idx is None:
        row_idx = torch.from_numpy(row_of_slot(M)).to(dev)
    slots = torch.as_tensor(color_slots, device=dev)
    ptr = np.asarray(color_slot_ptr)
    ad = M.ad[:, None] if two_d else M.ad
    y = ad * x[:M.n]
    for c in range(len(ptr) - 1):
        lo, hi = int(ptr[c]), int(ptr[c + 1])
        if hi == lo:
            continue
        sl = slots[lo:hi].long()
        r = row_idx[sl].long()
        j = M.ja[sl].long()
        al, au = M.al[sl], M.au[sl]
        if two_d:
            al, au = al[:, None], au[:, None]
        y.index_add_(0, r, al * x[j])
        y.index_add_(0, j, au * x[r])
    return y


def build_schedule(M: CSRC, plan: ExecutionPlan, p: int = 8,
                   coloring=None) -> SpmvSchedule:
    """Build the full schedule artifact for (matrix, plan).

    The path-specific artifact (pack / flat pack / coloring batches) comes
    from the plan path's registry entry; it raises ValueError exactly where
    strict plan execution must fail: a windowed ('kernel'/'flat') plan
    whose window exceeds ``plan.w_cap`` (bandwidth gate) and square-only
    plans on rectangular matrices.
    """
    from .tuner import fingerprint as _fingerprint   # local: avoid cycle

    entry = paths_mod.get_path(plan.path)
    # build the path artifact first: infeasible plans raise before any
    # build counter moves
    with obs.span("schedule.build_artifact", path=plan.path):
        fields = entry.build_artifact(M, plan, coloring=coloring)

    BUILD_COUNTS.inc("schedule")
    BUILD_COUNTS.inc("partition")
    with obs.span("schedule.partition", partition=plan.partition):
        p = max(1, min(p, M.n))
        if plan.partition == "count":
            part = partition_rows_by_count(M, p)
        else:
            part = partition_rows_by_nnz(M, p)
        halo = np.asarray(halo_widths(part), dtype=np.int64)

    return SpmvSchedule(
        fingerprint=_fingerprint(M), value_digest=value_digest(M),
        plan=plan, n=M.n, m=M.m, p=p, partition=part, halo=halo,
        structure_digest=structure_digest(M), **fields)


def refresh_schedule(sched: SpmvSchedule, M: CSRC) -> SpmvSchedule:
    """Same-structure value refresh: a new schedule for ``M`` reusing every
    structural artifact of ``sched`` (partition, halo, coloring, pack index
    streams) and rebuilding only the value streams.

    This is the FEM time-stepping fast path — the matrix is re-assembled
    every step with unchanged connectivity, so re-packing or re-coloring
    would redo O(nnz) structural work per step for nothing.  The path's
    registry entry supplies the stream refresh ('kernel'/'flat' refill the
    pack values vectorized); paths whose artifacts are purely structural
    ('segment', 'colorful' — executors read values from ``M`` directly)
    reuse the artifact as-is.  Raises ValueError when the structures do
    not actually match.
    """
    if structure_digest(M) != sched.structure_digest:
        raise ValueError(
            "refresh_schedule: matrix structure differs from the "
            "schedule's; a full rebuild (build_schedule) is required")
    entry = paths_mod.get_path(sched.plan.path)
    BUILD_COUNTS.inc("value_refresh")
    fields = ({} if entry.refresh_values is None
              else entry.refresh_values(M, sched))
    return dataclasses.replace(sched, value_digest=value_digest(M),
                               **fields)


def schedule_for(M: CSRC, plan: ExecutionPlan, cache=None, p: int = 8,
                 coloring=None) -> SpmvSchedule:
    """The schedule to execute (M, plan) with — cache hit wins.

    ``cache`` is a :class:`~repro_torch.core.tuner.PlanCache`; a hit performs zero
    pack/partition/coloring work.  On a value-digest miss a same-structure
    schedule (matching fingerprint + structure digest — FEM time stepping)
    is value-refreshed instead of rebuilt (:func:`refresh_schedule`): only
    the value streams are touched, no re-pack/re-partition/re-color.  An
    explicit ``coloring`` override bypasses the cache (custom colorings are
    caller-owned, not shared artifacts).
    """
    from .tuner import fingerprint as _fingerprint

    if coloring is not None or cache is None:
        return build_schedule(M, plan, p=p, coloring=coloring)
    fp = _fingerprint(M)
    vd = value_digest(M)
    hit = cache.get_schedule(fp, vd, plan, p)
    if hit is not None:
        return hit
    base = cache.find_schedule_by_structure(fp, structure_digest(M), plan, p)
    if base is not None:
        obs.counter("plan_cache_lookups_total", kind="schedule",
                    outcome="refresh").inc()
        sched = refresh_schedule(base, M)
        # the refreshed generation supersedes the base in memory (one
        # schedule per structure, not one per step); the npz already on
        # disk keeps serving fresh processes, so skip re-writing a full
        # artifact per time step
        cache.drop_schedule(base, remove_file=False)
        cache.put_schedule(sched, persist=False)
    else:
        sched = build_schedule(M, plan, p=p)
        cache.put_schedule(sched)
    return sched


# ---------------------------------------------------------------------------
# Shard layouts (the shard-level structure precomputations the mesh
# strategies of core/distributed.py execute with)
# ---------------------------------------------------------------------------

def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ShardedSlots:
    """Slot arrays split into p nnz-balanced groups, padded to equal length
    and stacked on a leading shard axis (allreduce / reduce_scatter)."""
    row_idx: torch.Tensor    # (p, S) int32 global row of each slot (pad: 0)
    ja: torch.Tensor         # (p, S) int32 global column          (pad: 0)
    al: torch.Tensor         # (p, S) float32                      (pad: 0.0)
    au: torch.Tensor         # (p, S)
    ad_shard: torch.Tensor   # (p, n) diagonal owned by the shard, zero rest
    part: RowPartition

    def to(self, device) -> "ShardedSlots":
        return move_layout(self, ("row_idx", "ja", "al", "au", "ad_shard"),
                           device)

    def reference_shapes(self) -> dict:
        return {}


@dataclasses.dataclass(frozen=True)
class HaloLayout:
    """Equal-row shard slot arrays in *local* coordinates for the paper's
    effective accumulation ('halo'): each shard owns ns rows and writes at
    most h rows below its range (the halo sent to the left neighbour)."""
    p: int
    ns: int                  # rows per shard (8-aligned)
    h: int                   # halo width (8-aligned bandwidth)
    n_pad: int
    row_loc: torch.Tensor    # (p, S) int32 local row of each slot
    col_rel: torch.Tensor    # (p, S) int32 column relative to [r0-h, r1)
    al: torch.Tensor         # (p, S) float32
    au: torch.Tensor         # (p, S)
    ad: torch.Tensor         # (p, ns)

    def to(self, device) -> "HaloLayout":
        return move_layout(self, ("row_loc", "col_rel", "al", "au", "ad"),
                           device)

    def reference_shapes(self) -> dict:
        return {}


# Memo of the shard layouts: repeated builder calls for the same matrix
# (serving restarts, solver re-instantiation) are zero-precompute.  Keys pin
# the exact matrix (value digest) and the layout geometry; no eviction
# (``clear_shard_layout_memos`` empties them).
_SHARDED_SLOTS_MEMO: dict = {}
_HALO_LAYOUT_MEMO: dict = {}
_FLAT_SHARDS_MEMO: dict = {}
_FLAT_HALO_MEMO: dict = {}
_PATH_LAYOUT_MEMOS: dict = {"flat_shards": _FLAT_SHARDS_MEMO,
                            "flat_halo": _FLAT_HALO_MEMO}


def _layout_memo(kind: str) -> dict:
    return _PATH_LAYOUT_MEMOS.setdefault(kind, {})


def clear_shard_layout_memos() -> None:
    """Drop every memoized shard layout (the next request rebuilds or
    loads from a cache)."""
    _SHARDED_SLOTS_MEMO.clear()
    _HALO_LAYOUT_MEMO.clear()
    for memo in _PATH_LAYOUT_MEMOS.values():
        memo.clear()


# ---------------------------------------------------------------------------
# Shard-layout npz: ships the per-shard layouts to serving workers through
# the PlanCache, keyed by (fingerprint, value digest, p, kind, geometry)
# ---------------------------------------------------------------------------

SHARD_LAYOUT_VERSION = 1


def _layout_kinds() -> dict:
    """npz kind -> dataclass for every serializable shard layout: the two
    owned here plus every registered path's ShardSupport layouts."""
    kinds = {"sharded_slots": ShardedSlots, "halo": HaloLayout}
    for entry in paths_mod.registered_paths():
        if entry.shard_support is not None:
            kinds.update(entry.shard_support.layout_classes())
    return kinds


def shard_layout_key(kind: str, fp: str, digest: str, p: int,
                     geo: tuple = ()) -> str:
    """Cache key of one shard layout: matrix class + exact values + shard
    count + kind, plus a hash of the geometry (tile height, k-step, index
    dtype, partition boundaries...) — the JAX package's key."""
    gh = hashlib.sha1(json.dumps([str(g) for g in geo]).encode()
                      ).hexdigest()[:10]
    return f"shard-{kind}-{fp}.{digest}.p{p}.{gh}"


def save_shard_layout_npz(path: str, lay):
    """Serialize any shard layout in the JAX package's layout: scalar
    fields to the JSON meta, arrays (and the embedded RowPartition) to npz,
    bf16 value streams widened to float32 (lossless) and named in the
    meta, slot streams in the JAX package's shapes.  Written uncompressed,
    as every npz of this module (``np.load`` reads either form)."""
    kind = next(k for k, cls in _layout_kinds().items()
                if isinstance(lay, cls))
    meta = {"version": SHARD_LAYOUT_VERSION, "kind": kind}
    arrays = {}
    shapes = lay.reference_shapes()
    for f in dataclasses.fields(lay):
        v = getattr(lay, f.name)
        if isinstance(v, RowPartition):
            for pf in dataclasses.fields(v):
                arrays[f"part__{pf.name}"] = np.asarray(getattr(v, pf.name))
        elif isinstance(v, (bool, int, float)):
            meta[f.name] = v
        else:
            t = v.detach().cpu()
            if t.dtype == torch.bfloat16:
                meta.setdefault("__bf16__", []).append(f.name)
                t = t.float()
            a = t.numpy()
            arrays[f.name] = a.reshape(shapes[f.name]) if f.name in shapes \
                else a
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp.npz"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(
            json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8),
            **arrays)
    os.replace(tmp, path)


def load_shard_layout_npz(path: str):
    """The inverse of :func:`save_shard_layout_npz`, for files of either
    package (``convert.shard_layout_from_arrays`` rebuilds and checks the
    layout); a bf16 layout keeps its dtype."""
    from repro_torch.convert import shard_layout_from_arrays
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        if meta.get("version") != SHARD_LAYOUT_VERSION:
            raise ValueError(
                f"shard layout {path}: version {meta.get('version')!r} "
                f"!= {SHARD_LAYOUT_VERSION}")
        kind = meta["kind"]
        cls = _layout_kinds()[kind]
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in meta:
                kwargs[f.name] = meta[f.name]
            elif f.name == "part":
                kwargs["part"] = RowPartition(
                    starts=z["part__starts"], eff_lo=z["part__eff_lo"],
                    eff_hi=z["part__eff_hi"],
                    nnz_per_part=z["part__nnz_per_part"])
            else:
                kwargs[f.name] = z[f.name]
        value_dtype = "bfloat16" if meta.get("__bf16__") else "float32"
        return shard_layout_from_arrays(kind, value_dtype=value_dtype,
                                        **kwargs)


def _cached_layout(M: CSRC, cache, kind: str, p: int, geo: tuple):
    """Probe the cache's shard-layout store; returns (layout or None, key
    or None)."""
    if cache is None:
        return None, None
    from .tuner import fingerprint as _fingerprint
    key = shard_layout_key(kind, _fingerprint(M), value_digest(M), p, geo)
    return cache.get_shard_layout(key), key


def _ensure_shipped(M: CSRC, cache, kind: str, p: int, geo: tuple, lay):
    """Persist a memoized layout on the first cache-bearing request: a
    layout built without a cache (``tune_mesh``'s measurements) ships as
    soon as a cache-aware consumer asks for it."""
    if cache is None:
        return
    shipped, key = _cached_layout(M, cache, kind, p, geo)
    if shipped is None and key is not None:
        cache.put_shard_layout(key, lay)


def _memoized(M: CSRC, cache, kind: str, p: int, geo: tuple, memo: dict,
              memo_key, build, counter: Optional[str] = None):
    """Memo hit > cache hit > build, counted as ``BUILD_COUNTS[counter]``
    (default: the kind)."""
    hit = memo.get(memo_key)
    if hit is not None:
        _ensure_shipped(M, cache, kind, p, geo, hit)
        return hit
    shipped, key = _cached_layout(M, cache, kind, p, geo)
    if shipped is not None:
        memo[memo_key] = shipped
        return shipped
    out = build()
    BUILD_COUNTS.inc(counter or kind)
    memo[memo_key] = out
    if key is not None:
        cache.put_shard_layout(key, out)
    return out


def _stack_spans(arr: np.ndarray, spans, width: int, fill, dtype):
    out = np.full((len(spans), width), fill, dtype=dtype)
    for t, (s, e) in enumerate(spans):
        out[t, :e - s] = arr[s:e]
    return out


def _sharded_slot_arrays(M: CSRC, part: RowPartition, width: int):
    """(spans, al, au, ad_shard) of the stacked slot arrays."""
    ia = _np(M.ia).astype(np.int64)
    spans = [(int(ia[part.starts[t]]), int(ia[part.starts[t + 1]]))
             for t in range(part.p)]
    al = _stack_spans(_np(M.al), spans, width, 0.0, np.float32)
    au = _stack_spans(_np(M.au), spans, width, 0.0, np.float32)
    return spans, al, au, shard_diagonal(M, part.starts, M.n)


def build_sharded_slots(M: CSRC, part: RowPartition,
                        cache=None) -> ShardedSlots:
    """Shard-stacked slot arrays over the schedule's row partition
    (memoized per exact matrix + partition boundaries; with ``cache``, also
    served from / shipped to the PlanCache npz layer)."""
    starts_geo = tuple(int(s) for s in np.asarray(part.starts))

    def build():
        ia = _np(M.ia).astype(np.int64)
        smax = max(1, max(int(ia[part.starts[t + 1]] - ia[part.starts[t]])
                          for t in range(part.p)))
        smax = _round_up(smax, 128)
        spans, al, au, ad_shard = _sharded_slot_arrays(M, part, smax)
        return ShardedSlots(
            row_idx=torch.from_numpy(_stack_spans(
                row_of_slot(M), spans, smax, 0, np.int32)),
            ja=torch.from_numpy(_stack_spans(_np(M.ja), spans, smax, 0,
                                             np.int32)),
            al=torch.from_numpy(al), au=torch.from_numpy(au),
            ad_shard=torch.from_numpy(ad_shard), part=part)

    memo_key = (value_digest(M), np.asarray(part.starts).tobytes())
    return _memoized(M, cache, "sharded_slots", part.p, starts_geo,
                     _SHARDED_SLOTS_MEMO, memo_key, build)


def _halo_slot_positions(ros: np.ndarray, p: int, ns: int):
    """(shard, position) of every slot in the equal-row halo layout: slots
    are row-major, so a shard's slots are consecutive and the position is
    the slot index minus the shard's first slot (the JAX package's fill
    order: a stable sort over a non-decreasing shard array)."""
    shard = ros // ns
    first = np.searchsorted(shard, np.arange(p))
    q = np.arange(ros.shape[0], dtype=np.int64) - first[shard]
    return shard, q


def _halo_values(M: CSRC, p: int, ns: int, n_pad: int, smax: int):
    ros = row_of_slot(M)
    shard, q = _halo_slot_positions(ros, p, ns)
    al_s = np.zeros((p, smax), np.float32)
    au_s = np.zeros((p, smax), np.float32)
    al_s[shard, q] = _np(M.al)
    au_s[shard, q] = _np(M.au)
    ad_pad = np.zeros(n_pad, np.float32)
    ad_pad[:M.n] = _np(M.ad)
    return al_s, au_s, ad_pad.reshape(p, ns)


def build_halo_layout(M: CSRC, p: int, cache=None) -> HaloLayout:
    """Memoized per exact matrix + shard count (with ``cache``, also served
    from / shipped to the PlanCache npz layer).  Raises ValueError when the
    band does not fit inside one shard (the strategy's gate: fall back to
    allreduce / reduce_scatter).  Vectorized; the JAX package's arrays."""
    def build():
        n = M.n
        ns, h = halo_geometry(M, p)
        n_pad = ns * p
        ros = row_of_slot(M)
        shard, q = _halo_slot_positions(ros, p, ns)
        counts = np.bincount(shard, minlength=p)
        smax = _round_up(max(1, int(counts.max()) if counts.size else 0),
                         128)
        row_loc = np.zeros((p, smax), np.int32)
        col_rel = np.full((p, smax), ns + h - 1, np.int32)  # inert target
        row_loc[shard, q] = ros - shard * ns
        col_rel[shard, q] = _np(M.ja).astype(np.int64) - (shard * ns - h)
        al_s, au_s, ad = _halo_values(M, p, ns, n_pad, smax)
        return HaloLayout(p=p, ns=ns, h=h, n_pad=n_pad,
                          row_loc=torch.from_numpy(row_loc),
                          col_rel=torch.from_numpy(col_rel),
                          al=torch.from_numpy(al_s),
                          au=torch.from_numpy(au_s),
                          ad=torch.from_numpy(ad))

    return _memoized(M, cache, "halo", p, (), _HALO_LAYOUT_MEMO,
                     (value_digest(M), p), build, counter="halo_layout")


def _shard_support_of(path_name: str):
    sup = paths_mod.get_path(path_name).shard_support
    if sup is None:
        raise ValueError(f"path {path_name!r} registers no shard support; "
                         "the mesh strategies run it as index_add_")
    return sup


def build_path_shards(M: CSRC, part: RowPartition, plan: ExecutionPlan,
                      cache=None):
    """Per-shard packs of ``plan.path`` over the schedule's row partition
    (global coordinates; allreduce / reduce_scatter).  Generic over the
    registry's ShardSupport: memoized per exact matrix + partition
    boundaries + pack geometry; with ``cache``, also served from / shipped
    to the PlanCache npz layer."""
    sup = _shard_support_of(plan.path)
    kind = sup.shards_kind
    pgeo = sup.geometry(plan)
    geo = pgeo + tuple(int(s) for s in np.asarray(part.starts))
    memo_key = (value_digest(M), np.asarray(part.starts).tobytes()) + pgeo
    return _memoized(M, cache, kind, part.p, geo, _layout_memo(kind),
                     memo_key,
                     lambda: sup.pack_shards(M, np.asarray(part.starts),
                                             plan))


def build_path_halo(M: CSRC, p: int, plan: ExecutionPlan, cache=None):
    """Per-shard local-coordinate packs of ``plan.path`` for the halo
    strategy.  Raises ValueError when the band does not fit inside one
    shard (the gate of :func:`build_halo_layout`).  Memoized per exact
    matrix + shard count + pack geometry; with ``cache``, also served from
    / shipped to the PlanCache npz layer."""
    sup = _shard_support_of(plan.path)
    kind = sup.halo_kind
    geo = sup.geometry(plan)
    return _memoized(M, cache, kind, p, geo, _layout_memo(kind),
                     (value_digest(M), p) + geo,
                     lambda: sup.pack_halo(M, p, plan))


def build_flat_shards(M: CSRC, part: RowPartition, plan: ExecutionPlan,
                      cache=None):
    """The JAX package's name: :func:`build_path_shards` for a 'flat'
    plan."""
    return build_path_shards(M, part, plan, cache=cache)


def build_flat_halo_layout(M: CSRC, p: int, plan: ExecutionPlan,
                           cache=None):
    """The JAX package's name: :func:`build_path_halo` for a 'flat'
    plan."""
    return build_path_halo(M, p, plan, cache=cache)


# ---------------------------------------------------------------------------
# Same-structure value refresh of the shard layouts (the mesh's
# refresh_schedule: update_values / time stepping never re-pack,
# re-partition or re-color on the mesh)
# ---------------------------------------------------------------------------

def refresh_shard_layout(lay, M: CSRC, part: Optional[RowPartition] = None):
    """Refill a shard layout's value streams from a same-structure matrix.
    Structural arrays (slot indices, tile maps, halo geometry) are reused
    untouched and the refilled streams land on the layout's device; the
    probe counter is ``shard_value_refresh`` and no structural counter
    moves.  ``part`` is required for the partition-keyed layouts of the
    paths (FlatShards, NnzSplitShards: they do not embed their partition
    boundaries)."""
    BUILD_COUNTS.inc("shard_value_refresh")
    if isinstance(lay, ShardedSlots):
        return _refresh_sharded_slots(lay, M)
    if isinstance(lay, HaloLayout):
        return _refresh_halo_layout(lay, M)
    for entry in paths_mod.registered_paths():
        sup = entry.shard_support
        if sup is None:
            continue
        classes = sup.layout_classes()
        if isinstance(lay, classes[sup.shards_kind]):
            if part is None:
                raise ValueError(
                    f"refresh_shard_layout: {type(lay).__name__} needs "
                    "the row partition it was built over")
            return sup.refresh_shards(lay, M, np.asarray(part.starts))
        if isinstance(lay, classes[sup.halo_kind]):
            return sup.refresh_halo(lay, M)
    raise TypeError(f"unknown shard layout {type(lay).__name__}")


def _refresh_sharded_slots(ss: ShardedSlots, M: CSRC) -> ShardedSlots:
    """Value-only refill of the stacked slot arrays: the spans come again
    from the (unchanged) row pointers, so the padded layout matches the
    original build."""
    _, al, au, ad_shard = _sharded_slot_arrays(M, ss.part,
                                               int(ss.al.shape[1]))
    dev = ss.al.device
    return dataclasses.replace(
        ss, al=torch.from_numpy(al).to(dev), au=torch.from_numpy(au).to(dev),
        ad_shard=torch.from_numpy(ad_shard).to(dev))


def _refresh_halo_layout(lay: HaloLayout, M: CSRC) -> HaloLayout:
    """Value-only refill of the local-coordinate halo arrays."""
    al_s, au_s, ad = _halo_values(M, lay.p, lay.ns, lay.n_pad,
                                  int(lay.al.shape[1]))
    dev = lay.al.device
    return dataclasses.replace(lay, al=torch.from_numpy(al_s).to(dev),
                               au=torch.from_numpy(au_s).to(dev),
                               ad=torch.from_numpy(ad).to(dev))
