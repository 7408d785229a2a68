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

A schedule is built **once** per (matrix fingerprint, value digest, plan,
partition width) and stored next to the plan in the tuner's
:class:`~repro_torch.core.tuner.PlanCache` — a serving process that re-registers a
known matrix performs zero pack/partition/coloring work
(``BUILD_COUNTS`` is the probe tests assert that with).

Path-specific artifact contents (the block-ELL pack, the flat-grid pack,
the nnz-split pack, the coloring batches) are built and serialized by the
path's :class:`~repro_torch.core.paths.KernelPath` registry entry — this module owns
the common pieces (partition, halo, fingerprinting, cache plumbing) and
delegates the rest, so a newly registered path is schedule-cached with
zero edits here.

Serialization is npz + a JSON meta record (``save_npz`` / ``load_npz``);
``SCHEDULE_VERSION`` gates the on-disk layout — bumping it (e.g. on a pack
format change) invalidates every stored schedule, which is then silently
rebuilt on the next request.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch

from . import paths as paths_mod
from .blockell import BlockEll
from .csrc import CSRC, _np, row_of_slot
from .partition import (RowPartition, halo_widths, partition_rows_by_count,
                        partition_rows_by_nnz)
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
    # exact-structure digest (ia/ja/iar/jar only — values excluded): the
    # key of the value-refresh fast path (refresh_schedule)
    structure_digest: str = ""

    def to(self, device) -> "SpmvSchedule":
        """The same schedule with its tensor-bearing artifacts (the
        block-ELL, flat or nnz-split pack) on ``device``; partition, halo
        and the coloring batches stay host numpy (the colorful executor
        uploads its batches once, when it is bound)."""
        moved = {f: getattr(self, f).to(device)
                 for f in ("pack", "flat_pack", "nnzsplit_pack")
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
            np.savez_compressed(f, __meta__=np.frombuffer(
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
    """
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
    need refreshing (:func:`refresh_schedule`).
    """
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
    from repro_torch import obs

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
        from repro_torch import obs
        obs.counter("plan_cache_lookups_total", kind="schedule",
                    outcome="refresh").inc()
        sched = refresh_schedule(base, M)
        # the refreshed generation supersedes the base in memory (one
        # schedule per structure, not one per step); the npz already on
        # disk keeps serving fresh processes, so skip re-compressing a
        # full artifact per time step
        cache.drop_schedule(base, remove_file=False)
        cache.put_schedule(sched, persist=False)
    else:
        sched = build_schedule(M, plan, p=p)
        cache.put_schedule(sched)
    return sched
