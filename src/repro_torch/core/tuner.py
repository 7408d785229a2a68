"""Autotuner: measure feasible ExecutionPlans per matrix, cache the argmin.

This is the paper's per-matrix strategy-selection problem (§4: which
strategy wins depends on the matrix) solved the way RACE (arXiv:1907.06487)
and Bergmans et al. (arXiv:2502.19284) do it: enumerate feasible
candidates from matrix statistics, price them, *measure* the cheapest on
the device, and remember the winner.

  MatrixStats / stats_of     the statistics that gate candidates
                             (bandwidth, nnz/row deviation, working set,
                             numeric symmetry)
  fingerprint                stable string key of a matrix *class*
                             (n, m, k, bandwidth, nnz-histogram digest)
  enumerate_plans            feasible candidates from stats, one
                             enumerator per registered KernelPath
                             (core/paths.py), plus the
                             @register_candidate_source hook — the JAX
                             package's list, plan for plan and in order
  heuristic_plan             measurement-free default: ``kernel`` if the
                             window fits, else ``segment``, plus the
                             analytic distributed fields
  PlanCache                  JSON plan cache keyed by fingerprint, with the
                             schedule npz layer and the assembly layer
                             (schedules and tuned strategies) beside it;
                             the file formats are the JAX package's, so
                             caches written by either package load in the
                             other
  tune / plan_for            the tuning entry points used by solvers, the
                             serve engine and chip_smoke.py
  mesh_fingerprint, enumerate_mesh_plans, heuristic_mesh_plan,
  tune_mesh / mesh_plan_for  the mesh-aware mode: strategy='mesh' plans per
                             shard count, one winner per (matrix class, p)

``tune`` ranks the pool with the cost model's card pricing
(``roofline.cost_model.rank_card_plans``, denominators measured on the
device by ``calibrate``), measures the cheapest plans on the device with
``device.time_fn`` and stores the winner's schedule next to its plan.
``tune(mesh_ps=...)`` / ``tune_mesh`` measure every distributed candidate
of the JAX package's enumeration on a :class:`~repro_torch.core.
distributed.ShardMesh` (the p shards emulated on one device unless a
process-group mesh is given) with the same timer, and ship the winner's
shard layouts through the cache.

Windowed candidates with ``value_dtype='bfloat16'`` (enumerated only for
numerically-symmetric matrices) additionally pass an accuracy check
against the exact ``segment`` product on the same device before they may
win (``VALUE_DTYPE_TOL``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import obs
from . import paths as paths_mod
from .csrc import CSRC, bandwidth as csrc_bandwidth, nnz_per_row
from .plan import ExecutionPlan, feasible, kernel_window


# ---------------------------------------------------------------------------
# Matrix statistics and fingerprinting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MatrixStats:
    n: int
    m: int
    k: int
    nnz: int
    bandwidth: int
    working_set_bytes: int
    nnz_row_mean: float
    nnz_row_dev: float            # std of nnz per row (what drives load balance)
    numerically_symmetric: bool


def stats_of(M: CSRC) -> MatrixStats:
    w = nnz_per_row(M)
    return MatrixStats(
        n=M.n, m=M.m, k=M.k, nnz=M.nnz,
        bandwidth=csrc_bandwidth(M),
        working_set_bytes=M.working_set_bytes(),
        nnz_row_mean=float(w.mean()),
        nnz_row_dev=float(w.std()),
        numerically_symmetric=bool(M.numerically_symmetric),
    )


def fingerprint(M: CSRC) -> str:
    """Stable key of the matrix *class*: (n, m, k, bandwidth) in the clear
    plus a digest of the nnz-per-row histogram and symmetry flag.  Two
    matrices of the same class (same generator, same size) share a key, so
    solvers and the serve engine never re-tune a known class.  A
    ``schedule.digest`` span."""
    with obs.span("schedule.digest", of="fingerprint"):
        w = nnz_per_row(M)
        hist = np.bincount(np.minimum(w, 255).astype(np.int64),
                           minlength=256)
        h = hashlib.sha1()
        h.update(hist.astype(np.int64).tobytes())
        h.update(bytes([int(M.numerically_symmetric)]))
        band = csrc_bandwidth(M)
        return f"n{M.n}m{M.m}k{M.k}b{band}-{h.hexdigest()[:12]}"


def mesh_fingerprint(fp: str, p: int) -> str:
    """Cache key of the per-(matrix class, mesh width) distributed tuning
    decision — the mesh-aware mode records one winner per (matrix, p)."""
    return f"{fp}@p{p}"


def _distributed_fields(stats: MatrixStats, p_hint: int = 8):
    """Analytic choice of the sharding degrees of freedom (not measured on
    a single chip): nnz-balanced partition unless rows are uniform; halo when
    the band fits inside a shard (the collective-bytes model's winner),
    reduce_scatter otherwise."""
    partition = "nnz" if stats.nnz_row_dev > 0 else "count"
    rows_per_shard = max(1, -(-stats.n // p_hint))
    acc = ("halo" if stats.bandwidth <= max(8, rows_per_shard)
           else "reduce_scatter")
    return partition, acc


# ---------------------------------------------------------------------------
# Candidate enumeration
# ---------------------------------------------------------------------------

_CANDIDATE_SOURCES: List[Callable[[MatrixStats], List[ExecutionPlan]]] = []


def register_candidate_source(fn):
    """Extension hook: a function ``stats -> [ExecutionPlan, ...]`` whose
    (feasible) plans join every enumeration and therefore every tuning
    run."""
    _CANDIDATE_SOURCES.append(fn)
    return fn


def enumerate_plans(stats: MatrixStats,
                    tms=(32, 128),
                    k_steps_sublanes=(8,),
                    w_cap: int = 4096,
                    colorful_max_n: int = 2048,
                    p_hint: int = 8,
                    nrhs_options=(1,),
                    index_dtypes=("int32", "int16"),
                    colorings=("greedy", "race")) -> List[ExecutionPlan]:
    """All feasible candidate plans for a matrix with these statistics.

    Every registered path contributes its own enumerator over the sweep
    space (``segment`` always; ``kernel`` and, past the skew gate,
    ``flat`` per (tm, k_step) whose window fits under ``w_cap``;
    ``nnzsplit`` past the unstructured gate; ``colorful`` for square
    matrices up to ``colorful_max_n`` rows), then the
    ``@register_candidate_source`` hooks.  Every candidate is filtered
    through its path's feasibility predicate.  ``nrhs_options`` replicates
    every candidate per RHS block width (the serving engine's batched
    operating point); ``index_dtypes`` and ``colorings`` bound the
    windowed index-stream and the colorful provider proposals.  The list
    is the JAX package's for the same statistics, in the same order.
    """
    partition, acc = _distributed_fields(stats, p_hint)
    space = paths_mod.CandidateSpace(
        tms=tuple(tms), k_steps_sublanes=tuple(k_steps_sublanes),
        w_cap=w_cap, colorful_max_n=colorful_max_n,
        partition=partition, accumulation=acc,
        index_dtypes=tuple(index_dtypes),
        colorings=tuple(colorings))
    raw: List[ExecutionPlan] = []
    for entry in paths_mod.registered_paths():
        raw.extend(entry.candidates(stats, space))
    for source in _CANDIDATE_SOURCES:
        raw.extend(source(stats))
    plans = [p for p in raw
             if feasible(p, n=stats.n, m=stats.m, bandwidth=stats.bandwidth)]
    if tuple(nrhs_options) != (1,):
        plans = [dataclasses.replace(p, nrhs=r)
                 for p in plans for r in nrhs_options]
    # dedup on the full plan (frozen dataclass), preserving order — key()
    # elides execution-irrelevant fields and must not drop distinct plans
    seen, out = set(), []
    for p in plans:
        if p not in seen:
            seen.add(p)
            out.append(p)
    return out


def heuristic_plan(stats: MatrixStats, tm: int = 128,
                   w_cap: int = 4096) -> ExecutionPlan:
    """Measurement-free plan: the old SpmvOperator 'auto' logic (kernel if
    the window fits, else segment) with the analytic distributed fields."""
    partition, acc = _distributed_fields(stats)
    square = stats.n == stats.m
    if square and kernel_window(tm, stats.bandwidth) <= w_cap:
        return ExecutionPlan(path="kernel", tm=tm, w_cap=w_cap,
                             partition=partition, accumulation=acc)
    return ExecutionPlan(path="segment", w_cap=w_cap,
                         partition=partition, accumulation=acc)


# ---------------------------------------------------------------------------
# Mesh-aware candidate enumeration (strategy='mesh' plans per shard count)
# ---------------------------------------------------------------------------

# A distributed candidate is dropped when its estimated collective traffic
# exceeds this multiple of the shard's compute-stream bytes (working set /
# p): past that point the product is collective-bound by construction
# (Schubert et al., arXiv:0910.4836).
MESH_COLLECTIVE_RATIO = 4.0


def _halo_fits(stats: MatrixStats, p: int) -> bool:
    ns = -(-stats.n // p)
    ns = (ns + 7) // 8 * 8
    h = max(8, (stats.bandwidth + 7) // 8 * 8)
    return h <= ns


def enumerate_mesh_plans(stats: MatrixStats, p: int,
                         tms=(32, 128),
                         k_steps_sublanes=(8,),
                         w_cap: int = 4096,
                         nrhs_options=(1,),
                         index_dtypes=("int32", "int16"),
                         max_collective_ratio: float = MESH_COLLECTIVE_RATIO
                         ) -> List[ExecutionPlan]:
    """Distributed candidate plans for a p-way mesh — the JAX package's
    list, plan for plan and in order.

    Shard-local compute comes from ``segment`` and every registered path
    with ShardSupport (``flat`` past the skew gate, ``nnzsplit`` past the
    unstructured gate), float32 values only, crossed with every
    accumulation whose collective footprint passes the gate: ``halo`` only
    when the band fits inside one shard, and any strategy only when
    ``collective_bytes_from_stats`` stays within ``max_collective_ratio``
    times the shard's working-set bytes."""
    from .distributed import collective_bytes_from_stats

    if stats.n != stats.m or p < 1:
        return []                 # the strategies shard square rows
    partition = "nnz" if stats.nnz_row_dev > 0 else "count"
    space = paths_mod.CandidateSpace(
        tms=tuple(tms), k_steps_sublanes=tuple(k_steps_sublanes),
        w_cap=w_cap, partition=partition,
        index_dtypes=tuple(index_dtypes), value_dtypes=("float32",))
    bases: List[ExecutionPlan] = []
    for entry in paths_mod.registered_paths():
        if entry.name != "segment" and entry.shard_support is None:
            continue
        for cand in entry.candidates(stats, space):
            if feasible(cand, n=stats.n, m=stats.m,
                        bandwidth=stats.bandwidth):
                bases.append(cand)
    shard_ws = max(1, stats.working_set_bytes // p)
    out: List[ExecutionPlan] = []
    for acc in ("halo", "reduce_scatter", "allreduce"):
        if acc == "halo" and not _halo_fits(stats, p):
            continue
        for r in nrhs_options:
            est = collective_bytes_from_stats(
                stats.n, stats.bandwidth, p, acc, nrhs=r)
            if est > max_collective_ratio * shard_ws:
                continue          # collective-bound by construction
            for base in bases:
                out.append(dataclasses.replace(
                    base, strategy="mesh", mesh_p=p, accumulation=acc,
                    nrhs=r))
    return out


def heuristic_mesh_plan(stats: MatrixStats, p: int,
                        w_cap: int = 4096) -> ExecutionPlan:
    """Measurement-free distributed plan: ``segment`` shard compute with
    the collective-bytes model's strategy (halo when the band fits inside a
    shard, else reduce_scatter).  Raises ValueError for rectangular
    matrices: the strategies shard square rows only."""
    if stats.n != stats.m:
        raise ValueError(
            "distributed strategies shard square matrices only; serve "
            "rectangular matrices through a local plan")
    partition = "nnz" if stats.nnz_row_dev > 0 else "count"
    acc = "halo" if _halo_fits(stats, p) else "reduce_scatter"
    return ExecutionPlan(path="segment", w_cap=w_cap, partition=partition,
                         accumulation=acc, strategy="mesh", mesh_p=p)


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------

class PlanCache:
    """JSON plan cache keyed by matrix fingerprint.

    File format (version 1):

        {"version": 1,
         "entries": {"<fingerprint>": {"plan": {...ExecutionPlan fields...},
                                       "best_us": 12.3,
                                       "timings_us": {"<plan key>": 12.3}}}}

    A ``get`` hit returns the stored plan without any re-measurement; the
    hit/miss counters let tests (and ops dashboards) assert that.  Entries
    carry a ``measured`` flag: heuristic (unmeasured) plans cached by
    ``plan_for(autotune=False)`` are visible to heuristic lookups but do
    NOT satisfy ``tune()``, which would otherwise report a never-measured
    plan as the argmin.

    Next to each plan the cache stores the **schedule artifact**
    (core/schedule.py): the block-ELL pack, row partition/halo ranges, and
    coloring the plan executes with.  Schedules live in memory plus — when
    the cache has a file path — as npz files under ``<stem>_schedules/``
    beside the JSON, keyed by (fingerprint, value digest, plan, partition
    width).  ``get_schedule`` hits mean zero pack/partition/coloring work;
    a schedule whose ``SCHEDULE_VERSION`` no longer matches is ignored and
    rebuilt (format-change invalidation).
    """

    VERSION = 1

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.entries: Dict[str, Dict] = {}
        self.hits = 0
        self.misses = 0
        self.schedules: Dict[str, object] = {}
        self.schedule_hits = 0
        self.schedule_misses = 0
        self.assembly_schedules: Dict[str, object] = {}
        self.assembly_hits = 0
        self.assembly_misses = 0
        self.shard_layouts: Dict[str, object] = {}
        self.shard_layout_hits = 0
        self.shard_layout_misses = 0
        if path is not None and os.path.exists(path):
            self._read(path)

    def _read(self, path: str):
        with open(path) as f:
            data = json.load(f)
        if data.get("version") != self.VERSION:
            raise ValueError(
                f"plan cache {path}: version {data.get('version')!r} "
                f"!= {self.VERSION}")
        self.entries = dict(data.get("entries", {}))

    def save(self, path: Optional[str] = None):
        path = path or self.path
        if path is None:
            raise ValueError("PlanCache.save: no path given or stored")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"version": self.VERSION, "entries": self.entries},
                      f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        self.path = path

    def get(self, fp: str,
            require_measured: bool = False) -> Optional[ExecutionPlan]:
        e = self.entries.get(fp)
        if e is None or (require_measured and not e.get("measured")):
            self.misses += 1
            obs.counter("plan_cache_lookups_total", kind="plan",
                        outcome="miss").inc()
            return None
        self.hits += 1
        obs.counter("plan_cache_lookups_total", kind="plan",
                    outcome="hit").inc()
        env = e.get("env")
        if env:
            # a winner measured under a different toolchain/device is
            # identifiable; loading one bumps the warning counter per
            # disagreeing field (git SHA excluded — see obs.provenance)
            for field in obs.env_mismatches(env):
                obs.counter("plan_cache_env_mismatch_total",
                            field=field).inc()
        return ExecutionPlan.from_dict(e["plan"])

    def put(self, fp: str, plan: ExecutionPlan,
            timings_s: Optional[Dict[str, float]] = None,
            predictions_s: Optional[Dict[str, float]] = None,
            roofline: Optional[Dict[str, float]] = None,
            denominators: Optional[Dict[str, object]] = None):
        """``predictions_s`` (plan key -> analytic seconds) and
        ``roofline`` ({'predicted_ms', 'measured_ms', 'roofline_fraction'}
        of the winner) are the predict-then-measure provenance: the cache
        records what the cost model claimed next to what the clock said —
        and ``env`` records which torch/device/git environment measured it
        (obs.environment_provenance), ``denominators`` what the
        predictions were priced with (``cost_model.Denominators``; a field
        the JAX package does not read)."""
        entry: Dict = {"plan": plan.to_dict(),
                       "measured": bool(timings_s),
                       "env": dict(obs.environment_provenance())}
        if denominators:
            entry["denominators"] = dict(denominators)
        if timings_s:
            entry["timings_us"] = {k: round(v * 1e6, 3)
                                   for k, v in timings_s.items()}
            entry["best_us"] = round(min(timings_s.values()) * 1e6, 3)
        if predictions_s:
            entry["predicted_us"] = {k: round(v * 1e6, 3)
                                     for k, v in predictions_s.items()}
        if roofline:
            entry.update({k: roofline[k] for k in
                          ("predicted_ms", "measured_ms",
                           "roofline_fraction") if k in roofline})
        self.entries[fp] = entry

    # ---- schedule artifacts (stored next to the plans) ----

    def _schedule_dir(self) -> Optional[str]:
        if self.path is None:
            return None
        stem, _ = os.path.splitext(os.path.abspath(self.path))
        return stem + "_schedules"

    def get_schedule(self, fp: str, digest: str, plan: ExecutionPlan,
                     p: int = 8):
        """The cached schedule for (matrix, plan), or None.  Memory first,
        then the npz file beside the cache; version/plan mismatches count
        as misses (the caller rebuilds)."""
        from .schedule import (SpmvSchedule, plan_artifact_fields,
                               schedule_key)
        key = schedule_key(fp, digest, plan, p)
        sched = self.schedules.get(key)
        if sched is None:
            d = self._schedule_dir()
            f = None if d is None else os.path.join(d, key + ".npz")
            if f is not None and os.path.exists(f):
                try:
                    # the npz reload and the pack's checks (slot order)
                    with obs.span("schedule.load", path=plan.path):
                        sched = SpmvSchedule.load_npz(f)
                except Exception:         # stale version, truncated or
                    sched = None          # foreign file: rebuild, not crash
                if sched is not None and (
                        plan_artifact_fields(sched.plan)
                        != plan_artifact_fields(plan)
                        or sched.value_digest != digest):
                    sched = None
                if sched is not None:
                    self.schedules[key] = sched
        if sched is None:
            self.schedule_misses += 1
            obs.counter("plan_cache_lookups_total", kind="schedule",
                        outcome="miss").inc()
            return None
        self.schedule_hits += 1
        obs.counter("plan_cache_lookups_total", kind="schedule",
                    outcome="hit").inc()
        return sched

    def put_schedule(self, sched, persist: bool = True):
        """Store a schedule (memory, and — for path-backed caches — as an
        npz beside the plans).  ``persist=False`` keeps it memory-only:
        the value-refresh path uses it so per-step time stepping does not
        re-write a full npz (values + unchanged index streams) every
        step; the structural generation already on disk keeps serving
        fresh processes, which value-refresh from it on load."""
        key = sched.key()
        self.schedules[key] = sched
        d = self._schedule_dir()
        if persist and d is not None:
            sched.save_npz(os.path.join(d, key + ".npz"))

    def drop_schedule(self, sched, remove_file: bool = True):
        """Evict a schedule from memory (and, by default, its npz).  Used
        by the value-refresh path to replace a superseded value
        generation: time stepping keeps exactly one schedule per
        (structure, plan, p) in memory — the newest — so a 10k-step run
        does not accumulate 10k dead value streams."""
        key = sched.key()
        self.schedules.pop(key, None)
        d = self._schedule_dir()
        if remove_file and d is not None:
            try:
                os.remove(os.path.join(d, key + ".npz"))
            except OSError:
                pass

    def find_schedule_by_structure(self, fp: str, sdigest: str, plan,
                                   p: int = 8):
        """A cached schedule for the same matrix *structure* (fingerprint +
        structure digest + plan artifact geometry + partition width) whose
        values may differ — the FEM time-stepping fast path: the caller
        refreshes value streams (``schedule.refresh_schedule``) instead of
        re-packing/re-coloring.  In-memory schedules only: the scenario is
        repeated refreshes within one serving/solver process."""
        from .schedule import plan_artifact_fields
        fields = plan_artifact_fields(plan)
        for sched in self.schedules.values():
            if (sched.fingerprint == fp and sched.p == p
                    and sched.structure_digest == sdigest
                    and plan_artifact_fields(sched.plan) == fields):
                return sched
        return None

    # ---- shard layouts of the mesh strategies (ShardedSlots / HaloLayout
    # and the paths' shard packs), stored beside the schedules and keyed by
    # (fingerprint, value digest, p, kind, geometry) — the npz layer that
    # ships per-shard artifacts to serving workers ----

    def get_shard_layout(self, key: str):
        """The cached shard layout for this key, or None.  Memory first,
        then the npz beside the plans — a hit means zero per-shard pack or
        layout construction."""
        from .schedule import load_shard_layout_npz
        lay = self.shard_layouts.get(key)
        if lay is None:
            d = self._schedule_dir()
            f = None if d is None else os.path.join(d, key + ".npz")
            if f is not None and os.path.exists(f):
                try:
                    lay = load_shard_layout_npz(f)
                except Exception:     # stale version / truncated: rebuild
                    lay = None
                if lay is not None:
                    self.shard_layouts[key] = lay
        if lay is None:
            self.shard_layout_misses += 1
            obs.counter("plan_cache_lookups_total", kind="shard_layout",
                        outcome="miss").inc()
            return None
        self.shard_layout_hits += 1
        obs.counter("plan_cache_lookups_total", kind="shard_layout",
                    outcome="hit").inc()
        return lay

    def put_shard_layout(self, key: str, lay, persist: bool = True):
        from .schedule import save_shard_layout_npz
        self.shard_layouts[key] = lay
        d = self._schedule_dir()
        if persist and d is not None:
            save_shard_layout_npz(os.path.join(d, key + ".npz"), lay)

    # ---- assembly schedules (repro_torch.assembly.scatter), stored beside
    # the SpMV schedules and keyed by connectivity digest ----

    def get_assembly_schedule(self, digest: str, num_buffers: int = 8,
                              coloring: str = "greedy"):
        """The cached AssemblySchedule for this connectivity digest, or
        None.  Memory first, then the npz beside the cache — a hit means
        zero structural assembly work (slot maps, coloring, buffers).
        ``coloring`` picks the element-coloring provider slice of the
        cache."""
        from repro_torch.assembly.scatter import (AssemblySchedule,
                                                  assembly_key)
        key = assembly_key(digest, num_buffers, coloring)
        sched = self.assembly_schedules.get(key)
        if sched is None:
            d = self._schedule_dir()
            f = None if d is None else os.path.join(d, key + ".npz")
            if f is not None and os.path.exists(f):
                try:
                    sched = AssemblySchedule.load_npz(f)
                except Exception:      # stale version / truncated: rebuild
                    sched = None
                if sched is not None and (
                        sched.structure_digest != digest
                        or sched.coloring.provider != coloring):
                    sched = None
                if sched is not None:
                    self.assembly_schedules[key] = sched
        if sched is None:
            self.assembly_misses += 1
            obs.counter("plan_cache_lookups_total", kind="assembly",
                        outcome="miss").inc()
            return None
        self.assembly_hits += 1
        obs.counter("plan_cache_lookups_total", kind="assembly",
                    outcome="hit").inc()
        return sched

    def put_assembly_schedule(self, sched):
        key = sched.key()
        self.assembly_schedules[key] = sched
        d = self._schedule_dir()
        if d is not None:
            sched.save_npz(os.path.join(d, key + ".npz"))

    # ---- assembly strategy plans (assembly.scatter.tune_assembly): the
    # tuned (strategy, variant) winner + predict/measure provenance, stored
    # as a JSON record under "asmplan-<schedule key>" ----

    def get_assembly_plan(self, key: str):
        """The tuned assembly record for this schedule key, or None."""
        e = self.entries.get(key)
        rec = None if e is None else e.get("assembly")
        if rec is None:
            obs.counter("plan_cache_lookups_total", kind="assembly_plan",
                        outcome="miss").inc()
            return None
        obs.counter("plan_cache_lookups_total", kind="assembly_plan",
                    outcome="hit").inc()
        return dict(rec)

    def put_assembly_plan(self, key: str, record: Dict):
        self.entries[key] = {"assembly": dict(record), "measured": True}
        if self.path:
            self.save()

    def __len__(self) -> int:
        return len(self.entries)


# ---------------------------------------------------------------------------
# Tuning
# ---------------------------------------------------------------------------

# Max relative error a reduced-precision (value_dtype != 'float32')
# candidate may show against the exact segment-sum product before the
# tuner rejects it — the accuracy gate of the bf16 value-stream trade.
VALUE_DTYPE_TOL = 2e-2


def _rhs_pool(M: CSRC, x, device):
    """Measurement inputs per RHS block width on ``device``: the JAX
    package's seeds (``default_rng(0)`` for x, ``default_rng(nrhs)`` per
    width), made with numpy and memoized per width."""
    if x is None:
        x = np.random.default_rng(0).standard_normal(M.m).astype(np.float32)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, dtype=np.float32))
    xt = x.to(device=device, dtype=torch.float32)
    by_width = {1: xt} if xt.ndim == 1 else {xt.shape[1]: xt, 1: xt[:, 0]}

    def x_for(nrhs: int):
        if nrhs not in by_width:
            by_width[nrhs] = torch.from_numpy(
                np.random.default_rng(nrhs).standard_normal(
                    (M.m, nrhs)).astype(np.float32)).to(device)
        return by_width[nrhs]

    return x_for


@dataclasses.dataclass(frozen=True)
class TuneResult:
    plan: ExecutionPlan
    fingerprint: str
    timings_s: Dict[str, float]   # plan.key() -> seconds; empty on cache hit
    cached: bool
    # per-p distributed winners when tune() ran with mesh_ps (empty
    # otherwise); also recorded in the cache under mesh_fingerprint keys
    mesh_plans: Dict[int, ExecutionPlan] = dataclasses.field(
        default_factory=dict)
    # predict-then-measure provenance: plan.key() -> card-priced seconds
    # for every ranked candidate (superset of timings_s keys when pruning
    # ran), and the winner's achieved-roofline fraction
    predictions_s: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    roofline_fraction: Optional[float] = None


# Per-column times within this fraction of the best are level: the card's
# run-to-run spread of one kernel, within which the measurement cannot
# order two plans.
LEVEL_TOL = 0.03


def _measured_set(ranked, measure_top_k: Optional[int]):
    """The predict-then-measure cut over price groups ranked cheapest-first
    (``(plans, estimate)`` pairs; a group is the plans of one schedule
    artifact and RHS width, such as a stream plan and its one-hot twin,
    priced by its cheapest plan): whole groups while they fit in
    ``measure_top_k`` plans (default max(3, a quarter of the pool)), at
    least the first, plus each path's best-predicted group, so that no path
    is pruned unseen."""
    n_plans = sum(len(g) for g, _ in ranked)
    k_top = min(n_plans, max(2, measure_top_k if measure_top_k
                             else max(3, n_plans // 4)))
    chosen, count = [], 0
    for g, _ in ranked:
        if chosen and count + len(g) > k_top:
            break
        chosen.append(g)
        count += len(g)
    seen_paths = {g[0].path for g in chosen}
    for g, _ in ranked:
        if g[0].path not in seen_paths:
            chosen.append(g)
            seen_paths.add(g[0].path)
    return [p for g in chosen for p in g]


def tune(M: CSRC,
         cache: Optional[PlanCache] = None,
         x=None,
         candidates: Optional[List[ExecutionPlan]] = None,
         measure: Optional[Callable] = None,
         warmup: int = 1,
         repeats: int = 3,
         device=None,
         save: bool = True,
         value_dtype_tol: float = VALUE_DTYPE_TOL,
         predict: bool = True,
         measure_top_k: Optional[int] = None,
         nrhs_options=(1,),
         mesh_ps=(),
         mesh=None) -> TuneResult:
    """Rank candidates by card pricing, measure the cheapest on ``device``
    (default the card) and return the argmin plan.

    ``cache`` short-circuits: a measured fingerprint hit returns the stored
    plan with zero measurements (a heuristic entry does not count).
    ``measure(op, x) -> seconds`` is injectable for tests; the default is
    ``device.time_fn`` with ``warmup`` / ``repeats`` (CUDA events on the
    card).

    ``predict=True`` (default) prices every feasible candidate with
    ``cost_model.rank_card_plans`` (no packing, no timing), ranks the
    groups of plans sharing a schedule artifact and RHS width by their
    cheapest plan, and measures only the cheapest groups
    (:func:`_measured_set`).  When the winner is
    wider than one column, the one-column twins of its artifact are then
    timed on its schedule (they serve single requests) and join the
    argmin; variants of the winner's artifact and width whose per-column
    times are level with it (``LEVEL_TOL``) are ordered by their
    one-column twins' times.  The cache entry records ``predicted_us`` per
    ranked candidate, the winner's ``predicted_ms`` / ``measured_ms`` /
    ``roofline_fraction`` and the ``denominators`` priced with.
    ``predict=False`` measures the full pool and returns its per-column
    argmin, as the JAX package does.

    Candidates sharing a schedule artifact (``schedule.plan_artifact_
    fields``: plans that differ only in variant, RHS width or
    accumulation) are measured one after the other on one build of it
    (span ``tune.pack``), bound to the device once (binding and measuring
    under span ``tune.measure``); equal times go to the plan earlier in the
    measured list (ranked order, or enumeration order when
    ``predict=False``), as if the list had been measured in order.  Only the schedule of
    the best plan so far is kept besides the one being measured, and no
    losing operator outlives its measurement.

    Candidates with a reduced ``value_dtype`` must first match the exact
    ``segment`` product within ``value_dtype_tol`` relative error.
    ``nrhs_options`` replicates every candidate per RHS block width; the
    argmin is on per-column time.

    ``mesh_ps`` is the mesh-aware mode: for every shard count listed,
    :func:`tune_mesh` measures the distributed candidates (on ``mesh`` if
    given; without one only p = 1 runs, ``placement.mesh_available``) and
    records the per-(matrix, p) winner under ``mesh_fingerprint(fp, p)``;
    a measured local entry in the cache then spares the local tuning.
    """
    dev = device_mod.resolve(device)
    fp = fingerprint(M)
    hit = None
    if cache is not None:
        # a heuristic (unmeasured) entry must not satisfy a tune request
        hit = cache.get(fp, require_measured=True)
    if hit is not None:
        res = TuneResult(plan=hit, fingerprint=fp, timings_s={},
                         cached=True)
    else:
        res = _tune_local(M, fp, cache, x, candidates, measure, warmup,
                          repeats, dev, save, value_dtype_tol, predict,
                          measure_top_k, nrhs_options)
    if not mesh_ps:
        return res
    mesh_plans = {p: tune_mesh(M, p, cache=cache, mesh=mesh, x=x,
                               measure=measure, warmup=warmup,
                               repeats=repeats, device=dev, save=save,
                               nrhs_options=nrhs_options).plan
                  for p in mesh_ps}
    return dataclasses.replace(res, mesh_plans=mesh_plans)


def _tune_local(M, fp, cache, x, candidates, measure, warmup, repeats, dev,
                save, value_dtype_tol, predict, measure_top_k,
                nrhs_options) -> TuneResult:
    """:func:`tune`'s local mode after its cache probe missed."""
    from repro_torch.kernels import ref as ref_mod
    from repro_torch.kernels.ops import SpmvOperator
    from repro_torch.roofline import cost_model
    from . import schedule as schedule_mod

    stats = stats_of(M)
    cands = (candidates if candidates is not None
             else enumerate_plans(stats, nrhs_options=tuple(nrhs_options)))
    if measure is None:
        def measure(op, xv):
            return device_mod.time_fn(op, xv, warmup=warmup,
                                      repeats=repeats)
    x_for = _rhs_pool(M, x, dev)
    M_dev = M.to(dev)
    y_ref_by_width: Dict[int, torch.Tensor] = {}

    def accuracy_ok(op, nrhs: int) -> bool:
        """Reduced-precision gate against the exact segment product."""
        xv = x_for(nrhs)
        if nrhs not in y_ref_by_width:
            y_ref_by_width[nrhs] = (ref_mod.csrc_spmm(M_dev, xv)
                                    if xv.ndim == 2
                                    else ref_mod.csrc_spmv(M_dev, xv)
                                    ).double()
        y_ref = y_ref_by_width[nrhs]
        err = float((op(xv).double() - y_ref).abs().max())
        scale = max(1.0, float(y_ref.abs().max()))
        return err / scale <= value_dtype_tol

    pool = [p for p in cands
            if feasible(p, n=M.n, m=M.m, bandwidth=stats.bandwidth)]
    feasible_pool = pool
    obs.counter("tuner_candidates_enumerated_total").inc(len(pool))
    predictions: Dict[str, float] = {}
    est_by_key: Dict[str, object] = {}
    den = None
    if predict and pool:
        den = cost_model.calibrate(dev)
        # groups of plans sharing an artifact and a width (a stream plan
        # and its one-hot twin), measured whole, ranked by their cheapest
        # plan
        price_groups: Dict[tuple, List[ExecutionPlan]] = {}
        for p in pool:
            price_groups.setdefault(
                (schedule_mod.plan_artifact_fields(p), p.nrhs), []).append(p)
        priced = cost_model.rank_card_plans(stats, pool, den)
        est_by_key = {p.key(): e for p, e in priced}
        group_of = {q.key(): g for g in price_groups.values() for q in g}
        ranked, seen = [], set()
        for p, e in priced:                 # cheapest plan of each group
            g = group_of[p.key()]
            if id(g) not in seen:
                seen.add(id(g))
                ranked.append((g, e))
        predictions = {k: e.predicted_s for k, e in est_by_key.items()}
        measured = _measured_set(ranked, measure_top_k)
        pruned = len(pool) - len(measured)
        obs.counter("tuner_candidates_pruned_total").inc(pruned)
        # predict-then-measure savings: fraction of the feasible pool the
        # ranking removed from the clock
        obs.gauge("tuner_predict_measure_savings").set(pruned / len(pool))
        pool = measured

    timings: Dict[str, float] = {}

    def measure_plan(p: ExecutionPlan, bound) -> Optional[float]:
        """Seconds of ``p`` on a bound schedule, None when the precision
        trade fails the accuracy gate."""
        with obs.span("tune.measure", plan=p.key()):
            op = SpmvOperator.from_plan(M_dev, p, device=dev,
                                        schedule=bound)
            ok = p.value_dtype == "float32" or accuracy_ok(op, p.nrhs)
            t = float(measure(op, x_for(p.nrhs))) if ok else None
            del op
        if t is not None:
            obs.counter("tuner_candidates_measured_total").inc()
            timings[p.key()] = t
        return t

    # one build (and one upload) per schedule artifact
    groups: Dict[tuple, List[int]] = {}
    for i, p in enumerate(pool):
        groups.setdefault(schedule_mod.plan_artifact_fields(p), []).append(i)
    best = None                    # (per-column seconds, pool index)
    best_sched = None
    for members in groups.values():
        try:
            with obs.span("tune.pack", plan=pool[members[0]].key()):
                sched = schedule_mod.build_schedule(M, pool[members[0]])
        except ValueError:
            continue              # pack-time infeasibility (bandwidth gate)
        bound = sched.to(dev)
        for i in members:
            t = measure_plan(pool[i], bound)
            # argmin on per-RHS-column time: an nrhs=8 candidate does 8x
            # the work of a single product; equal times keep pool order
            if t is not None and (best is None
                                  or (t / pool[i].nrhs, i) < best):
                best, best_sched = (t / pool[i].nrhs, i), sched
        del bound, sched
    if best is None:
        raise ValueError("no feasible execution plan for this matrix")

    if predict and pool[best[1]].nrhs > 1:
        # the winner's one-column twins, on its schedule: they join the
        # argmin, and order the variants level with the winner
        art = schedule_mod.plan_artifact_fields(pool[best[1]])
        twins = [p for p in feasible_pool if p.nrhs == 1
                 and p.key() not in timings
                 and schedule_mod.plan_artifact_fields(p) == art]
        if twins:
            bound = best_sched.to(dev)
            for p in twins:
                pool.append(p)
                t = measure_plan(p, bound)
                if t is not None and (t, len(pool) - 1) < best:
                    best = (t, len(pool) - 1)
            del bound
        width = pool[best[1]].nrhs
        level = [i for i, p in enumerate(pool)
                 if p.nrhs == width and p.key() in timings
                 and schedule_mod.plan_artifact_fields(p) == art
                 and timings[p.key()] / width <= best[0] * (1 + LEVEL_TOL)]

        def one_column_s(i):
            twin = dataclasses.replace(pool[i], nrhs=1).key()
            return timings.get(twin, float("inf"))

        best = (best[0], min(level, key=lambda i: (one_column_s(i), i)))
    best_plan = pool[best[1]]
    best_raw = timings[best_plan.key()]

    roofline_entry: Optional[Dict[str, float]] = None
    winner_frac: Optional[float] = None
    est = est_by_key.get(best_plan.key())
    if est is not None and best_raw:
        winner_frac = est.predicted_s / best_raw
        roofline_entry = {
            "predicted_ms": round(est.predicted_s * 1e3, 6),
            "measured_ms": round(best_raw * 1e3, 6),
            "roofline_fraction": winner_frac,
        }
    if cache is not None:
        cache.put(fp, best_plan, timings, predictions_s=predictions,
                  roofline=roofline_entry,
                  denominators=None if den is None else den.to_dict())
        # the winner's schedule next to its plan: serving processes that
        # construct this (matrix, plan) never re-pack or re-color
        cache.put_schedule(best_sched)
        if save and cache.path is not None:
            cache.save()
    return TuneResult(plan=best_plan, fingerprint=fp, timings_s=timings,
                      cached=False, predictions_s=predictions,
                      roofline_fraction=winner_frac)


def plan_for(M: CSRC,
             cache: Optional[PlanCache] = None,
             autotune: bool = False,
             **tune_kw) -> ExecutionPlan:
    """The plan to run this matrix with.

    Cache hit wins; otherwise ``autotune=True`` measures (``tune``, with
    ``tune_kw`` such as ``device=`` or ``nrhs_options=``; it fills the
    cache), ``autotune=False`` falls back to the measurement-free
    heuristic (still cached, so the decision is stable across calls).
    """
    if autotune:
        # tune() performs the cache probe itself — probing here too would
        # double-count misses and fingerprint twice
        return tune(M, cache=cache, **tune_kw).plan
    fp = fingerprint(M)
    if cache is not None:
        hit = cache.get(fp)
        if hit is not None:
            return hit
    plan = heuristic_plan(stats_of(M))
    if cache is not None:
        cache.put(fp, plan)
        if cache.path is not None:
            cache.save()
    return plan


def _mesh_for(p: int, mesh, device):
    """``mesh`` checked against the width ``p``; without one, a one-shard
    mesh on ``device`` where ``placement.mesh_available`` says so, else
    ValueError: the shards of a wider mesh are never spread over the
    devices a count suggests, nor piled on one device unasked."""
    from .distributed import ShardMesh
    if mesh is not None:
        if mesh.p != p:
            raise ValueError(f"mesh has {mesh.p} shards, the plan {p}")
        return mesh
    from repro_torch.serve import placement
    if not placement.mesh_available(p, device):
        raise ValueError(
            f"a {p}-shard mesh needs one device per shard, and a process "
            f"drives one of the {placement.device_count(device)} devices it "
            f"sees; pass mesh=ShardMesh({p}, device) to emulate the shards "
            "on it, or backend='process_group' for one per rank")
    return ShardMesh(p, device)


def tune_mesh(M: CSRC, p: int,
              cache: Optional[PlanCache] = None,
              mesh=None,
              x=None,
              candidates: Optional[List[ExecutionPlan]] = None,
              measure: Optional[Callable] = None,
              warmup: int = 1,
              repeats: int = 3,
              device=None,
              save: bool = True,
              nrhs_options=(1,)) -> TuneResult:
    """The mesh-aware tuning mode: measure the distributed candidates on a
    p-shard :class:`~repro_torch.core.distributed.ShardMesh` and cache the
    per-(matrix, p) winner under ``mesh_fingerprint(fingerprint(M), p)``,
    beside the local decision for the same class.

    ``nrhs_options`` replicates the candidates per RHS block width as in
    :func:`tune` (argmin on per-column time).  Each candidate is built
    without the cache and timed by ``measure(fn, x) -> seconds`` (default
    ``device.time_fn``, CUDA events on the card); the winner's schedule and
    shard layouts are then shipped through ``cache``.  Without ``mesh`` only
    p = 1 runs (``placement.mesh_available``)."""
    from .distributed import build_sharded_spmv

    fp = mesh_fingerprint(fingerprint(M), p)
    if cache is not None:
        hit = cache.get(fp, require_measured=True)
        if hit is not None:
            return TuneResult(plan=hit, fingerprint=fp, timings_s={},
                              cached=True)
    mesh = _mesh_for(p, mesh, device)
    stats = stats_of(M)
    cands = (candidates if candidates is not None
             else enumerate_mesh_plans(stats, p,
                                       nrhs_options=tuple(nrhs_options)))
    if not cands:
        raise ValueError(
            f"no feasible distributed plan for this matrix at p={p}")
    if measure is None:
        def measure(fn, xv):
            return device_mod.time_fn(fn, xv, warmup=warmup,
                                      repeats=repeats)
    x_for = _rhs_pool(M, x, mesh.device)

    timings: Dict[str, float] = {}
    best_plan, best_t = None, float("inf")
    for cand in cands:
        try:
            # measured WITHOUT the cache: only the argmin's artifacts are
            # shipped (below)
            fn = build_sharded_spmv(M, mesh, strategy="auto", cache=None,
                                    plan=cand)
        except ValueError:
            continue              # halo band gate / window over cap
        with obs.span("tune.measure_mesh", plan=cand.key(), p=p):
            t = float(measure(fn, x_for(cand.nrhs)))
        del fn
        obs.counter("tuner_candidates_measured_total").inc()
        timings[cand.key()] = t
        t_norm = t / cand.nrhs
        if t_norm < best_t:
            best_plan, best_t = cand, t_norm
    if best_plan is None:
        raise ValueError(
            f"no distributed candidate survived measurement at p={p}")
    if cache is not None:
        cache.put(fp, best_plan, timings)
        # ship the winner's schedule and shard layouts (the builders serve
        # the memoized build and persist it)
        build_sharded_spmv(M, mesh, strategy="auto", cache=cache,
                           plan=best_plan)
        if save and cache.path is not None:
            cache.save()
    return TuneResult(plan=best_plan, fingerprint=fp, timings_s=timings,
                      cached=False)


def mesh_plan_for(M: CSRC, p: int,
                  cache: Optional[PlanCache] = None,
                  autotune: bool = False,
                  **tune_kw) -> ExecutionPlan:
    """The distributed plan to serve this matrix with on a p-shard mesh:
    :func:`plan_for` for the per-(matrix, p) keys.  A hit wins;
    ``autotune=True`` measures (:func:`tune_mesh` with ``tune_kw``, such as
    ``mesh=``, ``device=`` or ``nrhs_options=``); ``autotune=False`` takes
    the collective-bytes heuristic (cached, so the decision is stable)."""
    if autotune:
        return tune_mesh(M, p, cache=cache, **tune_kw).plan
    fp = mesh_fingerprint(fingerprint(M), p)
    if cache is not None:
        hit = cache.get(fp)
        if hit is not None:
            return hit
    plan = heuristic_mesh_plan(stats_of(M), p)
    if cache is not None:
        cache.put(fp, plan)
        if cache.path is not None:
            cache.save()
    return plan
