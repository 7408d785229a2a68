"""Plan resolution: matrix statistics, fingerprints, the heuristic plan and
the plan cache.

This is the paper's per-matrix strategy-selection problem (§4: which
strategy wins depends on the matrix).  This package holds the part of the
tuner the main path needs:

  MatrixStats / stats_of     the statistics that gate candidates
                             (bandwidth, nnz/row deviation, working set,
                             numeric symmetry)
  fingerprint                stable string key of a matrix *class*
                             (n, m, k, bandwidth, nnz-histogram digest)
  heuristic_plan             measurement-free default: ``kernel`` if the
                             window fits, else ``segment``, plus the
                             analytic distributed fields
  PlanCache                  JSON plan cache keyed by fingerprint, with the
                             schedule npz layer and the assembly layer
                             (schedules and tuned strategies) beside it;
                             the file formats are the JAX package's, so
                             caches written by either package load in the
                             other
  plan_for                   the entry point used by solvers and the serve
                             engine

Measured tuning (``tune``, ``enumerate_plans``) and the mesh-aware mode
(``tune_mesh``, ``mesh_plan_for``) are not in this package yet:
``plan_for(autotune=True)`` raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np

from repro_torch import obs
from .csrc import CSRC, bandwidth as csrc_bandwidth, nnz_per_row
from .plan import ExecutionPlan, kernel_window


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
    solvers and the serve engine never re-tune a known class."""
    w = nnz_per_row(M)
    hist = np.bincount(np.minimum(w, 255).astype(np.int64), minlength=256)
    h = hashlib.sha1()
    h.update(hist.astype(np.int64).tobytes())
    h.update(bytes([int(M.numerically_symmetric)]))
    band = csrc_bandwidth(M)
    return f"n{M.n}m{M.m}k{M.k}b{band}-{h.hexdigest()[:12]}"


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
            roofline: Optional[Dict[str, float]] = None):
        """``predictions_s`` (plan key -> analytic seconds) and
        ``roofline`` ({'predicted_ms', 'measured_ms', 'roofline_fraction'}
        of the winner) are the predict-then-measure provenance: the cache
        records what the cost model claimed next to what the clock said —
        and ``env`` records which torch/device/git environment measured it
        (obs.environment_provenance)."""
        entry: Dict = {"plan": plan.to_dict(),
                       "measured": bool(timings_s),
                       "env": dict(obs.environment_provenance())}
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
        re-compress a full npz (values + unchanged index streams) every
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


def plan_for(M: CSRC,
             cache: Optional[PlanCache] = None,
             autotune: bool = False) -> ExecutionPlan:
    """The plan to run this matrix with.

    Cache hit wins; otherwise the measurement-free heuristic decides (and
    is cached, so the decision is stable across calls).  ``autotune=True``
    raises until measured tuning is ported.
    """
    if autotune:
        raise NotImplementedError(
            "measured tuning (tuner.tune) is not in repro_torch yet — it "
            "arrives with the tuner / cost-model part of the port; use "
            "autotune=False or pass an explicit plan")
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
