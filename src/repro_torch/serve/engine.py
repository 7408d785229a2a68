"""The SpMV serving engine.

``SpmvServingEngine`` — the paper's workload as a service: clients submit
(matrix_id, x) products; matrices are registered once and get an
:class:`ExecutionPlan` from the plan cache / heuristic (a cache hit means a
known matrix class is never re-planned), and each tick answers all pending
requests per matrix with one batched multi-RHS product through a pluggable
:class:`~repro_torch.serve.executor.SpmvExecutor`.

Requests and results are host numpy arrays; the engine moves each
coalesced block to the executor's device, runs the product there, and
copies the answer back.  That device-to-host copy is the synchronization
that makes ``execute_s`` the time of the finished product, not of its
enqueue.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import obs


@dataclasses.dataclass
class SpmvRequest:
    uid: int
    matrix_id: str
    x: np.ndarray
    t_submit: float = 0.0         # perf_counter at submit (0 = unknown)


class SpmvResult(np.ndarray):
    """A served y = A·x with the metadata benchmarks need to attribute
    latency to the chosen path: behaves exactly like the float32 result
    array (ndarray subclass), plus

      matrix_id   the registered matrix the request hit
      plan_key    ExecutionPlan.key() of the plan that served it
      path        shard-compute path ('kernel'/'flat'/'segment'/...)
      strategy    'local' or 'mesh'
      mesh_p      shard count (1 for local)
      executor    executor kind that ran it
      batched     how many requests shared the coalesced SpMM
      timings     {'queue_wait_s', 'execute_s'} for this request (None
                  when the engine was constructed before timing landed)
    """

    _META = ("matrix_id", "plan_key", "path", "strategy", "mesh_p",
             "executor", "batched", "timings")

    def __array_finalize__(self, obj):
        for k in self._META:
            setattr(self, k, getattr(obj, k, None))

    def meta(self) -> Dict[str, object]:
        return {k: getattr(self, k, None) for k in self._META}


class SpmvServingEngine:
    """Continuous-batching SpMV service over tuned execution plans.

    ``register`` resolves the matrix's plan through the shared plan cache
    (a hit — e.g. a second matrix of an already-served class — constructs
    the executor without re-planning; ``autotune=True`` raises until
    measured tuning is ported) and backs it with a pluggable executor
    (serve/executor.py): ``strategy='local'`` plans run the single-device
    SpmvOperator on ``device`` (default: the card), with every schedule
    artifact served from the PlanCache npz layer — re-registering a known
    matrix performs zero pack/partition work.  ``mesh_p`` is accepted for
    parity with the JAX package; placement degrades it to local until the
    mesh executor is ported.  ``step`` groups the queue by matrix and
    answers each group with **one batched multi-RHS SpMM** through the
    chosen executor — never a loop of single products; results are
    :class:`SpmvResult` arrays carrying the plan/strategy metadata.
    """

    def __init__(self, cache=None, autotune: bool = False,
                 device=None, max_batch: int = 64,
                 mesh_p: Optional[int] = None,
                 serve_nrhs: Optional[int] = None):
        from repro_torch import device as device_mod
        from repro_torch.core.tuner import PlanCache
        self.cache = cache if cache is not None else PlanCache()
        self.autotune = autotune
        self.device = device_mod.resolve(device)
        self.max_batch = max_batch
        self.mesh_p = mesh_p
        # the batched operating point measured tuning will tune at:
        # coalesced groups run as (n, B) SpMM blocks, so a plan must be
        # measured at a representative B, not at nrhs=1
        self.serve_nrhs = (serve_nrhs if serve_nrhs is not None
                           else min(max_batch, 8))
        self._matrices: Dict[str, object] = {}
        self._ops: Dict[str, object] = {}
        self.queue: List[SpmvRequest] = []
        self._uid = 0

    def register(self, matrix_id: str, M, plan=None):
        """Install a matrix; returns the ExecutionPlan it will run with.

        The plan resolves through placement — or is pinned by the explicit
        ``plan`` argument.  Registering a matrix whose *structure* is
        already known to the cache (FEM time stepping: same connectivity,
        re-assembled values) takes the value-refresh fast path through
        ``schedule_for`` — the plan is a fingerprint hit and the schedule
        only refreshes value streams, zero re-pack/re-partition (the
        ``BUILD_COUNTS`` probe asserts it).
        """
        from . import placement
        if plan is None:
            plan = placement.resolve_plan(
                M, cache=self.cache, autotune=self.autotune,
                mesh_p=self.mesh_p, nrhs=self.serve_nrhs)
        self._matrices[matrix_id] = M
        self._ops[matrix_id] = placement.build_executor(
            M, plan, cache=self.cache, device=self.device)
        return plan

    def update_values(self, matrix_id: str, M):
        """In-place value refresh of a registered matrix (structure must
        be unchanged): the executor swaps the value streams without any
        structural rebuild (``BUILD_COUNTS['value_refresh']``)."""
        if matrix_id not in self._ops:
            raise KeyError(f"matrix {matrix_id!r} not registered")
        self._matrices[matrix_id] = M
        self._ops[matrix_id].update_values(M)
        return self._ops[matrix_id].plan

    def plan(self, matrix_id: str):
        return self._ops[matrix_id].plan

    def executor(self, matrix_id: str):
        return self._ops[matrix_id]

    def submit(self, matrix_id: str, x: np.ndarray) -> int:
        if matrix_id not in self._ops:
            raise KeyError(f"matrix {matrix_id!r} not registered")
        x = np.asarray(x, dtype=np.float32)
        m = self._matrices[matrix_id].m
        if x.shape != (m,):
            # a wrong-length x would gather out of range; reject early
            raise ValueError(
                f"x has shape {x.shape}, matrix {matrix_id!r} needs ({m},)")
        uid = self._uid
        self._uid += 1
        obs.counter("serve_requests_total", matrix_id=matrix_id).inc()
        self.queue.append(SpmvRequest(uid=uid, matrix_id=matrix_id, x=x,
                                      t_submit=time.perf_counter()))
        return uid

    def _wrap(self, y, matrix_id: str, batched: int,
              timings=None) -> SpmvResult:
        """Attach per-request plan/strategy metadata to a result array."""
        ex = self._ops[matrix_id]
        plan = getattr(ex, "plan", None)
        r = np.ascontiguousarray(np.asarray(y)).view(SpmvResult)
        r.matrix_id = matrix_id
        r.plan_key = plan.key() if plan is not None else None
        r.path = getattr(plan, "path", None)
        r.strategy = getattr(plan, "strategy", "local")
        r.mesh_p = getattr(plan, "mesh_p", 1)
        r.executor = getattr(ex, "kind", "local")
        r.batched = batched
        r.timings = timings
        return r

    def step(self) -> Dict[int, SpmvResult]:
        """One tick: answer up to max_batch requests per matrix, each group
        coalesced into a single batched SpMM through the chosen executor
        (every registered path executes blocks natively); a group of one
        runs as an SpMV."""
        t_tick = time.perf_counter()
        by_matrix: Dict[str, List[SpmvRequest]] = {}
        rest: List[SpmvRequest] = []
        for r in self.queue:
            grp = by_matrix.setdefault(r.matrix_id, [])
            if len(grp) < self.max_batch:
                grp.append(r)
            else:
                rest.append(r)
        self.queue = rest
        out: Dict[int, SpmvResult] = {}
        with obs.span("serve.tick", groups=len(by_matrix)):
            for mid, group in by_matrix.items():
                op = self._ops[mid]
                plan = getattr(op, "plan", None)
                t0 = time.perf_counter()
                if len(group) == 1:
                    X = torch.from_numpy(group[0].x)
                else:
                    X = torch.from_numpy(
                        np.stack([r.x for r in group], axis=1))
                # the copy back to the host waits for the product
                Y = op(X.to(self.device)).cpu().numpy()
                dt = time.perf_counter() - t0
                if obs.STATE.enabled:
                    lbl = dict(matrix_id=mid,
                               path=getattr(plan, "path", None),
                               variant=getattr(plan, "variant", None),
                               strategy=getattr(plan, "strategy", "local"),
                               nrhs=len(group))
                    obs.histogram("serve_execute_seconds",
                                  **lbl).observe(dt)
                    obs.histogram("serve_batch_size",
                                  _buckets=obs.log_buckets(1.0, 1024.0, 2),
                                  matrix_id=mid).observe(len(group))
                    for r in group:
                        if r.t_submit:
                            obs.histogram(
                                "serve_queue_wait_seconds", matrix_id=mid,
                            ).observe(max(0.0, t0 - r.t_submit))
                if len(group) == 1:
                    timings = {"queue_wait_s":
                               (max(0.0, t0 - group[0].t_submit)
                                if group[0].t_submit else None),
                               "execute_s": dt}
                    out[group[0].uid] = self._wrap(Y, mid, batched=1,
                                                   timings=timings)
                else:
                    for i, r in enumerate(group):
                        timings = {"queue_wait_s":
                                   (max(0.0, t0 - r.t_submit)
                                    if r.t_submit else None),
                                   "execute_s": dt}
                        out[r.uid] = self._wrap(Y[:, i], mid,
                                                batched=len(group),
                                                timings=timings)
        if obs.STATE.enabled:
            obs.histogram("serve_tick_seconds").observe(
                time.perf_counter() - t_tick)
        return out

    def run_until_drained(self, max_ticks: int = 1000) -> Dict[int, SpmvResult]:
        out: Dict[int, SpmvResult] = {}
        for _ in range(max_ticks):
            if not self.queue:
                break
            out.update(self.step())
        return out
