"""Pluggable SpMV executors: how a registered matrix actually computes.

The serving engine (serve/engine.py) resolves an
:class:`~repro_torch.core.plan.ExecutionPlan` per matrix and hands
execution to whichever executor the plan's ``strategy`` field names:

* :class:`LocalExecutor` — ``strategy='local'``: the single-device
  :class:`~repro_torch.kernels.ops.SpmvOperator`, schedule-cached through
  the PlanCache (zero pack/partition work on a hit).

* :class:`MeshExecutor` — ``strategy='mesh'``: the paper's accumulation
  strategies across ``plan.mesh_p`` shards of a
  :class:`~repro_torch.core.distributed.ShardMesh` (emulated on one
  device, or one shard per rank of a process group) via
  :func:`~repro_torch.core.distributed.build_sharded_spmv`.  Every
  structural artifact the mesh needs — the schedule (row partition) and
  the per-shard layout (``ShardedSlots`` / ``HaloLayout`` for the
  ``index_add_`` shard compute, the path's ShardSupport layouts for
  ``flat`` and ``nnzsplit``) — comes from the schedule layer and, given a
  cache, from / to the PlanCache npz layer: a process re-registering a
  known matrix performs zero per-shard pack work.

Executors expose the same three-method surface (``__call__``,
``update_values``, ``plan``), so the engine's coalesced multi-RHS step
path is executor-agnostic.  ``update_values`` is the FEM time-stepping
fast path: the local executor refreshes the schedule's value streams
(``BUILD_COUNTS['value_refresh']``), the mesh executor also the shard
layout's (``BUILD_COUNTS['shard_value_refresh']``) — no re-pack, no
re-partition.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.csrc import CSRC
from repro_torch.core.plan import ExecutionPlan


class SpmvExecutor:
    """Executor surface the serving engine programs against."""

    kind: str = "abstract"
    plan: ExecutionPlan
    device: torch.device

    @property
    def path(self) -> str:
        """Compute path of the plan (SpmvOperator API parity)."""
        return self.plan.path

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def update_values(self, M: CSRC) -> "SpmvExecutor":
        raise NotImplementedError


class LocalExecutor(SpmvExecutor):
    """Single-device execution through an SpmvOperator."""

    kind = "local"

    def __init__(self, M: CSRC, plan: ExecutionPlan, cache=None,
                 device=None):
        from repro_torch.kernels.ops import SpmvOperator
        self.M = M
        self.op = SpmvOperator.from_plan(M, plan, device=device, cache=cache)
        self.plan = self.op.plan
        self.device = self.op.device

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)

    def update_values(self, M: CSRC) -> "LocalExecutor":
        self.M = M
        self.op.update_values(M)
        return self

    @property
    def schedule(self):
        return self.op.schedule


class MeshExecutor(SpmvExecutor):
    """Sharded execution across ``plan.mesh_p`` shards.

    Construction materializes (or fetches from the cache's npz layer) the
    schedule and the per-shard layout, binds the layout to the mesh's
    device once and builds the product through
    :func:`~repro_torch.core.distributed.build_sharded_spmv` with the
    layout injected.  ``mesh`` is a
    :class:`~repro_torch.core.distributed.ShardMesh` of ``plan.mesh_p``
    shards; without one, only a one-shard plan runs, on ``device``
    (default the card; ``placement.mesh_available``).
    ``update_values`` refreshes the value streams of the bound layout and
    the schedule; partition, halo geometry and index streams never move.
    """

    kind = "mesh"

    def __init__(self, M: CSRC, plan: ExecutionPlan, mesh=None,
                 cache=None, device=None):
        from repro_torch.core import paths as paths_mod
        from repro_torch.core.tuner import _mesh_for
        if plan.strategy != "mesh":
            raise ValueError(
                f"MeshExecutor needs a strategy='mesh' plan, got "
                f"{plan.key()}")
        self.plan = plan
        self.p = plan.mesh_p
        self.mesh = _mesh_for(self.p, mesh, device)
        self.device = self.mesh.device
        self.cache = cache
        self._sup = paths_mod.get_path(plan.path).shard_support
        self._sched = None
        self.layout = None
        self._structure_digest = None
        self._build(M)

    # the schedule only supplies the row partition here; a shard-supported
    # plan ('flat', 'nnzsplit') builds its per-shard packs instead of the
    # unused full-matrix pack, so the schedule request is path-free
    def _sched_plan(self) -> ExecutionPlan:
        return (dataclasses.replace(self.plan, path="segment")
                if self._sup is not None else self.plan)

    def _build(self, M: CSRC):
        from repro_torch.core import distributed as dist
        from repro_torch.core import schedule as schedule_mod
        self.M = M
        self._structure_digest = schedule_mod.structure_digest(M)
        if self.plan.accumulation == "halo":
            # halo geometry depends only on (matrix, p): no schedule
            self._sched = None
            layout = (schedule_mod.build_path_halo(M, self.p, self.plan,
                                                   cache=self.cache)
                      if self._sup is not None
                      else schedule_mod.build_halo_layout(
                          M, self.p, cache=self.cache))
        else:
            self._sched = schedule_mod.schedule_for(
                M, self._sched_plan(), cache=self.cache, p=self.p)
            part = self._sched.partition
            layout = (schedule_mod.build_path_shards(M, part, self.plan,
                                                     cache=self.cache)
                      if self._sup is not None
                      else schedule_mod.build_sharded_slots(
                          M, part, cache=self.cache))
        self._bind(layout)

    def _bind(self, layout):
        from repro_torch.core import distributed as dist
        self._fn = dist.build_sharded_spmv(
            self.M, self.mesh, strategy=self.plan.accumulation,
            schedule=self._sched, cache=self.cache, plan=self.plan,
            layout=layout)
        # the layout as bound to the mesh's device
        self.layout = self._fn.layout

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        # reduce_scatter pads y to p equal intervals; serve the true rows
        return self._fn.gather(self._fn(x))[:self.M.n]

    def update_values(self, M: CSRC) -> "MeshExecutor":
        """Same-structure value refresh on the mesh: the schedule's value
        streams (through the cache's structure-digest fast path) and the
        bound shard layout's are rewritten; partition, halo geometry and
        index streams are reused untouched.  Raises ValueError when the
        structure differs — a layout can only be value-refilled against
        the slot order it was built for."""
        from repro_torch.core import schedule as schedule_mod
        if schedule_mod.structure_digest(M) != self._structure_digest:
            raise ValueError(
                "MeshExecutor.update_values: matrix structure differs "
                "from the registered one; re-register for a full rebuild")
        part = None
        if self._sched is not None:
            if self.cache is not None:
                self._sched = schedule_mod.schedule_for(
                    M, self._sched_plan(), cache=self.cache, p=self.p)
            else:
                self._sched = schedule_mod.refresh_schedule(self._sched, M)
            part = self._sched.partition
        layout = schedule_mod.refresh_shard_layout(self.layout, M, part=part)
        self.M = M
        self._bind(layout)
        return self

    @property
    def schedule(self):
        return self._sched
