"""Pluggable SpMV executors: how a registered matrix actually computes.

The serving engine (serve/engine.py) resolves an
:class:`~repro_torch.core.plan.ExecutionPlan` per matrix and hands
execution to whichever executor the plan's ``strategy`` field names:

* :class:`LocalExecutor` — ``strategy='local'``: the single-device
  :class:`~repro_torch.kernels.ops.SpmvOperator`, schedule-cached through
  the PlanCache (zero pack/partition work on a hit).

The JAX package's ``MeshExecutor`` (``strategy='mesh'``) is not in this
package yet; placement refuses such a plan.

Executors expose the same three-method surface (``__call__``,
``update_values``, ``plan``), so the engine's coalesced multi-RHS step
path is executor-agnostic.  ``update_values`` is the FEM time-stepping
fast path: the local executor refreshes the schedule's value streams
(``BUILD_COUNTS['value_refresh']``) — no re-pack, no re-partition.
"""
from __future__ import annotations

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
