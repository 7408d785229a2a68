"""Placement: which executor (and which plan) serves a registered matrix.

One decision point for the serving engine:

* ``resolve_plan`` — the plan a matrix will run with.  With a requested
  mesh width it consults the per-(matrix, p) mesh entries of the plan
  cache (``tuner.mesh_plan_for``: cache hit > measured ``tune_mesh`` when
  autotuning > collective-bytes heuristic) — when a mesh is supplied
  (``mesh=ShardMesh(...)``, e.g. the p shards emulated on one card) or
  ``mesh_available`` (one shard, on a device that exists); otherwise it
  degrades to the local entries (``tuner.plan_for``), as the JAX package
  does without enough devices.
  Rectangular matrices always resolve locally.  Either way the decision is
  cached, so it is stable across engines and processes.

* ``build_executor`` — the executor for a resolved plan:
  ``strategy='mesh'`` plans get a :class:`~repro_torch.serve.executor.
  MeshExecutor` over ``mesh`` (or, for one shard, a mesh on ``device``),
  everything else a :class:`~repro_torch.serve.executor.LocalExecutor`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import device as device_mod
from repro_torch.core.csrc import CSRC
from repro_torch.core.plan import ExecutionPlan

from .executor import LocalExecutor, MeshExecutor, SpmvExecutor


def device_count(device=None) -> int:
    """Devices a mesh could put one shard on: the CUDA devices for a CUDA
    ``device`` (the default), 1 on the CPU."""
    dev = torch.device(device_mod.DEFAULT_DEVICE if device is None
                       else device)
    if dev.type == "cpu":
        return 1
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def mesh_available(p: Optional[int], device=None) -> bool:
    """Whether ``p`` shards can each have a device of their own without a
    supplied mesh, as the JAX package asks of its device count.  A process
    of the port drives one device (a ``ShardMesh`` holds all its shards on
    it), so only p = 1 qualifies, on a device that exists: a wider mesh is
    opted into with ``mesh=ShardMesh(p, ...)``, and without one the request
    degrades to local, whatever the device count."""
    return p == 1 and device_count(device) >= 1


def resolve_plan(M: CSRC, cache=None, autotune: bool = False,
                 mesh_p: Optional[int] = None,
                 nrhs: int = 1, device=None, mesh=None) -> ExecutionPlan:
    """The plan to serve this matrix with, honouring a mesh request when a
    mesh is supplied or ``mesh_available``, and falling back to local
    otherwise.

    ``nrhs`` > 1 is the engine's batched operating point: autotuning then
    measures every candidate at nrhs=1 *and* at that block width (argmin
    on per-column time) on ``device`` (default the card) or ``mesh``, so
    the cached winner is tuned for the coalesced SpMM the engine actually
    issues — the winning ``plan.nrhs`` records the width it was tuned at."""
    from repro_torch.core import tuner
    tune_kw = {"device": device}
    if autotune and nrhs > 1:
        tune_kw["nrhs_options"] = (1, nrhs)
    if (mesh_p is not None and M.is_square
            and (mesh is not None or mesh_available(mesh_p, device))):
        if not autotune:
            return tuner.mesh_plan_for(M, mesh_p, cache=cache)
        return tuner.mesh_plan_for(M, mesh_p, cache=cache, autotune=True,
                                   mesh=mesh, **tune_kw)
    if not autotune:
        return tuner.plan_for(M, cache=cache)
    return tuner.plan_for(M, cache=cache, autotune=True, **tune_kw)


def build_executor(M: CSRC, plan: ExecutionPlan, cache=None,
                   device=None, mesh=None) -> SpmvExecutor:
    """Executor for a resolved plan (strategy field dispatch)."""
    if plan.strategy == "mesh":
        return MeshExecutor(M, plan, mesh=mesh, cache=cache, device=device)
    return LocalExecutor(M, plan, cache=cache, device=device)
