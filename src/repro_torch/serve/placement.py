"""Placement: which executor (and which plan) serves a registered matrix.

One decision point for the serving engine:

* ``resolve_plan`` — the plan a matrix will run with (``tuner.plan_for``:
  cache hit > measured ``tune`` when autotuning > heuristic); the decision
  is cached, so it is stable across engines and processes.  A mesh width
  may be requested, as in the JAX package, but this package has no mesh
  executor yet, so the request degrades to the local entries exactly as it
  does there when the process cannot see enough devices.

* ``build_executor`` — the executor for a resolved plan: a
  :class:`~repro_torch.serve.executor.LocalExecutor`; a ``strategy='mesh'``
  plan raises ``NotImplementedError`` until the mesh layer is ported.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.csrc import CSRC
from repro_torch.core.plan import ExecutionPlan

from .executor import LocalExecutor, SpmvExecutor


def resolve_plan(M: CSRC, cache=None, autotune: bool = False,
                 mesh_p: Optional[int] = None,
                 nrhs: int = 1, device=None) -> ExecutionPlan:
    """The plan to serve this matrix with.  ``mesh_p`` is accepted for
    parity with the JAX package and degrades to local.

    ``nrhs`` > 1 is the engine's batched operating point: autotuning then
    measures every candidate at nrhs=1 *and* at that block width (argmin
    on per-column time) on ``device`` (default the card), so the cached
    winner is tuned for the coalesced SpMM the engine actually issues —
    the winning ``plan.nrhs`` records the width it was tuned at."""
    from repro_torch.core import tuner
    if not autotune:
        return tuner.plan_for(M, cache=cache)
    tune_kw = {"device": device}
    if nrhs > 1:
        tune_kw["nrhs_options"] = (1, nrhs)
    return tuner.plan_for(M, cache=cache, autotune=True, **tune_kw)


def build_executor(M: CSRC, plan: ExecutionPlan, cache=None,
                   device=None) -> SpmvExecutor:
    """Executor for a resolved plan (strategy field dispatch)."""
    if plan.strategy == "mesh":
        raise NotImplementedError(
            "strategy='mesh' plans need the mesh executor, which arrives "
            "with the mesh layer of the port")
    return LocalExecutor(M, plan, cache=cache, device=device)
