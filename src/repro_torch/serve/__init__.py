"""The serving subsystem.

  engine.py     ``SpmvServingEngine`` — the paper's SpMV as a service,
                which coalesces same-matrix requests into one multi-RHS
                SpMM per tick
  executor.py   pluggable execution behind a registered matrix:
                ``LocalExecutor`` (single-device SpmvOperator) and
                ``MeshExecutor`` (the accumulation strategies over the
                shards of a ``ShardMesh``)
  placement.py  plan resolution and executor construction

The token-generation engine of the JAX package is not in this package
yet.
"""
from .engine import SpmvRequest, SpmvResult, SpmvServingEngine
from .executor import LocalExecutor, MeshExecutor, SpmvExecutor

__all__ = [
    "SpmvRequest", "SpmvResult", "SpmvServingEngine", "LocalExecutor",
    "MeshExecutor", "SpmvExecutor",
]
