"""The serving subsystem.

  engine.py     continuous-batching engines: token generation
                (``ServingEngine`` over a ``DenseLM``) and the paper's SpMV
                as a service (``SpmvServingEngine``), which coalesces
                same-matrix requests into one multi-RHS SpMM per tick
  executor.py   pluggable execution behind a registered matrix:
                ``LocalExecutor`` (single-device SpmvOperator) and
                ``MeshExecutor`` (the accumulation strategies over the
                shards of a ``ShardMesh``)
  placement.py  plan resolution and executor construction
"""
from .engine import (Request, ServingEngine, SpmvRequest, SpmvResult,
                     SpmvServingEngine)
from .executor import LocalExecutor, MeshExecutor, SpmvExecutor

__all__ = [
    "Request", "ServingEngine", "SpmvRequest", "SpmvResult",
    "SpmvServingEngine", "LocalExecutor", "MeshExecutor", "SpmvExecutor",
]
