"""Execution plans: every degree of freedom of a CSRC SpMV, in one record.

The paper's central empirical result is that *which* parallelization
strategy wins — local buffers with one of four accumulation methods, or
colorful partitioning — depends on the matrix: working-set size, band
structure, and numeric symmetry decide it per input (§4, Figs. 5–9).
``ExecutionPlan`` reifies that decision so it can be enumerated, measured,
cached, and shipped between processes instead of being hard-coded in
``SpmvOperator``:

  path               single-device compute strategy, one of the names in
                     the KernelPath registry (core/paths.py):
                       'kernel'   rectangular-grid block-ELL CUDA kernels
                                  (banded matrices)
                       'flat'     flat-grid block-ELL CUDA kernels
                                  (skewed row lengths)
                       'nnzsplit' nnz-split CUDA kernels (unstructured
                                  matrices)
                       'colorful' color-by-color writes (paper §3.2)
                       'segment'  segment-sum torch path (any matrix)
                     New kernels add a name by registering a KernelPath —
                     not by editing this module.
  tm                 block-ELL row-tile height (kernel path)
  w_cap              max window width the kernel will accept before the
                     pack is declared infeasible (bandwidth gate)
  k_step_sublanes    slot padding granularity in units of 128 slots (the
                     pack unit shared with the JAX package); the pack's
                     k_step is 128 * k_step_sublanes
  partition          row partitioning for sharding: 'nnz' (paper's
                     nnz-balanced split) or 'count' (naive row count)
  accumulation       distributed accumulation strategy (core/distributed):
                     'allreduce' (all-in-one), 'reduce_scatter'
                     (per-buffer/interval), or 'halo' (effective)
  nrhs               right-hand-side block width the plan was tuned for
                     (1 = classic SpMV; >1 = multi-RHS SpMM, the batched
                     serving / block-Krylov shape).  Execution accepts any
                     width — nrhs records the tuned operating point.
  index_dtype        index-stream dtype of the windowed packs ('kernel'/
                     'flat'): 'int32' (default) or 'int16', which halves
                     the index stream whenever the padded window fits in
                     16 bits (local window offsets are small on banded
                     matrices) — the tuner proposes both and measures.
  value_dtype        value-stream dtype of the windowed packs: 'float32'
                     (default) or 'bfloat16', which halves the value
                     stream.  Enumerated only for numerically-symmetric
                     (well-conditioned suite) classes and accuracy-gated
                     in the tuner before it can win.
  strategy           which executor serves the plan (serve/executor.py):
                     'local' — single-device SpmvOperator; 'mesh' — the
                     distributed strategies of core/distributed.py across
                     ``mesh_p`` shards, with ``accumulation`` naming the
                     collective.  Chosen per (matrix, p) by the tuner's
                     mesh-aware mode.
  mesh_p             mesh width the plan was tuned for (1 for local
                     plans; the shard count of a 'mesh' plan).

Plans are plain data: JSON-serializable, hashable, comparable.  The tuner
(core/tuner.py) enumerates feasible plans from matrix statistics, measures
them, and caches the argmin per matrix fingerprint.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict

# Valid ExecutionPlan.path values.  Seeded with the names every install
# ships; paths.register_path() appends new ones at registration time, so a
# new kernel path never edits this module.
PATHS = ["kernel", "segment", "colorful"]


def register_path_name(name: str) -> None:
    """Called by paths.register_path: makes ``name`` a valid plan path."""
    if name not in PATHS:
        PATHS.append(name)


PARTITIONS = ("nnz", "count")
ACCUMULATIONS = ("allreduce", "reduce_scatter", "halo")
# Index-stream dtypes the windowed packs support (blockell.pack /
# csrc_spmv_flat.pack_flat): 'int16' halves the index stream whenever the
# padded window fits (w_pad + 1 <= 32767) — the paper's §1 index
# compression (Williams et al.) as a tunable plan field.
INDEX_DTYPES = ("int32", "int16")
# Value-stream dtypes the windowed packs support: 'bfloat16' halves the
# value stream (SpMV is bandwidth-bound); the tuner only proposes it for
# numerically-symmetric classes and rejects it when the accuracy check
# fails (core/tuner.py VALUE_DTYPE_TOL).
VALUE_DTYPES = ("float32", "bfloat16")
# Executor strategies (serve/executor.py): 'local' = single-device
# SpmvOperator, 'mesh' = distributed product over mesh_p shards with the
# plan's accumulation as the collective pattern.
STRATEGIES = ("local", "mesh")
# Coloring providers of the colorful path (core/coloring.py): 'greedy' is
# the sequential largest-degree-first coloring, 'race' the recursive
# level-group scheme (arXiv:1907.06487) — fewer, locality-preserving
# classes on banded and mesh-born matrices.  The tuner proposes both and
# measures; the field is inert on every other path.
COLORINGS = ("greedy", "race")
# Kernel body variants of the windowed paths: 'onehot' realizes gather/
# scatter as one-hot mask contractions — O(W) work per slot, bound by
# operations, a fixed summation order; 'stream' gathers by index and
# scatter-adds into the window — O(1) work per slot, the bandwidth-bound
# shape the paper requires.  Both share the same pack artifacts (variant is
# not an artifact field).
VARIANTS = ("onehot", "stream")

LANES = 128                     # pack unit of the shared artifact format:
                                # slots per k_step_sublanes unit and the
                                # window rounding (not a lane count of the card)


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A fully-resolved SpMV execution strategy (no 'auto' anywhere)."""

    path: str = "segment"
    tm: int = 128
    w_cap: int = 4096
    k_step_sublanes: int = 8
    partition: str = "nnz"
    accumulation: str = "allreduce"
    nrhs: int = 1
    index_dtype: str = "int32"
    value_dtype: str = "float32"
    strategy: str = "local"
    mesh_p: int = 1
    variant: str = "onehot"
    # colorful-path coloring provider; plans serialized before this field
    # existed load with the greedy default (from_dict fills missing fields)
    coloring: str = "greedy"

    def __post_init__(self):
        if self.path not in PATHS:
            # a registered-but-not-yet-imported path (e.g. 'flat' before
            # anything touched the registry): loading core.paths runs the
            # built-in registrations, which extend PATHS
            from . import paths as _paths  # noqa: F401
            if self.path not in PATHS:
                raise ValueError(
                    f"path {self.path!r} not in {tuple(PATHS)}")
        if self.partition not in PARTITIONS:
            raise ValueError(
                f"partition {self.partition!r} not in {PARTITIONS}")
        if self.accumulation not in ACCUMULATIONS:
            raise ValueError(
                f"accumulation {self.accumulation!r} not in {ACCUMULATIONS}")
        if self.tm < 1:
            raise ValueError(f"tm must be >= 1, got {self.tm}")
        if self.k_step_sublanes < 1:
            raise ValueError(
                f"k_step_sublanes must be >= 1, got {self.k_step_sublanes}")
        if self.nrhs < 1:
            raise ValueError(f"nrhs must be >= 1, got {self.nrhs}")
        if self.index_dtype not in INDEX_DTYPES:
            raise ValueError(
                f"index_dtype {self.index_dtype!r} not in {INDEX_DTYPES}")
        if self.value_dtype not in VALUE_DTYPES:
            raise ValueError(
                f"value_dtype {self.value_dtype!r} not in {VALUE_DTYPES}")
        if self.strategy not in STRATEGIES:
            raise ValueError(
                f"strategy {self.strategy!r} not in {STRATEGIES}")
        if self.mesh_p < 1:
            raise ValueError(f"mesh_p must be >= 1, got {self.mesh_p}")
        if self.strategy == "local" and self.mesh_p != 1:
            raise ValueError(
                f"local plans run on one device; mesh_p {self.mesh_p} "
                "requires strategy='mesh'")
        if self.variant not in VARIANTS:
            raise ValueError(
                f"variant {self.variant!r} not in {VARIANTS}")
        if self.coloring not in COLORINGS:
            raise ValueError(
                f"coloring {self.coloring!r} not in {COLORINGS}")

    @property
    def k_step(self) -> int:
        return LANES * self.k_step_sublanes

    def key(self) -> str:
        """Stable short identifier (used in cache timing tables and CSV)."""
        rhs = f":r{self.nrhs}" if self.nrhs != 1 else ""
        mesh = f":mesh{self.mesh_p}" if self.strategy == "mesh" else ""
        st = ":st" if self.variant == "stream" else ""
        if self.path in ("kernel", "flat"):
            i16 = ":i16" if self.index_dtype == "int16" else ""
            bf16 = ":bf16" if self.value_dtype == "bfloat16" else ""
            return (f"{self.path}:tm{self.tm}:ks{self.k_step_sublanes}"
                    f"{i16}{bf16}{st}"
                    f":{self.partition}:{self.accumulation}{rhs}{mesh}")
        if self.path == "nnzsplit":
            # no tm: chunking is row-independent; ks sets the chunk size
            i16 = ":i16" if self.index_dtype == "int16" else ""
            bf16 = ":bf16" if self.value_dtype == "bfloat16" else ""
            return (f"{self.path}:ks{self.k_step_sublanes}{i16}{bf16}{st}"
                    f":{self.partition}:{self.accumulation}{rhs}{mesh}")
        # colorful keys carry the non-default provider (':race'); greedy
        # keys are byte-identical to pre-provider caches
        col = (":race" if self.path == "colorful"
               and self.coloring == "race" else "")
        return (f"{self.path}{col}:{self.partition}:{self.accumulation}"
                f"{rhs}{mesh}")

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "ExecutionPlan":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "ExecutionPlan":
        return cls.from_dict(json.loads(s))


def kernel_window(tm: int, bandwidth: int) -> int:
    """The padded window width the block-ELL pack would use (blockell.pack):
    round_up(tm + bandwidth, max(128, tm))."""
    return _round_up(tm + bandwidth, max(LANES, tm))


def feasible(plan: ExecutionPlan, *, n: int, m: int, bandwidth: int) -> bool:
    """Can this plan execute the matrix at all?

    Delegates to the plan path's registry entry (core/paths.py):

    * 'segment' handles everything, including the rectangular tail;
    * 'kernel' / 'flat' need a square matrix whose window fits under w_cap
      (the bandwidth gate — the packer cannot tile anything wider);
    * 'colorful' needs a square matrix (the color loop covers only the
      structurally-symmetric part);
    * 'nnzsplit' needs a square matrix, and n <= 32767 for int16 indices.
    """
    from . import paths as paths_mod
    return paths_mod.get_path(plan.path).feasible(
        plan, n=n, m=m, bandwidth=bandwidth)


DEFAULT_PLAN = ExecutionPlan()
