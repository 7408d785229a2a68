"""The KernelPath registry: one registration per execution path.

One record per path collects everything the plan / schedule / tuner /
operator stack needs to know about it:

  name              the ``ExecutionPlan.path`` value
  feasible          can this path execute a matrix with these shape stats
                    at all
  candidates        tuner candidate enumerator: the plans worth measuring
                    for a matrix with the given statistics
  artifact_fields   the plan fields the schedule artifact depends on
                    (plans differing only elsewhere share one artifact)
  build_artifact    packer -> SpmvSchedule field dict
  save_artifact     npz serialization of those fields (meta, arrays)
  load_artifact     the inverse; versioned via schedule.SCHEDULE_VERSION
  make_spmv         executor factory, x of shape (m,)
  make_spmm         executor factory, X of shape (m, r)
  refresh_values    same-structure value-stream refresh (FEM time
                    stepping; schedule.refresh_schedule) — optional
  shard_support     how the path runs shard-locally inside the mesh
                    strategies (:class:`ShardSupport`) — optional

``register_path`` wires the name into ``plan.PATHS`` (so ``ExecutionPlan``
validation accepts it) and makes the path visible to the operator, the
schedule layer and the tuner.  Registered here, in the JAX package's
order: ``segment``, ``kernel``, ``colorful``, ``flat`` and ``nnzsplit``;
``flat`` and ``nnzsplit`` register shard support (``FLAT_SHARD_SUPPORT``,
``NNZSPLIT_SHARD_SUPPORT``), the others run shard-locally as
``index_add_`` (core/distributed.py).

The executor factories receive the matrix and the schedule **already on
the executor's device** (``SpmvOperator._bind`` moves them once) and
return callables on tensors of that device.  Executors live in
``repro_torch.kernels`` — imported lazily inside the factory functions so
the core package keeps its import order (kernels imports core, never the
reverse at module load).
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .plan import ExecutionPlan, kernel_window, register_path_name


# Build probe: how many times each expensive structure precomputation ran.
# Tests (and ops dashboards) diff these counters around a cache-hit path to
# assert that no re-pack / re-partition happened.  (Re-exported as
# ``schedule.BUILD_COUNTS`` — same object.)  A thin dict-like view over the
# ``build_total{kind=...}`` counter family in ``repro_torch.obs.REGISTRY``.
class BuildCounts:
    """Counter-compatible view over the ``build_total`` metric family."""

    FAMILY = "build_total"
    _HELP = ("expensive structure precomputations (pack / partition / "
             "coloring / shard layouts) that actually ran")

    def _family(self):
        from repro_torch import obs
        return obs.REGISTRY.family(self.FAMILY, "counter", ("kind",),
                                   help=self._HELP)

    def inc(self, kind: str, v: int = 1):
        """Record ``v`` builds of this kind.  Counts even when metrics
        are disabled: the probe is a correctness assertion, not
        telemetry."""
        self._family().labels(kind=kind).inc_always(v)

    def __getitem__(self, kind: str) -> int:
        child = self._family().children.get((str(kind),))
        return 0 if child is None else int(child.value)

    def __setitem__(self, kind: str, v):
        import warnings
        warnings.warn(
            "direct BUILD_COUNTS mutation is deprecated; use "
            "BUILD_COUNTS.inc(kind) or obs.counter('build_total', ...)",
            DeprecationWarning, stacklevel=2)
        self._family().labels(kind=kind).set_always(v)

    def get(self, kind: str, default: int = 0) -> int:
        v = self[kind]
        return v if (str(kind),) in self._family().children else default

    def keys(self):
        return [k for (k,) in self._family().children]

    def values(self):
        return [int(c.value) for c in self._family().children.values()]

    def items(self):
        return [(k, int(c.value))
                for (k,), c in self._family().children.items()]

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._family().children)

    def __contains__(self, kind) -> bool:
        return (str(kind),) in self._family().children

    def __repr__(self) -> str:
        return f"BuildCounts({dict(self.items())!r})"


BUILD_COUNTS = BuildCounts()


@dataclasses.dataclass(frozen=True)
class CandidateSpace:
    """The degrees of freedom the tuner's enumeration sweeps, plus the
    analytically-chosen distributed fields every candidate inherits."""
    tms: Tuple[int, ...] = (32, 128)
    k_steps_sublanes: Tuple[int, ...] = (8,)
    w_cap: int = 4096
    colorful_max_n: int = 2048
    partition: str = "nnz"
    accumulation: str = "allreduce"
    # index-stream dtypes the windowed enumerators propose; 'int16' is
    # emitted only where the pack supports it (window fits in 16 bits)
    index_dtypes: Tuple[str, ...] = ("int32", "int16")
    # value-stream dtypes the windowed enumerators propose; 'bfloat16' is
    # emitted only for numerically-symmetric matrices and must additionally
    # pass the tuner's accuracy check before it can win
    value_dtypes: Tuple[str, ...] = ("float32", "bfloat16")
    nnzsplit_ks: Tuple[int, ...] = (2, 8)
    # kernel body variants the windowed enumerators propose; both share one
    # pack artifact, so proposing both costs no extra schedule builds
    variants: Tuple[str, ...] = ("stream", "onehot")
    colorings: Tuple[str, ...] = ("greedy", "race")


@dataclasses.dataclass(frozen=True)
class ShardSupport:
    """How a path executes *shard-locally* inside the mesh strategies
    (core/distributed.py) and the serving ``MeshExecutor``.

    A path without one (``KernelPath.shard_support is None``) still runs on
    a mesh — the strategies take the ``index_add_`` shard-local product —
    but a path that registers one is served by all three accumulation
    strategies over its own per-shard packs, with the schedule layer
    memoizing and shipping the layouts and ``refresh_shard_layout``
    refreshing their value streams.

      name      the path's name: the npz kinds and BUILD_COUNTS keys of its
                layouts are ``<name>_shards`` (allreduce / reduce_scatter)
                and ``<name>_halo``, and its kernel module holds
                ``pack_<name>_shards`` / ``pack_<name>_halo``,
                ``refresh_<name>_shards`` / ``refresh_<name>_halo``,
                ``<name>_local_fn`` and ``<name>_halo_dims``
      module    that kernel module, imported at first use
      classes   the names of its (shards, halo) layout dataclasses
      geometry  plan -> the plan-derived geometry tuple layouts are keyed
                by (memoization and npz cache keys)
      pack_kw   plan -> the packers' keyword arguments

    The JAX package's ``shard_arrays`` / ``shard_specs`` (shard_map
    plumbing) have no counterpart: a layout's ``shard_pack(t)`` is shard
    t's pack, views of the stacked streams.  ``local_fn`` takes the plan's
    variant, which the JAX package drops (ROADMAP C2).
    """
    name: str
    module: str
    classes: Tuple[str, str]
    geometry: Callable[[ExecutionPlan], tuple]
    pack_kw: Callable[[ExecutionPlan], dict]

    @property
    def shards_kind(self) -> str:
        return f"{self.name}_shards"

    @property
    def halo_kind(self) -> str:
        return f"{self.name}_halo"

    def _get(self, attr: str):
        return getattr(importlib.import_module(self.module), attr)

    def layout_classes(self) -> dict:
        """{kind: layout dataclass}."""
        return {self.shards_kind: self._get(self.classes[0]),
                self.halo_kind: self._get(self.classes[1])}

    def pack_shards(self, M, starts, plan):
        """The row-partition layout of M over the partition ``starts``."""
        return self._get(f"pack_{self.name}_shards")(M, starts,
                                                     **self.pack_kw(plan))

    def pack_halo(self, M, p: int, plan):
        """The halo layout of M over p shards (ValueError: band gate)."""
        return self._get(f"pack_{self.name}_halo")(M, p,
                                                   **self.pack_kw(plan))

    def refresh_shards(self, lay, M, starts):
        return self._get(f"refresh_{self.name}_shards")(lay, M, starts)

    def refresh_halo(self, lay, M):
        return self._get(f"refresh_{self.name}_halo")(lay, M)

    def local_fn(self, lay, n_local: int, variant: str) -> Callable:
        """fn(t, x) -> shard t's product, n_local rows; the shard packs
        are built once, when this is called."""
        return self._get(f"{self.name}_local_fn")(lay, n_local, variant)

    def halo_dims(self, lay) -> tuple:
        """(ns, h, n_local) of a halo layout."""
        return self._get(f"{self.name}_halo_dims")(lay)


@dataclasses.dataclass(frozen=True)
class KernelPath:
    """Everything the plan/schedule/tuner/operator stack needs to know
    about one execution path."""
    name: str
    feasible: Callable[..., bool]
    candidates: Callable[..., list]
    artifact_fields: Callable[[ExecutionPlan], tuple]
    build_artifact: Callable[..., dict]
    save_artifact: Callable[..., Tuple[dict, dict]]
    load_artifact: Callable[..., dict]
    make_spmv: Callable[..., Callable]
    make_spmm: Callable[..., Callable]
    # Same-structure value refresh (M, schedule) -> updated artifact field
    # dict (schedule.refresh_schedule).  None means the path's artifact is
    # purely structural (or absent) and is reused as-is — the executors
    # read values from the matrix directly ('segment').
    refresh_values: Optional[Callable[..., dict]] = None
    # Shard-local execution for the mesh strategies and the serving
    # MeshExecutor.  None means the path runs shard-locally as index_add_
    # (core/distributed.py's default).
    shard_support: Optional[ShardSupport] = None


_REGISTRY: Dict[str, KernelPath] = {}


def register_path(entry: KernelPath) -> KernelPath:
    """Register a path.  The name becomes a valid ``ExecutionPlan.path``,
    the candidates join every tuner enumeration, the artifact build function is
    called by ``schedule.build_schedule``, and the executors by
    ``SpmvOperator``."""
    _REGISTRY[entry.name] = entry
    register_path_name(entry.name)
    return entry


def get_path(name: str) -> KernelPath:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no kernel path {name!r} registered "
                       f"(known: {sorted(_REGISTRY)})") from None


def registered_paths() -> Tuple[KernelPath, ...]:
    return tuple(_REGISTRY.values())


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _always_feasible(plan, *, n, m, bandwidth) -> bool:
    return True


def _square_feasible(plan, *, n, m, bandwidth) -> bool:
    return n == m


def _windowed_feasible(plan, *, n, m, bandwidth) -> bool:
    """Square matrix whose padded window fits under the plan's cap — the
    bandwidth gate of the windowed kernels.  An int16 index stream
    additionally needs the window (and its padding sentinel, index == W)
    to fit in 16 bits."""
    if n != m:
        return False
    w = kernel_window(plan.tm, bandwidth)
    if w > plan.w_cap:
        return False
    return plan.index_dtype != "int16" or w + 1 <= 32767


def _no_artifact(M, plan, coloring=None) -> dict:
    return {}


def _save_nothing(sched):
    return {}, {}


def _load_nothing(meta, z) -> dict:
    return {}


def _empty_fields(plan) -> tuple:
    return ()


def _windowed_fields(plan) -> tuple:
    return (plan.tm, plan.w_cap, plan.k_step_sublanes, plan.index_dtype,
            plan.value_dtype)


def _windowed_candidates(path, stats, space):
    out = []
    if stats.n != stats.m:
        return out
    for tm in space.tms:
        w = kernel_window(tm, stats.bandwidth)
        if w > space.w_cap:
            continue
        for ks in space.k_steps_sublanes:
            for idt in space.index_dtypes:
                if idt == "int16" and w + 1 > 32767:
                    continue        # window overflows 16-bit offsets
                for vdt in space.value_dtypes:
                    if (vdt == "bfloat16"
                            and not stats.numerically_symmetric):
                        # bf16 value streams are proposed only for the
                        # numerically-symmetric (well-conditioned) classes
                        continue
                    for var in space.variants:
                        out.append(ExecutionPlan(
                            path=path, tm=tm, w_cap=space.w_cap,
                            k_step_sublanes=ks, index_dtype=idt,
                            value_dtype=vdt, variant=var,
                            partition=space.partition,
                            accumulation=space.accumulation))
    return out


# ---------------------------------------------------------------------------
# 'segment' — any matrix, incl. the rectangular tail: K15 on the card
# (kernels/csrc_segment.py), the gather + index_add_ chain (kernels/ref.py)
# on the CPU
# ---------------------------------------------------------------------------

def _segment_candidates(stats, space):
    return [ExecutionPlan(path="segment", w_cap=space.w_cap,
                          partition=space.partition,
                          accumulation=space.accumulation)]


def _segment_make(M, plain):
    """K15 for a matrix on the card (it launches or raises: a matrix it
    cannot read is refused when the operator binds), the reference chain
    for one on the CPU."""
    from repro_torch.kernels import csrc_segment, ref
    if M.device.type == "cuda":
        return csrc_segment.SegmentKernel(M)
    return functools.partial(plain, M, row_idx=ref.row_index(M))


def _segment_make_spmv(M, schedule, plan, *, coloring=None):
    from repro_torch import obs
    from repro_torch.kernels import ref
    fn = _segment_make(M, ref.csrc_spmv)
    # SpmvOperator._bind builds this executor and its SpMM twin together:
    # the route is counted here, once per bound operator
    obs.counter("segment_route_total",
                "segment operators bound, by route: K15 on the card "
                "(kernel) or the plain chain on the CPU (plain)",
                route="kernel" if M.device.type == "cuda" else "plain"
                ).inc_always()
    return fn


def _segment_make_spmm(M, schedule, plan, *, coloring=None):
    from repro_torch.kernels import ref
    return _segment_make(M, ref.csrc_spmm)


register_path(KernelPath(
    name="segment",
    feasible=_always_feasible,
    candidates=_segment_candidates,
    artifact_fields=_empty_fields,
    build_artifact=_no_artifact,
    save_artifact=_save_nothing,
    load_artifact=_load_nothing,
    make_spmv=_segment_make_spmv,
    make_spmm=_segment_make_spmm,
))


# ---------------------------------------------------------------------------
# 'kernel' — rectangular-grid block-ELL CUDA kernels (banded matrices)
# ---------------------------------------------------------------------------

def _index_dtype_of(plan):
    return torch.int16 if plan.index_dtype == "int16" else torch.int32


def _value_dtype_of(plan):
    return (torch.bfloat16 if plan.value_dtype == "bfloat16"
            else torch.float32)


def _kernel_build(M, plan, coloring=None) -> dict:
    from . import blockell
    if not M.is_square:
        raise ValueError(
            "kernel path packs the square CSRC part only; "
            "use 'segment' for rectangular matrices")
    BUILD_COUNTS.inc("pack")
    return {"pack": blockell.pack(M, tm=plan.tm, k_step=plan.k_step,
                                  w_cap=plan.w_cap,
                                  dtype=_value_dtype_of(plan),
                                  index_dtype=_index_dtype_of(plan))}


def _host_f32(a) -> np.ndarray:
    return a.detach().to(device="cpu", dtype=torch.float32).numpy()


def _kernel_save(sched):
    pk = sched.pack
    # value streams are persisted as float32 (bf16 -> f32 widening is
    # lossless; numpy npz has no native bfloat16) and re-narrowed on load
    # to the dtype recorded in the meta
    meta = {"pack": {"n": pk.n, "tm": pk.tm, "nt": pk.nt,
                     "w_pad": pk.w_pad, "s": pk.s,
                     "num_symmetric": bool(pk.num_symmetric),
                     "value_dtype": str(pk.vals_l.dtype).replace("torch.", ""),
                     "pad_ratio": pk.pad_ratio}}
    arrays = dict(
        pack_vals_l=_host_f32(pk.vals_l),
        pack_vals_u=_host_f32(pk.vals_u),
        pack_col_local=pk.col_local.detach().cpu().numpy(),
        pack_row_in_win=pk.row_in_win.detach().cpu().numpy(),
        pack_ad=_host_f32(pk.ad),
    )
    return meta, arrays


def _kernel_load(meta, z) -> dict:
    from . import blockell
    pm = meta["pack"]
    vdt = {"float32": torch.float32,
           "bfloat16": torch.bfloat16}[pm.get("value_dtype", "float32")]

    def values(name):
        return torch.from_numpy(
            np.ascontiguousarray(z[name], dtype=np.float32)).to(vdt)

    num_symmetric = bool(pm["num_symmetric"])
    vals_l = values("pack_vals_l")
    col_local = torch.from_numpy(np.ascontiguousarray(z["pack_col_local"]))
    row_in_win = torch.from_numpy(np.ascontiguousarray(z["pack_row_in_win"]))
    blockell.check_slot_order(row_in_win, col_local, pm["w_pad"])
    return {"pack": blockell.BlockEll(
        n=pm["n"], tm=pm["tm"], nt=pm["nt"], w_pad=pm["w_pad"], s=pm["s"],
        vals_l=vals_l,
        vals_u=vals_l if num_symmetric else values("pack_vals_u"),
        col_local=col_local, row_in_win=row_in_win,
        ad=values("pack_ad"),
        num_symmetric=num_symmetric,
        pad_ratio=float(pm["pad_ratio"]),
    )}


def _kernel_refresh(M, sched) -> dict:
    from . import blockell
    return {"pack": blockell.refresh_values(sched.pack, M)}


def _kernel_make_spmv(M, schedule, plan, *, coloring=None):
    if plan.variant == "stream":
        from repro_torch.kernels import csrc_spmv_stream as stream_mod
        return functools.partial(stream_mod.blockell_spmv_stream,
                                 schedule.pack,
                                 k_step_sublanes=plan.k_step_sublanes)
    from repro_torch.kernels import csrc_spmv as kernel_mod
    return functools.partial(kernel_mod.blockell_spmv, schedule.pack,
                             k_step_sublanes=plan.k_step_sublanes)


def _kernel_make_spmm(M, schedule, plan, *, coloring=None):
    if plan.variant == "stream":
        from repro_torch.kernels import csrc_spmv_stream as stream_mod
        return functools.partial(stream_mod.blockell_spmm_stream,
                                 schedule.pack,
                                 k_step_sublanes=plan.k_step_sublanes)
    from repro_torch.kernels import csrc_spmm as kernel_mm_mod
    return functools.partial(kernel_mm_mod.blockell_spmm, schedule.pack,
                             k_step_sublanes=plan.k_step_sublanes)


register_path(KernelPath(
    name="kernel",
    feasible=_windowed_feasible,
    candidates=functools.partial(_windowed_candidates, "kernel"),
    artifact_fields=_windowed_fields,
    build_artifact=_kernel_build,
    save_artifact=_kernel_save,
    load_artifact=_kernel_load,
    make_spmv=_kernel_make_spmv,
    make_spmm=_kernel_make_spmm,
    refresh_values=_kernel_refresh,
))


# ---------------------------------------------------------------------------
# 'colorful' — the paper's §3.2 color-by-color writes (torch ops: the JAX
# package has no Pallas body for this path)
# ---------------------------------------------------------------------------

def _colorful_candidates(stats, space):
    if (stats.n != stats.m or stats.n > space.colorful_max_n
            or stats.k == 0):
        return []
    return [ExecutionPlan(path="colorful", w_cap=space.w_cap,
                          partition=space.partition,
                          accumulation=space.accumulation,
                          coloring=provider)
            for provider in space.colorings]


def _colorful_fields(plan) -> tuple:
    # greedy and race colorings are different artifacts: the provider joins
    # the schedule cache key so the two never collide
    return (plan.coloring,)


def _colorful_build(M, plan, coloring=None) -> dict:
    from .coloring import color_rows
    from . import schedule as schedule_mod
    if not M.is_square:
        raise ValueError(
            "colorful path covers the square CSRC part only; "
            "use 'segment' for rectangular matrices")
    if coloring is None:
        BUILD_COUNTS.inc("coloring")
        col = color_rows(M, provider=plan.coloring)
    else:
        col = coloring
    slots, ptr = schedule_mod.color_slot_batches(M, col)
    return {"coloring": col, "color_slots": slots, "color_slot_ptr": ptr}


def _colorful_save(sched):
    col = sched.coloring
    meta = {"num_colors": int(col.num_colors),
            "coloring_provider": col.provider}
    arrays = dict(
        color_of_row=np.asarray(col.color_of_row),
        rows_by_color=np.asarray(col.rows_by_color),
        color_ptr=np.asarray(col.color_ptr),
        color_slots=np.asarray(sched.color_slots),
        color_slot_ptr=np.asarray(sched.color_slot_ptr),
    )
    # RACE level-group metadata rides along so a loaded schedule keeps the
    # chunk-aware conflict invariant verifiable without re-coloring
    if col.level_of_row is not None:
        arrays["color_level_of_row"] = np.asarray(col.level_of_row)
    if col.group_of_row is not None:
        arrays["color_group_of_row"] = np.asarray(col.group_of_row)
    return meta, arrays


def _colorful_load(meta, z) -> dict:
    from repro_torch.convert import coloring_from_arrays
    files = getattr(z, "files", z)
    return {
        "coloring": coloring_from_arrays(
            color_of_row=z["color_of_row"],
            num_colors=int(meta["num_colors"]),
            rows_by_color=z["rows_by_color"],
            color_ptr=z["color_ptr"],
            provider=meta.get("coloring_provider", "greedy"),
            level_of_row=(z["color_level_of_row"]
                          if "color_level_of_row" in files else None),
            group_of_row=(z["color_group_of_row"]
                          if "color_group_of_row" in files else None)),
        "color_slots": z["color_slots"],
        "color_slot_ptr": z["color_slot_ptr"],
    }


def _colorful_make(M, schedule, plan, *, coloring=None):
    """The color loop bound to ``M``'s device: the slot batches and the row
    of each slot go up once, here, never per call."""
    from . import schedule as schedule_mod
    from .csrc import row_of_slot
    slots, ptr = schedule.color_slots, schedule.color_slot_ptr
    if coloring is not None and coloring is not schedule.coloring:
        slots, ptr = schedule_mod.color_slot_batches(M, coloring)
    dev = M.ad.device
    return functools.partial(
        schedule_mod.colorful_apply, M,
        color_slots=torch.from_numpy(
            np.asarray(slots, dtype=np.int64)).to(dev),
        color_slot_ptr=np.asarray(ptr, dtype=np.int64),
        row_idx=torch.from_numpy(row_of_slot(M).astype(np.int64)).to(dev))


register_path(KernelPath(
    name="colorful",
    feasible=_square_feasible,
    candidates=_colorful_candidates,
    artifact_fields=_colorful_fields,
    build_artifact=_colorful_build,
    save_artifact=_colorful_save,
    load_artifact=_colorful_load,
    make_spmv=_colorful_make,
    make_spmm=_colorful_make,       # colorful_apply handles (m,) and (m, r)
))


# ---------------------------------------------------------------------------
# 'flat' — flat-grid block-ELL CUDA kernels (skewed row-length matrices)
# ---------------------------------------------------------------------------

# Candidate gate: coefficient of variation of nnz-per-row above which the
# rectangular grid's per-tile padding is expected to waste bandwidth and
# the flat grid becomes worth measuring.  (Feasibility — can the matrix be
# tiled at all — is _windowed_feasible, identical to the rectangular
# kernel; the skew statistic only gates *enumeration*.)
FLAT_SKEW_MIN = 0.25


def flat_worth_measuring(stats) -> bool:
    """The flat enumerator's skew gate: is the nnz-per-row spread large
    enough that per-tile-exact packing could beat the rectangular grid?"""
    return stats.nnz_row_dev > FLAT_SKEW_MIN * max(stats.nnz_row_mean, 1.0)


def _flat_candidates(stats, space):
    if not flat_worth_measuring(stats):
        return []
    return _windowed_candidates("flat", stats, space)


def _flat_build(M, plan, coloring=None) -> dict:
    from repro_torch.kernels import csrc_spmv_flat as flat_mod
    if not M.is_square:
        raise ValueError(
            "flat path packs the square CSRC part only; "
            "use 'segment' for rectangular matrices")
    BUILD_COUNTS.inc("flat_pack")
    return {"flat_pack": flat_mod.pack_flat(
        M, tm=plan.tm, ks=plan.k_step_sublanes, w_cap=plan.w_cap,
        dtype=_value_dtype_of(plan),
        index_dtype=_index_dtype_of(plan))}


def _flat_save(sched):
    pk = sched.flat_pack
    shape = (pk.total_steps, pk.ks, 128)

    # the JAX package's layout: (total, ks, 128) streams, float32 values
    # (re-narrowed on load to the recorded value dtype); step_start is
    # derived again on load, never stored
    meta = {"flat_pack": {"n": pk.n, "tm": pk.tm, "nt": pk.nt,
                          "w_pad": pk.w_pad,
                          "total_steps": pk.total_steps, "ks": pk.ks,
                          "num_symmetric": bool(pk.num_symmetric),
                          "value_dtype": str(pk.vals_l.dtype).replace(
                              "torch.", ""),
                          "pad_ratio": pk.pad_ratio}}
    arrays = dict(
        flat_vals_l=_host_f32(pk.vals_l).reshape(shape),
        flat_vals_u=_host_f32(pk.vals_u).reshape(shape),
        flat_col_local=pk.col_local.detach().cpu().numpy().reshape(shape),
        flat_row_in_win=pk.row_in_win.detach().cpu().numpy().reshape(shape),
        flat_ad=_host_f32(pk.ad),
        flat_tile_of_step=pk.tile_of_step.detach().cpu().numpy(),
        flat_first_of_tile=pk.first_of_tile.detach().cpu().numpy(),
    )
    return meta, arrays


def _flat_load(meta, z) -> dict:
    from repro_torch.convert import flat_from_arrays
    pm = meta["flat_pack"]
    return {"flat_pack": flat_from_arrays(
        n=pm["n"], tm=pm["tm"], nt=pm["nt"], w_pad=pm["w_pad"],
        total_steps=pm["total_steps"], ks=pm["ks"],
        num_symmetric=bool(pm["num_symmetric"]),
        pad_ratio=float(pm["pad_ratio"]),
        value_dtype=pm.get("value_dtype", "float32"),
        **{f: z["flat_" + f] for f in (
            "vals_l", "vals_u", "col_local", "row_in_win", "ad",
            "tile_of_step", "first_of_tile")})}


def _flat_refresh(M, sched) -> dict:
    from repro_torch.kernels import csrc_spmv_flat as flat_mod
    return {"flat_pack": flat_mod.refresh_flat_values(sched.flat_pack, M)}


def _flat_make_spmv(M, schedule, plan, *, coloring=None):
    if plan.variant == "stream":
        from repro_torch.kernels import csrc_spmv_stream as stream_mod
        return functools.partial(stream_mod.flat_spmv_stream,
                                 schedule.flat_pack)
    from repro_torch.kernels import csrc_spmv_flat as flat_mod
    return functools.partial(flat_mod.flat_spmv, schedule.flat_pack)


def _flat_make_spmm(M, schedule, plan, *, coloring=None):
    if plan.variant == "stream":
        from repro_torch.kernels import csrc_spmv_stream as stream_mod
        return functools.partial(stream_mod.flat_spmm_stream,
                                 schedule.flat_pack)
    from repro_torch.kernels import csrc_spmv_flat as flat_mod
    return functools.partial(flat_mod.flat_spmm, schedule.flat_pack)


FLAT_SHARD_SUPPORT = ShardSupport(
    name="flat",
    module="repro_torch.kernels.csrc_spmv_flat",
    classes=("FlatShards", "FlatHalo"),
    geometry=lambda plan: (plan.tm, plan.k_step_sublanes, plan.w_cap,
                           plan.index_dtype, plan.value_dtype),
    pack_kw=lambda plan: dict(
        tm=plan.tm, ks=plan.k_step_sublanes, w_cap=plan.w_cap,
        dtype=_value_dtype_of(plan), index_dtype=_index_dtype_of(plan)),
)


register_path(KernelPath(
    name="flat",
    feasible=_windowed_feasible,
    candidates=_flat_candidates,
    artifact_fields=_windowed_fields,
    build_artifact=_flat_build,
    save_artifact=_flat_save,
    load_artifact=_flat_load,
    make_spmv=_flat_make_spmv,
    make_spmm=_flat_make_spmm,
    refresh_values=_flat_refresh,
    shard_support=FLAT_SHARD_SUPPORT,
))


# ---------------------------------------------------------------------------
# 'nnzsplit' — equal-nnz chunks of the combined stream (unstructured
# matrices), CUDA kernels K9-K12
# ---------------------------------------------------------------------------

# Candidate gates (the chunking is feasible on any square matrix; these only
# gate *enumeration*):
#  * skew: nnz-per-row CoV above this means even the flat grid's per-tile
#    packing pays for hub rows (power-law degree tails).  Deliberately above
#    FLAT_SKEW_MIN: in the moderate-skew band the flat path already wins.
#  * spread: ``ja`` bandwidth above this fraction of n means the windowed
#    packs pad a window comparable to the whole matrix (random graphs,
#    circuits) — there is no band to exploit.
NNZSPLIT_SKEW_MIN = 2.0
NNZSPLIT_SPREAD_MIN = 0.25


def nnzsplit_worth_measuring(stats) -> bool:
    """The nnzsplit enumerator's gate: is the matrix unstructured enough
    (heavy row-length tail OR non-banded column spread) that nnz-balanced
    chunking could beat the windowed paths?"""
    if stats.n != stats.m:
        return False
    cov = stats.nnz_row_dev / max(stats.nnz_row_mean, 1.0)
    return (cov > NNZSPLIT_SKEW_MIN
            or stats.bandwidth > NNZSPLIT_SPREAD_MIN * max(stats.n, 1))


def _nnzsplit_feasible(plan, *, n, m, bandwidth) -> bool:
    """Square matrices only; int16 gather indices additionally need every
    global index (src into x) to fit.  The per-chunk row window is checked
    at pack time against plan.w_cap (reused as the chunk-window cap) — it
    depends on row-gap statistics, not on the bandwidth stat."""
    if n != m:
        return False
    return plan.index_dtype != "int16" or n <= 32767


def _nnzsplit_candidates(stats, space):
    if not nnzsplit_worth_measuring(stats):
        return []
    out = []
    for ks in space.nnzsplit_ks:
        for idt in space.index_dtypes:
            if idt == "int16" and stats.n > 32767:
                continue        # gather index overflows 16 bits
            for vdt in space.value_dtypes:
                if (vdt == "bfloat16"
                        and not stats.numerically_symmetric):
                    continue
                for var in space.variants:
                    out.append(ExecutionPlan(
                        path="nnzsplit", w_cap=space.w_cap,
                        k_step_sublanes=ks, index_dtype=idt,
                        value_dtype=vdt, variant=var,
                        partition=space.partition,
                        accumulation=space.accumulation))
    return out


def _nnzsplit_fields(plan) -> tuple:
    # no tm: the chunking is row-independent; w_cap doubles as the
    # per-chunk row-window cap
    return (plan.k_step_sublanes, plan.w_cap, plan.index_dtype,
            plan.value_dtype)


def _nnzsplit_build(M, plan, coloring=None) -> dict:
    from repro_torch.kernels import csrc_spmv_nnzsplit as nz_mod
    if not M.is_square:
        raise ValueError(
            "nnzsplit path chunks the square CSRC part only; "
            "use 'segment' for rectangular matrices")
    BUILD_COUNTS.inc("nnzsplit_pack")
    return {"nnzsplit_pack": nz_mod.pack_nnzsplit(
        M, ks=plan.k_step_sublanes, r_cap=plan.w_cap,
        dtype=_value_dtype_of(plan),
        index_dtype=_index_dtype_of(plan))}


def _nnzsplit_save(sched):
    pk = sched.nnzsplit_pack
    shape = (pk.num_chunks, pk.ks, 128)
    # the JAX package's layout: (C, ks, 128) vals / lrow, a flat (C·S,)
    # src, float32 values re-narrowed on load to the recorded dtype
    meta = {"nnzsplit_pack": {
        "n": pk.n, "num_chunks": pk.num_chunks, "ks": pk.ks,
        "r_pad": pk.r_pad, "num_symmetric": bool(pk.num_symmetric),
        "value_dtype": str(pk.vals.dtype).replace("torch.", ""),
        "pad_ratio": pk.pad_ratio}}
    arrays = dict(
        nnzsplit_vals=_host_f32(pk.vals).reshape(shape),
        nnzsplit_lrow=pk.lrow.detach().cpu().numpy().reshape(shape),
        nnzsplit_src=pk.src.detach().cpu().numpy().reshape(-1),
        nnzsplit_chunk_row0=pk.chunk_row0.detach().cpu().numpy(),
        nnzsplit_fixup_idx=pk.fixup_idx.detach().cpu().numpy(),
        nnzsplit_ad=_host_f32(pk.ad),
    )
    return meta, arrays


def _nnzsplit_load(meta, z) -> dict:
    from repro_torch.convert import nnzsplit_from_arrays
    pm = meta["nnzsplit_pack"]
    return {"nnzsplit_pack": nnzsplit_from_arrays(
        n=pm["n"], num_chunks=pm["num_chunks"], ks=pm["ks"],
        r_pad=pm["r_pad"], num_symmetric=bool(pm["num_symmetric"]),
        pad_ratio=float(pm["pad_ratio"]),
        value_dtype=pm.get("value_dtype", "float32"),
        **{f: z["nnzsplit_" + f] for f in (
            "vals", "lrow", "src", "chunk_row0", "fixup_idx", "ad")})}


def _nnzsplit_refresh(M, sched) -> dict:
    from repro_torch.kernels import csrc_spmv_nnzsplit as nz_mod
    return {"nnzsplit_pack": nz_mod.refresh_nnzsplit_values(
        sched.nnzsplit_pack, M)}


def _nnzsplit_make_spmv(M, schedule, plan, *, coloring=None):
    if plan.variant == "stream":
        from repro_torch.kernels import csrc_spmv_stream as stream_mod
        return functools.partial(stream_mod.nnzsplit_spmv_stream,
                                 schedule.nnzsplit_pack)
    from repro_torch.kernels import csrc_spmv_nnzsplit as nz_mod
    return functools.partial(nz_mod.nnzsplit_spmv, schedule.nnzsplit_pack)


def _nnzsplit_make_spmm(M, schedule, plan, *, coloring=None):
    if plan.variant == "stream":
        from repro_torch.kernels import csrc_spmv_stream as stream_mod
        return functools.partial(stream_mod.nnzsplit_spmm_stream,
                                 schedule.nnzsplit_pack)
    from repro_torch.kernels import csrc_spmv_nnzsplit as nz_mod
    return functools.partial(nz_mod.nnzsplit_spmm, schedule.nnzsplit_pack)


NNZSPLIT_SHARD_SUPPORT = ShardSupport(
    name="nnzsplit",
    module="repro_torch.kernels.csrc_spmv_nnzsplit",
    classes=("NnzSplitShards", "NnzSplitHalo"),
    geometry=lambda plan: (plan.k_step_sublanes, plan.w_cap,
                           plan.index_dtype, plan.value_dtype),
    pack_kw=lambda plan: dict(
        ks=plan.k_step_sublanes, r_cap=plan.w_cap,
        dtype=_value_dtype_of(plan), index_dtype=_index_dtype_of(plan)),
)


register_path(KernelPath(
    name="nnzsplit",
    feasible=_nnzsplit_feasible,
    candidates=_nnzsplit_candidates,
    artifact_fields=_nnzsplit_fields,
    build_artifact=_nnzsplit_build,
    save_artifact=_nnzsplit_save,
    load_artifact=_nnzsplit_load,
    make_spmv=_nnzsplit_make_spmv,
    make_spmm=_nnzsplit_make_spmm,
    refresh_values=_nnzsplit_refresh,
    shard_support=NNZSPLIT_SHARD_SUPPORT,
))
