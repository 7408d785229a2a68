"""Public entry points for the CSRC SpMV/SpMM products.

``SpmvOperator`` executes an :class:`repro_torch.core.plan.ExecutionPlan`
through an :class:`repro_torch.core.schedule.SpmvSchedule` — the
precomputed artifact bundling the pack and row partition/halo ranges the
plan needs (core/schedule.py).  The operator never packs or partitions
inline: it asks the schedule layer (and, given ``cache=``, reuses the
artifact stored next to the plan in the tuner's PlanCache).

Dispatch is registry-driven: the plan's path resolves to its
:class:`~repro_torch.core.paths.KernelPath` entry, whose executor factories
produce the SpMV and SpMM callables — this module contains no per-path
``if`` chain.  Registered paths (core/paths.py):

  * 'kernel'   rectangular-grid block-ELL CUDA kernels when the matrix is
    banded enough to window;
  * 'flat'     flat-grid block-ELL CUDA kernels (per-tile-exact k-steps,
    for skewed row lengths; chosen only by an explicit plan);
  * 'nnzsplit' nnz-split CUDA kernels over equal chunks of the combined
    stream (unstructured matrices: power-law graphs, random patterns;
    chosen only by an explicit plan);
  * 'colorful' the paper's §3.2 row coloring, one ``index_add_`` pair per
    color (chosen only by an explicit plan);
  * 'segment'  ``index_add_`` torch path (any matrix, incl. the
    rectangular tail).

Every path accepts ``x`` of shape (m,) — classic SpMV — or (m, r) —
multi-RHS SpMM (batched serving, block-Krylov solvers).  Construction
accepts either a fully-resolved plan (``from_plan``) or the keyword form
where ``path='auto'`` resolves to kernel-if-packable-else-segment (the
paper's static fallback).  Either way the operator *emits* the concrete
plan it runs as ``op.plan`` and the artifact as ``op.schedule``.

``device=`` says where the operator runs and defaults to the card; the
matrix and the schedule's pack are moved there once, at bind time, and the
operator takes and returns tensors of that device.  ``device="cpu"`` runs
the plain PyTorch versions of the kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import device as device_mod
from repro_torch import obs
from repro_torch.core import paths as paths_mod
from repro_torch.core import schedule as schedule_mod
from repro_torch.core.csrc import CSRC
from repro_torch.core.plan import LANES, ExecutionPlan
from . import ref


class SpmvOperator:
    """A prepared y = A·x / Y = A·X for repeated application.

    Builds (or fetches from ``cache``) the schedule once; call like a
    function with x of shape (m,) or (m, r) on the operator's device.
    ``path`` is 'auto' or a registered path ('kernel', 'flat', 'nnzsplit',
    'colorful', 'segment'); or pass
    ``plan=`` / use :meth:`from_plan` to pin every degree of freedom.
    """

    def __init__(self, M: CSRC, path: str = "auto", tm: int = 128,
                 w_cap: int = 4096, device=None,
                 coloring=None, k_step: int = 1024,
                 plan: Optional[ExecutionPlan] = None,
                 schedule: Optional["schedule_mod.SpmvSchedule"] = None,
                 cache=None):
        self.device = device_mod.resolve(device)
        self.M = M
        self.n, self.m = M.n, M.m
        ks_sub = max(1, k_step // LANES)

        if plan is None and schedule is not None:
            plan = schedule.plan
        if plan is None:
            if path == "auto":
                base = ExecutionPlan(path="kernel", tm=tm, w_cap=w_cap,
                                     k_step_sublanes=ks_sub)
                if M.is_square:
                    try:
                        schedule = schedule_mod.schedule_for(
                            M, base, cache=cache)
                        plan = base
                    except ValueError:      # bandwidth gate: static fallback
                        plan = dataclasses.replace(base, path="segment")
                else:
                    plan = dataclasses.replace(base, path="segment")
            else:
                plan = ExecutionPlan(path=path, tm=tm, w_cap=w_cap,
                                     k_step_sublanes=ks_sub)
        try:
            self._entry = paths_mod.get_path(plan.path)
        except KeyError as e:
            raise ValueError(e.args[0]) from None
        if plan.strategy != "local":
            raise ValueError(
                f"SpmvOperator runs local plans; got strategy "
                f"{plan.strategy!r}")

        if schedule is None:
            # strict: an infeasible kernel plan or a square-only plan on a
            # rectangular matrix raises here (no silent fallback)
            schedule = schedule_mod.schedule_for(M, plan, cache=cache,
                                                 coloring=coloring)
        elif (schedule_mod.plan_artifact_fields(schedule.plan)
              != schedule_mod.plan_artifact_fields(plan)):
            raise ValueError(
                f"schedule was built for {schedule.plan.key()} and cannot "
                f"execute plan {plan.key()}")
        self.plan = plan
        self.path = plan.path
        self._bind(M, schedule, coloring=coloring)

    def _bind(self, M: CSRC, schedule, coloring=None):
        """Install the schedule and (re)build both executors through the
        registry — shared by construction and ``update_values``.  The
        matrix and the schedule's pack move to the operator's device here,
        once; ``self.schedule`` stays the host-side artifact (what the
        cache holds and ``save_npz`` writes)."""
        self.M = M
        self.schedule = schedule
        with obs.span("schedule.to_device", device=str(self.device)):
            bound = schedule.to(self.device)
            m_dev = M.to(self.device)
        # the path's pack ('kernel', 'flat' or 'nnzsplit'), None for
        # 'segment' and 'colorful'
        self.pack = next((p for p in (bound.pack, bound.flat_pack,
                                      bound.nnzsplit_pack)
                          if p is not None), None)
        self._fn = self._entry.make_spmv(m_dev, bound, self.plan,
                                         coloring=coloring)
        self._fn_mm = self._entry.make_spmm(m_dev, bound, self.plan,
                                            coloring=coloring)

    def update_values(self, M: CSRC) -> "SpmvOperator":
        """Value-refresh fast path: swap in a matrix with **identical
        structure** (FEM time stepping — re-assembled values on a fixed
        connectivity).  Only the schedule's value streams are refreshed
        (``schedule.refresh_schedule``); no re-pack, no re-partition —
        ``BUILD_COUNTS`` records a single ``value_refresh``.
        Raises ValueError when the structure actually differs."""
        refreshed = schedule_mod.refresh_schedule(self.schedule, M)
        self._bind(M, refreshed)
        return self

    @classmethod
    def from_plan(cls, M: CSRC, plan: ExecutionPlan,
                  device=None, coloring=None, cache=None,
                  schedule=None) -> "SpmvOperator":
        """Strict construction: the plan's path is executed as given (a
        'kernel' plan whose window does not fit raises ValueError).  Pass
        ``cache=`` (a PlanCache) to reuse the stored schedule artifact."""
        return cls(M, device=device, coloring=coloring, plan=plan,
                   cache=cache, schedule=schedule)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """y = A·x; an ``spmv.product`` range while the profiler records
        (``obs.trace_range``)."""
        if x.device != self.device:
            raise ValueError(f"operator is bound to {self.device}, x lives "
                             f"on {x.device}")
        with obs.trace_range("spmv.product"):
            if x.ndim == 2:
                return self._fn_mm(x)
            return self._fn(x)

    @property
    def flops_per_call(self) -> int:
        """Useful flops (paper §4.1): n mul + (nnz-n) fma = 2·nnz - n."""
        return 2 * self.M.nnz - self.M.n

    @property
    def bytes_per_call(self) -> int:
        if self.pack is not None:
            return self.pack.streamed_bytes()
        return self.M.working_set_bytes()


def spmv(M: CSRC, x: torch.Tensor, path: str = "auto", device=None,
         plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """One-shot convenience wrapper; ``x`` is moved to ``device``."""
    op = SpmvOperator(M, path=path, device=device, plan=plan)
    return op(x.to(op.device))


def spmv_transpose(M: CSRC, x: torch.Tensor, device=None) -> torch.Tensor:
    """A^T·x — the paper's O(1) transpose (swap al/au) through the segment
    path on ``device`` (default: the card); ``M`` and ``x`` are moved
    there."""
    dev = device_mod.resolve(device)
    return ref.csrc_spmv_transpose(M.to(dev), x.to(dev))


def spmm(M: CSRC, X: torch.Tensor, device=None) -> torch.Tensor:
    """Multi-RHS product through the segment path on ``device`` (default:
    the card); ``M`` and ``X`` are moved there."""
    dev = device_mod.resolve(device)
    return ref.csrc_spmm(M.to(dev), X.to(dev))
