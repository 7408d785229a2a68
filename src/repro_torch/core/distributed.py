"""Sharded CSRC SpMV/SpMM: the paper's accumulation strategies over p shards.

The paper runs p OpenMP threads on 2-4 cores, each with a private buffer
of y, and combines the buffers after the product.  Here the p "threads"
are the shards of a :class:`ShardMesh`; the race on y is the same (the
column half of a shard's slots writes rows other shards own), and each of
the paper's accumulations is one combining step:

  strategy='allreduce'       paper: local buffers + *all-in-one*
      accumulation.  Every shard owns an nnz-balanced contiguous row range
      (the schedule's partition), computes a full-length partial y, and the
      partials are summed.  Output replicated.

  strategy='reduce_scatter'  paper: *per buffer / interval* accumulation.
      The same partials, summed and cut into p equal intervals of
      ``n_pad = round_up(n, p)`` rows.  Output row-sharded; ``[:n]`` is y.

  strategy='halo'            paper: *effective* accumulation.  Equal-row
      shards of ns rows; a shard's local product covers rows [r0-h, r1)
      (h the 8-aligned bandwidth): it takes its left neighbour's last h
      rows of x, and adds its first h rows of y into that neighbour's last
      h rows.  The ring wraps as the JAX package's does: shard 0 takes the
      last shard's x tail and sends its halo rows to the last shard, where
      they add nothing (no slot of shard 0 reaches below row 0).

A :class:`ShardMesh` has two backends:

  'emulated'       (default) one process holds all p shards on one device
                   — the paper's set-up of p threads with private buffers
                   on one shared memory.  A product runs the p shard-local
                   products in turn on the device's stream, then the
                   combining step as tensor ops: a running sum in shard
                   order (allreduce), the same sum zero-padded to n_pad
                   (reduce_scatter), or the halo rows copied and added
                   between neighbours (halo).
  'process_group'  one shard per rank of the initialized
                   ``torch.distributed`` world: ``all_reduce``,
                   ``reduce_scatter_tensor`` and paired ``isend`` /
                   ``irecv`` of the h-row tails.  A product returns the
                   rank's part (all of y, its interval, its ns rows);
                   :meth:`MeshProduct.gather` assembles the whole.

Shard-local compute is plan-driven: a plan whose path registers a
:class:`~repro_torch.core.paths.ShardSupport` ('flat', 'nnzsplit') runs
that path's kernels per shard — allreduce / reduce_scatter over its
global-coordinate shard packs (``schedule.build_path_shards``), halo over
its local-coordinate packs (``schedule.build_path_halo``) — with the
plan's variant.  Every other path runs shard-locally as ``index_add_`` over
``ShardedSlots`` / ``HaloLayout`` (as the JAX package's segment sums,
outside its kernels).  Every builder takes x of shape (n,) or (n, B).

All structure comes from the schedule layer, memoized and shipped through
the PlanCache; a product only binds it to the mesh's device (once) and
runs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from repro_torch import device as device_mod
from repro_torch.obs import collectives
from . import paths as paths_mod
from . import schedule as schedule_mod
from .csrc import CSRC, bandwidth
from .plan import ExecutionPlan
from .schedule import SpmvSchedule

STRATEGIES = ("allreduce", "reduce_scatter", "halo")
BACKENDS = ("emulated", "process_group")


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


class ShardMesh:
    """p shards of one product: the port's ``jax.make_mesh((p,), ('rows',))``.

    ``backend='emulated'`` holds every shard on ``device`` (default the
    card); ``backend='process_group'`` holds shard ``rank`` of the
    initialized ``torch.distributed`` world, whose size must be p, on
    ``device``."""

    def __init__(self, p: int, device=None, backend: str = "emulated"):
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} not in {BACKENDS}")
        if int(p) < 1:
            raise ValueError(f"a mesh needs p >= 1 shards, got {p}")
        self.p = int(p)
        self.backend = backend
        self.device = device_mod.resolve(device)
        self.rank = None
        if backend == "process_group":
            import torch.distributed as dist
            if not dist.is_initialized():
                raise ValueError("backend='process_group' needs an "
                                 "initialized torch.distributed group")
            size = dist.get_world_size()
            if size != self.p:
                raise ValueError(f"the group has {size} ranks, the mesh "
                                 f"{self.p} shards")
            self.rank = dist.get_rank()

    @property
    def shards(self) -> List[int]:
        """The shards this process computes."""
        return list(range(self.p)) if self.rank is None else [self.rank]

    def __repr__(self) -> str:
        return (f"ShardMesh(p={self.p}, device={self.device}, "
                f"backend={self.backend!r})")


def _operand(x: torch.Tensor, n: int, device) -> torch.Tensor:
    if x.device != device:
        raise ValueError(f"the mesh lives on {device}, x on {x.device}")
    if x.ndim not in (1, 2) or x.shape[0] != n:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected ({n},) or "
                         f"({n}, B)")
    return x.to(torch.float32).contiguous()


def _bc(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast per-slot / per-row values over the columns of x (n, B)."""
    return v[:, None] if x.ndim == 2 else v


class MeshProduct:
    """y = A·x over a :class:`ShardMesh`, in three stages that a caller may
    time apart: ``prepare`` (x to each shard: the x halo exchange of the
    'halo' strategy), ``local`` (the shard-local products: the kernels) and
    ``combine`` (the accumulation).  ``__call__`` runs the three.

    Output: allreduce n rows, reduce_scatter n_pad rows, halo n rows; on a
    process-group mesh the rank's part of it (:meth:`gather` assembles)."""

    def __init__(self, mesh: ShardMesh, strategy: str, n: int,
                 local_y: Callable, layout, ns: int = 0, h: int = 0,
                 part=None):
        self.mesh = mesh
        self.strategy = strategy
        self.n = n
        self.p = mesh.p
        self.layout = layout           # bound to the mesh's device
        self.part = part               # the row partition (not for halo)
        self.local_y = local_y
        self.ns, self.h = ns, h
        self.n_pad = (ns * mesh.p if strategy == "halo"
                      else _round_up(n, mesh.p))

    # -- stages ----------------------------------------------------------

    def prepare(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = _operand(x, self.n, self.mesh.device)
        if self.strategy != "halo":
            return [x for _ in self.mesh.shards]
        ns, h, p = self.ns, self.h, self.p
        x_pad = torch.zeros((self.n_pad,) + tuple(x.shape[1:]),
                            dtype=torch.float32, device=x.device)
        x_pad[:self.n] = x
        if self.mesh.rank is None:
            _record_halo(x, h)
            # x_ext of shard t is rows [t·ns - h, (t+1)·ns) of x_pad: a view,
            # but for shard 0, whose left neighbour is the last shard
            return [torch.cat([x_pad[self.n_pad - h:], x_pad[:ns]]) if t == 0
                    else x_pad[t * ns - h:(t + 1) * ns] for t in range(p)]
        r = self.mesh.rank
        own = x_pad[r * ns:(r + 1) * ns]
        left = self._exchange(own[ns - h:].contiguous(), to=(r + 1) % p,
                              frm=(r - 1) % p)
        return [torch.cat([left, own])]

    def local(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        return [self.local_y(t, xt) for t, xt in zip(self.mesh.shards, xs)]

    def combine(self, parts: List[torch.Tensor]) -> torch.Tensor:
        if self.mesh.rank is None:
            return self._combine_emulated(parts)
        return self._combine_group(parts[0])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.combine(self.local(self.prepare(x)))

    # -- the emulated accumulations --------------------------------------

    def _combine_emulated(self, parts):
        # what each shard would put on the wire: its partial (allreduce),
        # its padded partial (reduce_scatter), its h halo rows (halo)
        if self.strategy == "halo":
            _record_halo(parts[0], self.h)
        else:
            row = parts[0][0].numel() * 4
            collectives.record(
                "all-reduce" if self.strategy == "allreduce"
                else "reduce-scatter",
                row * (self.n if self.strategy == "allreduce"
                       else self.n_pad))
        if self.strategy == "halo":
            ns, h, p = self.ns, self.h, self.p
            tail = tuple(parts[0].shape[1:])
            out = torch.empty((p, ns) + tail, dtype=torch.float32,
                              device=parts[0].device)
            for t in range(p):
                out[t] = parts[t][h:]
            for t in range(p):
                # y halo from the right neighbour (its rows [r0-h, r0) are
                # this shard's last h rows); the last shard takes shard 0's
                out[t, ns - h:] += parts[(t + 1) % p][:h]
            return out.reshape((self.n_pad,) + tail)[:self.n]
        y = parts[0]
        for q in parts[1:]:
            y += q                       # shard order
        if self.strategy == "allreduce":
            return y
        out = torch.zeros((self.n_pad,) + tuple(y.shape[1:]),
                          dtype=torch.float32, device=y.device)
        out[:self.n] = y
        return out

    def accumulation_bytes(self, nrhs: int = 1) -> int:
        """Bytes the emulated ``prepare`` and ``combine`` read and write on
        the device for x of width ``nrhs`` (each op's reads and writes,
        float32): allreduce the running sum, 3·(p-1)·n; reduce_scatter
        that and the padded copy, n_pad + 2n; halo the padded x (n_pad +
        2n), shard 0's x_ext (2·(ns+h)), the own rows (2·n_pad) and the
        halo adds (3·p·h)."""
        n, p, w = self.n, self.p, 4 * nrhs
        if self.strategy == "halo":
            ns, h = self.ns, self.h
            return w * (self.n_pad + 2 * n + 2 * (ns + h)
                        + 2 * self.n_pad + 3 * p * h)
        b = 3 * (p - 1) * n
        if self.strategy == "reduce_scatter":
            b += self.n_pad + 2 * n
        return w * b

    # -- the process-group accumulations ---------------------------------

    def _exchange(self, send: torch.Tensor, to: int, frm: int):
        """Send ``send`` to rank ``to`` and receive a tensor of its shape
        from rank ``frm`` (the ring step; a one-rank ring keeps its own)."""
        import torch.distributed as dist
        if to == self.mesh.rank and frm == self.mesh.rank:
            return send.clone()
        collectives.record("send-recv", send.numel() * send.element_size())
        recv = torch.empty_like(send)
        reqs = [dist.isend(send, to), dist.irecv(recv, frm)]
        for req in reqs:
            req.wait()
        return recv

    def _combine_group(self, part):
        import torch.distributed as dist
        if self.strategy == "allreduce":
            dist.all_reduce(part)
            collectives.record("all-reduce", part.numel() * 4)
            return part
        if self.strategy == "reduce_scatter":
            tail = tuple(part.shape[1:])
            y_pad = torch.zeros((self.n_pad,) + tail, dtype=torch.float32,
                                device=part.device)
            y_pad[:self.n] = part
            out = torch.empty((self.n_pad // self.p,) + tail,
                              dtype=torch.float32, device=part.device)
            dist.reduce_scatter_tensor(out, y_pad)
            collectives.record("reduce-scatter", y_pad.numel() * 4)
            return out
        r, p, h = self.mesh.rank, self.p, self.h
        from_right = self._exchange(part[:h].contiguous(), to=(r - 1) % p,
                                    frm=(r + 1) % p)
        out = part[h:].clone()
        out[self.ns - h:] += from_right
        return out

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        """The whole output from this rank's part (all ranks call it); the
        emulated mesh's output is whole already."""
        if self.mesh.rank is None or self.strategy == "allreduce":
            return y
        import torch.distributed as dist
        out = torch.empty((y.shape[0] * self.p,) + tuple(y.shape[1:]),
                          dtype=y.dtype, device=y.device)
        dist.all_gather_into_tensor(out, y.contiguous())
        collectives.record("all-gather", y.numel() * y.element_size())
        return out[:self.n] if self.strategy == "halo" else out


def _record_halo(t: torch.Tensor, h: int) -> None:
    """An emulated halo step: each shard sends h rows of ``t``'s width."""
    collectives.record("send-recv", h * t[0].numel() * 4)


# ---------------------------------------------------------------------------
# Shard-local products
# ---------------------------------------------------------------------------

def _slots_local_fn(ss, n: int):
    """The ``index_add_`` shard-local partial over ShardedSlots (bound to
    the device): the paper's private y buffer, n rows."""
    rows = ss.row_idx.long()
    cols = ss.ja.long()

    def local_y(t: int, x: torch.Tensor) -> torch.Tensor:
        r, j = rows[t], cols[t]
        y = _bc(ss.ad_shard[t], x) * x
        y.index_add_(0, r, _bc(ss.al[t], x) * x[j])
        y.index_add_(0, j, _bc(ss.au[t], x) * x[r])
        return y

    return local_y


def _halo_local_fn(lay):
    """The ``index_add_`` shard-local product over a HaloLayout: x_ext
    (ns + h rows) in, y_ext (ns + h rows) out, the h halo rows first."""
    rows = lay.row_loc.long() + lay.h
    cols = lay.col_rel.long()
    ns, h = lay.ns, lay.h

    def local_y(t: int, x_ext: torch.Tensor) -> torch.Tensor:
        r, j = rows[t], cols[t]
        y = torch.zeros((ns + h,) + tuple(x_ext.shape[1:]),
                        dtype=torch.float32, device=x_ext.device)
        y.index_add_(0, r, _bc(lay.al[t], x_ext) * x_ext[j])
        y.index_add_(0, j, _bc(lay.au[t], x_ext) * x_ext[r])
        y[h:] += _bc(lay.ad[t], x_ext) * x_ext[h:]
        return y

    return local_y


def _shard_support(plan: Optional[ExecutionPlan]):
    """The plan's ShardSupport, or None when the path runs shard-locally as
    ``index_add_`` ('segment', 'colorful', 'kernel', or no plan)."""
    if plan is None:
        return None
    return paths_mod.get_path(plan.path).shard_support


def _schedule(M: CSRC, p: int, accumulation: str,
              schedule: Optional[SpmvSchedule], cache,
              plan: Optional[ExecutionPlan] = None) -> SpmvSchedule:
    if schedule is not None:
        return schedule
    if plan is None:
        plan = ExecutionPlan(path="segment", partition="nnz",
                             accumulation=accumulation)
    return schedule_mod.schedule_for(M, plan, cache=cache, p=p)


def build_spmv_allreduce(M: CSRC, mesh: ShardMesh,
                         scatter_output: bool = False,
                         schedule: Optional[SpmvSchedule] = None,
                         cache=None,
                         plan: Optional[ExecutionPlan] = None,
                         layout=None) -> MeshProduct:
    """The 'allreduce' (all-in-one) and 'reduce_scatter' (interval)
    strategies over the schedule's row partition.  With a plan or schedule
    whose path registers ShardSupport the shard-local partial runs that
    path's kernels over the shard's pack, with the plan's variant.

    ``layout`` injects a prebuilt (or value-refreshed) ShardedSlots / path
    shards layout; otherwise the schedule layer builds it — and, given
    ``cache``, serves it from / ships it to the PlanCache npz layer."""
    p = mesh.p
    acc = "reduce_scatter" if scatter_output else "allreduce"
    # the requested plan decides shard-local compute; the schedule only
    # supplies the row partition, so its request is path-free (no unused
    # full-matrix pack is built)
    req_plan = plan if plan is not None else (
        schedule.plan if schedule is not None else None)
    if plan is not None and schedule is None and plan.path != "segment":
        plan = dataclasses.replace(plan, path="segment")
    part = _schedule(M, p, acc, schedule, cache, plan=plan).partition
    if part.p != p:
        raise ValueError(f"schedule partition is {part.p}-way, the mesh "
                         f"has {p} shards")
    sup = _shard_support(req_plan)
    if sup is not None:
        lay = (layout if layout is not None
               else schedule_mod.build_path_shards(M, part, req_plan,
                                                   cache=cache))
        lay = lay.to(mesh.device)
        local_y = sup.local_fn(lay, M.n, req_plan.variant)
    else:
        lay = (layout if layout is not None
               else schedule_mod.build_sharded_slots(M, part, cache=cache))
        lay = lay.to(mesh.device)
        local_y = _slots_local_fn(lay, M.n)
    return MeshProduct(mesh, acc, M.n, local_y, lay, part=part)


def build_spmv_halo(M: CSRC, mesh: ShardMesh,
                    schedule: Optional[SpmvSchedule] = None,
                    cache=None,
                    plan: Optional[ExecutionPlan] = None,
                    layout=None) -> MeshProduct:
    """The 'halo' (effective) strategy: equal-row shards, only the h-row
    halos cross shard boundaries.  The halo geometry depends on the mesh
    width, not on a partition, so no schedule is needed;
    ``build_halo_layout`` / ``build_path_halo`` memoize it per (matrix, p[,
    pack geometry]).  Raises ValueError when the band does not fit inside
    one shard."""
    p = mesh.p
    plan = plan if plan is not None else (
        schedule.plan if schedule is not None else None)
    sup = _shard_support(plan)
    if sup is not None:
        lay = (layout if layout is not None
               else schedule_mod.build_path_halo(M, p, plan, cache=cache))
        ns, h, n_local = sup.halo_dims(lay)
        lay = lay.to(mesh.device)
        local_y = sup.local_fn(lay, n_local, plan.variant)
    else:
        lay = (layout if layout is not None
               else schedule_mod.build_halo_layout(M, p, cache=cache))
        ns, h = lay.ns, lay.h
        lay = lay.to(mesh.device)
        local_y = _halo_local_fn(lay)
    return MeshProduct(mesh, "halo", M.n, local_y, lay, ns=ns, h=h)


def build_sharded_spmv(M: CSRC, mesh: ShardMesh,
                       strategy: str = "auto",
                       schedule: Optional[SpmvSchedule] = None,
                       cache=None,
                       plan: Optional[ExecutionPlan] = None,
                       layout=None) -> MeshProduct:
    """Factory: a :class:`MeshProduct` computing A·x (or A·X for (n, B)
    blocks) over the mesh.  ``schedule`` / ``cache`` reuse the precomputed
    artifacts; with ``strategy='auto'`` a supplied schedule's (or plan's)
    accumulation decides, else the band: halo when it fits inside a shard,
    reduce_scatter otherwise.  ``layout`` injects a prebuilt shard layout
    (the MeshExecutor's value-refresh path)."""
    p = mesh.p
    if strategy == "auto":
        if schedule is not None:
            strategy = schedule.plan.accumulation
        elif plan is not None:
            strategy = plan.accumulation
        else:
            ns = -(-M.n // p)
            strategy = ("halo" if bandwidth(M) <= max(8, ns)
                        else "reduce_scatter")
    if strategy in ("allreduce", "reduce_scatter"):
        return build_spmv_allreduce(
            M, mesh, scatter_output=strategy == "reduce_scatter",
            schedule=schedule, cache=cache, plan=plan, layout=layout)
    if strategy == "halo":
        return build_spmv_halo(M, mesh, schedule=schedule, cache=cache,
                               plan=plan, layout=layout)
    raise ValueError(f"unknown strategy {strategy!r}")


def collective_bytes_from_stats(n: int, band: int, p: int, strategy: str,
                                nrhs: int = 1) -> int:
    """The JAX package's collective-bytes model over bare matrix
    statistics: bytes crossing links per shard per product between chips
    (the tuner's mesh candidate gate).  On an emulated mesh nothing crosses
    a link; ``MeshProduct.accumulation_bytes`` counts what its combining
    step moves on the device."""
    if strategy == "allreduce":
        return 2 * 4 * n * nrhs * (p - 1) // p       # ring all-reduce
    if strategy == "reduce_scatter":
        return 4 * n * nrhs * (p - 1) // p
    if strategy == "halo":
        return 2 * 4 * max(8, band) * nrhs           # x halo + y halo
    raise ValueError(strategy)


def collective_bytes_estimate(M: CSRC, p: int, strategy: str,
                              nrhs: int = 1) -> int:
    """:func:`collective_bytes_from_stats` for a matrix (scales linearly
    with the RHS block)."""
    return collective_bytes_from_stats(M.n, bandwidth(M), p, strategy,
                                       nrhs=nrhs)
