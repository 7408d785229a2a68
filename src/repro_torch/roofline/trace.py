"""Costs of one call on meta tensors, counted op by op: the port's
counterpart of reading a compiled module's ``cost_analysis`` and
``memory_analysis`` (the JAX package's ``launch/dryrun.py``), which torch
does not build (ROADMAP C40).

    tr = trace_fn(step, state, batch)
    tr.flops, tr.bytes_accessed, tr.peak_temp_bytes, tr.output_bytes

One dispatch mode, :class:`Tracer`, sees every aten op the call runs — the
backward's and remat's recomputations too — and records:

  flops            ``FlopCounterMode``'s formulas (``flop_registry``), as
                   ``op_cost.analyze_fn`` counts them;
  bytes accessed   every op's operand bytes plus result bytes, views apart
                   (a view moves nothing): the unfused semantics of the JAX
                   package's ``roofline/hlo_cost.py:224-229``;
  peak temporaries the peak of the bytes of live storages created during
                   the call, each dropped when a weak reference sees it
                   freed; the arguments' storages are counted apart
                   (``argument_bytes``);
  output bytes     the storages created in the call that the outputs hold;
  collectives      what the port's collectives record (``obs.collectives``).

Ops without a meta kernel that the ten archs reach, answered here:
``aten::bincount`` (the MoE dispatch's expert counts, ``models/moe.py``):
``(minlength,)`` int64 — every expert id is below ``minlength``, so that
is the size the card's kernel returns.

A whole step of a full-size cell is too many ops to trace (qwen3-8b x
train_4k is 270,228; a recurrent scan runs ops once per token), so
:func:`rollup` traces smaller copies and extrapolates, the way
``hlo_cost.py`` multiplies a while loop's body by its trip count:

  * repeat counts (layers, the hybrid's groups, microbatches): costs are
    affine in each count, so multilinear in all of them; each count is
    traced at two values and extrapolated.  The peak is affine in a count
    only within one phase, so the tracer keeps one peak per phase — the
    forward or the backward of the first microbatch or of a later one, or
    the update after them; before the first layer, in the first layer or
    in the last (an op's layer is that of the last stacked weight it
    read) — extrapolates each and takes the largest;
  * scans over a time axis, named by the caller (:func:`rolled_scans`),
    are each traced alone at three lengths and their forward and
    backward costs fitted as polynomials of degree two in the length
    (the backward's bytes are quadratic: each step's slice gradient is a
    full-size tensor); during the call's trace a stand-in returns
    outputs of the right shapes, adds the fitted flops and bytes, and
    holds the bytes the scan keeps for its backward (released with the
    graph, or at once when a remat checkpoint discards them), its
    transient peaks added on top of what is live.

Which counts repeat and which functions are scans is the caller's to say
(``launch/dryrun.py`` knows the models); nothing here names a model.
``tests/test_torch_dryrun_trace.py`` holds the rollup against whole
traces.  Nothing here changes what a function computes: the stand-ins
exist only inside :func:`rolled_scans`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import time
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from repro_torch.obs import collectives
from repro_torch.roofline.op_cost import _tensors, collective_stats

_AT = torch.ops.aten


@functools.lru_cache(maxsize=None)
def _op_info(func) -> Tuple[bool, Optional[Callable], bool, bool]:
    """(is a view, flop formula or None, decomposes, functional) of an op
    overload.  A composite op reaches the mode undecomposed under
    inference mode (prefill, decode); the tracer decomposes it, as
    ``FlopCounterMode`` does, so its matmuls are counted as under
    autograd.  A functional op (no argument or result aliased) has its
    meta results cached by :func:`_meta_key`."""
    from torch.utils.flop_counter import flop_registry
    schema = func._schema
    rets = schema.returns
    view = bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)
    composite = torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), "CompositeImplicitAutograd")
    functional = bool(rets) and not any(
        a.alias_info is not None for a in list(schema.arguments) + list(rets))
    return (view, flop_registry.get(func.overloadpacket), composite,
            functional)


class _NoKey(Exception):
    pass


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


def _k(x):
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise _NoKey
        return (x.shape, x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_k(e) for e in x)
    if isinstance(x, _PLAIN):
        return (type(x), x)
    raise _NoKey


def _meta_key(func, args, kwargs):
    """A key of a meta op's inputs (shapes, strides, dtypes, scalars):
    the same key gives results of the same shapes, strides and dtypes.
    None when an input is not on meta or not hashable."""
    try:
        return (func, _k(args), tuple(sorted(
            (k, _k(v)) for k, v in kwargs.items())))
    except _NoKey:
        return None


# ops whose result shares an input's storage though their schema says
# nothing (``aten._unsafe_view``): views for the count, never cached
_ALIASING: set = set()

# meta results by key: a layer's ops repeat across layers, microbatches
# and traces, and the meta kernels of pointwise ops are Python refs (about
# 100 us an op); an empty tensor of the cached layout costs a few
_META: Dict[tuple, object] = {}


def _layout(out):
    if isinstance(out, torch.Tensor):
        return (tuple(out.shape), out.stride(), out.dtype) \
            if out.device.type == "meta" else None
    if isinstance(out, (list, tuple)) and out and all(
            isinstance(o, torch.Tensor) and o.device.type == "meta"
            for o in out):
        return [(tuple(o.shape), o.stride(), o.dtype) for o in out]
    return None


def _from_layout(lay):
    if isinstance(lay, tuple):
        return torch.empty_strided(lay[0], lay[1], dtype=lay[2],
                                   device="meta")
    return tuple(torch.empty_strided(s, st, dtype=d, device="meta")
                 for s, st, d in lay)


def _flat(obj):
    """Tensors among an op's arguments or results (one level of lists)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            if isinstance(o, torch.Tensor):
                yield o
            elif isinstance(o, (list, tuple)):
                yield from _flat(o)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _bincount_meta(args, kwargs):
    weights = kwargs.get("weights", args[1] if len(args) > 1 else None)
    minlength = kwargs.get("minlength", args[2] if len(args) > 2 else 0)
    return torch.empty((int(minlength),), device=args[0].device,
                       dtype=torch.int64 if weights is None else
                       torch.float64)


class Tracer(TorchDispatchMode):
    """The dispatch mode of one trace.  ``units`` maps a storage key
    (``untyped_storage()._cdata``) of a layer stack's weights to (bytes of
    one unit, index of its first unit); ``n_units`` is the number of units
    (layers, or the hybrid's groups) the call runs."""

    def __init__(self, units: Dict[int, Tuple[int, int]] = None,
                 n_units: int = 0):
        super().__init__()
        self.units = units or {}
        self.n_units = n_units
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.live = 0
        self.peak = 0
        self.counting = True
        self._sizes: Dict[int, int] = {}
        self._refs: Dict[int, weakref.ref] = {}
        self._args: set = set()
        self._kinds = []             # "f" / "b" per segment of the call
        self._layer = None           # the unit of the last weight read
        self._k = 0                  # ops since the unit (or segment) began
        self._label = (-1, None, 0)
        self._peaks: Dict[tuple, int] = {}

    # ---- storages ----
    def watch_args(self, *objs) -> int:
        """Counts the storages of ``objs`` as arguments; returns their
        bytes (each storage once)."""
        total = 0
        for t in _tensors(objs):
            s = t.untyped_storage()
            if s._cdata not in self._args:
                self._args.add(s._cdata)
                total += s.nbytes()
        return total

    def adopt(self, t: torch.Tensor) -> None:
        """Counts ``t``'s storage as created in the call, until freed."""
        self.adopt_storage(t.untyped_storage())

    def adopt_storage(self, s) -> None:
        key = s._cdata
        if key in self._args or key in self._sizes:
            return
        n = s.nbytes()
        self._sizes[key] = n
        self.live += n
        self._refs[key] = weakref.ref(s, functools.partial(self._freed, key))

    def forget(self, s) -> None:
        """Stops counting storage ``s`` (its bytes are released now)."""
        key = s._cdata
        if key in self._sizes:
            self.live -= self._sizes.pop(key)
            self._refs.pop(key, None)

    def _freed(self, key, _ref):
        self.live -= self._sizes.pop(key, 0)
        self._refs.pop(key, None)

    def created_bytes(self, objs) -> int:
        """Bytes of the storages created in the call that ``objs`` hold."""
        seen, total = set(), 0
        for t in _tensors(objs):
            key = t.untyped_storage()._cdata
            if key in self._sizes and key not in seen:
                seen.add(key)
                total += self._sizes[key]
        return total

    # ---- phases ----
    def _phase(self, args, kwargs):
        kind = "b" if torch._C._current_autograd_node() is not None else "f"
        if not self._kinds or self._kinds[-1] != kind:
            self._kinds.append(kind)
            self._layer, self._k = None, -1
        if self.units:
            for t in itertools.chain(_flat(args), _flat(
                    tuple(kwargs.values()))):
                u = self.units.get(t.untyped_storage()._cdata)
                if u is not None:
                    j = u[1] + (t.storage_offset() * t.element_size()
                                ) // u[0]
                    if j != self._layer:
                        self._layer, self._k = j, -1
        self._k += 1
        self._label = (len(self._kinds) - 1, self._layer, self._k)

    def note(self, value: int) -> None:
        """A live-bytes value reached now (after an op's results, or a
        stand-in's transient), kept under the op's label."""
        key = self._label
        if value > self._peaks.get(key, -1):
            self._peaks[key] = value
        if value > self.peak:
            self.peak = value

    def inject(self, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.bytes += nbytes

    @contextlib.contextmanager
    def uncounted(self):
        """Ops whose flops and bytes are not the call's (a stand-in's
        placeholders); their storages are still tracked."""
        was, self.counting = self.counting, False
        try:
            yield
        finally:
            self.counting = was

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        view, flop, composite, functional = _op_info(func)
        if composite:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        view = view or func in _ALIASING
        key = (_meta_key(func, args, kwargs) if functional and not view
               else None)
        lay = _META.get(key) if key is not None else None
        if lay is not None:
            out = _from_layout(lay)
        elif func is _AT.bincount.default and args[0].device.type == "meta":
            out = _bincount_meta(args, kwargs)
        else:
            out = func(*args, **kwargs)
            if key is not None:
                ins = {t.untyped_storage()._cdata for t in _flat(args)}
                if any(o.untyped_storage()._cdata in ins for o in _flat(out)):
                    # aliases its input without saying so (_unsafe_view)
                    _ALIASING.add(func)
                    view = True
                else:
                    lay = _layout(out)
                    if lay is not None:
                        _META[key] = lay
        self._phase(args, kwargs)
        if self.counting:
            self.ops += 1
            if flop is not None:
                self.flops += flop(*args, **kwargs, out_val=out)
            if not view:
                b = 0
                for t in itertools.chain(_flat(args),
                                         _flat(tuple(kwargs.values())),
                                         _flat(out)):
                    b += _nbytes(t)
                self.bytes += b
        if functional and not view:
            # only an op that aliases nothing makes storages; a view or an
            # in-place op returns one that exists (maybe a module weight,
            # which is no argument and was not made in the call)
            for t in _flat(out):
                self.adopt(t)
        self.note(self.live)
        return out

    # ---- the peak by phase ----
    def phase_peaks(self) -> Dict[str, int]:
        """The live bytes after each op, by label
        ``<segment>/<unit>/<k>``: segment ``f0`` / ``b0`` (the first
        forward / backward), ``fN`` / ``bN`` (later microbatches; the
        largest over them), ``tail`` (after the last backward); unit
        ``pre`` (no unit's weight read yet in the segment; ``k`` ops into
        it), ``lo`` (the first unit), ``hi`` (the last, and all after
        it), ``mid`` (any other; ``k`` ops since the unit began).  Copies
        with other repeat counts run the same ops under each ``pre``,
        ``lo`` and ``hi`` label, so the live bytes of each label are
        affine in the counts."""
        kinds = self._kinds
        last_b = max((i for i, k in enumerate(kinds) if k == "b"),
                     default=-1)
        first_b = kinds.index("b") if "b" in kinds else -1

        def seg(i):
            if kinds[i] == "b":
                return "b0" if i == first_b else "bN"
            if i == 0:
                return "f0"
            return "tail" if i > last_b else "fN"

        out: Dict[str, int] = {}
        for (i, j, k), v in self._peaks.items():
            if j is None:
                labels = ["pre"]
            else:
                labels = []
                if j == 0:
                    labels.append("lo")
                if j == self.n_units - 1:
                    labels.append("hi")
                if not labels:
                    labels.append("mid")
            for lab in labels:
                key = f"{seg(i)}/{lab}/{k}"
                out[key] = max(out.get(key, 0), v)
        return out


_ACTIVE: list = []


@dataclasses.dataclass
class Trace:
    """What one trace (or a rollup of several) counted."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    peak_temp_bytes: float = 0.0
    output_bytes: float = 0.0
    argument_bytes: float = 0.0
    ops: float = 0.0
    phase_peaks: Dict[str, float] = dataclasses.field(default_factory=dict)
    collectives: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    collective_bytes: float = 0.0
    seconds: float = 0.0
    traces: int = 1

    def to_dict(self) -> Dict:
        """Every field but the per-label peaks (one per op)."""
        out = dataclasses.asdict(self)
        out.pop("phase_peaks")
        return out


def trace_fn(fn, *args, units=None, n_units: int = 0, **kwargs) -> Trace:
    """Run ``fn(*args, **kwargs)`` on meta tensors under a :class:`Tracer`
    and a collective recording; its counts."""
    t0 = time.perf_counter()
    tracer = Tracer(units, n_units)
    arg_bytes = tracer.watch_args(args, kwargs)
    _ACTIVE.append(tracer)
    try:
        with collectives.recording() as log, tracer:
            out = fn(*args, **kwargs)
        out_bytes = tracer.created_bytes(out)
    finally:
        _ACTIVE.remove(tracer)
    stats = collective_stats(log)
    del out
    return Trace(flops=float(tracer.flops),
                 bytes_accessed=float(tracer.bytes),
                 peak_temp_bytes=float(tracer.peak),
                 output_bytes=float(out_bytes),
                 argument_bytes=float(arg_bytes), ops=float(tracer.ops),
                 phase_peaks={k: float(v) for k, v in
                              tracer.phase_peaks().items()},
                 collectives=stats,
                 collective_bytes=sum(v["bytes"] for v in stats.values()),
                 seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# The multilinear rollup over repeat counts
# ---------------------------------------------------------------------------

_SUMMED = ("flops", "bytes_accessed", "output_bytes", "argument_bytes",
           "ops", "collective_bytes")


def multilinear(points: Dict[Tuple[int, ...], Trace],
                grid: Sequence[Tuple[int, int]],
                target: Sequence[int]) -> Trace:
    """The trace at ``target`` from traces at every corner of ``grid``
    (two values per count): exact for a multilinear function of the
    counts.  Each phase's peak is extrapolated alone and the largest is
    the peak; a phase missing at some corner is dropped."""
    weights = []
    for (a, b), x in zip(grid, target):
        weights.append({a: (b - x) / (b - a), b: (x - a) / (b - a)})
    out = Trace(traces=0)
    labels = None
    for corner, tr in points.items():
        labels = (set(tr.phase_peaks) if labels is None
                  else labels & set(tr.phase_peaks))
    for corner, tr in points.items():
        w = 1.0
        for wk, c in zip(weights, corner):
            w *= wk[c]
        for f in _SUMMED:
            setattr(out, f, getattr(out, f) + w * getattr(tr, f))
        for lab in labels:
            out.phase_peaks[lab] = out.phase_peaks.get(lab, 0.0) \
                + w * tr.phase_peaks[lab]
        out.seconds += tr.seconds
        out.traces += tr.traces
        for k, v in tr.collectives.items():
            dst = out.collectives.setdefault(k, {"count": 0.0, "bytes": 0.0})
            dst["count"] += w * v["count"]
            dst["bytes"] += w * v["bytes"]
    out.peak_temp_bytes = max(out.phase_peaks.values(), default=0.0)
    return out


def rollup(trace_at: Callable[..., Trace],
           counts: Sequence[Tuple[int, Tuple[int, int]]]) -> Trace:
    """``trace_at(*values)`` extrapolated to each count's full value.
    ``counts`` holds (full value, (a, b)) per count; a count whose full
    value is at most ``b`` is traced at its full value."""
    grid, target, fixed = [], [], []
    for full, (a, b) in counts:
        if full <= b:
            fixed.append(full)
            grid.append(None)
        else:
            fixed.append(None)
            grid.append((a, b))
            target.append(full)
    free = [i for i, g in enumerate(grid) if g is not None]
    if not free:
        return trace_at(*fixed)
    points = {}
    for corner in itertools.product(*(grid[i] for i in free)):
        vals = list(fixed)
        for i, c in zip(free, corner):
            vals[i] = c
        points[corner] = trace_at(*vals)
    return multilinear(points, [grid[i] for i in free], target)


# ---------------------------------------------------------------------------
# Rolled scans
# ---------------------------------------------------------------------------

# the shortest fit, in time units; the fit doubles it until its counts are
# polynomial (a peak stops being affine in the length where the steps'
# outputs overtake the state's transients, about 2 x d_state steps)
FIT_START = 16


def _poly_ok(ys, degree: int) -> bool:
    """Whether equally spaced ``ys`` lie on a polynomial of ``degree``."""
    d = list(ys)
    for _ in range(degree + 1):
        d = [b - a for a, b in zip(d, d[1:])]
    scale = max(1.0, max(abs(y) for y in ys))
    return all(abs(v) <= 1e-9 * scale for v in d)


def _fit3(xs, ys):
    """Coefficients of the degree-2 polynomial through three points."""
    (x0, x1, x2), (y0, y1, y2) = xs, ys
    d01 = (y1 - y0) / (x1 - x0)
    d12 = (y2 - y1) / (x2 - x1)
    c = (d12 - d01) / (x2 - x0)
    b = d01 - c * (x0 + x1)
    a = y0 - b * x0 - c * x0 * x0
    return a, b, c


# counts that are quadratic in the length (the backward's slice gradients);
# every other count is affine
_QUADRATIC = ("bbytes",)


class _ScanFit:
    """One scan's counts as functions of its length, for one signature
    (the inputs' shapes but the length, dtypes, requires_grad).  Each
    count comes from the scan traced alone (:func:`_measure`) at lengths
    s, 2s, 3s, 4s: when the peaks are affine on the last three and the
    backward's bytes quadratic on all four, the polynomial through the
    last three holds beyond; else s doubles.  A length within 4s is
    measured directly.  ``mask`` names the outputs the backward receives a
    gradient for (None: the forward alone)."""

    def __init__(self, fn, args, grad: bool, unit: int):
        self.fn, self.grad, self.unit = fn, grad, unit
        # shapes, dtypes and requires_grad only: holding the tensors
        # would keep a trace's storages alive
        self.args = [(tuple(a.shape), a.dtype, a.requires_grad)
                     for a in args]
        self.kept = None    # (inputs, outputs) the backward keeps alive
        self._rows: Dict[tuple, Dict[str, float]] = {}
        self._coef: Dict[object, tuple] = {}

    def _row(self, t, mask):
        key = (t, mask)
        if key not in self._rows:
            row, kept = _measure(self.fn, self.args, self.grad, t, mask)
            self._rows[key] = row
            self.kept = self.kept or kept
        return self._rows[key]

    def counts(self, t: int, mask=None) -> Dict[str, float]:
        """Every count of the scan at length ``t``; the forward's come
        from the rows of the usual backward (a gradient for the output,
        none for the final state) when the scan is differentiated."""
        if mask is None and self.grad:
            mask = (True, False)
        if mask not in self._coef:
            self._coef[mask] = (FIT_START * self.unit, None)
        s, coef = self._coef[mask]
        while coef is None and 4 * s < t:
            ts = [k * s for k in (1, 2, 3, 4)]
            rows = [self._row(x, mask) for x in ts]
            # affine counts on the last three lengths, quadratic ones on
            # all four
            if all(_poly_ok([r[k] for r in rows], 2) if k in _QUADRATIC
                   else _poly_ok([r[k] for r in rows[1:]], 1)
                   for k in rows[0]):
                coef = {k: _fit3(ts[1:], [r[k] for r in rows[1:]])
                        for k in rows[0]}
            else:
                s *= 2
            self._coef[mask] = (s, coef)
        if coef is None or t <= 4 * s:
            return self._row(t, mask)
        return {k: max(0.0, c[0] + c[1] * t + c[2] * t * t)
                for k, c in coef.items()}


def _with_length(args, t):
    """Leaf meta tensors of ``args``' (shape, dtype, requires_grad) with
    the time axis (dim 1 of the first four) of length ``t``."""
    out = []
    for i, (shape, dtype, rg) in enumerate(args):
        shape = list(shape)
        if i < 4:
            shape[1] = t
        out.append(torch.empty(shape, dtype=dtype,
                               device="meta").requires_grad_(rg))
    return out


def _measure(fn, args, grad, t, mask=None):
    """One scan alone at length ``t``, outside every ambient mode and
    saved-tensor hook: its forward flops and bytes, the forward's peak
    over its start (``fpk``; ``fpk_free`` when a checkpoint discards what
    it saves), the bytes it leaves live (``fend``: outputs and saved), its
    outputs' bytes; with ``mask``, the backward for the outputs it names:
    flops, bytes and the peak over its start (``bpk``).  Also returns
    which inputs and outputs the forward saves for the backward."""
    row, kept = {}, None
    with _disable_current_modes(), torch.set_grad_enabled(grad):
        for free in ((False, True) if grad else (False,)):
            xs = _with_length(args, t)
            saved = set()

            def pack(x):
                saved.add(x.untyped_storage()._cdata)
                return None if free else x

            tr = Tracer()
            tr.watch_args(xs)
            with torch.autograd.graph.saved_tensors_hooks(
                    pack, lambda x: x), tr:
                outs = fn(*xs)
            if free:
                row["fpk_free"] = tr.peak
                del outs
                continue
            kept = (tuple(x.untyped_storage()._cdata in saved for x in xs),
                    tuple(o.untyped_storage()._cdata in saved for o in outs))
            row.update(fflops=tr.flops, fbytes=tr.bytes, fpk=tr.peak,
                       fend=tr.live, out=sum(_nbytes(o) for o in outs))
            if mask is not None:
                roots = [o for o, m in zip(outs, mask) if m]
                need = [x for x in xs if x.requires_grad]
                with tr, tr.uncounted():
                    seed = _Seed.apply(tr, *roots)
                # the outputs' gradients arrive with the backward (as in
                # the model, where they are live when it reaches the
                # scan) and are freed once used
                start = tr.live + sum(_nbytes(o) for o in roots)
                tr.peak = 0
                tr.flops = tr.bytes = 0.0
                one = torch.ones((), device="meta")
                with tr:
                    torch.autograd.grad(seed, need, one, allow_unused=True)
                row.update(bflops=tr.flops, bbytes=tr.bytes,
                           bpk=max(0, tr.peak - start))
            del outs
    return row, kept


class _Seed(torch.autograd.Function):
    """A scalar whose backward hands each of its inputs a gradient (made
    by the engine, so freed once used, as in the model)."""

    @staticmethod
    def forward(ctx, tracer, *outs):
        ctx.tracer = tracer
        ctx.meta = [(o.shape, o.dtype) for o in outs]
        return torch.zeros((), device="meta")

    @staticmethod
    def backward(ctx, _g):
        with ctx.tracer.uncounted():
            return (None,) + tuple(torch.empty(s, dtype=d, device="meta")
                                   for s, d in ctx.meta)


class _StandIn(torch.autograd.Function):
    """A scan's outputs at full length; its fitted backward counts are
    added when autograd reaches it."""

    @staticmethod
    def forward(ctx, rolled, fit, t, tracer, *args):
        ctx.fit, ctx.t, ctx.tracer = fit, t, tracer
        ctx.set_materialize_grads(False)
        ctx.in_meta = [(a.shape, a.dtype, a.requires_grad) for a in args]
        c = fit.counts(t)
        with tracer.uncounted():
            outs = rolled.outputs(args)
        # the bytes the scan saves for its backward, held untracked until
        # the checkpoint (if any) has kept or dropped them
        with _disable_current_modes():
            hold = torch.empty((max(0, int(c["fend"] - c["out"])),),
                               dtype=torch.uint8, device="meta")
        # and the inputs and outputs the scan's backward keeps alive
        kept_in, kept_out = fit.kept
        ctx.save_for_backward(
            hold, *(a for a, k in zip(args, kept_in) if k),
            *(o for o, k in zip(outs, kept_out) if k))
        ctx.hold = weakref.ref(hold.untyped_storage())
        return outs

    @staticmethod
    def backward(ctx, *gouts):
        fit, t, tracer = ctx.fit, ctx.t, ctx.tracer
        c = fit.counts(t, tuple(g is not None for g in gouts))
        tracer.inject(c["bflops"], c["bbytes"])
        tracer.note(tracer.live + int(c["bpk"]))
        # the scan's saved tensors are gone by the end of its backward
        hold = ctx.hold()
        if hold is not None:
            tracer.forget(hold)
        grads = []
        with tracer.uncounted():
            for shape, dtype, rg in ctx.in_meta:
                grads.append(torch.empty(shape, dtype=dtype, device="meta")
                             if rg else None)
        return (None, None, None, None) + tuple(grads)


# fits by (scan, signature), kept across traces
_FITS: Dict[tuple, _ScanFit] = {}


class _Rolled:
    """The stand-in that replaces one scan while :func:`rolled_scans` is
    open (on meta, inside a trace); any other call runs the scan."""

    def __init__(self, name, fn, t_unit):
        self.name, self.fn, self.t_unit = name, fn, t_unit

    @staticmethod
    def outputs(args):
        x = args[0]
        return (torch.empty(x.shape, dtype=torch.float32, device=x.device),
                torch.empty(args[5].shape, dtype=torch.float32,
                            device=x.device))

    def __call__(self, *args):
        tracer = _ACTIVE[-1] if _ACTIVE else None
        t = args[0].shape[1]
        unit = self.t_unit()
        if tracer is None or t % unit or args[0].device.type != "meta":
            return self.fn(*args)
        grad = torch.is_grad_enabled() and any(a.requires_grad
                                               for a in args)
        key = (self.name, tuple((tuple(a.shape[:1]) + tuple(a.shape[2:]),
                                 a.dtype, a.requires_grad) for a in args),
               grad, unit, torch.is_inference_mode_enabled())
        if key not in _FITS:
            _FITS[key] = _ScanFit(self.fn, args, grad, unit)
        fit = _FITS[key]
        c = fit.counts(t)
        tracer.inject(c["fflops"], c["fbytes"])
        base = tracer.live
        if not grad:
            with tracer.uncounted():
                outs = self.outputs(args)
            tracer.note(base + int(c["fpk"]))
            return outs
        outs = _StandIn.apply(self, fit, t, tracer, *args)
        # what the scan saved: kept (plain autograd, or a checkpoint's
        # recomputation) or already dropped (a checkpoint's first forward)
        hold = outs[0].grad_fn.hold()
        if hold is not None:
            tracer.adopt_storage(hold)
            tracer.note(base + int(c["fpk"]))
        else:
            tracer.note(base + int(c["fpk_free"]))
        return outs


@contextlib.contextmanager
def rolled_scans(scans):
    """Replaces each scan of ``scans`` by its stand-in for the block.
    ``scans`` holds (module, function name, time unit) per scan: the
    function takes (x1, x2, x3, x4, y1, y2) with the time axis at dim 1 of
    the first four and returns (out, state) in float32, ``out`` of x1's
    shape and ``state`` of y2's; ``time_unit()`` is the length the time
    axis must be a multiple of for the stand-in to replace a call."""
    saved = []
    try:
        for mod, name, unit in scans:
            fn = getattr(mod, name)
            saved.append((mod, name, fn))
            setattr(mod, name, _Rolled(name, fn, unit))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
