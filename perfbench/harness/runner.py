"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the plain reference, and the result line.

Set-up builds a ``SpmvServingEngine`` on the device with its default plan
resolution and a ``PlanCache`` in a fixed directory of the checkout,
registers the configuration's matrix, takes ``engine.executor`` as the
operator and solves one warm-up set.  The window is a closed loop of sets:
``repro_torch.core.solvers.cg`` from x0 = 0 on a fresh block of
right-hand sides, ``iters_per_set`` iterations (tol 0), one set after the
other, until the first set boundary after ``seconds``.  The benchmark's
wrapper around the operator stamps the host clock at every call but a
set's first (A·x0) and at every set's end; every iteration ends in
``cg``'s residual sync, so the time between two stamps is one iteration,
or a set's prologue with the gap before it.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import random
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.harness import checks, devtrace, roofline, spec, traffic
from perfbench.reference import csrc_ref

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CHECK_SETS = 3          # sets whose x is compared, drawn from the seed
CHECK_PRODUCTS = 4      # products compared, drawn from the seed
TRACE_ITERS = 300       # iterations the traced slice holds at least
CACHE = os.path.join(spec.PERFBENCH, "cache")
UNLIMITED = {name: {"limit": math.inf} for name in checks.NAMES}


def say(kind: str, **fields) -> None:
    """An earlier line of the run's standard output (never the last)."""
    print(json.dumps({"perfbench": kind, **fields}, default=str), flush=True)


class Reservoir:
    """A uniform sample of ``size`` items from a stream of unknown length,
    drawn by ``rng`` (Algorithm R); items are cloned when taken, so the
    sample does not depend on whether the program reuses its buffers."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng = size, rng
        self.items: List[Tuple] = []
        self.seen = 0

    def offer(self, *tensors) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            slot = len(self.items)
            self.items.append(None)
        else:
            slot = self.rng.randrange(self.seen)
            if slot >= self.size:
                return
        self.items[slot] = tuple(t.detach().clone() if torch.is_tensor(t)
                                 else t for t in tensors)


class TimedOperator:
    """The benchmark's wrapper around the operator: a host-clock stamp at
    every call but a set's first (A·x0), one at the end of every set, the
    products it keeps for the comparison, and, in the traced slice, a
    ``record_function`` range around each call."""

    def __init__(self, op: Callable, products: Optional[Reservoir]):
        self.op = op
        self.products = products
        self.annotate = False
        self.reset()

    def reset(self, start: Optional[float] = None):
        """Forget the stamps; ``start`` is the window's first."""
        self.stamps: List[float] = [] if start is None else [start]
        self._first = False

    def begin_set(self):
        self._first = True

    def end_set(self):
        self.stamps.append(time.perf_counter())

    def __call__(self, x):
        first, self._first = self._first, False
        if not first:
            self.stamps.append(time.perf_counter())
        if self.annotate:
            with torch.profiler.record_function(devtrace.PRODUCT):
                y = self.op(x)
        else:
            y = self.op(x)
        if not first and self.products is not None:
            # A·x0 with x0 = 0 has nothing to compare
            self.products.offer(x, y)
        return y

    def iteration_times(self) -> np.ndarray:
        """Seconds between successive stamps: they tile the window.  A set
        gives iters + 1 intervals: from the previous set's end (or the
        window's start) through its prologue (A·x0, the first residual and
        its sync) to its first iteration's product, then one for every
        iteration, each ending at the next product or at the set's end."""
        return np.diff(np.asarray(self.stamps))


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    n: int
    k: int
    nnz: int
    nrhs: int
    numerically_symmetric: bool
    peaks: Optional[Dict[str, float]]
    setup_s: float
    register_s: float
    window_s: float = 0.0
    sets: int = 0
    iterations: int = 0
    iteration_s: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))
    slice: Optional[devtrace.DeviceSlice] = None
    slice_iterations: int = 0


def _cg(*args, **kw):
    """The program's solver, looked up at each call."""
    from repro_torch.core import solvers
    return solvers.cg(*args, **kw)


def _solve_sets(op: TimedOperator, pool, ad, iters: int,
                until: float, max_sets: int = 0,
                sample: Optional[Reservoir] = None) -> Tuple[int, int, int]:
    """Sets one after the other until the host clock passes ``until`` (or
    ``max_sets`` are done); returns (sets, iterations, short sets)."""
    sets = total = short = 0
    while True:
        b = pool[sets % len(pool)]
        op.begin_set()
        res = _cg(op, b, tol=0.0, maxiter=iters, diag=ad)
        op.end_set()
        total += res.iters
        short += res.iters != iters
        if sample is not None:
            sample.offer(b, res.x, res.iters)
        sets += 1
        if (max_sets and sets >= max_sets) or (
                not max_sets and time.perf_counter() >= until):
            return sets, total, short


def _trace_slice(op: TimedOperator, pool, ad, iters: int,
                 device) -> Tuple[Optional[devtrace.DeviceSlice], int]:
    """At least TRACE_ITERS iterations under torch.profiler, each operator
    call inside a product range; the reduced trace and its iterations."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    n_sets = -(-TRACE_ITERS // iters)
    op.reset()
    op.annotate = True
    with profile(activities=acts) as prof:
        with record_function(devtrace.SLICE):
            _, total, _ = _solve_sets(op, pool, ad, iters, 0.0,
                                      max_sets=n_sets)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    op.annotate = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    return devtrace.reduce(trace), total


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class System:
    """The system under test as set-up leaves it."""
    op: Callable
    arrays: Dict
    ad: torch.Tensor
    register_s: float
    generate_s: float


def set_up(cell: spec.Cell, device: torch.device,
           control: Optional[str] = None) -> System:
    """The matrix from the configuration's generator, handed to the engine
    through ``from_assembly``; the engine's default plan for it; its
    executor.  ``control="bf16"`` puts the reference one precision down in
    the program's place instead."""
    from repro_torch import obs
    from repro_torch.core import csrc
    from repro_torch.core.tuner import PlanCache
    from repro_torch.serve.engine import SpmvServingEngine
    cfg = cell.config
    t0 = time.perf_counter()
    if cfg["preconditioner"] != "jacobi":
        raise ValueError("the plain reference solves Jacobi-PCG only, not "
                         f"{cfg['preconditioner']!r}")
    arrays = spec.generator(cfg["generator"]).build(cfg)
    generate_s = time.perf_counter() - t0
    ad = torch.as_tensor(arrays["ad"]).to(device)
    if control == "bf16":
        return System(csrc_ref.LowPrecision(arrays, device), arrays, ad,
                      0.0, generate_s)
    if control is not None:
        raise ValueError(f"unknown control {control!r}")
    M = csrc.from_assembly(arrays["n"], arrays["ia"], arrays["ja"],
                           arrays["ad"], arrays["al"], arrays["au"])
    cache = PlanCache(path=os.path.join(CACHE, cfg["name"], "plans.json"))
    engine = SpmvServingEngine(cache=cache, device=device)
    obs.clear_trace()
    t0 = time.perf_counter()
    plan = engine.register(cfg["name"], M)
    register_s = time.perf_counter() - t0
    say("register", plan=plan.key(), path=plan.path, variant=plan.variant,
        register_s=register_s, generate_s=generate_s,
        spans=[{"name": r["name"], "seconds": r["duration_s"]}
               for r in obs.trace() if r["name"].startswith("schedule.")])
    return System(engine.executor(cfg["name"]), arrays, ad, register_s,
                  generate_s)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        t_start: float, device="cuda",
        control: Optional[str] = None) -> Tuple[int, Optional[Dict]]:
    """One run; returns (exit code, result).  The result is None where no
    result may be printed."""
    device = torch.device(device)
    tr = cell.traffic
    iters, nrhs = int(tr["iters_per_set"]), int(tr["rhs"])
    t_enter = time.perf_counter()
    system = set_up(cell, device, control)
    arrays = system.arrays
    t_built = time.perf_counter()
    pool, warm = traffic.blocks(tr, arrays["n"], seed, device,
                                dtype=system.ad.dtype)
    t_blocks = time.perf_counter()
    op = TimedOperator(system.op, None)
    _solve_sets(op, [warm], system.ad, iters, 0.0, max_sets=1)
    _sync(device)
    op.reset()
    rng = random.Random(int(seed))
    products = op.products = Reservoir(CHECK_PRODUCTS, rng)
    sets_kept = Reservoir(CHECK_SETS, rng)
    t_warm = time.perf_counter()
    setup_s = t_warm - t_start
    say("setup", setup_s=setup_s, start_s=t_enter - t_start,
        generate_s=system.generate_s, register_s=system.register_s,
        system_s=t_built - t_enter, blocks_s=t_blocks - t_built,
        warm_s=t_warm - t_blocks)

    w0 = time.perf_counter()
    op.reset(start=w0)
    sets, total, short = _solve_sets(op, pool, system.ad, iters,
                                     w0 + seconds, sample=sets_kept)
    window_s = op.stamps[-1] - w0
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    rec = Run(n=arrays["n"],
              k=int(arrays["ja"].shape[0]),
              nnz=arrays["n"] + 2 * int(arrays["ja"].shape[0]), nrhs=nrhs,
              numerically_symmetric=bool(arrays["numerically_symmetric"]),
              peaks=roofline.peaks_of(kind), setup_s=setup_s,
              register_s=system.register_s, window_s=window_s, sets=sets,
              iterations=total, iteration_s=op.iteration_times())
    if trace:
        op.products = None
        try:
            rec.slice, rec.slice_iterations = _trace_slice(
                op, pool, system.ad, iters, device)
        except devtrace.UnmatchedActivity as err:
            print(f"perfbench: the device trace cannot be read: {err}",
                  file=sys.stderr)
            return 4, None
    dev_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                "kind": kind, "count": cell.chips}
    if device.type == "cuda":
        dev_info["memory_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(device))
    found = forbidden_modules()
    if found:
        print("perfbench: modules of JAX or of the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3, None

    del op, system, pool, warm
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = csrc_ref.Csrc64(arrays, device)
    compared, failed = checks.compare(ref, products.items, sets_kept.items,
                                      cell.limits)
    del ref
    say("compared", seconds=time.perf_counter() - t_ref,
        products=len(products.items), sets=len(sets_kept.items),
        sets_in_window=sets, iterations=total, short_sets=short,
        window_s=window_s, setup_s=setup_s,
        card=_card_line(device))
    failed += short
    correct = failed == 0 and all(c["value"] <= c["limit"]
                                  for c in compared.values())

    metrics = cell.per_layer if trace else cell.end_to_end
    result = {"correct": bool(correct), "attempted": sets, "failed": failed,
              "metrics": _metrics(rec, metrics), "device": dev_info}
    if trace and rec.slice is not None:
        dev_info["busy_s"] = rec.slice.busy_s
        dev_info["window_s"] = rec.slice.window_s
        result["breakdown"] = {
            "device_ops": [list(kv) for kv in rec.slice.device_ops],
            "idle_gaps": [list(kv) for kv in rec.slice.idle_gaps]}
    result["checks"] = {name: {"value": _finite(c["value"]),
                               "limit": c["limit"]}
                        for name, c in compared.items()}
    return 0, result


def _metrics(rec: Run, metrics: List[Dict]) -> Dict:
    """Each metric its reader finds something for, with its unit."""
    out = {}
    for m in metrics:
        v = spec.metric_reader(m["name"])(rec)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def _card_line(device) -> Optional[str]:
    """The card's name and power limit, read beside every number."""
    if device.type != "cuda":
        return None
    from repro_torch import device as device_mod
    return device_mod.power_limit()


def _finite(v: float) -> Optional[float]:
    return v if math.isfinite(v) else None


def readings(cell: spec.Cell, seeds: List[int], device="cuda",
             control: Optional[str] = None) -> List[Dict]:
    """The compared numbers on many seeds after one set-up: for each seed,
    CHECK_SETS sets of the cell's own width from that seed's blocks, all
    of their x and CHECK_PRODUCTS of their products compared, as a run
    compares.  This is what the limits are set from (the program's seeds,
    and the control's); the benchmark's own runs never call it."""
    device = torch.device(device)
    tr = cell.traffic
    iters = int(tr["iters_per_set"])
    system = set_up(cell, device, control)
    ref = csrc_ref.Csrc64(system.arrays, device)
    out = []
    for seed in seeds:
        pool, _ = traffic.blocks(tr, system.arrays["n"], seed, device,
                                 count=CHECK_SETS, dtype=system.ad.dtype)
        rng = random.Random(int(seed))
        op = TimedOperator(system.op, Reservoir(CHECK_PRODUCTS, rng))
        kept = Reservoir(CHECK_SETS, rng)
        _solve_sets(op, pool, system.ad, iters, 0.0,
                    max_sets=CHECK_SETS, sample=kept)
        compared, failed = checks.compare(ref, op.products.items,
                                          kept.items, UNLIMITED)
        line = {"seed": seed, "control": control, "failed": failed,
                **{k: _finite(v["value"]) for k, v in compared.items()},
                "each": {k: v["each"] for k, v in compared.items()}}
        say("reading", cell=cell.name, **line)
        out.append(line)
        del pool, op, kept
    return out
