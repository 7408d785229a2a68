#!/usr/bin/env python3
"""The port's own ranges and counters, read on one benchmark cell.

    python3 tools/trace_ranges_probe.py --workload hpcg-pencil56.cg1 \
        [--seed 0] [--seconds 10] [--slices 2]

Sets the cell up as ``perfbench/run.py`` does (``runner.set_up``: the
engine's default plan, its executor, the cell's blocks) and warms it up,
then:

* a window of closed-loop CG sets with the profiler off: ``cg_iter_ms``
  on the host clock, and from the deltas of the ``solver_*`` counters
  ``sync_wait_ms`` (host seconds blocked in the residual readback per
  iteration) and ``host_issue_ms`` (the rest of the solve's host seconds
  per iteration);
* ``--slices`` pairs of traced slices of the benchmark's length under
  ``torch.profiler`` (each operator call inside the benchmark's
  ``perfbench.product`` range, as its traced runs have it), bridged and
  not bridged in turns (bridged, plain, plain, bridged, ...): not bridged,
  the program's ranges see no profiler.  Host ms per iteration of each
  kind is the bridge's cost under the profiler;
* from the first bridged slice's chrome trace: the count of each program
  range, host (``user_annotation``) and device timeline
  (``gpu_user_annotation``), and the device time of the activities whose
  launch lies inside each range, matched by correlation id as
  ``perfbench/harness/devtrace.py`` places the product; per operator call
  for the product's parts (``accumulate_ms``), per iteration for the
  solver's.

Needs one NVIDIA GPU; ``--device cpu --grid NX NY NZ`` rehearses it on
the host at a small grid.  Prints one JSON line, with the card's name
and power limit.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

RANGES = ("solver.iteration", "solver.residual_sync", "spmv.product",
          "spmv.accumulate")
PER_CALL = ("spmv.product", "spmv.accumulate")


def _range_device_s(trace: dict):
    """(count of each program range on the host and on the device
    timeline, device seconds launched inside each) over the slice."""
    from perfbench.harness import devtrace
    events = [e for e in trace["traceEvents"]
              if e.get("ph") == "X" and "ts" in e]
    t0, t1 = next(devtrace._span(e) for e in events
                  if e.get("name") == devtrace.SLICE
                  and e.get("cat") in devtrace.HOST_CATS)
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in devtrace.LAUNCH_CATS
                and "correlation" in (e.get("args") or {})}
    spans = collections.defaultdict(list)
    counts = {n: {"host": 0, "device_timeline": 0} for n in RANGES}
    for e in events:
        name = e.get("name")
        if name not in counts:
            continue
        if e.get("cat") == "user_annotation":
            counts[name]["host"] += 1
            spans[name].append(devtrace._span(e))
        elif e.get("cat") == "gpu_user_annotation":
            counts[name]["device_timeline"] += 1
    merged = {n: devtrace._merge(s) for n, s in spans.items()}
    starts = {n: [s for s, _ in iv] for n, iv in merged.items()}
    dev_s = dict.fromkeys(RANGES, 0.0)
    for e in events:
        if e.get("cat") not in devtrace.DEVICE_CATS:
            continue
        if not t0 <= float(e["ts"]) <= t1:
            continue
        t = launches[e["args"]["correlation"]]
        s, end = devtrace._span(e)
        for n, iv in merged.items():
            i = bisect.bisect_right(starts[n], t) - 1
            if i >= 0 and t <= iv[i][1]:
                dev_s[n] += (min(end, t1) - s) / 1e6
    return counts, dev_s


class _NoBridge:
    """The profiler module as the program's ranges see it with the bridge
    off: never recording."""
    _is_profiler_enabled = False


def _slice(op, pool, ad, iters, n_sets, device, keep: bool):
    """One traced slice; (host seconds, iterations, trace or None)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from perfbench.harness import devtrace, runner
    import torch
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    op.reset()
    op.annotate = True
    with profile(activities=acts) as prof:
        with record_function(devtrace.SLICE):
            t = time.perf_counter()
            _, total, _ = runner._solve_sets(op, pool, ad, iters, 0.0,
                                             max_sets=n_sets)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            host_s = time.perf_counter() - t
    op.annotate = False
    trace = None
    if keep:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
    return host_s, total, trace


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--slices", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, nargs=3, default=None)
    args = ap.parse_args()
    import torch
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("needs one NVIDIA GPU (or --device cpu --grid ...)",
              file=sys.stderr)
        return 1
    from perfbench.harness import devtrace, runner, spec, traffic
    from repro_torch import obs
    from repro_torch.obs import tracing

    cell = spec.load_cell(args.workload)
    if args.grid:
        cell = dataclasses.replace(cell, config=dict(
            cell.config, grid=list(args.grid),
            name="probe-" + cell.config["name"]))
    tr = cell.traffic
    iters = int(tr["iters_per_set"])
    system = runner.set_up(cell, device)
    pool, warm = traffic.blocks(tr, system.arrays["n"], args.seed, device,
                                dtype=system.ad.dtype)
    op = runner.TimedOperator(system.op, None)
    runner._solve_sets(op, [warm], system.ad, iters, 0.0, max_sets=1)
    runner._sync(device)

    before = obs.snapshot()
    w0 = time.perf_counter()
    sets, total, _ = runner._solve_sets(op, pool, system.ad, iters,
                                        w0 + args.seconds)
    window_s = time.perf_counter() - w0
    d = obs.snapshot().diff(before)
    n_it = d.value("solver_iterations_total", solver="cg")
    sync_s = d.value("solver_sync_seconds_total", solver="cg")
    solve_s = d.value("solver_seconds_total", solver="cg")
    line = {
        "cell": cell.name, "seed": args.seed, "plan": system.op.plan.key(),
        "window": {"sets": sets, "iterations": total,
                   "counted_iterations": n_it,
                   "cg_iter_ms": window_s / total * 1e3,
                   "sync_wait_ms": sync_s / n_it * 1e3,
                   "host_issue_ms": (solve_s - sync_s) / n_it * 1e3}}

    n_sets = -(-runner.TRACE_ITERS // iters)
    host = {"bridged": [], "plain": []}
    kept = None
    real = tracing._profiler
    for i in range(args.slices):
        for bridged in ((True, False) if i % 2 == 0 else (False, True)):
            tracing._profiler = real if bridged else _NoBridge
            try:
                s, it, trace = _slice(op, pool, system.ad, iters, n_sets,
                                      device, keep=bridged and kept is None)
            finally:
                tracing._profiler = real
            host["bridged" if bridged else "plain"].append(s / it * 1e3)
            if trace is not None:
                kept = trace
    line["slice_host_ms_per_iteration"] = host

    counts, dev_s = _range_device_s(kept)
    reduced = devtrace.reduce(kept)
    calls = reduced.product_calls if reduced else counts[
        "spmv.product"]["host"]
    slice_iters = n_sets * iters
    line["ranges"] = counts
    line["range_device_ms"] = {
        n: dev_s[n] / (calls if n in PER_CALL else slice_iters) * 1e3
        for n in RANGES}
    line["accumulate_ms"] = line["range_device_ms"]["spmv.accumulate"]
    if reduced is not None:
        line["product_ms"] = reduced.product_device_s / calls * 1e3
        line["vector_ms"] = reduced.other_device_s / slice_iters * 1e3
        line["device_idle_frac"] = 1 - reduced.busy_s / reduced.window_s
        line["idle_gaps"] = reduced.idle_gaps
    if device.type == "cuda":
        from repro_torch import device as device_mod
        line["card"] = device_mod.power_limit()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
