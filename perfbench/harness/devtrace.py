"""Reduce a ``torch.profiler`` trace of the traced slice to device times.

The slice is a ``record_function("perfbench.slice")`` range; every call of
the operator inside it is a ``record_function("perfbench.product")``
range, opened by the benchmark's own wrapper.  A device activity (kernel,
copy or fill) belongs to the product when the host call that launched it
lies inside a product range.  The launch is found through the activity's
``correlation`` id, which the runtime or driver call that launched it
carries too.  An activity in the slice whose launch is not in the trace
cannot be placed: the reduction then raises ``UnmatchedActivity`` and
reads nothing, rather than count it on either side.

Only the chrome-trace export is read, the format every ``torch.profiler``
writes; times there are microseconds on one clock for host and device.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

PRODUCT = "perfbench.product"
SLICE = "perfbench.slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")
TOP = 10
NAME_CHARS = 120            # a kernel's name in the breakdown, cut to this


def short(name: str) -> str:
    """A device op's name for the breakdown: no ``void`` and at most
    NAME_CHARS characters (template arguments run to thousands)."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


class UnmatchedActivity(ValueError):
    """Device activity in the slice whose launch the trace does not hold."""


@dataclasses.dataclass
class DeviceSlice:
    window_s: float                 # length of the traced slice
    busy_s: float                   # union of device activity inside it
    product_calls: int
    product_device_s: float         # device time launched from products
    other_device_s: float           # the rest of the device time
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


class _Ranges:
    """Sorted, non-overlapping [start, end] ranges, searched by bisection."""

    def __init__(self, ranges: Sequence[Tuple[float, float]]):
        self.ranges = sorted(ranges)
        self.starts = [r[0] for r in self.ranges]

    def __len__(self):
        return len(self.ranges)

    def contains(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ranges[i][1]


def _span(ev) -> Tuple[float, float]:
    ts = float(ev["ts"])
    return ts, ts + float(ev.get("dur", 0.0))


def _merge(intervals: List[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_label(host: List[Tuple[float, float, str]],
                starts: List[float], t: float) -> str:
    """The innermost host event running at ``t``: of nested events, the
    covering one that started last.  ``python`` where the host ran no
    recorded op."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 256), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "python"


def reduce(trace: Dict) -> Optional[DeviceSlice]:
    """The slice's device times, or None where the trace holds no slice or
    no device activity inside it (a CPU run, or a profiler that saw no
    device).  Raises ``UnmatchedActivity`` where an activity's launch is
    not found by its correlation id."""
    events = trace.get("traceEvents", trace if isinstance(trace, list)
                       else [])
    events = [ev for ev in events if ev.get("ph") == "X" and "ts" in ev]
    slices = [_span(ev) for ev in events
              if ev.get("name") == SLICE and ev.get("cat") in HOST_CATS]
    if not slices:
        return None
    t0, t1 = slices[0]
    products = _Ranges([_span(ev) for ev in events
                        if ev.get("name") == PRODUCT
                        and ev.get("cat") in HOST_CATS])
    launches: Dict[object, float] = {}
    host: List[Tuple[float, float, str]] = []
    for ev in events:
        cat = ev.get("cat")
        args = ev.get("args") or {}
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = float(ev["ts"])
        elif cat in HOST_CATS and ev.get("name") != SLICE:
            s, e = _span(ev)
            host.append((s, e, ev.get("name", "?")))
    host.sort()

    device = [ev for ev in events if ev.get("cat") in DEVICE_CATS
              and t0 <= float(ev["ts"]) <= t1]
    if not device:
        return None
    unmatched = [ev for ev in device if (ev.get("args") or {}).get(
        "correlation") not in launches]
    if unmatched:
        raise UnmatchedActivity(
            f"{len(unmatched)} of {len(device)} device activities in the "
            f"traced slice have no launch with their correlation id (first: "
            f"{short(unmatched[0].get('name', '?'))})")
    prod_s = other_s = 0.0
    by_name: Dict[str, float] = collections.defaultdict(float)
    intervals = []
    for ev in device:
        args = ev.get("args") or {}
        s, e = _span(ev)
        e = min(e, t1)
        dur_s = (e - s) / 1e6
        intervals.append((s, e))
        by_name[short(ev.get("name", "?"))] += dur_s
        if products.contains(launches[args["correlation"]]):
            prod_s += dur_s
        else:
            other_s += dur_s

    busy = _merge(intervals)
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps: Dict[str, float] = collections.defaultdict(float)
    starts = [h[0] for h in host]
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for i in range(0, len(edges), 2):
        gs, ge = edges[i], edges[i + 1]
        if ge > gs:
            gaps[_host_label(host, starts, (gs + ge) / 2)] += (ge - gs) / 1e6
    return DeviceSlice(
        window_s=(t1 - t0) / 1e6, busy_s=busy_s,
        product_calls=len(products), product_device_s=prod_s,
        other_device_s=other_s,
        device_ops=sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
        idle_gaps=sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP])
