"""Dependency-free labeled metrics: Counter / Gauge / Histogram families.

The process-global :data:`REGISTRY` (re-exported as ``repro_torch.obs.REGISTRY``)
holds metric *families* — a name plus a fixed set of label names — whose
children are addressed by label values:

    obs.counter("plan_cache_lookups_total", kind="plan", outcome="hit").inc()
    obs.histogram("serve_execute_seconds", matrix_id=m, path=p).observe(dt)

Design constraints (docs/DESIGN.md §9):

* stdlib only — the serving hot path must not grow a dependency;
* near-zero cost when disabled (``set_enabled(False)``): every mutation
  checks one attribute and returns — the <2% serving-overhead budget is
  asserted in tests/test_obs.py;
* histograms use **fixed log-spaced buckets** (``DEFAULT_BUCKETS``: four
  per decade, 1 µs .. 100 s) so p50/p95/p99 estimates are mergeable
  across label sets and across processes without storing samples;
* bounded label cardinality: past ``MAX_CARDINALITY`` children per
  family, new label sets collapse into one ``_overflow`` child instead
  of growing without bound (a counter records the drops);
* ``snapshot()`` / ``Snapshot.diff`` let tests and benchmarks assert on
  deltas instead of absolute values, so suites compose;
* exporters to structured JSON (``to_json``) and Prometheus text format
  (``to_prometheus``) — the scrape surface the serving-fleet router's
  heartbeats will read.
"""
from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Dict, List, Optional, Tuple


class _State:
    """Process-global enable flag; one attribute read on every hot-path
    mutation (cheaper than a function call or an env probe)."""
    __slots__ = ("enabled",)

    def __init__(self):
        self.enabled = True


STATE = _State()


def set_enabled(flag: bool) -> bool:
    """Enable/disable every metric mutation and span; returns the previous
    state so callers can restore it (see :func:`disabled`)."""
    prev = STATE.enabled
    STATE.enabled = bool(flag)
    return prev


def enabled() -> bool:
    return STATE.enabled


class disabled:
    """``with obs.disabled(): ...`` — metrics off inside the block."""

    def __enter__(self):
        self._prev = set_enabled(False)
        return self

    def __exit__(self, *exc):
        set_enabled(self._prev)
        return False


def log_buckets(lo: float = 1e-6, hi: float = 100.0,
                per_decade: int = 4) -> Tuple[float, ...]:
    """Log-spaced histogram bucket upper bounds, ``per_decade`` per decade
    from ``lo`` to ``hi`` inclusive.  Fixed and shared (DEFAULT_BUCKETS)
    so histograms merge across label sets and processes."""
    n = int(round(math.log10(hi / lo) * per_decade))
    return tuple(lo * 10.0 ** (i / per_decade) for i in range(n + 1))


DEFAULT_BUCKETS = log_buckets()

# children per family before new label sets collapse into one overflow
# child — metric memory must stay bounded under per-request labels
MAX_CARDINALITY = 512
OVERFLOW_LABEL = "_overflow"


class Counter:
    """Monotonic counter.  ``inc`` honors the global enable flag;
    ``inc_always`` bypasses it (correctness probes like BUILD_COUNTS must
    count even when telemetry is off)."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0):
        if STATE.enabled:
            self.value += v

    def inc_always(self, v: float = 1.0):
        self.value += v

    def set_always(self, v: float):
        self.value = float(v)

    def sample(self) -> Dict:
        return {"value": self.value}


class Gauge:
    """Last-write-wins scalar."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float):
        if STATE.enabled:
            self.value = float(v)

    def inc(self, v: float = 1.0):
        if STATE.enabled:
            self.value += v

    def add(self, v: float):
        self.inc(v)

    def dec(self, v: float = 1.0):
        self.inc(-v)

    def sample(self) -> Dict:
        return {"value": self.value}


class Histogram:
    """Fixed-bucket histogram with quantile estimates.

    ``bounds`` are upper bucket edges; observations above the last bound
    land in an implicit +Inf bucket.  Quantiles interpolate geometrically
    inside the winning bucket (the buckets are log-spaced), so the
    estimate error is bounded by one bucket ratio (~1.78x for the default
    four-per-decade spacing) — plenty for latency SLO gating."""

    kind = "histogram"
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float):
        if not STATE.enabled:
            return
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def quantile(self, q: float) -> float:
        return quantile_from_counts(self.bounds, self.counts, self.count, q)

    def sample(self) -> Dict:
        return {"count": self.count, "sum": self.sum,
                "counts": list(self.counts),
                "p50": self.quantile(0.50), "p95": self.quantile(0.95),
                "p99": self.quantile(0.99)}


def quantile_from_counts(bounds, counts, total, q: float) -> float:
    """Quantile estimate from (bounds, per-bucket counts): geometric
    interpolation inside the winning bucket.  Shared by live histograms
    and merged/snapshotted samples (benchmarks/trajectory.py)."""
    if total <= 0:
        return 0.0
    target = q * total
    cum = 0
    for i, c in enumerate(counts):
        cum += c
        if cum >= target and c > 0:
            if i >= len(bounds):          # +Inf bucket: report last edge
                return bounds[-1]
            hi = bounds[i]
            lo = bounds[i - 1] if i > 0 else hi / 10.0
            frac = (target - (cum - c)) / c
            return lo * (hi / lo) ** frac
    return bounds[-1]


def merge_histogram_samples(samples: List[Dict],
                            bounds=DEFAULT_BUCKETS) -> Dict:
    """Fold histogram samples (same fixed buckets) into one: counts add,
    quantiles recomputed — how per-label latency series roll up into one
    service-level p50/p95/p99."""
    counts = [0] * (len(bounds) + 1)
    total, s = 0, 0.0
    for smp in samples:
        for i, c in enumerate(smp.get("counts", [])):
            if i < len(counts):
                counts[i] += c
        total += smp.get("count", 0)
        s += smp.get("sum", 0.0)
    return {"count": total, "sum": s, "counts": counts,
            "p50": quantile_from_counts(bounds, counts, total, 0.50),
            "p95": quantile_from_counts(bounds, counts, total, 0.95),
            "p99": quantile_from_counts(bounds, counts, total, 0.99)}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One metric name with a fixed label-name tuple and one child metric
    per observed label-value combination."""

    __slots__ = ("name", "kind", "help", "labelnames", "children",
                 "_buckets", "_lock", "dropped")

    def __init__(self, name: str, kind: str, labelnames: Tuple[str, ...],
                 help: str = "", buckets=None):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self.children: Dict[Tuple[str, ...], object] = {}
        self._buckets = tuple(buckets) if buckets else DEFAULT_BUCKETS
        self._lock = threading.Lock()
        self.dropped = 0              # label sets collapsed into overflow

    def _make(self):
        if self.kind == "histogram":
            return Histogram(self._buckets)
        return _KINDS[self.kind]()

    def labels(self, **labels):
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name!r} takes labels {self.labelnames}, "
                f"got {tuple(sorted(labels))}")
        key = tuple(str(labels[k]) for k in self.labelnames)
        child = self.children.get(key)
        if child is None:
            with self._lock:
                child = self.children.get(key)
                if child is None:
                    if len(self.children) >= MAX_CARDINALITY:
                        self.dropped += 1
                        key = tuple(OVERFLOW_LABEL
                                    for _ in self.labelnames)
                        child = self.children.get(key)
                        if child is None:
                            child = self._make()
                            self.children[key] = child
                    else:
                        child = self._make()
                        self.children[key] = child
        return child


class Snapshot:
    """Immutable-by-convention point-in-time copy of every family.

    ``data`` maps family name -> {kind, labelnames, series} where series
    maps a JSON-encoded label-value tuple -> metric sample.  Built either
    from a live registry (``MetricsRegistry.snapshot``) or from exported
    JSON (``Snapshot.from_json`` — the round-trip tests ride this)."""

    def __init__(self, data: Dict):
        self.data = data

    @staticmethod
    def key_of(labelnames, labels) -> str:
        return json.dumps([str(labels[k]) for k in labelnames])

    def value(self, name: str, **labels) -> float:
        """Counter/gauge value for an exact label set (0.0 if absent)."""
        fam = self.data.get(name)
        if fam is None:
            return 0.0
        smp = fam["series"].get(self.key_of(fam["labelnames"], labels))
        return 0.0 if smp is None else smp.get("value", 0.0)

    def hist(self, name: str, **labels) -> Optional[Dict]:
        fam = self.data.get(name)
        if fam is None:
            return None
        return fam["series"].get(self.key_of(fam["labelnames"], labels))

    def find(self, name: str, **subset) -> List[Tuple[Dict, Dict]]:
        """Every (labels, sample) of a family whose labels contain
        ``subset`` — the lookup tests and trajectory folding use when the
        full label set is not known in advance."""
        fam = self.data.get(name)
        if fam is None:
            return []
        names = fam["labelnames"]
        out = []
        for key, smp in fam["series"].items():
            labels = dict(zip(names, json.loads(key)))
            if all(labels.get(k) == str(v) for k, v in subset.items()):
                out.append((labels, smp))
        return out

    def total(self, name: str, **subset) -> float:
        """Sum of counter/gauge values across label sets matching
        ``subset``."""
        return sum(smp.get("value", 0.0)
                   for _, smp in self.find(name, **subset))

    def merged_hist(self, name: str, **subset) -> Dict:
        """All matching histogram series folded into one sample."""
        fam = self.data.get(name, {})
        bounds = fam.get("bounds", DEFAULT_BUCKETS)
        return merge_histogram_samples(
            [smp for _, smp in self.find(name, **subset)], bounds=bounds)

    def diff(self, old: "Snapshot") -> "Snapshot":
        """Delta snapshot: counters and histogram counts/sums subtract
        (absent-in-old means zero), gauges keep the new value (a gauge is
        a level, not a flow).  Series that did not move are kept with
        zero deltas so lookups stay total."""
        out: Dict = {}
        for name, fam in self.data.items():
            ofam = old.data.get(name, {"series": {}})
            series = {}
            for key, smp in fam["series"].items():
                osmp = ofam["series"].get(key)
                series[key] = _diff_sample(fam["kind"], smp, osmp)
            nf = {k: v for k, v in fam.items() if k != "series"}
            nf["series"] = series
            out[name] = nf
        return Snapshot(out)

    def to_json(self) -> str:
        return json.dumps(self.data, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Snapshot":
        return cls(json.loads(text))


def _diff_sample(kind: str, new: Dict, old: Optional[Dict]) -> Dict:
    if kind == "gauge" or old is None:
        return dict(new)
    if kind == "counter":
        return {"value": new["value"] - old["value"]}
    counts = [a - b for a, b in zip(new["counts"], old["counts"])]
    total = new["count"] - old["count"]
    return {"count": total, "sum": new["sum"] - old["sum"],
            "counts": counts,
            "p50": new["p50"], "p95": new["p95"], "p99": new["p99"]}


class MetricsRegistry:
    """Process-global family registry.  ``family`` is get-or-create and
    validates that a name is never reused with a different kind or label
    set; the ``counter``/``gauge``/``histogram`` conveniences return the
    child for the given label values directly."""

    def __init__(self):
        self._families: Dict[str, Family] = {}
        self._lock = threading.Lock()

    def family(self, name: str, kind: str, labelnames=(), help: str = "",
               buckets=None) -> Family:
        fam = self._families.get(name)
        if fam is None:
            with self._lock:
                fam = self._families.get(name)
                if fam is None:
                    fam = Family(name, kind, tuple(labelnames), help=help,
                                 buckets=buckets)
                    self._families[name] = fam
        if fam.kind != kind or fam.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind} with "
                f"labels {fam.labelnames}; requested {kind} with "
                f"{tuple(labelnames)}")
        return fam

    def counter(self, name: str, _help: str = "", **labels) -> Counter:
        return self.family(name, "counter", tuple(sorted(labels)),
                           help=_help).labels(**labels)

    def gauge(self, name: str, _help: str = "", **labels) -> Gauge:
        return self.family(name, "gauge", tuple(sorted(labels)),
                           help=_help).labels(**labels)

    def histogram(self, name: str, _help: str = "", _buckets=None,
                  **labels) -> Histogram:
        return self.family(name, "histogram", tuple(sorted(labels)),
                           help=_help, buckets=_buckets).labels(**labels)

    def families(self) -> Dict[str, Family]:
        return dict(self._families)

    def reset(self):
        """Drop every family (tests only — live handles into old families
        keep counting into detached objects)."""
        with self._lock:
            self._families = {}

    def snapshot(self) -> Snapshot:
        data: Dict = {}
        for name, fam in sorted(self._families.items()):
            series = {json.dumps(list(key)): child.sample()
                      for key, child in sorted(fam.children.items())}
            entry = {"kind": fam.kind, "labelnames": list(fam.labelnames),
                     "help": fam.help, "series": series}
            if fam.kind == "histogram":
                entry["bounds"] = list(fam._buckets)
            data[name] = entry
        return Snapshot(data)

    def to_json(self) -> str:
        """Structured JSON export (the snapshot's wire format)."""
        return self.snapshot().to_json()

    def to_prometheus(self) -> str:
        """Prometheus text exposition format: counters and gauges as one
        sample per label set, histograms as cumulative ``_bucket`` series
        plus ``_sum``/``_count``."""
        lines: List[str] = []
        for name, fam in sorted(self._families.items()):
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, child in sorted(fam.children.items()):
                base = _prom_labels(fam.labelnames, key)
                if fam.kind in ("counter", "gauge"):
                    lines.append(f"{name}{_brace(base)} "
                                 f"{_prom_num(child.value)}")
                    continue
                cum = 0
                for i, b in enumerate(child.bounds):
                    cum += child.counts[i]
                    le = base + [f'le="{_prom_num(b)}"']
                    lines.append(f"{name}_bucket{_brace(le)} {cum}")
                le = base + ['le="+Inf"']
                lines.append(f"{name}_bucket{_brace(le)} {child.count}")
                lines.append(f"{name}_sum{_brace(base)} "
                             f"{_prom_num(child.sum)}")
                lines.append(f"{name}_count{_brace(base)} {child.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _prom_escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _prom_labels(names, values) -> List[str]:
    return [f'{n}="{_prom_escape(v)}"' for n, v in zip(names, values)]


def _brace(parts: List[str]) -> str:
    return "{" + ",".join(parts) + "}" if parts else ""


def _prom_num(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


REGISTRY = MetricsRegistry()
