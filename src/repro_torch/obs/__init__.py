"""repro_torch.obs — metrics + tracing spine (stdlib, and torch's profiler).

One process-global :data:`REGISTRY` of labeled Counter/Gauge/Histogram
families, nested wall-clock :func:`span`\\ s with a ring-buffer trace log,
JSON + Prometheus exporters, and a ``snapshot()/diff`` API so tests and
benchmarks assert on deltas.  ``obs.collectives`` records the bytes the
port's own collectives put on the wire.  See docs/DESIGN.md §9 for the metric-name
table and label conventions.

Quickstart::

    from repro_torch import obs
    obs.counter("requests_total", matrix_id=mid).inc()
    with obs.span("serve.tick"):
        ...
    with obs.trace_range("solver.iteration"):   # profiler-only, hot path
        ...
    obs.histogram("serve_execute_seconds", path="kernel").observe(dt)
    print(obs.to_prometheus())

``REPRO_METRICS=1`` in the environment installs an atexit hook that
prints the full Prometheus-text snapshot on process exit — the zero-code
way to see what a run did (used by the examples and the acceptance
check).  ``set_enabled(False)`` turns every mutation and span into a
near-free no-op (the <2% serving hot-path budget).
"""
from __future__ import annotations

import atexit
import os
import sys

from .metrics import (DEFAULT_BUCKETS, MAX_CARDINALITY, OVERFLOW_LABEL,
                      STATE, Counter, Family, Gauge, Histogram,
                      MetricsRegistry, REGISTRY, Snapshot, disabled,
                      enabled, log_buckets, merge_histogram_samples,
                      quantile_from_counts, set_enabled)
from .provenance import (MISMATCH_FIELDS, env_mismatches,
                         environment_provenance, git_sha)
from .tracing import (Span, clear_trace, set_trace_capacity, span, trace,
                      trace_range)


def counter(name: str, _help: str = "", **labels) -> Counter:
    """Counter child of the global registry for these label values."""
    return REGISTRY.counter(name, _help=_help, **labels)


def gauge(name: str, _help: str = "", **labels) -> Gauge:
    return REGISTRY.gauge(name, _help=_help, **labels)


def histogram(name: str, _help: str = "", _buckets=None,
              **labels) -> Histogram:
    return REGISTRY.histogram(name, _help=_help, _buckets=_buckets,
                              **labels)


def snapshot() -> Snapshot:
    return REGISTRY.snapshot()


def to_json() -> str:
    return REGISTRY.to_json()


def to_prometheus() -> str:
    return REGISTRY.to_prometheus()


def _truthy(v: str) -> bool:
    return v.strip().lower() not in ("", "0", "false", "no", "off")


def _dump_at_exit():
    sys.stdout.write(to_prometheus())
    sys.stdout.flush()


if _truthy(os.environ.get("REPRO_METRICS", "")):
    atexit.register(_dump_at_exit)
