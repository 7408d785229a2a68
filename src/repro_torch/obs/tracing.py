"""Nested wall-clock spans with a ring-buffer trace log.

``span(name, **labels)`` is a context manager:

    with obs.span("tune.measure", plan=plan.key()):
        t = measure(op, x)

On exit it appends a record to a bounded ring buffer (``trace()`` reads
it) carrying the duration, the nesting depth, the enclosing span's name,
and whether the block raised — exception-safe: the record is written and
the per-thread stack restored on the error path too, and the exception
propagates untouched.

Spans honor the global enable flag: disabled spans skip the clock, the
stack, and the ring entirely (one attribute read), which is what keeps
the serving hot path inside the <2% overhead budget.
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

from .metrics import STATE

DEFAULT_TRACE_CAPACITY = 4096

_trace = collections.deque(maxlen=DEFAULT_TRACE_CAPACITY)
_tls = threading.local()


def _stack() -> List["Span"]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class Span:
    """One timed block.  Created via :func:`span`; re-entrant use of a
    single instance is not supported (make a new one per block)."""

    __slots__ = ("name", "labels", "t0", "start", "depth", "parent",
                 "duration_s", "_live")

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.duration_s = None
        self._live = False

    def __enter__(self) -> "Span":
        if not STATE.enabled:
            return self
        st = _stack()
        self.depth = len(st)
        self.parent = st[-1].name if st else None
        st.append(self)
        self.start = time.time()
        self.t0 = time.perf_counter()
        self._live = True
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if not self._live:
            return False
        self.duration_s = time.perf_counter() - self.t0
        self._live = False
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        else:                         # unbalanced exit (enable flag moved
            while st and st[-1] is not self:   # mid-span): resync stack
                st.pop()
            if st:
                st.pop()
        _trace.append({
            "name": self.name, "labels": self.labels,
            "start": self.start, "duration_s": self.duration_s,
            "depth": self.depth, "parent": self.parent,
            "ok": exc_type is None,
            "error": (None if exc_type is None
                      else f"{exc_type.__name__}: {exc}"),
        })
        return False                  # never swallow the exception


def span(name: str, **labels) -> Span:
    """A new span context manager (see module docstring).  Label values
    are stringified into the trace record."""
    return Span(name, {k: str(v) for k, v in labels.items()})


def trace(name: Optional[str] = None) -> List[Dict]:
    """Snapshot of the ring buffer, oldest first; ``name`` filters."""
    recs = list(_trace)
    if name is not None:
        recs = [r for r in recs if r["name"] == name]
    return recs


def clear_trace():
    _trace.clear()


def set_trace_capacity(n: int):
    """Resize the ring buffer (keeps the newest records)."""
    global _trace
    _trace = collections.deque(_trace, maxlen=int(n))
