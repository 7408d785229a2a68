"""Operation counts of what torch runs — the port's counterpart of the JAX
package's ``roofline/hlo_cost.py``.

The JAX package re-derives flops, bytes and collective bytes from compiled
XLA HLO text (trip-count aware, since its layer stacks are ``lax.scan``
loops).  torch produces no HLO (ROADMAP C40), so here:

  * flops come from ``torch.utils.flop_counter.FlopCounterMode`` around a
    call of the function: every matmul, convolution and attention op that
    runs is counted, once per time it runs — a Python loop over layers
    counts each iteration, and a recomputation (remat's second forward)
    counts when the backward runs it inside the counted call;
  * bytes are those of the call's inputs and outputs (each tensor once),
    the traffic a fused step could not avoid — not the per-op traffic
    XLA's "bytes accessed" sums;
  * collective bytes are what the port's own collectives record while the
    call runs (``obs.collectives``): per kind, their count and bytes.

The function runs for real: on meta tensors it costs no memory and no
time, and FlopCounterMode counts the same formulas.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.obs import collectives


@dataclasses.dataclass
class Costs:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collectives: Dict[str, Dict[str, float]] = None
    flops_by_op: Dict[str, float] = None

    def __post_init__(self):
        if self.collectives is None:
            self.collectives = collective_stats([])
        if self.flops_by_op is None:
            self.flops_by_op = {}


def _tensors(obj):
    """Every tensor in nested dicts, lists, tuples and dataclasses."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def _bytes(obj) -> int:
    seen, total = set(), 0
    for t in _tensors(obj):
        key = id(t)
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


def collective_stats(log) -> Dict[str, Dict[str, float]]:
    """Per-kind {count, bytes} of a collective recording
    (``obs.collectives.recording``)."""
    return {k: {"count": float(v["count"]), "bytes": float(v["bytes"])}
            for k, v in collectives.by_kind(log).items()}


def analyze_fn(fn, *args, **kwargs) -> Costs:
    """Run ``fn(*args, **kwargs)`` once under FlopCounterMode and a
    collective recording; its flops, the bytes of its inputs and outputs,
    and its collectives."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with collectives.recording() as log, counter:
        out = fn(*args, **kwargs)
    by_op = {str(op): float(n) for op, n in
             counter.get_flop_counts().get("Global", {}).items()}
    stats = collective_stats(log)
    return Costs(flops=float(counter.get_total_flops()),
                 bytes=float(_bytes(list(args) + list(kwargs.values()))
                             + _bytes(out)),
                 collective_bytes=sum(v["bytes"] for v in stats.values()),
                 collectives=stats, flops_by_op=by_op)
