"""Bytes the port's own collectives put on the wire, recorded per kind.

The JAX package reads its collectives' bytes off compiled HLO text; torch
compiles none, so each collective of the port records itself where it runs:
``optim.compress.compressed_psum`` (all-reduce), ``train.pipeline.
pipeline_apply``'s hand-offs (send-recv) and its collection of the outputs
(all-reduce), and ``core.distributed.MeshProduct``'s combine (all-reduce,
reduce-scatter, all-gather, send-recv).  An emulated mesh moves no bytes
between devices: it records what each shard would put on the wire.

    with collectives.recording() as rec:
        compressed_psum(trees, mesh, "bfloat16")
    roofline.op_cost.collective_stats(rec)   # {kind: {count, bytes}}

Nothing is kept while no recording is open.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "send-recv")

_OPEN: List[List[dict]] = []


def record(kind: str, nbytes: int) -> None:
    """One collective of ``kind`` moving ``nbytes`` per shard."""
    if not _OPEN:
        return
    if kind not in KINDS:
        raise ValueError(f"collective kind {kind!r} not in {KINDS}")
    entry = {"kind": kind, "bytes": int(nbytes)}
    for log in _OPEN:
        log.append(entry)


@contextlib.contextmanager
def recording():
    """Collects every :func:`record` call made inside the block into the
    list it yields (nested recordings each see them all)."""
    log: List[dict] = []
    _OPEN.append(log)
    try:
        yield log
    finally:
        _OPEN.remove(log)


def by_kind(log) -> Dict[str, Dict[str, int]]:
    """{kind: {"count", "bytes"}} of a recording, every kind present."""
    stats = {k: {"count": 0, "bytes": 0} for k in KINDS}
    for e in log:
        stats[e["kind"]]["count"] += 1
        stats[e["kind"]]["bytes"] += e["bytes"]
    return stats
