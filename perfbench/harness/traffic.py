"""The one traffic generator: blocks of right-hand sides from the seed.

A mix (``traffic/<name>.json``) gives ``rhs`` (the block width; 1 sends
vectors, more sends an (n, rhs) block through one SpMM per iteration),
``iters_per_set`` and ``rhs_pool``.  The pool and one warm-up block are
drawn on the card from ``--seed`` in one call, before the window; set j of
the window solves block j mod ``rhs_pool``.  Every seed gives the same
sizes and the same number of iterations, so the seed changes the numbers
and never the work.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

SEED_MOD = 1 << 64              # torch.Generator takes seeds below 2**64


def blocks(traffic: dict, n: int, seed: int, device, count: int = 0,
           dtype=torch.float32) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """(pool, warm): ``count`` (default ``rhs_pool``) blocks and one more
    for the warm-up set, standard normal in ``dtype`` (the configuration's
    precision) on ``device``."""
    count = count or int(traffic["rhs_pool"])
    nrhs = int(traffic["rhs"])
    shape = (count + 1, n) if nrhs == 1 else (count + 1, n, nrhs)
    g = torch.Generator(device=device).manual_seed(int(seed) % SEED_MOD)
    data = torch.randn(shape, generator=g, device=device,
                       dtype=dtype)
    return [data[i] for i in range(count)], data[count]
