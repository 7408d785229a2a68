"""Batched serving demo on the PyTorch/CUDA port: continuous batching over
a small model with per-slot decode states, greedy + temperature sampling.

  PYTHONPATH=src python examples/torch_serve_batched.py --requests 6 \\
      [--device cuda]

Weights are random, drawn on the device from ``--seed``.  Even-numbered
requests decode greedily, odd ones sample at temperature 0.8 from the
engine's ``torch.Generator`` (a torch stream, not the JAX package's: the
greedy tokens are the ones that match it on equal weights).  ``--device
cpu`` runs on the host; the default is the card.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve
from repro_torch.models.transformer import build_model
from repro_torch.serve.engine import Request, ServingEngine


def requests_for(cfg, count: int, max_new: int):
    """The demo's traffic: prompts of 4-8 tokens in [2, vocab), greedy on
    even uids and temperature 0.8 on odd ones."""
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(2, cfg.vocab, 4 + i % 5),
                    max_new_tokens=max_new,
                    temperature=0.0 if i % 2 == 0 else 0.8)
            for i in range(count)]


def serve(model, cfg, count: int, max_new: int):
    """Serves :func:`requests_for`'s traffic through 3 slots; returns the
    finished requests by uid and the seconds it took."""
    engine = ServingEngine(model, max_slots=3, max_len=128, eos_id=1)
    t0 = time.perf_counter()
    for req in requests_for(cfg, count, max_new):
        engine.submit(req)
    done = engine.run_until_drained()
    return {r.uid: r for r in done}, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    cfg = get_config(args.arch, reduced=True)
    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(args.seed))
    done, dt = serve(model, cfg, args.requests, args.max_new)
    total = sum(len(r.out_tokens) for r in done.values())
    print(f"served {len(done)} requests / {total} tokens in {dt:.2f}s")
    for uid in sorted(done):
        print(f"  req{uid}: {done[uid].out_tokens}")
    return {"done": done, "tokens": total, "seconds": dt}


if __name__ == "__main__":
    main()
