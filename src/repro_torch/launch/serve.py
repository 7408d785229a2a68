"""Serving launcher: batched decode with the continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --reduced --requests 8 --max-new 16 [--device cpu]

Every token-mode arch serves: the dense family, ``rwkv6-1.6b`` (ssm) and
``zamba2-7b`` (hybrid).  Weights are random, drawn from ``--seed`` on the
device (the card by default).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve
from repro_torch.models.transformer import build_model
from repro_torch.serve.engine import Request, ServingEngine


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def submit_traffic(engine: ServingEngine, cfg, requests: int, max_new: int,
                   temperature: float, seed: int) -> None:
    """``requests`` prompts of 4-11 random tokens in [2, vocab)."""
    rng = np.random.default_rng(seed)
    for i in range(requests):
        plen = int(rng.integers(4, 12))
        engine.submit(Request(
            uid=i, prompt=rng.integers(2, cfg.vocab, plen),
            max_new_tokens=max_new, temperature=temperature))


def main(argv=None):
    args = parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{cfg.name} has a stub frontend (embeds input); "
                         "serve the token-mode archs")
    dev = resolve(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = build_model(cfg, device=dev, generator=gen)
    engine = ServingEngine(model, max_slots=args.slots, max_len=args.max_len,
                           eos_id=1, seed=args.seed)
    t0 = time.perf_counter()
    submit_traffic(engine, cfg, args.requests, args.max_new,
                   args.temperature, args.seed)
    done = engine.run_until_drained()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {len(done)} requests, {tokens} tokens in {dt:.2f}s "
          f"({tokens / dt:.1f} tok/s) on {dev}")
    for r in done[:3]:
        print(f"  uid={r.uid} -> {r.out_tokens}")
    return done


if __name__ == "__main__":
    main()
