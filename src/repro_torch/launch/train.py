"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
      --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt \
      [--device cpu]

Weights are random, drawn from ``--seed`` on the device (the card by
default; ``--device cpu`` runs on the host).  Full configs need the card's
memory for their weights, AdamW moments and activations; ``--reduced``
runs the family-preserving small config.  Prints the parameter count, one
JSON line per history entry and any flagged stragglers.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import pipeline_for_model
from repro_torch.device import resolve
from repro_torch.models.transformer import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Trainer:
    args = parse_args(argv)
    dev = resolve(args.device)
    cfg = get_config(args.arch, reduced=args.reduced)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = build_model(cfg, device=dev, generator=gen)
    opt_cfg = AdamWConfig(lr_peak=args.lr, warmup_steps=args.steps // 10,
                          total_steps=args.steps)
    state = init_train_state(model, opt_cfg)
    n_params = sum(p.numel() for p in tree.leaves(state.params))
    print(f"[train] {cfg.name} ({'reduced' if args.reduced else 'full'}): "
          f"{n_params:,} params on {dev}")

    pipe = pipeline_for_model(cfg, global_batch=args.batch,
                              seq_len=args.seq, seed=args.seed, device=dev)
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches,
                              remat=args.remat)
    trainer = Trainer(
        TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every, log_every=10),
        step_fn, pipe, state)
    trainer.run()
    for h in trainer.history:
        print(json.dumps(h))
    if trainer.monitor.flagged:
        print(f"[train] stragglers flagged: {trainer.monitor.flagged}")
    return trainer


if __name__ == "__main__":
    main()
