"""Train a qwen-family model for a few hundred steps through the port's
whole training stack (pipeline -> train_step(remat, microbatches) ->
AdamW -> Trainer with checkpoints and the straggler monitor), on the card.

The default is a ~10M-weight reduced model; ``--full-100m`` trains a
~100M-weight one.  ``--device cpu`` runs it on the host.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 200 [--device cpu]
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch import tree
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import pipeline_for_model
from repro_torch.device import resolve
from repro_torch.models.transformer import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import init_train_state, make_train_step
from repro_torch.train.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full-100m", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve(args.device)

    cfg = get_config("qwen1.5-0.5b", reduced=True)
    if args.full_100m:
        cfg = dataclasses.replace(
            cfg, n_layers=12, d_model=768, n_heads=12, n_kv=12,
            head_dim=64, d_ff=2048, vocab=32000)     # ~100M params
    else:
        cfg = dataclasses.replace(
            cfg, n_layers=6, d_model=384, n_heads=6, n_kv=6,
            head_dim=64, d_ff=1024, vocab=8192)      # ~10M (CPU demo)

    model = build_model(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(args.seed))
    opt = AdamWConfig(lr_peak=3e-4, warmup_steps=args.steps // 10,
                      total_steps=args.steps)
    state = init_train_state(model, opt)
    n = sum(p.numel() for p in tree.leaves(state.params))
    print(f"params: {n/1e6:.1f}M on {dev}")

    pipe = pipeline_for_model(cfg, global_batch=args.batch,
                              seq_len=args.seq, seed=args.seed, device=dev)
    step = make_train_step(model, opt, microbatches=2, remat="full")
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(TrainerConfig(total_steps=args.steps, ckpt_dir=d,
                                   ckpt_every=max(50, args.steps // 4),
                                   log_every=10),
                     step, pipe, state)
        tr.run()
    losses = [(h["step"], h["loss"]) for h in tr.history if "loss" in h]
    for h in tr.history:
        if "loss" in h:
            print(f"step {h['step']:4d}  loss {h['loss']:.4f}  "
                  f"{h['dt']*1e3:.0f} ms")
    first, last = losses[0][1], losses[-1][1]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return {"params": n, "losses": losses, "trainer": tr}


if __name__ == "__main__":
    main()
