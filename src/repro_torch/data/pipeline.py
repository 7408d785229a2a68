"""Deterministic, resumable, shard-aware synthetic data pipeline.

The batch at step ``t`` is a pure function of (seed, t) — a counted
random stream.  That makes checkpoint/restart exact (restoring ``step``
restores the stream; no iterator state to save) and elastic restarts
trivial (a host computes exactly its shard of any step's batch).

The JAX package draws from ``jax.random.fold_in``, which this package does
not import, so the port's stream is its own: a ``torch.Generator`` on the
CPU seeded from (seed, step) through ``numpy.random.SeedSequence``, the
batch made there and then moved to the pipeline's device, so the host and
the card see the same batches.  The marginal is the reference's Zipf-ish
``min(int(u**4 * vocab), vocab - 1)``; the parity tests feed the
reference's batches to both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    input_mode: str = "tokens"     # tokens | embeds
    d_model: int = 0               # for embeds mode
    dtype: str = "bfloat16"


def _generator(*entropy: int) -> torch.Generator:
    seed = np.random.SeedSequence(list(entropy)).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device="cpu").manual_seed(int(seed))


class TokenPipeline:
    def __init__(self, cfg: PipelineConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve(device)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """Global batch for a step (pure function of step): ``targets``
        (B, S) int32 and ``inputs``, token ids (B, S) int32 or frontend
        embeddings (B, S, d_model)."""
        c = self.cfg
        g = _generator(c.seed, step)
        # Zipf-ish marginal: exponentiate a uniform to concentrate mass
        u = torch.rand((c.global_batch, c.seq_len + 1), generator=g)
        tokens = (u ** 4.0 * c.vocab).to(torch.int32).clamp(max=c.vocab - 1)
        batch = {"targets": tokens[:, 1:]}
        if c.input_mode == "tokens":
            batch["inputs"] = tokens[:, :-1]
        else:
            dt = torch.bfloat16 if c.dtype == "bfloat16" else torch.float32
            batch["inputs"] = torch.randn(
                (c.global_batch, c.seq_len, c.d_model),
                generator=_generator(c.seed, step, 1)).to(dt)
        return {k: v.contiguous().to(self.device) for k, v in batch.items()}

    def shard_slice(self, step: int, shard: int, num_shards: int
                    ) -> Dict[str, torch.Tensor]:
        """The rows of step ``step`` owned by data shard ``shard`` — what a
        multi-host deployment feeds each host (identical content regardless
        of num_shards, so elastic restarts keep the stream)."""
        b = self.cfg.global_batch
        if b % num_shards:
            raise ValueError(f"batch {b} does not split into {num_shards} "
                             "shards")
        lo = b // num_shards * shard
        hi = lo + b // num_shards
        return {k: v[lo:hi] for k, v in self.batch_at(step).items()}


def pipeline_for_model(cfg, global_batch: int, seq_len: int, seed: int = 0,
                       device: DeviceLike = None) -> TokenPipeline:
    """Build a pipeline matching a ModelConfig (handles embeds-mode stubs)."""
    return TokenPipeline(PipelineConfig(
        vocab=cfg.vocab, global_batch=global_batch, seq_len=seq_len,
        seed=seed, input_mode=cfg.input_mode, d_model=cfg.d_model,
        dtype=cfg.dtype), device=device)
