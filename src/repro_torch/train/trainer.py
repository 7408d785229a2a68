"""Training loop with checkpoint/restart, failure recovery, and straggler
monitoring — the fleet-facing control plane.

Fault model (what happens at 1000+ nodes, and how each is handled here):

  * process crash / preemption   -> restart resumes from the latest atomic
    checkpoint; the data stream is a pure function of step, so resume is
    sample-exact;
  * transient step failure (bad host, flaky link) -> the step is retried
    from the last checkpoint up to ``max_retries`` times (fault injection
    hook in tests); a step writes nothing it is given, so the state a
    failed step started from stays usable (without a checkpoint directory
    the retry goes back to step 0 with it, as the reference's does);
  * stragglers -> per-step wall time EWMA + deviation; steps slower than
    ``straggler_sigma`` deviations are logged with their step index.  On a
    real fleet this signal feeds the controller that cordons the slow host
    — the detection logic is what can be built and tested here;
  * elastic restart -> checkpoints restore into a template on any device
    (checkpoint/ckpt.py), and the pipeline's shard_slice is device-count
    independent.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint import ckpt
from repro_torch.train.step import TrainState


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    ckpt_async: bool = False
    log_every: int = 10
    max_retries: int = 3
    straggler_ewma: float = 0.9
    straggler_sigma: float = 3.0


class StragglerMonitor:
    """EWMA mean/var of step wall-time; flags outlier steps.

    Guards against false positives: a warm-up period before any flagging
    (the EWMA variance starts near zero), and a relative floor — a step
    must exceed both mean + sigma·std AND rel_floor × mean to count (5%
    jitter on a tight distribution is not a straggler)."""

    WARMUP = 10

    def __init__(self, alpha: float, sigma: float,
                 rel_floor: float = 1.25):
        self.alpha = alpha
        self.sigma = sigma
        self.rel_floor = rel_floor
        self.mean = None
        self.var = 0.0
        self.count = 0
        self.flagged: List[Dict] = []

    def observe(self, step: int, dt: float) -> bool:
        self.count += 1
        if self.mean is None:
            self.mean = dt
            return False
        dev = dt - self.mean
        threshold = self.sigma * max(self.var, 1e-12) ** 0.5
        is_straggler = (self.count > self.WARMUP
                        and dev > threshold
                        and dt > self.rel_floor * self.mean)
        self.mean = self.alpha * self.mean + (1 - self.alpha) * dt
        self.var = self.alpha * self.var + (1 - self.alpha) * dev * dev
        if is_straggler:
            self.flagged.append({"step": step, "dt": dt,
                                 "mean": self.mean})
        return is_straggler


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_step: Callable,
                 pipeline, state: TrainState,
                 fault_hook: Optional[Callable[[int], None]] = None):
        """fault_hook(step) may raise to simulate a step failure (tests)."""
        self.cfg = cfg
        self.train_step = train_step
        self.pipeline = pipeline
        self.state = state
        self.fault_hook = fault_hook
        self.monitor = StragglerMonitor(cfg.straggler_ewma,
                                        cfg.straggler_sigma)
        self.history: List[Dict] = []

    # ---- checkpointing ----
    def _save(self, step: int, blocking: bool = True):
        if self.cfg.ckpt_dir:
            ckpt.save(self.cfg.ckpt_dir, step, self.state,
                      keep=self.cfg.ckpt_keep,
                      blocking=blocking or not self.cfg.ckpt_async)

    def try_restore(self) -> int:
        """Resume from the latest checkpoint if one exists; returns the
        step to start from."""
        if not self.cfg.ckpt_dir:
            return 0
        latest = ckpt.latest_step(self.cfg.ckpt_dir)
        if latest is None:
            return 0
        self.state = ckpt.restore(self.cfg.ckpt_dir, latest, self.state)
        return latest

    # ---- main loop ----
    def run(self, start_step: Optional[int] = None) -> TrainState:
        step = self.try_restore() if start_step is None else start_step
        retries = 0
        while step < self.cfg.total_steps:
            batch = self.pipeline.batch_at(step)
            t0 = time.perf_counter()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                new_state, metrics = self.train_step(self.state, batch)
                # materialize before trusting the step (surfacing the
                # card's asynchronous errors here, inside the retry scope)
                loss = float(metrics["loss"])
                if not np.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss at {step}")
            except Exception as e:  # noqa: BLE001 — fleet-style recovery
                retries += 1
                if retries > self.cfg.max_retries:
                    raise
                restored = self.try_restore()
                self.history.append({"step": step, "event": "retry",
                                     "error": repr(e),
                                     "restored_to": restored})
                step = restored
                continue
            retries = 0
            self.state = new_state
            dt = time.perf_counter() - t0
            self.monitor.observe(step, dt)
            if step % self.cfg.log_every == 0 or step == self.cfg.total_steps - 1:
                self.history.append({"step": step, "loss": loss, "dt": dt})
            step += 1
            if self.cfg.ckpt_dir and step % self.cfg.ckpt_every == 0:
                self._save(step, blocking=not self.cfg.ckpt_async)
        self._save(step, blocking=True)
        return self.state
