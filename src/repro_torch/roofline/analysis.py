"""Roofline analysis per (arch × shape × mesh), in seconds, with the card's
denominators (``launch/mesh.py``: NVIDIA H100 SXM):

  compute    = flops per device            / 989.4 TFLOP/s (dense bf16)
  memory     = bytes per device            / HBM bandwidth (measured on
               the card by ``cost_model.calibrate``, 3.35 TB/s on the CPU)
  collective = collective bytes per device / 450 GB/s (NVLink, one
               direction)

The JAX package fills the first two from compiled HLO (``hlo_flops``,
``hlo_bytes``: per-device totals of the partitioned module) and the third
from its collective instructions.  The port keeps the record's keys; what
fills them (ROADMAP C40):

  hlo_flops         flops per device that ran: ``op_cost.analyze_fn``'s
                    FlopCounterMode count, or, in the meta-device dry-run,
                    the traced step's (``roofline/trace.py``) over the
                    model axis;
  hlo_bytes         bytes per device: the call's inputs and outputs
                    (``analyze_fn``), or the dry-run's traced bytes
                    accessed over the model axis;
  collective_bytes  what the port's collectives recorded
                    (``obs.collectives``), None where nothing ran.

A dry-run cell that was not traced has no ``hlo_flops`` / ``hlo_bytes``;
its terms, bottleneck and useful ratio stay None.

MODEL_FLOPS (6·N·D train, 2·N·D inference; N = active params for MoE)
gives the useful-work ratio — remat recompute shows up as counted flops
above MODEL_FLOPS.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.launch.mesh import (HBM_BW_DATA_SHEET, NVLINK_BW,
                                     PEAK_FLOPS_BF16)


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: Optional[float]
    hlo_bytes: Optional[float]
    collective_bytes: Optional[float]
    model_flops: float
    compute_s: Optional[float] = 0.0
    memory_s: Optional[float] = 0.0
    collective_s: Optional[float] = 0.0
    bottleneck: Optional[str] = ""
    useful_ratio: Optional[float] = 0.0
    bytes_per_device: Optional[float] = 0.0
    collectives: Optional[dict] = None

    def finalize(self, hbm_bw: float = HBM_BW_DATA_SHEET):
        if self.hlo_flops is None or self.hlo_bytes is None:
            self.compute_s = self.memory_s = self.collective_s = None
            self.bottleneck = self.useful_ratio = None
            self.bytes_per_device = None
            return self
        self.compute_s = self.hlo_flops / PEAK_FLOPS_BF16
        self.memory_s = self.hlo_bytes / hbm_bw
        self.collective_s = (None if self.collective_bytes is None
                             else self.collective_bytes / NVLINK_BW)
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        terms = {k: v for k, v in terms.items() if v is not None}
        self.bottleneck = max(terms, key=terms.get)
        self.useful_ratio = (self.model_flops / max(1.0, self.hlo_flops
                                                    * self.chips))
        self.bytes_per_device = self.hlo_bytes
        return self

    def to_dict(self):
        return dataclasses.asdict(self)


def model_flops(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (inference) with N = active params."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.batch * shape.seq
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.batch * shape.seq
        return 2.0 * n * tokens
    # decode: one token per sequence
    return 2.0 * n * shape.batch


def analyze(arch: str, shape, mesh_name: str, chips: int, costs, cfg,
            hbm_bw: float = HBM_BW_DATA_SHEET) -> Roofline:
    """The three terms from an ``op_cost.Costs`` of one device's step
    (``analyze_fn``), beside ``model_flops``."""
    r = Roofline(arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
                 hlo_flops=costs.flops, hlo_bytes=costs.bytes,
                 collective_bytes=costs.collective_bytes,
                 model_flops=model_flops(cfg, shape),
                 collectives=dict(costs.collectives))
    return r.finalize(hbm_bw)

