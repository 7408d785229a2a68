"""Production mesh descriptions and the card's roofline constants.

A mesh here is an axis-name-to-size description (:class:`MeshShape`): the
sharding rules (``models/sharding.py``), the dry-run and the roofline read
only its axes and sizes, as the JAX package's rules read only
``dict(mesh.shape)``.  It becomes a ``torch.distributed`` ``DeviceMesh``
(:meth:`MeshShape.device_mesh`) only when a process group of its size
exists.

Single pod: (data=16, model=16) = 256 devices.
Multi-pod:  (pod=2, data=16, model=16) = 512 devices; the ``pod`` axis
carries cross-pod data parallelism (its collectives cross the slower
inter-node links, which is why it is a separate axis).

The constants are the NVIDIA H100 SXM's, the card this port runs on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

from repro_torch.roofline.cost_model import HBM_BW


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Named mesh axes and their sizes, in mesh order."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} against {self.sizes}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """Devices in the mesh."""
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        return "x".join(str(s) for s in self.sizes)

    def device_mesh(self, device_type: str = "cuda"):
        """This mesh as a ``DeviceMesh`` over the initialized
        ``torch.distributed`` world, whose size must equal the mesh's."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        if not dist.is_initialized():
            raise ValueError("a DeviceMesh needs an initialized "
                             "torch.distributed group")
        world = dist.get_world_size()
        if world != self.size:
            raise ValueError(f"the group has {world} ranks, the mesh "
                             f"{self.size} devices")
        return init_device_mesh(device_type, self.sizes,
                                mesh_dim_names=self.axis_names)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_test_mesh(devices: int = 8, model: int = 2) -> MeshShape:
    """A small (data, model) mesh for the tests."""
    return MeshShape(("data", "model"), (devices // model, model))


# NVIDIA H100 SXM5 (data sheet) — the roofline's denominators per device;
# the measured HBM bandwidth is ``cost_model.calibrate(device).hbm_bw`` (a
# 1 GiB device-to-device copy on the card, the data sheet's on the CPU)
PEAK_FLOPS_BF16 = 989.4e12      # dense bf16 tensor-core FLOP/s
HBM_BW_DATA_SHEET = HBM_BW      # 3.35e12 bytes/s of HBM3
NVLINK_BW = 450e9               # bytes/s per direction (NVLink 4, 18 links)

