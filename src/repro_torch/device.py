"""Device resolution for the port's entry points.

Every entry point (``SpmvOperator``, ``spmv``, ``cg_solve``,
``SpmvServingEngine``, ``LocalExecutor``, ``placement.*``) takes a
``device=`` argument that defaults to ``"cuda"``.  There is no global
default device and no quiet fallback: asking for the card on a machine
without one raises, and only a caller that passes ``device="cpu"`` (the
CPU test-suite does) runs the plain PyTorch versions of the kernels.

``time_fn`` is the steady-state timer both tuners measure with.
"""
from __future__ import annotations

import subprocess
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"

DeviceLike = Union[str, torch.device, None]


def resolve(device: DeviceLike = None) -> torch.device:
    """The validated ``torch.device`` for ``device`` (``None`` means the
    default, the card).  Raises ``RuntimeError`` when a CUDA device is
    requested and none is usable, ``ValueError`` for any other device
    type — the port runs on NVIDIA cards and, on request, on the CPU."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on an NVIDIA GPU by default and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the plain PyTorch versions on the host")
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"cuda:{index} requested, {torch.cuda.device_count()} "
                "device(s) visible")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} "
                         "(expected 'cuda' or 'cpu')")
    return dev


def sm_count(device: DeviceLike = None) -> int:
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError("sm_count needs a CUDA device")
    return int(torch.cuda.get_device_properties(dev).multi_processor_count)


def power_limit() -> Optional[str]:
    """The first card's name and power limit as ``nvidia-smi`` reports them
    (``"NVIDIA H100 80GB HBM3, 700.00 W"``), or None when the tool is
    missing or fails.  Every measured number is quoted beside this line:
    a card set below its maximum limit runs slower under load."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0 or not out.stdout.strip():
        return None
    return out.stdout.strip().splitlines()[0].strip()


def describe(device: DeviceLike = None) -> Dict[str, object]:
    """JSON-safe description of the resolved device."""
    dev = resolve(device)
    if dev.type == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": torch.cuda.device_count()}


def time_fn(fn: Callable, *args, warmup: int = 3, repeats: int = 10) -> float:
    """Median seconds of ``fn(*args)`` after ``warmup`` untimed calls (the
    first call binds and uploads).  When an argument is a CUDA tensor, CUDA
    events on its device bracket each timed call and the host waits on the
    end event, so a time is that of the finished device work; otherwise
    the host clock times each call."""
    dev = next((a.device for a in args
                if isinstance(a, torch.Tensor) and a.is_cuda), None)
    for _ in range(warmup):
        fn(*args)
    ts = []
    for _ in range(repeats):
        if dev is not None:
            with torch.cuda.device(dev):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn(*args)
            ts.append(time.perf_counter() - t0)
    return float(np.median(ts))
