"""Environment provenance: which toolchain/devices produced a cached
tuning decision.

``environment_provenance()`` returns a small JSON-safe dict (torch and
CUDA version, backend, device kind/count, SM count, git SHA, python
version) that :class:`~repro_torch.core.tuner.PlanCache` stores next to
every entry — a cached winner measured on different hardware is
identifiable, and loading one increments the
``plan_cache_env_mismatch_total{field=...}`` warning counter (the git SHA
is recorded for identification but not treated as a mismatch: winners
stay valid across commits, not across device kinds).

The keys ``python``, ``git_sha``, ``backend``, ``device_kind`` and
``device_count`` are shared with the JAX package's record, so a plan
cache written by either package loads in the other; ``torch``, ``cuda``
and ``sm_count`` are this package's own.

torch is imported lazily and failure-tolerated so the obs package itself
stays dependency-free.
"""
from __future__ import annotations

import functools
import os
import platform
import subprocess
from typing import Dict, Optional

# env fields whose disagreement means the measurement environment changed
# (the git SHA deliberately excluded — see module docstring)
MISMATCH_FIELDS = ("torch", "backend", "device_kind", "device_count")


def _repo_root() -> Optional[str]:
    d = os.path.dirname(os.path.abspath(__file__))
    for _ in range(8):
        if os.path.isdir(os.path.join(d, ".git")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            return None
        d = parent
    return None


@functools.lru_cache(maxsize=1)
def git_sha() -> str:
    """Current commit SHA: ``REPRO_GIT_SHA`` env override (images without
    a .git dir), else ``git rev-parse HEAD``, else 'unknown'."""
    sha = os.environ.get("REPRO_GIT_SHA")
    if sha:
        return sha
    root = _repo_root()
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=root or os.getcwd(),
            capture_output=True, text=True, timeout=10)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return "unknown"


@functools.lru_cache(maxsize=1)
def environment_provenance() -> Dict[str, object]:
    info: Dict[str, object] = {
        "python": platform.python_version(),
        "git_sha": git_sha(),
    }
    try:
        import torch
    except ImportError:
        info.update({"torch": None, "cuda": None, "backend": None,
                     "device_kind": None, "device_count": None,
                     "sm_count": None})
        return info
    info["torch"] = torch.__version__
    info["cuda"] = torch.version.cuda
    if torch.cuda.is_available():
        props = torch.cuda.get_device_properties(0)
        info["backend"] = "cuda"
        info["device_kind"] = torch.cuda.get_device_name(0)
        info["device_count"] = torch.cuda.device_count()
        info["sm_count"] = int(props.multi_processor_count)
    else:
        info.update({"backend": "cpu", "device_kind": "cpu",
                     "device_count": 1, "sm_count": None})
    return info


def env_mismatches(recorded: Dict[str, object]) -> Dict[str, object]:
    """Fields of a recorded provenance dict that disagree with the
    current environment: ``{field: (recorded, current)}``."""
    cur = environment_provenance()
    out = {}
    for k in MISMATCH_FIELDS:
        if k in recorded and str(recorded[k]) != str(cur.get(k)):
            out[k] = (recorded[k], cur.get(k))
    return out
