"""Atomic, resumable checkpoints in the JAX package's layout.

Layout (the reference's, so a checkpoint written by either package
restores in the other):
  <dir>/step_000000123.tmp-<nonce>/  (written, then atomically renamed)
      manifest.json                  (step, keys, dtypes, shapes)
      arrays.npz                     (uncompressed, ``a<i>`` per leaf)
  <dir>/step_000000123/

Keys are the leaves' paths joined by ``/`` in the reference's order
(``repro_torch.tree``: ``params/layers/attn/wq``, ``opt/step``,
``opt/m/...``, ``opt/v/...``, ``step`` for a ``TrainState``).  A bf16 leaf
is stored as 2-byte void with manifest dtype ``"bfloat16"``, which the
reference views back as ``ml_dtypes.bfloat16`` and this module as
``uint16`` bits, then ``torch.bfloat16``.

Properties:
  * atomicity — a crash mid-write never corrupts the latest checkpoint
    (tmp dir + rename; readers only see complete renames);
  * keep-k garbage collection, and orphaned tmp dirs removed;
  * restore into a template — each array goes to its template tensor's
    device and dtype, so a restart may use another device;
  * async save — the device-to-host copy happens in the caller, the write
    on a worker thread while training continues.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import uuid
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree

_STEP_RE = re.compile(r"^step_(\d+)$")


def _paths(state):
    pairs = tree.flatten_with_paths(state)
    return ["/".join(path) for path, _ in pairs], [leaf for _, leaf in pairs]


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)     # a snapshot, also on the host
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def save(directory: str, step: int, state, keep: int = 3,
         blocking: bool = True):
    """Write ``state`` as step ``step``; returns the checkpoint's path, or
    with ``blocking=False`` the started writer thread."""
    os.makedirs(directory, exist_ok=True)
    keys, leaves = _paths(state)
    host = [_to_host(leaf) for leaf in leaves]       # the device-to-host copy
    manifest = {"step": step, "keys": keys,
                "dtypes": [_dtype_name(leaf) for leaf in leaves],
                "shapes": [list(a.shape) for a in host]}
    final = os.path.join(directory, f"step_{step:09d}")

    def write():
        tmp = f"{final}.tmp-{uuid.uuid4().hex[:8]}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"a{i}": a for i, a in enumerate(host)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(directory, keep)

    if blocking:
        write()
        return final
    t = threading.Thread(target=write, daemon=True)
    t.start()
    return t


def _gc(directory: str, keep: int):
    steps = all_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:09d}"),
                      ignore_errors=True)
    # drop orphaned tmp dirs (crashed writers)
    for d in os.listdir(directory):
        if ".tmp-" in d:
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(directory, d, "manifest.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if a.dtype.kind == "V":          # npz keeps bfloat16 as 2-byte void
        if dtype_name != "bfloat16":
            raise ValueError(f"a void array for dtype {dtype_name!r}")
        return torch.from_numpy(a.view(np.uint16).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.asarray(a, order="C"))


def restore(directory: str, step: int, template) -> Any:
    """Restore into the structure of ``template``: each leaf goes to its
    template tensor's device and dtype.  Raises ``KeyError`` for a leaf the
    checkpoint lacks and ``ValueError`` for a shape that differs."""
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    index = {k: i for i, k in enumerate(manifest["keys"])}
    keys, leaves = _paths(template)
    out = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for k, tmpl in zip(keys, leaves):
            if k not in index:
                raise KeyError(f"checkpoint missing leaf {k!r}")
            i = index[k]
            a = _from_host(data[f"a{i}"], manifest["dtypes"][i])
            if tuple(a.shape) != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch for {k}: ckpt "
                                 f"{tuple(a.shape)} vs {tuple(tmpl.shape)}")
            out.append(a.to(device=tmpl.device, dtype=tmpl.dtype))
    return tree.unflatten(template, out)
