"""Sharding rules: map model parameters and activations onto a mesh.

Mesh axes (``launch/mesh.py``):
  pod    — data parallelism across pods (crosses the inter-node links);
  data   — in-pod data parallelism; parameters are FSDP-sharded here;
  model  — tensor / expert parallelism (heads, d_ff, vocab, experts).

Rules are name-based over the trailing dims of each leaf of the params
tree in the JAX package's stacked layout (``convert.lm_params_tree``:
stacked layer axes are padded with None on the left), with per-dim
divisibility guards — a dim that does not divide its mesh axis falls back
to replication (e.g. granite's vocab 49155 on 16-way model).

A spec is a :class:`PartitionSpec`: a tuple with one entry per dim, each
an axis name, a tuple of names or None.  Specs come back in a tree of the
params tree's structure; :func:`materialize` turns them into
``torch.distributed.tensor`` placements (``Shard(d)`` / ``Replicate()``)
on a ``DeviceMesh``.  The rules read only the mesh's axis sizes: a
``launch.mesh.MeshShape``, a ``DeviceMesh`` or any object whose ``shape``
maps axis names to sizes.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch import tree


def _entry(e):
    """A one-name tuple is that name, an empty one None (as JAX's
    PartitionSpec normalizes them)."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else e[0] if len(e) == 1 else e
    return e


class PartitionSpec(tuple):
    """One entry per dim: an axis name, a tuple of names, or None."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


P = PartitionSpec

# rules: leaf-name -> spec for the trailing dims (None-padded on the left).
# "col" = (in, out) -> (data, model); "row" = (in, out) -> (model, data).
_COL2 = ("data", "model")
_ROW2 = ("model", "data")
_RULES = {
    # embeddings / head
    "embed": ("model", "data"),
    "head": _COL2,
    # attention
    "wq": _COL2, "wk": _COL2, "wv": _COL2, "wo": _ROW2,
    # mlp
    "wi_gate": _COL2, "wi_up": _COL2, "w_down": _ROW2,
    # moe (E, D, F) / (E, F, D); experts over model (EP)
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "router": ("data", None),
    # mla
    "w_dkv": _COL2,
    "w_uk": (None, "model", None), "w_uv": (None, "model", None),
    "w_q": ("data", "model", None), "w_o": ("model", None, "data"),
    # rwkv
    "wr": _COL2, "wg": _COL2,
    "maa_w1": _COL2, "decay_w1": _COL2, "decay_w2": _ROW2,
    # mamba2
    "w_in": _COL2, "w_out": _ROW2, "conv_w": (None, "model"),
    "conv_b": ("model",),
    # lora adapters (hybrid shared block)
    "lora_a": _COL2, "lora_b": _ROW2,
}
# name collisions resolved by parent path fragment
_CONTEXT_RULES = {
    ("cm", "wv"): _ROW2,        # rwkv channel-mix down-proj (F, D)
    ("moe", "w_down"): ("model", None, "data"),
}


def _guard(spec_tail, shape, axis_sizes) -> PartitionSpec:
    """Drop axes that don't divide their dim; pad front with None."""
    tail = list(spec_tail)
    full = [None] * (len(shape) - len(tail)) + tail
    out = []
    for dim, ax in zip(shape, full):
        if isinstance(ax, str):
            size = axis_sizes.get(ax, 1)
            out.append(ax if size > 1 and dim % size == 0 else None)
        else:
            out.append(None)
    return P(*out)


def _axis_sizes(mesh) -> Dict[str, int]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                   # a DeviceMesh
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def infer_param_specs(params, mesh):
    """PartitionSpec tree matching ``params`` (the stacked params tree) for
    the given mesh."""
    axis_sizes = _axis_sizes(mesh)

    def leaf_spec(names, leaf):
        name = names[-1] if names else ""
        if leaf.ndim <= 1:
            return P()
        for (ctx, n), spec in _CONTEXT_RULES.items():
            if n == name and ctx in names:
                return _guard(spec, leaf.shape, axis_sizes)
        if name in _RULES:
            return _guard(_RULES[name], leaf.shape, axis_sizes)
        return _guard(_COL2, leaf.shape, axis_sizes)   # generic matmul

    return tree.unflatten(params, [leaf_spec(path, leaf) for path, leaf
                                   in tree.flatten_with_paths(params)])


def guard_spec(spec, shape, mesh) -> PartitionSpec:
    """Drop spec entries that don't divide their dim on this mesh; flatten
    axis tuples whose axes are absent."""
    axis_sizes = _axis_sizes(mesh)
    out = []
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for dim, e in zip(shape, entries):
        if e is None:
            out.append(None)
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        axes = tuple(a for a in axes if axis_sizes.get(a, 1) > 1)
        total = 1
        for a in axes:
            total *= axis_sizes[a]
        if axes and dim % total == 0:
            out.append(axes[0] if len(axes) == 1 else axes)
        else:
            out.append(None)
    return P(*out)


def placements(spec, shape, device_mesh) -> Tuple:
    """The ``torch.distributed.tensor`` placements of one guarded spec on a
    ``DeviceMesh``: per mesh dim, ``Shard(d)`` for the tensor dim whose
    entry names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    guarded = guard_spec(spec, shape, device_mesh)
    out = []
    for axis in device_mesh.mesh_dim_names:
        dim = next((d for d, e in enumerate(guarded)
                    if e == axis or (isinstance(e, tuple) and axis in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def materialize(spec_tree, tensor_tree, device_mesh):
    """Logical spec tree + tensor tree -> a tree of ``DTensor``s, each
    tensor distributed over ``device_mesh`` by its guarded spec (every
    rank passes the whole tensor; each keeps its shard)."""
    from torch.distributed.tensor import distribute_tensor
    specs = tree.leaves(spec_tree)
    tensors = tree.leaves(tensor_tree)
    return tree.unflatten(tensor_tree, [
        distribute_tensor(t, device_mesh,
                          placements(P() if s is None else s, t.shape,
                                     device_mesh))
        for s, t in zip(specs, tensors, strict=True)])


# ---------------------------------------------------------------------------
# Activation constraints (identity outside a mesh context)
# ---------------------------------------------------------------------------

_ACTIVE_MESH = None


class use_mesh:
    """Context in which :func:`constrain` and :func:`batch_axes` see
    ``mesh`` (the JAX package reads the ambient ``with mesh:``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._prev = None

    def __enter__(self):
        global _ACTIVE_MESH
        self._prev, _ACTIVE_MESH = _ACTIVE_MESH, self.mesh
        return self.mesh

    def __exit__(self, *exc):
        global _ACTIVE_MESH
        _ACTIVE_MESH = self._prev
        return False


def _current_mesh():
    return _ACTIVE_MESH


def _axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def batch_axes(mesh=None) -> Tuple[str, ...]:
    mesh = mesh or _current_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in ("pod", "data") if a in _axis_names(mesh))


def constrain(x, *spec):
    """The sharding constraint with divisibility guards; identity when no
    ``DeviceMesh`` is active (one card, the CPU, a mere axis description).
    A ``DTensor`` is redistributed to the guarded placements; any other
    tensor passes through unchanged."""
    mesh = _current_mesh()
    if getattr(mesh, "mesh_dim_names", None) is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(spec, x.shape, mesh))


def constrain_tokens(x):
    """(B, S[, D]) activations: batch over (pod, data)."""
    ba = batch_axes()
    if not ba:
        return x
    spec = [ba] + [None] * (x.ndim - 1)
    return constrain(x, *spec)
