"""Build this package's objects from the JAX package's, handed over as numpy
arrays and plain Python values.

The caller does the ``np.asarray`` on the other package's arrays: nothing
here ever sees (or imports) a foreign array type.  bfloat16 streams cross
as widened float32 plus the dtype's name, the way the schedule npz layer
stores them; an LM's bfloat16 weights cross as numpy's bfloat16 arrays,
bit for bit (``lm_state_dict_from_jax``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import blockell
from repro_torch.core.csrc import CSRC, _t
from repro_torch.core.plan import ExecutionPlan

_VALUE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tensor(a, dtype=None) -> torch.Tensor:
    return _t(np.asarray(a, dtype=dtype))


def csrc_from_arrays(*, n: int, m: int, ad, ia, ja, al, au, iar, jar, ar,
                     numerically_symmetric: bool) -> CSRC:
    """A :class:`CSRC` from the eight arrays of another container."""
    return CSRC(n=int(n), m=int(m), ad=_tensor(ad), ia=_tensor(ia),
                ja=_tensor(ja), al=_tensor(al), au=_tensor(au),
                iar=_tensor(iar), jar=_tensor(jar), ar=_tensor(ar),
                numerically_symmetric=bool(numerically_symmetric))


def blockell_from_arrays(*, n: int, tm: int, nt: int, w_pad: int, s: int,
                         vals_l, vals_u, col_local, row_in_win, ad,
                         num_symmetric: bool, pad_ratio: float,
                         value_dtype: str = "float32") -> blockell.BlockEll:
    """A :class:`~repro_torch.core.blockell.BlockEll` from a foreign pack.
    Value streams arrive as float32 arrays and are narrowed to
    ``value_dtype`` ('float32' or 'bfloat16'); index streams keep the
    integer dtype they arrive in.  The slot order is checked here
    (``blockell.check_slot_order``): a malformed pack raises ValueError."""
    vdt = _VALUE_DTYPES[value_dtype]

    def values(a):
        return _tensor(a, np.float32).to(vdt)

    col_t, row_t = _tensor(col_local), _tensor(row_in_win)
    blockell.check_slot_order(row_t, col_t, int(w_pad))
    vl = values(vals_l)
    return blockell.BlockEll(
        n=int(n), tm=int(tm), nt=int(nt), w_pad=int(w_pad), s=int(s),
        vals_l=vl, vals_u=vl if num_symmetric else values(vals_u),
        col_local=col_t, row_in_win=row_t,
        ad=values(ad), num_symmetric=bool(num_symmetric),
        pad_ratio=float(pad_ratio))


def flat_from_arrays(*, n: int, tm: int, nt: int, w_pad: int,
                     total_steps: int, ks: int, vals_l, vals_u, col_local,
                     row_in_win, ad, tile_of_step, first_of_tile,
                     num_symmetric: bool, pad_ratio: float,
                     value_dtype: str = "float32"):
    """A :class:`~repro_torch.kernels.csrc_spmv_flat.FlatBlockEll` from a
    foreign flat pack.  Streams arrive in the ``(total, ks, 128)`` layout
    (or already flat per step) and are stored as (total, ks·128); value
    streams arrive as float32 and are narrowed to ``value_dtype``.  The
    step ranges are derived and validated here: a malformed pack raises
    ValueError."""
    from repro_torch.kernels.csrc_spmv_flat import FlatBlockEll
    vdt = _VALUE_DTYPES[value_dtype]
    shape = (int(total_steps), int(ks) * 128)

    def values(a):
        return _tensor(np.asarray(a, np.float32).reshape(shape)).to(vdt)

    def indices(a):
        return _tensor(np.asarray(a).reshape(shape))

    vl = values(vals_l)
    return FlatBlockEll(
        n=int(n), tm=int(tm), nt=int(nt), w_pad=int(w_pad),
        total_steps=int(total_steps), ks=int(ks),
        vals_l=vl, vals_u=vl if num_symmetric else values(vals_u),
        col_local=indices(col_local), row_in_win=indices(row_in_win),
        ad=_tensor(ad, np.float32).to(vdt),
        tile_of_step=_tensor(tile_of_step, np.int32),
        first_of_tile=_tensor(first_of_tile, np.int32),
        num_symmetric=bool(num_symmetric), pad_ratio=float(pad_ratio))


def nnzsplit_from_arrays(*, n: int, num_chunks: int, ks: int, r_pad: int,
                         vals, lrow, src, chunk_row0, fixup_idx, ad,
                         num_symmetric: bool, pad_ratio: float,
                         value_dtype: str = "float32"):
    """A :class:`~repro_torch.kernels.csrc_spmv_nnzsplit.NnzSplitPack` from
    a foreign nnz-split pack.  ``vals`` / ``lrow`` arrive in the
    ``(C, ks, 128)`` layout and ``src`` as ``(C·S,)`` (or any layout of the
    same entries) and are stored as (C, S); values arrive as float32 and
    are narrowed to ``value_dtype``; index streams keep their integer
    dtype.  The streams are checked here (``lrow`` sorted inside each
    chunk, indices in range, ``fixup_idx`` consistent): a malformed pack
    raises ValueError."""
    from repro_torch.kernels.csrc_spmv_nnzsplit import (NnzSplitPack,
                                                        check_chunk_streams)
    vdt = _VALUE_DTYPES[value_dtype]
    shape = (int(num_chunks), int(ks) * 128)
    lrow_t = _tensor(np.asarray(lrow).reshape(shape))
    src_t = _tensor(np.asarray(src).reshape(shape))
    if lrow_t.dtype != src_t.dtype:
        raise ValueError(f"lrow is {lrow_t.dtype} but src is {src_t.dtype}")
    row0 = _tensor(chunk_row0, np.int32)
    fix = _tensor(fixup_idx, np.int32)
    check_chunk_streams(lrow_t, src_t, row0, fix, n=int(n), r_pad=int(r_pad))
    return NnzSplitPack(
        n=int(n), num_chunks=int(num_chunks), ks=int(ks), r_pad=int(r_pad),
        vals=_tensor(np.asarray(vals, np.float32).reshape(shape)).to(vdt),
        lrow=lrow_t, src=src_t, chunk_row0=row0, fixup_idx=fix,
        ad=_tensor(ad, np.float32).to(vdt),
        num_symmetric=bool(num_symmetric), pad_ratio=float(pad_ratio))


def _partition(part):
    """A port RowPartition from one, or from its four arrays."""
    from repro_torch.core.partition import RowPartition
    if isinstance(part, RowPartition):
        return part
    return RowPartition(**{f: np.asarray(part[f]) for f in (
        "starts", "eff_lo", "eff_hi", "nnz_per_part")})


def shard_layout_from_arrays(kind: str, *, value_dtype: str = "float32",
                             **fields):
    """One of the six shard layouts of the mesh strategies from a foreign
    layout's fields: ``kind`` is its npz kind ('sharded_slots', 'halo',
    'flat_shards', 'flat_halo', 'nnzsplit_shards' or 'nnzsplit_halo'),
    scalars as plain values, arrays as numpy in the JAX package's shapes
    (value streams as float32, narrowed to ``value_dtype`` for the flat and
    nnz-split packs; index streams keep their integer dtype), and ``part``
    a RowPartition or a mapping of its four arrays.  The nnz-split chunks
    are checked here (``check_chunk_streams``, per shard); the flat packs'
    slot order and step ranges when a shard's pack is taken
    (``shard_pack``).  A numerically symmetric flat layout aliases
    ``vals_u`` to ``vals_l`` and raises ValueError if the two differ."""
    from repro_torch.core import schedule as sched_mod
    vdt = _VALUE_DTYPES[value_dtype]
    f = dict(fields)
    if kind == "sharded_slots":
        return sched_mod.ShardedSlots(
            row_idx=_tensor(f["row_idx"], np.int32),
            ja=_tensor(f["ja"], np.int32), al=_tensor(f["al"], np.float32),
            au=_tensor(f["au"], np.float32),
            ad_shard=_tensor(f["ad_shard"], np.float32),
            part=_partition(f["part"]))
    if kind == "halo":
        return sched_mod.HaloLayout(
            p=int(f["p"]), ns=int(f["ns"]), h=int(f["h"]),
            n_pad=int(f["n_pad"]), row_loc=_tensor(f["row_loc"], np.int32),
            col_rel=_tensor(f["col_rel"], np.int32),
            al=_tensor(f["al"], np.float32), au=_tensor(f["au"], np.float32),
            ad=_tensor(f["ad"], np.float32))
    if kind in ("flat_shards", "flat_halo"):
        from repro_torch.kernels import csrc_spmv_flat as flat_mod
        p, steps, ks = int(f["p"]), int(f["steps"]), int(f["ks"])
        shape = (p, steps, ks * 128)
        sym = bool(f["num_symmetric"])
        vl_np = np.asarray(f["vals_l"], np.float32).reshape(shape)
        vu_np = np.asarray(f["vals_u"], np.float32).reshape(shape)
        if sym and not np.array_equal(vl_np, vu_np):
            raise ValueError("a numerically symmetric layout needs "
                             "vals_u == vals_l")
        vl = _tensor(vl_np).to(vdt)
        common = dict(
            tm=int(f["tm"]), nt=int(f["nt"]), w_pad=int(f["w_pad"]),
            steps=steps, ks=ks, vals_l=vl,
            vals_u=vl if sym else _tensor(vu_np).to(vdt),
            col_local=_tensor(np.asarray(f["col_local"]).reshape(shape)),
            row_in_win=_tensor(np.asarray(f["row_in_win"]).reshape(shape)),
            ad=_tensor(f["ad"], np.float32).to(vdt),
            tile_of_step=_tensor(f["tile_of_step"], np.int32),
            first_of_tile=_tensor(f["first_of_tile"], np.int32),
            num_symmetric=sym)
        if kind == "flat_shards":
            return flat_mod.FlatShards(p=p, n=int(f["n"]), **common)
        return flat_mod.FlatHalo(p=p, ns=int(f["ns"]), h=int(f["h"]),
                                 n_local=int(f["n_local"]), **common)
    if kind in ("nnzsplit_shards", "nnzsplit_halo"):
        from repro_torch.kernels import csrc_spmv_nnzsplit as nz_mod
        p, nc, ks = int(f["p"]), int(f["num_chunks"]), int(f["ks"])
        r_pad = int(f["r_pad"])
        shape = (p, nc, ks * 128)
        lrow = _tensor(np.asarray(f["lrow"]).reshape(shape))
        src = _tensor(np.asarray(f["src"]).reshape(shape))
        if lrow.dtype != src.dtype:
            raise ValueError(f"lrow is {lrow.dtype} but src is {src.dtype}")
        row0 = _tensor(f["chunk_row0"], np.int32)
        fix = _tensor(f["fixup_idx"], np.int32)
        rows = int(f["n"] if kind == "nnzsplit_shards" else f["n_local"])
        for t in range(p):
            nz_mod.check_chunk_streams(lrow[t], src[t], row0[t], fix[t],
                                       n=rows, r_pad=r_pad)
        common = dict(
            num_chunks=nc, ks=ks, r_pad=r_pad,
            vals=_tensor(np.asarray(f["vals"], np.float32).reshape(
                shape)).to(vdt),
            lrow=lrow, src=src, chunk_row0=row0, fixup_idx=fix,
            ad=_tensor(f["ad"], np.float32).to(vdt),
            num_symmetric=bool(f["num_symmetric"]))
        if kind == "nnzsplit_shards":
            return nz_mod.NnzSplitShards(p=p, n=int(f["n"]), **common)
        return nz_mod.NnzSplitHalo(p=p, ns=int(f["ns"]), h=int(f["h"]),
                                   n_local=int(f["n_local"]), **common)
    raise ValueError(f"unknown shard layout kind {kind!r}")


def coloring_from_arrays(*, color_of_row, num_colors: int, rows_by_color,
                         color_ptr, provider: str = "greedy",
                         level_of_row=None, group_of_row=None):
    """A :class:`~repro_torch.core.coloring.Coloring` from a foreign one's
    arrays (numpy, as the JAX package keeps them)."""
    from repro_torch.core.coloring import PROVIDERS, Coloring
    if provider not in PROVIDERS:
        raise ValueError(f"unknown coloring provider {provider!r}")

    def opt(a):
        return None if a is None else np.asarray(a)
    return Coloring(color_of_row=np.asarray(color_of_row),
                    num_colors=int(num_colors),
                    rows_by_color=np.asarray(rows_by_color),
                    color_ptr=np.asarray(color_ptr), provider=provider,
                    level_of_row=opt(level_of_row),
                    group_of_row=opt(group_of_row))


def assembly_schedule_from_arrays(*, structure_digest: str, n: int, k: int,
                                  ne: int, edof: int, ndof_per_node: int,
                                  num_buffers: int, ia, ja, targets,
                                  coloring, buffer_elements, color_slots,
                                  color_targets, sorted_perm,
                                  sorted_targets):
    """An :class:`~repro_torch.assembly.scatter.AssemblySchedule` from a
    foreign one's fields.  ``coloring`` is a
    :class:`~repro_torch.core.coloring.Coloring` or the keyword arrays of
    :func:`coloring_from_arrays`; index streams keep the integer dtypes
    they arrive in (the int16 gate travels with them).  The kernel packs
    are validated and bucketed on construction: a malformed pack raises
    ValueError."""
    from repro_torch.assembly.scatter import AssemblySchedule
    from repro_torch.core.coloring import Coloring
    if not isinstance(coloring, Coloring):
        coloring = coloring_from_arrays(**coloring)
    return AssemblySchedule(
        structure_digest=str(structure_digest), n=int(n), k=int(k),
        ne=int(ne), edof=int(edof), ndof_per_node=int(ndof_per_node),
        num_buffers=int(num_buffers), ia=np.asarray(ia), ja=np.asarray(ja),
        targets=np.asarray(targets), coloring=coloring,
        buffer_elements=np.asarray(buffer_elements),
        color_slots=np.asarray(color_slots),
        color_targets=np.asarray(color_targets),
        sorted_perm=np.asarray(sorted_perm),
        sorted_targets=np.asarray(sorted_targets))


def plan_from_dict(d: Dict) -> ExecutionPlan:
    """An :class:`ExecutionPlan` from another plan's ``to_dict()``."""
    return ExecutionPlan.from_dict(dict(d))


def _leaf_tensor(a) -> torch.Tensor:
    """A tensor of ``a``'s dtype.  A bfloat16 array (numpy's
    ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` cannot take)
    crosses as its ``uint16`` bits.  The array is copied: the tensor owns
    its memory."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _flat_leaves(tree, prefix=""):
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, dict):
            yield from _flat_leaves(value, path + ".")
        else:
            yield path, value


# the params tree's layer stacks -> how many leading axes each stacks
_LM_STACKS = {"layers": 1, "first_layers": 1, "mamba_groups": 2,
              "mamba_tail": 1, "lora": 1}


def _rows(a):
    return [a[i] for i in range(np.shape(a)[0])]


def _unstacked(path, leaf, split=_rows):
    """(state-dict key, array) pieces of one leaf: a leaf of a layer stack
    is split along its stacked axes (``mamba_groups.w_in`` of shape
    (G, P, ...) -> ``mamba_groups.<g>.<p>.w_in``) by ``split``, any other
    kept whole."""
    group, _, rest = path.partition(".")
    axes = _LM_STACKS.get(group, 0) if rest else 0
    if not axes:
        return [(path, leaf)]
    pieces = [(group, leaf)]
    for _ in range(axes):
        pieces = [(f"{key}.{i}", row) for key, a in pieces
                  for i, row in enumerate(split(a))]
    return [(f"{key}.{rest}", a) for key, a in pieces]


def lm_state_dict_from_jax(cfg, params) -> Dict[str, torch.Tensor]:
    """A state dict for ``build_model(cfg)`` (any family) from the JAX
    package's params tree of the same config, handed over as nested dicts
    of numpy arrays.

    The layer stacks are unstacked into module paths: ``layers`` /
    ``first_layers`` / ``mamba_tail`` / ``lora`` along axis 0
    (``layers.<i>.<name>``), ``mamba_groups`` along its two leading axes
    (``mamba_groups.<g>.<p>.<name>``); nested dicts (``tm``, ``cm``, ``m``,
    ``shared.attn``) become dotted paths.  Every leaf keeps its dtype.
    Raises ``ValueError`` on a leaf the model has no weight for, on a shape
    that differs from the model's, and on a weight the tree does not give;
    the model's names and shapes come from a skeleton on the meta
    device."""
    from repro_torch.models.transformer import build_model
    expected = {k: v.shape for k, v in
                build_model(cfg, device="meta").state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    for path, leaf in _flat_leaves(params):
        for key, a in _unstacked(path, leaf):
            if key not in expected:
                raise ValueError(f"{cfg.name}: leaf {key!r} not consumed: "
                                 "the model has no such weight")
            t = _leaf_tensor(a)
            if t.shape != expected[key]:
                raise ValueError(f"{cfg.name}: leaf {key!r} has shape "
                                 f"{tuple(t.shape)}, the model "
                                 f"{tuple(expected[key])}")
            out[key] = t
    missing = sorted(set(expected) - set(out))
    if missing:
        raise ValueError(f"{cfg.name}: the tree lacks {missing[:5]}")
    return out


def lm_params_from_jax(params) -> Dict:
    """The JAX package's params tree (nested dicts of numpy arrays) as the
    port's training tree: the same nesting and stacked layout, each leaf a
    tensor of its dtype (``train.step.TrainState.params``)."""
    return {k: lm_params_from_jax(v) if isinstance(v, dict)
            else _leaf_tensor(v) for k, v in params.items()}


def lm_params_tree(state_dict) -> Dict:
    """The params tree in the JAX package's layout from a model's state
    dict: each layer stack's per-layer weights stacked on its leading
    axes (``layers.<i>.attn.wq`` -> ``["layers"]["attn"]["wq"]`` of shape
    (L, ...), ``mamba_groups.<g>.<p>.m.w_in`` -> (G, P, ...)), every other
    weight nested by its dotted path.  The inverse of
    :func:`lm_state_dict_from_tree`; the tensors are new (``torch.stack``)
    except the unstacked ones, which are the state dict's."""
    out: Dict = {}
    stacks: Dict = {}
    for key, t in state_dict.items():
        group, _, rest = key.partition(".")
        axes = _LM_STACKS.get(group, 0) if rest else 0
        if not axes:
            _nest(out, key.split("."), t)
            continue
        parts = rest.split(".")
        name = (group,) + tuple(parts[axes:])
        stacks.setdefault(name, {})[tuple(int(i) for i in parts[:axes])] = t

    def stack(pieces, prefix, axes):
        n = 1 + max(idx[len(prefix)] for idx in pieces)
        rows = [prefix + (i,) for i in range(n)]
        if axes == 1:
            return torch.stack([pieces[r] for r in rows])
        return torch.stack([stack(pieces, r, axes - 1) for r in rows])

    for name, pieces in stacks.items():
        _nest(out, list(name), stack(pieces, (), _LM_STACKS[name[0]]))
    return out


def _nest(tree, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def lm_state_dict_from_tree(params) -> Dict[str, torch.Tensor]:
    """A model's state dict from the params tree: each stacked leaf split
    by ``torch.unbind`` into views, one per layer (its backward is one
    ``stack`` per leaf, where indexing layer by layer would write a
    full-size zero tensor for every layer)."""
    return dict(piece for path, leaf in _flat_leaves(params)
                for piece in _unstacked(path, leaf, split=torch.unbind))
