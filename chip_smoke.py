#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--n 2097152] [--cubes 64 32 32]
                          [--verbose-build]

Builds the fourteen CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, then drives four of
the port's kernel paths through its public entry points at a size a
deployment would call real, one after the other:

  kernel    two FEM-like band matrices (``--n`` rows, 24 sub-diagonals at
            fill 0.6, about 62 M non-zeros each at the default size) on the
            rectangular block-ELL grid (K1-K4);
  flat      two skewed FEM-like matrices (``--n`` rows, a dense half-band
            of 512 on the first 6 % of rows and of 3 on the rest, about
            142 M non-zeros each) on the flat grid (K5-K8);
  nnzsplit  two unstructured matrices (``--n`` rows): the Laplacian-like
            matrix of a power-law graph with shuffled labels (mean degree
            32, about 69 M non-zeros, the scale of SNAP's com-LiveJournal)
            and a random pattern of 20 entries per row (about 44 M), both
            infeasible for the windowed paths, on the nnz-split chunks
            (K9-K12);
  assembly  FEM assembly of a 3-D elasticity system: a 64 x 32 x 32-cube
            block (``--cubes``) of Kuhn tetrahedra (393,216 elements, three
            DOFs per node, 56.6 M element contributions per assembly),
            schedule built
            and cached, strategy tuned, assembled by the colored kernels
            (K13 stream, K14 one-hot) and every other strategy, each equal
            to the serial oracle bit for bit; the matrix is served and
            solved on the ``kernel`` path, then re-assembled, refreshed,
            served and solved at three time steps, and the schedule and the
            tuned strategy come back from a fresh cache with zero builds.

Each path's two matrices are served by one ``SpmvServingEngine`` and solved
by ``cg_solve`` / ``bicgstab``.  Answers are checked against a float64
``scipy.sparse`` product built from the same COO data and against the
port's own ``segment`` path.  A last phase serves one 2-D Poisson matrix
(``--n``/8 rows: 512 x 512 at the default size) through the paper's two
strategies side by side —
row coloring (the ``colorful`` path, torch ops) and the local-buffer
windows of the ``kernel`` path — and solves it by CG on the colorful one.

Every phase prints one JSON line.  Before the last line come one JSON
object ``{"kernels": [...]}`` (per kernel: launches on its path's main run,
error against the plain version, time, plain time, bound, library time)
and the card's name and power limit.  The last line is
``{"ok": true, "device": {...}}``.  Any failing phase, a missing card or a
kernel that does not build ends the run with a non-zero exit code; nothing
falls back to the CPU or to a plain version.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

HALF_BAND = 24
FILL = 0.6
SKEW_WIDE = 512       # half-band of the wide rows of the skewed matrices
SKEW_NARROW = 3       # half-band of the other rows
SKEW_WIDE_FRAC = 0.06
PL_ATTACH = 16        # edges each vertex draws: mean degree 32
PL_ALPHA = 0.5        # attachment weight (rank)^-alpha: degrees ~ k^-3
RAND_PER_ROW = 20     # stored entries per row of the random pattern
TOL = 1e-5            # of the row's absolute sum: float32 sums in any order
# build counters a same-structure value refresh must leave untouched
STRUCTURAL_BUILDS = ("pack", "flat_pack", "nnzsplit_pack", "coloring",
                     "partition")
# the assembly path: a cantilever-beam block of 64 x 32 x 32 unit cubes,
# six Kuhn tets each, elasticity (three DOFs per node), three time steps
ASM_CUBES = (64, 32, 32)
ASM_DOF = 3
ASM_STEPS = 3
ASM_BUILDS = ("pack", "partition", "coloring", "assembly_schedule",
              "element_coloring", "assembly_color_pack",
              "assembly_sorted_pack")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, published
FP32_FLOPS = 67e12             # H100 SXM, float32 outside the tensor cores


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ---------------------------------------------------------------------------
# Data: vectorized band matrices (the package's own generators loop in
# Python and are kept for parity at test sizes)
# ---------------------------------------------------------------------------

def band_arrays(n, half_band, fill, seed, symmetric, dyadic=False,
                empty_rows=None):
    """Structure and values of a random band matrix with a structurally
    symmetric pattern: (ia, ja, ad, al, au) with row-major lower slots."""
    rng = np.random.default_rng(seed)
    keep = rng.random((n, half_band), dtype=np.float32) < fill
    # column c of `keep` is the sub-diagonal offset half_band - c, so that
    # the stored columns of a row ascend with c
    rows_i = np.arange(n, dtype=np.int64)[:, None]
    cols_j = rows_i - half_band + np.arange(half_band, dtype=np.int64)[None, :]
    keep &= cols_j >= 0
    if empty_rows is not None:
        keep[empty_rows] = False
    r, c = np.nonzero(keep)
    ja = (r - half_band + c).astype(np.int32)
    ia = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(keep.sum(axis=1), out=ia[1:])
    k = ja.shape[0]

    def values():
        if dyadic:    # exact in bfloat16 too: multiples of 1/4 in [-2, 2]
            return (rng.integers(-8, 9, size=k) / 4.0).astype(np.float32)
        return rng.standard_normal(k, dtype=np.float32)

    al = values()
    au = al if symmetric else values()
    ad = np.full(n, 2.0 * half_band, dtype=np.float32)
    return ia, ja, ad, al, au


def skew_arrays(n, wide, narrow, seed, symmetric, fill=1.0, dyadic=False,
                empty_rows=None):
    """A matrix of the shape of ``csrc.skewed_band``: rows below
    ``SKEW_WIDE_FRAC·n`` hold the band of half-width ``wide``, the others
    of half-width ``narrow``, dense (``fill`` keeps a random share of the
    wide rows' slots), diagonal 2·wide.  Returns (ia, ja, ad, al, au) with
    row-major lower slots."""
    rng = np.random.default_rng(seed)
    rows_i = np.arange(n, dtype=np.int64)
    n_wide = max(1, int(round(SKEW_WIDE_FRAC * n)))
    lo = np.maximum(0, rows_i - np.where(rows_i < n_wide, wide, narrow))
    count = rows_i - lo
    if empty_rows is not None:
        count[empty_rows] = 0
    ros = np.repeat(rows_i, count)
    ia_full = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(count, out=ia_full[1:])
    ja = lo[ros] + np.arange(ros.shape[0], dtype=np.int64) - ia_full[ros]
    if fill < 1.0:
        keep = (ros >= n_wide) | (rng.random(ros.shape[0]) < fill)
        ros, ja = ros[keep], ja[keep]
    ia = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(np.bincount(ros, minlength=n), out=ia[1:])
    k = ja.shape[0]

    def values():
        if dyadic:
            return (rng.integers(-8, 9, size=k) / 4.0).astype(np.float32)
        return rng.standard_normal(k, dtype=np.float32)

    al = values()
    au = al if symmetric else values()
    ad = np.full(n, 2.0 * wide, dtype=np.float32)
    return ia, ja.astype(np.int32), ad, al, au


def _lower_from_pairs(n, hi, lo):
    """Row-major lower slots (ia, ja) of the distinct pairs hi > lo."""
    key = np.unique(hi.astype(np.int64) * n + lo)
    ros, ja = np.divmod(key, n)
    ia = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(np.bincount(ros, minlength=n), out=ia[1:])
    return ia, ja.astype(np.int32), ros


def _dyadic_values(rng, k):
    return (rng.integers(-8, 9, size=k) / 4.0).astype(np.float32)


def powerlaw_arrays(n, seed, attach=PL_ATTACH, dyadic=False,
                    general=False):
    """A matrix of the class of ``csrc.powerlaw_laplacian``: every vertex
    draws ``attach`` neighbours with probability proportional to a
    power-law weight, labels shuffled, so degrees have a heavy tail (hub
    rows) and ``ja`` spreads over all of n.  Off-diagonals -1 and diagonal
    2·degree + 1 (integers, symmetric, strictly diagonally dominant: SPD,
    Jacobi spectrum in (0.5, 1.5)); ``general`` draws symmetric standard
    normal off-diagonals with diagonal 1 + 2·(absolute row sum), ``dyadic``
    multiples of 1/4.  Returns (ia, ja, ad, al, au)."""
    rng = np.random.default_rng(seed)
    label = rng.permutation(n)
    src = np.repeat(np.arange(n, dtype=np.int64), attach)
    # inverse of the continuous CDF of rank^-alpha on [1, n]: one draw per
    # edge in closed form (a search of a 2 M-entry CDF per draw is slow)
    e = 1.0 - PL_ALPHA
    u = rng.random(src.shape[0])
    rank = (1.0 + u * (n ** e - 1.0)) ** (1.0 / e)
    dst = label[np.minimum(rank.astype(np.int64), n) - 1]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    ia, ja, ros = _lower_from_pairs(n, np.maximum(src, dst),
                                    np.minimum(src, dst))
    k = ja.shape[0]
    if general or dyadic:
        al = (_dyadic_values(rng, k) if dyadic
              else rng.standard_normal(k, dtype=np.float32))
        absum = (np.bincount(ros, np.abs(al), minlength=n)
                 + np.bincount(ja, np.abs(al), minlength=n))
        ad = (1.0 + 2.0 * absum).astype(np.float32)
        return ia, ja, ad, al, al
    deg = np.bincount(ros, minlength=n) + np.bincount(ja, minlength=n)
    al = -np.ones(k, dtype=np.float32)
    return ia, ja, (2.0 * deg + 1.0).astype(np.float32), al, al


def random_arrays(n, seed, per_row=RAND_PER_ROW, dyadic=False,
                  empty_rows=None):
    """A matrix of the class of ``csrc.random_symmetric_pattern`` (the
    cage15 / F1 kind): n·per_row/2 lower entries at uniform rows, each at a
    uniform column below its row; independent standard normal (or dyadic)
    al / au and diagonal 1 + 2·(absolute row sum).  Returns (ia, ja, ad,
    al, au)."""
    rng = np.random.default_rng(seed)
    k = n * per_row // 2
    r = rng.integers(1, n, size=k, dtype=np.int64)
    c = (rng.random(k) * r).astype(np.int64)
    if empty_rows is not None:
        gone = np.zeros(n, dtype=bool)
        gone[empty_rows] = True
        keep = ~(gone[r] | gone[c])
        r, c = r[keep], c[keep]
    ia, ja, ros = _lower_from_pairs(n, r, c)
    k = ja.shape[0]

    def values():
        if dyadic:
            return _dyadic_values(rng, k)
        return rng.standard_normal(k, dtype=np.float32)

    al, au = values(), values()
    absum = (np.bincount(ros, np.abs(al), minlength=n)
             + np.bincount(ja, np.abs(au), minlength=n))
    return ia, ja, (1.0 + 2.0 * absum).astype(np.float32), al, au


def star_arrays(n, seed):
    """A star graph's centre (row 0, adjacent to every other row) over a
    sparse random background: the hub row spans several chunks.  Dyadic
    values."""
    rng = np.random.default_rng(seed)
    leaves = np.arange(1, n, dtype=np.int64)
    r = rng.integers(1, n, size=2 * n, dtype=np.int64)
    c = (rng.random(2 * n) * r).astype(np.int64)
    hi = np.concatenate([leaves, np.maximum(r, c + 1)])
    lo = np.concatenate([np.zeros(n - 1, np.int64), np.minimum(c, r - 1)])
    ia, ja, ros = _lower_from_pairs(n, hi, lo)
    al = _dyadic_values(rng, ja.shape[0])
    au = _dyadic_values(rng, ja.shape[0])
    return ia, ja, np.full(n, 4.0, dtype=np.float32), al, au


def gap_arrays(seed, gap=3999, width=600):
    """Two dense rows ``gap`` apart with only empty rows between them
    (their ``width`` neighbours each lie just past the second): the first
    chunk holds both and spans gap + 1 rows, so r_pad reaches 4096.
    Dyadic values."""
    n = gap + 1 + 2 * width + 128
    hi = gap + 1 + np.arange(2 * width, dtype=np.int64)
    lo = np.concatenate([np.zeros(width, np.int64),
                         np.full(width, gap, np.int64)])
    ia, ja, _ = _lower_from_pairs(n, hi, lo)
    rng = np.random.default_rng(seed)
    al = _dyadic_values(rng, ja.shape[0])
    au = _dyadic_values(rng, ja.shape[0])
    return ia, ja, np.full(n, 2.0, dtype=np.float32), al, au


def onehot_adversary_arrays(case, seed):
    """A small matrix (dyadic values, numerically non-symmetric, a band of
    3 besides) whose packs stress the row runs and column buckets of the
    one-hot kernels (K3/K4 on the rectangular grid, K7/K8 on the flat one)
    and the warp runs of the stream SpMVs (K1, K5):

      row_spans_steps     rows 1000-1199 hold 1,000 slots each: over steps
                          of 128 slots a row's run fills whole steps and
                          crosses step boundaries;
      bucket_128          every row reaches column 0, so one column's bucket
                          holds a slot of every row of a step; rows
                          1280-1535 are empty, so their flat tiles hold one
                          step of padding;
      padding_only_steps  rows 1024-1151 hold 200 slots each and rows
                          1152-1279 none: beside one dense tile the other
                          rectangular tiles fill their steps with padding;
      w4096               rows from 3968 on reach 3968 back: W = 4096;
      warp_run_edges      row widths cycle over 1, 1, 1..33, 64, 128 and
                          300: in the stream SpMVs' warps of 32 lanes x 4
                          slots a run ends at each of the 128 positions,
                          a lane holds four rows, a run fills one warp
                          exactly, a longer one whole warps, and runs
                          cross 256-slot strides and step ends.

    Returns (ia, ja, ad, al, au)."""
    n = 8192 if case == "w4096" else 3000
    r = np.arange(n, dtype=np.int64)
    width = np.full(n, 3, dtype=np.int64)
    if case == "row_spans_steps":
        width[1000:1200] = 1000
    if case == "padding_only_steps":
        width[1024:1152] = 200
        width[1152:1280] = 0
    if case == "warp_run_edges":
        cycle = np.concatenate([[1, 1], np.arange(1, 34), [64, 128, 300]])
        width = cycle[r % cycle.shape[0]]
    count = r - np.maximum(0, r - width)
    hi = np.repeat(r, count)
    lo = hi - 1 - (np.arange(hi.shape[0]) - np.repeat(np.cumsum(count)
                                                      - count, count))
    if case == "bucket_128":
        hi = np.concatenate([hi, r[1:]])
        lo = np.concatenate([lo, np.zeros(n - 1, np.int64)])
        keep = (hi < 1280) | (hi >= 1536)
        hi, lo = hi[keep], lo[keep]
    if case == "w4096":
        hi = np.concatenate([hi, r[3968:]])
        lo = np.concatenate([lo, r[3968:] - 3968])
    ia, ja, _ = _lower_from_pairs(n, hi, lo)
    rng = np.random.default_rng(seed)
    al = _dyadic_values(rng, ja.shape[0])
    au = _dyadic_values(rng, ja.shape[0])
    return ia, ja, np.full(n, 8.0, dtype=np.float32), al, au



def onehot_step_geometry(pack, step):
    """What the one-hot adversary cases aim at, read off a pack (the
    rectangular ``BlockEll`` or the flat ``FlatBlockEll``) as rows of
    ``step`` slots: the steps holding one row's real slots only, the
    largest column bucket of a step, the steps of padding only and, on the
    rectangular grid, the real slots of the emptiest and fullest tile.
    For the stream SpMVs (K1, K5: lanes of 4 consecutive slots, warps of
    128): the positions in a warp at which a row's run ends inside a step,
    the lanes holding four rows, the warps whose slots hold one row (and
    those of them holding a whole run), and the runs that cross a 256-slot
    stride inside a step or the end of a step into the tile's next one."""
    rows = pack.row_in_win.long().reshape(-1, step)
    cols = pack.col_local.long().reshape(-1, step)
    real = cols < pack.w_pad
    per_step = torch.zeros((rows.shape[0], pack.w_pad + 1),
                           dtype=torch.int64, device=cols.device)
    per_step.scatter_add_(1, cols.clamp(max=pack.w_pad),
                          torch.ones_like(cols))
    geometry = {
        "w_pad": pack.w_pad, "k_step": step, "steps": rows.shape[0],
        "one_row_steps": int(((rows == rows[:, :1]) & real).all(1).sum()),
        "largest_bucket": int(per_step[:, :pack.w_pad].max()),
        "padding_only_steps": int((~real).all(1).sum())}
    if hasattr(pack, "s"):                 # rectangular: NT tiles of S slots
        tiles = real.reshape(pack.nt, -1).sum(1)
        geometry["tile_real_slots"] = [int(tiles.min()), int(tiles.max())]
        tile_of_step = torch.arange(rows.shape[0]) // (pack.s // step)
    else:
        tile_of_step = pack.tile_of_step.long().cpu()
    # the warp runs, inside each step (a warp never crosses one)
    same = (rows[:, 1:] == rows[:, :-1]) & real[:, 1:]
    ends = real[:, :-1] & ~same
    position = torch.arange(step - 1, device=rows.device) % 128
    lanes = rows.reshape(rows.shape[0], -1, 4)
    warps = rows.reshape(rows.shape[0], -1, 128)
    one_row = ((warps == warps[..., :1]) & real.reshape(warps.shape)).all(-1)
    opens = torch.ones_like(one_row)
    opens[:, 1:] = warps[:, 1:, 0] != warps[:, :-1, -1]
    closes = torch.ones_like(one_row)
    closes[:, :-1] = warps[:, :-1, -1] != warps[:, 1:, 0]
    passes = torch.arange(256, max(step, 256), 256, device=rows.device)
    next_step = (tile_of_step[1:] == tile_of_step[:-1]).to(rows.device)
    geometry.update({
        "run_end_positions": int(torch.unique(
            position[ends.any(0)]).numel()),
        "four_row_lanes": int((lanes[..., 1:] != lanes[..., :-1]).all(-1)
                              .sum()),
        "one_row_warps": int(one_row.sum()),
        "whole_run_warps": int((one_row & opens & closes).sum()),
        "runs_over_pass": int(same[:, passes - 1].sum()),
        "runs_over_step_end": int((next_step & real[1:, 0] & real[:-1, -1]
                                   & (rows[1:, 0] == rows[:-1, -1])).sum())})
    return geometry


def onehot_case_holds(case, geometry) -> bool:
    """Whether a pack's ``onehot_step_geometry`` has the feature its
    ``onehot_adversary_arrays`` case aims at."""
    if case == "row_spans_steps":          # a run fills whole steps
        return geometry["one_row_steps"] > 1
    if case == "bucket_128":               # and padding-only steps beside it
        return (geometry["largest_bucket"] >= 128
                and geometry["padding_only_steps"] > 0)
    if case == "padding_only_steps":       # an empty tile beside a dense one
        lo, hi = geometry["tile_real_slots"]
        return (geometry["padding_only_steps"] > 0 and lo == 0
                and hi > geometry["k_step"])
    if case == "warp_run_edges":           # runs end everywhere in a warp
        return (geometry["run_end_positions"] == 128
                and geometry["four_row_lanes"] > 0
                and geometry["whole_run_warps"] > 0
                and geometry["one_row_warps"] > geometry["whole_run_warps"]
                and geometry["runs_over_pass"] > 0
                and geometry["runs_over_step_end"] > 0)
    return geometry["w_pad"] == 4096

# K12's adversary packs (``nnzsplit_adversary_arrays``): case -> (value
# dtype, index dtype, ks)
NNZ_ADVERSARIES = {
    "hub_fills_chunks": (torch.float32, torch.int32, 8),
    "run_crosses_pass": (torch.float32, torch.int32, 8),
    "r_pad_4096": (torch.float32, torch.int32, 8),
    "bf16_i16": (torch.bfloat16, torch.int16, 8),
}


def nnzsplit_adversary_arrays(case, seed):
    """A small matrix (dyadic values) whose nnz-split pack (``NNZ_ADVERSARIES``
    gives its dtypes and ks) stresses K11/K12's row runs:

      hub_fills_chunks  a star graph's centre: one row fills whole chunks,
                        so one thread per column adds 1,024 entries;
      run_crosses_pass  20 entries per row, 40 per row in the combined
                        stream: a row's run crosses entry 512 of a chunk,
                        where a pass of the kernel ends;
      r_pad_4096        two dense rows 3,999 apart in one chunk;
      bf16_i16          a power-law graph in bfloat16 values and int16
                        indices.

    Returns (ia, ja, ad, al, au)."""
    if case == "hub_fills_chunks":
        return star_arrays(5000, seed)
    if case == "run_crosses_pass":
        return random_arrays(3000, seed, dyadic=True)
    if case == "r_pad_4096":
        return gap_arrays(seed)
    return powerlaw_arrays(20000, seed, dyadic=True)


def nnzsplit_chunk_geometry(pack):
    """What the K11/K12 adversary cases aim at, read off an ``NnzSplitPack``:
    the chunks holding one row only, the runs cut by the end of a kernel
    pass (``csrc_spmv_nnzsplit._STAGE`` entries), r_pad and the dtypes."""
    from repro_torch.kernels.csrc_spmv_nnzsplit import _STAGE
    lrow = pack.lrow.long()
    cuts = torch.arange(_STAGE, pack.s, _STAGE)
    return {"r_pad": pack.r_pad, "s": pack.s,
            "one_row_chunks": int((lrow == lrow[:, :1]).all(1).sum()),
            "runs_across_passes": int((lrow[:, cuts - 1]
                                       == lrow[:, cuts]).sum()),
            "dtypes": [str(pack.vals.dtype), str(pack.lrow.dtype)]}


def nnzsplit_case_holds(case, geometry) -> bool:
    """Whether a pack's ``nnzsplit_chunk_geometry`` has the feature its
    ``nnzsplit_adversary_arrays`` case aims at."""
    if case == "hub_fills_chunks":
        return geometry["one_row_chunks"] > 0
    if case == "run_crosses_pass":
        return geometry["runs_across_passes"] > 0
    if case == "r_pad_4096":
        return geometry["r_pad"] == 4096
    return geometry["dtypes"] == ["torch.bfloat16", "torch.int16"]


ASM_ADVERSARIES = ("race_fan", "tile_over_one_pass", "empty_tile",
                   "empty_color", "i16_targets_32767")


def assembly_adversary(case, seed):
    """A small assembly (schedule built by the port, dyadic stiffness) whose
    colored packs stress K14's runs and passes (``ONEHOT_STAGE`` entries):

      race_fan            12,596 triangles around node 0 in two level-group
                          colors (RACE's serial chunks): color 0's run of
                          target 0 (4,096 entries) crosses a pass end and
                          closes exactly at the next, color 1's (8,500)
                          crosses four pass ends;
      tile_over_one_pass  greedy grid_tet(5), three DOFs per node: a tile's
                          buckets over all colors fill several passes;
      empty_tile          two grid_tri(8) patches 2,000 nodes apart: the
                          tiles between them get no entry of any color;
      empty_color         greedy grid_tri(4) with one more, empty, color;
      i16_targets_32767   one triangle whose vector has 32,767 entries: int16
                          targets, the sentinel at the int16 maximum.

    Returns (schedule, ke)."""
    import dataclasses as dc
    from repro_torch.assembly import conflict
    from repro_torch.assembly import mesh as amesh
    from repro_torch.assembly import scatter as asc
    from repro_torch.core.coloring import Coloring
    d, coloring = 1, None
    if case == "race_fan":
        ne = 4096 + 8500
        first = np.arange(1, ne + 1, dtype=np.int32)
        conn = np.stack([np.zeros(ne, np.int32), first, first + 1], 1)
        mesh = amesh.Mesh("fan", 2, np.zeros((ne + 2, 2)), conn)
        zeros = np.zeros(ne, np.int32)
        coloring = Coloring(
            color_of_row=(np.arange(ne) >= 4096).astype(np.int32),
            num_colors=2, rows_by_color=np.arange(ne, dtype=np.int32),
            color_ptr=np.asarray([0, 4096, ne], np.int32), provider="race",
            level_of_row=zeros, group_of_row=zeros)
    elif case == "tile_over_one_pass":
        mesh, d = amesh.grid_tet(5), 3
    elif case == "empty_tile":
        patch = amesh.grid_tri(8)
        conn = np.concatenate([patch.conn, patch.conn + 2000])
        mesh = amesh.Mesh("two_patches", 2,
                          np.zeros((2000 + patch.num_nodes, 2)), conn)
    elif case == "empty_color":
        mesh = amesh.grid_tri(4)
        col = conflict.color_elements(mesh.conn)
        coloring = dc.replace(col, num_colors=col.num_colors + 1,
                              color_ptr=np.append(col.color_ptr,
                                                  col.color_ptr[-1]))
    else:
        mesh = amesh.Mesh("one_triangle", 2, np.zeros((32761, 2)),
                          np.asarray([[0, 1, 32760]], np.int32))
    sched = asc.build_assembly_schedule(mesh, d, coloring=coloring)
    return sched, amesh.synthetic_stiffness(mesh, d, seed=seed)


def assembly_pack_geometry(packs):
    """What the K14 adversary cases aim at, read off ``ColoredPacks``: the
    longest run (one target's entries in one color), the most entries of
    one tile over all colors, the empty tiles that lie between tiles with
    entries, the empty colors, the target dtype and the vector's size."""
    tgts = packs.tgts.long().cpu()
    run = 0
    for c in range(packs.num_colors):
        real = tgts[c][tgts[c] != packs.size]
        if real.numel():
            run = max(run, int(torch.bincount(real).max()))
    ptr = packs.ptr.long().cpu()
    per_tile = (ptr[:, 1:] - ptr[:, :-1]).sum(0)
    full = torch.nonzero(per_tile).reshape(-1)
    inner = (per_tile[int(full.min()):int(full.max()) + 1] if full.numel()
             else per_tile[:0])
    return {"longest_run": run, "tile_entries_max": int(per_tile.max()),
            "empty_tiles_between": int((inner == 0).sum()),
            "empty_colors": int((ptr[:, -1] == 0).sum()),
            "target_dtype": str(packs.tgts.dtype), "size": packs.size}


def assembly_case_holds(case, geometry) -> bool:
    """Whether packs' ``assembly_pack_geometry`` has the feature their
    ``assembly_adversary`` case aims at."""
    from repro_torch.kernels.assembly_scatter import ONEHOT_STAGE
    if case == "race_fan":
        return geometry["longest_run"] > 2 * ONEHOT_STAGE
    if case == "tile_over_one_pass":
        return geometry["tile_entries_max"] > ONEHOT_STAGE
    if case == "empty_tile":
        return geometry["empty_tiles_between"] > 0
    if case == "empty_color":
        return geometry["empty_colors"] > 0
    return (geometry["target_dtype"] == "torch.int16"
            and geometry["size"] == 32767)


def poisson_arrays(side):
    """The 5-point Laplacian on a side x side grid, the class of
    ``csrc.poisson2d``: diagonal 4, -1 to each grid neighbour (row-major
    lower slots: the row above, then the left neighbour)."""
    n = side * side
    i = np.arange(n, dtype=np.int64)
    hi = np.concatenate([i[i >= side], i[i % side > 0]])
    lo = np.concatenate([i[i >= side] - side, i[i % side > 0] - 1])
    ia, ja, _ = _lower_from_pairs(n, hi, lo)
    al = -np.ones(ja.shape[0], dtype=np.float32)
    return ia, ja, np.full(n, 4.0, dtype=np.float32), al, al


def rect_estimate(M, tm=128, k_step=1024):
    """pad_ratio and streamed bytes the rectangular pack of ``M`` (float32
    values, int32 indices) would have, from its tile slot counts alone
    (nothing is packed: on a skewed matrix that pack is many gigabytes)."""
    from repro_torch.core.csrc import bandwidth, row_of_slot
    from repro_torch.core.plan import kernel_window
    n = M.n
    nt = -(-n // tm)
    counts = np.bincount(row_of_slot(M) // tm, minlength=nt)
    s = max(k_step, -(-int(counts.max()) // k_step) * k_step)
    w_pad = kernel_window(tm, bandwidth(M))
    streams = (3 if M.numerically_symmetric else 4) * 4 * nt * s
    bytes_ = streams + 4 * nt * tm + 4 * (nt * tm + w_pad) + 4 * nt * w_pad
    return {"s": s, "pad_ratio": nt * s / max(1, int(M.ja.shape[0])),
            "streamed_bytes": bytes_}


def scipy_csr(n, ia, ja, ad, al, au):
    """Float64 CSR of the same matrix, independent of the port."""
    import scipy.sparse as sp
    ros = np.repeat(np.arange(n, dtype=np.int64), np.diff(ia))
    ja64 = ja.astype(np.int64)
    diag = np.arange(n, dtype=np.int64)
    rows = np.concatenate([ros, ja64, diag])
    cols = np.concatenate([ja64, ros, diag])
    vals = np.concatenate([al, au, ad]).astype(np.float64)
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()


def dyadic_vector(rng, shape):
    return (rng.integers(-8, 9, size=shape) / 8.0).astype(np.float32)


def _event_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_ms(fn) -> float:
    """Milliseconds per call, CUDA events: one warm-up call, one timed
    call, then as many more (at most 10) as fit in about half a second."""
    fn()
    torch.cuda.synchronize()
    first = _event_ms(fn, 1)
    reps = max(1, min(10, int(500.0 / max(first, 1e-3))))
    return first if reps == 1 else _event_ms(fn, reps)


def abs_pack(pack):
    from repro_torch.kernels.csrc_spmv_nnzsplit import NnzSplitPack
    if isinstance(pack, NnzSplitPack):
        return dataclasses.replace(pack, vals=pack.vals.abs(),
                                   ad=pack.ad.abs())
    return dataclasses.replace(
        pack, vals_l=pack.vals_l.abs(),
        vals_u=pack.vals_l.abs() if pack.num_symmetric else pack.vals_u.abs(),
        ad=pack.ad.abs())


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_env():
    from repro_torch import device as device_mod
    from repro_torch.kernels import _build
    card = device_mod.power_limit()
    check(card is not None, "nvidia-smi did not report the card")
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=_build.nvcc_version(),
         card=card, sm_count=device_mod.sm_count("cuda"),
         matmul_tf32=bool(torch.backends.cuda.matmul.allow_tf32))
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls must run in full precision for the plain versions")
    return card


def phase_build(verbose: bool):
    from repro_torch.kernels import _build
    info = _build.build(verbose=verbose)
    if verbose:
        for name, log in info["log"].items():
            print(f"--- nvcc {name}\n{log}", flush=True)
    emit("build", seconds=round(info["seconds"], 3),
         compiled=info["compiled"], build_dir=_build.build_dir())


def _runners(pack, ks):
    """name -> (kernel wrapper, plain version), for x (n,) and X (n, B), of
    a rectangular (K1-K4), a flat (K5-K8) or an nnz-split (K9-K12) pack.
    The window kernels return (NT, W[, B]) windows, the chunk kernels
    (C, r_pad[, B]) partials."""
    from repro_torch.kernels import csrc_spmm as mm
    from repro_torch.kernels import csrc_spmv as mv
    from repro_torch.kernels import csrc_spmv_flat as fl
    from repro_torch.kernels import csrc_spmv_nnzsplit as nz
    if isinstance(pack, nz.NnzSplitPack):
        return {
            "nnzsplit_spmv_stream": (
                lambda x: nz.nnzsplit_spmv_stream_cuda(pack, x),
                lambda x: nz.nnzsplit_partials_stream_plain(pack, x)),
            "nnzsplit_spmv_onehot": (
                lambda x: nz.nnzsplit_spmv_onehot_cuda(pack, x),
                lambda x: nz.nnzsplit_partials_onehot_plain(pack, x)),
            "nnzsplit_spmm_stream": (
                lambda x: nz.nnzsplit_spmm_stream_cuda(pack, x),
                lambda x: nz.nnzsplit_partials_stream_plain(pack, x)),
            "nnzsplit_spmm_onehot": (
                lambda x: nz.nnzsplit_spmm_onehot_cuda(pack, x),
                lambda x: nz.nnzsplit_partials_onehot_plain(pack, x)),
        }
    if isinstance(pack, fl.FlatBlockEll):
        return {
            "flat_spmv_stream": (
                lambda x: fl.flat_spmv_stream_cuda(pack, x),
                lambda x: fl.flat_windows_stream_plain(pack, x)),
            "flat_spmv_onehot": (
                lambda x: fl.flat_spmv_onehot_cuda(pack, x),
                lambda x: fl.flat_windows_onehot_plain(pack, x)),
            "flat_spmm_stream": (
                lambda x: fl.flat_spmm_stream_cuda(pack, x),
                lambda x: fl.flat_windows_stream_plain(pack, x)),
            "flat_spmm_onehot": (
                lambda x: fl.flat_spmm_onehot_cuda(pack, x),
                lambda x: fl.flat_windows_onehot_plain(pack, x)),
        }
    k_step = ks * 128
    return {
        "blockell_spmv_stream": (
            lambda x: mv.spmv_windows_stream_cuda(pack, x),
            lambda x: mv.spmv_windows_stream_plain(pack, x)),
        "blockell_spmv_onehot": (
            lambda x: mv.spmv_windows_onehot_cuda(pack, x, k_step),
            lambda x: mv.spmv_windows_onehot_plain(pack, x, k_step)),
        "blockell_spmm_stream": (
            lambda x: mm.spmm_windows_stream_cuda(pack, x),
            lambda x: mm.spmm_windows_stream_plain(pack, x)),
        "blockell_spmm_onehot": (
            lambda x: mm.spmm_windows_onehot_cuda(pack, x, k_step),
            lambda x: mm.spmm_windows_onehot_plain(pack, x, k_step)),
    }


def _compare(name, kernel, plain, x, exact, abs_plain=None):
    """Kernel against plain on the card; returns the max abs error."""
    got = kernel(x)
    want = plain(x)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = float((got - want).abs().max())
    if exact:
        check(torch.equal(got, want),
              f"{name}: differs from its plain version on dyadic data "
              f"(max abs err {err})")
    else:
        bound = TOL * abs_plain(x.abs()) + 1e-30
        check(bool(((got - want).abs() <= bound).all()),
              f"{name}: exceeds {TOL} of the row's absolute sum "
              f"(max abs err {err})")
    if "onehot" in name:      # K3, K4, K7, K8, K11, K12: a fixed order
        check(torch.equal(got, kernel(x)),
              f"{name}: two runs on the same input differ")
    return err


def phase_kernels(seed: int):
    """K1-K14 against their plain versions at small and mid shapes."""
    from repro_torch.core import blockell, csrc
    from repro_torch.kernels import csrc_spmv_flat as fl
    rng = np.random.default_rng(seed + 1)
    f32, bf16, i32, i16 = (torch.float32, torch.bfloat16, torch.int32,
                           torch.int16)
    cases = [
        # name, grid, n, half_band (wide for flat), fill, symmetric, dyadic,
        # dtype, idx, tm, ks, Bs
        ("f32_i32_ns_dyadic", "rect", 1000, 24, 0.6, False, True,
         f32, i32, 128, 8, (1, 3, 8, 64)),
        ("bf16_i16_sym_dyadic", "rect", 4133, 24, 0.6, True, True,
         bf16, i16, 128, 8, (1, 3, 8)),
        ("f32_i16_ns_empty_rows", "rect", 2500, 40, 0.5, False, True,
         f32, i16, 32, 2, (1, 8)),
        ("f32_i32_sym_general", "rect", 3001, 24, 0.6, True, False,
         f32, i32, 128, 8, (1, 8)),
        ("f32_i32_ns_general", "rect", 3001, 24, 0.6, False, False,
         f32, i32, 128, 8, (1, 3)),
        # B=3 leaves a partial column tile (BT=2 for K2) at this window
        ("wide_band_w4096", "rect", 8192, 3900, 0.05, False, True,
         f32, i32, 128, 8, (1, 3, 8)),
        # flat grid: skewed matrices whose tiles carry 1 to many k-steps
        ("flat_f32_i32_ns_dyadic", "flat", 3000, 200, 1.0, False, True,
         f32, i32, 128, 2, (1, 3, 8, 64)),
        ("flat_bf16_i16_sym_dyadic", "flat", 4133, 100, 1.0, True, True,
         bf16, i16, 128, 8, (1, 3, 8)),
        ("flat_f32_i16_ns_empty_rows", "flat", 2500, 150, 0.5, False, True,
         f32, i16, 32, 1, (1, 8)),
        ("flat_f32_i32_sym_general", "flat", 3001, 200, 1.0, True, False,
         f32, i32, 128, 2, (1, 8)),
        ("flat_f32_i32_ns_general", "flat", 3001, 200, 1.0, False, False,
         f32, i32, 128, 2, (1, 3)),
        # the flat main path's geometry (W = 640, 64-step tiles) at 1/32 size
        ("flat_skew_w640", "flat", 65536, SKEW_WIDE, 1.0, False, True,
         f32, i32, 128, 8, (1, 11)),
        # the wide rows (6 % of n) must reach past 3,900 for W = 4096
        ("flat_wide_band_w4096", "flat", 70000, 3900, 0.05, False, True,
         f32, i32, 128, 8, (1, 3, 8)),
    ]
    report = []
    for (name, grid, n, hb, fill, sym, dyadic, vdt, idt, tm, ks,
         widths) in cases:
        empty = slice(700, 1100) if "empty" in name else None
        case_seed = seed + len(report)
        if grid == "rect":
            arrays = band_arrays(n, hb, fill, case_seed, sym, dyadic=dyadic,
                                 empty_rows=empty)
            M = csrc.from_assembly(n, *arrays)
            pack = blockell.pack(M, tm=tm, k_step=ks * 128, dtype=vdt,
                                 index_dtype=idt).to("cuda")
            geometry = {"s": pack.s}
        else:
            arrays = skew_arrays(n, hb, SKEW_NARROW, case_seed, sym,
                                 fill=fill, dyadic=dyadic, empty_rows=empty)
            M = csrc.from_assembly(n, *arrays)
            pack = fl.pack_flat(M, tm=tm, ks=ks, dtype=vdt,
                                index_dtype=idt).to("cuda")
            steps = torch.diff(pack.step_start.cpu())
            geometry = {"total_steps": pack.total_steps,
                        "steps_per_tile": [int(steps.min()),
                                           int(steps.max())]}
            check(int(steps.min()) == 1 and int(steps.max()) > 1,
                  f"{name}: tiles should carry 1 to many steps, got "
                  f"{geometry['steps_per_tile']}")
        if "w4096" in name:
            check(pack.w_pad == 4096, f"{name}: window {pack.w_pad}")
        runners = _runners(pack, ks)
        abs_runners = _runners(abs_pack(pack), ks)
        errs = {}
        for width in widths:
            shape = (n,) if width == 1 else (n, width)
            x_np = (dyadic_vector(rng, shape) if dyadic
                    else rng.standard_normal(shape, dtype=np.float32))
            x = torch.from_numpy(x_np).cuda()
            for kname, (kernel, plain) in runners.items():
                if ("spmv" in kname) != (width == 1):
                    continue
                err = _compare(f"{name}/{kname}/B{width}", kernel, plain, x,
                               exact=dyadic, abs_plain=abs_runners[kname][1])
                errs[f"{kname}/B{width}"] = err
        report.append({"case": name, "n": n, "nt": pack.nt, **geometry,
                       "w_pad": pack.w_pad,
                       "pad_ratio": round(pack.pad_ratio, 4),
                       "exact": dyadic, "max_err": max(errs.values())})
        del pack, runners, abs_runners
        torch.cuda.empty_cache()
    report += _flat_onehot_cases(seed, rng)
    report += _nnzsplit_kernel_cases(seed, rng)
    report += _nnzsplit_adversary_cases(seed, rng)
    report += _assembly_kernel_cases(seed)
    report += _rect_onehot_cases(seed, rng)
    emit("kernels", tolerance=f"exact on dyadic data, else {TOL} of the "
         "row's absolute sum", cases=report)


def _exact_runs(name, runners, n, rng, widths=(1, 3, 11, 64)):
    """Every runner against its plain version on dyadic x at ``widths``,
    exactly; returns the errors by kernel and width."""
    errs = {}
    for width in widths:
        shape = (n,) if width == 1 else (n, width)
        x = torch.from_numpy(dyadic_vector(rng, shape)).cuda()
        for kname, (kernel, plain) in runners.items():
            if ("spmv" in kname) != (width == 1):
                continue
            errs[f"{kname}/B{width}"] = _compare(
                f"{name}/{kname}/B{width}", kernel, plain, x, exact=True)
    return errs


def _rect_onehot_cases(seed, rng):
    """K1-K4 on rectangular packs that stress K3/K4's runs and buckets and
    K1/K2's warp runs (see ``onehot_adversary_arrays``), exact on dyadic
    data at B = 1, 3, 11 and 64; the cases leave K2/K4 partial column
    tiles (tiles of 7 columns at W = 1,152, of 2 at W = 3,200 and 4,096,
    of 21 at W = 384; warp_run_edges at W = 512 takes four whole tiles of
    16)."""
    from repro_torch.core import blockell, csrc
    from repro_torch.kernels.csrc_spmm import column_tile
    cases = [
        # name, generator case, dtype, idx, ks
        ("rect_row_spans_steps", "row_spans_steps", torch.float32,
         torch.int32, 1),
        ("rect_bucket_128", "bucket_128", torch.float32, torch.int32, 8),
        ("rect_padding_only_steps", "padding_only_steps", torch.float32,
         torch.int32, 8),
        ("rect_w4096_bf16_i16", "w4096", torch.bfloat16, torch.int16, 8),
        ("rect_warp_run_edges", "warp_run_edges", torch.float32,
         torch.int32, 8),
    ]
    report = []
    for name, case, vdt, idt, ks in cases:
        arrays = onehot_adversary_arrays(case, seed + 60 + len(report))
        n = arrays[0].shape[0] - 1
        M = csrc.from_assembly(n, *arrays)
        step = ks * 128
        pack = blockell.pack(M, k_step=step, dtype=vdt,
                             index_dtype=idt).to("cuda")
        geometry = onehot_step_geometry(pack, step)
        geometry["k4_column_tiles"] = {b: column_tile(pack.w_pad, b, 2)
                                       for b in (3, 64)}
        check(onehot_case_holds(case, geometry),
              f"{name}: the pack misses its feature ({geometry})")
        errs = _exact_runs(name, _runners(pack, ks), n, rng)
        report.append({"case": name, "n": n, "nt": pack.nt, **geometry,
                       "exact": True, "max_err": max(errs.values())})
        del pack
        torch.cuda.empty_cache()
    return report


def _flat_onehot_cases(seed, rng):
    """K5-K8 on flat packs that stress K7/K8's runs and buckets and K5/K6's
    warp runs (see ``onehot_adversary_arrays``), exact on dyadic data at
    B = 1, 3, 11 and 64; the cases leave K6/K8 partial column tiles
    (tiles of 7 columns at W = 1,152, of 2 at W = 3,200 and 4,096;
    warp_run_edges at W = 512 takes four whole tiles of 16)."""
    from repro_torch.core import csrc
    from repro_torch.kernels import csrc_spmv_flat as fl
    from repro_torch.kernels.csrc_spmm import column_tile
    cases = [
        # name, generator case, dtype, idx, ks
        ("flat_row_spans_steps", "row_spans_steps", torch.float32,
         torch.int32, 1),
        ("flat_bucket_128_padding_step", "bucket_128", torch.float32,
         torch.int32, 8),
        ("flat_w4096_bf16_i16", "w4096", torch.bfloat16, torch.int16, 8),
        ("flat_warp_run_edges_bf16_i16", "warp_run_edges", torch.bfloat16,
         torch.int16, 8),
    ]
    report = []
    for name, case, vdt, idt, ks in cases:
        arrays = onehot_adversary_arrays(case, seed + 50 + len(report))
        n = arrays[0].shape[0] - 1
        M = csrc.from_assembly(n, *arrays)
        pack = fl.pack_flat(M, ks=ks, dtype=vdt, index_dtype=idt).to("cuda")
        geometry = onehot_step_geometry(pack, pack.step)
        geometry["k8_column_tiles"] = {b: column_tile(pack.w_pad, b, 2)
                                       for b in (3, 64)}
        check(onehot_case_holds(case, geometry),
              f"{name}: the pack misses its feature ({geometry})")
        errs = _exact_runs(name, _runners(pack, ks), n, rng)
        report.append({"case": name, "n": n, "nt": pack.nt, **geometry,
                       "exact": True, "max_err": max(errs.values())})
        del pack
        torch.cuda.empty_cache()
    return report


def _nnzsplit_kernel_cases(seed, rng):
    """K9-K12 against their plain versions on their (C, r_pad[, B])
    partials (the fix-up adds in atomic order on the card, the partials do
    not)."""
    from repro_torch.core import csrc
    from repro_torch.kernels import csrc_spmv_nnzsplit as nz
    f32, bf16, i32, i16 = (torch.float32, torch.bfloat16, torch.int32,
                           torch.int16)
    cases = [
        # name, arrays(seed), dtype, idx, ks, Bs, dyadic
        ("nz_f32_i32_ns_dyadic",
         lambda sd: random_arrays(3000, sd, dyadic=True),
         f32, i32, 8, (1, 3, 8, 64), True),
        ("nz_bf16_i16_sym_dyadic",
         lambda sd: powerlaw_arrays(20000, sd, dyadic=True),
         bf16, i16, 8, (1, 3, 8), True),
        ("nz_f32_i16_ns_empty_rows",
         lambda sd: random_arrays(2500, sd, dyadic=True,
                                  empty_rows=slice(700, 1100)),
         f32, i16, 1, (1, 8), True),
        ("nz_f32_i32_sym_general",
         lambda sd: powerlaw_arrays(5000, sd, general=True),
         f32, i32, 8, (1, 8), False),
        ("nz_f32_i32_ns_general", lambda sd: random_arrays(3001, sd),
         f32, i32, 1, (1, 3), False),
        # the power-law main path's geometry at 1/32 size
        ("nz_powerlaw_main_geometry",
         lambda sd: powerlaw_arrays(65536, sd, dyadic=True),
         f32, i32, 8, (1, 11), True),
    ]
    report = []
    for name, make, vdt, idt, ks, widths, dyadic in cases:
        arrays = make(seed + 50 + len(report))
        n = arrays[0].shape[0] - 1
        M = csrc.from_assembly(n, *arrays)
        pack = nz.pack_nnzsplit(M, ks=ks, dtype=vdt,
                                index_dtype=idt).to("cuda")
        hub_chunks = int(torch.bincount(pack.chunk_row0.long()).max())
        runners = _runners(pack, ks)
        abs_runners = _runners(abs_pack(pack), ks)
        errs = {}
        for width in widths:
            shape = (n,) if width == 1 else (n, width)
            x_np = (dyadic_vector(rng, shape) if dyadic
                    else rng.standard_normal(shape, dtype=np.float32))
            x = torch.from_numpy(x_np).cuda()
            for kname, (kernel, plain) in runners.items():
                if ("spmv" in kname) != (width == 1):
                    continue
                errs[f"{kname}/B{width}"] = _compare(
                    f"{name}/{kname}/B{width}", kernel, plain, x,
                    exact=dyadic, abs_plain=abs_runners[kname][1])
        report.append({"case": name, "n": n, "ks": ks,
                       "num_chunks": pack.num_chunks, "r_pad": pack.r_pad,
                       "chunks_of_largest_row": hub_chunks,
                       "pad_ratio": round(pack.pad_ratio, 4),
                       "exact": dyadic, "max_err": max(errs.values())})
        del pack, runners, abs_runners
        torch.cuda.empty_cache()
    return report


def _nnzsplit_adversary_cases(seed, rng):
    """K9-K12 on the packs of ``nnzsplit_adversary_arrays`` (each checked
    for its feature first), exact on dyadic data: K9/K11 on x (n,), K10/K12
    on X (n, B) at B = 1, 3, 11 and 64 — B = 1 through the SpMM entry, and
    at B = 64 K12 runs several column tiles."""
    from repro_torch.core import csrc
    from repro_torch.kernels import csrc_spmv_nnzsplit as nz
    report = []
    for case, (vdt, idt, ks) in NNZ_ADVERSARIES.items():
        arrays = nnzsplit_adversary_arrays(case, seed + 70 + len(report))
        n = arrays[0].shape[0] - 1
        M = csrc.from_assembly(n, *arrays)
        pack = nz.pack_nnzsplit(M, ks=ks, dtype=vdt,
                                index_dtype=idt).to("cuda")
        geometry = nnzsplit_chunk_geometry(pack)
        check(nnzsplit_case_holds(case, geometry),
              f"nz_{case}: the pack misses its feature ({geometry})")
        geometry["k12_column_tiles"] = {
            b: nz._onehot_tile(pack.r_pad, b) for b in (3, 11, 64)}
        errs = {}
        for width in (None, 1, 3, 11, 64):
            shape = (n,) if width is None else (n, width)
            x = torch.from_numpy(dyadic_vector(rng, shape)).cuda()
            for kname, (kernel, plain) in _runners(pack, ks).items():
                if ("spmv" in kname) != (width is None):
                    continue
                tag = f"{kname}/B{width or 1}"
                errs[tag] = _compare(f"nz_{case}/{tag}", kernel, plain, x,
                                     exact=True)
        report.append({"case": f"nz_{case}", "n": n, "ks": ks,
                       "num_chunks": pack.num_chunks, **geometry,
                       "exact": True, "max_err": max(errs.values())})
        del pack
        torch.cuda.empty_cache()
    return report


def path_specs(n: int, seed: int):
    """The three main-path runs: per path, its matrices, the plan each is
    registered with (None: the default heuristic plan), the (path,
    variant) each must run, which matrix is refreshed and solved by CG
    (symmetric) and by BiCGSTAB, and where each of its kernels is timed."""
    from repro_torch.core.plan import ExecutionPlan
    kernel_stream = ExecutionPlan(path="kernel", variant="stream")
    flat_stream = ExecutionPlan(path="flat", variant="stream")
    flat_onehot = ExecutionPlan(path="flat", variant="onehot")
    nz_stream = ExecutionPlan(path="nnzsplit", variant="stream")
    nz_onehot = ExecutionPlan(path="nnzsplit", variant="onehot")
    return [
        {"name": "kernel",
         "matrices": {
             "fem_ns": lambda: band_arrays(n, HALF_BAND, FILL, seed + 100,
                                           False),
             "fem_sym": lambda: band_arrays(n, HALF_BAND, FILL, seed + 101,
                                            True)},
         "plans": {"fem_ns": None, "fem_sym": kernel_stream},
         "expect": {"fem_ns": ("kernel", "onehot"),
                    "fem_sym": ("kernel", "stream")},
         "sym": "fem_sym", "ns": "fem_ns",
         "kernels": {"blockell_spmv_stream": ("fem_sym", 1),
                     "blockell_spmm_stream": ("fem_sym", 11),
                     "blockell_spmv_onehot": ("fem_ns", 1),
                     "blockell_spmm_onehot": ("fem_ns", 11)}},
        {"name": "flat",
         "matrices": {
             "skew_ns": lambda: skew_arrays(n, SKEW_WIDE, SKEW_NARROW,
                                            seed + 200, False),
             "skew_sym": lambda: skew_arrays(n, SKEW_WIDE, SKEW_NARROW,
                                             seed + 201, True)},
         "plans": {"skew_ns": flat_onehot, "skew_sym": flat_stream},
         "expect": {"skew_ns": ("flat", "onehot"),
                    "skew_sym": ("flat", "stream")},
         "sym": "skew_sym", "ns": "skew_ns",
         "kernels": {"flat_spmv_stream": ("skew_sym", 1),
                     "flat_spmm_stream": ("skew_sym", 11),
                     "flat_spmv_onehot": ("skew_ns", 1),
                     "flat_spmm_onehot": ("skew_ns", 11)}},
        {"name": "nnzsplit",
         "matrices": {
             "pl_sym": lambda: powerlaw_arrays(n, seed + 300),
             "rand_ns": lambda: random_arrays(n, seed + 301)},
         "plans": {"pl_sym": nz_stream, "rand_ns": nz_onehot},
         "expect": {"pl_sym": ("nnzsplit", "stream"),
                    "rand_ns": ("nnzsplit", "onehot")},
         "sym": "pl_sym", "ns": "rand_ns", "unstructured": True,
         "kernels": {"nnzsplit_spmv_stream": ("pl_sym", 1),
                     "nnzsplit_spmm_stream": ("pl_sym", 11),
                     "nnzsplit_spmv_onehot": ("rand_ns", 1),
                     "nnzsplit_spmm_onehot": ("rand_ns", 11)}},
    ]


def unstructured_gate(M):
    """Assert what makes ``M`` a matrix for the nnzsplit path: the tuner's
    gate passes, and both windowed paths are infeasible (the window of a
    128-row tile exceeds w_cap)."""
    from repro_torch.core import tuner
    from repro_torch.core.paths import nnzsplit_worth_measuring
    from repro_torch.core.plan import ExecutionPlan, feasible, kernel_window
    st = tuner.stats_of(M)
    window = kernel_window(128, st.bandwidth)
    check(nnzsplit_worth_measuring(st), "nnzsplit gate refuses the matrix")
    for path in ("kernel", "flat"):
        check(not feasible(ExecutionPlan(path=path), n=st.n, m=st.m,
                           bandwidth=st.bandwidth),
              f"the {path} path could window this matrix ({window})")
    return {"bandwidth": st.bandwidth, "window": window,
            "w_cap": ExecutionPlan().w_cap,
            "nnz_row_cov": round(st.nnz_row_dev / st.nnz_row_mean, 3),
            "max_row_nnz": int(np.max(np.diff(M.ia.numpy())
                                      + np.bincount(M.ja.numpy(),
                                                    minlength=M.n)) + 1)}


class Workload:
    """One path's serve/solve matrices, their references and requests."""

    def __init__(self, n: int, seed: int, spec):
        from repro_torch.core import csrc
        self.n = n
        self.arrays = {}
        self.M = {}
        self.csr = {}
        t0 = time.perf_counter()
        for mid, make in spec["matrices"].items():
            arr = make()
            self.arrays[mid] = arr
            self.M[mid] = csrc.from_assembly(n, *arr)
        self.construct_s = time.perf_counter() - t0
        self.gates = ({mid: unstructured_gate(M) for mid, M in self.M.items()}
                      if spec.get("unstructured") else None)
        t0 = time.perf_counter()
        for mid, arr in self.arrays.items():
            self.csr[mid] = scipy_csr(n, *arr)
        self.scipy_s = time.perf_counter() - t0
        rng = np.random.default_rng(seed + 7)
        self.sample = np.sort(rng.choice(n, size=min(n, 4096), replace=False))
        self.rng = rng

    def check_answers(self, csr, X, Y, segment_op, abs_op, what):
        """Y (n, B) float32 answers for X: sampled rows against the float64
        scipy product ``csr @ X``, all rows against the port's segment
        path.  Both sides round, so the bound is twice ``TOL`` of the
        row's absolute sum (``abs_op`` applies |A|)."""
        check(Y.shape == X.shape and Y.dtype == np.float32,
              f"{what}: shape/dtype {Y.shape} {Y.dtype}")
        check(bool(np.isfinite(Y).all()), f"{what}: non-finite answer")
        X_dev = torch.from_numpy(X).cuda()
        abs_rows = abs_op(X_dev.abs())
        want = np.asarray(csr[self.sample] @ X.astype(np.float64))
        err = np.abs(Y[self.sample] - want)
        bound = 2 * TOL * abs_rows[torch.from_numpy(self.sample).cuda()]
        check(bool((err <= bound.cpu().numpy().astype(np.float64)
                    + 1e-30).all()),
              f"{what}: sampled rows differ from the float64 reference "
              f"(max {err.max()})")
        dev = (torch.from_numpy(Y).cuda() - segment_op(X_dev)).abs()
        check(bool((dev <= 2 * TOL * abs_rows + 1e-30).all()),
              f"{what}: differs from the segment path "
              f"(max {float(dev.max())})")
        return float(err.max()), float(dev.max())


def _pack_report(M, pack):
    from repro_torch.kernels.csrc_spmv_flat import FlatBlockEll
    from repro_torch.kernels.csrc_spmv_nnzsplit import NnzSplitPack
    if isinstance(pack, NnzSplitPack):
        return {"num_chunks": pack.num_chunks, "ks": pack.ks,
                "r_pad": pack.r_pad, "pad_ratio": round(pack.pad_ratio, 4),
                "chunks_of_largest_row": int(torch.bincount(
                    pack.chunk_row0.long()).max()),
                "streamed_bytes": pack.streamed_bytes()}
    out = {"nt": pack.nt, "w_pad": pack.w_pad,
           "pad_ratio": round(pack.pad_ratio, 4),
           "streamed_bytes": pack.streamed_bytes()}
    if isinstance(pack, FlatBlockEll):
        steps = torch.diff(pack.step_start.cpu())
        out.update(total_steps=pack.total_steps,
                   steps_per_tile=[int(steps.min()), int(steps.max())],
                   rect_estimate=rect_estimate(M, pack.tm, pack.step))
    else:
        out["s"] = pack.s
    return out


def phase_serve(work: Workload, spec):
    from repro_torch import obs
    from repro_torch.core import csrc
    from repro_torch.core.paths import BUILD_COUNTS
    from repro_torch.kernels.ops import SpmvOperator
    from repro_torch.serve import SpmvServingEngine

    mids = list(spec["matrices"])
    eng = SpmvServingEngine()          # default device: the card
    obs.clear_trace()
    t0 = time.perf_counter()
    plans = {mid: eng.register(mid, work.M[mid], plan=spec["plans"][mid])
             for mid in mids}
    register_s = time.perf_counter() - t0
    spans = {}
    for rec in obs.trace():        # pack and partition, summed over both
        if rec["name"].startswith("schedule."):
            spans[rec["name"]] = round(
                spans.get(rec["name"], 0.0) + rec["duration_s"], 3)
    for mid, plan in plans.items():
        check((plan.path, plan.variant) == spec["expect"][mid],
              f"{mid}: plan is {plan.key()}, expected "
              f"{spec['expect'][mid]}")
        if spec["plans"][mid] is not None:
            check(plan.key() == spec["plans"][mid].key(),
                  f"{mid}: explicit plan not honoured")
    segment = {mid: SpmvOperator(work.M[mid], path="segment")
               for mid in mids}
    segment_abs = {mid: SpmvOperator(csrc_abs(work.n, *arr), path="segment")
                   for mid, arr in work.arrays.items()}

    n = work.n
    # 24 requests over both matrices, in two waves: a wave of 11 + 11 is
    # answered by one coalesced SpMM per matrix, a wave of 1 + 1 by one SpMV
    waves = []
    for per_matrix in (11, 1):
        sent = {}
        for mid in mids:
            for _ in range(per_matrix):
                x = work.rng.standard_normal(n, dtype=np.float32)
                sent[eng.submit(mid, x)] = (mid, x)
        t_tick = time.perf_counter()
        out = eng.run_until_drained()
        tick_s = time.perf_counter() - t_tick
        check(set(out) == set(sent), "not every request was answered")
        check(not eng.queue, "queue not drained")
        execute_s = {}
        for mid in mids:
            uids = [u for u, (m, _) in sent.items() if m == mid]
            for u in uids:
                r = out[u]
                check(r.batched == per_matrix
                      and r.plan_key == plans[mid].key()
                      and r.executor == "local" and r.matrix_id == mid
                      and r.path == spec["expect"][mid][0]
                      and r.strategy == "local",
                      f"result metadata wrong: {r.meta()}")
                check(r.timings["execute_s"] > 0, "no execute_s timing")
            X = np.stack([sent[u][1] for u in uids], axis=1)
            Y = np.stack([np.asarray(out[u]) for u in uids], axis=1)
            errs = work.check_answers(work.csr[mid], X, Y, segment[mid],
                                      segment_abs[mid],
                                      f"serve {mid} B={per_matrix}")
            execute_s[mid] = {"execute_s": out[uids[0]].timings["execute_s"],
                              "err_vs_float64": errs[0],
                              "err_vs_segment": errs[1]}
        waves.append({"requests_per_matrix": per_matrix,
                      "tick_s": round(tick_s, 4), **execute_s})

    # value refresh: same structure, new values -> no pack, no partition
    sym = spec["sym"]
    ia, ja, ad, al, _ = work.arrays[sym]
    M_t = csrc.from_assembly(n, ia, ja, 0.5 * ad, 0.5 * al, 0.5 * al)
    csr_t = (0.5 * work.csr[sym]).tocsr()
    before = dict(BUILD_COUNTS.items())
    t0 = time.perf_counter()
    eng.update_values(sym, M_t)
    refresh_s = time.perf_counter() - t0
    x = work.rng.standard_normal(n, dtype=np.float32)
    uid = eng.submit(sym, x)
    out = eng.run_until_drained()
    delta = {k: v - before.get(k, 0) for k, v in BUILD_COUNTS.items()}
    check(delta.get("value_refresh") == 1
          and not any(delta.get(k) for k in STRUCTURAL_BUILDS),
          f"value refresh rebuilt structure: {delta}")
    seg_t = SpmvOperator(M_t, path="segment")
    work.check_answers(csr_t, x[:, None], np.asarray(out[uid])[:, None],
                       seg_t, segment_abs[sym], f"serve {sym} after refresh")
    # back to the registered values for the solve phase
    eng.update_values(sym, work.M[sym])

    emit("serve", path=spec["name"], n=n, requests=2 * (11 + 1) + 1,
         nnz={mid: int(M.nnz) for mid, M in work.M.items()},
         construct_s=round(work.construct_s, 3),
         scipy_reference_s=round(work.scipy_s, 3),
         register_s=round(register_s, 3), register_spans_s=spans,
         refresh_s=round(refresh_s, 3),
         plans={mid: plan.key() for mid, plan in plans.items()},
         pack={mid: _pack_report(work.M[mid], eng.executor(mid).op.pack)
               for mid in mids},
         build_counts=dict(BUILD_COUNTS.items()), waves=waves,
         **({"unstructured": work.gates} if work.gates else {}))
    return eng


def phase_solve(work: Workload, eng, spec):
    from repro_torch.core import solvers

    n = work.n
    sym, ns = spec["sym"], spec["ns"]
    b = work.rng.standard_normal((n, 8), dtype=np.float32)
    t0 = time.perf_counter()
    res, op = solvers.cg_solve(
        work.M[sym], torch.from_numpy(b), cache=eng.cache,
        plan=spec["plans"][sym], tol=1e-6)
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    check(res.converged, f"cg did not converge: {res.residual}")
    x = res.x.cpu().numpy().astype(np.float64)
    r = b - work.csr[sym] @ x
    cg_true = float(np.max(np.linalg.norm(r, axis=0)
                           / np.linalg.norm(b, axis=0)))
    check(cg_true <= 1e-5, f"cg true residual {cg_true}")

    b1 = work.rng.standard_normal(n, dtype=np.float32)
    op_ns = eng.executor(ns).op
    t0 = time.perf_counter()
    res2 = solvers.bicgstab(op_ns, torch.from_numpy(b1).cuda(), tol=1e-6)
    torch.cuda.synchronize()
    bi_s = time.perf_counter() - t0
    check(res2.converged, f"bicgstab did not converge: {res2.residual}")
    x2 = res2.x.cpu().numpy().astype(np.float64)
    r2 = b1 - work.csr[ns] @ x2
    bi_true = float(np.linalg.norm(r2) / np.linalg.norm(b1))
    check(bi_true <= 1e-5, f"bicgstab true residual {bi_true}")
    emit("solve", path=spec["name"],
         cg={"matrix": sym, "nrhs": 8, "plan": op.plan.key(),
             "iters": res.iters, "residual": res.residual,
             "true_residual": cg_true, "seconds": round(cg_s, 4)},
         bicgstab={"matrix": ns, "plan": op_ns.plan.key(),
                   "iters": res2.iters, "residual": res2.residual,
                   "true_residual": bi_true, "seconds": round(bi_s, 4)})


def _slot_order_check_s(pack) -> float:
    """Host seconds of the slot-order check that building, loading or
    converting a windowed pack makes, on a host copy of its index streams."""
    from repro_torch.core.blockell import check_slot_order
    rows, cols = pack.row_in_win.cpu(), pack.col_local.cpu()
    t0 = time.perf_counter()
    check_slot_order(rows, cols, pack.w_pad)
    return round(time.perf_counter() - t0, 4)


def phase_path_kernels(work: Workload, eng, spec, launches):
    """Each kernel of one path at the shapes its main run gave it: against
    its plain version, timed, beside its bound and one library call."""
    from repro_torch.core import blockell
    from repro_torch.kernels import _build
    n = work.n
    ks = 8
    rows = []
    for kname, (mid, nrhs) in spec["kernels"].items():
        shape = (n,) if nrhs == 1 else (n, nrhs)
        x = torch.from_numpy(
            work.rng.standard_normal(shape, dtype=np.float32)).cuda()
        pack = eng.executor(mid).op.pack
        kernel, plain = _runners(pack, ks)[kname]
        abs_plain = _runners(abs_pack(pack), ks)[kname][1]
        err = _compare(f"path/{kname}", kernel, plain, x, exact=False,
                       abs_plain=abs_plain)
        if kname == "nnzsplit_spmv_onehot":
            # K11 is K12's body at one column: the same sums, bit for bit
            k12 = _runners(pack, ks)["nnzsplit_spmm_onehot"][0]
            check(torch.equal(kernel(x), k12(x[:, None])[..., 0]),
                  "path/nnzsplit_spmv_onehot: differs from K12's column 0")
        csr = work.csr[mid]
        lib = torch.sparse_csr_tensor(
            torch.from_numpy(csr.indptr.astype(np.int64)),
            torch.from_numpy(csr.indices.astype(np.int64)),
            torch.from_numpy(csr.data.astype(np.float32)),
            size=(n, n)).cuda()
        ms = time_ms(lambda: kernel(x))
        plain_ms = time_ms(lambda: plain(x))
        library_ms = time_ms(lambda: lib @ x)
        del lib
        extra = {}
        if kname.startswith("nnzsplit"):
            # the kernel's own work: its streams read once, its partials
            # written once, x read once; one multiply-add per real entry
            bytes_moved = sum(a.numel() * a.element_size()
                              for a in (pack.vals, pack.lrow, pack.src))
            bytes_moved += (pack.num_chunks * pack.r_pad + n) * 4 * nrhs
            flops = 2 * (2 * work.M[mid].k) * nrhs
            extra["product_streamed_bytes"] = pack.streamed_bytes(nrhs)
        else:
            # the windows' own bytes: the padded slots are the layout's
            layout = blockell.padding_bytes(pack)
            bytes_moved = pack.streamed_bytes(nrhs) - layout
            flops = (2 * work.M[mid].nnz - n) * nrhs
            extra["layout_bytes"] = layout
            extra["slot_order_check_s"] = _slot_order_check_s(pack)
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        k = _build.KERNELS[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": k.repo_source,
            "replaces": k.replaces, "launches": launches[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "shape": {"matrix": mid, "nrhs": nrhs, **_pack_report(
                work.M[mid], pack)},
            "bytes": bytes_moved, "flops": flops, **extra})
        if kname == "nnzsplit_spmv_stream":
            _k11_on_hub_rows(pack, x, mid, ms, max(t_bytes, t_ops))
        del x
        torch.cuda.empty_cache()
    return rows


def _k11_on_hub_rows(pack, x, mid, k9_ms, bound_ms):
    """K11 on the power-law pack beside K9 (its order of additions keeps
    each row's run in slot order, one thread per row, so a hub row's
    chunks are its slowest): held against its plain version, timed."""
    kernel, plain = _runners(pack, 8)["nnzsplit_spmv_onehot"]
    abs_plain = _runners(abs_pack(pack), 8)["nnzsplit_spmv_onehot"][1]
    err = _compare("k11_hub/nnzsplit_spmv_onehot", kernel, plain, x,
                   exact=False, abs_plain=abs_plain)
    dest = pack.chunk_row0[:, None].long() + pack.lrow.long()
    emit("k11_hub", matrix=mid, k11_ms=time_ms(lambda: kernel(x)),
         k9_ms=k9_ms, bound_ms=bound_ms, max_abs_err=err,
         chunks=pack.num_chunks,
         largest_row_entries=int(torch.bincount(dest.reshape(-1)).max()),
         largest_row_chunks=int(torch.bincount(
             pack.chunk_row0.long()).max()),
         tolerance=f"{TOL} of the row's absolute sum")


def phase_colorful(side: int, seed: int):
    """The paper's two strategies on one 2-D Poisson matrix: row coloring
    (``colorful``: one ``index_add_`` pair per color) and the local-buffer
    windows of the ``kernel`` path (K1/K2), registered side by side in one
    engine and served the same waves; then CG on the colorful one."""
    from repro_torch import obs
    from repro_torch.core import solvers
    from repro_torch.core.coloring import balance_stats, verify_coloring
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.kernels.ops import SpmvOperator
    from repro_torch.serve import SpmvServingEngine

    n = side * side
    spec = {"matrices": {"p2d": lambda: poisson_arrays(side)}}
    work = Workload(n, seed, spec)
    M = work.M["p2d"]
    plans = {"p2d_colorful": ExecutionPlan(path="colorful"),
             "p2d_kernel": ExecutionPlan(path="kernel", variant="stream")}
    eng = SpmvServingEngine()
    register_s, spans = {}, {}
    for mid, plan in plans.items():
        obs.clear_trace()
        t0 = time.perf_counter()
        got = eng.register(mid, M, plan=plan)
        register_s[mid] = round(time.perf_counter() - t0, 3)
        check(got.key() == plan.key(), f"{mid}: plan is {got.key()}")
        spans[mid] = {rec["name"]: round(rec["duration_s"], 3)
                      for rec in obs.trace()
                      if rec["name"].startswith("schedule.")}
    col = eng.executor("p2d_colorful").op.schedule.coloring
    check(verify_coloring(M, col), "the coloring has a write conflict")
    ia, ja, ad, al, au = work.arrays["p2d"]
    segment = SpmvOperator(M, path="segment")
    segment_abs = SpmvOperator(csrc_abs(n, ia, ja, ad, al, au),
                               path="segment")
    waves = []
    for per_matrix in (11, 1):
        xs = [work.rng.standard_normal(n, dtype=np.float32)
              for _ in range(per_matrix)]
        sent = {mid: [eng.submit(mid, x) for x in xs] for mid in plans}
        t_tick = time.perf_counter()
        out = eng.run_until_drained()
        tick_s = time.perf_counter() - t_tick
        wave = {"requests_per_matrix": per_matrix, "tick_s": round(tick_s, 4)}
        X = np.stack(xs, axis=1)
        for mid, uids in sent.items():
            check(all(out[u].batched == per_matrix
                      and out[u].path == plans[mid].path for u in uids),
                  f"{mid}: result metadata wrong")
            Y = np.stack([np.asarray(out[u]) for u in uids], axis=1)
            errs = work.check_answers(work.csr["p2d"], X, Y, segment,
                                      segment_abs, f"serve {mid} "
                                      f"B={per_matrix}")
            wave[mid] = {"execute_s": out[uids[0]].timings["execute_s"],
                         "err_vs_float64": errs[0],
                         "err_vs_segment": errs[1]}
        waves.append(wave)

    b = work.rng.standard_normal((n, 8), dtype=np.float32)
    t0 = time.perf_counter()
    res, op = solvers.cg_solve(M, torch.from_numpy(b), cache=eng.cache,
                               plan=plans["p2d_colorful"], tol=1e-6,
                               maxiter=4000)
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    check(res.converged and op.path == "colorful",
          f"colorful cg did not converge: {res.residual}")
    x = res.x.cpu().numpy().astype(np.float64)
    r = b - work.csr["p2d"] @ x
    true = float(np.max(np.linalg.norm(r, axis=0)
                        / np.linalg.norm(b, axis=0)))
    # float32 CG on this matrix (condition number ~1e5) stalls near a
    # 1e-4 true residual while its recurrence reaches 1e-6
    check(true <= 1e-3, f"colorful cg true residual {true}")
    emit("colorful", n=n, grid=side, nnz=int(M.nnz),
         num_colors=int(col.num_colors), provider=col.provider,
         balance=balance_stats(col), register_s=register_s,
         register_spans_s=spans, plans={m: p.key() for m, p in plans.items()},
         waves=waves,
         cg={"nrhs": 8, "iters": res.iters, "residual": res.residual,
             "true_residual": true, "seconds": round(cg_s, 4)})


def _assembly_kernel_cases(seed):
    """K13 / K14 against their plain versions and the serial oracle,
    exact on dyadic stiffness: tri / quad / tet meshes with 1-3 DOFs per
    node, int16 and int32 streams (both gates, the int16-overflow
    connectivity), a single element, a RACE coloring whose colors repeat
    targets (K13's adds to them land in atomic order), a mid-size tet, and
    the packs of ``assembly_adversary`` aimed at K14's runs and passes (an
    empty color among them); each of those is checked for its feature
    first."""
    from repro_torch.assembly import mesh as amesh
    from repro_torch.assembly import scatter as asc
    from repro_torch.kernels import assembly_scatter as ak
    small_ke = np.asarray([[[2.0, -0.5, -0.25], [-0.5, 1.0, -0.125],
                            [-0.25, -0.125, 3.0]]], np.float32)

    cases = [
        # name, mesh or conn, dofs per node, provider
        ("asm_tri_d1_i16", amesh.grid_tri(8), 1, "greedy"),
        ("asm_quad_d2", amesh.grid_quad(6), 2, "greedy"),
        ("asm_tet_d3", amesh.grid_tet(3), 3, "greedy"),
        ("asm_tri_i32_slots_i16_targets", amesh.grid_tri(44), 1, "greedy"),
        ("asm_i16_overflow", np.asarray([[0, 1, 32767]]), 1, "greedy"),
        ("asm_single_element", np.asarray([[0, 1, 2]]), 1, "greedy"),
        ("asm_tet16_d3_race", amesh.grid_tet(16), 3, "race"),
        ("asm_tet16_d3", amesh.grid_tet(16), 3, "greedy"),
    ]

    def schedules():
        for name, mesh, d, provider in cases:
            sched = asc.build_assembly_schedule(mesh, d,
                                                coloring_provider=provider)
            ke = (amesh.synthetic_stiffness(mesh, d, seed=seed + len(report))
                  if hasattr(mesh, "conn") else small_ke)
            yield name, sched, ke, {"dofs_per_node": d, "provider": provider}
        for case in ASM_ADVERSARIES:
            sched, ke = assembly_adversary(case, seed + len(report))
            geometry = assembly_pack_geometry(sched.colored)
            check(assembly_case_holds(case, geometry),
                  f"asm_{case}: the packs miss their feature ({geometry})")
            yield (f"asm_{case}", sched, ke,
                   {"dofs_per_node": sched.ndof_per_node,
                    "provider": sched.coloring.provider, **geometry})

    report = []
    for name, sched, ke, extra in schedules():
        want = assembly_oracle(sched, ke)
        check(np.array_equal(want, asc.scatter_serial(sched, ke)),
              f"{name}: the bincount oracle differs from np.add.at")
        packs = sched.bind("cuda").colored
        k = torch.from_numpy(ke).cuda().reshape(-1)
        if "race" in name:
            check(packs.repeats, f"{name}: no color repeats a target")
        errs = {}
        for kname, kernel, plain in (
                ("assembly_colored_stream", ak.colored_scatter_stream_cuda,
                 ak.colored_scatter_stream_plain),
                ("assembly_colored_onehot", ak.colored_scatter_onehot_cuda,
                 ak.colored_scatter_onehot_plain)):
            errs[kname] = _compare(f"{name}/{kname}",
                                   lambda x: kernel(packs, x),
                                   lambda x: plain(packs, x), k, exact=True)
            check(np.array_equal(kernel(packs, k).cpu().numpy(), want),
                  f"{name}/{kname}: differs from the serial oracle")
        report.append({"case": name, "ne": sched.ne, **extra,
                       "colors": packs.num_colors,
                       "lmax": packs.lmax, "size": sched.size,
                       "index_dtypes": sched.index_dtypes,
                       "repeats": packs.repeats, "exact": True,
                       "max_err": max(errs.values())})
        del packs, k
    torch.cuda.empty_cache()
    return report


def assembly_oracle(sched, ke):
    """The unified [ad | al | au] vector of the serial assembly, by a
    float64 ``np.bincount`` of the same targets (exact on dyadic
    stiffness, so equal to ``np.add.at`` in float32), cast to float32."""
    return np.bincount(np.asarray(sched.targets),
                       weights=np.asarray(ke, np.float64).reshape(-1),
                       minlength=sched.size).astype(np.float32)


def _unified(M):
    return torch.cat([M.ad, M.al, M.au]).cpu().numpy()


def _fem_csr(sched, vals):
    n, k = sched.n, sched.k
    return scipy_csr(n, sched.ia, sched.ja, vals[:n], vals[n:n + k],
                     vals[n + k:])


def _check_fem_answers(csr, X, Y, what):
    """Y (n, B) against the float64 scipy product, within 2e-5 of each
    row's absolute sum |A|·|x|."""
    check(Y.shape == X.shape and bool(np.isfinite(Y).all()),
          f"{what}: shape {Y.shape} or non-finite answer")
    X64 = X.astype(np.float64)
    err = np.abs(Y - csr @ X64)
    bound = 2 * TOL * (abs(csr) @ np.abs(X64)) + 1e-30
    check(bool((err <= bound).all()),
          f"{what}: differs from the float64 reference (max {err.max()})")
    return float(err.max())


def _true_residual(csr, b, x):
    r = b - csr @ x.astype(np.float64)
    return float(np.max(np.linalg.norm(r, axis=0)
                        / np.linalg.norm(b, axis=0)))


def phase_assembly(seed: int, cubes):
    """The assembly main path at full width; returns (launches of its
    kernels in the main run, the schedule, the initial stiffness)."""
    from repro_torch import obs
    from repro_torch.assembly import mesh as amesh
    from repro_torch.assembly import scatter as asc
    from repro_torch.core import solvers
    from repro_torch.core.paths import BUILD_COUNTS
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.core.tuner import PlanCache
    from repro_torch.kernels import _build
    from repro_torch.serve import SpmvServingEngine

    def builds_since(before):
        return {k: v - before.get(k, 0) for k, v in BUILD_COUNTS.items()
                if v != before.get(k, 0)}

    def uploads():
        snap = obs.snapshot()
        return {part: snap.total("assembly_pack_uploads_total",
                                 device="cuda", part=part)
                for part in ("structure", "colored", "sorted", "private")}

    tmp = tempfile.mkdtemp(prefix="chip_smoke_assembly_")
    try:
        t0 = time.perf_counter()
        mesh = amesh.grid_tet(*cubes)
        ke0 = amesh.synthetic_stiffness(mesh, ASM_DOF, seed=seed)
        mesh_s = time.perf_counter() - t0

        # 1. schedule through a path-backed plan cache
        cache_path = os.path.join(tmp, "plans.json")
        cache = PlanCache(path=cache_path)
        obs.clear_trace()
        before = dict(BUILD_COUNTS.items())
        t0 = time.perf_counter()
        sched = asc.assembly_schedule_for(mesh, ASM_DOF, cache=cache)
        build_s = time.perf_counter() - t0
        spans = {}
        for rec in obs.trace():
            if rec["name"].startswith("assembly."):
                spans[rec["name"]] = round(
                    spans.get(rec["name"], 0.0) + rec["duration_s"], 3)
        check(builds_since(before).get("assembly_schedule") == 1,
              "the schedule was not built")
        n, size, G = sched.n, sched.size, sched.num_contribs
        emit("assembly_build", mesh=mesh.name, elements=sched.ne,
             nodes=mesh.num_nodes, dofs=n, lower_slots=sched.k,
             unified_size=size, contributions=G,
             mesh_and_stiffness_s=round(mesh_s, 3),
             build_s=round(build_s, 3), spans_s=spans,
             num_colors=int(sched.coloring.num_colors),
             lmax=int(sched.color_slots.shape[1]),
             pad_ratio=round(sched.color_slots.size / G, 4),
             index_dtypes=sched.index_dtypes,
             tiles=sched.colored.num_tiles, repeats=sched.colored.repeats)
        check(not sched.colored.repeats,
              "a greedy color repeats a target")

        # 2-7: the main run
        _build.reset_launch_counts()
        t_main = time.perf_counter()
        up0 = uploads()
        t0 = time.perf_counter()
        tuned = asc.tune_assembly(sched, ke0, cache=cache)
        tune_s = time.perf_counter() - t0
        check(not tuned.cached and {k.split("/")[0] for k in
                                     tuned.timings_s} == {"colored",
                                                          "sorted",
                                                          "private"},
              f"tune_assembly measured {sorted(tuned.timings_s)}")
        want0 = assembly_oracle(sched, ke0)
        strategies = {}
        M0 = None
        for strategy, variant in asc.ASSEMBLY_CANDIDATES:
            t0 = time.perf_counter()
            M = asc.assemble(sched, ke0, strategy, variant)
            wall = time.perf_counter() - t0
            check(M.device.type == "cuda", f"{strategy}/{variant}: the "
                  "matrix left the card")
            check(np.array_equal(_unified(M), want0),
                  f"assembly {strategy}/{variant} differs from the serial "
                  "oracle")
            strategies[f"{strategy}/{variant}"] = round(wall, 4)
            if (strategy, variant) == ("colored", "stream"):
                M0 = M
        check(M0.numerically_symmetric, "the assembled matrix is not "
              "symmetric")
        del M

        plan = ExecutionPlan(path="kernel", variant="stream")
        eng = SpmvServingEngine(cache=cache)
        t0 = time.perf_counter()
        got = eng.register("fem", M0, plan=plan)
        register_s = time.perf_counter() - t0
        check(got.key() == plan.key(), f"fem: plan is {got.key()}")
        csr = _fem_csr(sched, want0)
        rng = np.random.default_rng(seed + 14)

        def wave(per, csr_t, what):
            xs = [rng.standard_normal(n, dtype=np.float32)
                  for _ in range(per)]
            uids = [eng.submit("fem", x) for x in xs]
            t_tick = time.perf_counter()
            out = eng.run_until_drained()
            tick_s = time.perf_counter() - t_tick
            check(all(out[u].batched == per and out[u].path == "kernel"
                      for u in uids), f"{what}: result metadata wrong")
            Y = np.stack([np.asarray(out[u]) for u in uids], axis=1)
            err = _check_fem_answers(csr_t, np.stack(xs, axis=1), Y, what)
            return {"requests": per, "tick_s": round(tick_s, 4),
                    "execute_s": out[uids[0]].timings["execute_s"],
                    "err_vs_float64": err}

        waves = [wave(11, csr, "assembled B=11"),
                 wave(1, csr, "assembled B=1")]
        b = rng.standard_normal((n, 8), dtype=np.float32)
        t0 = time.perf_counter()
        res, _ = solvers.cg_solve(M0, torch.from_numpy(b), cache=cache,
                                  plan=plan, tol=1e-6)
        torch.cuda.synchronize()
        cg_s = time.perf_counter() - t0
        true0 = _true_residual(csr, b, res.x.cpu().numpy())
        check(res.converged and true0 <= 1e-5,
              f"cg on the assembled matrix: {res.residual}, true {true0}")

        op = eng.executor("fem").op
        steps = []
        for t in range(1, ASM_STEPS + 1):
            ke = amesh.synthetic_stiffness(mesh, ASM_DOF, seed=seed + t)
            want = assembly_oracle(sched, ke)
            before = dict(BUILD_COUNTS.items())
            snap = obs.snapshot()
            t0 = time.perf_counter()
            M_t = asc.assemble(sched, ke)
            assemble_s = time.perf_counter() - t0
            k13_s = obs.snapshot().diff(snap).merged_hist(
                "assembly_device_seconds", strategy="colored",
                variant="stream")["sum"]
            check(np.array_equal(_unified(M_t), want),
                  f"step {t}: assembly differs from the serial oracle")
            t0 = time.perf_counter()
            eng.update_values("fem", M_t)
            refresh_s = time.perf_counter() - t0
            csr_t = _fem_csr(sched, want)
            served = wave(11, csr_t, f"step {t} B=11")
            b = rng.standard_normal((n, 8), dtype=np.float32)
            t0 = time.perf_counter()
            res_t = solvers.cg(op, torch.from_numpy(b).cuda(), tol=1e-6,
                               diag=M_t.ad)
            torch.cuda.synchronize()
            solve_s = time.perf_counter() - t0
            true_t = _true_residual(csr_t, b, res_t.x.cpu().numpy())
            check(res_t.converged and true_t <= 1e-5,
                  f"step {t}: cg {res_t.residual}, true {true_t}")
            delta = builds_since(before)
            check(delta.get("assembly_value_refresh") == 1
                  and delta.get("value_refresh") == 1
                  and not any(delta.get(k) for k in ASM_BUILDS),
                  f"step {t} rebuilt structure: {delta}")
            steps.append({"step": t, "assemble_s": round(assemble_s, 4),
                          "k13_ms": k13_s * 1e3,
                          "refresh_s": round(refresh_s, 3),
                          "wave": served, "cg_iters": res_t.iters,
                          "cg_s": round(solve_s, 4),
                          "true_residual": true_t, "builds": delta})
        counts = _build.launch_counts()
        main_s = time.perf_counter() - t_main
        up = {part: v - up0[part] for part, v in uploads().items()}
        check(all(v == 1 for v in up.values()), f"each strategy's streams "
              f"must go to the card once in the main run: {up}")

        # 8. a fresh cache on the same path: hits only, nothing timed
        before = dict(BUILD_COUNTS.items())
        fresh = PlanCache(path=cache_path)

        def never(fn, k):
            fail("tune_assembly measured on a cache hit")

        t0 = time.perf_counter()
        sched2 = asc.assembly_schedule_for(mesh, ASM_DOF, cache=fresh)
        tuned2 = asc.tune_assembly(sched2, ke0, cache=fresh, measure=never)
        reload_s = time.perf_counter() - t0
        check(fresh.assembly_hits == 1 and tuned2.cached
              and tuned2.key() == tuned.key()
              and not builds_since(before),
              f"fresh cache: hits {fresh.assembly_hits}, tuned "
              f"{tuned2.key()} cached={tuned2.cached}, builds "
              f"{builds_since(before)}")
        emit("assembly", mesh=mesh.name, tuned=tuned.key(),
             tune_s=round(tune_s, 3),
             tune_timings_ms={k: v * 1e3 for k, v in
                              tuned.timings_s.items()},
             tune_predicted_ms={k: v * 1e3 for k, v in
                                tuned.predictions_s.items()},
             assemble_wall_s=strategies, register_s=round(register_s, 3),
             waves=waves,
             cg={"nrhs": 8, "iters": res.iters, "residual": res.residual,
                 "true_residual": true0, "seconds": round(cg_s, 4)},
             steps=steps, pack_uploads=up,
             main_run_s=round(main_s, 3), launches=counts,
             fresh_cache={"reload_s": round(reload_s, 3),
                          "assembly_hits": fresh.assembly_hits,
                          "tuned": tuned2.key(), "builds": {}})
        del eng, M0, M_t, op, sched2
        return counts, sched, ke0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_assembly_kernels(sched, ke, launches, cubes, seed):
    """K13 and K14 at the assembly path's shapes: against their plain
    versions (exact; K13 also on standard-normal contributions), timed,
    beside their bound and one library call (an ``index_add_`` of all
    contributions at their targets)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import assembly_scatter as ak
    packs = sched.bind("cuda").colored
    k = torch.from_numpy(ke).cuda().reshape(-1)
    k_normal = torch.randn(k.numel(), generator=torch.Generator(
        "cuda").manual_seed(seed), device="cuda")
    targets = torch.from_numpy(np.asarray(sched.targets)).cuda()
    out = torch.zeros(sched.size, device="cuda")
    library_ms = time_ms(lambda: out.index_add_(0, targets, k))
    rows = []
    for kname, variant, kernel, plain in (
            ("assembly_colored_stream", "stream",
             ak.colored_scatter_stream_cuda, ak.colored_scatter_stream_plain),
            ("assembly_colored_onehot", "onehot",
             ak.colored_scatter_onehot_cuda,
             ak.colored_scatter_onehot_plain)):
        err = _compare(f"path/{kname}", lambda x: kernel(packs, x),
                       lambda x: plain(packs, x), k, exact=True)
        if variant == "stream" and not packs.repeats:
            # greedy colors: one add per target and color, in color order
            # in both, so general values agree bit for bit too
            _compare(f"path/{kname}/normal", lambda x: kernel(packs, x),
                     lambda x: plain(packs, x), k_normal, exact=True)
        ms = time_ms(lambda: kernel(packs, k))
        plain_ms = time_ms(lambda: plain(packs, k))
        bytes_moved = packs.streamed_bytes()
        flops = sched.num_contribs           # one add per contribution
        t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        kern = _build.KERNELS[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": kern.repo_source,
            "replaces": kern.replaces, "launches": launches[kname],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "shape": {"mesh": "tet%dx%dx%d" % tuple(cubes),
                      "dofs_per_node": ASM_DOF,
                      "colors": packs.num_colors, "lmax": packs.lmax,
                      "tiles": packs.num_tiles, "size": sched.size,
                      "contributions": sched.num_contribs,
                      "index_dtypes": sched.index_dtypes,
                      "repeats": packs.repeats},
            "bytes": bytes_moved,
            "layout_bytes": packs.layout_bytes(variant), "flops": flops})
    del out, targets, k, k_normal
    torch.cuda.empty_cache()
    return rows


def csrc_abs(n, ia, ja, ad, al, au):
    from repro_torch.core import csrc
    return csrc.from_assembly(n, ia, ja, np.abs(ad), np.abs(al), np.abs(au))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n", type=int, default=2_097_152,
                    help="rows of the serve/solve matrices")
    ap.add_argument("--cubes", type=int, nargs=3, default=ASM_CUBES,
                    metavar=("X", "Y", "Z"),
                    help="unit cubes of the assembly path's tet block")
    ap.add_argument("--verbose-build", action="store_true",
                    help="print nvcc's register / shared-memory report")
    args = ap.parse_args()

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one "
             "NVIDIA GPU")
    from repro_torch import device as device_mod
    from repro_torch.kernels import _build
    from repro_torch.kernels import (assembly_scatter,  # noqa: F401
                                     csrc_spmm, csrc_spmv,  # (register)
                                     csrc_spmv_flat, csrc_spmv_nnzsplit)

    torch.manual_seed(args.seed)
    card = phase_env()
    phase_build(args.verbose_build)
    phase_kernels(args.seed)

    launches = {}
    rows = []
    for spec in path_specs(args.n, args.seed):
        t0 = time.perf_counter()
        work = Workload(args.n, args.seed, spec)
        _build.reset_launch_counts()       # this path's main run starts here
        eng = phase_serve(work, spec)
        phase_solve(work, eng, spec)
        counts = _build.launch_counts()    # ... and ends here
        for name in spec["kernels"]:
            check(counts[name] > 0,
                  f"kernel {name} was never launched on the {spec['name']} "
                  "path's main run")
            launches[name] = counts[name]
        emit("main_path", path=spec["name"], launches=counts,
             seconds=round(time.perf_counter() - t0, 3))
        rows += phase_path_kernels(work, eng, spec, launches)
        del eng, work
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    counts, sched, ke0 = phase_assembly(args.seed, args.cubes)
    for name in ("assembly_colored_stream", "assembly_colored_onehot"):
        check(counts[name] > 0, f"kernel {name} was never launched on the "
              "assembly path's main run")
        launches[name] = counts[name]
    rows += phase_assembly_kernels(sched, ke0, launches, args.cubes,
                                   args.seed)
    emit("assembly_phase", seconds=round(time.perf_counter() - t0, 3))
    del sched, ke0
    gc.collect()
    torch.cuda.empty_cache()
    for name in _build.KERNELS:
        check(name in launches, f"kernel {name} is on no main path")
    t0 = time.perf_counter()
    phase_colorful(int(round(math.sqrt(args.n / 8))), args.seed)
    emit("colorful_phase", seconds=round(time.perf_counter() - t0, 3))
    emit("total", seconds=round(time.perf_counter() - t_start, 3))

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": device_mod.describe("cuda:0")}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
