#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--n 2097152] [--cubes 64 32 32]
                          [--verbose-build]

Builds the fifteen CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, then drives five of
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
  segment   after the mesh phase, HPCG's 27-point stencil on 112^3
            (band 12,657, too wide for every window):
            the default plan falls to ``segment``, which on the card is
            K15, one launch a product; served and solved by block CG, K15
            against the gather + ``index_add_`` chain at B = 1 and 8 and on
            a rectangular matrix, and timed beside its byte bound, that
            chain, one ``index_add_`` and one ``torch.sparse`` product;
            then K15's split form (two launches) on Graph500's SCALE 21
            Kronecker graph, against that chain at B = 1 and 8 and timed,
            split and unsplit, beside its byte bound;
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

  mesh      after the nnzsplit path, the paper's three accumulations
            (allreduce, reduce_scatter, halo) over 8 shards emulated on the
            card (``ShardMesh(8, "cuda")``) on the kernel path's ``fem_sym``
            and the nnzsplit path's ``pl_sym``: shard-local ``index_add_``,
            ``flat`` (K5-K8) and ``nnzsplit`` (K9-K12) at B = 1 and 8, each
            against the local plan's answer and time, each product launching
            its kernel once per shard, and each shard's kernel at these
            shapes against its plain version; halo at p = 1, 2, 4,
            8; serving, a value refresh and block CG through the
            ``MeshExecutor``; ``tune_mesh`` and a second engine on its
            cache; the process-group backend on NCCL at world size 1.  At
            n = 40,000 first, every mesh product of K5-K12 on the card
            equal bit for bit to the plain versions' on the CPU (dyadic).

  lm        last, the LM serving path at full width, the dense family:
            qwen3-8b (36 layers, GQA) and then deepseek-v2-lite-16b (27
            layers, MLA, 64 experts top-6), random bf16 weights drawn on the
            card from ``--seed``, each serving ``launch/serve.py``'s traffic
            (8 prompts of 4-11 tokens, 4 slots, 16 new tokens, greedy)
            through two ``ServingEngine``s that must agree token for token;
            prefill + one decode against ``forward`` on the extended
            sequence (bf16 cache, int8 cache; deepseek at capacity factor
            E/k), a 4,096-token prefill (the chunked online softmax)
            against one pass, tokens/s, prefill and decode ms (CUDA events)
            beside the decode's byte floor, one decode under
            ``torch.profiler`` (launches, the device's busy time) and
            memory.  Then the recurrent families: rwkv6-1.6b (24 layers of
            RWKV6) and zamba2-7b (81 Mamba2 layers, a weight-shared
            attention block every 6 with its LoRA, a 4,096-position ring)
            through the same traffic, prefill + decode against
            ``forward`` (bf16, and the weights widened to float32), and
            the chunked scans against the recurrent ones
            (one layer in float32 on 512 tokens, gated; the whole model
            in bf16, reported).  It adds no kernel.

  train     after the LM phase, single-device training at full width:
            qwen1.5-0.5b uncut (24 layers, d 1024, vocab 151,936, tied
            embeddings), random bf16 weights from ``--seed``, the port's
            counted pipeline at 8 x 512 tokens, AdamW with float32
            moments.  A few ``Trainer`` steps with full remat (the loss
            must fall), the same step twice from one state (bit for bit),
            one step under ``torch.profiler``, the step's parts timed
            alone, remat none / full / dots from one state (params within
            the reference test's bar), two microbatches accumulated in bf16
            with error feedback, 4 straight steps against 2 + a checkpoint
            + a fresh ``Trainer`` restoring it + 2 (params and moments bit
            for bit), and the reduced config's step in float32 on the card
            against the CPU's.  Step ms (CUDA events) and tokens/s beside
            the flop floor 6·N·T over the data sheet's dense bf16 peak.  It
            adds no kernel.

  dist      last, distributed training and the analysis tools at
            qwen1.5-0.5b's width: its 24 decoder blocks as ``layer_fn`` of
            ``pipeline_apply`` over 4 stages emulated on the card (8
            microbatches of 1 x 512 tokens) against the blocks in
            sequence, bit for bit, timed both ways; ``compressed_psum`` at
            p = 4 over gradient-sized float32 trees (463,987,712 entries a
            shard) in float32, bf16 and int8, each timed beside its wire
            bytes and its error against the float32 sum; both also on a
            1-rank NCCL group; the meta-device dry-run of all 80 (arch x
            shape x mesh) cells, its one-device train cell against the
            bytes the train phase holds; and the flops ``FlopCounterMode``
            counts in a train step with remat none and full against
            6·N·T.  It adds no kernel.

Each path's two matrices are served by one ``SpmvServingEngine`` and solved
by ``cg_solve`` / ``bicgstab``.  After the ``kernel`` and ``flat`` paths'
main runs, a tune phase registers their non-symmetric matrix (``fem_ns``,
``skew_ns``) in a fresh ``SpmvServingEngine(autotune=True, serve_nrhs=8)``:
the measured tuner prices every candidate plan with the card-calibrated
cost model, measures the cheapest on the card at nrhs 1 and 8, serves a
wave on the winner, holds the winner's time per column against the
heuristic plan's, and registers the matrix again in a second engine on the
same cache with no measurement and no pack.  Answers are checked against a float64
``scipy.sparse`` product built from the same COO data and against the
port's own ``segment`` path.  A last phase serves one 2-D Poisson matrix
(``--n``/8 rows: 512 x 512 at the default size) through the paper's two
strategies side by side —
row coloring (the ``colorful`` path, torch ops) and the local-buffer
windows of the ``kernel`` path — and solves it by CG on the colorful one.

Every phase prints one JSON line (the ``calibration`` line: the cost
model's denominators measured on the card; a ``card_pricing`` line per
path: the cost model's price of each kernel's plan beside the bound's
bytes, and each stream / one-hot pair on the path's packs timed side by
side, the predicted order beside the measured one).  Before the last line come one JSON object ``{"kernels": [...]}``
(per kernel: launches on its path's main run, error against the plain
version, time, plain time, bound, library time, launches on the mesh
phase's main run; beside K9 the time of the nnz-split fix-up that follows
it) and the card's name and power limit.  The last line is
``{"ok": true, "device": {...}}``.  Any failing phase, a missing card or a
kernel that does not build ends the run with a non-zero exit code; nothing
falls back to the CPU or to a plain version.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
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
KRON_INITIATOR = (0.57, 0.19, 0.19)   # Graph500's A, B, C (D = 0.05)
KRON_SCALE = 21       # the segment phase's split case: 2^21 vertices
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


def stencil27_arrays(nx, ny, nz, seed=None, symmetric=True, dyadic=False):
    """HPCG's 27-point stencil on an nx x ny x nz grid (row ix + nx·(iy +
    ny·iz)), its bandwidth nx·ny + nx + 1: (ia, ja, ad, al, au) with
    row-major lower slots, columns ascending.  HPCG's values (26 on the
    diagonal, -1 elsewhere) without a ``seed``; else random off-diagonal
    values (multiples of 1/4 in [-2, 2] when ``dyadic``), ``au`` drawn
    apart unless ``symmetric``."""
    n = nx * ny * nz
    ix = np.tile(np.arange(nx, dtype=np.int64), ny * nz)
    iy = np.tile(np.repeat(np.arange(ny, dtype=np.int64), nx), nz)
    iz = np.repeat(np.arange(nz, dtype=np.int64), nx * ny)
    offs = sorted((dx + nx * dy + nx * ny * dz, dx, dy, dz)
                  for dz in (-1, 0, 1) for dy in (-1, 0, 1)
                  for dx in (-1, 0, 1) if dx + nx * dy + nx * ny * dz < 0)
    cols = np.full((n, len(offs)), -1, dtype=np.int64)
    for c, (d, dx, dy, dz) in enumerate(offs):
        ok = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
              & (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz))
        cols[ok, c] = np.nonzero(ok)[0] + d
    valid = cols >= 0
    ia = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(valid.sum(axis=1), out=ia[1:])
    ja = cols[valid].astype(np.int32)
    k = ja.shape[0]
    ad = np.full(n, 26.0, dtype=np.float32)
    if seed is None:
        al = np.full(k, -1.0, dtype=np.float32)
        return ia, ja, ad, al, al
    rng = np.random.default_rng(seed)

    def values():
        if dyadic:
            return (rng.integers(-8, 9, size=k) / 4.0).astype(np.float32)
        return rng.standard_normal(k, dtype=np.float32)

    al = values()
    return ia, ja, ad, al, al if symmetric else values()


def kronecker_pattern(scale, seed, device="cpu"):
    """Graph500's Kronecker graph: 2^scale vertices, 16·2^scale edges, each
    placed by one draw a level among the initiator's quadrants (row bit
    set in C and D, column bit in B and D), labels permuted; self-loops
    dropped and repeats merged.  Returns (n, ia, ja) of its strict lower
    triangle, numpy, columns ascending.  Drawn and sorted by torch on
    ``device``."""
    n, m = 1 << scale, 16 << scale
    a, b, c = KRON_INITIATOR
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.zeros(m, dtype=torch.int64, device=device)
    v = torch.zeros_like(u)
    for level in range(scale):
        r = torch.rand(m, generator=gen, device=device)
        low = r >= a + b
        u += low.long() << level
        v += ((r >= a + b + c) | ((r >= a) & ~low)).long() << level
    perm = torch.randperm(n, generator=gen, device=device)
    u, v = perm[u], perm[v]
    keep = u != v
    key = torch.unique(torch.maximum(u, v)[keep] * n
                       + torch.minimum(u, v)[keep])
    del u, v, keep
    ia = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(torch.bincount(key // n, minlength=n).cpu().numpy(),
              out=ia[1:])
    return n, ia, (key % n).to(torch.int32).cpu().numpy()


def kronecker_arrays(scale, seed, symmetric=True, dyadic=False,
                     device="cpu"):
    """(n, (ia, ja, ad, al, au)) of :func:`kronecker_pattern`'s graph:
    values as ``band_arrays`` draws them, ``au`` apart unless
    ``symmetric``, a diagonal of 4."""
    n, ia, ja = kronecker_pattern(scale, seed, device)
    rng = np.random.default_rng(seed)
    k = ja.shape[0]

    def values():
        if dyadic:
            return (rng.integers(-8, 9, size=k) / 4.0).astype(np.float32)
        return rng.standard_normal(k, dtype=np.float32)

    al = values()
    au = al if symmetric else values()
    return n, (ia, ja, np.full(n, 4.0, dtype=np.float32), al, au)


def _lower_from_pairs(n, hi, lo):
    """Row-major lower slots (ia, ja) of the distinct pairs hi > lo.  The
    keys are deduplicated after a sort: ``np.unique`` of numpy 2.3 took
    106 s on the 33 M keys of the power-law matrix, ``np.sort`` 0.5 s."""
    key = np.sort(hi.astype(np.int64) * n + lo)
    key = key[np.concatenate(([True], key[1:] != key[:-1]))]
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


def lane_run_arrays(seed, sinks=320, cycles=80):
    """Rows from ``sinks`` on, whose lower entries all fall in the first
    ``sinks`` columns, with widths cycling over 1, 1, 1..33, 64, 128 and
    300 (``cycles`` times): in the combined stream those rows hold exactly
    their widths, after the sink rows, which hold their upper partners —
    row 0 one entry per cycled row, so it fills whole chunks.  Dyadic
    values.  Returns (ia, ja, ad, al, au)."""
    cycle = np.concatenate([[1, 1], np.arange(1, 34), [64, 128, 300]])
    width = np.tile(cycle, cycles).astype(np.int64)
    n = sinks + width.shape[0]
    hi = np.repeat(np.arange(sinks, n, dtype=np.int64), width)
    lo = np.arange(hi.shape[0]) - np.repeat(np.cumsum(width) - width, width)
    ia, ja, _ = _lower_from_pairs(n, hi, lo)
    rng = np.random.default_rng(seed)
    al = _dyadic_values(rng, ja.shape[0])
    au = _dyadic_values(rng, ja.shape[0])
    return ia, ja, np.full(n, 8.0, dtype=np.float32), al, au


# the nnz-split adversary packs (``nnzsplit_adversary_arrays``): case ->
# (value dtype, index dtype, ks)
NNZ_ADVERSARIES = {
    "hub_fills_chunks": (torch.float32, torch.int32, 8),
    "run_crosses_pass": (torch.float32, torch.int32, 8),
    "r_pad_4096": (torch.float32, torch.int32, 8),
    "bf16_i16": (torch.bfloat16, torch.int16, 8),
    "lane_run_edges": (torch.float32, torch.int32, 8),
    "lane_run_edges_bf16_i16": (torch.bfloat16, torch.int16, 8),
}


def nnzsplit_adversary_arrays(case, seed):
    """A small matrix (dyadic values) whose nnz-split pack (``NNZ_ADVERSARIES``
    gives its dtypes and ks) stresses K11/K12's row runs or K9's warp runs:

      hub_fills_chunks  a star graph's centre: one row fills whole chunks,
                        so one thread per column adds 1,024 entries;
      run_crosses_pass  20 entries per row, 40 per row in the combined
                        stream: a row's run crosses entry 512 of a chunk,
                        where a pass of the kernel ends;
      r_pad_4096        two dense rows 3,999 apart in one chunk;
      bf16_i16          a power-law graph in bfloat16 values and int16
                        indices;
      lane_run_edges    (and its bfloat16 / int16 twin) rows of the
                        combined stream 1, 1, 1..33, 64, 128 and 300
                        entries long (``lane_run_arrays``): in lanes of
                        four consecutive entries and warps of 128 (the
                        four-entry forms of ``tools/k9_body_probe.py``;
                        K9's warps take 32) a run ends at each of the 128
                        positions, four entries of a lane hold four rows,
                        runs cross warp, pass (512 entries) and chunk
                        ends, and a hub row fills whole chunks.

    Returns (ia, ja, ad, al, au)."""
    if case == "hub_fills_chunks":
        return star_arrays(5000, seed)
    if case == "run_crosses_pass":
        return random_arrays(3000, seed, dyadic=True)
    if case == "r_pad_4096":
        return gap_arrays(seed)
    if case.startswith("lane_run_edges"):
        return lane_run_arrays(seed)
    return powerlaw_arrays(20000, seed, dyadic=True)


def nnzsplit_chunk_geometry(pack):
    """What the nnz-split adversary cases aim at, read off an
    ``NnzSplitPack``: the chunks holding one row only, the runs cut by the
    end of a kernel pass (``csrc_spmv_nnzsplit._STAGE`` entries: K11/K12's
    stage, and the pass of 128 lanes of four entries), r_pad and the
    dtypes; for lanes of four consecutive entries and warps of 128: the
    positions in a warp at which a run ends inside a chunk, the lanes
    holding four rows, and the runs that cross a warp's end or run on from
    one chunk into the next."""
    from repro_torch.kernels.csrc_spmv_nnzsplit import _STAGE
    lrow = pack.lrow.long()
    dev = lrow.device
    cuts = torch.arange(_STAGE, pack.s, _STAGE, device=dev)
    same = lrow[:, 1:] == lrow[:, :-1]      # entry e + 1 continues e's run
    position = torch.arange(pack.s - 1, device=dev) % 128
    lanes = lrow.reshape(lrow.shape[0], -1, 4)
    warp_ends = torch.arange(127, pack.s - 1, 128, device=dev)
    dest = pack.chunk_row0.long()[:, None] + lrow
    return {"r_pad": pack.r_pad, "s": pack.s,
            "one_row_chunks": int((lrow == lrow[:, :1]).all(1).sum()),
            "runs_across_passes": int((lrow[:, cuts - 1]
                                       == lrow[:, cuts]).sum()),
            "run_end_positions": int(torch.unique(
                position[(~same).any(0)]).numel()),
            "four_row_lanes": int((lanes[..., 1:] != lanes[..., :-1]).all(-1)
                                  .sum()),
            "runs_over_warp_end": int(same[:, warp_ends].sum()),
            "runs_over_chunk_end": int((dest[1:, 0] == dest[:-1, -1]).sum()),
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
    narrow = ["torch.bfloat16", "torch.int16"]
    if case.startswith("lane_run_edges"):
        dtypes = (narrow if case.endswith("bf16_i16")
                  else ["torch.float32", "torch.int32"])
        return (geometry["run_end_positions"] == 128
                and geometry["four_row_lanes"] > 0
                and geometry["runs_over_warp_end"] > 0
                and geometry["runs_across_passes"] > 0
                and geometry["runs_over_chunk_end"] > 0
                and geometry["one_row_chunks"] > 0
                and geometry["dtypes"] == dtypes)
    return geometry["dtypes"] == narrow


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


def phase_calibration(card):
    """The cost model's denominators, measured on the card once for the
    process (a 1 GiB device-to-device copy, back-to-back launches)."""
    from repro_torch.roofline import cost_model
    t0 = time.perf_counter()
    den = cost_model.calibrate("cuda")
    emit("calibration", card=card, seconds=round(time.perf_counter() - t0, 3),
         **den.to_dict())


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
    work.segment_abs = segment_abs        # |A| · |x|, for later bounds

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
    its plain version, timed, beside its bound and one library call.  The
    cost model's card price of each kernel's plan (estimated from the
    matrix's statistics, and on the built pack) goes on a ``card_pricing``
    line of its own, keyed by kernel name: predictions, not measurements."""
    from repro_torch.core import blockell
    from repro_torch.kernels import _build
    n = work.n
    ks = 8
    rows = []
    pricing, stats, pairs = {}, {}, []
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
        twin_name = _twin(kname)
        twin = _runners(pack, ks)[twin_name][0]
        twin_ms = time_ms(lambda: twin(x))
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
            if kname == "nnzsplit_spmv_stream":
                # the fix-up after K9 (torch ops, as the reference's
                # .at[].add): fixup_idx to int64, y_pad zeroed, index_add_
                # of the partials, the diagonal
                from repro_torch.kernels import csrc_spmv_nnzsplit as nz
                partials = kernel(x)
                extra["fixup_ms"] = time_ms(
                    lambda: nz.fixup(pack, partials, x))
                del partials
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
        pricing[kname] = _card_priced(work, eng, mid, nrhs, pack,
                                      bytes_moved, stats)
        pairs.append(_pair_order(work, eng, mid, nrhs, pack, stats,
                                 {kname: ms, twin_name: twin_ms}))
        if kname == "nnzsplit_spmv_stream":
            _k11_on_hub_rows(pack, x, mid, ms, max(t_bytes, t_ops))
        del x
        torch.cuda.empty_cache()
    emit("card_pricing", path=spec["name"], kernels=pricing,
         stream_onehot_pairs=pairs, level_band=PAIR_LEVEL)
    return rows


# a stream / one-hot pair measured within this share of each other is level:
# the tuner measures both variants of an artifact, and either predicted
# order agrees with it
PAIR_LEVEL = 0.10
# card pricing's bodies are throughput terms, fitted where the grid fills
# the card many times over: a pair is held to its predicted order only on
# a pack of at least this many tiles or chunks per SM (every main-path pack
# at the default size; the small packs of --n 131072 print their orders
# unchecked)
PAIR_MIN_TILES_PER_SM = 64


def _twin(kname: str) -> str:
    """The kernel of the other variant on the same grid and width."""
    head, variant = kname.rsplit("_", 1)
    return f"{head}_{'onehot' if variant == 'stream' else 'stream'}"


def _pair_order(work: Workload, eng, mid, nrhs, pack, stats, ms):
    """Card pricing's order of a stream / one-hot pair on one pack (the
    plans' prices on the pack's geometry) beside the order of the two
    kernels' times measured on it; they must agree unless the measured
    times are level (``PAIR_LEVEL``)."""
    from repro_torch.core import tuner
    from repro_torch.roofline import cost_model
    den = cost_model.calibrate("cuda")
    if mid not in stats:
        stats[mid] = tuner.stats_of(work.M[mid])
    geom = cost_model.pack_geometry(pack)
    plan = dataclasses.replace(eng.executor(mid).op.plan, nrhs=nrhs)
    measured, predicted, body = {}, {}, {}
    for kname, t in ms.items():
        variant = kname.rsplit("_", 1)[1]
        est = cost_model.card_plan_cost(
            stats[mid], dataclasses.replace(plan, variant=variant), den,
            geometry=geom)
        measured[variant] = t
        predicted[variant] = est.predicted_s * 1e3
        body[variant] = est.body_s * 1e3
    m_ratio = measured["onehot"] / measured["stream"]
    p_ratio = predicted["onehot"] / predicted["stream"]
    level = abs(m_ratio - 1.0) <= PAIR_LEVEL
    agree = level or (m_ratio > 1.0) == (p_ratio > 1.0)
    from repro_torch import device as device_mod
    held = geom.tiles >= PAIR_MIN_TILES_PER_SM * device_mod.sm_count("cuda")
    check(agree or not held, f"{mid} r{nrhs}: card pricing orders one-hot "
          f"/ stream {p_ratio:.3f}, the card {m_ratio:.3f}")

    def order(r):
        return "onehot slower" if r > 1.0 else "stream slower"

    return {"matrix": mid, "nrhs": nrhs, "measured_ms": measured,
            "predicted_ms": predicted, "body_ms": body,
            "measured_ratio": m_ratio, "predicted_ratio": p_ratio,
            "measured_order": "level" if level else order(m_ratio),
            "predicted_order": order(p_ratio), "agree": agree,
            "tiles": geom.tiles, "held_to_order": held}


def _card_priced(work: Workload, eng, mid, nrhs, pack, bytes_moved,
                 stats):
    """The cost model's card price of the plan a kernel ran under, from the
    matrix's statistics (memoized in ``stats``) and on the built pack,
    beside the bound's bytes.  The pack's kernel bytes must equal the
    bound's (``bytes_moved``, counted without the cost model)."""
    from repro_torch.core import tuner
    from repro_torch.roofline import cost_model
    den = cost_model.calibrate("cuda")
    check(cost_model.pack_kernel_bytes(pack, nrhs) == bytes_moved,
          f"{mid}: cost_model.pack_kernel_bytes "
          f"{cost_model.pack_kernel_bytes(pack, nrhs)} != the bound's "
          f"{bytes_moved}")
    plan = dataclasses.replace(eng.executor(mid).op.plan, nrhs=nrhs)
    if mid not in stats:
        stats[mid] = tuner.stats_of(work.M[mid])
    priced = cost_model.card_plan_cost(stats[mid], plan, den)
    on_pack = cost_model.card_plan_cost(
        stats[mid], plan, den, geometry=cost_model.pack_geometry(pack))
    check(on_pack.kernel_bytes == bytes_moved,
          f"{mid}: card pricing's kernel bytes on the pack "
          f"{on_pack.kernel_bytes} != the bound's {bytes_moved}")
    return {"plan": plan.key(), "bound_bytes": bytes_moved,
            "bytes": priced.bytes,
            "ratio_to_bound_bytes": priced.bytes / bytes_moved,
            "layout_bytes": priced.layout_bytes,
            "accumulation_bytes": priced.accumulation_bytes,
            "launches": priced.launches,
            "predicted_ms": priced.predicted_s * 1e3,
            "on_pack_bytes": on_pack.bytes,
            "on_pack_ratio_to_bound_bytes": on_pack.bytes / bytes_moved}


# the segment phase's matrix: the benchmark's cube (HPCG's stencil on 112^3,
# n = 1,404,928), whose band of 12,657 no window takes
SEGMENT_GRID = (112, 112, 112)


def phase_segment(grid, seed: int):
    """The ``segment`` path's main run on a matrix too wide for every
    window: HPCG's stencil on ``grid``, registered with the default plan
    (which must be ``segment``, one ``segment_route_total{route="kernel"}``),
    served (a wave of 8 requests, one SpMM, then one SpMV) and solved by
    8-column block CG, every product one K15 launch; answers against the
    float64 scipy product.  Then K15 against its plain version (the gather
    + ``index_add_`` chain on the card) on the grid at B = 1 and 8, on dyadic
    values (equal) and general ones (within ``TOL`` of the row's absolute
    sum), on a small rectangular matrix at B = 3, and in its split form
    (two launches a product) on Graph500's Kronecker graph at
    ``KRON_SCALE`` at B = 1 and 8, al != au; and K15 timed beside its byte
    bound, the plain chain, one ``index_add_`` of the (k, B) transpose term
    and one ``torch.sparse`` CSR product, and on the Kronecker graph split
    and unsplit beside its bound and the plain chain.  Returns (K15's
    launches on the main run, the kernels-table row at B = 8 with the B = 1
    times and the split form's beside it)."""
    from repro_torch import obs
    from repro_torch.core import csrc, solvers
    from repro_torch.kernels import _build
    from repro_torch.kernels import csrc_segment as seg
    from repro_torch.kernels import ref
    from repro_torch.serve import SpmvServingEngine

    name = seg.K15.name
    nx, ny, nz = grid
    n = nx * ny * nz
    rng = np.random.default_rng(seed + 500)
    t0 = time.perf_counter()
    arr = stencil27_arrays(nx, ny, nz)
    M = csrc.from_assembly(n, *arr)
    csr = scipy_csr(n, *arr)
    abs_csr = abs(csr)
    construct_s = time.perf_counter() - t0
    sample = np.sort(rng.choice(n, size=min(n, 4096), replace=False))

    def check_rows(X, Y, what):
        want = csr[sample] @ X.astype(np.float64)
        bound = 2 * TOL * (abs_csr[sample] @ np.abs(X).astype(np.float64))
        err = np.abs(Y[sample] - want)
        check(bool(np.isfinite(Y).all()) and bool((err <= bound).all()),
              f"segment {what}: differs from the float64 reference "
              f"(max {err.max()})")
        return float(err.max())

    routed = obs.counter("segment_route_total", route="kernel")
    routed0 = routed.value
    _build.reset_launch_counts()          # the main run starts here
    eng = SpmvServingEngine()
    plan = eng.register("cube", M)
    check(plan.path == "segment", f"cube: plan is {plan.key()}, expected "
          "the segment path")
    check(routed.value == routed0 + 1, "the cube's operator did not route "
          "its segment product to K15")
    serve = {}
    for per in (8, 1):
        sent = {eng.submit("cube", x): x for x in
                (rng.standard_normal(n, dtype=np.float32)
                 for _ in range(per))}
        before = _build.launch_counts()[name]
        out = eng.run_until_drained()
        check(_build.launch_counts()[name] == before + 1,
              f"a tick of {per} requests did not launch K15 once")
        X = np.stack(list(sent.values()), axis=1)
        Y = np.stack([np.asarray(out[u]) for u in sent], axis=1)
        serve[f"B{per}_err_vs_float64"] = check_rows(X, Y, f"serve B={per}")
    b = rng.standard_normal((n, 8), dtype=np.float32)
    before = _build.launch_counts()[name]
    t0 = time.perf_counter()
    res, op = solvers.cg_solve(M, torch.from_numpy(b), cache=eng.cache,
                               tol=1e-6)
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    check(res.converged and op.plan.path == "segment",
          f"segment cg: converged {res.converged}, plan {op.plan.key()}")
    x = res.x.cpu().numpy().astype(np.float64)
    cg_true = float(np.max(np.linalg.norm(b - csr @ x, axis=0)
                           / np.linalg.norm(b, axis=0)))
    check(cg_true <= 1e-5, f"segment cg true residual {cg_true}")
    cg_launches = _build.launch_counts()[name] - before
    check(cg_launches >= res.iters, f"segment cg: {cg_launches} K15 "
          f"launches for {res.iters} iterations")
    launches = _build.launch_counts()[name]     # ... and ends here
    cg = {"nrhs": 8, "iters": res.iters, "launches": cg_launches,
          "true_residual": cg_true, "seconds": round(cg_s, 4)}
    del eng, op, res
    gc.collect()

    # K15 against its plain version: dyadic (equal) and general values
    errs = {}
    for kind, dyadic in (("dyadic", True), ("general", False)):
        arr_v = stencil27_arrays(nx, ny, nz, seed + 501, symmetric=False,
                                 dyadic=dyadic)
        Mv = csrc.from_assembly(n, *arr_v).to("cuda")
        Ma = csrc_abs(n, *arr_v).to("cuda")
        for width in (1, 8):
            shape = (n,) if width == 1 else (n, width)
            xv = (dyadic_vector(rng, shape) if dyadic
                  else rng.standard_normal(shape, dtype=np.float32))
            errs[f"{kind}/B{width}"] = _compare(
                f"segment/{kind}/B{width}",
                lambda v: seg.SegmentKernel(Mv)(v),
                lambda v: seg.segment_product_plain(Mv, v),
                torch.from_numpy(xv).cuda(), exact=dyadic,
                abs_plain=lambda v: seg.segment_product_plain(Ma, v))
        del Mv, Ma, arr_v
    Mr = csrc.rectangular_fem(400, 37, 9, seed=seed)
    Mr = dataclasses.replace(Mr, **{f: torch.round(getattr(Mr, f) * 4) / 4
                                    for f in ("ad", "al", "au", "ar")})
    Mr = Mr.to("cuda")
    errs["rectangular/B3"] = _compare(
        "segment/rectangular/B3", lambda v: seg.SegmentKernel(Mr)(v),
        lambda v: seg.segment_product_plain(Mr, v),
        torch.from_numpy(dyadic_vector(rng, (Mr.m, 3))).cuda(), exact=True)
    del Mr

    # the split form: Graph500's Kronecker graph, al != au, whose rows past
    # HEAVY_SLOTS K15 cuts into chunks (two launches a product)
    for kind, dyadic in (("dyadic", True), ("general", False)):
        nk, arr_v = kronecker_arrays(KRON_SCALE, seed + 502, symmetric=False,
                                     dyadic=dyadic, device="cuda")
        Mv = csrc.from_assembly(nk, *arr_v).to("cuda")
        Ma = csrc_abs(nk, *arr_v).to("cuda")
        kv = seg.SegmentKernel(Mv)
        check(kv.split.rows > 0, f"kron{KRON_SCALE}: no row was split")
        for width in (1, 8):
            shape = (nk,) if width == 1 else (nk, width)
            xv = (dyadic_vector(rng, shape) if dyadic
                  else rng.standard_normal(shape, dtype=np.float32))
            before = _build.launch_counts()[name]
            errs[f"kron/{kind}/B{width}"] = _compare(
                f"segment/kron{KRON_SCALE}/{kind}/B{width}", kv,
                lambda v: seg.segment_product_plain(Mv, v),
                torch.from_numpy(xv).cuda(), exact=dyadic,
                abs_plain=lambda v: seg.segment_product_plain(Ma, v))
            check(_build.launch_counts()[name] == before + 2,
                  f"kron{KRON_SCALE} B={width}: a split product is not two "
                  "launches")
        del Mv, Ma, kv, arr_v
        gc.collect()
        torch.cuda.empty_cache()

    # times at the grid's shape, HPCG's values
    Md = M.to("cuda")
    k15 = seg.SegmentKernel(Md)
    row_idx32 = ref.row_index(Md)      # as the operator held it before K15
    row_idx = row_idx32.long()
    ja64 = Md.ja.long()
    lib = torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr.astype(np.int64)),
        torch.from_numpy(csr.indices.astype(np.int64)),
        torch.from_numpy(csr.data.astype(np.float32)), size=(n, n)).cuda()
    times = {}
    for width in (1, 8):
        shape = (n,) if width == 1 else (n, width)
        xt = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                              ).cuda()
        contrib = (Md.al[:, None] * xt.reshape(n, -1)[row_idx]).reshape(
            (-1,) + shape[1:])
        out = torch.zeros(shape, dtype=torch.float32, device="cuda")
        # ia, ja, ad and al (HPCG's values are symmetric: au is not read),
        # X read and Y written once
        nbytes = (4 * (n + 1) + 4 * Md.k + 4 * (n + Md.k)
                  + 2 * 4 * n * width)
        flops = (2 * M.nnz - n) * width
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        times[width] = {
            "ms": time_ms(lambda: k15(xt)),
            "plain_ms": time_ms(lambda: seg.segment_product_plain(
                Md, xt, row_idx=row_idx32)),
            "index_add_ms": time_ms(lambda: out.index_add_(0, ja64,
                                                          contrib)),
            "sparse_csr_ms": time_ms(lambda: lib @ xt),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}
        del contrib, out, xt
    del lib, Md, k15, row_idx, row_idx32, ja64
    torch.cuda.empty_cache()

    # ... and on the Kronecker graph with al = au, as the kron21-lgc cell
    # holds it: split, and unsplit (no row heavy) at B = 8
    nk, arr_k = kronecker_arrays(KRON_SCALE, seed + 503, device="cuda")
    Mk = csrc.from_assembly(nk, *arr_k).to("cuda")
    del arr_k
    kk = seg.SegmentKernel(Mk)
    unsplit = seg.SegmentKernel(Mk, seg.split_rows(Mk.ia, heavy=2**31 - 1))
    row_idx32 = ref.row_index(Mk)
    split_times = {}
    for width in (1, 8):
        shape = (nk,) if width == 1 else (nk, width)
        xt = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                              ).cuda()
        nbytes = (4 * (nk + 1) + 4 * Mk.k + 4 * (nk + Mk.k)
                  + 2 * 4 * nk * width)
        flops = (2 * Mk.nnz - nk) * width
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS * 1e3
        split_times[width] = {
            "ms": time_ms(lambda: kk(xt)),
            "plain_ms": time_ms(lambda: seg.segment_product_plain(
                Mk, xt, row_idx=row_idx32)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}
        if width == 8:
            split_times[width]["unsplit_ms"] = time_ms(lambda: unsplit(xt))
        del xt
    split = {"matrix": f"kron{KRON_SCALE}", "n": nk, "k": Mk.k,
             "longest_lower_row": int((Mk.ia[1:] - Mk.ia[:-1]).max()),
             "rows": kk.split.rows, "slots": kk.split.slots,
             "chunks": int(kk.split.chunks.shape[0]), "heavy": kk.split.heavy}
    del Mk, kk, unsplit, row_idx32
    gc.collect()
    torch.cuda.empty_cache()
    emit("segment", grid=list(grid), n=n, k=M.k, plan=plan.key(),
         construct_s=round(construct_s, 3), launches=launches,
         cg=cg, serve=serve, max_abs_err=errs, times=times,
         split=split, split_times=split_times)
    k = _build.KERNELS[name]
    b8 = times[8]
    row = {"name": name, "route": "cuda", "source": k.repo_source,
           "replaces": k.replaces, "launches": launches,
           "max_abs_err": errs["general/B8"], "ms": b8["ms"],
           "plain_ms": b8["plain_ms"], "bound_ms": b8["bound_ms"],
           "bound_by": b8["bound_by"], "library_ms": b8["index_add_ms"],
           "sparse_csr_ms": b8["sparse_csr_ms"],
           "shape": {"matrix": f"hpcg27_{nx}x{ny}x{nz}", "nrhs": 8,
                     "n": n, "k": M.k},
           "bytes": b8["bytes"], "flops": b8["flops"], "B1": times[1],
           "split": dict(split_times[8], shape=dict(split, nrhs=8),
                         max_abs_err=errs["kron/general/B8"],
                         B1=split_times[1])}
    return launches, row


# the matrix of each path that this slice's tune phase tunes
TUNED = {"kernel": "fem_ns", "flat": "skew_ns"}
MEASURE = {"warmup": 1, "repeats": 3}      # tuner.tune's defaults


def _kernel_of(plan) -> str:
    """The kernel a plan's product launches: K1-K12 by path, width and
    variant ('kernel' names the rectangular grid's blockell_* kernels)."""
    grid = "blockell" if plan.path == "kernel" else plan.path
    width = "spmv" if plan.nrhs == 1 else "spmm"
    return f"{grid}_{width}_{plan.variant}"


def phase_tune(work: Workload, spec):
    """This slice's path: measured tuning of the path's non-symmetric
    matrix at full width.  A fresh ``SpmvServingEngine(autotune=True,
    serve_nrhs=8)`` registers it (``tuner.tune`` at nrhs_options (1, 8),
    predict-then-measure with card pricing); the winner serves a wave of
    11 requests and one request, checked as ``phase_serve`` checks; the
    heuristic plan at one column and at the serve width is timed by the
    tuner's timer on the tuner's inputs (or read from the tuner's timings),
    and the winner's time per column must be within 1.05x of both; a
    second engine on the same cache registers the matrix with zero
    measurements and zero packs.  Launch counts are this phase's own."""
    from repro_torch import obs
    from repro_torch.core import tuner
    from repro_torch.core.paths import BUILD_COUNTS
    from repro_torch.device import time_fn
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import SpmvOperator
    from repro_torch.serve import SpmvServingEngine

    mid = TUNED[spec["name"]]
    M, n = work.M[mid], work.n
    t_phase = time.perf_counter()
    stats = tuner.stats_of(M)
    pool = {p.key(): p for p in tuner.enumerate_plans(stats,
                                                      nrhs_options=(1, 8))}
    cache = tuner.PlanCache()
    _build.reset_launch_counts()           # this phase's run starts here
    obs.clear_trace()
    snap = obs.snapshot()
    t0 = time.perf_counter()
    eng = SpmvServingEngine(cache=cache, autotune=True, serve_nrhs=8)
    plan = eng.register(mid, M)
    register_s = time.perf_counter() - t0
    spans = {}
    for rec in obs.trace():
        if rec["name"] in ("tune.pack", "tune.measure"):
            spans[rec["name"]] = spans.get(rec["name"], 0.0) + rec[
                "duration_s"]
    entry = cache.entries[tuner.fingerprint(M)]
    timings = {k: v / 1e6 for k, v in entry["timings_us"].items()}
    predicted = {k: v / 1e6 for k, v in entry["predicted_us"].items()}
    check(obs.snapshot().diff(snap).total(
        "tuner_candidates_measured_total") == len(timings) > 0,
        f"{mid}: measured count off the cache entry")
    check(set(predicted) == set(pool) and set(timings) <= set(pool),
          f"{mid}: priced pool differs from enumerate_plans")
    variants = {pool[k].variant for k in timings
                if pool[k].path in ("kernel", "flat", "nnzsplit")}
    check(variants == {"stream", "onehot"},
          f"{mid}: measured variants {variants}, need a stream and a "
          "one-hot plan")
    winner_col = timings[plan.key()] / plan.nrhs

    # the heuristic plan at one column and at the serve width, by the same
    # timer on the tuner's inputs: read from the tuner's timings where it
    # measured them, else timed here on one build
    heur = tuner.heuristic_plan(stats)
    heuristic = {}
    op = None
    for width in (1, 8):
        hp = dataclasses.replace(heur, nrhs=width)
        if hp.key() in timings:
            secs, by_tune = timings[hp.key()], True
        else:
            if op is None:
                op = SpmvOperator.from_plan(M, heur)
            shape = (M.m,) if width == 1 else (M.m, width)
            x = torch.from_numpy(np.random.default_rng(
                0 if width == 1 else width).standard_normal(shape).astype(
                    np.float32)).cuda()
            secs, by_tune = time_fn(op, x, **MEASURE), False
            del x
        heuristic[f"r{width}"] = {"plan": hp.key(),
                                  "s_per_column": secs / width,
                                  "measured_by_tune": by_tune}
    del op
    torch.cuda.empty_cache()
    for width in ("r1", "r8"):
        heur_col = heuristic[width]["s_per_column"]
        check(winner_col <= 1.05 * heur_col,
              f"{mid}: tuned {plan.key()} {winner_col} s a column, "
              f"heuristic {heuristic[width]['plan']} {heur_col} s")
    one_col = timings.get(dataclasses.replace(plan, nrhs=1).key())

    # the tuned plan serves: a wave of 11 (one SpMM), then one request
    segment = SpmvOperator(M, path="segment")
    abs_op = SpmvOperator(csrc_abs(n, *work.arrays[mid]), path="segment")
    waves = []
    for per in (11, 1):
        xs = [work.rng.standard_normal(n, dtype=np.float32)
              for _ in range(per)]
        uids = [eng.submit(mid, x) for x in xs]
        t0 = time.perf_counter()
        out = eng.run_until_drained()
        tick_s = time.perf_counter() - t0
        check(all(out[u].batched == per and out[u].plan_key == plan.key()
                  for u in uids), f"{mid}: tuned wave metadata wrong")
        Y = np.stack([np.asarray(out[u]) for u in uids], axis=1)
        errs = work.check_answers(work.csr[mid], np.stack(xs, axis=1), Y,
                                  segment, abs_op,
                                  f"tuned {mid} B={per}")
        waves.append({"requests": per, "tick_s": round(tick_s, 4),
                      "execute_s": out[uids[0]].timings["execute_s"],
                      "err_vs_float64": errs[0],
                      "err_vs_segment": errs[1]})
    del segment, abs_op

    # a second engine on the same cache: no measurement, no pack
    before = dict(BUILD_COUNTS.items())
    snap = obs.snapshot()
    t0 = time.perf_counter()
    eng2 = SpmvServingEngine(cache=cache, autotune=True, serve_nrhs=8)
    plan2 = eng2.register(mid, M)
    second_s = time.perf_counter() - t0
    measured2 = obs.snapshot().diff(snap).total(
        "tuner_candidates_measured_total")
    builds = {k: v - before.get(k, 0) for k, v in BUILD_COUNTS.items()
              if v != before.get(k, 0)}
    check(plan2 == plan and measured2 == 0 and not builds,
          f"{mid}: second engine measured {measured2}, built {builds}")
    counts = _build.launch_counts()        # ... and ends here
    for key in timings:
        if pool[key].path in ("kernel", "flat", "nnzsplit"):
            name = _kernel_of(pool[key])
            check(counts[name] > 0, f"{mid}: {key} was measured but "
                  f"{name} never launched")
    emit("tune", matrix=mid, path=spec["name"], n=n, nnz=int(M.nnz),
         pool=len(predicted), measured=len(timings),
         timings_s={k: {"measured_s": t, "predicted_s": predicted[k]}
                    for k, t in timings.items()},
         pack_s=round(spans.get("tune.pack", 0.0), 3),
         measure_s=round(spans.get("tune.measure", 0.0), 3),
         register_s=round(register_s, 3), winner=plan.key(),
         winner_s_per_column=winner_col,
         winner_one_column_s=one_col, heuristic=heuristic,
         # the tuner's gain at the serve width (plan choice alone), and
         # against one column (batching plus plan choice)
         gain_at_serve_width=heuristic["r8"]["s_per_column"] / winner_col,
         gain_over_one_column=heuristic["r1"]["s_per_column"] / winner_col,
         roofline_fraction=entry.get("roofline_fraction"),
         denominators=entry["denominators"], waves=waves,
         second_engine={"register_s": round(second_s, 3),
                        "measurements": measured2, "builds": builds},
         launches={k: v for k, v in counts.items() if v},
         seconds=round(time.perf_counter() - t_phase, 3))
    del eng, eng2
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The mesh phase: the paper's three accumulations over p shards emulated on
# the one card (core/distributed.py), shard-local K5-K12
# ---------------------------------------------------------------------------

MESH_P = 8
MESH_WIDTHS = (1, 8)
# the main path whose matrix the mesh phase reuses
MESH_MATRIX = {"kernel": "fem_sym", "nnzsplit": "pl_sym"}
MESH_MID_N = 40_000
MESH_TOL = 2e-5       # of the row's absolute sum, against the local answer
# (matrix, path, variant, strategies): Table 2's form, with the one-hot
# twins; halo on pl_sym must raise (its band is about n)
MESH_CASES = (
    ("fem_sym", "segment", "stream", ("allreduce", "reduce_scatter", "halo")),
    ("fem_sym", "flat", "stream", ("allreduce", "reduce_scatter", "halo")),
    ("fem_sym", "flat", "onehot", ("allreduce",)),
    ("pl_sym", "nnzsplit", "stream", ("allreduce", "reduce_scatter")),
    ("pl_sym", "segment", "stream", ("allreduce", "reduce_scatter")),
    ("pl_sym", "nnzsplit", "onehot", ("reduce_scatter",)),
)
MESH_KERNELS = ("flat_spmv_stream", "flat_spmm_stream", "flat_spmv_onehot",
                "flat_spmm_onehot", "nnzsplit_spmv_stream",
                "nnzsplit_spmm_stream", "nnzsplit_spmv_onehot",
                "nnzsplit_spmm_onehot")


@contextlib.contextmanager
def uncounted():
    """Launches made inside are taken back off the counts: a reference
    answer or a comparison, not the path under test."""
    from repro_torch.kernels import _build
    saved = _build.launch_counts()
    try:
        yield
    finally:
        for name, k in _build.KERNELS.items():
            k.launches = saved[name]


def _mesh_plan(path, variant, acc, p):
    from repro_torch.core.plan import ExecutionPlan
    return ExecutionPlan(path=path, variant=variant, strategy="mesh",
                         mesh_p=p, accumulation=acc)


def _shard_counts(fn, M, S=1024):
    """Per shard, (real, padded) k-steps of a flat layout or chunks of an
    nnz-split one; None for the index_add_ layouts."""
    from repro_torch.core.csrc import row_of_slot
    from repro_torch.kernels.csrc_spmv_flat import FlatHalo, FlatShards
    from repro_torch.kernels.csrc_spmv_nnzsplit import NnzSplitShards
    lay = fn.layout
    if isinstance(lay, (FlatShards, FlatHalo)):
        real = [int(lay.shard_pack(t).step_start[-1]) for t in range(lay.p)]
        return {"steps_real": real, "steps_padded": lay.steps}
    if isinstance(lay, NnzSplitShards):
        ja = M.ja.numpy()
        cnt = (np.bincount(row_of_slot(M), minlength=M.n)
               + np.bincount(ja, minlength=M.n))
        cum = np.concatenate([[0], np.cumsum(cnt)])
        starts = np.asarray(fn.part.starts)
        per = cum[starts[1:]] - cum[starts[:-1]]
        return {"chunks_real": [int(-(-e // (lay.ks * 128))) for e in per],
                "chunks_padded": lay.num_chunks, "r_pad": lay.r_pad}
    return None


def _mesh_mid_cases(seed: int):
    """K5-K12 on shard and halo packs at a mid shape (n = 40,000, p = 8,
    dyadic values): each mesh product on the card (the kernels) equal bit
    for bit to the same product on the CPU (the plain versions), with p
    launches of its kernel per product; and the p = 1 mesh equal to the
    local executor on the card, as the JAX package's
    ``test_mesh_executor_bit_identical_to_local_p1``."""
    from repro_torch.core import csrc, distributed as D
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.kernels import _build
    from repro_torch.serve import LocalExecutor, MeshExecutor
    n = MESH_MID_N
    mats = {"band": csrc.from_assembly(n, *band_arrays(
                n, HALF_BAND, FILL, seed + 40, True, dyadic=True)),
            "pl": csrc.from_assembly(n, *powerlaw_arrays(
                n, seed + 41, dyadic=True))}
    cases = ([("band", "flat", v, acc) for v in ("stream", "onehot")
              for acc in ("allreduce", "reduce_scatter", "halo")]
             + [("band", "nnzsplit", v, "halo") for v in ("stream", "onehot")]
             + [("pl", "nnzsplit", v, acc) for v in ("stream", "onehot")
                for acc in ("allreduce", "reduce_scatter")])
    rng = np.random.default_rng(seed + 42)
    card_mesh = D.ShardMesh(MESH_P, "cuda")
    cpu_mesh = D.ShardMesh(MESH_P, "cpu")
    seen = set()
    t0 = time.perf_counter()
    for mid, path, variant, acc in cases:
        plan = _mesh_plan(path, variant, acc, MESH_P)
        on_card = D.build_sharded_spmv(mats[mid], card_mesh, plan=plan)
        plain = D.build_sharded_spmv(mats[mid], cpu_mesh, plan=plan)
        for nrhs in MESH_WIDTHS:
            x = dyadic_vector(rng, (n,) if nrhs == 1 else (n, nrhs))
            name = _kernel_of(dataclasses.replace(plan, nrhs=nrhs))
            before = _build.launch_counts()[name]
            got = on_card(torch.from_numpy(x).cuda()).cpu()
            check(_build.launch_counts()[name] == before + MESH_P,
                  f"mesh mid {mid} {plan.key()}: {name} not launched once "
                  "per shard")
            want = plain(torch.from_numpy(x))
            check(torch.equal(got, want),
                  f"mesh mid {mid} {plan.key()} B={nrhs}: card differs from "
                  f"the plain versions (max {float((got - want).abs().max())})")
            seen.add(name)
        del on_card, plain
    check(seen == set(MESH_KERNELS), f"mid cases ran only {sorted(seen)}")
    # p = 1: the mesh equal to the local executor, bit for bit (dyadic)
    M = mats["band"]
    local = LocalExecutor(M, ExecutionPlan(path="segment"))
    for acc in ("allreduce", "reduce_scatter", "halo"):
        ex = MeshExecutor(M, ExecutionPlan(path="segment", strategy="mesh",
                                           mesh_p=1, accumulation=acc))
        for nrhs in (1, 3, 8):
            x = torch.from_numpy(dyadic_vector(
                rng, (n,) if nrhs == 1 else (n, nrhs))).cuda()
            check(torch.equal(ex(x), local(x)),
                  f"p=1 mesh {acc} B={nrhs} differs from LocalExecutor")
    emit("mesh_mid", n=n, p=MESH_P, cases=len(cases),
         widths=list(MESH_WIDTHS), kernels=sorted(seen),
         p1_equals_local=["allreduce", "reduce_scatter", "halo"],
         seconds=round(time.perf_counter() - t0, 3))


def _mesh_case(fn, M, local, abs_op, x, what, name):
    """One product on the card: its kernel ``name`` (None: ``index_add_``)
    launched once per shard, the answer checked against the local one;
    then timed whole and by stage."""
    from repro_torch.kernels import _build
    before = _build.launch_counts()
    y = fn(x)[:M.n]
    after = _build.launch_counts()
    launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
    check(launched == ({} if name is None else {name: fn.p}),
          f"{what}: launched {launched}, not {name} once per shard")
    check(bool(torch.isfinite(y).all()), f"{what}: non-finite answer")
    with uncounted():
        want = local(x)
        bound = MESH_TOL * abs_op(x.abs())
    err = (y - want).abs()
    check(bool((err <= bound + 1e-30).all()),
          f"{what}: differs from the local answer (max {float(err.max())})")
    del y, want, bound
    xs = fn.prepare(x)
    parts = fn.local(xs)
    out = {"ms": time_ms(lambda: fn(x)),
           "prepare_ms": time_ms(lambda: fn.prepare(x)),
           "kernels_ms": time_ms(lambda: fn.local(xs)),
           # combine adds into the first partial: its values grow, its
           # time does not change
           "combine_ms": time_ms(lambda: fn.combine(parts)),
           "max_err_vs_local": float(err.max())}
    out["accumulation_ms"] = out["prepare_ms"] + out["combine_ms"]
    return out


def _shard_kernels_hold(fn, name, x, what):
    """Each shard's kernel ``name`` at the shapes the mesh product gives it
    (the stacked shard or halo pack's view, the cut of its inert tail, the
    shard's own x) against its plain version on the card, within TOL of
    the row's absolute sum.  Returns the largest error."""
    lay = fn.layout
    errs = []
    with uncounted():
        for t, xt in enumerate(fn.prepare(x)):
            pack = lay.shard_pack(t)
            kernel, plain = _runners(pack, lay.ks)[name]
            # the bound only: the stream plain version is the quicker
            abs_plain = _runners(abs_pack(pack), lay.ks)[
                name.replace("onehot", "stream")][1]
            errs.append(_compare(f"{what} shard {t}/{name}", kernel, plain,
                                 xt, exact=False, abs_plain=abs_plain))
            del pack
    return max(errs)


def phase_mesh(inputs, seed: int):
    """This slice's path: the mesh layer at full width.  ``inputs`` holds,
    for ``fem_sym`` (the kernel path's) and ``pl_sym`` (the nnzsplit
    path's), the matrix, its arrays, its float64 scipy matrix, the local
    executor its main run served with and the segment operator of |A|.
    Every mesh runs on one card, ``ShardMesh(p, "cuda")``.  Returns the
    launch counts of the phase's main run (Table 2, Figs. 8/9, serving, CG
    and tune_mesh): the mesh products' alone, the local answers they are
    checked against and the per-shard comparisons taken off (``uncounted``)."""
    from repro_torch import obs
    from repro_torch.core import distributed as D
    from repro_torch.core import schedule, solvers, tuner
    from repro_torch.core.paths import BUILD_COUNTS
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.kernels import _build
    from repro_torch.serve import SpmvServingEngine

    t_phase = time.perf_counter()
    _mesh_mid_cases(seed)
    n = inputs["fem_sym"]["M"].n
    abs_ops = {mid: d["abs"] for mid, d in inputs.items()}
    rng = np.random.default_rng(seed + 43)
    xs = {w: torch.from_numpy(rng.standard_normal(
        (n,) if w == 1 else (n, w), dtype=np.float32)).cuda()
        for w in MESH_WIDTHS}
    mesh = D.ShardMesh(MESH_P, "cuda")
    _build.reset_launch_counts()          # this phase's main run starts here

    # -- Table 2: every strategy at p = 8, B = 1 and 8 --------------------
    # one row partition per matrix and one layout per (matrix, path, kind),
    # built and bound to the card once, shared by the plans that use it
    with uncounted():
        local_ms = {mid: {f"B{w}": time_ms(lambda: d["local"](xs[w]))
                          for w in MESH_WIDTHS}
                    for mid, d in inputs.items()}
    scheds, layouts = {}, {}

    def timed_build(make):
        before = dict(BUILD_COUNTS.items())
        t0 = time.perf_counter()
        out = make()
        torch.cuda.synchronize()
        return out, {"build_s": round(time.perf_counter() - t0, 3),
                     "builds": {k: v - before.get(k, 0)
                                for k, v in BUILD_COUNTS.items()
                                if v != before.get(k, 0)}}

    def layout_for(mid, plan):
        M = inputs[mid]["M"]
        halo = plan.accumulation == "halo"
        if not halo and mid not in scheds:
            scheds[mid] = timed_build(lambda: schedule.schedule_for(
                M, ExecutionPlan(path="segment"), p=MESH_P))
        key = (mid, plan.path, halo)
        if key not in layouts:
            if plan.path == "segment":
                make = ((lambda: schedule.build_halo_layout(M, MESH_P)) if halo
                        else (lambda: schedule.build_sharded_slots(
                            M, scheds[mid][0].partition)))
            else:
                make = ((lambda: schedule.build_path_halo(M, MESH_P, plan))
                        if halo else (lambda: schedule.build_path_shards(
                            M, scheds[mid][0].partition, plan)))
            layouts[key] = timed_build(lambda: make().to(mesh.device))
        return (None if halo else scheds[mid][0]), layouts[key][0]

    table = []
    shards_held = set()     # (layout, kernel): each shard held against plain
    for mid, path, variant, strategies in MESH_CASES:
        M = inputs[mid]["M"]
        for acc in strategies:
            plan = _mesh_plan(path, variant, acc, MESH_P)
            sched, lay = layout_for(mid, plan)
            fn = D.build_sharded_spmv(M, mesh, plan=plan, schedule=sched,
                                      layout=lay)
            row = {"matrix": mid, "plan": plan.key(), "path": path,
                   "variant": variant, "strategy": acc, "p": MESH_P,
                   "layout": layouts[(mid, path, acc == "halo")][1],
                   "schedule": None if sched is None else scheds[mid][1],
                   "shards": _shard_counts(fn, M), "widths": {}}
            for w in MESH_WIDTHS:
                what = f"mesh {mid} {plan.key()} B={w}"
                name = (_kernel_of(dataclasses.replace(plan, nrhs=w))
                        if path != "segment" else None)
                r = _mesh_case(fn, M, inputs[mid]["local"], abs_ops[mid],
                               xs[w], what, name)
                key = (mid, path, acc == "halo", name)
                if name is not None and key not in shards_held:
                    r["shard_kernels_max_abs_err"] = _shard_kernels_hold(
                        fn, name, xs[w], what)
                    shards_held.add(key)
                r.update(
                    kernel=name or "index_add_",
                    accumulation_bytes=fn.accumulation_bytes(w),
                    collective_bytes_estimate=D.collective_bytes_estimate(
                        M, MESH_P, acc, nrhs=w),
                    local_plan_ms=local_ms[mid][f"B{w}"])
                row["widths"][f"B{w}"] = r
            table.append(row)
            emit("mesh_table2", **row)
            del fn
    check({key[3] for key in shards_held} == set(MESH_KERNELS),
          f"the full-size shard packs held only {sorted(shards_held)}")
    raised = None
    try:
        D.build_sharded_spmv(inputs["pl_sym"]["M"], mesh,
                             plan=_mesh_plan("nnzsplit", "stream", "halo",
                                             MESH_P))
    except ValueError as e:
        raised = str(e)
    check(raised is not None and "exceeds shard rows" in raised,
          f"pl_sym halo did not raise the band gate: {raised}")

    # -- Figs. 8/9: halo, flat stream, B = 1, p = 1, 2, 4, 8 ---------------
    M = inputs["fem_sym"]["M"]
    scaling = {}
    for p in (1, 2, 4, 8):
        t0 = time.perf_counter()
        fn = D.build_sharded_spmv(
            M, D.ShardMesh(p, "cuda"),
            plan=_mesh_plan("flat", "stream", "halo", p),
            layout=(layouts[("fem_sym", "flat", True)][0] if p == MESH_P
                    else None))
        build_s = time.perf_counter() - t0
        r = _mesh_case(fn, M, inputs["fem_sym"]["local"],
                       abs_ops["fem_sym"], xs[1], f"mesh scaling p={p}",
                       "flat_spmv_stream")
        scaling[f"p{p}"] = {"ms": r["ms"], "kernels_ms": r["kernels_ms"],
                            "accumulation_ms": r["accumulation_ms"],
                            "build_s": round(build_s, 3)}
        del fn
    del layouts, scheds
    torch.cuda.empty_cache()
    emit("mesh_scaling", matrix="fem_sym", path="flat", variant="stream",
         strategy="halo", nrhs=1, local_plan_ms=local_ms["fem_sym"]["B1"],
         note="p shards emulated on one card: the cost of more shards, "
              "not a speedup", by_p=scaling)

    # -- serving and block CG through the mesh ----------------------------
    cache = tuner.PlanCache()
    eng = SpmvServingEngine(cache=cache, mesh_p=MESH_P, mesh=mesh)
    t0 = time.perf_counter()
    plans = {"fem_sym": eng.register("fem_sym", inputs["fem_sym"]["M"]),
             "pl_sym": eng.register("pl_sym", inputs["pl_sym"]["M"],
                                    plan=_mesh_plan("nnzsplit", "stream",
                                                    "reduce_scatter",
                                                    MESH_P))}
    register_s = time.perf_counter() - t0
    heur = tuner.heuristic_mesh_plan(tuner.stats_of(inputs["fem_sym"]["M"]),
                                     MESH_P)
    check(plans["fem_sym"] == heur,
          f"fem_sym registered {plans['fem_sym'].key()}, the heuristic mesh "
          f"plan is {heur.key()}")
    waves = []
    for per in (11, 1):
        sent = {}
        for mid in plans:
            for _ in range(per):
                x = rng.standard_normal(n, dtype=np.float32)
                sent[eng.submit(mid, x)] = (mid, x)
        t0 = time.perf_counter()
        out = eng.run_until_drained()
        tick_s = time.perf_counter() - t0
        check(set(out) == set(sent), "mesh engine: not every request answered")
        wave = {"requests_per_matrix": per, "tick_s": round(tick_s, 4)}
        for mid in plans:
            uids = [u for u, (m, _) in sent.items() if m == mid]
            for u in uids:
                r = out[u]
                check(r.executor == "mesh" and r.strategy == "mesh"
                      and r.mesh_p == MESH_P and r.batched == per
                      and r.plan_key == plans[mid].key(),
                      f"mesh result metadata wrong: {r.meta()}")
            X = torch.from_numpy(np.stack([sent[u][1] for u in uids], 1)
                                 ).cuda()
            Y = torch.from_numpy(np.stack([np.asarray(out[u])
                                           for u in uids], 1)).cuda()
            with uncounted():
                want = inputs[mid]["local"](X)
                bound = MESH_TOL * abs_ops[mid](X.abs()) + 1e-30
            err = (Y - want).abs()
            check(bool((err <= bound).all()),
                  f"mesh serve {mid} B={per}: max {float(err.max())}")
            wave[mid] = {"execute_s": out[uids[0]].timings["execute_s"],
                         "max_err_vs_local": float(err.max())}
        waves.append(wave)
    # value refresh on the mesh: no structural build
    d = inputs["fem_sym"]
    from repro_torch.core import csrc
    ia, ja, ad, al, _ = d["arrays"]
    M_half = csrc.from_assembly(n, ia, ja, 0.5 * ad, 0.5 * al, 0.5 * al)
    before = dict(BUILD_COUNTS.items())
    t0 = time.perf_counter()
    eng.update_values("fem_sym", M_half)
    refresh_s = time.perf_counter() - t0
    delta = {k: v - before.get(k, 0) for k, v in BUILD_COUNTS.items()
             if v != before.get(k, 0)}
    check(delta.get("shard_value_refresh") == 1
          and not any(delta.get(k) for k in STRUCTURAL_BUILDS
                      + ("sharded_slots", "halo_layout", "flat_shards",
                         "flat_halo", "nnzsplit_shards", "nnzsplit_halo")),
          f"mesh value refresh rebuilt structure: {delta}")
    x = xs[1]
    with uncounted():
        want = 0.5 * d["local"](x)
        bound = MESH_TOL * abs_ops["fem_sym"](x.abs())
    err = (eng.executor("fem_sym")(x) - want).abs()
    check(bool((err <= bound).all()),
          f"mesh refresh: answer off by {float(err.max())}")
    eng.update_values("fem_sym", d["M"])
    # block CG with 8 right-hand sides through the MeshExecutor
    b = rng.standard_normal((n, 8), dtype=np.float32)
    ex = eng.executor("fem_sym")
    t0 = time.perf_counter()
    res = solvers.cg(ex, torch.from_numpy(b).cuda(), tol=1e-6,
                     diag=d["M"].ad)
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    check(res.converged, f"mesh cg did not converge: {res.residual}")
    xsol = res.x.cpu().numpy().astype(np.float64)
    r = b - d["csr"] @ xsol
    cg_true = float(np.max(np.linalg.norm(r, axis=0)
                           / np.linalg.norm(b, axis=0)))
    check(cg_true <= 1e-5, f"mesh cg true residual {cg_true}")
    emit("mesh_serve", p=MESH_P, plans={m: q.key() for m, q in plans.items()},
         register_s=round(register_s, 3), waves=waves,
         refresh_s=round(refresh_s, 3), refresh_builds=delta,
         cg={"matrix": "fem_sym", "nrhs": 8, "plan": ex.plan.key(),
             "iters": res.iters, "residual": res.residual,
             "true_residual": cg_true, "seconds": round(cg_s, 4)})
    del eng, ex

    # -- tune_mesh, then a second engine on the same cache ----------------
    M = inputs["fem_sym"]["M"]
    cache = tuner.PlanCache()
    snap = obs.snapshot()
    t0 = time.perf_counter()
    res = tuner.tune_mesh(M, MESH_P, cache=cache, mesh=mesh,
                          nrhs_options=(1, 8), **MEASURE)
    tune_s = time.perf_counter() - t0
    measured = obs.snapshot().diff(snap).total(
        "tuner_candidates_measured_total")
    check(measured == len(res.timings_s) > 0, "tune_mesh measured nothing")
    schedule.clear_shard_layout_memos()   # the second engine: a new process
    before = dict(BUILD_COUNTS.items())
    snap = obs.snapshot()
    t0 = time.perf_counter()
    eng2 = SpmvServingEngine(cache=cache, autotune=True, mesh_p=MESH_P,
                             mesh=mesh, serve_nrhs=8)
    plan2 = eng2.register("fem_sym", M)
    second_s = time.perf_counter() - t0
    measured2 = obs.snapshot().diff(snap).total(
        "tuner_candidates_measured_total")
    builds = {k: v - before.get(k, 0) for k, v in BUILD_COUNTS.items()
              if v != before.get(k, 0)}
    check(plan2 == res.plan and measured2 == 0 and not builds,
          f"second mesh engine measured {measured2}, built {builds}")
    y = eng2.executor("fem_sym")(xs[8])
    with uncounted():
        want = inputs["fem_sym"]["local"](xs[8])
        bound = MESH_TOL * abs_ops["fem_sym"](xs[8].abs())
    err = (y - want).abs()
    check(bool((err <= bound).all()),
          f"tuned mesh plan answer off by {float(err.max())}")
    emit("mesh_tune", matrix="fem_sym", p=MESH_P, nrhs_options=[1, 8],
         measured={k: v * 1e3 for k, v in res.timings_s.items()},
         unit="ms", winner=res.plan.key(), seconds=round(tune_s, 3),
         second_engine={"register_s": round(second_s, 3),
                        "measurements": measured2, "builds": builds})
    del eng2
    counts = _build.launch_counts()       # ... and ends here
    for name in MESH_KERNELS:
        check(counts[name] > 0, f"kernel {name} was never launched on the "
              "mesh phase's main run")

    # -- the process-group backend at world size 1 (NCCL) -----------------
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        plan = _mesh_plan("flat", "onehot", "allreduce", 1)
        em = D.build_sharded_spmv(M, D.ShardMesh(1, "cuda"), plan=plan)
        pg = D.build_sharded_spmv(
            M, D.ShardMesh(1, "cuda", backend="process_group"), plan=plan)
        for w in MESH_WIDTHS:
            a, b_ = em(xs[w]), pg.gather(pg(xs[w]))
            check(torch.equal(a, b_), f"NCCL allreduce B={w} differs from "
                  "the emulated answer")
        emit("mesh_process_group", backend=dist.get_backend(), world_size=1,
             plan=plan.key(), widths=list(MESH_WIDTHS), equal=True)
        del em, pg
    finally:
        dist.destroy_process_group()
    schedule.clear_shard_layout_memos()
    gc.collect()
    torch.cuda.empty_cache()
    emit("mesh_phase", seconds=round(time.perf_counter() - t_phase, 3))
    return counts


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
                                                          "private"}
              and "colored/onehot" in tuned.timings_s,
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


# ---------------------------------------------------------------------------
# The LM serving path: the dense family's two published models, then the
# recurrent families' two, at full width, random weights from the seed,
# served by the token ServingEngine
# ---------------------------------------------------------------------------

LM_DEVICE = "cuda"
LM_DENSE = "qwen3-8b"
LM_MOE = "deepseek-v2-lite-16b"
# launch/serve.py's traffic: 8 prompts of 4-11 tokens, 4 slots, greedy
LM_TRAFFIC = {"requests": 8, "slots": 4, "max_len": 256, "max_new": 16}
LM_DECODE_TOL = 0.05   # tests/test_models.py::test_smoke_decode_consistency
LM_INT8_TOL = 0.1      # tests/test_serve.py::test_int8_kv_decode_consistency
LM_CHUNK_TOL = 2e-2    # of the largest logit: chunked against one pass
LM_LONG = 4096         # a prefill that takes the chunked online softmax
# the recurrent families: RWKV6 (ssm) and the Mamba2 hybrid
LM_RECURRENT = ("rwkv6-1.6b", "zamba2-7b")
LM_SCAN_T = 512        # tokens of the chunked-against-recurrent checks
# (rtol, atol): tests/test_mamba2.py's bars for the chunked forms
LM_SCAN_TOL = {"CHUNKED_WKV": (1e-3, 1e-4), "CHUNKED_SSD": (1e-4, 1e-4)}
LM_F32_TOL = 1e-4      # float32 decode against forward (the CPU parity bar)


class TimedModel:
    """The model as the engine sees it, with each prefill and decode call
    bracketed by CUDA events (ms per call: the device's time between the
    events, launch gaps included) and the host clock."""

    def __init__(self, model):
        self.model = model
        self.device = model.device
        self.ms = {"prefill": [], "decode": []}
        self.host_ms = {"prefill": [], "decode": []}

    def _timed(self, kind, fn, *args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn(*args, **kw)
        end.record()
        end.synchronize()
        self.host_ms[kind].append((time.perf_counter() - t0) * 1e3)
        self.ms[kind].append(start.elapsed_time(end))
        return out

    def prefill(self, prompt, max_len):
        return self._timed("prefill", self.model.prefill, prompt,
                           max_len=max_len)

    def decode_step(self, state, tokens):
        return self._timed("decode", self.model.decode_step, state, tokens)


def _lm_serve(model, cfg, seed):
    """launch/serve.py's traffic through one ServingEngine; returns the
    engine's outputs by uid, the wall seconds and the timed model."""
    from repro_torch.launch.serve import submit_traffic
    from repro_torch.serve.engine import ServingEngine
    timed = TimedModel(model)
    eng = ServingEngine(timed, max_slots=LM_TRAFFIC["slots"],
                        max_len=LM_TRAFFIC["max_len"], eos_id=1, seed=seed)
    submit_traffic(eng, cfg, LM_TRAFFIC["requests"], LM_TRAFFIC["max_new"],
                   0.0, seed)
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(len(done) == LM_TRAFFIC["requests"],
          f"{cfg.name}: {len(done)} of {LM_TRAFFIC['requests']} requests "
          "retired")
    return {r.uid: r.out_tokens for r in done}, seconds, timed


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    return float((got - want).abs().max() / want.abs().max())


def _decode_consistency(model, seed, tol):
    """prefill + one decode_step against forward on the extended sequence
    (b 2, s 12: the reference's test); returns the relative error."""
    cfg = model.cfg
    g = torch.Generator(device=LM_DEVICE).manual_seed(seed + 1)
    seq = torch.randint(0, cfg.vocab, (2, 13), generator=g,
                        device=LM_DEVICE, dtype=torch.int32)
    with torch.inference_mode():
        want = model.forward(seq)[:, 12]
        state, _ = model.prefill(seq[:, :12], max_len=20)
        _, logits = model.decode_step(state, seq[:, 12:13])
    err = _rel(logits[:, 0], want)
    check(err < tol, f"{cfg.name} ({cfg.kv_cache_dtype} cache): prefill + "
          f"decode against forward rel err {err} >= {tol}")
    return err


def _profile_decode(model, seed):
    """One decode step of a batch-1 slot under torch.profiler: kernel and
    copy launches, and the device's busy ms (the sum of their times).
    Returns None when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    cfg = model.cfg
    g = torch.Generator(device=LM_DEVICE).manual_seed(seed + 2)
    prompt = torch.randint(2, cfg.vocab, (1, 8), generator=g,
                           device=LM_DEVICE, dtype=torch.int32)
    with torch.inference_mode():
        state, logits = model.prefill(prompt, max_len=64)
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        state, _ = model.decode_step(state, tok)          # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.decode_step(state, tok)
            torch.cuda.synchronize()
    device = [ev for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    launches = len(device)
    busy_us = sum(ev.time_range.elapsed_us() for ev in device)
    if busy_us <= 0:
        return None
    return {"device_launches": launches, "device_busy_ms": busy_us / 1e3}


def _lm_model(name, seed, card):
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import build_model
    cfg = get_config(name)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=LM_DEVICE).manual_seed(seed)
    model = build_model(cfg, device=LM_DEVICE, generator=gen)
    torch.cuda.synchronize()
    params = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    emit("lm_model", model=name, card=card, layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab, dtype=cfg.dtype,
         params=params, param_count_formula=cfg.param_count(),
         active_param_count_formula=cfg.active_param_count(),
         param_bytes=nbytes, init_s=round(time.perf_counter() - t0, 3),
         max_memory_allocated=torch.cuda.max_memory_allocated())
    return cfg, model


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _decode_bytes(model, cfg):
    """The bytes one batch-1 decode must move, and beside them every
    weight's bytes.  Neither counts the embedding table, of which a decode
    gathers one row.  The dense family reads the weights it uses (the top-k
    routed experts only, by active_param_count; every weight is the other
    number, since the capacity dispatch runs all experts).  The recurrent
    families read every weight, the hybrid's shared block once per
    application (n_groups times), and read and write their recurrent state
    once (RWKV's WKV matrices and shifted tokens, Mamba2's SSM states and
    conv tails); the attention ring's filled keys are left out."""
    from repro_torch.models.transformer import DenseLM, HybridLM
    table = 0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model
    elsize = torch.finfo(cfg.compute_dtype).bits // 8
    weights = _nbytes(model.parameters()) - table * elsize
    if isinstance(model, DenseLM):
        return (cfg.active_param_count() - table) * elsize, weights
    floor = weights
    if isinstance(model, HybridLM):
        floor += (model.n_groups - 1) * _nbytes(model.shared.parameters())
    state = model.init_decode_state(1, 1)
    recurrent = [t for key in ("states", "groups", "tail")
                 for t in (state.get(key) or ())]
    return floor + 2 * _nbytes(recurrent), weights


def _lm_traffic(model, cfg, seed, card, **extra):
    """Two engines on the same traffic: the first timed, the second held
    to the first token for token (greedy)."""
    out, seconds, timed = _lm_serve(model, cfg, seed)
    again, _, _ = _lm_serve(model, cfg, seed)
    check(again == out, f"{cfg.name}: greedy decoding differs between two "
          "engines on the same traffic")
    tokens = sum(len(t) for t in out.values())
    floor_bytes, every_bytes = _decode_bytes(model, cfg)
    dec, pre = timed.ms["decode"], timed.ms["prefill"]
    prof = _profile_decode(model, seed)
    decode_ms = float(np.mean(dec))
    emit("lm_serve", model=cfg.name, card=card, **LM_TRAFFIC,
         tokens=tokens, seconds=round(seconds, 4),
         tokens_per_s=round(tokens / seconds, 2),
         prefill_ms=round(float(np.mean(pre)), 4),
         prefill_calls=len(pre),
         decode_ms_per_token_slot=round(decode_ms, 4),
         decode_ms_median=round(float(np.median(dec)), 4),
         decode_host_ms=round(float(np.mean(timed.host_ms["decode"])), 4),
         decode_calls=len(dec),
         decode_floor_bytes=floor_bytes,
         decode_floor_ms=round(floor_bytes / HBM_BYTES_PER_S * 1e3, 4),
         all_weights_ms=round(every_bytes / HBM_BYTES_PER_S * 1e3, 4),
         decode_profile=prof,
         device_idle_share=(round(1 - prof["device_busy_ms"] / decode_ms, 4)
                            if prof else None),
         greedy_repeats=True, **extra)
    return out


def _timed_call(fn):
    """fn() bracketed by CUDA events: (its result, ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _last_logits(model, inp, kv_chunk, dtype):
    """A prefill's last-token logits walked block by block with an explicit
    ``kv_chunk`` (None: one pass), each block's weights cast to ``dtype``
    while it runs."""
    from repro_torch.models.layers import rms_norm
    from repro_torch.models.transformer import (block_attn_forward,
                                                block_ffn_forward)
    cfg = model.cfg

    def cast(block):
        return block if dtype == cfg.compute_dtype else \
            copy.deepcopy(block).to(dtype)

    x = model.embed_in(inp).to(dtype)
    pos = torch.arange(inp.shape[1], device=LM_DEVICE)
    blocks = [(b, False) for b in model.first_layers]
    blocks += [(b, model.use_moe) for b in model.layers]
    for block, use_moe in blocks:
        lp = cast(block)
        x, _ = block_attn_forward(cfg, lp, x, pos, kv_chunk,
                                  cfg.sliding_window)
        x, _ = block_ffn_forward(cfg, lp, x, use_moe=use_moe)
        del lp
    x = rms_norm(x[:, -1:], model.final_norm, offset=cfg.norm_offset)
    tied = cfg.input_mode == "tokens" and cfg.tie_embeddings
    return x @ (model.embed.T if tied else model.head).to(dtype)


def _lm_long_prefill(model, seed):
    """A 4,096-token prefill, which takes the chunked online-softmax branch
    (kv_chunk 2048), against the same prefill in one pass (kv_chunk None):
    in float32 (the same weights, widened a block at a time) within
    LM_CHUNK_TOL of the largest logit; in bf16, the chunked prefill no
    farther from the float32 one pass than the bf16 one pass is (1.25x)."""
    cfg = model.cfg
    g = torch.Generator(device=LM_DEVICE).manual_seed(seed + 3)
    inp = torch.randint(0, cfg.vocab, (1, LM_LONG), generator=g,
                        device=LM_DEVICE, dtype=torch.int32)
    with torch.inference_mode():
        (state, chunked), ms = _timed_call(
            lambda: model.prefill(inp, max_len=LM_LONG))
        del state
        one_pass = _last_logits(model, inp, None, cfg.compute_dtype)
    with torch.no_grad():
        chunked32 = _last_logits(model, inp, 2048, torch.float32)
        one_pass32 = _last_logits(model, inp, None, torch.float32)
    err32 = _rel(chunked32, one_pass32)
    check(err32 < LM_CHUNK_TOL, f"{cfg.name}: chunked {LM_LONG}-token "
          f"prefill against one pass in float32: {err32} >= {LM_CHUNK_TOL}")
    err_chunked, err_one = _rel(chunked, one_pass32), _rel(one_pass,
                                                           one_pass32)
    check(err_chunked <= 1.25 * err_one,
          f"{cfg.name}: bf16 chunked prefill {err_chunked} from float32, "
          f"bf16 one pass {err_one}")
    return {"tokens": LM_LONG, "ms": round(ms, 4),
            "float32_rel_err": err32,
            "bf16_chunked_vs_one_pass": _rel(chunked, one_pass),
            "bf16_chunked_vs_float32": err_chunked,
            "bf16_one_pass_vs_float32": err_one}


@contextlib.contextmanager
def _module_flag(module, flag: str, value: bool):
    """Set a module-level switch for the duration (as the reference's test
    flips CHUNKED_SSD / CHUNKED_WKV)."""
    old = getattr(module, flag)
    setattr(module, flag, value)
    try:
        yield
    finally:
        setattr(module, flag, old)


def _scan_checks(model, seed):
    """The chunked form against the recurrent form at full width on
    LM_SCAN_T tokens: layer 0's time_mix (RWKV6) or first mamba2_forward
    (hybrid) in float32 on that layer's real input, the module flag flipped
    around the call, output and final state held to tests/test_mamba2.py's
    bars (gated); beside it the whole model's bf16 logits both ways
    (reported)."""
    from repro_torch.models import mamba2 as M2
    from repro_torch.models import rwkv6 as R6
    from repro_torch.models.layers import layer_norm, rms_norm
    from repro_torch.models.transformer import RWKVLM
    cfg = model.cfg
    g = torch.Generator(device=LM_DEVICE).manual_seed(seed + 4)
    inp = torch.randint(0, cfg.vocab, (1, LM_SCAN_T), generator=g,
                        device=LM_DEVICE, dtype=torch.int32)
    f32 = torch.float32
    with torch.inference_mode():
        x = model.embed_in(inp)
        if isinstance(model, RWKVLM):
            module, flag = R6, "CHUNKED_WKV"
            lp = copy.deepcopy(model.layers[0]).to(f32)
            h = layer_norm(layer_norm(x, model.ln0, model.ln0_b).to(f32),
                           lp.ln1, lp.ln1_b)
            st = R6.init_state(1, cfg.d_model, cfg.n_heads, f32, LM_DEVICE)

            def layer():
                y, _, S = R6.time_mix(lp.tm, h, st.tm_x, st.S, cfg.n_heads)
                return y, S
        else:
            module, flag = M2, "CHUNKED_SSD"
            lp = copy.deepcopy(model.mamba_groups[0][0]).to(f32)
            h = rms_norm(x.to(f32), lp.ln, offset=cfg.norm_offset)
            st = M2.init_state(1, model.d_inner, cfg.ssm.d_state,
                               cfg.ssm.head_dim, f32, LM_DEVICE)

            def layer():
                y, new = M2.mamba2_forward(
                    lp.m, h, st, d_inner=model.d_inner,
                    d_state=cfg.ssm.d_state, head_dim=cfg.ssm.head_dim)
                return y, new.h
        out, ms = {}, {}
        for chunked in (False, True):
            with _module_flag(module, flag, chunked):
                out[chunked], ms[chunked] = _timed_call(layer)
                out[chunked, "model"], ms[chunked, "model"] = _timed_call(
                    lambda: model.forward(inp))
    rtol, atol = LM_SCAN_TOL[flag]
    worst = {}
    for i, name in enumerate(("y", "state")):
        got, want = out[True][i], out[False][i]
        check(bool(torch.isfinite(got).all()), f"{cfg.name}: non-finite "
              f"chunked {name}")
        worst[name] = float(((got - want).abs()
                             / (atol + rtol * want.abs())).max())
        check(worst[name] <= 1.0, f"{cfg.name}: {flag} {name} at "
              f"{LM_SCAN_T} tokens in float32 exceeds rtol {rtol} / atol "
              f"{atol} of the recurrent form ({worst[name]}x the bound)")
    del lp, out[False], out[True]
    return {"flag": flag, "tokens": LM_SCAN_T, "rtol": rtol, "atol": atol,
            "layer_y_worst_over_bound": worst["y"],
            "layer_state_worst_over_bound": worst["state"],
            "layer_recurrent_ms": round(ms[False], 4),
            "layer_chunked_ms": round(ms[True], 4),
            "model_bf16_rel_err": _rel(out[True, "model"],
                                       out[False, "model"]),
            "model_recurrent_ms": round(ms[False, "model"], 4),
            "model_chunked_ms": round(ms[True, "model"], 4)}


def phase_lm_recurrent(seed: int, card):
    """The recurrent families at full width, each freed before the next:
    rwkv6-1.6b (RWKV6) and zamba2-7b (81 Mamba2 layers, the shared block
    every 6), the traffic through two engines, prefill + decode against
    forward (in bf16, then with the weights widened to float32: bf16's
    roundings grow through these random-weight stacks, ROADMAP C34), the
    chunked scans against the recurrent ones."""
    for name in LM_RECURRENT:
        cfg, model = _lm_model(name, seed, card)
        _lm_traffic(model, cfg, seed, card)
        err = _decode_consistency(model, seed, LM_DECODE_TOL)
        scans = _scan_checks(model, seed)
        memory = torch.cuda.max_memory_allocated()
        model.to(torch.float32)
        model.cfg = dataclasses.replace(cfg, dtype="float32")
        err32 = _decode_consistency(model, seed, LM_F32_TOL)
        emit("lm_checks", model=cfg.name, card=card, decode_rel_err=err,
             decode_tol=LM_DECODE_TOL, decode_rel_err_float32=err32,
             decode_float32_tol=LM_F32_TOL,
             chunked_against_recurrent=scans, max_memory_allocated=memory)
        del model
        gc.collect()
        torch.cuda.empty_cache()


def phase_lm(seed: int, card):
    """The LM serving path at full width: qwen3-8b (GQA, dense), then
    deepseek-v2-lite-16b (MLA, 64 experts top-6, first layer dense), then
    the recurrent families (``phase_lm_recurrent``), each initialized in
    bf16 on the card from a seeded generator and freed before the next."""
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()

    cfg, model = _lm_model(LM_DENSE, seed, card)
    _lm_traffic(model, cfg, seed, card)
    err = _decode_consistency(model, seed, LM_DECODE_TOL)
    long = _lm_long_prefill(model, seed)
    model.cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    try:
        err8 = _decode_consistency(model, seed, LM_INT8_TOL)
    finally:
        model.cfg = cfg
    emit("lm_checks", model=cfg.name, card=card, decode_rel_err=err,
         decode_tol=LM_DECODE_TOL, long_prefill=long,
         int8_decode_rel_err=err8, int8_tol=LM_INT8_TOL,
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del model
    gc.collect()
    torch.cuda.empty_cache()

    cfg, model = _lm_model(LM_MOE, seed, card)
    prompts = np.random.default_rng(seed)
    dropped = []
    with torch.inference_mode():
        for _ in range(LM_TRAFFIC["requests"]):   # the traffic's prompts
            plen = int(prompts.integers(4, 12))
            p = torch.as_tensor(prompts.integers(2, cfg.vocab, plen),
                                dtype=torch.int32, device=LM_DEVICE)[None]
            _, aux = model.forward(p, return_aux=True, logits_mode="last")
            dropped.append(round(float(aux["dropped_fraction"]), 4))
    _lm_traffic(model, cfg, seed, card,
                capacity_factor=cfg.moe.capacity_factor,
                prefill_dropped_fraction=dropped)
    m = cfg.moe
    no_drop = m.num_experts / m.top_k
    model.cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(m, capacity_factor=no_drop))
    try:
        err = _decode_consistency(model, seed, LM_DECODE_TOL)
    finally:
        model.cfg = cfg
    emit("lm_checks", model=cfg.name, card=card, decode_rel_err=err,
         decode_tol=LM_DECODE_TOL,
         decode_capacity_factor=f"E/k = {no_drop} (no drops, as the reduced "
         "configs set it)",
         max_memory_allocated=torch.cuda.max_memory_allocated())
    del model
    gc.collect()
    torch.cuda.empty_cache()
    phase_lm_recurrent(seed, card)
    emit("lm_phase", seconds=round(time.perf_counter() - t_phase, 3))


# single-device training at full width: launch/train.py's example config
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_BATCH, TRAIN_SEQ = 8, 512            # 4,096 tokens a step
TRAIN_STEPS = 6                            # the loss must fall over them
TRAIN_OPT = {"lr_peak": 3e-4, "warmup_steps": 1, "total_steps": 100}
# tests/test_train_infra.py::test_remat_grad_equivalence
TRAIN_REMAT_RTOL, TRAIN_REMAT_ATOL = 1e-3, 1e-5
TRAIN_CPU_TOL = 1e-4   # the reduced step in float32, card against the CPU
# a microbatched step's mean loss against the whole batch's, both in bf16
TRAIN_MB_LOSS_TOL = 1e-2
BF16_FLOPS_PER_S = 989.4e12    # H100 SXM5 data sheet, dense bf16


class TimedStep:
    """A train step with each call bracketed by CUDA events (ms per step:
    the device's time between the events, launch gaps included)."""

    def __init__(self, step):
        self.step = step
        self.ms = []

    def __call__(self, state, batch):
        (new, metrics), ms = _timed_call(lambda: self.step(state, batch))
        self.ms.append(ms)
        return new, metrics


def _equal_states(a, b):
    """Leaf paths where two train states differ (bit for bit)."""
    from repro_torch import tree
    return ["/".join(p) for (p, x), y in zip(tree.flatten_with_paths(a),
                                             tree.leaves(b))
            if not torch.equal(x, y)]


def _profile_step(step_fn, state, batch, top=12):
    """One train step under torch.profiler: kernel and copy launches, the
    device's busy ms (the sum of their times) and the ``top`` kernels by
    device time (launches and ms summed by name); None when the profiler
    sees no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = step_fn(state, batch)
        torch.cuda.synchronize()
    device = [ev for ev in prof.events()
              if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(ev.time_range.elapsed_us() for ev in device)
    del out
    if busy_us <= 0:
        return None
    by_name = {}
    for ev in device:
        n, us = by_name.get(ev.name, (0, 0.0))
        by_name[ev.name] = (n + 1, us + ev.time_range.elapsed_us())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {"device_launches": len(device), "device_busy_ms": busy_us / 1e3,
            "top_kernels": [{"name": name[:80], "launches": n,
                             "ms": round(us / 1e3, 3)}
                            for name, (n, us) in ranked]}


def _train_breakdown(model, opt_cfg, state, pipe, step):
    """The step's parts, each timed alone by CUDA events after a warm-up
    call: the batch (host clock: the CPU stream and the copy to the card),
    the loss alone (no grad), the loss and its gradient (full remat) and
    the AdamW update."""
    from repro_torch import convert
    from repro_torch.models.transformer import call_with
    from repro_torch.optim import adamw
    from repro_torch.train import step as train_step
    t0 = time.perf_counter()
    batch = pipe.batch_at(step)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) * 1e3
    weights = convert.lm_state_dict_from_tree(state.params)

    def forward():
        with torch.no_grad():
            return call_with(model, weights, model.loss, batch)

    def forward_backward():
        return train_step.value_and_grad(model, state.params, batch)

    out = {"batch_host_ms": round(batch_ms, 4)}
    for name, fn in (("forward_ms", forward),
                     ("value_and_grad_ms", forward_backward)):
        fn()
        out[name] = round(_timed_call(fn)[1], 4)
    grads = forward_backward()[2]

    def update():
        return adamw.update(opt_cfg, state.opt, state.params, grads)

    update()
    out["update_ms"] = round(_timed_call(update)[1], 4)
    return out


def _train_remat_and_microbatches(model, opt_cfg, state, batch, card):
    """One step each with remat none, full and dots from the same state
    (params held to the reference test's bar), and one with two
    microbatches accumulated in bf16 with error feedback."""
    from repro_torch import tree
    from repro_torch.train.step import make_train_step
    out = {}
    for remat in ("none", "full", "dots"):
        torch.cuda.reset_peak_memory_stats()
        (new, metrics), ms = _timed_call(lambda: make_train_step(
            model, opt_cfg, remat=remat)(state, batch))
        out[remat] = {"params": new.params, "loss": float(metrics["loss"]),
                      "ms": round(ms, 4),
                      "max_memory_allocated":
                          torch.cuda.max_memory_allocated()}
        del new
    worst = {}
    for remat in ("full", "dots"):
        worst[remat] = 0.0
        for a, b in zip(tree.leaves(out["none"]["params"]),
                        tree.leaves(out[remat]["params"])):
            a, b = a.float(), b.float()
            over = float(((a - b).abs() / (TRAIN_REMAT_ATOL
                                            + TRAIN_REMAT_RTOL * a.abs()))
                         .max())
            worst[remat] = max(worst[remat], over)
        check(worst[remat] <= 1.0, f"{TRAIN_ARCH}: remat {remat} params "
              f"{worst[remat]}x the bound (rtol {TRAIN_REMAT_RTOL}, atol "
              f"{TRAIN_REMAT_ATOL}) from remat none")
    (new, metrics), ms = _timed_call(lambda: make_train_step(
        model, opt_cfg, microbatches=2, remat="full",
        accum_dtype="bfloat16")(state, batch))
    mb_loss = float(metrics["loss"])
    check(all(bool(torch.isfinite(p.float()).all())
              for p in tree.leaves(new.params)),
          f"{TRAIN_ARCH}: non-finite params after a microbatched step")
    mb_err = abs(mb_loss - out["none"]["loss"]) / out["none"]["loss"]
    check(mb_err < TRAIN_MB_LOSS_TOL, f"{TRAIN_ARCH}: two microbatches' "
          f"mean loss {mb_loss} against the whole batch's "
          f"{out['none']['loss']}")
    del new
    emit("train_remat", model=TRAIN_ARCH, card=card,
         **{r: {k: v for k, v in o.items() if k != "params"}
            for r, o in out.items()},
         worst_over_bound=worst, rtol=TRAIN_REMAT_RTOL, atol=TRAIN_REMAT_ATOL,
         microbatches_2_bf16={"ms": round(ms, 4), "loss": mb_loss,
                              "loss_rel_err": mb_err,
                              "tol": TRAIN_MB_LOSS_TOL})


def _train_resume(model, opt_cfg, state0, pipe, card):
    """4 straight Trainer steps against 2, a Trainer checkpoint to a temp
    dir, a fresh Trainer that restores it, and 2 more: params and moments
    bit for bit equal.  The checkpoint is the phase's only disk write."""
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    step_fn = make_train_step(model, opt_cfg, remat="full")
    straight = Trainer(TrainerConfig(total_steps=4), step_fn, pipe,
                       state0).run(start_step=0)
    seconds = {}

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            seconds[name] = round(time.perf_counter() - t0, 3)
            return out
        return call

    d = tempfile.mkdtemp(prefix="train_ckpt_")
    try:
        first = Trainer(TrainerConfig(total_steps=2, ckpt_dir=d,
                                      ckpt_every=10_000), step_fn, pipe,
                        state0)
        first._save = timed("save_s", first._save)
        first.run(start_step=0)
        del first
        path = os.path.join(d, "step_000000002")
        ckpt_bytes = sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path))
        template = state0
        second = Trainer(TrainerConfig(total_steps=4, ckpt_dir=d), step_fn,
                         pipe, template)
        start = timed("restore_s", second.try_restore)()
        check(start == 2, f"{TRAIN_ARCH}: restored step {start}, not 2")
        second.cfg.ckpt_dir = None        # no second multi-GB write
        resumed = second.run(start_step=start)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    differ = _equal_states(straight, resumed)
    check(not differ, f"{TRAIN_ARCH}: the resumed run differs from the "
          f"straight one at {differ[:5]}")
    emit("train_resume", model=TRAIN_ARCH, card=card, steps="4 straight; "
         "2 + checkpoint + restore + 2", bit_equal=True,
         checkpoint_bytes=ckpt_bytes, **seconds)
    return ckpt_bytes, seconds


def _train_reduced_card_vs_cpu(seed, card):
    """The reduced config's step in float32 on the card against the same
    step on the CPU: loss, grad norm and both moments within
    TRAIN_CPU_TOL of the largest value of each leaf; params within
    TRAIN_CPU_TOL of it plus a tenth of the learning rate (Adam's first
    step turns a float32 rounding of a gradient element near eps into a
    move of up to the learning rate; tests/test_torch_train_step.py)."""
    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import pipeline_for_model
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = dataclasses.replace(get_config(TRAIN_ARCH, reduced=True),
                              dtype="float32")
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    out = {}
    for dev in ("cpu", LM_DEVICE):
        model = build_model(cfg, device=dev, generator=torch.Generator(
            device="cpu").manual_seed(seed)) if dev == "cpu" else \
            build_model(cfg, device=dev)
        if dev != "cpu":
            model.load_state_dict(out["cpu"][0].state_dict())
        pipe = pipeline_for_model(cfg, 4, 64, seed=seed, device=dev)
        state = init_train_state(model, opt_cfg)
        new, metrics = make_train_step(model, opt_cfg, microbatches=2,
                                       remat="dots")(state, pipe.batch_at(0))
        out[dev] = (model, new, metrics)
    (_, want, wm), (_, got, gm) = out["cpu"], out[LM_DEVICE]
    errs = {k: abs(float(gm[k]) - float(wm[k])) / abs(float(wm[k]))
            for k in ("loss", "grad_norm")}
    for name in ("m", "v"):
        errs[name] = max(_rel(g.cpu(), w) for g, w in zip(
            tree.leaves(getattr(got.opt, name)),
            tree.leaves(getattr(want.opt, name))))
    for k, e in errs.items():
        check(e < TRAIN_CPU_TOL, f"reduced {TRAIN_ARCH} step, card against "
              f"CPU: {k} rel err {e} >= {TRAIN_CPU_TOL}")
    lr = wm["lr"]
    worst = 0.0
    for g, w in zip(tree.leaves(got.params), tree.leaves(want.params)):
        bound = TRAIN_CPU_TOL * float(w.abs().max()) + 0.1 * lr
        worst = max(worst, float((g.cpu() - w).abs().max()) / bound)
    check(worst <= 1.0, f"reduced {TRAIN_ARCH} step, card against CPU: "
          f"params {worst}x the bound")
    return {"rel_err": errs, "params_worst_over_bound": worst,
            "tol": TRAIN_CPU_TOL, "dtype": "float32",
            "microbatches": 2, "remat": "dots"}


def phase_train(seed: int, card):
    """Single-device training at full width: qwen1.5-0.5b uncut (24 layers,
    d 1024, vocab 151,936, tied embeddings), random bf16 weights from the
    seed, the port's pipeline at B 8 x S 512, AdamW in float32.  A few
    Trainer steps with full remat (the loss must fall), one step profiled,
    remat none / full / dots from one state, two bf16-accumulated
    microbatches, resume through a checkpoint bit for bit, and the reduced
    config's step on the card against the CPU's."""
    from repro_torch import tree
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import pipeline_for_model
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.train.trainer import Trainer, TrainerConfig
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=LM_DEVICE).manual_seed(seed)
    model = build_model(cfg, device=LM_DEVICE, generator=gen)
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    state0 = init_train_state(model, opt_cfg)
    pipe = pipeline_for_model(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed,
                              device=LM_DEVICE)
    n_params = sum(p.numel() for p in tree.leaves(state0.params))
    param_bytes = _nbytes(tree.leaves(state0.params))
    moment_bytes = _nbytes(tree.leaves(state0.opt))
    # what the dry-run's one-device train cell must predict: the weights,
    # and AdamW's m and v without the step count
    sizes = {"param_bytes": param_bytes,
             "moment_bytes": _nbytes(tree.leaves(state0.opt.m))
             + _nbytes(tree.leaves(state0.opt.v))}

    timed = TimedStep(make_train_step(model, opt_cfg, remat="full"))
    trainer = Trainer(TrainerConfig(total_steps=TRAIN_STEPS, log_every=1),
                      timed, pipe, state0)
    t0 = time.perf_counter()
    state = trainer.run(start_step=0)
    run_s = time.perf_counter() - t0
    memory = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in trainer.history if "loss" in h]
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"{TRAIN_ARCH}: losses {losses}")
    check(losses[-1] < losses[0], f"{TRAIN_ARCH}: the loss did not fall "
          f"over {TRAIN_STEPS} steps: {losses}")
    # the same step twice from one state: what resume's bit-equality needs
    batch = pipe.batch_at(TRAIN_STEPS)
    again = [timed.step(state, batch)[0] for _ in range(2)]
    differ = _equal_states(*again)
    del again
    check(not differ, f"{TRAIN_ARCH}: one step from one state differs "
          f"between two runs at {differ[:5]}")
    prof = _profile_step(timed.step, state, batch)
    parts = _train_breakdown(model, opt_cfg, state, pipe, TRAIN_STEPS + 1)

    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = timed.ms[1:]
    step_ms = float(np.median(steady))
    flops = 6 * cfg.active_param_count() * tokens
    floor_ms = flops / BF16_FLOPS_PER_S * 1e3
    emit("train", model=TRAIN_ARCH, card=card, layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab, dtype=cfg.dtype,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, tokens_per_step=tokens,
         remat="full", params=n_params,
         active_param_count_formula=cfg.active_param_count(),
         param_bytes=param_bytes, moment_bytes=moment_bytes,
         steps=TRAIN_STEPS, loss=losses,
         step_ms=[round(m, 4) for m in timed.ms],
         step_ms_median_after_first=round(step_ms, 4),
         first_step_s=round(timed.ms[0] / 1e3, 3), step_parts=parts,
         tokens_per_s=round(tokens / step_ms * 1e3, 1),
         trainer_run_s=round(run_s, 3),
         host_step_s=[round(h["dt"], 4) for h in trainer.history
                      if "dt" in h],
         flop_floor_ms=round(floor_ms, 4), flops_per_step=flops,
         bf16_peak_flops=BF16_FLOPS_PER_S,
         floor_share=round(floor_ms / step_ms, 4),
         step_profile=prof,
         device_idle_share=(round(1 - prof["device_busy_ms"] / step_ms, 4)
                            if prof else None),
         step_repeats_bit_for_bit=True,
         max_memory_allocated=memory)
    _train_remat_and_microbatches(model, opt_cfg, state, batch, card)
    del state, trainer
    gc.collect()
    torch.cuda.empty_cache()
    _train_resume(model, opt_cfg, state0, pipe, card)
    del model, state0
    gc.collect()
    torch.cuda.empty_cache()
    reduced = _train_reduced_card_vs_cpu(seed, card)
    emit("train_phase", reduced_card_vs_cpu=reduced,
         seconds=round(time.perf_counter() - t_phase, 3))
    return sizes


# ---------------------------------------------------------------------------
# The dist phase: the GPipe pipeline and the compressed all-reduce over a
# ShardMesh, the meta-device dry-run and the flop count of a train step
# ---------------------------------------------------------------------------

DIST_ARCH = TRAIN_ARCH
DIST_STAGES, DIST_MICROBATCHES = 4, 8
DIST_MB_SEQ = 512                 # tokens of one microbatch (batch 1)
DIST_PSUM_P = 4
DIST_MODES = ("float32", "bfloat16", "int8")


def _decoder_layer_fn(model):
    """``pipeline_apply``'s layer_fn over the stacked ``layers`` tree: one
    decoder block of ``model`` (attention + MLP, its norms) run through
    ``transformer.call_with`` on the layer's slice of the stacked tree."""
    from repro_torch import tree
    from repro_torch.models.transformer import (block_attn_forward,
                                                block_ffn_forward, call_with)
    cfg, lp0 = model.cfg, model.layers[0]

    def block(x):
        pos = torch.arange(x.shape[1], device=x.device)
        x, _ = block_attn_forward(cfg, lp0, x, pos, None,
                                  cfg.sliding_window)
        return block_ffn_forward(cfg, lp0, x, use_moe=False)[0]

    def layer_fn(p, x):
        w = {"layers.0." + ".".join(path): leaf
             for path, leaf in tree.flatten_with_paths(p)}
        return call_with(model, w, block, x)

    return layer_fn


@contextlib.contextmanager
def _nccl_world_of_one():
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _dist_pipeline(model, seed, card):
    """qwen1.5-0.5b's decoder blocks at full width as ``layer_fn``: S = 4
    emulated stages over M = 8 microbatches of 1 x 512 tokens, against the
    same blocks applied in sequence (bit for bit), timed both ways; then a
    1-rank NCCL process group (one stage) against the emulated run."""
    from repro_torch import convert, tree
    from repro_torch.core.distributed import ShardMesh
    from repro_torch.obs import collectives
    from repro_torch.train.pipeline import bubble_fraction, pipeline_apply
    stacked = convert.lm_params_tree(model.state_dict())["layers"]
    layer_fn = _decoder_layer_fn(model)
    cfg = model.cfg
    gen = torch.Generator(device=LM_DEVICE).manual_seed(seed + 27)
    xs = torch.randn((DIST_MICROBATCHES, 1, DIST_MB_SEQ, cfg.d_model),
                     generator=gen, device=LM_DEVICE).to(cfg.compute_dtype)
    n_layers = tree.leaves(stacked)[0].shape[0]

    def sequential():
        out = torch.empty_like(xs)
        for mb in range(DIST_MICROBATCHES):
            x = xs[mb]
            for i in range(n_layers):
                x = layer_fn(tree.map(lambda a: a[i], stacked), x)
            out[mb] = x
        return out

    mesh = ShardMesh(DIST_STAGES, LM_DEVICE)
    with torch.no_grad():
        with collectives.recording() as log:
            got = pipeline_apply(layer_fn, stacked, xs, mesh)
        want = sequential()
        err = float((got.float() - want.float()).abs().max())
        check(bool(torch.isfinite(got.float()).all()),
              "dist_pipeline: non-finite output")
        check(torch.equal(got, want), f"dist_pipeline: S={DIST_STAGES} "
              f"emulated differs from the sequential blocks ({err})")
        pipe_ms = time_ms(lambda: pipeline_apply(layer_fn, stacked, xs,
                                                 mesh))
        seq_ms = time_ms(sequential)
        with _nccl_world_of_one():
            pg = pipeline_apply(layer_fn, stacked, xs,
                                ShardMesh(1, LM_DEVICE,
                                          backend="process_group"))
        check(torch.equal(pg, got), "dist_pipeline: the 1-rank NCCL "
              "pipeline differs from the emulated one")
    from repro_torch.roofline.op_cost import collective_stats
    emit("dist_pipeline", model=DIST_ARCH, card=card, layers=n_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, stages=DIST_STAGES,
         microbatches=DIST_MICROBATCHES, microbatch_shape=list(xs.shape[1:]),
         max_abs_err=err, bit_equal=True, pipeline_ms=pipe_ms,
         sequential_ms=seq_ms,
         bubble_fraction=bubble_fraction(DIST_STAGES, DIST_MICROBATCHES),
         collectives={k: v for k, v in collective_stats(log).items()
                      if v["count"]},
         nccl_1_rank_equal=True)


def _dist_psum(model, seed, card):
    """``compressed_psum`` at p = 4 emulated over trees the size of the
    model's gradients (float32), each mode timed, its wire bytes and its
    error against the float32 sum; then each mode on a 1-rank NCCL group
    against the emulated p = 1 result."""
    from repro_torch import convert, tree
    from repro_torch.core.distributed import ShardMesh
    from repro_torch.obs import collectives
    from repro_torch.optim.compress import compressed_psum, wire_bytes
    from repro_torch.roofline.op_cost import collective_stats
    shapes = tree.map(lambda a: a.shape,
                      convert.lm_params_tree(model.state_dict()))
    gen = torch.Generator(device=LM_DEVICE).manual_seed(seed + 28)
    trees = [tree.map(lambda s: torch.randn(s, generator=gen,
                                            device=LM_DEVICE), shapes)
             for _ in range(DIST_PSUM_P)]
    entries = sum(t.numel() for t in tree.leaves(trees[0]))
    mesh = ShardMesh(DIST_PSUM_P, LM_DEVICE)
    out = {}
    exact = None
    for mode in DIST_MODES:
        with collectives.recording() as log:
            summed = compressed_psum(trees, mesh, mode)[0]
        stats = collective_stats(log)["all-reduce"]
        check(stats["bytes"] == wire_bytes(trees[0], mode),
              f"dist_psum {mode}: recorded {stats['bytes']} wire bytes")
        if mode == "float32":
            exact = summed
        err = max(float((a - b).abs().max()) for a, b in zip(
            tree.leaves(summed), tree.leaves(exact)))
        finite = all(bool(torch.isfinite(a).all())
                     for a in tree.leaves(summed))
        check(finite, f"dist_psum {mode}: non-finite sum")
        del summed
        ms = time_ms(lambda: compressed_psum(trees, mesh, mode))
        out[mode] = {"ms": ms, "wire_bytes_per_shard": stats["bytes"],
                     "max_abs_err_vs_float32": err}
    # bf16: each shard's cast and the sum's rounding, half an ulp each;
    # int8: each shard's rounding, half a quantization step
    amax = max(float(a.abs().max()) for t in trees for a in tree.leaves(t))
    scale = max(float(a.abs().max()) for a in tree.leaves(exact))
    bounds = {"bfloat16": 2 ** -8 * (DIST_PSUM_P * amax + scale),
              "int8": DIST_PSUM_P * amax / 254 * (1 + 2 ** -20)}
    for mode, bound in bounds.items():
        out[mode]["bound"] = bound
        check(out[mode]["max_abs_err_vs_float32"] <= bound,
              f"dist_psum {mode}: {out[mode]} beyond {bound}")
    del exact
    one = ShardMesh(1, LM_DEVICE)
    with _nccl_world_of_one():
        pg = ShardMesh(1, LM_DEVICE, backend="process_group")
        for mode in DIST_MODES:
            a = compressed_psum(trees[0], pg, mode)
            b = compressed_psum([trees[0]], one, mode)[0]
            check(all(torch.equal(x, y) for x, y in zip(
                tree.leaves(a), tree.leaves(b))),
                f"dist_psum {mode}: the 1-rank NCCL all-reduce differs "
                "from the emulated p = 1 sum")
            del a, b
    emit("dist_psum", model=DIST_ARCH, card=card, shards=DIST_PSUM_P,
         entries_per_shard=entries, modes=out, nccl_1_rank_equal=True)
    del trees


def _dist_dryrun(card, train_sizes):
    """Every (arch x shape x mesh) cell on meta, and the 1 x 1 mesh's
    qwen1.5-0.5b train cell against the weights and moments phase_train
    measured on the card."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.roofline import cost_model
    from repro_torch.configs.base import registry
    from repro_torch.configs.shapes import SHAPES
    bw = cost_model.calibrate(LM_DEVICE).hbm_bw
    t0 = time.perf_counter()
    records = dryrun.run(sorted(registry()), list(SHAPES),
                         list(dryrun.MESHES), bw, trace=False)
    seconds = time.perf_counter() - t0
    status = {k: sum(r["status"] == k for r in records)
              for k in ("ok", "skipped", "failed")}
    check(len(records) == 80 and status["failed"] == 0,
          f"dist_dryrun: {len(records)} cells, {status}")
    largest = max((r for r in records if r["status"] == "ok"),
                  key=lambda r: r["memory"]["argument_size_in_bytes"])
    one = dryrun.lower_cell(DIST_ARCH, "train_4k",
                            MeshShape(("data", "model"), (1, 1)), "1x1",
                            hbm_bw=bw, trace=False)["per_device_bytes"]
    check(one["params"] == train_sizes["param_bytes"]
          and one["moments"] == train_sizes["moment_bytes"],
          f"dist_dryrun: 1x1 {DIST_ARCH} train cell predicts {one}, "
          f"phase_train measured {train_sizes}")
    emit("dist_dryrun", card=card, cells=len(records), **status,
         seconds=round(seconds, 3), hbm_bw=bw,
         largest={"cell": f"{largest['arch']} x {largest['shape']} x "
                          f"{largest['mesh']}",
                  "gb_per_device":
                      largest["memory"]["argument_size_in_bytes"] / 1e9},
         one_device_train_cell={"model": DIST_ARCH, **one},
         phase_train_measured=train_sizes)


def _dist_flops(model, seed, card):
    """``op_cost.analyze_fn`` of one train step (B 8 x S 512) with remat
    none and full, against ``model_flops``' 6·N·T."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.data.pipeline import pipeline_for_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline.analysis import model_flops
    from repro_torch.roofline.op_cost import analyze_fn
    from repro_torch.train.step import init_train_state, make_train_step
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    state = init_train_state(model, opt_cfg)
    batch = pipeline_for_model(model.cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed,
                               device=LM_DEVICE).batch_at(0)
    want = model_flops(model.cfg, InputShape("train", "train", TRAIN_SEQ,
                                             TRAIN_BATCH))
    out = {}
    for remat in ("none", "full"):
        step = make_train_step(model, opt_cfg, remat=remat)
        costs = analyze_fn(step, state, batch)
        out[remat] = {"flops": costs.flops, "ratio": costs.flops / want,
                      "io_bytes": costs.bytes,
                      "top_ops": dict(sorted(costs.flops_by_op.items(),
                                             key=lambda kv: -kv[1])[:4])}
    check(0.9 < out["none"]["ratio"] < 1.5,
          f"dist_flops: remat none counts {out['none']['ratio']} x 6NT")
    check(out["full"]["flops"] > out["none"]["flops"],
          "dist_flops: full remat counts no recompute")
    model.remat = "none"
    emit("dist_flops", model=DIST_ARCH, card=card, batch=TRAIN_BATCH,
         seq=TRAIN_SEQ, model_flops_6NT=want, **out)


# traced temporaries against the card's, relative: sound traces sat within
# 6.2e-5 of an H100's readings (its allocator's 512-byte rounding); 1e-3
# of the smallest peak held here (5.17 GB, the prefill) is 5.2 MB, under
# any one term a trace could miss (the module's 0.928 GB of weights, or
# one 4,096-token hidden state of qwen3-8b, 33.6 MB)
DIST_TRACE_TOL = 1e-3
DIST_TRACE_PREFILL = ("qwen3-8b", 4096)     # one batch-1 prefill
# one 16 x 16 cell under each lever of the dry-run
DIST_TRACE_LEVERS = (
    ("remat_none", {"remat": "none"}, "qwen3-8b", "train_4k"),
    ("remat_dots", {"remat": "dots"}, "qwen3-8b", "train_4k"),
    ("microbatches_1", {"microbatches": 1}, "qwen3-8b", "train_4k"),
    ("bf16_moments", {"bf16_moments": True}, "qwen3-8b", "train_4k"),
    ("kv_quant", {"kv_quant": True}, "qwen3-8b", "decode_32k"),
    ("serve_tp_only", {"serve_tp_only": True}, "qwen3-8b", "prefill_32k"),
    ("ssd_chunked", {"ssd_chunked": True}, "zamba2-7b", "prefill_32k"),
    ("moe_hierarchical", {"moe_constrained": "hierarchical"},
     "deepseek-v2-lite-16b", "prefill_32k"))


def _measured_call(fn):
    """fn() on the card under FlopCounterMode: its result, the bytes
    allocated above what was allocated just before it (the peak, so the
    temporaries and the outputs) and its counted flops."""
    from torch.utils.flop_counter import FlopCounterMode
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    counter = FlopCounterMode(display=False)
    with counter:
        out = fn()
    torch.cuda.synchronize()
    return (out, torch.cuda.max_memory_allocated() - before,
            float(counter.get_total_flops()))


def _trace_pair(name, traced, measured_bytes, counted_flops):
    """One traced-against-card pair: held to DIST_TRACE_TOL (temporaries)
    and equality (flops)."""
    rel = (traced.peak_temp_bytes - measured_bytes) / measured_bytes
    pair = {"traced_temp_bytes": int(traced.peak_temp_bytes),
            "measured_temp_bytes": int(measured_bytes),
            "rel_diff": round(rel, 5), "traced_flops": traced.flops,
            "counted_flops": counted_flops,
            "traced_output_bytes": int(traced.output_bytes),
            "traced_bytes_accessed": traced.bytes_accessed,
            "traces": traced.traces, "trace_s": round(traced.seconds, 3)}
    print(f"[dist_trace] {name}: temporaries traced "
          f"{pair['traced_temp_bytes']} against the card's "
          f"{pair['measured_temp_bytes']} ({rel:+.4f}); flops traced "
          f"{traced.flops:.0f} against counted {counted_flops:.0f}",
          flush=True)
    check(abs(rel) <= DIST_TRACE_TOL,
          f"dist_trace {name}: traced temporaries {pair} off by more than "
          f"{DIST_TRACE_TOL}")
    check(traced.flops == counted_flops,
          f"dist_trace {name}: traced flops {traced.flops} against "
          f"{counted_flops} counted on the card")
    return pair


def _dist_trace(model, seed, card):
    """The dry-run's trace (``roofline/trace.py``, rolled up over layers
    and scans) held against the card: (a) phase_train's step (B 8 x S
    512) with remat none, full and dots and with bf16 moments, (b) one
    batch-1 qwen3-8b prefill of 4,096 tokens on random bf16 weights — each
    traced temporaries against ``max_memory_allocated`` above what was
    allocated just before the call, traced flops against FlopCounterMode's
    count of the real call; (c) the 16 x 16 cells traced, and one cell
    under each lever."""
    from repro_torch.configs.base import get_config, registry
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.data.pipeline import pipeline_for_model
    from repro_torch.launch import dryrun
    from repro_torch.models import mamba2, moe, rwkv6
    from repro_torch.models.transformer import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.roofline import cost_model
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = model.cfg
    batch = pipeline_for_model(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=seed,
                               device=LM_DEVICE).batch_at(0)
    # (a) the train step: one step first, so the card's workspaces exist
    opt_cfg = AdamWConfig(**TRAIN_OPT)
    state = init_train_state(model, opt_cfg)
    make_train_step(model, opt_cfg, remat="none")(state, batch)
    train = {}
    for name, remat, mdt in (("remat_none", "none", "float32"),
                             ("remat_full", "full", "float32"),
                             ("remat_dots", "dots", "float32"),
                             ("bf16_moments", "full", "bfloat16")):
        ocfg = AdamWConfig(**TRAIN_OPT, moment_dtype=mdt)
        st = state if mdt == "float32" else init_train_state(model, ocfg)
        step = make_train_step(model, ocfg, remat=remat)
        new, measured, counted = _measured_call(lambda: step(st, batch))
        del new
        traced = dryrun.trace_cell(
            cfg, "train", TRAIN_BATCH, TRAIN_SEQ,
            dryrun.Levers(remat=remat, bf16_moments=mdt == "bfloat16"), 1,
            opt_cfg=ocfg)
        train[name] = dict(_trace_pair(name, traced, measured, counted),
                           remat=remat, moment_dtype=mdt)
        del st
        gc.collect()
        torch.cuda.empty_cache()
    model.remat = "none"
    del state
    gc.collect()
    torch.cuda.empty_cache()
    # (b) one prefill at full width
    arch, seq = DIST_TRACE_PREFILL
    cfg8 = get_config(arch)
    big = build_model(cfg8, device=LM_DEVICE, generator=torch.Generator(
        device=LM_DEVICE).manual_seed(seed))
    tokens = torch.randint(0, cfg8.vocab, (1, seq), dtype=torch.int32,
                           device=LM_DEVICE,
                           generator=torch.Generator(
                               device=LM_DEVICE).manual_seed(seed))
    big.prefill(tokens[:, :16], 16)          # workspaces
    out, measured, counted = _measured_call(lambda: big.prefill(tokens, seq))
    del out
    traced = dryrun.trace_cell(cfg8, "prefill", 1, seq, dryrun.Levers(), 1)
    prefill = dict(_trace_pair(f"{arch} prefill", traced, measured, counted),
                   model=arch, batch=1, seq=seq)
    del big, tokens
    gc.collect()
    torch.cuda.empty_cache()
    # (c) the 16 x 16 cells, traced, and one cell under each lever
    bw = cost_model.calibrate(LM_DEVICE).hbm_bw
    flags = (moe.CONSTRAIN_DISPATCH, mamba2.CHUNKED_SSD, rwkv6.CHUNKED_WKV)
    t0 = time.perf_counter()
    recs = dryrun.run(sorted(registry()), list(SHAPES), ["16x16"], bw)
    cells_s = time.perf_counter() - t0
    status = {k: sum(r["status"] == k for r in recs)
              for k in ("ok", "skipped", "failed")}
    check(len(recs) == 40 and status == {"ok": 32, "skipped": 8,
                                         "failed": 0},
          f"dist_trace: 16x16 cells {status}")
    ok = [r for r in recs if r["status"] == "ok"]
    for r in ok:
        check(r["cost"]["flops"] and r["cost"]["bytes accessed"]
              and r["memory"]["temp_size_in_bytes"]
              and r["memory"]["output_size_in_bytes"] and "trace" in r,
              f"dist_trace: {r['arch']} x {r['shape']} lacks a traced field")
    by_cell = {(r["arch"], r["shape"]): r for r in ok}

    def brief(r):
        return {"flops": r["cost"]["flops"],
                "bytes_accessed": r["cost"]["bytes accessed"],
                "temp_bytes": r["memory"]["temp_size_in_bytes"],
                "output_bytes": r["memory"]["output_size_in_bytes"],
                "resident_bytes": r["memory"]["argument_size_in_bytes"],
                "bottleneck": r["roofline"]["bottleneck"],
                "trace_s": round(r["trace"]["seconds"], 3)}

    cells = {f"{r['arch']} x {r['shape']}": brief(r) for r in ok}
    levers = {}
    for name, kw, arch_l, shape_l in DIST_TRACE_LEVERS:
        rec = dryrun.run([arch_l], [shape_l], ["16x16"], bw,
                         levers=dryrun.Levers(**kw))[0]
        check(rec["status"] == "ok", f"dist_trace: lever {name} {rec}")
        levers[name] = {"cell": f"{arch_l} x {shape_l}", "lever": kw,
                        "with": brief(rec),
                        "default": brief(by_cell[(arch_l, shape_l)])}
    check((moe.CONSTRAIN_DISPATCH, mamba2.CHUNKED_SSD,
           rwkv6.CHUNKED_WKV) == flags,
          "dist_trace: a lever's switch outlived its cell")
    largest = max(ok, key=lambda r: r["memory"]["temp_size_in_bytes"])
    emit("dist_trace", card=card, train_step={
             "model": DIST_ARCH, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
             **train},
         bf16_moments_peak_fall_bytes=(
             train["remat_full"]["measured_temp_bytes"]
             - train["bf16_moments"]["measured_temp_bytes"]),
         prefill=prefill, tol=DIST_TRACE_TOL,
         cells_16x16={"count": len(recs), **status,
                      "seconds": round(cells_s, 3), "cells": cells},
         levers=levers,
         largest_temp={"cell": f"{largest['arch']} x {largest['shape']} x "
                               "16x16",
                       "temp_bytes": largest["memory"]["temp_size_in_bytes"]})


def phase_dist(seed: int, card, train_sizes=None):
    """The distributed-training and analysis modules at full width, after
    the train phase: the GPipe pipeline over qwen1.5-0.5b's decoder blocks
    (4 emulated stages, 8 microbatches) against the blocks in sequence,
    ``compressed_psum`` at p = 4 over gradient-sized trees in each mode,
    both also on a 1-rank NCCL group; the 80-cell meta dry-run (resident
    bytes); the counted flops of a train step against 6·N·T; the dry-run's
    trace held against the card and the 16 x 16 cells traced
    (``_dist_trace``)."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.transformer import build_model
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(DIST_ARCH)
    model = build_model(cfg, device=LM_DEVICE, generator=torch.Generator(
        device=LM_DEVICE).manual_seed(seed))
    if train_sizes is None:           # phase_dist alone
        params = list(model.state_dict().values())
        train_sizes = {"param_bytes": _nbytes(params),
                       "moment_bytes": 2 * 4 * sum(p.numel()
                                                   for p in params)}
    parts = {}
    for name, fn in (("dist_pipeline", lambda: _dist_pipeline(
                          model, seed, card)),
                     ("dist_psum", lambda: _dist_psum(model, seed, card)),
                     ("dist_dryrun", lambda: _dist_dryrun(card,
                                                          train_sizes)),
                     ("dist_flops", lambda: _dist_flops(model, seed,
                                                        card)),
                     ("dist_trace", lambda: _dist_trace(model, seed,
                                                        card))):
        t0 = time.perf_counter()
        fn()
        parts[name] = round(time.perf_counter() - t0, 3)
        gc.collect()
        torch.cuda.empty_cache()
    del model
    gc.collect()
    torch.cuda.empty_cache()
    emit("dist_phase", parts_s=parts,
         seconds=round(time.perf_counter() - t_phase, 3))


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
                                     csrc_segment,  # (register)
                                     csrc_spmm, csrc_spmv,
                                     csrc_spmv_flat, csrc_spmv_nnzsplit)

    torch.manual_seed(args.seed)
    card = phase_env()
    phase_build(args.verbose_build)
    phase_kernels(args.seed)
    phase_calibration(card)

    launches = {}
    rows = []
    mesh_inputs, mesh_launches = {}, {}
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
        if spec["name"] in TUNED:
            phase_tune(work, spec)
        mid = MESH_MATRIX.get(spec["name"])
        if mid is not None:     # kept for the mesh phase
            mesh_inputs[mid] = {"M": work.M[mid], "arrays": work.arrays[mid],
                                "csr": work.csr[mid],
                                "local": eng.executor(mid),
                                "abs": work.segment_abs[mid]}
        del eng, work
        gc.collect()
        torch.cuda.empty_cache()
        if set(mesh_inputs) == set(MESH_MATRIX.values()):
            mesh_launches = phase_mesh(mesh_inputs, args.seed)
            mesh_inputs = {}
            gc.collect()
            torch.cuda.empty_cache()
    check(bool(mesh_launches), "the mesh phase did not run")
    t0 = time.perf_counter()
    launches[csrc_segment.K15.name], row = phase_segment(SEGMENT_GRID,
                                                         args.seed)
    rows.append(row)
    emit("segment_phase", seconds=round(time.perf_counter() - t0, 3))
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
    for row in rows:
        row["mesh_launches"] = mesh_launches.get(row["name"], 0)
    emit("assembly_phase", seconds=round(time.perf_counter() - t0, 3))
    del sched, ke0
    gc.collect()
    torch.cuda.empty_cache()
    for name in _build.KERNELS:
        check(name in launches, f"kernel {name} is on no main path")
    t0 = time.perf_counter()
    phase_colorful(int(round(math.sqrt(args.n / 8))), args.seed)
    emit("colorful_phase", seconds=round(time.perf_counter() - t0, 3))
    phase_lm(args.seed, card)
    train_sizes = phase_train(args.seed, card)
    phase_dist(args.seed, card, train_sizes)
    emit("total", seconds=round(time.perf_counter() - t_start, 3))

    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": device_mod.describe("cuda:0")}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
