"""Analytic per-candidate roofline costs for ExecutionPlans and for the
FEM assembly strategies.

The tuners' predict-then-measure mode needs a ranking of candidates
*before* any of them is packed or timed.  This module prices a candidate
from matrix statistics (or an assembly schedule) alone — the geometry
formulas the packers use (window width, tile count, slot padding),
evaluated without building a pack:

  bytes   the streamed working set per product: value streams (halved for
          numerically-symmetric matrices and again for bfloat16), index
          streams (halved for int16), x/y traffic, and the per-tile window
          writes + overlap-add re-reads;
  flops   O(1)-per-slot multiply-adds for the streaming/segment variants;
          the one-hot variants additionally pay the mask build and the
          contractions of the TPU bodies (one op per mask element, 2·S·W·
          nrhs flops per contraction);
  predicted_s = max(bytes / HBM_BW, flops / PEAK_FLOPS) (+ a per-color
          launch term for the colored executors).

Bytes and flops are the JAX package's, formula for formula, for the same
input.  The denominators are this port's card, named once below.  The
one-hot terms still price the TPU bodies' masks, which the port's one-hot
kernels never build, so the model over-prices them; predictions rank the
candidates (measure only the top of the list) and give the achieved
fraction ``predicted_s / measured_s``, never a substitute for measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.plan import ExecutionPlan, kernel_window, LANES

# NVIDIA H100 SXM, published (data sheet): 80 GB of HBM3 at 3.35 TB/s and
# 67 TFLOP/s float32 outside the tensor cores — the figures chip_smoke.py
# prices its kernel bounds with.  Measured denominators are still open.
HBM_BW = 3.35e12                # bytes/s
PEAK_FLOPS = 67e12              # float32 FLOP/s


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


_VALUE_BYTES = {"float32": 4, "bfloat16": 2}
_INDEX_BYTES = {"int32": 4, "int16": 2}

# --- colorful-path locality terms -----------------------------------------
# Per-color serial launch overhead: each color class is its own scatter
# dispatch, serialized against the previous one, so the colored path pays
# this once per palette entry.
COLOR_LAUNCH_S = 2e-6
# Scatter transaction granularity: an isolated y/x touch moves a whole
# line, using only the 4 bytes it wanted.  Greedy classes stride the
# matrix and pay the waste on most touches; RACE classes are unions of
# contiguous level ranges, so most of the waste vanishes.
SCATTER_LINE_BYTES = 64.0
_REUSE_WASTE_FRACTION = {"greedy": 1.0, "race": 0.25}


def _coloring_palette_estimate(stats, provider: str) -> float:
    """Analytic palette-size estimate for the distance-2 row coloring:
    greedy needs about the conflict degree + 1 colors (~2·bandwidth on
    banded matrices, ~deg² on unstructured ones, capped at n-1); RACE is
    modeled as a small constant palette."""
    n = max(stats.n, 1)
    deg = 2.0 * stats.k / n
    conflict_deg = min(float(n - 1), 2.0 * stats.bandwidth,
                       deg * deg + deg)
    if provider == "race":
        return 4.0                       # two sweeps x ~one recursion level
    return 1.0 + conflict_deg


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Roofline price of one candidate."""
    bytes: float                  # streamed bytes per product
    flops: float                  # arithmetic ops per product
    memory_s: float               # bytes / HBM_BW
    compute_s: float              # flops / PEAK_FLOPS
    predicted_s: float            # max(memory_s, compute_s) + launch term

    @property
    def bound(self) -> str:
        return "compute" if self.compute_s > self.memory_s else "memory"

    def to_dict(self) -> Dict:
        return {"bytes": self.bytes, "flops": self.flops,
                "predicted_ms": self.predicted_s * 1e3, "bound": self.bound}


def _estimate(byts: float, flops: float, launch_s: float) -> CostEstimate:
    mem_s = byts / HBM_BW
    cmp_s = flops / PEAK_FLOPS
    return CostEstimate(bytes=float(byts), flops=float(flops),
                        memory_s=mem_s, compute_s=cmp_s,
                        predicted_s=max(mem_s, cmp_s) + launch_s)


def _windowed_geometry(stats, plan: ExecutionPlan) -> Tuple[int, int, int]:
    """(nt, w_pad, padded slot count) of a 'kernel'/'flat' pack, estimated
    from stats — mirrors blockell.pack / pack_flat without building them."""
    tm = plan.tm
    nt = max(1, -(-stats.n // tm))
    w_pad = kernel_window(tm, stats.bandwidth)
    k_step = plan.k_step_sublanes * LANES
    if plan.path == "flat":
        # per-tile-exact packing: ceil(k / k_step) full steps plus at most
        # one remainder step per tile
        steps = -(-max(stats.k, 1) // k_step) + nt
        return nt, w_pad, steps * k_step
    # rectangular grid: every tile is padded to the fullest tile's slot
    # count; skew is modeled with the nnz-per-row dispersion
    mean_tile = max(stats.k, 1) / nt
    imbalance = 1.0 + stats.nnz_row_dev / max(stats.nnz_row_mean, 1.0)
    s_tile = _round_up(max(int(mean_tile * imbalance), 1), k_step)
    return nt, w_pad, nt * s_tile


def _nnzsplit_geometry(stats, plan: ExecutionPlan) -> Tuple[int, int, int]:
    """(num_chunks, r_pad, padded entry count): the dest-sorted stream has
    one entry per triangle half (2k total), cut into S = ks·128 chunks."""
    s = plan.k_step_sublanes * LANES
    entries = max(2 * stats.k, 1)
    num_chunks = -(-entries // s)
    # a chunk of S entries spans ~S / (nnz per row) rows
    span = s / max(stats.nnz_row_mean, 1.0)
    r_pad = _round_up(max(int(span), 1), 128)
    return num_chunks, r_pad, num_chunks * s


def plan_cost(stats, plan: ExecutionPlan) -> CostEstimate:
    """Roofline price of one candidate plan.  Any path without its own
    formula prices as the generic streaming product (the segment
    formula)."""
    nrhs = max(plan.nrhs, 1)
    vb = _VALUE_BYTES.get(plan.value_dtype, 4)
    ib = _INDEX_BYTES.get(plan.index_dtype, 4)
    n, k = stats.n, max(stats.k, 1)
    vstreams = 1 if stats.numerically_symmetric else 2
    xy = 2.0 * 4 * max(n, stats.m) * nrhs      # x read + y write
    diag = 4.0 * n
    launch_s = 0.0                             # serialized dispatch overhead

    if plan.path in ("kernel", "flat"):
        nt, w_pad, slots = _windowed_geometry(stats, plan)
        byts = (slots * (vb * vstreams + ib * 2)   # vals + col/row streams
                + diag + xy
                + 2.0 * nt * w_pad * 4 * nrhs)     # windows + overlap-add
        flops = 4.0 * slots * nrhs + 2.0 * n * nrhs
        if plan.variant == "onehot":
            # two (S, W) masks: iota + compare + convert per element, then
            # four contractions at 2·S·W·nrhs each
            flops += slots * w_pad * (6.0 + 8.0 * nrhs)
    elif plan.path == "nnzsplit":
        nc, r_pad, slots = _nnzsplit_geometry(stats, plan)
        byts = (slots * (vb + 4 + ib)     # vals + src gather idx + lrow
                + diag + xy
                + 2.0 * nc * r_pad * 4 * nrhs)     # partials + fixup
        flops = 2.0 * slots * nrhs + 2.0 * n * nrhs
        if plan.variant == "onehot":
            flops += slots * r_pad * (3.0 + 2.0 * nrhs)
    elif plan.path == "colorful":
        # the color classes tile the slots (one pass over the triangle)
        # plus one serialized scatter launch per color and the
        # isolated-line waste of scattered classes
        colors = _coloring_palette_estimate(stats, plan.coloring)
        waste = _REUSE_WASTE_FRACTION.get(plan.coloring, 1.0)
        byts = k * (4 * vstreams + 4 * 2) + diag + xy
        byts += waste * (2.0 * k + n) * (SCATTER_LINE_BYTES - 4.0)
        flops = 4.0 * k * nrhs + 2.0 * n * nrhs
        launch_s = colors * COLOR_LAUNCH_S
    else:
        # segment / future paths: the unpadded streaming product
        byts = k * (4 * vstreams + 4 * 2) + diag + xy
        flops = 4.0 * k * nrhs + 2.0 * n * nrhs
    return _estimate(byts, flops, launch_s)


def rank_plans(stats, plans: Sequence[ExecutionPlan]
               ) -> List[Tuple[ExecutionPlan, CostEstimate]]:
    """Candidates cheapest-first by predicted per-RHS-column time (an
    nrhs=8 plan prices 8 columns of work)."""
    priced = [(p, plan_cost(stats, p)) for p in plans]
    priced.sort(key=lambda pc: pc[1].predicted_s / max(pc[0].nrhs, 1))
    return priced


def roofline_fraction(est: CostEstimate, measured_s: float) -> float:
    """Fraction of the analytic roofline the measured time achieved."""
    if measured_s <= 0:
        return 0.0
    return est.predicted_s / measured_s


# ---------------------------------------------------------------------------
# FEM assembly scatter pricing (repro_torch.assembly.scatter.tune_assembly)
# ---------------------------------------------------------------------------

def assembly_cost(sched, strategy: str,
                  variant: str = "stream") -> CostEstimate:
    """Roofline price of one assembly value refresh for a (strategy,
    variant) candidate on an AssemblySchedule (duck-typed: ne, edof,
    size, num_buffers, coloring and the numpy kernel packs).

    All strategies stream the G = ne·edof² contribution values plus their
    index streams (halved under the int16 gate) and write the unified
    vector.  The colored kernels pay the (C, Lmax) pack padding; the
    one-hot variant is priced as the TPU body (an (L, TILE) mask per output
    tile, five ops per element), not as K14's bucketed form; the per-color
    baseline pays one launch per color plus the isolated scatter-line
    waste; private pays 2·B·size partial traffic; sorted streams exactly
    G."""
    from repro_torch.kernels.assembly_scatter import ONEHOT_TILE

    contribs = float(sched.ne * sched.edof * sched.edof)   # G
    size = float(sched.size)
    out_bytes = size * 4.0
    ib_slot = _INDEX_BYTES.get(str(sched.color_slots.dtype), 4)
    ib_tgt = _INDEX_BYTES.get(str(sched.color_targets.dtype), 4)
    launch_s = 0.0

    if strategy == "colored" and variant == "percolor":
        colors = int(sched.coloring.num_colors)
        byts = contribs * (4.0 + 4.0) + out_bytes
        byts += contribs * (SCATTER_LINE_BYTES - 4.0)
        flops = contribs
        launch_s = colors * COLOR_LAUNCH_S
    elif strategy == "colored":
        padded = float(sched.color_slots.shape[0]
                       * sched.color_slots.shape[1])       # C·Lmax
        byts = padded * (4.0 + ib_slot + ib_tgt) + out_bytes
        flops = padded
        if variant == "onehot":
            size_pad = float(_round_up(int(size) + 1, ONEHOT_TILE))
            flops += padded * size_pad * 5.0
    elif strategy == "sorted":
        byts = contribs * (4.0 + ib_slot + ib_tgt) + out_bytes
        flops = contribs
    elif strategy == "private":
        buffers = float(sched.num_buffers)
        # partials written then re-read for the reduce
        byts = (contribs * (4.0 + 4.0) + out_bytes
                + 2.0 * buffers * (size + 1.0) * 4.0)
        flops = contribs + buffers * size
    else:                              # serial oracle — not a candidate
        byts = contribs * (4.0 + 4.0) + out_bytes
        byts += contribs * (SCATTER_LINE_BYTES - 4.0)
        flops = contribs
    return _estimate(byts, flops, launch_s)


def rank_assembly_candidates(
        sched, candidates: Sequence[Tuple[str, str]]
        ) -> List[Tuple[Tuple[str, str], CostEstimate]]:
    """(strategy, variant) candidates cheapest-first by predicted time."""
    priced = [(sv, assembly_cost(sched, sv[0], sv[1]))
              for sv in candidates]
    priced.sort(key=lambda pc: pc[1].predicted_s)
    return priced
