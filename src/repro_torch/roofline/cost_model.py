"""Analytic per-candidate roofline costs for ExecutionPlans and for the
FEM assembly strategies, in two forms.

The tuners' predict-then-measure mode needs a ranking of candidates
*before* any of them is packed or timed.  Both forms price a candidate
from matrix statistics (or an assembly schedule) alone — the geometry
formulas the packers use (window width, tile count, slot padding),
evaluated without building a pack.

**The JAX package's formulas** (``plan_cost``, ``rank_plans``,
``assembly_cost``, ``rank_assembly_candidates``), kept byte for byte and
flop for flop so that the two packages' prices can be held against each
other:

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

Their one-hot terms price the TPU bodies' masks, which this port's
kernels never build, so the port's tuners do not rank with them.

**Card pricing** (``card_plan_cost``, ``rank_card_plans``,
``card_assembly_cost``, ``rank_card_assembly_candidates``) prices each
path as this port runs it on the card: the kernel's own bytes (what
``chip_smoke.py``'s bound column counts, :func:`pack_kernel_bytes`), the
padded slots the kernel streams as layout bytes, the bytes of every torch
op around it (overlap-add, the nnz-split fix-up, each op of the
``segment`` and ``colorful`` products) and one launch term per kernel or
op.  The one-hot kernels sum runs of equal rows (no mask), so a one-hot
plan costs exactly what its stream twin costs and measurement decides
between them.  The denominators are measured on the card once per process
(:func:`calibrate`); on the CPU they are the data-sheet figures.

Predictions rank the candidates (measure only the top of the list) and
give the achieved fraction ``predicted_s / measured_s``, never a
substitute for measurement.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.plan import ExecutionPlan, kernel_window, LANES

# NVIDIA H100 SXM, published (data sheet): 80 GB of HBM3 at 3.35 TB/s and
# 67 TFLOP/s float32 outside the tensor cores — the figures chip_smoke.py
# prices its kernel bounds with, and card pricing's denominators on a CPU
# device (``calibrate`` measures the bandwidth and the launch on a card).
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


# ---------------------------------------------------------------------------
# Card pricing: the denominators
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Denominators:
    """What card pricing divides by: device-memory bytes per second,
    float32 operations per second, and seconds per kernel launch when
    launches run back to back."""
    hbm_bw: float
    peak_flops: float
    launch_s: float
    source: str

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


# the CPU's denominators: the card's data sheet, and the JAX package's
# per-color launch constant
DATA_SHEET = Denominators(hbm_bw=HBM_BW, peak_flops=PEAK_FLOPS,
                          launch_s=COLOR_LAUNCH_S, source="data sheet")

CALIBRATION_COPY_BYTES = 1 << 30     # one device-to-device copy of 1 GiB
CALIBRATION_LAUNCHES = 200
# cycles the card spins before the timed launches, so that they queue up
# and the host's call rate does not set their time (tens of milliseconds)
_SLEEP_CYCLES = 50_000_000
_CALIBRATED: Dict[str, Denominators] = {}


def calibrate(device=None) -> Denominators:
    """The denominators of card pricing on ``device`` (default the card),
    measured once per process and device: the bandwidth of a 1 GiB
    device-to-device copy (bytes read plus bytes written over its time)
    and the latency of one launch, timed as ``tools/k13_launch_probe.py``
    times it — ``CALIBRATION_LAUNCHES`` one-element adds queued behind a
    spinning kernel, less one such add, per extra launch.  The float32
    peak stays the data sheet's.  A CPU device gets ``DATA_SHEET``."""
    from repro_torch import device as device_mod
    dev = device_mod.resolve(device)
    if dev.type != "cuda":
        return DATA_SHEET
    key = str(dev)
    if key not in _CALIBRATED:
        _CALIBRATED[key] = _measure_denominators(dev)
    return _CALIBRATED[key]


def _measure_denominators(dev) -> Denominators:
    import torch
    from repro_torch.device import time_fn

    with torch.cuda.device(dev):
        src = torch.ones(CALIBRATION_COPY_BYTES // 4, device=dev)
        dst = torch.empty_like(src)
        copy_s = time_fn(dst.copy_, src, warmup=2, repeats=5)
        del src, dst
        torch.cuda.empty_cache()
        one = torch.zeros(1, device=dev)

        def queued_s(count: int) -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SLEEP_CYCLES)
            start.record()
            for _ in range(count):
                one.add_(1.0)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3

        queued_s(CALIBRATION_LAUNCHES)
        many = float(np.median([queued_s(CALIBRATION_LAUNCHES)
                                for _ in range(3)]))
        single = float(np.median([queued_s(1) for _ in range(3)]))
    return Denominators(
        hbm_bw=2.0 * CALIBRATION_COPY_BYTES / copy_s,
        peak_flops=PEAK_FLOPS,
        launch_s=max(many - single, 0.0) / (CALIBRATION_LAUNCHES - 1),
        source="measured on " + torch.cuda.get_device_name(dev))


# ---------------------------------------------------------------------------
# Card pricing: SpMV plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CardCost(CostEstimate):
    """Card price of one candidate, with its parts: ``bytes`` is their
    sum and ``predicted_s`` adds ``launches`` launch latencies."""
    kernel_bytes: float = 0.0          # the kernel's own (the bound's)
    layout_bytes: float = 0.0          # padded slots / entries it streams
    accumulation_bytes: float = 0.0    # the torch ops around it
    launches: int = 0


def _card_estimate(kernel: float, layout: float, acc: float, flops: float,
                   launches: int, den: Denominators) -> CardCost:
    byts = float(kernel + layout + acc)
    mem_s = byts / den.hbm_bw
    cmp_s = flops / den.peak_flops
    return CardCost(bytes=byts, flops=float(flops), memory_s=mem_s,
                    compute_s=cmp_s,
                    predicted_s=max(mem_s, cmp_s) + launches * den.launch_s,
                    kernel_bytes=float(kernel), layout_bytes=float(layout),
                    accumulation_bytes=float(acc), launches=int(launches))


@dataclasses.dataclass(frozen=True)
class PackGeometry:
    """The pack sizes card pricing needs: estimated from statistics
    (``_estimate_geometry``) or read off a built pack
    (:func:`pack_geometry`)."""
    slots: int        # allocated slots (windowed) or entries (nnz-split)
    real: int         # real slots / entries among them
    tiles: int        # row tiles (windowed) or chunks (nnz-split)
    width: int        # window W (windowed) or chunk row window r_pad
    tm: int           # rows per tile (0 for nnz-split)


def _estimate_geometry(stats, plan: ExecutionPlan) -> PackGeometry:
    """The pack geometry of a windowed or nnz-split plan from statistics:
    the JAX package's estimates (``_windowed_geometry``,
    ``_nnzsplit_geometry``), with the real slot count known exactly."""
    if plan.path == "nnzsplit":
        nc, r_pad, slots = _nnzsplit_geometry(stats, plan)
        return PackGeometry(slots=slots, real=2 * stats.k, tiles=nc,
                            width=r_pad, tm=0)
    nt, w_pad, slots = _windowed_geometry(stats, plan)
    return PackGeometry(slots=max(slots, stats.k), real=stats.k, tiles=nt,
                        width=w_pad, tm=plan.tm)


def pack_geometry(pack) -> PackGeometry:
    """The geometry of a built pack: a ``BlockEll``, a ``FlatBlockEll`` or
    an ``NnzSplitPack``."""
    from repro_torch.core.blockell import _padding
    if hasattr(pack, "num_chunks"):
        slots = pack.num_chunks * pack.s
        return PackGeometry(slots=slots, real=slots, tiles=pack.num_chunks,
                            width=pack.r_pad, tm=0)
    slots = pack.col_local.numel()
    pad = int(_padding(pack.col_local, pack.w_pad).sum())
    return PackGeometry(slots=slots, real=slots - pad, tiles=pack.nt,
                        width=pack.w_pad, tm=pack.tm)


def _stream_bytes(plan: ExecutionPlan, numerically_symmetric: bool):
    """(value bytes, stream bytes per slot) of a plan's pack."""
    vb = _VALUE_BYTES.get(plan.value_dtype, 4)
    ib = _INDEX_BYTES.get(plan.index_dtype, 4)
    if plan.path == "nnzsplit":       # one combined value stream, lrow, src
        return vb, vb + 2 * ib
    return vb, vb * (1 if numerically_symmetric else 2) + 2 * ib


def _kernel_bytes(g: PackGeometry, n: int, vb: int, per_slot: int,
                  nrhs: int) -> float:
    """What the kernel itself moves: for K1-K8 the real slots' values and
    indices, the (NT, TM) diagonal, x as the windows read it and the
    window partials written once; for K9-K12 (``g.tm == 0``) the value,
    ``lrow`` and ``src`` streams (padding included), x once and the
    partials written once.  ``chip_smoke.py``'s bound column counts these
    bytes (:func:`pack_kernel_bytes`)."""
    if g.tm == 0:
        return g.slots * per_slot + (g.tiles * g.width + n) * 4.0 * nrhs
    n_pad = g.tiles * g.tm
    return (g.real * per_slot + n_pad * vb
            + (n_pad + g.width) * 4.0 * nrhs
            + g.tiles * g.width * 4.0 * nrhs)


def pack_kernel_bytes(pack, nrhs: int = 1) -> float:
    """The kernel's own bytes (:func:`_kernel_bytes`) on a built pack, from
    its streams' element sizes."""
    if hasattr(pack, "num_chunks"):
        vb = pack.vals.element_size()
        per_slot = vb + pack.lrow.element_size() + pack.src.element_size()
    else:
        vb = pack.vals_l.element_size()
        per_slot = (vb * (1 if pack.num_symmetric else 2)
                    + pack.col_local.element_size()
                    + pack.row_in_win.element_size())
    return _kernel_bytes(pack_geometry(pack), pack.n, vb, per_slot, nrhs)


def _windowed_card(stats, plan, g: PackGeometry, nrhs: int,
                   den: Denominators) -> CardCost:
    vb, per_slot = _stream_bytes(plan, stats.numerically_symmetric)
    kernel = _kernel_bytes(g, stats.n, vb, per_slot, nrhs)
    layout = (g.slots - g.real) * per_slot
    # blockell.overlap_add: y zero-filled, then per group of stride-r
    # tiles the windows gathered into a contiguous copy (read, write) and
    # added into y (read the copy, read y, write y)
    groups = max(1, g.width // max(g.tm, 1))
    part = g.tiles * g.width * 4.0 * nrhs
    acc = ((2 * g.width + g.tiles * g.tm) * 4.0 * nrhs
           + (5 if groups > 1 else 3) * part)
    launches = 1 + 1 + (2 if groups > 1 else 1) * groups
    flops = 4.0 * g.real * nrhs + 2.0 * stats.n * nrhs
    return _card_estimate(kernel, layout, acc, flops, launches, den)


def _nnzsplit_card(stats, plan, g: PackGeometry, nrhs: int,
                   den: Denominators) -> CardCost:
    n = stats.n
    vb, per_slot = _stream_bytes(plan, stats.numerically_symmetric)
    kernel = _kernel_bytes(g, n, vb, per_slot, nrhs)
    slots = g.tiles * g.width
    # csrc_spmv_nnzsplit.fixup: y_pad zeroed, the int32 fixup_idx widened
    # to int64, the index_add_ of the partials, the diagonal product (its
    # values widened first when bfloat16) and its add to y
    acc = ((n + g.width) * 4.0 * nrhs
           + slots * (4.0 + 8.0)
           + slots * (8.0 + 2 * 4.0 * nrhs)
           + n * (4.0 + 2 * 4.0 * nrhs)
           + 3 * n * 4.0 * nrhs)
    launches = 1 + 5
    if plan.value_dtype != "float32":
        acc += n * (vb + 4.0)
        launches += 1
    flops = 2.0 * g.real * nrhs + 2.0 * n * nrhs
    return _card_estimate(kernel, 0.0, acc, flops, launches, den)


def _segment_card(stats, nrhs: int, den: Denominators) -> CardCost:
    """kernels/ref.py's product, op by op: the int32 row and column
    indices widened, the diagonal product, then per triangle half a gather
    of x, the product with the values, a zeroed segment table, its
    ``index_add_`` and the add into y; the rectangular tail likewise."""
    n, k = stats.n, stats.k
    kr = max(stats.nnz - n - 2 * k, 0)
    col = 4.0 * nrhs
    ops = [k * (4 + 8), k * (4 + 8), n * 4 + 2 * n * col]
    for _ in range(2):
        ops += [k * 8 + 2 * k * col, k * 4 + 2 * k * col, (n + 1) * col,
                k * 8 + 2 * k * col, 3 * n * col]
    if kr:
        # the tail's rows are expanded on the host and uploaded per call
        ops += [kr * (4 + 8), kr * (8 + 8), kr * 4, kr * 8 + 2 * kr * col,
                kr * 4 + 2 * kr * col, (n + 1) * col,
                kr * 8 + 2 * kr * col, 3 * n * col]
    flops = 4.0 * k * nrhs + 2.0 * kr * nrhs + 2.0 * n * nrhs
    return _card_estimate(0.0, 0.0, float(sum(ops)), flops, len(ops), den)


def _colorful_card(stats, plan, nrhs: int, den: Denominators) -> CardCost:
    """core/schedule.py::colorful_apply, op by op: the diagonal product,
    then per color its slots widened, the rows, columns and both values
    gathered, and two (gather of x, product, ``index_add_``) triples — one
    pair of ``index_add_`` per color, twelve launches per color."""
    n, k = stats.n, stats.k
    colors = _coloring_palette_estimate(stats, plan.coloring)
    col = 4.0 * nrhs
    per_slot = ((4 + 8) + (8 + 8 + 8) + (8 + 4 + 4) + (4 + 8)
                + 2 * (8 + 4 + 4)
                + 2 * ((8 + 2 * col) + (4 + 2 * col) + (8 + 2 * col)))
    byts = k * per_slot + n * 4 + 2 * n * col
    flops = 4.0 * k * nrhs + 2.0 * n * nrhs
    return _card_estimate(0.0, 0.0, byts, flops, 1 + int(round(12 * colors)),
                          den)


def card_plan_cost(stats, plan: ExecutionPlan,
                   denominators: Denominators = DATA_SHEET,
                   geometry: Optional[PackGeometry] = None) -> CardCost:
    """Card price of one candidate plan, as the port runs it.
    ``geometry`` replaces the windowed or nnz-split estimate with a built
    pack's (:func:`pack_geometry`)."""
    nrhs = max(plan.nrhs, 1)
    den = denominators
    if plan.path in ("kernel", "flat", "nnzsplit"):
        g = (geometry if geometry is not None
             else _estimate_geometry(stats, plan))
        if plan.path == "nnzsplit":
            return _nnzsplit_card(stats, plan, g, nrhs, den)
        return _windowed_card(stats, plan, g, nrhs, den)
    if plan.path == "colorful":
        return _colorful_card(stats, plan, nrhs, den)
    return _segment_card(stats, nrhs, den)


def rank_card_plans(stats, plans: Sequence[ExecutionPlan],
                    denominators: Denominators = DATA_SHEET
                    ) -> List[Tuple[ExecutionPlan, CardCost]]:
    """Candidates cheapest-first by card-priced per-RHS-column time; ties
    (a stream plan and its one-hot twin) keep the enumeration order."""
    priced = [(p, card_plan_cost(stats, p, denominators)) for p in plans]
    priced.sort(key=lambda pc: pc[1].predicted_s / max(pc[0].nrhs, 1))
    return priced


# ---------------------------------------------------------------------------
# Card pricing: assembly strategies
# ---------------------------------------------------------------------------

def card_assembly_cost(sched, strategy: str, variant: str = "stream",
                       denominators: Denominators = DATA_SHEET) -> CardCost:
    """Card price of one assembly value refresh, as the port runs it.
    Every strategy's own bytes are each real contribution's slot, target
    and value once and the unified vector once (``chip_smoke.py``'s bound
    for K13/K14); beyond them:

      colored/stream    K13: the padded entries of both (C, Lmax) index
                        streams, the zeroed vector, one launch per color;
      colored/onehot    K14: its (C, NT + 1) ``ptr`` over the two bucket
                        streams (real entries only), one launch;
      colored/percolor  per color the slots and targets widened, a gather
                        and an ``index_add_``: four launches per color;
      sorted            the zeroed vector, the gathered values written and
                        read: three launches;
      private           the padded buffer entries, the (B, size + 1)
                        partials zeroed, filled and summed: five launches.

    The serial oracle runs on the host and is not a candidate."""
    from repro_torch.kernels.assembly_scatter import ONEHOT_TILE

    G = float(sched.ne * sched.edof * sched.edof)
    size = float(sched.size)
    ib_s = _INDEX_BYTES.get(str(sched.color_slots.dtype), 4)
    ib_t = _INDEX_BYTES.get(str(sched.color_targets.dtype), 4)
    colors, lmax = (int(d) for d in sched.color_slots.shape)
    own = G * (ib_s + ib_t + 4.0) + 4.0 * size
    if strategy == "colored" and variant == "stream":
        return _card_estimate(own, (colors * lmax - G) * (ib_s + ib_t),
                              4.0 * size, G, 1 + colors, denominators)
    if strategy == "colored" and variant == "onehot":
        tiles = _round_up(int(size) + 1, ONEHOT_TILE) // ONEHOT_TILE
        return _card_estimate(own, colors * (tiles + 1) * 4.0, 0.0, G, 1,
                              denominators)
    if strategy == "colored" and variant == "percolor":
        busy = sum(1 for c in sched.color_counts if c)
        return _card_estimate(own, 0.0, 4.0 * size + G * (16 + 16 + 8), G,
                              1 + 4 * busy, denominators)
    own32 = G * 12.0 + 4.0 * size        # the bound int32 streams
    if strategy == "sorted":
        return _card_estimate(own32, 0.0, 4.0 * size + 8.0 * G, G, 3,
                              denominators)
    if strategy == "private":
        buffers = float(sched.buffer_elements.shape[0])
        entries = float(np.asarray(sched.buffer_elements).size
                        * sched.edof * sched.edof)
        return _card_estimate(
            own32, (entries - G) * 8.0,
            8.0 * G + 8.0 * entries + 8.0 * buffers * (size + 1.0),
            G + buffers * size, 5, denominators)
    raise ValueError(f"no card price for assembly {strategy}/{variant}")


def rank_card_assembly_candidates(
        sched, candidates: Sequence[Tuple[str, str]],
        denominators: Denominators = DATA_SHEET
        ) -> List[Tuple[Tuple[str, str], CardCost]]:
    """(strategy, variant) candidates cheapest-first by card price."""
    priced = [(sv, card_assembly_cost(sched, sv[0], sv[1], denominators))
              for sv in candidates]
    priced.sort(key=lambda pc: pc[1].predicted_s)
    return priced
