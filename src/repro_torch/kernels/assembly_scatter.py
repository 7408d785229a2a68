"""FEM assembly scatter: CUDA kernels K13/K14 and their plain versions.

Assembly is the scatter-add ``vals[targets[g]] += ke.flat[g]`` into the
unified ``[ad | al | au]`` vector of an
:class:`~repro_torch.assembly.scatter.AssemblySchedule`.  The colored
strategy runs it over the schedule's per-color (C, Lmax) slot / target
packs: colors are serial phases, and inside a greedy color no two
contributions share a target.  Padded pack entries carry slot sentinel G
(= ne·edof², the JAX package's gather of an appended zero) and target
sentinel ``size`` (its dropped segment); the kernels skip them, so no zero
is appended to ``ke``.  Index streams are int16 where the schedule's
overflow gate allowed it, else int32, each stream on its own; they are
widened in registers.

  'stream'  K13, csrc/assembly_colored_stream.cu — replaces the TPU body
            kernels/assembly_scatter.py::_colored_kernel_stream.  One
            cooperative launch per assembly, a grid barrier between colors;
            a plain load-add-store when no color repeats a target (greedy),
            ``atomicAdd`` when one does (RACE level groups).  Bound by bytes.
  'onehot'  K14, csrc/assembly_colored_onehot.cu — replaces
            ::_colored_kernel_onehot, ported from its math, not its grid:
            one block per 512-wide output tile owns it across all colors,
            reading only that tile's bucket of each color (``order`` /
            ``ptr``, :func:`pack_colored_streams`); the thread of position p
            adds its matches in color, then slot order.  No mask, no
            atomics, bit-identical reruns.

Their plain versions follow the TPU bodies' math — K13: per color a gather
and an ``index_add_`` into ``size + 1`` (the drop segment), color after
color; K14: per color and tile the one-hot contraction over the tile's
bucket.  A CUDA tensor launches the kernel or raises; only a CPU tensor
takes the plain version.  :func:`colored_scatter_fused` (all colors in one
gather + ``index_add_``) and :func:`sorted_scatter` (the sorted-slot
strategy) are the JAX package's torch-op executors, not Pallas bodies.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _build
from ._build import _I, _P

# output-tile width of the one-hot body: K14's block owns one tile, one
# thread per position (csrc/assembly_colored_onehot.cu kTile)
ONEHOT_TILE = 512
COLORED_VARIANTS = ("stream", "onehot")
# one-hot masks of the plain version are built for at most this many
# (entry, position) pairs at a time
_MASK_ELEMENTS = 1 << 25

K13 = _build.register(_build.Kernel(
    "assembly_colored_stream",
    [_P] * 4 + [_I] * 7 + [_P],
    replaces="src/repro/kernels/assembly_scatter.py:102"))
K14 = _build.register(_build.Kernel(
    "assembly_colored_onehot",
    [_P] * 6 + [_I] * 7 + [_P],
    replaces="src/repro/kernels/assembly_scatter.py:121"))

_STREAMS = ("slots", "tgts", "order", "ptr")
_INDEX_DTYPES = (np.int16, np.int32)


def _round_up(v: int, m: int) -> int:
    return (v + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ColoredPacks:
    """A schedule's colored streams with the bucketing K14 reads.

    ``order[c]`` lists color c's pack positions stable-sorted by output
    tile (``tgt // ONEHOT_TILE``), sentinels last; tile t's entries are
    ``order[c, ptr[c, t]:ptr[c, t + 1]]``.  ``repeats`` says whether some
    color writes one target twice (a RACE level group can): K13 then adds
    with atomics.  Derived from the packs by :func:`pack_colored_streams`,
    never stored."""

    num_contribs: int           # G = ne·edof², the slot sentinel
    size: int                   # unified vector length, the target sentinel
    slots: torch.Tensor         # (C, Lmax) int16|int32
    tgts: torch.Tensor          # (C, Lmax) int16|int32
    order: torch.Tensor         # (C, Lmax) int32
    ptr: torch.Tensor           # (C, NT + 1) int32
    repeats: bool

    @property
    def num_colors(self) -> int:
        return int(self.slots.shape[0])

    @property
    def lmax(self) -> int:
        return int(self.slots.shape[1])

    @property
    def num_tiles(self) -> int:
        return int(self.ptr.shape[1]) - 1

    @property
    def device(self) -> torch.device:
        return self.slots.device

    def to(self, device) -> "ColoredPacks":
        device = torch.device(device)
        if all(getattr(self, f).device == device for f in _STREAMS):
            return self
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device).contiguous()
                     for f in _STREAMS})

    @property
    def num_entries(self) -> int:
        """Real (non-sentinel) pack entries over all colors."""
        return int(self.ptr[:, -1].sum())

    def streamed_bytes(self) -> int:
        """Bytes the scatter must move, whichever kernel runs it: each real
        entry's slot, target and contribution read once, the unified
        vector written once.  Padding and K14's buckets are the layout's
        cost (:meth:`layout_bytes`)."""
        per_entry = self.slots.element_size() + self.tgts.element_size() + 4
        return self.num_entries * per_entry + 4 * self.size

    def layout_bytes(self, variant: str = "stream") -> int:
        """Bytes a kernel reads beyond :meth:`streamed_bytes`: the padded
        entries of both index streams, and K14's ``order`` / ``ptr``."""
        pad = (self.slots.numel() - self.num_entries) * (
            self.slots.element_size() + self.tgts.element_size())
        if variant == "onehot":
            pad += (self.order.numel() * self.order.element_size()
                    + self.ptr.numel() * self.ptr.element_size())
        return pad


def pack_colored_streams(color_slots, color_targets, num_contribs: int,
                         size: int) -> ColoredPacks:
    """Validate a schedule's (C, Lmax) packs and derive K14's buckets.

    Raises ValueError unless every slot lies in [0, G] and every target in
    [0, size], and an entry is a sentinel in both streams or in neither —
    what the kernels assume (the JAX package trusts the arrays)."""
    slots = np.asarray(color_slots)
    tgts = np.asarray(color_targets)
    if slots.ndim != 2 or slots.shape != tgts.shape:
        raise ValueError(f"slot / target packs must be one (C, Lmax) shape, "
                         f"got {slots.shape} and {tgts.shape}")
    for name, a in (("slots", slots), ("targets", tgts)):
        if a.dtype not in _INDEX_DTYPES:
            raise TypeError(f"{name} must be int16 or int32, got {a.dtype}")
    if max(num_contribs, size, slots.size) >= 2 ** 31 - 1:
        raise ValueError("packs too large for the kernels' 32-bit indices")
    sentinel = tgts == size
    if slots.size and (slots.min() < 0 or slots.max() > num_contribs
                       or tgts.min() < 0 or tgts.max() > size):
        raise ValueError(f"slots must lie in [0, {num_contribs}] and "
                         f"targets in [0, {size}]")
    if not np.array_equal(slots == num_contribs, sentinel):
        raise ValueError("a padded entry must carry both sentinels")
    num_colors = slots.shape[0]
    nt = _round_up(size + 1, ONEHOT_TILE) // ONEHOT_TILE
    key = np.where(sentinel, nt, tgts.astype(np.int32) // ONEHOT_TILE)
    # 16-bit keys take numpy's radix sort (a stable O(n) pass per color)
    key = key.astype(np.int16 if nt <= np.iinfo(np.int16).max else np.int32)
    order = np.argsort(key, axis=1, kind="stable").astype(np.int32)
    ptr = np.zeros((num_colors, nt + 1), np.int32)
    repeats = False
    for c in range(num_colors):
        ptr[c, 1:] = np.cumsum(np.bincount(key[c], minlength=nt + 1)[:nt])
        real = tgts[c][~sentinel[c]]
        repeats = repeats or (real.size > 0 and int(np.bincount(
            real.astype(np.int64), minlength=1).max()) > 1)
    return ColoredPacks(num_contribs=int(num_contribs), size=int(size),
                        slots=torch.from_numpy(np.ascontiguousarray(slots)),
                        tgts=torch.from_numpy(np.ascontiguousarray(tgts)),
                        order=torch.from_numpy(order),
                        ptr=torch.from_numpy(ptr), repeats=bool(repeats))


def _contribs(packs: ColoredPacks, kflat: torch.Tensor) -> torch.Tensor:
    """The flat float32 contribution values on the packs' device."""
    if kflat.device != packs.device:
        raise ValueError(f"packs live on {packs.device}, ke on "
                         f"{kflat.device}; bind the packs with .to() first")
    k = kflat.reshape(-1).to(torch.float32).contiguous()
    if k.numel() != packs.num_contribs:
        raise ValueError(f"ke holds {k.numel()} contributions, the packs "
                         f"{packs.num_contribs}")
    return k


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def colored_scatter_stream_plain(packs: ColoredPacks,
                                 kflat: torch.Tensor) -> torch.Tensor:
    """Plain version of K13, as the TPU body computes: per color, gather
    the contributions (slot sentinel G reads an appended zero) and
    segment-sum them into ``size + 1`` (target sentinel ``size`` is the
    dropped segment), color after color."""
    k = _contribs(packs, kflat)
    kpad = torch.cat([k, k.new_zeros(1)])
    out = k.new_zeros(packs.size + 1)
    for c in range(packs.num_colors):
        out.index_add_(0, packs.tgts[c].long(),
                       kpad.index_select(0, packs.slots[c].long()))
    return out[:packs.size]


def colored_scatter_onehot_plain(packs: ColoredPacks,
                                 kflat: torch.Tensor) -> torch.Tensor:
    """Plain version of K14: per color and output tile, the (TILE, bucket)
    one-hot of the tile-local targets contracted with the bucket's
    contributions, accumulated color after color.  Buckets are laid out
    as a padded (NT, Bmax) table per color (padding matches no position)
    and tiles are contracted in groups so the masks stay bounded."""
    k = _contribs(packs, kflat)
    dev, nt, tile = k.device, packs.num_tiles, ONEHOT_TILE
    out = k.new_zeros(nt * tile)
    iota = torch.arange(tile, device=dev)
    for c in range(packs.num_colors):
        ptr = packs.ptr[c].long()
        real = int(ptr[-1])
        if real == 0:
            continue
        pos = packs.order[c, :real].long()
        tg = packs.tgts[c].long()[pos]
        val = k[packs.slots[c].long()[pos]]
        t_of = tg // tile
        rank = torch.arange(real, device=dev) - ptr[t_of]
        bmax = int((ptr[1:] - ptr[:-1]).max())
        loc = torch.full((nt, bmax), -1, dtype=torch.long, device=dev)
        vt = k.new_zeros((nt, bmax))
        loc[t_of, rank] = tg - t_of * tile
        vt[t_of, rank] = val
        group = max(1, _MASK_ELEMENTS // (bmax * tile))
        for t0 in range(0, nt, group):
            sl = slice(t0, min(nt, t0 + group))
            onehot = (loc[sl, :, None] == iota).to(torch.float32)
            win = torch.bmm(vt[sl, None, :], onehot)[:, 0]      # (g, TILE)
            out[sl.start * tile:sl.stop * tile] += win.reshape(-1)
    return out[:packs.size]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _flags(packs: ColoredPacks, device) -> tuple:
    """``(slots are int16, targets are int16)`` after checking the
    streams' dtypes, shapes, layout and device."""
    shapes = {"slots": (packs.num_colors, packs.lmax),
              "tgts": (packs.num_colors, packs.lmax),
              "order": (packs.num_colors, packs.lmax),
              "ptr": (packs.num_colors, packs.num_tiles + 1)}
    for name, shape in shapes.items():
        a = getattr(packs, name)
        if (tuple(a.shape) != shape or not a.is_contiguous()
                or a.device != device):
            raise ValueError(f"packs.{name} must be contiguous {shape} on "
                             f"{device}, got {tuple(a.shape)} on {a.device}")
    for name in ("slots", "tgts"):
        if getattr(packs, name).dtype not in (torch.int16, torch.int32):
            raise TypeError(f"packs.{name} must be int16 or int32")
    for name in ("order", "ptr"):
        if getattr(packs, name).dtype != torch.int32:
            raise TypeError(f"packs.{name} must be int32")
    return (packs.slots.dtype == torch.int16,
            packs.tgts.dtype == torch.int16)


def _launch(kernel, packs: ColoredPacks, kflat: torch.Tensor,
            extra_ptrs, extra_ints) -> torch.Tensor:
    if not kflat.is_cuda:
        raise ValueError("the CUDA kernels take CUDA tensors; a CPU tensor "
                         "goes to the plain version")
    k = _contribs(packs, kflat)
    flags = _flags(packs, k.device)
    out = torch.empty(packs.size, dtype=torch.float32, device=k.device)
    args = [packs.slots.data_ptr(), packs.tgts.data_ptr(), *extra_ptrs,
            k.data_ptr(), out.data_ptr(), packs.num_colors, packs.lmax,
            *extra_ints, packs.num_contribs, packs.size,
            *(int(f) for f in flags)]
    with torch.cuda.device(k.device):
        kernel.launch(*args)
    return out


def colored_scatter_stream_cuda(packs: ColoredPacks,
                                kflat: torch.Tensor) -> torch.Tensor:
    """Launch K13 (one cooperative launch); returns the (size,) vector.
    Atomic adds only when some color repeats a target."""
    return _launch(K13, packs, kflat, [], [int(packs.repeats)])


def colored_scatter_onehot_cuda(packs: ColoredPacks,
                                kflat: torch.Tensor) -> torch.Tensor:
    """Launch K14 (one block per output tile); returns the (size,)
    vector."""
    return _launch(K14, packs, kflat,
                   [packs.order.data_ptr(), packs.ptr.data_ptr()],
                   [packs.num_tiles])


def run_colored(packs: ColoredPacks, kflat: torch.Tensor,
                variant: str = "stream") -> torch.Tensor:
    """The colored scatter over bound packs: K13 / K14 on a CUDA ``kflat``,
    their plain versions on a CPU one."""
    if variant not in COLORED_VARIANTS:
        raise ValueError(f"variant {variant!r} not in {COLORED_VARIANTS}")
    if kflat.is_cuda:
        launch = (colored_scatter_stream_cuda if variant == "stream"
                  else colored_scatter_onehot_cuda)
        return launch(packs, kflat)
    if kflat.device.type != "cpu":
        raise ValueError(f"ke lives on {kflat.device}: a CUDA tensor "
                         "launches the kernel, a CPU tensor takes the plain "
                         "version")
    plain = (colored_scatter_stream_plain if variant == "stream"
             else colored_scatter_onehot_plain)
    return plain(packs, kflat)


def colored_scatter(color_slots, color_targets, kflat, size: int,
                    variant: str = "stream", device=None) -> torch.Tensor:
    """The colored-batch scatter from raw (C, Lmax) packs, the JAX
    package's entry: the packs are validated, bucketed and moved to
    ``device`` (default the card) on every call — a schedule binds them
    once instead (``AssemblySchedule.bind``)."""
    from repro_torch import device as device_mod
    dev = device_mod.resolve(device)
    if not isinstance(kflat, torch.Tensor):
        kflat = torch.from_numpy(np.asarray(kflat, np.float32))
    k = kflat.to(dev)
    packs = pack_colored_streams(color_slots, color_targets, k.numel(),
                                 size).to(dev)
    return run_colored(packs, k, variant)


# the JAX package has two entries (its grid form and an interpret-mode
# fused route); without an interpret mode they are one function here
colored_scatter_grid = colored_scatter


# ---------------------------------------------------------------------------
# Torch-op executors of the JAX package (no Pallas body behind them)
# ---------------------------------------------------------------------------

def colored_scatter_fused(color_slots, color_targets, kflat,
                          size: int) -> torch.Tensor:
    """All color batches as one gather + one ``index_add_``: the same
    (slot, target) pairs K13 processes per color, evaluated at once;
    target sentinel ``size`` lands in the dropped segment."""
    k = torch.as_tensor(kflat).reshape(-1).to(torch.float32)
    kpad = torch.cat([k, k.new_zeros(1)])
    slots = torch.as_tensor(color_slots, device=k.device).reshape(-1).long()
    tgts = torch.as_tensor(color_targets, device=k.device).reshape(-1).long()
    out = k.new_zeros(size + 1)
    out.index_add_(0, tgts, kpad.index_select(0, slots))
    return out[:size]


def sorted_scatter(sorted_perm, sorted_targets, kflat,
                   size: int) -> torch.Tensor:
    """Sorted-slot assembly: gather the contributions in destination order,
    then one segment sum over the monotone targets (``index_add_``; on the
    card its adds land in atomic order — exact on dyadic data)."""
    k = torch.as_tensor(kflat).reshape(-1).to(torch.float32)
    perm = torch.as_tensor(sorted_perm, device=k.device)
    tgts = torch.as_tensor(sorted_targets, device=k.device)
    if perm.dtype == torch.int16:
        perm = perm.int()
    if tgts.dtype == torch.int16:
        tgts = tgts.int()
    out = k.new_zeros(size)
    out.index_add_(0, tgts, k.index_select(0, perm))
    return out
