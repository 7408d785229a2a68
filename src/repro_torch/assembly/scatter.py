"""Conflict-free global-matrix assembly: the paper's accumulation
strategies applied to the FEM scatter-add.

Assembling ``A = Σ_e P_e^T k_e P_e`` is a scatter-add over CSRC slots:
contribution (e, a, b) lands on the diagonal (i == j), on a lower slot
``al[p]`` (i > j) or on the aligned upper slot ``au[p]`` (i < j).  All
three destinations flatten into one **unified value vector**
``[ad | al | au]`` of length n + 2k, so assembly is a single scatter into
that vector and the paper's two race-avoidance families map exactly:

  colored   per-color batched scatter (elements of one greedy color share
            no DOF, so within a color every target is written once).
            ``variant='stream'`` runs K13 and ``'onehot'`` K14
            (``repro_torch.kernels.assembly_scatter``, one launch each);
            ``'percolor'`` is the one-``index_add_``-per-color baseline
  sorted    contributions pre-sorted by destination slot at schedule-build
            time, so assembly is one color-free gather + segment sum
  private   per-buffer full-length partials (one batched ``index_add_``
            into a (B, size + 1) table) summed at the end — the paper's
            local-buffers family
  serial    numpy ``np.add.at`` in element order on the host — the oracle
            the strategies must reproduce

With the dyadic stiffness of ``assembly/mesh.py`` float32 sums are exact in
any order, so every strategy must agree with the oracle **bit for bit**.

All structure-dependent work — slot layout, contribution targets, element
coloring, buffer grouping, the kernel packs — lives in the npz-serializable
:class:`AssemblySchedule` (the JAX package's file format: schedules
cross-load both ways), stored in the PlanCache beside the SpMV schedules
and keyed by a connectivity digest: FEM time stepping re-assembles with
unchanged connectivity and reuses every artifact.  A schedule moves each
strategy's streams to a device once, on that strategy's first use there
(:meth:`AssemblySchedule.bind`), not per assembly.

Entry points take ``device=`` (default the card, raising without one);
``ke`` may be a numpy array or a tensor already on the device, and the
assembled matrix keeps its values on the assembling device.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch import obs
from repro_torch.core.coloring import Coloring
from repro_torch.core.csrc import CSRC
from repro_torch.core.paths import BUILD_COUNTS
from repro_torch.kernels import assembly_scatter as akern
from repro_torch.kernels.assembly_scatter import COLORED_VARIANTS  # noqa: F401
from .conflict import color_elements, element_dofs, sorted_unique
from .mesh import Mesh

# version 3: the schedule carries the kernel slot packs — per-color
# (slots, targets) streams and the destination-sorted permutation — with
# overflow-gated int16 index dtypes (the JAX package's format)
ASSEMBLY_VERSION = 3

STRATEGIES = ("colored", "sorted", "private", "serial")

# the (strategy, variant) pool tune_assembly prices and measures ('vmap'
# keeps the JAX package's label of the private executor)
ASSEMBLY_CANDIDATES = (
    ("colored", "stream"), ("colored", "onehot"), ("colored", "percolor"),
    ("sorted", "stream"), ("private", "vmap"))

_DEFAULT_VARIANT = {"colored": "stream", "sorted": "stream",
                    "private": "vmap", "serial": "numpy"}

# int16 index streams iff every representable value (including the
# sentinel one past the real range) fits
_INT16_MAX = np.iinfo(np.int16).max


def assembly_key(digest: str, num_buffers: int,
                 coloring: str = "greedy") -> str:
    """Cache key of one assembly schedule.  Greedy keys carry no provider
    suffix; other providers append their name."""
    suffix = "" if coloring == "greedy" else f".{coloring}"
    return f"asm-{digest}.b{num_buffers}{suffix}"


class BoundSchedule:
    """A schedule's index streams on one device.  Each part is uploaded on
    its first use there and kept, so a strategy that never runs costs no
    device memory; ``assembly_pack_uploads_total{device, part}`` counts one
    upload per part."""

    def __init__(self, sched: "AssemblySchedule", device: torch.device):
        self._sched = sched
        self.device = device
        self._parts: Dict[str, object] = {}

    def _part(self, name: str, upload):
        got = self._parts.get(name)
        if got is None:
            with obs.span("assembly.bind", device=str(self.device),
                          part=name):
                got = upload(self._sched, self.device)
            self._parts[name] = got
            obs.counter("assembly_pack_uploads_total",
                        device=self.device.type, part=name).inc_always()
        return got

    @property
    def colored(self) -> akern.ColoredPacks:
        """K13 / K14 packs with K14's buckets, as built (int16 stays)."""
        return self._part("colored", lambda s, dev: s.colored.to(dev))

    @property
    def sorted(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(G,) int32 permutation and monotone targets."""
        return self._part("sorted", lambda s, dev: (
            _i32(s.sorted_perm, dev), _i32(s.sorted_targets, dev)))

    @property
    def private(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B·epb·edof²,) int32 gather slots (G = padding) and their flat
        index into the (B, size + 1) partials."""
        return self._part("private", _upload_private)

    @property
    def structure(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(n+1,) ia and (k,) ja, int32: what every assembled matrix
        wraps."""
        return self._part("structure", lambda s, dev: (
            _i32(s.ia, dev), _i32(s.ja, dev)))


@dataclasses.dataclass(frozen=True)
class AssemblySchedule:
    """Every structure-dependent precomputation one connectivity needs to
    assemble CSRC matrices, for any number of value refreshes."""

    structure_digest: str       # connectivity digest (see structure_digest)
    n: int                      # global DOFs
    k: int                      # strictly-lower CSRC slots
    ne: int                     # elements
    edof: int                   # DOFs per element
    ndof_per_node: int
    num_buffers: int            # private-buffer strategy width
    ia: np.ndarray              # (n+1,) CSRC lower-triangle row pointers
    ja: np.ndarray              # (k,)
    # contribution (e, a, b) at flat index e·edof² + a·edof + b scatters to
    # targets[...] in the unified [ad | al | au] vector of length n + 2k
    targets: np.ndarray         # (ne·edof²,) int32
    coloring: Coloring          # element coloring (conflict.color_elements)
    buffer_elements: np.ndarray  # (num_buffers, epb) int32, -1 = padding
    # per-color contribution streams, padded to a rectangular (C, Lmax)
    # table: slots index the flat ke (sentinel = ne·edof²), targets index
    # the unified vector (sentinel = size).  int16 where the gate allows.
    color_slots: np.ndarray      # (C, Lmax) int16|int32
    color_targets: np.ndarray    # (C, Lmax) int16|int32
    # destination-sorted permutation of all contributions (sorted-slot
    # strategy): perm gathers ke.flat, sorted_targets is monotone
    sorted_perm: np.ndarray      # (ne·edof²,) int16|int32
    sorted_targets: np.ndarray   # (ne·edof²,) int16|int32
    # derived, never stored: the validated packs with K14's tile buckets
    # (kernels/assembly_scatter.pack_colored_streams), and the packs bound
    # to each device (bind)
    colored: akern.ColoredPacks = dataclasses.field(
        init=False, repr=False, compare=False)
    _bound: Dict = dataclasses.field(init=False, repr=False, compare=False)

    def __post_init__(self):
        with obs.span("assembly.kernel_buckets"):
            object.__setattr__(self, "colored", akern.pack_colored_streams(
                self.color_slots, self.color_targets, self.num_contribs,
                self.size))
        object.__setattr__(self, "_bound", {})

    @property
    def size(self) -> int:
        """Length of the unified value vector."""
        return self.n + 2 * self.k

    @property
    def num_contribs(self) -> int:
        return self.ne * self.edof * self.edof

    @property
    def color_counts(self) -> Tuple[int, ...]:
        """Real contributions per color."""
        edof2 = self.edof * self.edof
        return tuple(len(self.coloring.rows(c)) * edof2
                     for c in range(self.coloring.num_colors))

    @property
    def index_dtypes(self) -> Dict[str, str]:
        """Gated dtypes of the kernel index streams."""
        return {"slots": str(self.color_slots.dtype),
                "targets": str(self.color_targets.dtype)}

    def key(self) -> str:
        return assembly_key(self.structure_digest, self.num_buffers,
                            self.coloring.provider)

    def bind(self, device) -> BoundSchedule:
        """The index streams on ``device``: one record per device, whose
        parts upload on first use and serve every later assembly there."""
        dev = device_mod.resolve(device)
        bound = self._bound.get(dev)
        if bound is None:
            bound = self._bound[dev] = BoundSchedule(self, dev)
        return bound

    # ------------------------------------------------------------------
    # Serialization (npz arrays + JSON meta, the JAX package's layout;
    # written uncompressed: zlib took most of a full-size save's time,
    # and np.load reads either form)
    # ------------------------------------------------------------------

    def save_npz(self, path: str):
        meta = {
            "version": ASSEMBLY_VERSION,
            "structure_digest": self.structure_digest,
            "n": self.n, "k": self.k, "ne": self.ne, "edof": self.edof,
            "ndof_per_node": self.ndof_per_node,
            "num_buffers": self.num_buffers,
            "num_colors": int(self.coloring.num_colors),
            "coloring_provider": self.coloring.provider,
        }
        arrays = dict(
            ia=np.asarray(self.ia), ja=np.asarray(self.ja),
            targets=np.asarray(self.targets),
            color_of_row=np.asarray(self.coloring.color_of_row),
            rows_by_color=np.asarray(self.coloring.rows_by_color),
            color_ptr=np.asarray(self.coloring.color_ptr),
            buffer_elements=np.asarray(self.buffer_elements),
            color_slots=np.asarray(self.color_slots),
            color_targets=np.asarray(self.color_targets),
            sorted_perm=np.asarray(self.sorted_perm),
            sorted_targets=np.asarray(self.sorted_targets),
        )
        # RACE level-group metadata survives the round trip
        if self.coloring.level_of_row is not None:
            arrays["color_level_of_row"] = np.asarray(
                self.coloring.level_of_row)
        if self.coloring.group_of_row is not None:
            arrays["color_group_of_row"] = np.asarray(
                self.coloring.group_of_row)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(
                json.dumps(meta, sort_keys=True).encode(), dtype=np.uint8),
                **arrays)
        os.replace(tmp, path)

    @classmethod
    def load_npz(cls, path: str) -> "AssemblySchedule":
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            if meta.get("version") != ASSEMBLY_VERSION:
                raise ValueError(
                    f"assembly schedule {path}: version "
                    f"{meta.get('version')!r} != {ASSEMBLY_VERSION}")
            coloring = Coloring(
                color_of_row=z["color_of_row"],
                num_colors=int(meta["num_colors"]),
                rows_by_color=z["rows_by_color"],
                color_ptr=z["color_ptr"],
                provider=meta.get("coloring_provider", "greedy"),
                level_of_row=(z["color_level_of_row"]
                              if "color_level_of_row" in z.files else None),
                group_of_row=(z["color_group_of_row"]
                              if "color_group_of_row" in z.files else None))
            return cls(structure_digest=meta["structure_digest"],
                       n=meta["n"], k=meta["k"], ne=meta["ne"],
                       edof=meta["edof"],
                       ndof_per_node=meta["ndof_per_node"],
                       num_buffers=meta["num_buffers"],
                       ia=z["ia"], ja=z["ja"], targets=z["targets"],
                       coloring=coloring,
                       buffer_elements=z["buffer_elements"],
                       color_slots=z["color_slots"],
                       color_targets=z["color_targets"],
                       sorted_perm=z["sorted_perm"],
                       sorted_targets=z["sorted_targets"])


def _i32(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def _upload_private(sched: AssemblySchedule, dev: torch.device):
    """The private strategy's gather slots and flat partial index."""
    edof2 = sched.edof * sched.edof
    G, size = sched.num_contribs, sched.size
    be = np.asarray(sched.buffer_elements, np.int64)
    B = be.shape[0]
    valid = (be >= 0)[:, :, None]
    lane = np.arange(edof2, dtype=np.int64)
    slots = np.where(valid, np.maximum(be, 0)[:, :, None] * edof2 + lane, G)
    tgts = np.where(slots < G,
                    np.asarray(sched.targets, np.int64)[np.minimum(slots,
                                                                   G - 1)],
                    size)
    index = tgts + np.arange(B, dtype=np.int64)[:, None, None] * (size + 1)
    idx_dt = np.int32 if B * (size + 1) < 2 ** 31 else np.int64
    return (_i32(slots.reshape(-1), dev),
            torch.from_numpy(index.reshape(-1).astype(idx_dt)).to(dev))


def structure_digest(conn: np.ndarray, ndof_per_node: int = 1,
                     num_nodes: Optional[int] = None) -> str:
    """Digest of the element connectivity: unchanged connectivity ⇒
    identical slot layout, targets, coloring, and buffer grouping.  The
    same string as the JAX package's for the same input."""
    conn = np.ascontiguousarray(np.asarray(conn, np.int64))
    num_nodes = int(conn.max()) + 1 if num_nodes is None else num_nodes
    h = hashlib.sha1()
    h.update(np.asarray([conn.shape[0], conn.shape[1], num_nodes,
                         ndof_per_node], np.int64).tobytes())
    h.update(conn.tobytes())
    return h.hexdigest()[:16]


def _index_dtype(max_value: int):
    """Narrowest stream dtype that holds every value up to ``max_value``
    (the sentinel, one past the real range)."""
    return np.int16 if max_value <= _INT16_MAX else np.int32


def _pack_colored(targets: np.ndarray, coloring: Coloring, edof2: int,
                  size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The colored kernels' (C, Lmax) slot/target streams.

    Row c lists color c's contribution indices (element-major) and their
    destinations, padded to a multiple of 128 with the sentinels the
    kernels skip (slot = G, target = size)."""
    num_contribs = int(targets.size)
    counts = [len(coloring.rows(c)) * edof2
              for c in range(coloring.num_colors)]
    lmax = max(128, -(-max(counts + [1]) // 128) * 128)
    slot_dt = _index_dtype(num_contribs)
    tgt_dt = _index_dtype(size)
    color_slots = np.full((coloring.num_colors, lmax), num_contribs,
                          dtype=slot_dt)
    color_targets = np.full((coloring.num_colors, lmax), size,
                            dtype=tgt_dt)
    lane = np.arange(edof2, dtype=np.int64)
    for c in range(coloring.num_colors):
        els = np.asarray(coloring.rows(c), np.int64)
        if els.size == 0:
            continue
        sl = (els[:, None] * edof2 + lane).reshape(-1)
        color_slots[c, :sl.size] = sl.astype(slot_dt)
        color_targets[c, :sl.size] = targets[sl].astype(tgt_dt)
    return color_slots, color_targets


def _pack_sorted(targets: np.ndarray,
                 size: int) -> Tuple[np.ndarray, np.ndarray]:
    """The sorted-slot strategy's destination order: the stable argsort of
    the targets (torch's multithreaded stable sort: the same permutation as
    numpy's, sooner at tens of millions of keys)."""
    num_contribs = int(targets.size)
    perm = torch.sort(torch.from_numpy(np.ascontiguousarray(
        targets, np.int32)), stable=True).indices.numpy()
    sorted_perm = perm.astype(_index_dtype(num_contribs))
    sorted_targets = targets[perm].astype(_index_dtype(size))
    return sorted_perm, sorted_targets


def _is_mesh(obj) -> bool:
    """A :class:`Mesh`, or any object with its ``conn`` / ``num_nodes``
    (the JAX package's Mesh)."""
    return isinstance(obj, Mesh) or (hasattr(obj, "conn")
                                     and hasattr(obj, "num_nodes"))


def build_assembly_schedule(mesh_or_conn: Union[Mesh, np.ndarray],
                            ndof_per_node: int = 1,
                            num_buffers: int = 8,
                            num_nodes: Optional[int] = None,
                            coloring: Optional[Coloring] = None,
                            coloring_provider: str = "greedy"
                            ) -> AssemblySchedule:
    """Build the full assembly artifact for one connectivity.

    The slot layout (ia/ja) is the union of every element's dense block,
    lower triangle only — structurally symmetric by construction.
    Contribution targets are resolved once by searchsorted on the sorted
    lower-slot keys; the element coloring, the kernel packs and the
    private-buffer grouping ride along."""
    if _is_mesh(mesh_or_conn):
        conn = mesh_or_conn.conn
        num_nodes = mesh_or_conn.num_nodes
    else:
        conn = np.asarray(mesh_or_conn)
        num_nodes = (int(conn.max()) + 1 if num_nodes is None
                     else num_nodes)
    BUILD_COUNTS.inc("assembly_schedule")
    d = ndof_per_node
    n = num_nodes * d
    with obs.span("assembly.build_schedule", ndof_per_node=d):
        ed = element_dofs(conn, d)                 # (ne, edof)
        ne, edof = ed.shape

        with obs.span("assembly.slot_pack", ne=ne, edof=edof):
            ii = np.broadcast_to(ed[:, :, None],
                                 (ne, edof, edof)).reshape(-1)
            jj = np.broadcast_to(ed[:, None, :],
                                 (ne, edof, edof)).reshape(-1)
            ii = ii.astype(np.int64)
            jj = jj.astype(np.int64)

            low = ii > jj
            keys = sorted_unique(ii[low] * n + jj[low])  # lower slots
            k = int(keys.shape[0])
            rows = (keys // n).astype(np.int64)
            ja = (keys % n).astype(np.int32)
            ia = np.zeros(n + 1, dtype=np.int32)
            np.cumsum(np.bincount(rows, minlength=n), out=ia[1:])

            targets = np.empty(ne * edof * edof, dtype=np.int32)
            diag = ii == jj
            targets[diag] = ii[diag]
            targets[low] = n + np.searchsorted(keys, ii[low] * n + jj[low])
            up = ii < jj
            targets[up] = n + k + np.searchsorted(keys,
                                                  jj[up] * n + ii[up])

        if coloring is None:
            BUILD_COUNTS.inc("element_coloring")
            with obs.span("assembly.element_coloring",
                          provider=coloring_provider):
                coloring = color_elements(conn, provider=coloring_provider)

        size = n + 2 * k
        BUILD_COUNTS.inc("assembly_color_pack")
        with obs.span("assembly.color_pack",
                      num_colors=int(coloring.num_colors)):
            color_slots, color_targets = _pack_colored(
                targets, coloring, edof * edof, size)
        BUILD_COUNTS.inc("assembly_sorted_pack")
        with obs.span("assembly.sorted_pack", contributions=targets.size):
            sorted_perm, sorted_targets = _pack_sorted(targets, size)

    # private-buffer grouping: contiguous element chunks (locality), padded
    # to a rectangular (B, epb) table with -1 sentinels
    B = max(1, min(num_buffers, ne))
    epb = -(-ne // B)
    buffer_elements = np.full((B, epb), -1, dtype=np.int32)
    flat = buffer_elements.reshape(-1)
    flat[:ne] = np.arange(ne, dtype=np.int32)

    return AssemblySchedule(
        structure_digest=structure_digest(conn, d, num_nodes),
        n=n, k=k, ne=ne, edof=edof, ndof_per_node=d, num_buffers=B,
        ia=ia, ja=ja, targets=targets, coloring=coloring,
        buffer_elements=buffer_elements,
        color_slots=color_slots, color_targets=color_targets,
        sorted_perm=sorted_perm, sorted_targets=sorted_targets)


def assembly_schedule_for(mesh_or_conn, ndof_per_node: int = 1,
                          num_buffers: int = 8, cache=None,
                          num_nodes: Optional[int] = None,
                          coloring_provider: str = "greedy"
                          ) -> AssemblySchedule:
    """The schedule to assemble this connectivity with — cache hit wins.

    ``cache`` is a :class:`~repro_torch.core.tuner.PlanCache`; a hit (keyed
    by the connectivity digest and the element-coloring provider) performs
    zero structural work, which is the FEM time-stepping fast path."""
    if cache is None:
        return build_assembly_schedule(mesh_or_conn, ndof_per_node,
                                       num_buffers, num_nodes=num_nodes,
                                       coloring_provider=coloring_provider)
    if _is_mesh(mesh_or_conn):
        conn, nn = mesh_or_conn.conn, mesh_or_conn.num_nodes
    else:
        conn = np.asarray(mesh_or_conn)
        nn = int(conn.max()) + 1 if num_nodes is None else num_nodes
    digest = structure_digest(conn, ndof_per_node, nn)
    # same clamp the builder applies, so lookup and stored keys agree on
    # meshes with fewer elements than buffers
    num_buffers = max(1, min(num_buffers, int(conn.shape[0])))
    hit = cache.get_assembly_schedule(digest, num_buffers,
                                      coloring=coloring_provider)
    if hit is not None:
        return hit
    sched = build_assembly_schedule(conn, ndof_per_node, num_buffers,
                                    num_nodes=nn,
                                    coloring_provider=coloring_provider)
    cache.put_assembly_schedule(sched)
    return sched


# ---------------------------------------------------------------------------
# Accumulation strategies
# ---------------------------------------------------------------------------

def _contributions(sched: AssemblySchedule, ke, dev) -> torch.Tensor:
    """``ke`` (numpy or a tensor) as the flat float32 contribution vector
    on ``dev``."""
    if not isinstance(ke, torch.Tensor):
        ke = torch.from_numpy(np.asarray(ke, np.float32))
    k = ke.to(device=dev, dtype=torch.float32).reshape(-1)
    if k.numel() != sched.num_contribs:
        raise ValueError(f"ke holds {k.numel()} values, the schedule "
                         f"{sched.num_contribs} (ne·edof²)")
    return k.contiguous()


def scatter_colored_percolor(sched: AssemblySchedule, ke,
                             device=None) -> torch.Tensor:
    """The per-color baseline: one ``index_add_`` per color class,
    serialized — C dispatches per refresh, over each color's real
    entries."""
    dev = device_mod.resolve(device)
    packs = sched.bind(dev).colored
    k = _contributions(sched, ke, dev)
    vals = k.new_zeros(sched.size)
    for c, count in enumerate(sched.color_counts):
        if count == 0:
            continue
        sl = packs.slots[c, :count].long()
        tg = packs.tgts[c, :count].long()
        vals.index_add_(0, tg, k.index_select(0, sl))
    return vals


def scatter_colored(sched: AssemblySchedule, ke, variant: str = "stream",
                    device=None) -> torch.Tensor:
    """Per-color batched conflict-free scatter-add over the schedule's
    bound packs: ``variant`` 'stream' (K13) or 'onehot' (K14) on the card,
    their plain versions on the CPU; 'percolor' selects the
    one-scatter-per-color baseline."""
    if variant == "percolor":
        return scatter_colored_percolor(sched, ke, device=device)
    dev = device_mod.resolve(device)
    packs = sched.bind(dev).colored
    return akern.run_colored(packs, _contributions(sched, ke, dev), variant)


def scatter_sorted(sched: AssemblySchedule, ke,
                   device=None) -> torch.Tensor:
    """Sorted-slot assembly: contributions were argsorted by destination
    at schedule-build time, so the refresh is one color-free gather and
    one segment sum."""
    dev = device_mod.resolve(device)
    perm, targets = sched.bind(dev).sorted
    return akern.sorted_scatter(perm, targets,
                                _contributions(sched, ke, dev), sched.size)


def scatter_private(sched: AssemblySchedule, ke,
                    device=None) -> torch.Tensor:
    """Private-buffer accumulation: each buffer scatter-adds its element
    chunk into its own full-length partial (duplicates within a buffer are
    fine — the buffer is private), all buffers in one batched
    ``index_add_`` into a (B, size + 1) table whose last column takes the
    padding; then the partials are summed (the paper's local-buffers
    strategy)."""
    dev = device_mod.resolve(device)
    slots, index = sched.bind(dev).private
    k = _contributions(sched, ke, dev)
    kpad = torch.cat([k, k.new_zeros(1)])
    B = sched.buffer_elements.shape[0]
    partials = k.new_zeros(B * (sched.size + 1))
    partials.index_add_(0, index, kpad.index_select(0, slots))
    return partials.view(B, sched.size + 1).sum(dim=0)[:sched.size]


def scatter_serial(sched: AssemblySchedule, ke) -> np.ndarray:
    """Serial numpy oracle on the host: element-order ``np.add.at``."""
    if isinstance(ke, torch.Tensor):
        ke = ke.detach().cpu().numpy()
    vals = np.zeros(sched.size, np.float32)
    np.add.at(vals, np.asarray(sched.targets),
              np.asarray(ke, np.float32).reshape(-1))
    return vals


def values_to_csrc(sched: AssemblySchedule, vals) -> CSRC:
    """Split the unified value vector into (ad, al, au) views and wrap the
    schedule's structure on the vector's device — the O(k) value-refresh
    constructor (no copy of the values)."""
    if not isinstance(vals, torch.Tensor):
        vals = torch.from_numpy(np.asarray(vals, np.float32))
    vals = vals.to(torch.float32).contiguous()
    n, k = sched.n, sched.k
    if vals.shape != (sched.size,):
        raise ValueError(f"vals has shape {tuple(vals.shape)}, expected "
                         f"({sched.size},)")
    dev = vals.device
    ia, ja = sched.bind(dev).structure
    al, au = vals[n:n + k], vals[n + k:]
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    return CSRC(n=n, m=n, ad=vals[:n], ia=ia, ja=ja, al=al, au=au,
                iar=torch.zeros(n + 1, dtype=torch.int32, device=dev),
                jar=empty, ar=empty.to(torch.float32),
                numerically_symmetric=bool(k == 0 or torch.equal(al, au)))


def _scatter(sched: AssemblySchedule, k: torch.Tensor, strategy: str,
             variant: str) -> torch.Tensor:
    dev = k.device
    if strategy == "colored":
        return scatter_colored(sched, k, variant=variant, device=dev)
    if strategy == "sorted":
        return scatter_sorted(sched, k, device=dev)
    if strategy == "private":
        return scatter_private(sched, k, device=dev)
    return torch.from_numpy(scatter_serial(sched, k)).to(dev)


def assemble(sched: AssemblySchedule, ke, strategy: str = "colored",
             variant: Optional[str] = None, device=None) -> CSRC:
    """Assemble the global CSRC matrix from per-element dense blocks
    ``ke`` of shape (ne, edof, edof) with the chosen accumulation strategy,
    on ``device`` (default the card).

    This IS the value-refresh fast path: every call reuses the schedule's
    packs, bound to the device once (``BUILD_COUNTS
    ['assembly_value_refresh']`` counts one refresh per call and nothing
    else moves), runs under an obs span, and lands its wall time in
    ``assembly_scatter_seconds{strategy, variant}``.  On the card that
    time ends after a synchronize on an event recorded behind the scatter,
    so it covers the finished device work; the scatter alone, between two
    CUDA events, lands in ``assembly_device_seconds{strategy, variant}``."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy {strategy!r} not in {STRATEGIES}")
    variant = _DEFAULT_VARIANT[strategy] if variant is None else variant
    dev = device_mod.resolve(device)
    t0 = time.perf_counter()
    with obs.span("assembly.value_refresh", strategy=strategy,
                  variant=variant):
        k = _contributions(sched, ke, dev)
        bound = sched.bind(dev)
        bound.structure            # first uploads stay out of the timing
        if strategy != "serial":
            getattr(bound, strategy)
        events = None
        if dev.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record()
        vals = _scatter(sched, k, strategy, variant)
        if events is not None:
            events[1].record()
        M = values_to_csrc(sched, vals)
        if events is not None:
            events[1].synchronize()
    BUILD_COUNTS.inc("assembly_value_refresh")
    obs.histogram("assembly_scatter_seconds", strategy=strategy,
                  variant=variant).observe(time.perf_counter() - t0)
    if events is not None:
        obs.histogram("assembly_device_seconds", strategy=strategy,
                      variant=variant).observe(
                          events[0].elapsed_time(events[1]) / 1e3)
    return M


def assemble_mesh(mesh: Mesh, ke, ndof_per_node: int = 1,
                  strategy: str = "colored", cache=None,
                  num_buffers: int = 8,
                  coloring_provider: str = "greedy", device=None):
    """One-call mesh → CSRC assembly; returns (matrix, schedule) so
    repeated value refreshes reuse the schedule (or pass ``cache=`` and
    the connectivity digest does it for you)."""
    sched = assembly_schedule_for(mesh, ndof_per_node=ndof_per_node,
                                  num_buffers=num_buffers, cache=cache,
                                  coloring_provider=coloring_provider)
    return assemble(sched, ke, strategy=strategy, device=device), sched


# ---------------------------------------------------------------------------
# Predict-then-measure strategy selection
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AssemblyTuneResult:
    """Winner of one assembly strategy tune."""
    strategy: str
    variant: str
    timings_s: Dict[str, float]        # "strategy/variant" -> measured s
    predictions_s: Dict[str, float]    # every priced candidate
    roofline_fraction: Dict[str, float]  # predicted/measured, measured set
    cached: bool                       # True = PlanCache hit, nothing timed

    def key(self) -> str:
        return f"{self.strategy}/{self.variant}"


def _scatter_fn(sched: AssemblySchedule, strategy: str, variant: str):
    """The value-refresh executor of one candidate, on ``k``'s device."""
    if strategy == "colored":
        return lambda k: scatter_colored(sched, k, variant=variant,
                                         device=k.device)
    if strategy == "sorted":
        return lambda k: scatter_sorted(sched, k, device=k.device)
    if strategy == "private":
        return lambda k: scatter_private(sched, k, device=k.device)
    raise ValueError(f"no tunable executor for strategy {strategy!r}")


def _time_scatter(fn, k: torch.Tensor, warmup: int = 2,
                  repeats: int = 5) -> float:
    """Median seconds of ``fn(k)`` by the tuners' timer
    (``device.time_fn``): CUDA events around each call on the card, the
    host clock on the CPU."""
    return device_mod.time_fn(fn, k, warmup=warmup, repeats=repeats)


def tune_assembly(sched: AssemblySchedule, ke, cache=None,
                  measure=None, repeats: int = 5,
                  force: bool = False, device=None) -> AssemblyTuneResult:
    """Pick the assembly (strategy, variant) for this schedule: price the
    whole candidate pool with the cost model's card pricing
    (``cost_model.rank_card_assembly_candidates``, denominators from
    ``calibrate(device)``), measure the cheapest half (plus each
    strategy's best-predicted variant, so no family is pruned unseen) with
    ``device.time_fn``, argmin, and record predicted-vs-measured
    provenance with the denominators priced with.

    The winner persists in the PlanCache under ``asmplan-<schedule key>``
    (the JAX package's record, plus a ``denominators`` field it does not
    read) — a later call with the same cache returns it without timing
    anything.  ``measure(fn, ke)`` is injectable for deterministic tests;
    ``ke`` reaches it as a float32 tensor on ``device`` (default the
    card)."""
    from repro_torch.roofline import cost_model

    plan_key = "asmplan-" + sched.key()
    if cache is not None and not force:
        hit = cache.get_assembly_plan(plan_key)
        if hit is not None:
            return AssemblyTuneResult(
                strategy=hit["strategy"], variant=hit["variant"],
                timings_s=dict(hit.get("timings_s", {})),
                predictions_s=dict(hit.get("predictions_s", {})),
                roofline_fraction=dict(hit.get("roofline_fraction", {})),
                cached=True)

    dev = device_mod.resolve(device)
    den = cost_model.calibrate(dev)
    priced = cost_model.rank_card_assembly_candidates(
        sched, ASSEMBLY_CANDIDATES, den)
    predictions = {f"{s}/{v}": est.predicted_s for (s, v), est in priced}
    ests = {f"{s}/{v}": est for (s, v), est in priced}
    obs.counter("assembly_tuner_candidates_total",
                outcome="enumerated").inc(len(priced))

    pool = [sv for sv, _ in priced]
    chosen = list(pool[:max(2, len(pool) // 2)])
    seen_strategies = {s for s, _ in chosen}
    for s, v in pool:                  # best-predicted variant per family
        if s not in seen_strategies:
            chosen.append((s, v))
            seen_strategies.add(s)

    k = _contributions(sched, ke, dev)
    timings: Dict[str, float] = {}
    for s, v in chosen:
        fn = _scatter_fn(sched, s, v)
        t = (measure(fn, k) if measure is not None
             else _time_scatter(fn, k, repeats=repeats))
        timings[f"{s}/{v}"] = float(t)
    obs.counter("assembly_tuner_candidates_total",
                outcome="measured").inc(len(timings))

    winner = min(timings, key=timings.get)
    fractions = {key: cost_model.roofline_fraction(ests[key], t)
                 for key, t in timings.items() if t > 0}
    ws, wv = winner.split("/")

    result = AssemblyTuneResult(
        strategy=ws, variant=wv, timings_s=timings,
        predictions_s=predictions, roofline_fraction=fractions,
        cached=False)
    if cache is not None:
        cache.put_assembly_plan(plan_key, {
            "strategy": ws, "variant": wv, "timings_s": timings,
            "predictions_s": predictions,
            "roofline_fraction": fractions,
            "denominators": den.to_dict()})
    return result
