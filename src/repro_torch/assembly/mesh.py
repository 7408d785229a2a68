"""Structured meshes and deterministic element stiffness synthesis.

The paper's CSRC format exists to hold *global finite-element matrices*;
this module supplies the FEM-shaped inputs the assembly subsystem
(docs/DESIGN.md §5) consumes: small structured 2D/3D meshes with
tri/quad/tet connectivity and per-element dense stiffness matrices.

Element stiffness entries are **quantized to multiples of 1/64** (dyadic
rationals).  Dyadic values of moderate magnitude are exact in float32 and
their sums are exact *regardless of accumulation order*, so the colored,
private-buffer, and serial assembly strategies (assembly/scatter.py) are
required to agree **bit-for-bit** — the strongest possible race detector:
any write conflict or dropped contribution changes the result exactly,
never "within tolerance".

Generators:

  grid_tri   2D triangle mesh (each grid cell split along its diagonal)
  grid_quad  2D bilinear quad mesh
  grid_tet   3D tetrahedral mesh (Kuhn triangulation: 6 tets per cube)

Stiffness synthesis:

  poisson_stiffness    exact P1/Q1 Laplacian element matrices (+ optional
                       lumped-mass shift so the global matrix is SPD and
                       CG converges — the assemble→tune→solve demo)
  synthetic_stiffness  seeded random symmetric element blocks, optionally
                       vector-valued (ndof_per_node=2/3 — the elasticity
                       shape: dofs interleave per node)

Pure numpy, this package's own copy of the JAX package's module: the
connectivity and stiffness arrays are equal to its, draw for draw.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np

QUANTUM = 64                    # stiffness entries are multiples of 1/QUANTUM


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A conforming mesh: node coordinates + element connectivity."""

    name: str
    dim: int
    coords: np.ndarray          # (num_nodes, dim) float64
    conn: np.ndarray            # (ne, nen) int32 node ids per element

    @property
    def num_nodes(self) -> int:
        return int(self.coords.shape[0])

    @property
    def ne(self) -> int:
        return int(self.conn.shape[0])

    @property
    def nen(self) -> int:
        return int(self.conn.shape[1])


def _grid_nodes_2d(nx: int, ny: int) -> np.ndarray:
    xs, ys = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1))
    return np.stack([xs.reshape(-1), ys.reshape(-1)], axis=1).astype(
        np.float64)


def _cell_corners_2d(nx: int, ny: int):
    """Node ids of each cell's (v00, v10, v11, v01) corners."""
    x, y = np.meshgrid(np.arange(nx), np.arange(ny))
    x, y = x.reshape(-1), y.reshape(-1)
    stride = nx + 1
    v00 = y * stride + x
    return v00, v00 + 1, v00 + stride + 1, v00 + stride


def grid_quad(nx: int, ny: int = 0) -> Mesh:
    """Bilinear quads on an nx×ny unit grid."""
    ny = nx if ny == 0 else ny
    v00, v10, v11, v01 = _cell_corners_2d(nx, ny)
    conn = np.stack([v00, v10, v11, v01], axis=1).astype(np.int32)
    return Mesh(name=f"quad{nx}x{ny}", dim=2,
                coords=_grid_nodes_2d(nx, ny), conn=conn)


def grid_tri(nx: int, ny: int = 0) -> Mesh:
    """P1 triangles: each unit cell split along the (v00, v11) diagonal."""
    ny = nx if ny == 0 else ny
    v00, v10, v11, v01 = _cell_corners_2d(nx, ny)
    lower = np.stack([v00, v10, v11], axis=1)
    upper = np.stack([v00, v11, v01], axis=1)
    conn = np.concatenate([lower, upper]).astype(np.int32)
    return Mesh(name=f"tri{nx}x{ny}", dim=2,
                coords=_grid_nodes_2d(nx, ny), conn=conn)


def grid_tet(nx: int, ny: int = 0, nz: int = 0) -> Mesh:
    """P1 tetrahedra: Kuhn triangulation, 6 tets per unit cube (one per
    monotone lattice path from corner 000 to corner 111)."""
    ny = nx if ny == 0 else ny
    nz = nx if nz == 0 else nz
    xs, ys, zs = np.meshgrid(np.arange(nx + 1), np.arange(ny + 1),
                             np.arange(nz + 1), indexing="ij")
    coords = np.stack([xs.reshape(-1), ys.reshape(-1), zs.reshape(-1)],
                      axis=1).astype(np.float64)

    def node(ix, iy, iz):
        return (ix * (ny + 1) + iy) * (nz + 1) + iz

    cx, cy, cz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    cx, cy, cz = cx.reshape(-1), cy.reshape(-1), cz.reshape(-1)
    origin = node(cx, cy, cz)
    steps = {0: node(cx + 1, cy, cz) - origin,
             1: node(cx, cy + 1, cz) - origin,
             2: node(cx, cy, cz + 1) - origin}
    tets = []
    for perm in itertools.permutations((0, 1, 2)):
        v0 = origin
        v1 = v0 + steps[perm[0]]
        v2 = v1 + steps[perm[1]]
        v3 = v2 + steps[perm[2]]
        # odd permutations yield negatively-oriented tets; swap the last
        # two vertices so every element volume is positive
        parity = sum(1 for a in range(3) for b in range(a + 1, 3)
                     if perm[a] > perm[b]) % 2
        order = (v0, v1, v3, v2) if parity else (v0, v1, v2, v3)
        tets.append(np.stack(order, axis=1))
    conn = np.concatenate(tets).astype(np.int32)
    return Mesh(name=f"tet{nx}x{ny}x{nz}", dim=3, coords=coords, conn=conn)


# The benchmark/CI mesh suite: one entry per generator, parameterized by a
# common size knob (tet scales down — 6 elements per cube).  The assembly
# benchmark iterates this table, so a new generator added here is
# benchmarked and oracle-checked with no benchmark edits.
MESH_GENERATORS = (
    ("tri", lambda s: grid_tri(s)),
    ("quad", lambda s: grid_quad(s)),
    ("tet", lambda s: grid_tet(max(2, s // 3))),
)


# ---------------------------------------------------------------------------
# Element stiffness synthesis
# ---------------------------------------------------------------------------

def quantize(ke: np.ndarray, quantum: int = QUANTUM) -> np.ndarray:
    """Round to multiples of 1/quantum: every entry (and every partial sum
    of the assembly scatter) is exact in float32, making strategy-vs-oracle
    comparisons bit-for-bit instead of tolerance-based."""
    return (np.round(np.asarray(ke, np.float64) * quantum) / quantum).astype(
        np.float32)


def element_volumes(mesh: Mesh) -> np.ndarray:
    """Per-element area (2D) / volume (3D), positive for the generators
    above (a mesh-sanity invariant the tests assert)."""
    pts = mesh.coords[mesh.conn]                 # (ne, nen, dim)
    if mesh.nen == 3:                            # triangle
        e1 = pts[:, 1] - pts[:, 0]
        e2 = pts[:, 2] - pts[:, 0]
        return 0.5 * (e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])
    if mesh.nen == 4 and mesh.dim == 2:          # unit quad cells
        return np.ones(mesh.ne)
    if mesh.nen == 4 and mesh.dim == 3:          # tetrahedron
        e = pts[:, 1:] - pts[:, :1]              # (ne, 3, 3)
        return np.linalg.det(e) / 6.0
    raise ValueError(f"unsupported element ({mesh.nen} nodes, "
                     f"dim {mesh.dim})")


def _simplex_stiffness(mesh: Mesh) -> np.ndarray:
    """P1 stiffness on simplices: ke = V · (∇φ_a · ∇φ_b).  Gradients come
    from inverting the edge matrix, vectorized over elements."""
    pts = mesh.coords[mesh.conn]                 # (ne, nen, dim)
    d = mesh.dim
    edges = pts[:, 1:] - pts[:, :1]              # (ne, d, d)
    inv = np.linalg.inv(edges)                   # rows: dual basis
    grads = np.concatenate([-inv.sum(axis=2, keepdims=True).transpose(
        0, 2, 1), inv.transpose(0, 2, 1)], axis=1)       # (ne, nen, d)
    vol = np.abs(element_volumes(mesh))[:, None, None]
    return vol * np.einsum("ead,ebd->eab", grads, grads)


# Q1 Laplacian on the unit square, node order (v00, v10, v11, v01): the
# standard analytic element matrix (1/6)·[[4,-1,-2,-1],...].
_Q1_KE = np.asarray([[4, -1, -2, -1],
                     [-1, 4, -1, -2],
                     [-2, -1, 4, -1],
                     [-1, -2, -1, 4]], np.float64) / 6.0


def poisson_stiffness(mesh: Mesh, mass: float = 0.0,
                      quantum: int = QUANTUM) -> np.ndarray:
    """Laplacian element matrices (ne, nen, nen), float32 dyadic.

    ``mass`` adds a lumped-mass shift ``mass·V/nen`` to the diagonal —
    the assembled matrix becomes SPD (the pure Neumann Laplacian has the
    constant null vector), which is what the assemble→tune→solve CG demo
    needs.
    """
    if mesh.nen == 4 and mesh.dim == 2:
        ke = np.broadcast_to(_Q1_KE, (mesh.ne, 4, 4)).copy()
    else:
        ke = _simplex_stiffness(mesh)
    if mass:
        vol = np.abs(element_volumes(mesh))
        lump = mass * vol[:, None] / mesh.nen
        idx = np.arange(mesh.nen)
        ke[:, idx, idx] += lump
    return quantize(ke, quantum)


def synthetic_stiffness(mesh: Mesh, ndof_per_node: int = 1, seed: int = 0,
                        quantum: int = QUANTUM) -> np.ndarray:
    """Deterministic seeded symmetric element blocks (ne, edof, edof) with
    edof = nen·ndof_per_node.  ``ndof_per_node > 1`` gives the elasticity
    shape: vector-valued dofs interleaved per node (see
    ``conflict.element_dofs``).  Diagonally shifted so the assembled global
    matrix is positive definite."""
    rng = np.random.default_rng(seed)
    edof = mesh.nen * ndof_per_node
    B = rng.standard_normal((mesh.ne, edof, edof))
    ke = np.einsum("eab,ecb->eac", B, B) / edof
    idx = np.arange(edof)
    ke[:, idx, idx] += 2.0 * edof
    return quantize(ke, quantum)
