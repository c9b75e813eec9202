"""2D simplicial P1 triangles (broken 3-node elements).

Operators are exact per-triangle gradient blocks (3x3), nodal quadrature is
the corner rule (area/3 per vertex). Capability parity with reference
``src/fem2d_P1.jl``; assembly vectorized over the element axis (the blocks
land directly in the (N, 3, 3) batched layout).
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ..ops.blockdiag import BlockDiagHost
from .geometry import Geometry


class FEM2DP1:
    def __init__(self, K: np.ndarray):
        self.K = K
        self.dim = 2

    def default_slack_space(self):
        return "full"


def _p1_operators(x: np.ndarray):
    """Per-triangle dx, dy blocks and corner-rule weights, vectorized.

    ``x`` is (3, N, 2). For triangle with vertices P1,P2,P3 the P1 gradient
    is constant: d/dx weights b_j/det2, d/dy weights c_j/det2 with
    b=(y2-y3, y3-y1, y1-y2), c=(x3-x2, x1-x3, x2-x1), det2 = 2*signed area.
    """
    X, Y = x[:, :, 0], x[:, :, 1]                      # (3, N)
    det2 = ((X[1] - X[0]) * (Y[2] - Y[0]) - (X[2] - X[0]) * (Y[1] - Y[0]))
    b = np.stack([Y[1] - Y[2], Y[2] - Y[0], Y[0] - Y[1]])  # (3, N)
    c = np.stack([X[2] - X[1], X[0] - X[2], X[1] - X[0]])
    N = x.shape[1]
    dx = np.broadcast_to((b / det2).T[:, None, :], (N, 3, 3)).copy()
    dy = np.broadcast_to((c / det2).T[:, None, :], (N, 3, 3)).copy()
    area = np.abs(det2) / 2
    w = np.repeat(area / 3, 3).reshape(N, 3).T.reshape(-1, order="F")
    return dx, dy, w


def _build_geometry_p1(K: np.ndarray, t: np.ndarray | None) -> Geometry:
    dtype = K.dtype
    N = K.shape[1]
    dx, dy, w = _p1_operators(K)
    ident = np.broadcast_to(np.eye(3, dtype=dtype), (N, 3, 3)).copy()
    ops = {"id": BlockDiagHost(ident),
           "dx": BlockDiagHost(dx.astype(dtype)),
           "dy": BlockDiagHost(dy.astype(dtype))}
    return Geometry(FEM2DP1(K), K, w.astype(dtype), ops, t=t)


def fem2d_P1(*, K=None, t=None, dtype=np.float64) -> Geometry:
    """Single-level P1 triangulation; default = unit square, 2 triangles."""
    if K is None:
        K = np.empty((3, 2, 2), dtype=dtype)
        K[:, 0, :] = [[-1, -1], [1, -1], [-1, 1]]
        K[:, 1, :] = [[1, -1], [1, 1], [-1, 1]]
    K = np.asarray(K, dtype=dtype)
    return _build_geometry_p1(K, t)


def boundary_corners(tri_conn: np.ndarray) -> set:
    """Corner ids on the boundary: endpoints of edges used by one triangle
    (vectorized edge counting)."""
    t = np.asarray(tri_conn, dtype=np.int64)
    e = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
    e = np.sort(e, axis=1)
    uniq, cnt = np.unique(e, axis=0, return_counts=True)
    return set(np.unique(uniq[cnt == 1]).tolist())


def find_boundary_p1(geom: Geometry):
    N = geom.x.shape[1]
    labels = geom.t.reshape(-1, order="F")
    tri_conn = geom.t.T
    bset = boundary_corners(tri_conn)
    mask = np.isin(labels, np.fromiter(bset, dtype=np.int64))
    flat = np.flatnonzero(mask)
    return [(int(i % 3), int(i // 3)) for i in flat]


def p1_stiffness(corners: np.ndarray, tri_conn: np.ndarray) -> sp.csr_matrix:
    """Continuous P1 Dirichlet-energy (Neumann) stiffness on the corner mesh."""
    n_v = corners.shape[0]
    tri = tri_conn
    P = corners[tri]                                        # (N, 3, 2)
    x1, y1 = P[:, 0, 0], P[:, 0, 1]
    x2, y2 = P[:, 1, 0], P[:, 1, 1]
    x3, y3 = P[:, 2, 0], P[:, 2, 1]
    det2 = (x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1)
    b = np.stack([y2 - y3, y3 - y1, y1 - y2], axis=1)       # (N, 3)
    c = np.stack([x3 - x2, x1 - x3, x2 - x1], axis=1)
    scale = 1.0 / (2 * np.abs(det2))
    vals = (b[:, :, None] * b[:, None, :] + c[:, :, None] * c[:, None, :]) \
        * scale[:, None, None]
    rows = np.repeat(tri, 3, axis=1).reshape(-1)
    cols = np.tile(tri, (1, 3)).reshape(-1)
    return sp.csr_matrix((vals.reshape(-1), (rows, cols)), shape=(n_v, n_v))


def _corner_doubling_bridge(tri_conn: np.ndarray, n_v: int,
                            interior: np.ndarray, dtype) -> sp.csr_matrix:
    """Interior corners -> doubled per-element corner DOFs (0/1 map)."""
    N = tri_conn.shape[0]
    idx = -np.ones(n_v, dtype=np.int64)
    idx[interior] = np.arange(len(interior))
    flat_c = idx[tri_conn.reshape(-1)]
    rows = np.flatnonzero(flat_c >= 0)
    cols = flat_c[rows]
    return sp.csr_matrix((np.ones(len(rows), dtype=dtype), (rows, cols)),
                         shape=(3 * N, len(interior)))


def amg_p1(geom: Geometry, prolongator, dirichlet_nodes, auxiliary_postprocess):
    from .geometry import unique_coords
    from ..hierarchy.amg_build import (assemble_amg_dicts, assemble_ladder,
                                       pairs_to_linear, run_prolongator)

    dtype = geom.dtype
    N = geom.x.shape[1]
    n_broken = 3 * N
    labels = geom.t.reshape(-1, order="F")
    corners = unique_coords(labels, geom.xflat())
    n_v = corners.shape[0]
    tri_conn = geom.t.T

    K_full = p1_stiffness(corners, tri_conn)
    if auxiliary_postprocess is not None:
        K_full = sp.csr_matrix(auxiliary_postprocess(K_full))

    def hierarchy(interior):
        # row-then-column slicing: scipy's np.ix_ path materializes
        # the full (n, n) index grid (258 GiB at 263k nodes)
        K_loc = K_full[interior][:, interior]
        P_amg = run_prolongator(K_loc, prolongator)
        bridge = _corner_doubling_bridge(tri_conn, n_v, interior, dtype)
        return assemble_ladder(P_amg, bridge, n_broken)

    refine_full, sizes_full = hierarchy(np.arange(n_v))

    def build_dirichlet(nodes):
        dset = set(int(labels[r]) for r in pairs_to_linear(nodes, 3))
        interior = np.array(sorted(set(range(n_v)) - dset), dtype=np.int64)
        refine_dir, sizes_dir = hierarchy(interior)
        K_amg = len(refine_dir) - 1
        sub = [sp.identity(sizes_dir[l], format="csr", dtype=dtype)
               for l in range(K_amg)]
        sub.append(sp.csr_matrix(refine_dir[K_amg - 1]))
        return refine_dir, sub

    return assemble_amg_dicts(geom, n_broken, dirichlet_nodes,
                              refine_full, sizes_full, build_dirichlet)


def refine_p1_connectivity(t: np.ndarray) -> np.ndarray:
    """Topological 4-way red refinement of corner connectivity (3, N).

    Vectorized over elements: midpoint ids come from first-occurrence
    ranking of the sorted edge keys in the (element-major, ab/bc/ca-minor)
    order the sequential registry pass would mint them."""
    from .tensorfem import _first_occurrence_ids

    t = np.asarray(t, dtype=np.int64)
    N = t.shape[1]
    a, b, c = t[0], t[1], t[2]
    pairs = np.stack([np.stack([a, b], 1), np.stack([b, c], 1),
                      np.stack([c, a], 1)], axis=1).reshape(-1, 2)
    keys = np.sort(pairs, axis=1)
    mids = _first_occurrence_ids(keys, int(t.max()) + 1).reshape(N, 3)
    ab, bc, ca = mids[:, 0], mids[:, 1], mids[:, 2]
    out = np.empty((3, 4 * N), dtype=np.int64)
    out[0, 0::4], out[1, 0::4], out[2, 0::4] = a, ab, ca
    out[0, 1::4], out[1, 1::4], out[2, 1::4] = ab, b, bc
    out[0, 2::4], out[1, 2::4], out[2, 2::4] = ca, bc, c
    out[0, 3::4], out[1, 3::4], out[2, 3::4] = ab, bc, ca
    return out


_P1_REFINE = np.array([
    [1, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5],
    [0.5, 0.5, 0], [0, 1, 0], [0, 0.5, 0.5],
    [0.5, 0, 0.5], [0, 0.5, 0.5], [0, 0, 1],
    [0.5, 0.5, 0], [0, 0.5, 0.5], [0.5, 0, 0.5]])


def continuous_p1(t: np.ndarray, dtype=np.float64) -> sp.csr_matrix:
    """Zero-trace continuous P1 embedding into the broken basis."""
    from ..hierarchy.amg_build import continuous_subspace

    labels = t.reshape(-1, order="F")
    n_v = int(labels.max()) + 1
    bset = boundary_corners(t.T)
    return continuous_subspace(labels, n_v, bset, dtype)


def geometric_mg_p1(geom: Geometry, L: int):
    from ..hierarchy.multigrid import MultiGrid

    dtype = geom.dtype
    if L < 1:
        raise ValueError("L must be >= 1")
    meshes = [np.asarray(geom.x, dtype=dtype)]
    topos = [geom.t.copy()]
    for l in range(L - 1):
        Xc = meshes[l]
        Xf = np.empty((3, Xc.shape[1] * 4, 2), dtype=dtype)
        for ch in range(4):
            blk = _P1_REFINE[ch * 3:(ch + 1) * 3, :]
            Xf[:, ch::4, :] = np.einsum("im,mNe->iNe", blk, Xc)
        meshes.append(Xf)
        topos.append(refine_p1_connectivity(topos[l]))

    geomL = geom if L == 1 else _build_geometry_p1(meshes[-1], topos[-1])
    refine = []
    for l in range(L - 1):
        refine.append(sp.block_diag(
            [sp.csr_matrix(_P1_REFINE.astype(dtype))] * meshes[l].shape[1],
            format="csr"))
    refine.append(sp.identity(3 * meshes[-1].shape[1], format="csr",
                              dtype=dtype))
    subspaces = {"dirichlet": [], "full": [], "uniform": []}
    for l in range(L):
        nl = 3 * meshes[l].shape[1]
        subspaces["dirichlet"].append(continuous_p1(topos[l], dtype))
        subspaces["full"].append(sp.identity(nl, format="csr", dtype=dtype))
        subspaces["uniform"].append(sp.csr_matrix(np.ones((nl, 1), dtype=dtype)))
    return MultiGrid.from_subspaces(geomL, subspaces,
                                    {k: refine for k in subspaces})
