"""Chebyshev spectral discretizations (1D and tensor-product 2D).

Dense operators (n-by-n), multigrid levels = polynomial degrees 2, 4, ..., n
with exact polynomial interpolation as transfers, and the zero-trace subspace
built by *basis truncation* (columns T_k - T_{0|1}) rather than node masking.
Capability parity with reference ``src/spectral1d.jl`` / ``src/spectral2d.jl``.

A spectral geometry is the degenerate single-element case of the panel
machinery: one dense (1, n, n) block.
"""
from __future__ import annotations

import numpy as np

from ..ops.blockdiag import BlockDiagHost
from .geometry import Geometry


class Spectral1D:
    def __init__(self, n: int):
        self.n = n
        self.dim = 1

    def default_slack_space(self):
        return "full"


class Spectral2D:
    def __init__(self, n: int):
        self.n = n
        self.dim = 2

    def default_slack_space(self):
        return "full"


def chebyshev_values(x, n: int) -> np.ndarray:
    """T_0..T_{n-1} evaluated at points x: out[q, j] = T_j(x_q)."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    V = np.empty((len(x), n))
    V[:, 0] = 1.0
    if n > 1:
        V[:, 1] = x
        for j in range(2, n):
            V[:, j] = 2 * x * V[:, j - 1] - V[:, j - 2]
    return V


def chebyshev_derivative_matrix(n: int) -> np.ndarray:
    """Coefficient-space differentiation: (D c) are the coefficients of the
    derivative of the polynomial with Chebyshev coefficients c."""
    D = np.zeros((n, n))
    for j in range(n - 1):
        for k in range(j + 1, n, 2):
            D[j, k] = 2 * k
    D[0, :] /= 2
    return D


def clenshaw_curtis_points(n: int):
    """n Chebyshev-Lobatto points on [-1, 1] ascending, with CC weights (sum 2)."""
    from .tensorfem import cheb_lobatto_nodes, clenshaw_curtis_weights

    return cheb_lobatto_nodes(n - 1), clenshaw_curtis_weights(n - 1)


def _spectral1d_levels(n: int, dtype=np.float64):
    """Per-level Chebyshev data: level sizes 2, 4, ..., n.

    Returns (geometry, subspaces dict of dense matrices per level, refine list).
    """
    import scipy.sparse as sp

    L = int(np.ceil(np.log2(n)))
    sizes = [min(n, 2 ** (l + 1)) for l in range(L)]
    xs, dirichlet, full, uniform = [], [], [], []
    M = None
    w = None
    for nl in sizes:
        pts, wl = clenshaw_curtis_points(nl)
        w = wl.astype(dtype)
        xs.append(pts.reshape(-1, 1))
        M = chebyshev_values(pts, nl)
        # zero-trace truncation: columns T_k - T_0 (k even) / T_k - T_1 (k odd)
        CI = M[:, 2:].copy()
        for k in range(CI.shape[1]):
            CI[:, k] -= M[:, 0] if k % 2 == 0 else M[:, 1]
        dirichlet.append(CI.astype(dtype))
        full.append(M.astype(dtype))
        uniform.append(np.ones((nl, 1), dtype=dtype))
    D0 = chebyshev_derivative_matrix(sizes[-1])
    dx = M @ D0 @ np.linalg.inv(M)
    ident = np.eye(sizes[-1])
    refine = []
    for l in range(L - 1):
        refine.append((chebyshev_values(xs[l + 1][:, 0], sizes[l])
                       @ np.linalg.inv(full[l])).astype(dtype))
    refine.append(ident.astype(dtype))

    ops = {"id": BlockDiagHost(ident[None].astype(dtype)),
           "dx": BlockDiagHost(dx[None].astype(dtype))}
    x_fine = xs[-1].reshape(sizes[-1], 1, 1).astype(dtype)
    t = np.arange(sizes[-1], dtype=np.int64).reshape(-1, 1)
    geom = Geometry(Spectral1D(n), x_fine, w, ops, t=t)
    subspaces = {"dirichlet": [sp.csr_matrix(m) for m in dirichlet],
                 "full": [sp.csr_matrix(m) for m in full],
                 "uniform": [sp.csr_matrix(m) for m in uniform]}
    refine_sp = [sp.csr_matrix(m) for m in refine]
    return geom, subspaces, refine_sp


def spectral1d(*, n=16, dtype=np.float64) -> Geometry:
    return _spectral1d_levels(n, dtype)[0]


def spectral1d_multigrid(n: int, dtype=np.float64):
    """MultiGrid for spectral1d (used by hierarchy.amg dispatch)."""
    from ..hierarchy.multigrid import MultiGrid

    geom, subspaces, refine = _spectral1d_levels(n, dtype)
    return MultiGrid.from_subspaces(geom, subspaces,
                                    {k: refine for k in subspaces})


def spectral2d_multigrid(n: int, dtype=np.float64):
    """Tensor-product 2D spectral MultiGrid: R2d[X][l] = kron(R1d, R1d)."""
    import scipy.sparse as sp

    from ..hierarchy.multigrid import MultiGrid

    geom1, subspaces1, refine1 = _spectral1d_levels(n, dtype)
    mg1 = MultiGrid.from_subspaces(geom1, subspaces1,
                                   {k: refine1 for k in subspaces1})
    n1 = geom1.n_nodes
    w1 = geom1.w
    w2 = np.outer(w1, w1).reshape(-1, order="F")
    R2 = {X: [sp.csr_matrix(sp.kron(Rl, Rl)) for Rl in mg1.R[X]]
          for X in mg1.R}
    x1 = geom1.xflat()[:, 0]
    # node (i, j) at flat index i + j*n1: coords (x1[i], x1[j])
    xx = np.empty((n1 * n1, 2), dtype=dtype)
    xx[:, 0] = np.tile(x1, n1)
    xx[:, 1] = np.repeat(x1, n1)
    ID = geom1.operators["id"].data[0]
    DX = geom1.operators["dx"].data[0]
    ops = {"id": BlockDiagHost(np.kron(np.eye(n1), ID)[None].astype(dtype)),
           "dx": BlockDiagHost(np.kron(np.eye(n1), DX)[None].astype(dtype)),
           "dy": BlockDiagHost(np.kron(DX, ID)[None].astype(dtype))}
    x_fine = xx.reshape(n1 * n1, 1, 2)
    t = np.arange(n1 * n1, dtype=np.int64).reshape(-1, 1)
    geom = Geometry(Spectral2D(n), x_fine, w2, ops, t=t)
    return MultiGrid(geom, R2)


def spectral2d(*, n=4, dtype=np.float64) -> Geometry:
    return spectral2d_multigrid(n, dtype).geometry


def find_boundary_spectral1d(geom: Geometry):
    n = geom.discretization.n
    return [(0, 0), (n - 1, 0)]


def find_boundary_spectral2d(geom: Geometry):
    n = geom.discretization.n
    out = []
    for j in range(n):
        for i in range(n):
            if i in (0, n - 1) or j in (0, n - 1):
                out.append((j * n + i, 0))
    return out
