"""Shared helpers for the convex-set constructors (host-side sampling)."""
from __future__ import annotations

import numpy as np


def resolve_x(mg):
    """Flat (n_nodes, dim) node coordinates from a MultiGrid/Geometry/array."""
    if mg is None:
        raise ValueError("a mesh (mg=) or explicit grids are required")
    if hasattr(mg, "geometry"):
        g = mg.geometry
    else:
        g = mg
    if hasattr(g, "xflat"):
        return np.asarray(g.xflat())
    return np.asarray(mg)


def sample_grid(fn, x, dtype, width=None):
    """Sample closure ``fn(x_row)`` over nodes into an (n, width) grid."""
    from ..utils.maps import sample_rows

    return sample_rows(fn, x, dtype, width=width)


def scatter_vec(idx, vals, N):
    """Scatter a gradient over selected positions into a length-N vector.

    ``idx=None`` is the identity (Colon semantics). Mirrors reference
    ``_scatter_gradient`` (``src/convex_linear.jl:237-249``). DD-aware
    (double-float values scatter componentwise).

    The indices are STATIC Python ints and N is tiny (the per-node
    component count), so the scatter is built from slices + concatenate:
    no scatter HLO at all.
    """
    from ..ops.ddarray import cat, zeros

    if idx is None:
        return vals
    pos = {int(j): k for k, j in enumerate(np.asarray(idx))}
    parts = [vals[pos[j]:pos[j] + 1] if j in pos
             else zeros((1,), like=vals) for j in range(N)]
    return cat(parts)


def scatter_mat(idx, H, N):
    """Scatter a Hessian over selected positions into an N-by-N matrix.

    ``idx=None`` is the identity. Mirrors reference ``_scatter_hessian``
    (``src/convex_linear.jl:258-280``). DD-aware; static slice/concatenate
    construction like ``scatter_vec``.
    """
    from ..ops.ddarray import cat, zeros

    if idx is None:
        return H
    pos = {int(j): k for k, j in enumerate(np.asarray(idx))}
    rows = []
    for j in range(N):
        r = scatter_vec(idx, H[pos[j]], N) if j in pos \
            else zeros((N,), like=H)
        rows.append(r.reshape(1, N))
    return cat(rows, axis=0)


def gather(idx, y):
    """y[idx] with static 0-based indices; identity for idx=None.

    Static slices + concatenate, not a gather op (see scatter_vec)."""
    from ..ops.ddarray import cat

    if idx is None:
        return y
    return cat([y[int(i):int(i) + 1] for i in np.asarray(idx)])


def comp(x, j):
    """Static scalar component ``x[j]`` of a 1D (DD or plain) vector via
    slice + reshape: jnp lowers integer indexing to a gather under vmap;
    a static slice stays a slice.
    """
    j = int(j) % x.shape[0]
    return x[j:j + 1].reshape(())


# ---------------------------------------------------------------------------
# Scalar-list algebra for the per-node barrier functions.
#
# The constraint dimension nz is tiny and STATIC, so per-node vectors and
# matrices are carried as Python lists of () scalars: under vmap each scalar
# is a clean vector over the nodes, and the whole evaluation lowers to
# elementwise ops + slices + concatenates (per-node reshape(nz, nz) /
# matmul / einsum would lower to minor-dim shape casts and high-rank
# broadcasts).
# DD-transparent: the scalars may be double-float.
# ---------------------------------------------------------------------------

def ssum(parts):
    """Sum of a list of scalars (left fold, DD-aware)."""
    import functools
    import operator

    return functools.reduce(operator.add, parts)


def svec(parts):
    """(n,) vector from a list of () scalars (expand + concatenate)."""
    from ..ops.ddarray import cat

    return cat([p[None] for p in parts])


def smat(rows):
    """(nr, nc) matrix from a nested list of () scalars."""
    from ..ops.ddarray import cat

    return cat([svec(r)[None] for r in rows], axis=0)


def mat_scalars(A_row, nr, nc):
    """Row-major flat per-node matrix -> nested list of () scalars."""
    return [[comp(A_row, i * nc + j) for j in range(nc)] for i in range(nr)]


def vec_scalars(v, n=None, idx=None):
    """1D vector -> list of () scalars (optionally gathered by static idx)."""
    if idx is not None:
        return [comp(v, int(i)) for i in idx]
    return [comp(v, j) for j in range(n if n is not None else v.shape[0])]


def scatter_svec(idx, vals, N):
    """List-of-scalars scatter into an (N,) vector; idx=None = identity."""
    from ..ops.ddarray import zeros

    if idx is None:
        return svec(vals)
    pos = {int(j): k for k, j in enumerate(np.asarray(idx))}
    zero = zeros((), like=vals[0])
    return svec([vals[pos[j]] if j in pos else zero for j in range(N)])


def scatter_smat(idx, H, N):
    """Nested-list scatter into an (N, N) matrix; idx=None = identity."""
    from ..ops.ddarray import zeros

    if idx is None:
        return smat(H)
    pos = {int(j): k for k, j in enumerate(np.asarray(idx))}
    zero = zeros((), like=H[0][0])
    return smat([[H[pos[i]][pos[j]] if i in pos and j in pos else zero
                  for j in range(N)] for i in range(N)])
