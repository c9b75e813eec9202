"""Linear inequality constraints: A(x) y[idx] + b(x) > 0 componentwise.

Barrier: -sum(log(F_i)). Mirrors reference ``src/convex_linear.jl:87-223``.
A is (nc, ni) per node (stored row-major flattened), b is (nc,) per node.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops import ddarray
from ..ops.ddarray import cat
from ..utils.log import Log
from ._common import (resolve_x, sample_grid, comp, ssum, svec, smat,
                      mat_scalars, vec_scalars, scatter_svec, scatter_smat)
from .convex import Convex, input_spec_from_idx


def convex_linear(mg=None, *, idx=None, A=None, b=None,
                  A_grid=None, b_grid=None, x=None, dtype=None):
    if dtype is None:
        from .._config import default_dtype

        dtype = default_dtype()
    xs = resolve_x(mg) if x is None else np.asarray(x)
    n = xs.shape[0]
    idx_t = None if idx is None else tuple(int(i) for i in idx)

    if A_grid is None:
        if A is None:
            if idx_t is None:
                raise ValueError("idx=None with identity A cannot determine the "
                                 "constraint size; pass idx, A, or A_grid")
            ni = len(idx_t)
            A_grid = np.tile(np.eye(ni, dtype=dtype).reshape(1, -1), (n, 1))
            nc = ni
        else:
            A0 = np.asarray(A(xs[0]), dtype=dtype)
            nc, ni = A0.shape
            A_grid = sample_grid(lambda xi: np.asarray(A(xi), dtype=dtype).reshape(-1),
                                 xs, dtype)
    else:
        A_grid = np.asarray(A_grid, dtype=dtype)
        if b_grid is None and not callable(b):
            raise ValueError("explicit A_grid needs b_grid (or callable b) to fix nc")
        nc = None
        ni = None

    if b_grid is None:
        if b is None:
            b_grid = np.zeros((n, nc), dtype=dtype)
        else:
            b0 = np.asarray(b(xs[0]))
            if b0.ndim == 0:
                if nc is None:
                    raise ValueError("scalar-valued b needs A (or idx) to fix nc")
                b_grid = np.tile(
                    np.zeros((1, nc), dtype=dtype), (n, 1))
                for i in range(n):
                    b_grid[i, :] = b(xs[i])
            else:
                b_grid = sample_grid(lambda xi: np.asarray(b(xi), dtype=dtype), xs, dtype)
    else:
        b_grid = np.asarray(b_grid, dtype=dtype)
    nc = b_grid.shape[1]
    if A_grid.shape[1] % nc != 0:
        raise ValueError(
            f"A_grid has {A_grid.shape[1]} columns/node, not a multiple of nc={nc}")
    ni = A_grid.shape[1] // nc
    if idx_t is not None and ni != len(idx_t):
        raise ValueError(f"A implies ni={ni} but len(idx)={len(idx_t)}")

    spec = input_spec_from_idx(idx_t, ni)

    def _parts(A_row, b_row, y):
        """Scalar-list form (see convex/_common.py): A nested scalars,
        F a list of nc scalars."""
        A = mat_scalars(A_row, nc, ni)
        ys = vec_scalars(y, n=ni, idx=idx_t)
        F = [ssum([A[i][j] * ys[j] for j in range(ni)]) + comp(b_row, i)
             for i in range(nc)]
        return A, F

    def F0(A_row, b_row, y):
        _, F = _parts(A_row, b_row, y)
        return -ssum([Log(Fi) for Fi in F])

    def F1(A_row, b_row, y):
        A, F = _parts(A_row, b_row, y)
        invF = [1.0 / Fi for Fi in F]
        g = [-ssum([A[k][i] * invF[k] for k in range(nc)])
             for i in range(ni)]
        return scatter_svec(idx_t, g, y.shape[0])

    def F2(A_row, b_row, y):
        A, F = _parts(A_row, b_row, y)
        iF2 = [1.0 / (Fi * Fi) for Fi in F]
        H = [[ssum([A[k][i] * A[k][j] * iF2[k] for k in range(nc)])
              for j in range(ni)] for i in range(ni)]
        return scatter_smat(idx_t, H, y.shape[0])

    def C0(A_row, b_row, yhat):
        _, F = _parts(A_row, b_row, yhat)
        slack = comp(yhat, -1)
        return -ssum([Log(Fi + slack) for Fi in F])

    def C1(A_row, b_row, yhat):
        A, F = _parts(A_row, b_row, yhat)
        slack = comp(yhat, -1)
        invF = [1.0 / (Fi + slack) for Fi in F]
        g = [-ssum([A[k][i] * invF[k] for k in range(nc)])
             for i in range(ni)]
        out = scatter_svec(idx_t, g, yhat.shape[0] - 1)
        return cat([out, (-ssum(invF))[None]])

    def C2(A_row, b_row, yhat):
        A, F = _parts(A_row, b_row, yhat)
        slack = comp(yhat, -1)
        inv = [1.0 / (Fi + slack) for Fi in F]
        iF2 = [vi * vi for vi in inv]
        H = [[ssum([A[k][i] * A[k][j] * iF2[k] for k in range(nc)])
              for j in range(ni)] for i in range(ni)]
        cross = [ssum([A[k][i] * iF2[k] for k in range(nc)])
                 for i in range(ni)]
        N1 = yhat.shape[0]
        ii = tuple(range(N1 - 1)) if idx_t is None else idx_t
        pos = {int(j): k for k, j in enumerate(ii)}
        zero = ddarray.zeros((), like=iF2[0])
        rows = []
        for i in range(N1 - 1):
            row = [H[pos[i]][pos[j]] if i in pos and j in pos else zero
                   for j in range(N1 - 1)]
            row.append(cross[pos[i]] if i in pos else zero)
            rows.append(row)
        rows.append([cross[pos[j]] if j in pos else zero
                     for j in range(N1 - 1)] + [ssum(iF2)])
        return smat(rows)

    def Slack(A_row, b_row, y):
        _, F = _parts(A_row, b_row, y)
        import functools

        return -functools.reduce(jnp.minimum, F)

    return Convex(
        args=(jnp.asarray(A_grid), jnp.asarray(b_grid)),
        barrier=(F0, F1, F2),
        cobarrier=(C0, C1, C2),
        slack=Slack,
        input_spec=spec,
    )
