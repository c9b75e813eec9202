"""Euclidean power cone: {y : s >= ||q||_2^p}, [q; s] = A(x) y[idx] + b(x).

Barrier: -log(s^(2/p) - ||q||^2) - mu(p) log(s), with mu = 0 for p in {1, 2},
1 for p < 2, 2 for p > 2 (mu precomputed per node on host). Gradient and
Hessian are hand-coded closed forms; tests cross-check them against
``jax.grad``/``jax.hessian`` (the reference does the same with symmetry
checks). Mirrors reference ``src/convex_euclidian_power.jl`` (functors at
lines 66-253, constructor at 352-453).

Per-node functions are pure and shape-static; they vmap over the node axis
and fuse into the surrounding barrier einsums under jit.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..ops import ddarray
from ..ops.ddarray import cat
from ..utils.log import Log, safe_pow
from ._common import (resolve_x, sample_grid, comp, ssum, svec, smat,
                      mat_scalars, vec_scalars, scatter_svec, scatter_smat)
from .convex import Convex, input_spec_from_idx


def _mu_of_p(p):
    p = np.asarray(p, dtype=np.float64)
    mu = np.where(p < 2.0, 1.0, 2.0)
    mu = np.where((p == 1.0) | (p == 2.0), 0.0, mu)
    return mu


def _core_parts(A_row, b_row, idx, y):
    """Per-node affine image z = A y[idx] + b in scalar-list form: ``A``
    nested scalars, ``q`` a list of nz-1 scalars, ``s`` a scalar (the
    scalar-list algebra of convex/_common.py)."""
    nz = b_row.shape[0]
    A = mat_scalars(A_row, nz, nz)
    ys = vec_scalars(y, n=nz, idx=idx)
    z = [ssum([A[i][j] * ys[j] for j in range(nz)]) + comp(b_row, i)
         for i in range(nz)]
    return A, z[:-1], z[-1]


def _pow_alpha(s, alpha, spec):
    """s^alpha with safe_pow semantics (0 for s <= 0). ``spec`` is the
    STATIC specialization: alpha == 2 (p = 1, the headline p-Laplacian) and
    alpha == 1 (p = 2) avoid the transcendental exp/log chain entirely —
    on the dd path each safe_pow is a ~600-flop dd_log+dd_exp chain per
    node per evaluation, and it dominated both run time and XLA compile."""
    from ..ops import ddarray

    if spec == 2.0:
        return ddarray.where(ddarray.hi(s) > 0, s * s,
                             ddarray.zeros(getattr(s, "shape", ()), like=s))
    if spec == 1.0:
        return ddarray.where(ddarray.hi(s) > 0, s,
                             ddarray.zeros(getattr(s, "shape", ()), like=s))
    return safe_pow(s, alpha)


def _core_grad(q, s, p0, mu, spec=None):
    """Gradient of the barrier wrt (q, s), scalar-list form (q a list, s a
    scalar; returns list of nz scalars). Reference
    src/convex_euclidian_power.jl:387-397.

    Only one transcendental power is evaluated: s^(alpha-1) = s^alpha / s
    (exact division is far cheaper than a second exp/log chain, which matters
    for the double-float path where each safe_pow is a ~dd_log+dd_exp chain).
    """
    alpha = 2.0 / p0
    q_sq = ssum([qi * qi for qi in q])
    s_a = _pow_alpha(s, alpha, spec)
    r = s_a - q_sq
    inv_r = 1.0 / r
    two_ir = 2.0 * inv_r
    grad_q = [two_ir * qi for qi in q]
    s_am1 = s_a / s
    grad_s = -alpha * s_am1 * inv_r - mu / s
    return grad_q + [grad_s]


def _core_hess(q, s, p0, mu, spec=None):
    """Hessian of the barrier wrt (q, s), scalar-list form (nested list of
    nz x nz scalars). Reference src/convex_euclidian_power.jl:400-433.

    The power ladder comes from one safe_pow by exact division, and the
    Hessian is built from the FACTORED quantities u = q/r, v = s^(a-1)/r
    (Hqq = 4 u u' + (2/r) I, cross = -2a v u, Hss = -a(a-1) s^(a-2)/r +
    a^2 v^2 + mu/s^2): near the deep-t central path nodes with vanishing
    gradient have s ~ 1/t and r ~ s^2, so the unfactored 1/r^2 ~ 1e35
    exceeds the float32 Dekker-split range (f32max/4097) and the dd
    products NaN out, while every factored intermediate stays ~1e18.
    """
    alpha = 2.0 / p0
    q_sq = ssum([qi * qi for qi in q])
    s_a = _pow_alpha(s, alpha, spec)
    r = s_a - q_sq
    inv_r = 1.0 / r
    s_am1 = s_a / s
    s_am2 = s_am1 / s
    u = [inv_r * qi for qi in q]
    v = s_am1 * inv_r
    H_ss = (-alpha * (alpha - 1.0) * s_am2 * inv_r
            + (alpha * alpha) * (v * v) + (mu / s) / s)
    two_ir = 2.0 * inv_r
    n = len(q)
    cross = [(-2.0 * alpha * v) * ui for ui in u]
    rows = []
    for i in range(n):
        row = [4.0 * u[i] * u[j] + two_ir if i == j else 4.0 * u[i] * u[j]
               for j in range(n)]
        rows.append(row + [cross[i]])
    rows.append(cross + [H_ss])
    return rows


def convex_euclidian_power(mg=None, *, idx=None, A=None, b=None, p=2.0,
                           A_grid=None, b_grid=None, p_grid=None,
                           x=None, dtype=None):
    """Build the Euclidean-power-cone Convex.

    Parameters mirror the reference constructor: ``idx`` is a tuple of 0-based
    positions into the per-node input vector y = Dz (None = all rows);
    ``A(x)->(nz,nz)``, ``b(x)->(nz,) or scalar``, ``p(x)->scalar`` (or a plain
    number) are sampled at the mesh nodes unless pre-built grids are passed.
    """
    if dtype is None:
        from .._config import default_dtype

        dtype = default_dtype()
    xs = resolve_x(mg) if x is None else np.asarray(x)
    n = xs.shape[0]

    idx_t = None if idx is None else tuple(int(i) for i in idx)

    # ---- grids -----------------------------------------------------------
    if A_grid is None:
        if idx_t is not None:
            nz = len(idx_t)
        else:
            if A is None:
                raise ValueError("idx=None needs a matrix-valued A (or A_grid) "
                                 "to determine the constraint dimension")
            nz = np.asarray(A(xs[0])).shape[0]
        if A is None:
            A_grid = np.tile(np.eye(nz, dtype=dtype).reshape(1, -1), (n, 1))
        else:
            A_grid = sample_grid(lambda xi: np.asarray(A(xi), dtype=dtype).reshape(-1),
                                 xs, dtype)
    else:
        A_grid = np.asarray(A_grid, dtype=dtype)
        nz = int(round(np.sqrt(A_grid.shape[1])))
        if nz * nz != A_grid.shape[1]:
            raise ValueError("A_grid columns must be a square count nz^2")
    if idx_t is not None and len(idx_t) != nz:
        raise ValueError(f"len(idx)={len(idx_t)} but A implies nz={nz}")

    if b_grid is None:
        if b is None:
            b_grid = np.zeros((n, nz), dtype=dtype)
        else:
            b0 = np.asarray(b(xs[0]))
            if b0.ndim == 0:
                # scalar b lands in the s slot (last), zeros elsewhere
                def bfn(xi):
                    out = np.zeros((nz,), dtype=dtype)
                    out[-1] = b(xi)
                    return out
                b_grid = sample_grid(bfn, xs, dtype)
            else:
                b_grid = sample_grid(lambda xi: np.asarray(b(xi), dtype=dtype), xs, dtype)
    else:
        b_grid = np.asarray(b_grid, dtype=dtype)
    if b_grid.shape[1] != nz:
        raise ValueError(f"b_grid has {b_grid.shape[1]} values/node, need nz={nz}")

    if p_grid is None:
        if callable(p):
            p_grid = sample_grid(lambda xi: np.asarray(p(xi), dtype=dtype), xs, dtype)[:, 0]
        else:
            p_grid = np.full((n,), float(p), dtype=dtype)
    else:
        p_grid = np.asarray(p_grid, dtype=dtype)
    mu_grid = _mu_of_p(p_grid).astype(dtype)
    # static alpha specialization: constant p with alpha = 2/p in {1, 2}
    # (p = 2 and the headline p = 1) skips the transcendental power chain
    spec_alpha = None
    if p_grid.size and np.all(p_grid == p_grid.flat[0]):
        a0 = 2.0 / float(p_grid.flat[0])
        if a0 in (1.0, 2.0):
            spec_alpha = a0

    spec = input_spec_from_idx(idx_t, nz)

    # ---- per-node functions ---------------------------------------------
    # p is promoted to DD alongside a DD y: alpha = 2/p must carry more than
    # f32 bits or its rounding alone injects ~1e-7 relative error into
    # s^alpha (the reference computes alpha in Float64)
    def _pp(p_val, y):
        # promoted to DD alongside a DD y (alpha = 2/p must carry more than
        # f32 bits), EXCEPT when the static specialization fixes alpha to an
        # exact small integer
        if spec_alpha is None and isinstance(y, ddarray.DD) \
                and not isinstance(p_val, ddarray.DD):
            return ddarray.DD(p_val)
        return p_val

    def _AtHA(A, Hz):
        """A^T Hz A in nested-scalar form (nz is tiny and static)."""
        nz_ = len(A)
        return [[ssum([A[k][i] * Hz[k][l] * A[l][j]
                       for k in range(nz_) for l in range(nz_)])
                 for j in range(nz_)] for i in range(nz_)]

    def F0(A_row, b_row, p_val, mu_val, y):
        _, q, s = _core_parts(A_row, b_row, idx_t, y)
        alpha = 2.0 / _pp(p_val, y)
        q_sq = ssum([qi * qi for qi in q])
        return -Log(_pow_alpha(s, alpha, spec_alpha) - q_sq) \
            - mu_val * Log(s)

    def F1(A_row, b_row, p_val, mu_val, y):
        A, q, s = _core_parts(A_row, b_row, idx_t, y)
        gz = _core_grad(q, s, _pp(p_val, y), mu_val, spec=spec_alpha)
        nz_ = len(A)
        g = [ssum([A[k][i] * gz[k] for k in range(nz_)])
             for i in range(nz_)]
        return scatter_svec(idx_t, g, y.shape[0])

    def F2(A_row, b_row, p_val, mu_val, y):
        A, q, s = _core_parts(A_row, b_row, idx_t, y)
        Hz = _core_hess(q, s, _pp(p_val, y), mu_val, spec=spec_alpha)
        return scatter_smat(idx_t, _AtHA(A, Hz), y.shape[0])

    # cobarrier: y carries an appended slack; s_eff = s + slack
    def _co_parts(A_row, b_row, yhat):
        A, q, s = _core_parts(A_row, b_row, idx_t, yhat)
        return A, q, s + comp(yhat, -1)

    def C0(A_row, b_row, p_val, mu_val, yhat):
        _, q, s = _co_parts(A_row, b_row, yhat)
        alpha = 2.0 / _pp(p_val, yhat)
        q_sq = ssum([qi * qi for qi in q])
        return -Log(_pow_alpha(s, alpha, spec_alpha) - q_sq) \
            - mu_val * Log(s)

    def C1(A_row, b_row, p_val, mu_val, yhat):
        A, q, s = _co_parts(A_row, b_row, yhat)
        gz = _core_grad(q, s, _pp(p_val, yhat), mu_val, spec=spec_alpha)
        nz_ = len(A)
        g = [ssum([A[k][i] * gz[k] for k in range(nz_)])
             for i in range(nz_)]
        out = scatter_svec(idx_t, g, yhat.shape[0] - 1)
        return cat([out, gz[-1][None]])

    def C2(A_row, b_row, p_val, mu_val, yhat):
        A, q, s = _co_parts(A_row, b_row, yhat)
        Hz = _core_hess(q, s, _pp(p_val, yhat), mu_val, spec=spec_alpha)
        H = _AtHA(A, Hz)
        nz_ = len(A)
        # cross = A^T Hz[:, -1] (the slack couples through s only)
        cross = [ssum([A[k][i] * Hz[k][nz_ - 1] for k in range(nz_)])
                 for i in range(nz_)]
        N1 = yhat.shape[0]
        ii = tuple(range(N1 - 1)) if idx_t is None else idx_t
        pos = {int(j): k for k, j in enumerate(ii)}
        zero = ddarray.zeros((), like=Hz[0][0])
        rows = []
        for i in range(N1 - 1):
            row = [H[pos[i]][pos[j]] if i in pos and j in pos else zero
                   for j in range(N1 - 1)]
            row.append(cross[pos[i]] if i in pos else zero)
            rows.append(row)
        rows.append([cross[pos[j]] if j in pos else zero
                     for j in range(N1 - 1)] + [Hz[nz_ - 1][nz_ - 1]])
        return smat(rows)

    def Slack(A_row, b_row, p_val, mu_val, y):
        _, q, s = _core_parts(A_row, b_row, idx_t, y)
        q_sq = ssum([qi * qi for qi in q])
        return -jnp.minimum(s - safe_pow(q_sq, p_val / 2.0), s)

    return Convex(
        args=(jnp.asarray(A_grid), jnp.asarray(b_grid),
              jnp.asarray(p_grid), jnp.asarray(mu_grid)),
        barrier=(F0, F1, F2),
        cobarrier=(C0, C1, C2),
        slack=Slack,
        input_spec=spec,
    )
