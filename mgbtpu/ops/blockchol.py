"""Blocked dense Cholesky + SPD inverse with O(1) program size.

XLA's CholeskyExpander / TriangularSolveExpander unroll their blocked
loops on backends without a library Cholesky, and a `cho_solve(cf, eye)`
explicit inverse materializes every intermediate panel of the n-RHS
triangular solve. The frozen dense preconditioner built per centering
(solver/newton.py) stacks several of these, so the program size grew with
n. On the GPU `lax.linalg.cholesky` is a cuSOLVER call; whether this module
still pays there is not yet measured.

Here the right-looking blocked factorization is a ``lax.fori_loop`` over
column blocks (dynamic slices into a padded buffer; the trailing SYRK is a
full-width masked update — ~3x the minimal FLOPs, all matmul, still O(n^3))
and the inverse is a ``lax.scan`` over 256-column identity blocks through
two fixed-width triangular solves. Program size is independent of n
and compile is seconds.

Replaces the cuDSS analysis+factor role of the reference's CUDA extension
(``ext/MultiGridBarrierCUDAExt/cudss_solver.jl:49-408``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def blocked_cholesky(A, block=512):
    """Lower Cholesky factor of PSD ``A`` (n, n); NaNs propagate from a
    non-PD pivot block exactly like ``lax.linalg.cholesky``."""
    n = A.shape[0]
    if n <= block:
        return lax.linalg.cholesky(A)
    nb = -(-n // block)
    npad = nb * block
    Ap = jnp.zeros((npad, npad), A.dtype).at[:n, :n].set(A)
    if npad > n:
        pad_idx = jnp.arange(n, npad)
        Ap = Ap.at[pad_idx, pad_idx].set(1.0)
    rows = jnp.arange(npad)

    def body(j, L):
        j0 = j * block
        Ajj = lax.dynamic_slice(L, (j0, j0), (block, block))
        Ljj = lax.linalg.cholesky(Ajj)
        strip = lax.dynamic_slice(L, (0, j0), (npad, block))
        sol = lax.linalg.triangular_solve(
            Ljj, strip, left_side=False, lower=True, transpose_a=True)
        below = (rows >= j0 + block)[:, None]
        newstrip = jnp.where(below, sol, 0.0)
        newstrip = lax.dynamic_update_slice(newstrip, Ljj, (j0, 0))
        L = lax.dynamic_update_slice(L, newstrip, (0, j0))
        # trailing SYRK: P is zero outside rows >= j0+block, so P P^T only
        # touches the trailing submatrix
        P = jnp.where(below, newstrip, 0.0)
        return L - jax.lax.dot(P, P.T, precision=jax.lax.Precision.HIGHEST)

    L = lax.fori_loop(0, nb, body, Ap)
    return jnp.tril(L[:n, :n])


def blocked_tril_inverse(L, block=512):
    """L^-1 for lower-triangular L by blocked forward substitution on an
    identity RHS: per row-block one small (block x block) triangular solve
    plus full-width matmuls — no n-dependent expander code (XLA's
    TriangularSolveExpander unrolls over n: a (5120, 512)-RHS solve alone
    was ~30 MB of code)."""
    n = L.shape[0]
    nb = -(-n // block)
    npad = nb * block
    Lp = jnp.zeros((npad, npad), L.dtype).at[:n, :n].set(L)
    if npad > n:
        pad_idx = jnp.arange(n, npad)
        Lp = Lp.at[pad_idx, pad_idx].set(1.0)
    eye_b = jnp.eye(block, dtype=L.dtype)
    cols = jnp.arange(npad)

    def body(i, X):
        i0 = i * block
        Lii = lax.dynamic_slice(Lp, (i0, i0), (block, block))
        Linv_ii = lax.linalg.triangular_solve(
            Lii, eye_b, left_side=True, lower=True)
        strip = lax.dynamic_slice(Lp, (i0, 0), (block, npad))   # L[i, :]
        strip = jnp.where((cols < i0)[None, :], strip, 0.0)     # L[i, :i]
        rhs = -jax.lax.dot(strip, X, precision=jax.lax.Precision.HIGHEST)
        rhs = lax.dynamic_update_slice(
            rhs, eye_b + lax.dynamic_slice(rhs, (0, i0), (block, block)),
            (0, i0))
        Xi = jax.lax.dot(Linv_ii, rhs,
                         precision=jax.lax.Precision.HIGHEST)
        return lax.dynamic_update_slice(X, Xi, (i0, 0))

    X = lax.fori_loop(0, nb, body, jnp.zeros((npad, npad), L.dtype))
    return X[:n, :n]


def spd_inverse_from_chol(L, block=512):
    """(L L^T)^-1 = (L^-1)^T (L^-1): blocked triangular inversion + one
    SYRK-shaped matmul."""
    X = blocked_tril_inverse(L, block=block)
    return jax.lax.dot(X.T, X, precision=jax.lax.Precision.HIGHEST)


def shifted_spd_inverse(Hmat, shifts=(2.0, 32.0)):
    """Equilibrated shifted-Cholesky explicit inverse: the frozen dense
    preconditioner core. Returns (Minv, dinv) with
    M = dinv * Hmat * dinv + shift*eps*I (the smallest finite shift of the
    ladder wins) and Minv = M^-1.

    The regularization shift directly floors the preconditioned spectrum
    (kappa_pre ~ shift / lambda_min), so prefer the smallest shift whose
    factorization stays finite; the explicit inverse turns preconditioner
    applications into matmuls instead of latency-bound triangular
    solves."""
    import numpy as _np

    dtype = Hmat.dtype
    eps = float(_np.finfo(_np.dtype(dtype)).eps)
    d = jnp.sqrt(jnp.abs(jnp.diagonal(Hmat)))
    dinv = jnp.where(d > 0, 1.0 / d, 1.0)
    Hs = Hmat * (dinv[:, None] * dinv[None, :])
    eye = jnp.eye(Hmat.shape[0], dtype=dtype)
    L = blocked_cholesky(Hs + jnp.asarray(shifts[0] * eps, dtype) * eye)
    for c in shifts[1:]:
        # lax.cond executes only the needed branch: the larger-shift
        # factorization costs nothing at runtime when the first succeeded
        # (the common case)
        L = lax.cond(
            jnp.all(jnp.isfinite(L)),
            lambda L=L: L,
            lambda c=c: blocked_cholesky(
                Hs + jnp.asarray(c * eps, dtype) * eye))
    return spd_inverse_from_chol(L), dinv
