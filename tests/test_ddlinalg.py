"""Blocked dd Cholesky / triangular solve (ops/ddlinalg.py) vs f64 oracles.

The blocked forms route their trailing updates through the Ozaki split
GEMM; accuracy must match the rolled elementwise-EFT forms (dd grade,
~2^-40 of the matrix scale after a full factorization). Oracle bars are
set for CPU: XLA:CPU jit wobbles EFT compositions at ~eps(f32) in some
fusion patterns, so bars sit well above 2^-48 but far below f32.
"""
import numpy as np
import jax.numpy as jnp

from mgbtpu.ops.df64 import f64_split
from mgbtpu.ops.ddlinalg import (dd_cholesky, dd_tri_solve_right,
                                 dd_tri_solve_left, _BLOCK)


def _spd(rng, Bk, n, cond=1e6):
    Q, _ = np.linalg.qr(rng.standard_normal((Bk, n, n)))
    ev = np.logspace(0, -np.log10(cond), n)
    return np.einsum("bij,j,bkj->bik", Q, ev, Q)


def test_blocked_cholesky_oracle():
    rng = np.random.default_rng(0)
    Bk, n = 3, 100                      # crosses several _BLOCK panels
    assert n > 2 * _BLOCK
    A = _spd(rng, Bk, n)
    Ah, Al = map(jnp.asarray, f64_split(A))
    Lh, Ll = dd_cholesky(Ah, Al)
    L = np.asarray(Lh, np.float64) + np.asarray(Ll, np.float64)
    # L L^T == A to dd grade; strictly upper part zero
    err = np.abs(L @ np.swapaxes(L, -1, -2) - A).max()
    assert err <= 1e-10, err
    assert np.abs(np.triu(L, 1)).max() == 0.0


def test_blocked_tri_solve_right_oracle():
    rng = np.random.default_rng(1)
    Bk, n, m = 2, 90, 37
    A = _spd(rng, Bk, n)
    L = np.linalg.cholesky(A)
    B = rng.standard_normal((Bk, m, n))
    Lh, Ll = map(jnp.asarray, f64_split(L))
    Bh, Bl = map(jnp.asarray, f64_split(B))
    Xh, Xl = dd_tri_solve_right(Lh, Ll, Bh, Bl)
    X = np.asarray(Xh, np.float64) + np.asarray(Xl, np.float64)
    want = np.linalg.solve(
        np.swapaxes(L, -1, -2)[:, None].repeat(1, 1),
        np.swapaxes(B, -1, -2)).swapaxes(-1, -2) \
        if False else B @ np.linalg.inv(np.swapaxes(L, -1, -2))
    err = np.abs(X - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= 1e-9, err


def test_blocked_vs_rolled_consistency():
    """The blocked path must agree with the rolled path to dd grade on the
    same inputs (they are algebraically identical factorizations)."""
    from mgbtpu.ops.ddlinalg import (_dd_cholesky_rolled,
                                     _dd_tri_solve_right_rolled)

    rng = np.random.default_rng(2)
    Bk, n = 2, 80
    A = _spd(rng, Bk, n, cond=1e4)
    Ah, Al = map(jnp.asarray, f64_split(A))
    Lb = dd_cholesky(Ah, Al)
    Lr = _dd_cholesky_rolled(Ah, Al)
    b = (np.asarray(Lb[0], np.float64) + np.asarray(Lb[1], np.float64))
    r = (np.asarray(Lr[0], np.float64) + np.asarray(Lr[1], np.float64))
    assert np.abs(b - r).max() <= 1e-11 * np.abs(r).max()


def test_rolled_panel_inverse_f64_oracle():
    """The dd diagonal-panel factor + inverse (rolled Cholesky, then the
    triangular inverse) against the float64 inverse Cholesky factor, on
    ill-conditioned panels and small widths: within the kappa-scaled dd
    floor, strictly lower triangular."""
    from mgbtpu.ops import df64
    from mgbtpu.ops import ddlinalg as ddl

    rng = np.random.default_rng(5)
    for B, n, cond in ((3, 32, 1e8), (2, 17, 1e4), (130, 32, 1e6),
                       (5, 3, 1e4), (64, 9, 1e6)):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        lam = np.geomspace(1.0, 1.0 / cond, n)
        A = (Q * lam) @ Q.T
        A = A[None] * np.exp(rng.uniform(-2, 2, (B, 1, 1)))
        Ah, Al = map(jnp.asarray, df64.f64_split(A, dtype=np.float32))
        L = ddl._dd_cholesky_rolled(Ah, Al)
        Xh, Xl = ddl.dd_tri_inverse(L[0], L[1])
        X = np.asarray(Xh, np.float64) + np.asarray(Xl, np.float64)
        Ad = np.asarray(Ah, np.float64) + np.asarray(Al, np.float64)
        Lnp = np.linalg.cholesky(Ad)
        Xnp = np.stack([np.linalg.solve(Lnp[b], np.eye(n))
                        for b in range(B)])
        e_ref = np.abs(X - Xnp).max() / np.abs(Xnp).max()
        floor = 64 * 2.0 ** -47 * cond + 1e-13
        assert e_ref < floor, (B, n, e_ref, floor)
        iu = np.triu_indices(n, k=1)
        assert np.abs(X[:, iu[0], iu[1]]).max() == 0.0


def test_dd_solve_matches_f64_solve():
    """A float32 + double-float mgb_solve lands on the float64 solution
    (both solve to tol = sqrt(eps(f64)))."""
    from mgbtpu import amg, assemble, fem2d_P1, mgb_solve, subdivide

    def solve(dtype):
        return mgb_solve(assemble(amg(subdivide(fem2d_P1(dtype=dtype), 2)),
                                  p=1.0, dtype=dtype)).z

    z32 = solve(np.float32)
    z64 = solve(np.float64)
    assert np.isfinite(z32).all()
    assert np.abs(z32.astype(np.float64) - z64).max() < 1e-5
