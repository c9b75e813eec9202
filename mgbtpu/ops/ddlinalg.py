"""Batched dense linear algebra in double-float (f32 hi/lo pairs).

The f32 multifrontal factors are shift-limited: the 2*eps(f32) shift on
the equilibrated barrier Hessian swamps lambda_min ~ 1/t at deep t, and
the preconditioned CG degenerates (measured: 1000-2800 CG its per ramp
step at t >= 8e5, ~75%% of all linear-solve work). Factoring in dd
resolves to ~2^-48 * kappa ~ 2e-4 at the target t = 6.7e7, so the
corrector converges in a few iterations at every ramp depth.

All routines are ROLLED (lax.fori_loop over columns with dynamic slices):
program size is O(1) in the matrix dimension — the XLA expanders' unrolled
code bloat is what ops/blockchol.py exists to avoid, and dd needs custom
loops anyway. Everything is elementwise work (error-free transforms use
no matmuls); batching over the leading axis provides the parallelism.
"""
from __future__ import annotations

import os as _os

import jax
import jax.numpy as jnp
from jax import lax

from . import df64


# panel width of the blocked (GEMM-update) factorizations. Tunable
# (MGBTPU_DD_BLOCK) for latency A/Bs: the P-form substitutions run in
# ceil(n/_BLOCK) SEQUENTIAL steps, so a wider panel trades per-step size
# for a shorter sequential chain.
_BLOCK = int(_os.environ.get("MGBTPU_DD_BLOCK", 32))


def dd_cholesky(Ah, Al):
    """Batched lower Cholesky of SPD dd matrices (B, n, n) -> dd (Lh, Ll).

    Above ``_BLOCK`` columns: recursive right-looking blocked form — rolled
    panel factor + panel solve (elementwise, O(n^2 w)) with the trailing
    Schur update as an Ozaki split GEMM (``dd_syrk_sub`` dispatch).
    Static shapes throughout (python recursion, depth n/w). At or below
    ``_BLOCK``: the rolled one-column-per-step form below.
    """
    n = Ah.shape[-1]
    if n > _BLOCK:
        w = _BLOCK
        L11 = dd_cholesky(Ah[:, :w, :w], Al[:, :w, :w])
        if TRI_INV or TRI_PANEL:
            # panel inverse (NS GEMMs) -> L21 = A21 L11^-T as one GEMM
            # instead of a w-step rolled substitution
            Li11 = dd_tri_inverse(L11[0], L11[1])
            L21 = dd_matmul_nt_any((Ah[:, w:, :w], Al[:, w:, :w]), Li11)
        else:
            L21 = dd_tri_solve_right(L11[0], L11[1],
                                     Ah[:, w:, :w], Al[:, w:, :w])
        Sh, Sl = dd_syrk_sub(Ah[:, w:, w:], Al[:, w:, w:], L21[0], L21[1])
        L22 = dd_cholesky(Sh, Sl)
        zh = jnp.zeros(Ah[:, :w, w:].shape, Ah.dtype)
        top_h = jnp.concatenate([L11[0], zh], axis=2)
        top_l = jnp.concatenate([L11[1], zh], axis=2)
        bot_h = jnp.concatenate([L21[0], L22[0]], axis=2)
        bot_l = jnp.concatenate([L21[1], L22[1]], axis=2)
        return (jnp.concatenate([top_h, bot_h], axis=1),
                jnp.concatenate([top_l, bot_l], axis=1))
    return _dd_cholesky_rolled(Ah, Al)


def _dd_cholesky_rolled(Ah, Al):
    B, n, _ = Ah.shape
    rows = jnp.arange(n)

    def body(j, carry):
        Lh, Ll = carry
        # pivot d = A[j, j]
        piv_h = lax.dynamic_slice(Lh, (0, j, j), (B, 1, 1))[:, 0, 0]
        piv_l = lax.dynamic_slice(Ll, (0, j, j), (B, 1, 1))[:, 0, 0]
        sh, sl = df64.dd_sqrt((piv_h, piv_l))
        inv_h, inv_l = df64.dd_recip((sh, sl))
        # column j (full height, masked to rows >= j)
        ch = lax.dynamic_slice(Lh, (0, 0, j), (B, n, 1))[:, :, 0]
        cl = lax.dynamic_slice(Ll, (0, 0, j), (B, n, 1))[:, :, 0]
        below = rows[None, :] >= j
        colh, coll = df64.dd_mul((ch, cl), (inv_h[:, None], inv_l[:, None]))
        colh = jnp.where(below, colh, 0.0)
        coll = jnp.where(below, coll, 0.0)
        # exact diagonal: L[j, j] = s
        colh = colh.at[:, j].set(sh)
        coll = coll.at[:, j].set(sl)
        # trailing update A[j+1:, j+1:] -= col col^T (strictly-below mask)
        strict = rows[None, :] > j
        uh = jnp.where(strict, colh, 0.0)
        ul = jnp.where(strict, coll, 0.0)
        oh, ol = df64.dd_mul((uh[:, :, None], ul[:, :, None]),
                             (uh[:, None, :], ul[:, None, :]))
        Lh2, Ll2 = df64.dd_sub((Lh, Ll), (oh, ol))
        # write column j, keep columns < j, zero column entries above diag
        keep = (jnp.arange(n)[None, None, :] != j)
        Lh2 = jnp.where(keep, Lh2, colh[:, :, None])
        Ll2 = jnp.where(keep, Ll2, coll[:, :, None])
        return (Lh2, Ll2)

    Lh, Ll = lax.fori_loop(0, n, body, (Ah, Al))
    tril = rows[:, None] >= rows[None, :]
    return jnp.where(tril, Lh, 0.0), jnp.where(tril, Ll, 0.0)


def dd_cholesky_pform(Ah, Al):
    """Batched lower Cholesky of SPD dd matrices, returned directly in the
    partitioned-inverse (P-) form of ``dd_tri_pinv``: inverted ``_BLOCK``
    diagonal panels in place, off-diagonal L kept. Same math as
    ``dd_tri_pinv(*dd_cholesky(Ah, Al))``.

    ROLLED over panels (``lax.fori_loop`` + dynamic slices): a Python
    recursion emits one full panel-step's code per ``_BLOCK`` columns
    (at fem2d_P2 L=5 the ND leaf level, amax 149, put 5 identical
    ~3k-line blocks into every Newton/ramp program). The rolled body
    updates the FULL trailing matrix under a mask each step
    (k * n^2 w = n^3 MAC flops vs n^3/3 for the shrinking recursion);
    the extra MACs ride the Ozaki GEMMs and are negligible against the
    sequential-latency-bound panel factors."""
    B, n, _ = Ah.shape
    if n <= _BLOCK:
        return _panel_inverse(Ah, Al)
    w = _BLOCK
    k = -(-n // w)
    N = k * w
    if N != n:
        Ah, Al = _pad_pform_spd(Ah, Al, n, N)
    rows = jnp.arange(N)
    Mh, Ml = lax.fori_loop(0, k, _pform_body_factory(B, N, w, rows), (Ah, Al))
    tril = rows[:, None] >= rows[None, :]
    Mh = jnp.where(tril, Mh, 0.0)
    Ml = jnp.where(tril, Ml, 0.0)
    return Mh[:, :n, :n], Ml[:, :n, :n]


def _panel_factor(Dh, Dl):
    """Factor one batch of diagonal panels (B, w, w) -> dd lower L.

    "rolled" (default): the one-column-per-step dd loop — ~60 primitive
    HLOs per column on the critical path, the measured latency bill of
    the whole ND factorization at the small-batch top tree levels.
    "ir": f32-seeded Newton refinement on the factor equation
    (``dd_cholesky_ir``) — all batched GEMMs, ~4x fewer sequential ops,
    but requires kappa(panel) below ~2^21 (the seed's f32 floor must
    contract); panels beyond that leave a garbage factor the CG counts
    expose. Opt-in via MGBTPU_DD_PANEL=ir for A/Bs."""
    if PANEL_MODE == "ir":
        return dd_cholesky_ir(Dh, Dl, steps=PANEL_IR_STEPS)
    return _dd_cholesky_rolled(Dh, Dl)


def _panel_inverse(Dh, Dl):
    """Inverted-factor form of one batch of diagonal panels:
    (B, w, w) dd SPD -> dd L^-1 (lower)."""
    Lp = _panel_factor(Dh, Dl)
    return dd_tri_inverse(Lp[0], Lp[1])


def _pform_body_factory(B, N, w, rows):
    def body(i, carry):
        Mh, Ml = carry
        Dh = lax.dynamic_slice(Mh, (0, i * w, i * w), (B, w, w))
        Dl = lax.dynamic_slice(Ml, (0, i * w, i * w), (B, w, w))
        Li = _panel_inverse(Dh, Dl)
        Ch = lax.dynamic_slice(Mh, (0, 0, i * w), (B, N, w))
        Cl = lax.dynamic_slice(Ml, (0, 0, i * w), (B, N, w))
        below = (rows >= (i + 1) * w)[None, :, None]
        Ch = jnp.where(below, Ch, 0.0)
        Cl = jnp.where(below, Cl, 0.0)
        L21h, L21l = dd_matmul_nt_any((Ch, Cl), Li)
        L21h = jnp.where(below, L21h, 0.0)
        L21l = jnp.where(below, L21l, 0.0)
        colh = lax.dynamic_update_slice(L21h, Li[0], (0, i * w, 0))
        coll = lax.dynamic_update_slice(L21l, Li[1], (0, i * w, 0))
        Mh = lax.dynamic_update_slice(Mh, colh, (0, 0, i * w))
        Ml = lax.dynamic_update_slice(Ml, coll, (0, 0, i * w))
        Sh, Sl = dd_matmul_nt_any((L21h, L21l), (L21h, L21l))
        keep = below & jnp.swapaxes(below, 1, 2)
        Th, Tl = df64.dd_sub((Mh, Ml), (Sh, Sl))
        Mh = jnp.where(keep, Th, Mh)
        Ml = jnp.where(keep, Tl, Ml)
        return (Mh, Ml)

    return body


def _pad_pform_spd(Ah, Al, n, N):
    """Pad a (B, n, n) SPD dd matrix to (B, N, N) with an identity tail
    block so padded panels factor to identity and decouple."""
    pad = N - n
    Ah = jnp.pad(Ah, ((0, 0), (0, pad), (0, pad)))
    Al = jnp.pad(Al, ((0, 0), (0, pad), (0, pad)))
    tail = jnp.arange(n, N)
    Ah = Ah.at[:, tail, tail].set(1.0)
    return Ah, Al


def dd_tri_solve_right(Lh, Ll, Bh, Bl):
    """Solve X L^T = B for X (batched): L dd lower (Bk, n, n), B dd
    (Bk, m, n).

    Above ``_BLOCK``: recursive blocked forward substitution — the
    off-diagonal update X1 L21^T rides the Ozaki GEMM; panels solve
    with the rolled column loop below."""
    n = Bh.shape[-1]
    if n > _BLOCK:
        from .ozaki import dd_matmul_nt

        w = _BLOCK
        X1 = dd_tri_solve_right(Lh[:, :w, :w], Ll[:, :w, :w],
                                Bh[:, :, :w], Bl[:, :, :w])
        upd = dd_matmul_nt(X1, (Lh[:, w:, :w], Ll[:, w:, :w]))
        B2h, B2l = df64.dd_sub((Bh[:, :, w:], Bl[:, :, w:]), upd)
        X2 = dd_tri_solve_right(Lh[:, w:, w:], Ll[:, w:, w:], B2h, B2l)
        return (jnp.concatenate([X1[0], X2[0]], axis=2),
                jnp.concatenate([X1[1], X2[1]], axis=2))
    return _dd_tri_solve_right_rolled(Lh, Ll, Bh, Bl)


def _dd_tri_solve_right_rolled(Lh, Ll, Bh, Bl):
    Bk, m, n = Bh.shape

    def body(j, carry):
        Xh, Xl = carry
        # X[:, :, j] = (B[:, :, j] - sum_{i<j} X[:, :, i] L[j, i]) / L[j, j]
        Lrow_h = lax.dynamic_slice(Lh, (0, j, 0), (Bk, 1, n))[:, 0, :]
        Lrow_l = lax.dynamic_slice(Ll, (0, j, 0), (Bk, 1, n))[:, 0, :]
        mask = (jnp.arange(n) < j)[None, :]
        Lrow_h = jnp.where(mask, Lrow_h, 0.0)
        Lrow_l = jnp.where(mask, Lrow_l, 0.0)
        # acc = X[:, :, :] . Lrow  (only columns < j are nonzero in Lrow)
        ph, pe = df64.dd_mul((Xh, Xl),
                             (Lrow_h[:, None, :], Lrow_l[:, None, :]))
        ah, al = df64.dd_tree_sum((ph, pe), axis=2)
        bh = lax.dynamic_slice(Bh, (0, 0, j), (Bk, m, 1))[:, :, 0]
        bl = lax.dynamic_slice(Bl, (0, 0, j), (Bk, m, 1))[:, :, 0]
        rh, rl = df64.dd_sub((bh, bl), (ah, al))
        piv_h = lax.dynamic_slice(Lh, (0, j, j), (Bk, 1, 1))[:, 0, 0]
        piv_l = lax.dynamic_slice(Ll, (0, j, j), (Bk, 1, 1))[:, 0, 0]
        ih, il = df64.dd_recip((piv_h, piv_l))
        xh, xl = df64.dd_mul((rh, rl), (ih[:, None], il[:, None]))
        keep = (jnp.arange(n)[None, None, :] != j)
        Xh = jnp.where(keep, Xh, xh[:, :, None])
        Xl = jnp.where(keep, Xl, xl[:, :, None])
        return (Xh, Xl)

    Z = jnp.zeros_like(Bh)
    Xh, Xl = lax.fori_loop(0, n, body, (Z, Z))
    return Xh, Xl


def dd_tri_solve_left(Lh, Ll, bh, bl, transpose=False):
    """Solve L y = b (or L^T y = b) for dd vectors: L (Bk, n, n),
    b (Bk, n). Rolled forward/back substitution."""
    Bk, n = bh.shape
    idx = jnp.arange(n)

    def fwd(j, carry):
        yh, yl = carry
        Lrow_h = lax.dynamic_slice(Lh, (0, j, 0), (Bk, 1, n))[:, 0, :]
        Lrow_l = lax.dynamic_slice(Ll, (0, j, 0), (Bk, 1, n))[:, 0, :]
        mask = (idx < j)[None, :]
        ph, pe = df64.dd_mul((jnp.where(mask, Lrow_h, 0.0),
                              jnp.where(mask, Lrow_l, 0.0)), (yh, yl))
        ah, al = df64.dd_tree_sum((ph, pe), axis=1)
        rbh = lax.dynamic_slice(bh, (0, j), (Bk, 1))[:, 0]
        rbl = lax.dynamic_slice(bl, (0, j), (Bk, 1))[:, 0]
        rh, rl = df64.dd_sub((rbh, rbl), (ah, al))
        piv_h = lax.dynamic_slice(Lh, (0, j, j), (Bk, 1, 1))[:, 0, 0]
        piv_l = lax.dynamic_slice(Ll, (0, j, j), (Bk, 1, 1))[:, 0, 0]
        qh, ql = df64.dd_div((rh, rl), (piv_h, piv_l))
        return (yh.at[:, j].set(qh), yl.at[:, j].set(ql))

    def bwd(jj, carry):
        yh, yl = carry
        j = n - 1 - jj
        Lcol_h = lax.dynamic_slice(Lh, (0, 0, j), (Bk, n, 1))[:, :, 0]
        Lcol_l = lax.dynamic_slice(Ll, (0, 0, j), (Bk, n, 1))[:, :, 0]
        mask = (idx > j)[None, :]
        ph, pe = df64.dd_mul((jnp.where(mask, Lcol_h, 0.0),
                              jnp.where(mask, Lcol_l, 0.0)), (yh, yl))
        ah, al = df64.dd_tree_sum((ph, pe), axis=1)
        rbh = lax.dynamic_slice(bh, (0, j), (Bk, 1))[:, 0]
        rbl = lax.dynamic_slice(bl, (0, j), (Bk, 1))[:, 0]
        rh, rl = df64.dd_sub((rbh, rbl), (ah, al))
        piv_h = lax.dynamic_slice(Lh, (0, j, j), (Bk, 1, 1))[:, 0, 0]
        piv_l = lax.dynamic_slice(Ll, (0, j, j), (Bk, 1, 1))[:, 0, 0]
        qh, ql = df64.dd_div((rh, rl), (piv_h, piv_l))
        return (yh.at[:, j].set(qh), yl.at[:, j].set(ql))

    Z = jnp.zeros_like(bh)
    if transpose:
        return lax.fori_loop(0, n, bwd, (Z, Z))
    return lax.fori_loop(0, n, fwd, (Z, Z))


def dd_syrk_sub(Ch, Cl, Uh, Ul):
    """C - U U^T in dd (batched): U (Bk, m, n), C (Bk, m, m).

    Large inner dimensions go through the Ozaki split GEMM path
    (ops/ozaki.py): exact bf16 matmuls + compensated combine; the
    elementwise error-free form below stays for small fronts (slicing
    overhead) and as the oracle in tests."""
    from .ozaki import OZAKI_MIN_INNER, dd_syrk_ozaki

    if Uh.shape[-1] >= OZAKI_MIN_INNER:
        return dd_syrk_ozaki((Ch, Cl), (Uh, Ul))
    return dd_syrk_sub_vpu(Ch, Cl, Uh, Ul)


def dd_syrk_sub_vpu(Ch, Cl, Uh, Ul):
    """Elementwise-EFT reference form of ``dd_syrk_sub`` (O(m^2 n))."""
    ph, pe = df64.dd_mul((Uh[:, :, None, :], Ul[:, :, None, :]),
                         (Uh[:, None, :, :], Ul[:, None, :, :]))
    sh, sl = df64.dd_tree_sum((ph, pe), axis=3)
    return df64.dd_sub((Ch, Cl), (sh, sl))


# ---------------------------------------------------------------------------
# Triangular inverses. The rolled substitutions above are O(n) SEQUENTIAL
# steps of tiny elementwise work, pure in-program latency. Two ways to buy
# that back with inverses:
#
#   "1"      store the FULL explicit inverse L^-1 (Newton-Schulz GEMMs)
#            and apply by one dd GEMV. Fast but NUMERICALLY UNSAFE
#            at depth: the *application* y = L^-1 r cancels — its error
#            is ~eps_dd * ||L^-1|| * ||r|| >> eps_dd * ||y|| when
#            kappa(L) is large, and no NS step count fixes it (measured:
#            |I - M A| plateaus at 3.8e-3 on a kappa=1e10 SPD probe vs
#            2.4e-5 for substitution; at fem2d_P2 L=6 the ramp CG total
#            blew up 127 -> 1907).
#   "panel"  (default) PARTITIONED INVERSE: keep L's off-diagonal blocks
#            and invert only the diagonal _BLOCK x _BLOCK panels in
#            place. Applies run panel-by-panel — the inter-panel updates
#            multiply by L entries (backward stable) and only the w-sized
#            panel inverses are applied explicitly, so the measured
#            quality matches substitution (probe: 3.5e-5 vs 2.4e-5)
#            while the sequential depth drops n -> ceil(n/_BLOCK) and
#            the factor-time panel solves stay one Ozaki GEMM each.
#   "0"      pure rolled substitution (oracle/fallback).
# ---------------------------------------------------------------------------

# diagonal-panel factor mode for the P-form factorization (see
# _panel_factor): "rolled" (default, XLA fori column loop) or "ir"
# (GEMM-form Newton-IR seed).
PANEL_MODE = _os.environ.get("MGBTPU_DD_PANEL", "rolled")
PANEL_IR_STEPS = int(_os.environ.get("MGBTPU_DD_PANEL_IR_STEPS", 3))

TRI_MODE = _os.environ.get("MGBTPU_DD_TRI_INV", "panel")
TRI_INV = TRI_MODE == "1"
TRI_PANEL = TRI_MODE not in ("0", "1")
# Newton-Schulz iteration count for the explicit (panel) inverses. The
# f32 triangular-solve seed has residual ~eps32 * kappa(panel); each NS
# step squares it, so 2 steps reach the dd floor for every panel the dd
# factorization can represent. Extra steps measurably do NOT improve the
# full-inverse apply (the plateau above is application rounding, not
# inverse quality).
NS_STEPS = int(_os.environ.get("MGBTPU_DD_NS_STEPS", 2))


def dd_matmul_nt_any(A, B):
    """dd A @ B^T for A (..., m, n), B (..., p, n): Ozaki split GEMM above
    OZAKI_MIN_INNER inner dim, elementwise-EFT form below."""
    from .ozaki import OZAKI_MIN_INNER, dd_matmul_nt

    if A[0].shape[-1] >= OZAKI_MIN_INNER:
        return dd_matmul_nt(A, B)
    ph, pe = df64.dd_mul((A[0][..., :, None, :], A[1][..., :, None, :]),
                         (B[0][..., None, :, :], B[1][..., None, :, :]))
    return df64.dd_tree_sum((ph, pe), axis=-1)


def dd_gemv(A, x, transpose=False):
    """Batched dd matvec: A dd (Bk, n, m), x dd (Bk, m) -> dd (Bk, n)
    (or A^T x for ``transpose``). One dd_mul + one tree-sum — a single
    fused op chain instead of an O(n) substitution loop."""
    Ah, Al = A
    xh, xl = x
    if transpose:
        ph, pe = df64.dd_mul((Ah, Al), (xh[:, :, None], xl[:, :, None]))
        return df64.dd_tree_sum((ph, pe), axis=1)
    ph, pe = df64.dd_mul((Ah, Al), (xh[:, None, :], xl[:, None, :]))
    return df64.dd_tree_sum((ph, pe), axis=2)


def dd_spd_inverse(Ah, Al, tol=2.0 ** -40, max_steps=24,
                   sigma_rel=16 * 2.0 ** -23):
    """Batched dd inverse of SPD (Bk, n, n) — the all-GEMM front kernel.

    Seed: one native batched f32 Cholesky of the SHIFTED matrix
    A + sigma*I (sigma = ``sigma_rel`` * max diag keeps the f32
    factorization unconditionally PD), f32 triangular inverse, M0 = Li^T
    Li. Refinement: Newton-Schulz M <- M (2I - A M) with both products in
    dd (Ozaki split GEMMs). The shifted seed converges GLOBALLY for
    SPD A: eigenvalues of A M0 are lam/(lam+sigma) in (0,1), so the
    residual contracts as (sigma/(lam+sigma))^(2^k) — about
    log2(33 * sigma/lambda_min) steps to the dd floor, i.e. ~16 steps at
    the measured deep-t lambda_min ~ 1.7e-10 and 5-8 steps for ordinary
    fronts. The ``lax.while_loop`` exits per-level as soon as the batch
    max-residual crosses ``tol``, so easy levels pay only their own steps.

    Why this shape: the rolled dd Cholesky + substitutions are O(n)
    SEQUENTIAL tiny elementwise steps, pure in-program latency. Here every
    step is two batched GEMMs; there are no rolled loops at all."""
    n = Ah.shape[-1]
    Ib = jnp.broadcast_to(jnp.eye(n, dtype=Ah.dtype), Ah.shape)
    dg = jnp.diagonal(Ah, axis1=-2, axis2=-1)
    smax = jnp.maximum(jnp.max(dg, axis=-1), jnp.asarray(1e-30, Ah.dtype))
    sigma = (sigma_rel * smax)[..., None, None]
    Lc = lax.linalg.cholesky(Ah + sigma * Ib)
    Li = lax.linalg.triangular_solve(Lc, Ib, left_side=True, lower=True)
    nb = Li.ndim - 2
    dn = (((Li.ndim - 2,), (Li.ndim - 2,)),
          (tuple(range(nb)), tuple(range(nb))))
    M0 = lax.dot_general(Li, Li, dn, preferred_element_type=Ah.dtype)

    def body(carry):
        Mh, Ml, _res, k = carry
        # A @ M (M symmetric, so the nt form needs no transpose)
        AMh, AMl = dd_matmul_nt_any((Ah, Al), (Mh, Ml))
        res = jnp.max(jnp.abs(AMh - Ib))
        # M (2I - AM) = 2M - M @ (AM)
        Xh = jnp.swapaxes(AMh, -1, -2)
        Xl = jnp.swapaxes(AMl, -1, -2)
        Ph, Pl = dd_matmul_nt_any((Mh, Ml), (Xh, Xl))
        Nh, Nl = df64.dd_sub(df64.dd_add((Mh, Ml), (Mh, Ml)), (Ph, Pl))
        # exact symmetrization (halving is exact; drift would compound)
        Nh, Nl = df64.dd_add((Nh, Nl), (jnp.swapaxes(Nh, -1, -2),
                                        jnp.swapaxes(Nl, -1, -2)))
        return (0.5 * Nh, 0.5 * Nl, res, k + 1)

    def cond(carry):
        _Mh, _Ml, res, k = carry
        return (k < max_steps) & (res > tol)

    Mh, Ml, _, _ = lax.while_loop(
        cond, body, (M0, jnp.zeros_like(M0),
                     jnp.asarray(jnp.inf, Ah.dtype),
                     jnp.asarray(0, jnp.int32)))
    return Mh, Ml


def dd_cholesky_ir(Ah, Al, steps=3, sigma_rel=4 * 2.0 ** -23):
    """Batched dd Cholesky by ITERATIVE REFINEMENT of the f32 factor —
    all GEMMs, no rolled loops. For fronts with kappa(A) below ~1/eps32.

    Seed: native batched f32 Cholesky of A + sigma*I (backward stable:
    residual E0 = A - L0 L0^T is ~eps32*||A|| REGARDLESS of kappa — unlike
    the inverse-NS residual, no kappa amplification). Refinement: Newton
    on the factor equation, dL = L Phi(L^-1 E L^-T) with Phi = tril
    halving the diagonal; the triangular inverse is taken in f32 (native)
    since it only preconditions the correction. Residual after one step
    ~ kappa * eps32^2 * ||A||, so 2-3 steps reach the dd floor for
    kappa <= ~1e6; the iteration DIVERGES once kappa*||E|| > 1, i.e. this
    is NOT a replacement for the sequential dd factorization at the
    deep-t separator fronts (kappa up to 2^48) — see dd_spd_inverse's
    docstring for the measured instability of the inverse-form NS there.

    Returns dd (Lh, Ll) lower-triangular."""
    n = Ah.shape[-1]
    ii = jnp.arange(n)
    tril = (ii[:, None] >= ii[None, :]).astype(Ah.dtype)
    Ib = jnp.broadcast_to(jnp.eye(n, dtype=Ah.dtype), Ah.shape)
    dg = jnp.diagonal(Ah, axis1=-2, axis2=-1)
    smax = jnp.maximum(jnp.max(dg, axis=-1), jnp.asarray(1e-30, Ah.dtype))
    sigma = (sigma_rel * smax)[..., None, None]
    L = (lax.linalg.cholesky(Ah + sigma * Ib), jnp.zeros_like(Ah))
    half_diag = tril - 0.5 * jnp.eye(n, dtype=Ah.dtype)
    for _ in range(steps):
        Eh, El = dd_syrk_sub(Ah, Al, L[0], L[1])      # A - L L^T, dd
        Li = lax.linalg.triangular_solve(L[0], Ib, left_side=True,
                                         lower=True)
        # T = Li E Li^T (E symmetric): Li @ (Li @ E)^T
        P = dd_matmul_nt_any((jnp.broadcast_to(Li, Eh.shape),
                              jnp.zeros_like(Eh)),
                             (jnp.swapaxes(Eh, -1, -2),
                              jnp.swapaxes(El, -1, -2)))
        T = dd_matmul_nt_any((jnp.broadcast_to(Li, Eh.shape),
                              jnp.zeros_like(Eh)), P)
        Ph = T[0] * half_diag
        Pl = T[1] * half_diag
        dL = dd_matmul_nt_any(L, (jnp.swapaxes(Ph, -1, -2),
                                  jnp.swapaxes(Pl, -1, -2)))
        Lh2, Ll2 = df64.dd_add(L, dL)
        L = (Lh2 * tril, Ll2 * tril)
    return L


def dd_tri_inverse(Lh, Ll, steps=None):
    """Batched dd inverse of lower-triangular (Bk, n, n).

    Seed: XLA's native batched f32 triangular solve against I (residual
    ~eps32 * kappa(L)); refinement: ``steps`` Newton-Schulz iterations
    X <- X (2I - L X) with both products in dd (Ozaki split GEMMs).
    Each iteration squares the residual; NS_STEPS (default 2) lands at
    the dd floor for every panel the dd factorization can represent. The
    strictly-upper part is re-zeroed each step (NS preserves
    triangularity exactly; the mask stops eps-level fill from
    compounding)."""
    if steps is None:
        steps = NS_STEPS
    n = Lh.shape[-1]
    ii = jnp.arange(n)
    tril = (ii[:, None] >= ii[None, :]).astype(Lh.dtype)
    Ib = jnp.broadcast_to(jnp.eye(n, dtype=Lh.dtype), Lh.shape)
    X0 = lax.linalg.triangular_solve(Lh, Ib, left_side=True, lower=True)
    X = (X0 * tril, jnp.zeros_like(X0))
    twoI = (2.0 * Ib, jnp.zeros_like(X0))
    for _ in range(steps):
        Xt = (jnp.swapaxes(X[0], -1, -2), jnp.swapaxes(X[1], -1, -2))
        LX = dd_matmul_nt_any((Lh, Ll), Xt)
        Rh, Rl = df64.dd_sub(twoI, LX)
        Xn = dd_matmul_nt_any(X, (jnp.swapaxes(Rh, -1, -2),
                                  jnp.swapaxes(Rl, -1, -2)))
        X = (Xn[0] * tril, Xn[1] * tril)
    return X


def _pad_pform(Lh, Ll, n, N):
    """Pad a (B, n, n) triangular dd factor to (B, N, N) with identity
    tail panels (unit diagonal, zero coupling) so padded panels invert
    to themselves."""
    pad = N - n
    Lh = jnp.pad(Lh, ((0, 0), (0, pad), (0, pad)))
    Ll = jnp.pad(Ll, ((0, 0), (0, pad), (0, pad)))
    tail = jnp.arange(n, N)
    Lh = Lh.at[:, tail, tail].set(1.0)
    return Lh, Ll


def dd_tri_pinv(Lh, Ll, steps=None):
    """Partitioned-inverse (P-) form of a batched dd lower-triangular
    factor (B, n, n): the diagonal ``_BLOCK`` panels are replaced IN
    PLACE by their dd inverses (Newton-Schulz, ``dd_tri_inverse``); the
    strictly-lower off-diagonal blocks keep L itself. Same storage as L.
    Applies via ``dd_tri_solve_left_pinv`` / ``dd_tri_solve_right_pinv``
    run at substitution-grade accuracy (see the TRI_MODE note above)
    with sequential depth ceil(n/_BLOCK)."""
    B, n, _ = Lh.shape
    w = _BLOCK
    if n <= w:
        return dd_tri_inverse(Lh, Ll, steps)
    k = -(-n // w)
    N = k * w
    if N != n:
        Lh, Ll = _pad_pform(Lh, Ll, n, N)
    idx = jnp.arange(k)
    Dh = Lh.reshape(B, k, w, k, w)[:, idx, :, idx, :]   # (k, B, w, w)
    Dl = Ll.reshape(B, k, w, k, w)[:, idx, :, idx, :]
    ih, il = dd_tri_inverse(Dh.reshape(k * B, w, w),
                            Dl.reshape(k * B, w, w), steps)
    ih = ih.reshape(k, B, w, w)
    il = il.reshape(k, B, w, w)
    Ph = Lh.reshape(B, k, w, k, w).at[:, idx, :, idx, :].set(ih)
    Pl = Ll.reshape(B, k, w, k, w).at[:, idx, :, idx, :].set(il)
    return (Ph.reshape(B, N, N)[:, :n, :n],
            Pl.reshape(B, N, N)[:, :n, :n])


def dd_tri_solve_left_pinv(Ph, Pl, bh, bl, transpose=False):
    """Solve L y = b (or L^T y = b) where (Ph, Pl) is the P-form factor
    from ``dd_tri_pinv``: b dd (Bk, n). ceil(n/_BLOCK) sequential steps,
    each one masked dd GEMV against the panel row/column block plus a
    w x w panel-inverse apply."""
    Bk, n = bh.shape
    w = _BLOCK
    if n <= w:
        return dd_gemv((Ph, Pl), (bh, bl), transpose=transpose)
    k = -(-n // w)
    N = k * w
    if N != n:
        Ph, Pl = _pad_pform(Ph, Pl, n, N)
        bh = jnp.pad(bh, ((0, 0), (0, N - n)))
        bl = jnp.pad(bl, ((0, 0), (0, N - n)))
    idx = jnp.arange(N)

    def step(i, carry, trans):
        yh, yl = carry
        if trans:
            blk_h = lax.dynamic_slice(Ph, (0, 0, i * w), (Bk, N, w))
            blk_l = lax.dynamic_slice(Pl, (0, 0, i * w), (Bk, N, w))
            m = (idx >= (i + 1) * w)[None, :, None]
            ph, pe = df64.dd_mul((jnp.where(m, blk_h, 0.0),
                                  jnp.where(m, blk_l, 0.0)),
                                 (yh[:, :, None], yl[:, :, None]))
            ah, al = df64.dd_tree_sum((ph, pe), axis=1)
        else:
            blk_h = lax.dynamic_slice(Ph, (0, i * w, 0), (Bk, w, N))
            blk_l = lax.dynamic_slice(Pl, (0, i * w, 0), (Bk, w, N))
            m = (idx < i * w)[None, None, :]
            ph, pe = df64.dd_mul((jnp.where(m, blk_h, 0.0),
                                  jnp.where(m, blk_l, 0.0)),
                                 (yh[:, None, :], yl[:, None, :]))
            ah, al = df64.dd_tree_sum((ph, pe), axis=2)
        rbh = lax.dynamic_slice(bh, (0, i * w), (Bk, w))
        rbl = lax.dynamic_slice(bl, (0, i * w), (Bk, w))
        rh, rl = df64.dd_sub((rbh, rbl), (ah, al))
        Dh = lax.dynamic_slice(Ph, (0, i * w, i * w), (Bk, w, w))
        Dl = lax.dynamic_slice(Pl, (0, i * w, i * w), (Bk, w, w))
        qh, ql = dd_gemv((Dh, Dl), (rh, rl), transpose=trans)
        return (lax.dynamic_update_slice(yh, qh, (0, i * w)),
                lax.dynamic_update_slice(yl, ql, (0, i * w)))

    Z = jnp.zeros_like(bh)
    if transpose:
        yh, yl = lax.fori_loop(
            0, k, lambda jj, c: step(k - 1 - jj, c, True), (Z, Z))
    else:
        yh, yl = lax.fori_loop(0, k, lambda i, c: step(i, c, False), (Z, Z))
    return yh[:, :n], yl[:, :n]


def dd_tri_solve_right_pinv(Ph, Pl, Bh, Bl):
    """Solve X L^T = B for X where (Ph, Pl) is the P-form factor: B dd
    (Bk, m, n). ceil(n/_BLOCK) sequential steps; the inter-panel update
    X[:, :, :i*w] . L_panel^T is one Ozaki GEMM and the panel apply
    R . D^-T another — the GEMM-everywhere factor-time form that
    ``TRI_INV`` bought, without the full-inverse application damage."""
    Bk, m, n = Bh.shape
    w = _BLOCK
    if n <= w:
        return dd_matmul_nt_any((Bh, Bl), (Ph, Pl))
    k = -(-n // w)
    N = k * w
    if N != n:
        Ph, Pl = _pad_pform(Ph, Pl, n, N)
        Bh = jnp.pad(Bh, ((0, 0), (0, 0), (0, N - n)))
        Bl = jnp.pad(Bl, ((0, 0), (0, 0), (0, N - n)))
    idx = jnp.arange(N)

    def step(i, carry):
        Xh, Xl = carry
        row_h = lax.dynamic_slice(Ph, (0, i * w, 0), (Bk, w, N))
        row_l = lax.dynamic_slice(Pl, (0, i * w, 0), (Bk, w, N))
        mrow = (idx < i * w)[None, None, :]
        uh, ul = dd_matmul_nt_any((Xh, Xl),
                                  (jnp.where(mrow, row_h, 0.0),
                                   jnp.where(mrow, row_l, 0.0)))
        rbh = lax.dynamic_slice(Bh, (0, 0, i * w), (Bk, m, w))
        rbl = lax.dynamic_slice(Bl, (0, 0, i * w), (Bk, m, w))
        rh, rl = df64.dd_sub((rbh, rbl), (uh, ul))
        Dh = lax.dynamic_slice(Ph, (0, i * w, i * w), (Bk, w, w))
        Dl = lax.dynamic_slice(Pl, (0, i * w, i * w), (Bk, w, w))
        xh, xl = dd_matmul_nt_any((rh, rl), (Dh, Dl))
        return (lax.dynamic_update_slice(Xh, xh, (0, 0, i * w)),
                lax.dynamic_update_slice(Xl, xl, (0, 0, i * w)))

    Z = jnp.zeros_like(Bh)
    Xh, Xl = lax.fori_loop(0, k, step, (Z, Z))
    return Xh[:, :, :n], Xl[:, :, :n]
