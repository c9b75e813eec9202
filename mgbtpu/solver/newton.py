"""Damped Newton with line search and stopping criteria, as a single jit.

The whole inner solve — Hessian assembly, dense symmetric solve, line
search, stopping tests — runs on-device inside ``lax.while_loop``s with a
status flag threaded through the carry (under jit there are no exceptions;
the barrier's Log->-inf convention turns every domain escape into a
non-finite value that the checks below reject, exactly the design the
reference chose for its GPU kernels). Algorithmic parity with reference
``src/newton.jl`` (newton at :227-287, backtracking at :139-154, Illinois at
:84-103, stopping at :187-225).

float32 path (``dd=True``): objective values flow as stacked double-float
scalars (their differences along a line search are ~lambda^2, below the f32
ulp of the value), and the Newton decrement is a df64 dot product.

Status codes: 0 running, 1 converged, 2 not converged (maxit / line-search
exhaustion), 3 non-finite initial value, 4 Hessian-solve failure at a
non-optimal point (lambda^2 <= 0 with large gradient), 5 non-finite Newton
direction.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..ops import df64

RUNNING, CONVERGED, DIVERGED, BAD_INIT, BAD_HESSIAN, BAD_DIRECTION = range(6)

_MAX_LS_TRIALS = 120  # s = beta^k underflows long before this for any dtype


class _PlainY:
    """Objective values as plain scalars (the float64 path)."""
    @staticmethod
    def hi(y):
        return y

    @staticmethod
    def value(y):
        return y

    @staticmethod
    def le(a, b):
        return a <= b

    @staticmethod
    def minimum(a, b):
        return jnp.minimum(a, b)

    @staticmethod
    def sub_f(y, f):
        return y - f

    @staticmethod
    def isfinite(y):
        return jnp.isfinite(y)


class _DDY:
    """Objective values as stacked df64 scalars (the float32 path)."""
    @staticmethod
    def hi(y):
        return df64.s_hi(y)

    @staticmethod
    def value(y):
        return df64.s_val(y)

    @staticmethod
    def le(a, b):
        return df64.s_le(a, b)

    @staticmethod
    def minimum(a, b):
        return df64.s_min(a, b)

    @staticmethod
    def sub_f(y, f):
        return df64.s_add_f(y, -f)

    @staticmethod
    def isfinite(y):
        return df64.s_isfinite(y)


class _PlainG:
    """Gradient vectors as plain arrays (the float64 path)."""
    @staticmethod
    def fl(g):
        return g

    @staticmethod
    def finite(g):
        return jnp.all(jnp.isfinite(g))

    @staticmethod
    def norm(g):
        return jnp.linalg.norm(g)

    @staticmethod
    def dot(g, n):
        return g @ n

    @staticmethod
    def sel(pred, a, b):
        return jnp.where(pred, a, b)


class _DDG:
    """Gradient vectors as DD pairs (the float32 path): the assembled
    gradient must reach the Newton solve unnarrowed — an eps(f32)-relative
    g perturbation costs ||H^-1 dg|| ~ eps * kappa_eq ~ eps * t in the
    direction."""
    @staticmethod
    def fl(g):
        return g.hi + g.lo

    @staticmethod
    def finite(g):
        return jnp.all(jnp.isfinite(g.hi)) & jnp.all(jnp.isfinite(g.lo))

    @staticmethod
    def norm(g):
        return jnp.linalg.norm(g.hi + g.lo)

    @staticmethod
    def dot(g, n):
        ph, pe = df64.two_prod(g.hi, n)
        pe = pe + g.lo * n
        hi, lo = df64.dd_tree_sum((ph, pe), axis=-1)
        return hi + lo

    @staticmethod
    def sel(pred, a, b):
        import jax

        return jax.tree_util.tree_map(lambda x, y: jnp.where(pred, x, y),
                                      a, b)


def equilibrated_solve(H, g):
    """Dense symmetric solve: Jacobi equilibration + LU + iterative
    refinement.

    The barrier Hessian carries 1/slack^2 ~ t^2 entries at active nodes next
    to O(1) rows; symmetric rescaling to unit diagonal removes that t^2
    spread from the conditioning (essential for the float32 path). LU
    with partial pivoting survives the slight numerical indefiniteness that
    rounding induces near the central path, where a Cholesky would NaN out;
    two refinement sweeps recover most of the equilibrated accuracy at
    O(n^2) cost.
    """
    from jax.scipy.linalg import lu_factor, lu_solve

    d = jnp.sqrt(jnp.abs(jnp.diagonal(H)))
    dinv = jnp.where(d > 0, 1.0 / d, 1.0)
    Hs = H * (dinv[:, None] * dinv[None, :])
    gs = dinv * g
    lu = lu_factor(Hs)
    x = lu_solve(lu, gs)
    for _ in range(2):
        r = gs - Hs @ x
        x = x + lu_solve(lu, r)
    return dinv * x


import os as _os

IR_INNER = int(_os.environ.get("MGBTPU_IR_INNER", 200))
IR_OUTER = int(_os.environ.get("MGBTPU_IR_OUTER", 3))
IR_RTOL = float(_os.environ.get("MGBTPU_IR_RTOL", 1e-5))
# Outer-IR exit: stop refining once the TRUE (dd) residual is within
# IR_TAU * rtol of the right-hand side — the first inner CG usually lands
# there already, and each extra outer costs a full corrector solve.
IR_TAU = float(_os.environ.get("MGBTPU_IR_TAU", 4.0))
# Inexact-Newton forcing (Eisenstat-Walker flavored, binary): while the
# decrement is far above lambda_tol the direction only steers the line
# search, so the corrector runs at the loose tolerance; the stopping
# iteration always re-solves tight so the reported decrement is honest.
# Defaults swept on the CPU f32 path (L=3/L=4, bit-identical code path):
# tight 1e-5 + loose 1e-2 cut total CG iterations ~30% vs (1e-7, 1e-3)
# at identical Newton counts and solution error vs the f64 oracle.
FORCING = _os.environ.get("MGBTPU_FORCING", "1") != "0"
RTOL_LOOSE = float(_os.environ.get("MGBTPU_FORCING_RTOL", 1e-2))
# Preconditioner refresh policy. Frozen-per-centering preconditioners go
# stale at t near the target (the Hessian drift within a centering exceeds
# the f32 factorization's shift) and CG counts inflate ~40% on the last
# ramp steps; always-refreshing pays an n^3 factorization every iteration.
# "auto" (default) rebuilds only when the previous solve's CG count
# crossed the refresh threshold — staleness is measured by the symptom
# itself. The threshold is per-preconditioner-kind: the ND factorization
# is O(n^1.5) while a CG matvec is O(n), so an ND refresh pays for itself
# after a handful of saved CG its — measured on CPU f64 fem2d_P2 (solve
# wall / total CG): L=6 AT=96: 15.6 s/2246 -> AT=4: 8.5 s/570; L=7:
# 79.0 s/2874 -> 52.4 s/685; L=5: 1.57 s/1025 -> 0.98 s/314 (beats the
# reference's A40). AT=2 and AT=8 bracket the same optimum. V-cycle/FSAI
# preconditioners sit at ~8 CG its when healthy, so they keep the lax
# threshold (a tight one would rebuild every iteration for no signal).
# Central-path tangent predictor (see make_newton_core._predict): warm-
# starts each t-step's centering from the first-order path extrapolation
# instead of the previous center. MGBTPU_PREDICTOR=0 disables.
PREDICTOR = _os.environ.get("MGBTPU_PREDICTOR", "1") != "0"
PRE_REFRESH = _os.environ.get("MGBTPU_PRE_REFRESH", "auto")
PRE_REFRESH_AT = int(_os.environ.get("MGBTPU_PRE_REFRESH_AT", 96))
PRE_REFRESH_ND_AT = int(_os.environ.get("MGBTPU_PRE_REFRESH_ND_AT", 4))
# dense-path staleness threshold: its OWN knob (defaulting to the ND value)
# so tuning the ND refresh does not silently retune the dense path too
PRE_REFRESH_DENSE_AT = int(_os.environ.get("MGBTPU_PRE_REFRESH_DENSE_AT",
                                           PRE_REFRESH_ND_AT))


def _refresh_at(H):
    """Trace-time CG-count threshold above which the frozen preconditioner
    is rebuilt: tight for direct-grade preconditioners (ND factors and the
    dense-path equilibrated Cholesky — both exit CG in ~1-3 its when fresh,
    so >4 its IS the staleness signal; the frozen dense pre at L=4 sat at
    ~91 CG its/Newton it under the lax threshold),
    lax for V-cycle/FSAI (healthy at ~8 its — a tight threshold would
    rebuild every iteration on no signal)."""
    from .levelops import GramHessian

    if isinstance(H, GramHessian):
        if (H.ctx is not None
                and getattr(H.ctx, "nd", None) is not None):
            return PRE_REFRESH_ND_AT
        if H.ctx is None:   # dense path (refresh cost gated by _refresh_allowed)
            return PRE_REFRESH_DENSE_AT
    return PRE_REFRESH_AT
# Dense-path refresh pays an n^3 factorization: the measured break-even (on
# earlier hardware; not yet measured on the GPU) sits between n_J = 1345
# (refresh wins, L=4) and 5057 (frozen wins, L=5)
PRE_REFRESH_MAXN = int(_os.environ.get("MGBTPU_PRE_REFRESH_MAXN", 3072))


def _refresh_allowed(H):
    from .levelops import GramHessian

    if not isinstance(H, GramHessian):
        return False
    if H.ctx is None:
        return H.ops.n_J <= PRE_REFRESH_MAXN
    return True   # PCG pre rebuilds are coarse-level work only


def _always_refresh(H, nd_dd=None):
    """Refresh the preconditioner EVERY Newton iteration: the dd nested-
    dissection factor is direct-solve quality when fresh (measured
    contraction 1.3e-4 at a captured deep-t state, CG exits in ~2 its) but
    the near-null subspace of the equilibrated Hessian rotates along the
    path, so even one stale step degrades it to hundreds of CG its at deep
    t. The O(n^1.5) refactorization is far cheaper than the stale-pre CG
    bill (measured at L=3: 13k CG its frozen vs ~4/solve fresh).

    ``nd_dd`` is the per-program factor-precision override threaded from
    the two-phase ramp (solver/mgb.py ND_DD_T): when set (True = dd
    fronts, False = native f32 fronts for the low-t phase) the ND factor
    always refreshes — the f32 refactorization is a handful of fused
    batched ops, far below one stale-pre CG iteration. When None, the legacy
    global policy applies (dd factors only, MGBTPU_ND_DD).

    ``MGBTPU_ND_REFRESH=auto`` opts the dd ND factor into the symptom-
    driven policy instead (rebuild when the last solve crossed
    PRE_REFRESH_ND_AT CG its): trading a few stale-pre CG its for
    skipped rebuilds can win wall-clock where the dd refactorization is
    latency-dominated. At L=6 on earlier hardware auto LOST (510 CG its
    vs always's 129): the stale-factor CG bill exceeded the refactor."""
    from .levelops import GramHessian

    return (_ND_REFRESH != "auto"
            and isinstance(H, GramHessian)
            and getattr(H.ctx, "nd", None) is not None
            and H.Ydd is not None
            and (ND_DD if nd_dd is None else True))


_ND_REFRESH = _os.environ.get("MGBTPU_ND_REFRESH", "always")
# V-cycle smoother: "cheby" (Chebyshev polynomial on D^-1 H, degree
# MGBTPU_CHEB_DEG) or "jacobi" (one damped sweep, omega=0.7)
SMOOTHER = _os.environ.get("MGBTPU_SMOOTHER", "cheby")
CHEB_DEG = int(_os.environ.get("MGBTPU_CHEB_DEG", 3))
# Large-level preconditioner:
#   "vcycle" (default) — Chebyshev-smoothed V-cycle over the barrier-Hessian
#            hierarchy with dense Cholesky base. With the corrected
#            lambda_max estimator (see smooth_data) the cycle contracts
#            level-independently: measured |E|=0.24 and 8 CG its at L=6
#            where the old estimator diverged (|E|=3.66, ~600 its) — the
#            earlier "V-cycle took 319 CG its at L=6" reading that
#            motivated FSAI was this estimator bug, not the cycle.
#   "fsai2"  — FSAI smoothing + two-level Galerkin coarse correction;
#            diverges at L>=6 (|E|~5e2): one coarse level is too far from
#            the fine grid once an intermediate level exists.
#   "fsai2a" — additive variant of fsai2
#   "fsai"   — plain FSAI (purely local, CG counts grow with depth)
#   "nd"     (default) — nested-dissection multifrontal direct factors
#            (ops/ndchol.py): at deep t the equilibrated barrier Hessian
#            grows hundreds of near-null eigenvalues (406 below 1e-3 at
#            the measured L=6 stall state) that no smoother+coarse-space
#            combination represents — the V-cycle contraction collapses to
#            0.998 and f32 CG diverges. A direct factorization with shift
#            below lambda_min handles the same systems at O(n^1.5)
#            flops; this is the role cuDSS plays for the reference.
BIG_PRE = _os.environ.get("MGBTPU_BIG_PRE", "nd")

# diagnostic hook: set to a dict to capture pcg_solve's preconditioner
# closures at trace time (None in production)
_DEBUG_CAPTURE = None



def make_dense_pre(H):
    """Build the frozen dense preconditioner (equilibration + shifted f32
    Cholesky + explicit inverse) for one CENTERING: the Hessian drifts only
    O(lambda) within a centering, so the factorization chain is built once
    per Newton run and the CG
    corrector absorbs the staleness with a few extra iterations.

    Uses the O(1)-program-size blocked factorization (ops/blockchol.py):
    XLA's expander-based cho_factor/cho_solve put ~300 MB of generated code
    and a 2.1 GB temp into every Newton program at n ~ 5000."""
    from ..ops.blockchol import shifted_spd_inverse

    return shifted_spd_inverse(H.H32)


def dense_ir_solve(H, g, *, inner_iters=None, outer_iters=None, pre=None,
                   rtol=None, return_stats=False):
    """Mixed-precision Newton solve for dd dense levels.

    The barrier Hessian near the central path has equilibrated condition
    number ~ t; at the reference tolerance t ~ 1/eps(f64) ~ 6.7e7 this is
    beyond what an f32 factorization can solve (kappa * eps_f32 > 1: plain
    iterative refinement diverges). Following the GMRES-IR recipe
    (Carson-Higham), the f32 equilibrated Cholesky of the dense assembly
    serves only as a *preconditioner* for a CG corrector (f32 dense matvec),
    while the outer refinement iterates double-float residuals r = g - H x
    against the exact matrix-free dd operator (levelops.y_matvec_dd) with a
    dd solution accumulator — pushing the direction to the dd floor.

    ``H``: GramHessian with ``ctx=None``, carrying the dd node blocks
    (Ydd), f32 factors (Lnode) and the dense f32 preconditioner assembly
    (H32). ``g`` may be a DD pair (it must be: an f32-narrowed gradient is
    amplified by kappa ~ t in the direction).
    """
    import numpy as _np

    from ..ops import df64
    from ..ops.ddarray import DD
    from .levelops import gram_matvec, y_matvec_dd, y_matvec_rel

    inner_iters = IR_INNER if inner_iters is None else inner_iters
    outer_iters = IR_OUTER if outer_iters is None else outer_iters
    if isinstance(g, DD):
        g_pair = (g.hi, g.lo)
    else:
        g_pair = (g, jnp.zeros_like(g))
    dtype = H.H32.dtype if H.H32 is not None else H.Lnode.dtype
    rtol = jnp.asarray(IR_RTOL if rtol is None else rtol, dtype)
    if pre is None:
        pre = make_nd_pre(H) if getattr(H.ctx, "nd", None) is not None \
            else make_dense_pre(H)
    null = None
    if isinstance(pre[0], tuple):
        # nested-dissection direct factors (ops/ndchol.py): pre =
        # (fact_tuple, dinv) or (fact_tuple, dinv, nullmask) for dd
        # factors. No tag string: the pre pytree flows through lax.cond
        # refresh carries, so the shapes are told apart by structure (dd
        # factors nest one tuple level deeper).
        from ..ops.ndchol import nd_solve, nd_solve_dd

        fact, dinv = pre[0], pre[1]
        null = pre[2] if len(pre) > 2 else None
        ndp = H.ctx.nd
        if isinstance(fact[0][0], tuple):
            def apply_pre(r):
                # mask the structurally-null dofs (unit pivots in the
                # factor; see make_nd_pre): their residual is
                # inconsistent (zero H row, nonzero g) and must not
                # enter the corrector
                rm = jnp.where(null, 0.0, r)
                xh, xl = nd_solve_dd(ndp, fact, rm)
                return jnp.where(null, 0.0, xh + xl)
        elif null is not None:
            # cheap f32 fronts inside a dd solve (two-phase ramp): same
            # null masking as the dd factors
            def apply_pre(r):
                x = nd_solve(ndp, fact, jnp.where(null, 0.0, r))
                return jnp.where(null, 0.0, x)
        else:
            def apply_pre(r):
                return nd_solve(ndp, fact, r)
    else:
        Minv, dinv = pre

        def apply_pre(r):
            return Minv @ r

    def ddot(a, b):
        hi, lo = df64.dd_dot(a, b)
        return hi + lo

    # f64/x64 ND path: no dd node blocks — the plain f64 Gram matvec is
    # already at working precision (the dd machinery exists to recover f64
    # accuracy FROM f32 storage)
    plain64 = H.Ydd is None

    def mv_s(u):
        # equilibrated matvec through the DOUBLE-FLOAT operator, narrowed
        # per application. An f32 matvec has ABSOLUTE error eps*||Hs||*||u||,
        # which at kappa_eq ~ t > 1/eps(f32) exceeds the solvable residual
        # and caps the whole refinement (the observed lambda floor ~3e-3);
        # the dd matvec's error is RELATIVE to the product, which is what
        # the GMRES-IR convergence theory (matvec in precision u^2) needs.
        # The inner corrector tolerates the plain-scatter variant.
        if plain64:
            return dinv * gram_matvec(H.ops, H.Lnode, dinv * u)
        return dinv * y_matvec_rel(H.ops, H.Ydd, dinv * u)

    def inner(r0):
        # CG in EQUILIBRATED coordinates: Hs u = dinv*r0, delta = dinv*u.
        # The raw H spans ~t^2 orders of magnitude near the reference
        # tolerance; on the unit-diagonal scale everything is O(1).
        # ``apply_pre`` sits at the TOP of the loop body (beta = 0 on the
        # first pass) instead of once before the loop and once at the
        # bottom: the preconditioner is the full ND substitution chain
        # (~25k HLO ops at L=5) and inlining it twice doubled the program
        # and its compile time. Same iterate
        # sequence as the classic form; the final iteration's wasted
        # trailing z also disappears.
        rs = dinv * r0
        if null is not None:
            rs = jnp.where(null, 0.0, rs)
        tol2 = rtol * rtol * ddot(rs, rs)

        def cond(c):
            x, r, p2, rz, k = c
            return (ddot(r, r) > tol2) & (k < inner_iters)

        def body(c):
            x, r, p2, rz_prev, k = c
            z = apply_pre(r)
            rz = ddot(r, z)
            beta = jnp.where((k > 0) & (rz_prev != 0), rz / rz_prev, 0.0)
            p2 = z + beta * p2
            Hp = mv_s(p2)
            pHp = ddot(p2, Hp)
            alpha = jnp.where(pHp > 0, rz / pHp, 0.0)
            x = x + alpha * p2
            r = r - alpha * Hp
            return (x, r, p2, rz, k + 1)

        init = (jnp.zeros_like(rs), rs, jnp.zeros_like(rs),
                jnp.asarray(0.0, rs.dtype), jnp.asarray(0, jnp.int32))
        x, _, _, _, k = lax.while_loop(cond, body, init)
        return dinv * x, k

    # dd iterative refinement, exited on the TRUE residual: the inner CG's
    # f32 recurrence residual drifts from the real one near its attainable
    # floor, so outers re-measure r = g - H x in dd and stop once it is
    # within IR_TAU * rtol of ||g|| (or the outer budget runs out). This
    # replaces a fixed unrolled outer count — each skipped outer saves a
    # full corrector solve.
    zeros = jnp.zeros_like(g_pair[0])
    # the stop metric is the EQUILIBRATED residual |D r|: the raw residual
    # has an f32-representation floor ~ |H| |delta| eps(f32) that exceeds
    # any useful raw tau at deep t (H spans ~t^2 orders of magnitude), so a
    # raw-norm test burns every outer budget without measuring anything
    gq = dinv * (g_pair[0] + g_pair[1])
    gnorm = jnp.sqrt(ddot(gq, gq))
    tau = jnp.asarray(IR_TAU, dtype) * rtol * jnp.maximum(gnorm, 1e-30)

    def ocond(c):
        xh, xl, r, rnorm, ko, kcg = c
        return ((ko == 0) | (rnorm > tau)) & (ko < outer_iters)

    def obody(c):
        xh, xl, r, rnorm, ko, kcg = c
        delta, k_in = inner(r)
        if _os.environ.get("MGBTPU_IR_DEBUG"):  # pragma: no cover
            jax.debug.print("    ir outer {o}: k_in={k} rnorm={rn}",
                            o=ko, k=k_in, rn=rnorm)
        xh, xl = df64.dd_add((xh, xl), (delta, zeros))
        if plain64:
            hx = (gram_matvec(H.ops, H.Lnode, xh), jnp.zeros_like(xh))
        else:
            hx = y_matvec_dd(H.ops, H.Ydd, xh)
        hx_lo = gram_matvec(H.ops, H.Lnode, xl)  # |xl| <= eps|xh|: f32 ok
        rh, rl = df64.dd_sub(g_pair, hx)
        rh, rl = df64.dd_sub((rh, rl), (hx_lo, zeros))
        r = rh + rl
        if null is not None:
            # structurally-null dofs: zero H row, nonzero g — the residual
            # there never decreases and must not gate the outer stop
            r = jnp.where(null, 0.0, r)
        rq = dinv * r
        return (xh, xl, r, jnp.sqrt(ddot(rq, rq)), ko + 1, kcg + k_in)

    r_init = g_pair[0] + g_pair[1]
    if null is not None:
        r_init = jnp.where(null, 0.0, r_init)
    init = (zeros, zeros, r_init, jnp.asarray(jnp.inf, dtype),
            jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
    xh, xl, _, _, _, kcg = lax.while_loop(ocond, obody, init)
    x = xh + xl
    return (x, kcg) if return_stats else x


def regularized_direction(H, g):
    """Fallback direction when the Newton solve fails (lambda^2 <= 0 away
    from the optimum): shifted Cholesky on the equilibrated system, with a
    shift ladder — float32 *evaluation* noise of the per-node barrier
    Hessians can make the assembled matrix indefinite at the ~1e-3 level (on
    the unit-diagonal scale), so a single sqrt(eps) shift can still NaN out.
    The direction is guaranteed descent; the caller must not trust its
    decrement for the inexact stopping test (a different quadratic form),
    only for line-search progress."""
    from jax.scipy.linalg import cho_factor, cho_solve

    import numpy as _np

    dtype = H.dtype
    d = jnp.sqrt(jnp.abs(jnp.diagonal(H)))
    dinv = jnp.where(d > 0, 1.0 / d, 1.0)
    Hs = H * (dinv[:, None] * dinv[None, :])
    gs = dinv * g
    eye = jnp.eye(H.shape[0], dtype=dtype)
    eps0 = float(_np.sqrt(_np.finfo(_np.dtype(dtype)).eps))
    out = None
    for delta in (eps0, 3e-2, 5e-1):
        cf = cho_factor(Hs + jnp.asarray(delta, dtype) * eye)
        x = dinv * cho_solve(cf, gs)
        # keep the first finite candidate (ladder evaluated smallest-first)
        out = x if out is None else jnp.where(jnp.all(jnp.isfinite(out)),
                                              out, x)
    return out


def _tree_finite(t):
    import jax

    leaves = [x for x in jax.tree_util.tree_leaves(t)
              if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)]
    if not leaves:
        return jnp.asarray(True)
    flags = [jnp.all(jnp.isfinite(x)) for x in leaves]
    out = flags[0]
    for f in flags[1:]:
        out = out & f
    return out


# Double-float nested-dissection factors on the dd path (default on;
# MGBTPU_ND_DD=0 falls back to f32 factors). The f32 factor's 2-eps(f32)
# shift swamps lambda_min ~ 1/t of the equilibrated Hessian at deep t and
# CG degenerates (measured: 993-2791 CG its/ramp-step at t >= 8e5, ~75% of
# all linear-solve work at L=6). The dd factor with exact dd assembly
# resolves the same systems to ~6e-6 in ONE application (measured at a
# captured deep-t state, kappa_eq = 2e10), so the corrector exits in 1-2
# iterations at every ramp depth.
ND_DD = _os.environ.get("MGBTPU_ND_DD", "1") != "0"
ND_DD_SHIFT = float(_os.environ.get("MGBTPU_ND_DD_SHIFT", 2.0 ** -46))


def make_nd_pre(H, nd_dd=None):
    """Nested-dissection direct factorization of the equilibrated Gram
    Hessian. dd path: double-float fronts with a 2^-46 per-dof shift (unit
    pivots for structurally empty dofs) and a 2^-24 non-finite fallback —
    direct-solve quality at every ramp depth. f64/x64 (or ND_DD=0) path:
    f32 factors with the 2-eps/32-eps ladder. The factor is exact up to
    the shift, so the near-null barrier spectrum that defeats every
    smoother/coarse-space combination (ops/ndchol.py docstring) is handled
    like the dense path handles it.

    ``nd_dd`` overrides the global MGBTPU_ND_DD per program: the fused
    ramp's low-t phase (solver/mgb.py ND_DD_T) runs nd_dd=False — native
    batched f32 Cholesky/triangular-solve fronts, ~10 fused HLOs per ND
    level instead of the dd path's rolled column loops — because the
    preconditioned residual ~ kappa_eq(t) * eps(f32) only exceeds the
    corrector's reach at deep t. The GMRES-IR outer stays dd (true
    residual), so the direction accuracy is unchanged; only the
    preconditioner application differs."""
    import numpy as _np

    from ..ops.ndchol import nd_factor, nd_factor_dd, nd_finite, nd_finite_dd
    from .levelops import gram_diag, gram_element_blocks, \
        gram_element_blocks_dd

    ops = H.ops
    ndp = H.ctx.nd
    d = gram_diag(ops, H.Lnode)
    dinv = jnp.where(d > 0, jax.lax.rsqrt(d), 1.0)
    if H.Ydd is not None and (ND_DD if nd_dd is None else nd_dd):
        dtype = H.Lnode.dtype
        Heh, Hel = gram_element_blocks_dd(ops, H.Ydd, dinv)
        # Structurally-null dofs. The equilibration diag (gram_diag) comes
        # from the JITTERED per-node factors (barrier.node_factors adds
        # ~8 eps |Y| I so f32 Cholesky succeeds), but He_dd comes from the
        # TRUE dd blocks — a panel direction in the exact null space of a
        # huge-scale node block has jittered diag ~ eps |Y| |P|^2 but true
        # diag 0. A sigma-pivot there amplifies its (structurally
        # inconsistent: g != 0, H row = 0) residual by 1/sigma ~ 7e13 and
        # the corrector diverges (measured). Unit pivots + masking
        # decouple them cleanly: their H column is zero too, so zeroing
        # their direction component changes nothing the curved subspace
        # sees. Threshold: the f32 jitter floor of the equilibrated diag.
        dg = jnp.diagonal(Heh, axis1=1, axis2=2)           # (N, C)
        ddiag = jnp.zeros((ops.n_J,), dtype).at[ops.cols].add(dg)
        null = (d <= 0) | (ddiag < 2.0 ** -17)

        def shv(s):
            v = jnp.where(null, jnp.asarray(1.0, dtype),
                          jnp.asarray(s, dtype))
            return jnp.concatenate([v, jnp.ones((1,), dtype)])

        fact = nd_factor_dd(ndp, Heh, Hel, shv(ND_DD_SHIFT))
        if _os.environ.get("MGBTPU_IR_DEBUG"):  # pragma: no cover
            jax.debug.print("  nd_pre: primary_finite={f} n_null={n}",
                            f=nd_finite_dd(fact), n=null.sum())
        fact = lax.cond(nd_finite_dd(fact),
                        lambda f=fact: f,
                        lambda: nd_factor_dd(ndp, Heh, Hel, shv(2.0 ** -24)))
        return (fact, dinv, null)
    He = gram_element_blocks(ops, H.Lnode, dinv)
    eps = float(_np.finfo(H.Lnode.dtype).eps)
    if H.Ydd is not None:
        # cheap (nd_dd=False) phase of a dd solve: same structurally-null
        # dof treatment as the dd branch (unit pivots + masked corrector),
        # with the mask read off the jittered f32 blocks — their null-dof
        # diagonal is jitter-level (~eps), far below the 2^-17 threshold
        dtype = H.Lnode.dtype
        dg = jnp.diagonal(He, axis1=1, axis2=2)
        ddiag = jnp.zeros((ops.n_J,), dtype).at[ops.cols].add(dg)
        null = (d <= 0) | (ddiag < 2.0 ** -17)

        def shv32(s):
            v = jnp.where(null, jnp.asarray(1.0, dtype),
                          jnp.asarray(s, dtype))
            return jnp.concatenate([v, jnp.ones((1,), dtype)])

        fact = nd_factor(ndp, He, shv32(2 * eps))
        fact = lax.cond(nd_finite(fact),
                        lambda f=fact: f,
                        lambda: nd_factor(ndp, He, shv32(32 * eps)))
        return (fact, dinv, null)
    fact = nd_factor(ndp, He, 2 * eps)
    fact = lax.cond(nd_finite(fact),
                    lambda f=fact: f,
                    lambda: nd_factor(ndp, He, 32 * eps))
    return (fact, dinv)


def make_pcg_pre(H, smooth_omega=0.7, nd_dd=None):
    """Preconditioner data for one centering of a matrix-free level:
    the nested-dissection direct factors (BIG_PRE="nd", default), the FSAI
    factor triple (BIG_PRE="fsai*"), or the frozen V-cycle data (coarse
    assemblies + shifted Cholesky inverses + smoother diagonals)."""
    if getattr(H.ctx, "nd", None) is not None and BIG_PRE == "nd":
        return make_nd_pre(H, nd_dd=nd_dd)
    import numpy as _np

    from .levelops import gram_diag

    ops = H.ops
    ctx = H.ctx
    if BIG_PRE.startswith("fsai") and getattr(ctx, "fsai", None) is not None:
        from .fsai import fsai_values

        Gtiles, dpos = fsai_values(ctx.fsai, ops, H.Lnode)
        coarse = None
        if BIG_PRE in ("fsai2", "fsai2a") and ctx.coarse_T is not None:
            # coarse-grid correction data: dense Galerkin barrier Hessian at
            # the V-cycle base level (Galerkin is exact here — the coarse
            # panel ops assemble T' H T of the SAME per-node factors), with
            # equilibrated shifted-Cholesky explicit inverse
            from ..ops.blockchol import shifted_spd_inverse

            Hc = ctx.coarse_ops[ctx.dense_level].assemble_gram(H.Lnode)
            coarse = shifted_spd_inverse(Hc)
        return (Gtiles, dpos, coarse)
    Lnode = H.Lnode
    dtype = Lnode.dtype
    eps = float(_np.finfo(_np.dtype(dtype)).eps)
    from ..ops.blockchol import shifted_spd_inverse

    dense_chos = []
    for l in range(ctx.dense_level + 1):
        Hl = ctx.coarse_ops[l].assemble_gram(Lnode)
        dense_chos.append(shifted_spd_inverse(Hl))
    from .levelops import gram_matvec as _gmv

    def smooth_data(o):
        # diagonal + lambda_max(D^-1 H) estimate for the Chebyshev smoother.
        # Estimated on the symmetrized S = D^-1/2 H D^-1/2 (same spectrum as
        # D^-1 H) by power iteration from a fixed Rademacher vector: the old
        # smooth ones-vector start was nearly orthogonal to the (high-
        # frequency) top eigenvector, so 8 steps *under*-estimated lambda_max
        # at L>=6 and the Chebyshev polynomial amplified above-band modes,
        # diverging the V-cycle (measured |E| = 3.66 at L=6). Norm-ratio
        # estimate (>= Rayleigh quotient) + 1.15 safety keeps the band a
        # guaranteed cover; overestimating only mildly weakens smoothing.
        d = gram_diag(o, Lnode)
        dis = jnp.where(d > 0, jax.lax.rsqrt(d), 0.0)
        v = jax.random.rademacher(
            jax.random.PRNGKey(1905), (o.n_J,), dtype)
        for _ in range(14):
            v = dis * _gmv(o, Lnode, dis * v)
            v = v / jnp.maximum(jnp.linalg.norm(v), 1e-30)
        lmax = jnp.linalg.norm(dis * _gmv(o, Lnode, dis * v))
        return (d, lmax * 1.15)

    diags = {}
    for l in range(ctx.dense_level + 1, ctx.n_levels):
        diags[l] = smooth_data(ctx.coarse_ops[l])
    diag_top = smooth_data(ops)
    return (dense_chos, diags, diag_top)


def pcg_solve(H, g, *, rel_tol=None, maxiter=None, smooth_omega=0.7,
              return_stats=False, pre=None):
    """Multigrid-preconditioned CG for a matrix-free GramHessian level.

    The V-cycle reuses the *same* hierarchy the barrier method searches over
    (the reference's BASELINE north star: replace the sparse direct solver
    with a V-cycle built from the AMG prolongations): coarse levels assemble
    dense Gram Hessians (Cholesky base solves), intermediate levels damp-
    Jacobi-smooth with matrix-free Gram matvecs, transfers are the
    coefficient-level ELL operators. CG from x0=0 keeps g.x > 0 at every
    iterate, so the decrement test never sees a fabricated lambda^2 <= 0.
    """
    from ..ops import df64
    from .levelops import gram_diag, gram_matvec

    ops = H.ops
    ctx = H.ctx
    if getattr(ctx, "nd", None) is not None:
        # nested-dissection context: same GMRES-IR machinery as the dense
        # path, only the preconditioner application differs
        return dense_ir_solve(H, g, pre=pre, rtol=rel_tol,
                              return_stats=return_stats)
    Lnode = H.Lnode
    from ..ops.ddarray import DD as _DD

    dtype = g.hi.dtype if isinstance(g, _DD) else g.dtype
    eps = float(jnp.finfo(dtype).eps)
    # dd path: the inner corrector must actually converge (the IR outer can
    # only polish what the corrector delivers); non-dd keeps the legacy
    # budget
    if rel_tol is None:
        rel_tol = IR_RTOL if ops.dd else 1e-5
    if maxiter is None:
        maxiter = IR_INNER if ops.dd else 150

    if pre is None:
        pre = make_pcg_pre(H, smooth_omega)
    use_fsai = (BIG_PRE.startswith("fsai")
                and getattr(ctx, "fsai", None) is not None)
    if use_fsai:
        from .fsai import fsai_apply

        Gtiles, dpos, coarse = pre
    else:
        dense_chos, diags, diag_top = pre

    def level_mv(l, v):
        o = ops if l == ctx.n_levels else ctx.coarse_ops[l]
        return gram_matvec(o, Lnode, v)

    def smooth(l, b, x0=None):
        # Chebyshev(CHEB_DEG) on D^-1 H over [lmax/4, lmax] (hypre-style
        # smoothing band): much stronger high-frequency damping than one
        # damped-Jacobi sweep at CHEB_DEG matvecs per application
        d, lmax = diag_top if l == ctx.n_levels else diags[l]
        dinv = jnp.where(d > 0, 1.0 / d, 0.0)
        lmin = lmax / 4.0
        theta = (lmax + lmin) / 2.0
        delta = (lmax - lmin) / 2.0
        sigma = theta / delta
        rho = 1.0 / sigma
        if x0 is None:
            x = dinv * b / theta
        else:
            x = x0 + dinv * (b - level_mv(l, x0)) / theta
        dvec = x if x0 is None else x - x0
        for _ in range(CHEB_DEG - 1):
            r = b - level_mv(l, x)
            rho_new = 1.0 / (2.0 * sigma - rho)
            dvec = rho_new * rho * dvec + (2.0 * rho_new / delta) * (dinv * r)
            x = x + dvec
            rho = rho_new
        return x

    def cycle(l, r):
        if l <= ctx.dense_level:
            Minv_l, dinv = dense_chos[l]
            return dinv * (Minv_l @ (dinv * r))
        if SMOOTHER == "cheby":
            x = smooth(l, r)
            resid = r - level_mv(l, x)
            T = ctx.transfers[l - 1]
            xc = cycle(l - 1, T.rmv(resid))
            x = x + T.mv(xc)
            return smooth(l, r, x0=x)
        d, _ = diag_top if l == ctx.n_levels else diags[l]
        dinv = jnp.where(d > 0, smooth_omega / d, 0.0)
        x = dinv * r
        resid = r - level_mv(l, x)
        T = ctx.transfers[l - 1]
        xc = cycle(l - 1, T.rmv(resid))
        x = x + T.mv(xc)
        x = x + dinv * (r - level_mv(l, x))
        return x

    def M(r):
        return cycle(ctx.n_levels, r)

    if _DEBUG_CAPTURE is not None:  # pragma: no cover - diagnostic hook
        _DEBUG_CAPTURE["M"] = M
        _DEBUG_CAPTURE["smooth"] = smooth
        _DEBUG_CAPTURE["level_mv"] = level_mv
        _DEBUG_CAPTURE["cycle"] = cycle

    def dot(a, b):
        hi, lo = df64.dd_dot(a, b)
        return hi + lo

    # CG in equilibrated coordinates (unit-diagonal scale): the raw operator
    # spans ~t^2 orders of magnitude near the reference tolerance and f32 CG
    # quantities formed from it drift into under/overflow (see
    # dense_ir_solve). Hs = D H D with D = diag(1/sqrt(diag H)).
    if use_fsai:
        dt = dpos
    else:
        d_top = diag_top[0]
        dt = jnp.sqrt(jnp.where(d_top > 0, d_top, 1.0))

    def mv_s(u):
        if not ops.dd:
            return H.mv(u / dt) / dt
        # relative-accurate dd matvec (plain scatter), which the IR
        # convergence needs at kappa_eq > 1/eps(f32) (see dense_ir_solve)
        from .levelops import y_matvec_rel as _ymv

        return _ymv(ops, H.Ydd, u / dt) / dt

    if use_fsai:
        if coarse is None:
            def M_s(rs):
                return fsai_apply(ctx.fsai, Gtiles, rs)
        else:
            Minv_c, dinv_c = coarse
            T_c = ctx.coarse_T

            def mvs32(v):
                # f32 equilibrated fine matvec (preconditioner-internal)
                return gram_matvec(ops, Lnode, v / dt) / dt

            def coarse_corr(rs):
                # raw-space residual dpos*rs restricted through the
                # composed transfer; Galerkin coarse solve; prolong back
                # (see the M_s = D^-1 T Hc^-1 T' D^-1 identity in
                # solver/fsai.py's module docstring context)
                w = T_c.rmv(dt * rs)
                zc = dinv_c * (Minv_c @ (dinv_c * w))
                return dt * T_c.mv(zc)

            if BIG_PRE == "fsai2a":
                def M_s(rs):
                    return fsai_apply(ctx.fsai, Gtiles, rs) + coarse_corr(rs)
            else:
                def M_s(rs):
                    x1 = fsai_apply(ctx.fsai, Gtiles, rs)
                    x2 = x1 + coarse_corr(rs - mvs32(x1))
                    return x2 + fsai_apply(ctx.fsai, Gtiles, rs - mvs32(x2))
    else:
        def M_s(rs):
            return dt * M(dt * rs)

    def inner(b):
        bs = b / dt
        tol = rel_tol * jnp.linalg.norm(bs)

        def cond(carry):
            x, r, z, p2, rz, k = carry
            return (jnp.linalg.norm(r) > tol) & (k < maxiter)

        def body(carry):
            x, r, z, p2, rz, k = carry
            Hp = mv_s(p2)
            pHp = dot(p2, Hp)
            alpha = jnp.where(pHp > 0, rz / pHp, 0.0)
            x = x + alpha * p2
            r = r - alpha * Hp
            z = M_s(r)
            rz2 = dot(r, z)
            beta = jnp.where(rz != 0, rz2 / rz, 0.0)
            p2 = z + beta * p2
            return (x, r, z, p2, rz2, k + 1)

        z0 = M_s(bs)
        x0 = jnp.zeros_like(bs)
        init = (x0, bs, z0, z0, dot(bs, z0), jnp.asarray(0, jnp.int32))
        x, r, _, _, _, k = lax.while_loop(cond, body, init)
        return x / dt, k

    from ..ops.ddarray import DD

    if not ops.dd:
        x, k = inner(g)
        return (x, k) if return_stats else x
    # double-float iterative refinement around the f32 V-cycle-CG corrector:
    # the equilibrated condition ~ t exceeds 1/eps(f32) near the reference
    # tolerance, so f32 CG alone cannot deliver the direction; dd residuals
    # against the error-free dd-block matvec restore it (same scheme as
    # dense_ir_solve, matrix-free). g arrives as a DD pair for the same
    # reason (amplification of its narrowing error).
    from .levelops import gram_matvec, y_matvec_dd

    if isinstance(g, DD):
        g_pair = (g.hi, g.lo)
    else:
        g_pair = (g, jnp.zeros_like(g))
    zeros = jnp.zeros_like(g_pair[0])
    rt = jnp.asarray(rel_tol, dtype)
    gnorm = jnp.sqrt(dot(g_pair[0], g_pair[0]))
    tau = jnp.asarray(IR_TAU, dtype) * rt * jnp.maximum(gnorm, 1e-30)

    # outer IR gated on the TRUE dd residual (see dense_ir_solve): each
    # skipped outer saves a full V-cycle-CG corrector solve
    def ocond(c):
        xh, xl, r, rnorm, ko, kcg = c
        return ((ko == 0) | (rnorm > tau)) & (ko < IR_OUTER)

    def obody(c):
        xh, xl, r, rnorm, ko, kcg = c
        delta, k_in = inner(r)
        xh, xl = df64.dd_add((xh, xl), (delta, zeros))
        hx = y_matvec_dd(ops, H.Ydd, xh)
        hx_lo = gram_matvec(ops, Lnode, xl)   # |xl| <= eps|xh|: f32 suffices
        rh, rl = df64.dd_sub(g_pair, hx)
        rh, rl = df64.dd_sub((rh, rl), (hx_lo, zeros))
        r = rh + rl
        return (xh, xl, r, jnp.sqrt(dot(r, r)), ko + 1, kcg + k_in)

    init = (zeros, zeros, g_pair[0] + g_pair[1], jnp.asarray(jnp.inf, dtype),
            jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))
    xh, xl, _, _, _, k_total = lax.while_loop(ocond, obody, init)
    x = xh + xl
    return (x, k_total) if return_stats else x


def stopping_exact(theta):
    """Stop when the objective AND the gradient norm both stagnate."""
    return ("exact", float(theta), -1.0)


def stopping_inexact(lambda_tol, theta):
    """Stop when the Newton decrement drops below lambda_tol, or exact."""
    return ("inexact", float(theta), float(lambda_tol))


def linesearch_backtracking(beta=0.5, c1=0.1):
    return ("backtracking", float(beta), float(c1))


def linesearch_illinois(beta=0.5):
    return ("illinois", float(beta), 0.0)


def _backtracking(Y, G, f0, f1, fargs, x, y, g, n_dir, inc, beta, c1):
    """Armijo backtracking; returns the last finite trial if the sufficient-
    decrease test never passes before s underflows (the reference's
    _linesearch_loop contract). Trials evaluate the objective only; the
    gradient is computed once at the returned point (it is only needed for
    the next Newton iteration and the stopping test, and on the dd path a
    per-trial f1 doubles the line-search cost)."""

    def cond(carry):
        s, _, _, accepted, trials = carry
        return (~accepted) & (s > 0) & (trials < _MAX_LS_TRIALS)

    def body(carry):
        s, xb, yb, _, trials = carry
        xn = x - s * n_dir
        yn = f0(xn, *fargs)
        ok = Y.isfinite(yn)
        stalled = jnp.linalg.norm(xn - x) == 0
        accept = ok & (stalled | Y.le(yn, Y.sub_f(y, c1 * inc * s)))
        xb = jnp.where(ok, xn, xb)
        yb = jnp.where(ok, yn, yb)
        return (jnp.where(accept, s, s * beta), xb, yb, accept, trials + 1)

    s0 = jnp.asarray(1.0, dtype=x.dtype)
    init = (s0, x, y, jnp.asarray(False), jnp.asarray(0, dtype=jnp.int32))
    _, xb, yb, _, _ = lax.while_loop(cond, body, init)
    gb = f1(xb, *fargs)
    # a non-finite gradient at an f0-finite point (barrier-term overflow at
    # the domain wall) falls back to the incoming iterate
    gok = G.finite(gb)
    xb = jnp.where(gok, xb, x)
    yb = jnp.where(gok, yb, y)
    gb = G.sel(gok, gb, g)
    return xb, yb, gb


def _illinois_root(phi, a, b, fa, fb, maxit=128):
    """Illinois variant of regula falsi for phi on [a, b] (device-safe)."""

    def cond(c):
        a, b, fa, fb, k, done = c
        return (~done) & (k < maxit)

    def body(c):
        a, b, fa, fb, k, done = c
        denom = jnp.where(fb - fa == 0, 1.0, fb - fa)
        x = (a * fb - b * fa) / denom
        fx = phi(x)
        out_of_bracket = (x <= jnp.minimum(a, b)) | (x >= jnp.maximum(a, b)) \
            | ~jnp.isfinite(fx)
        done2 = out_of_bracket | (fx * fa == 0) | (fx * fb == 0)
        opposite = fb * fx < 0
        a2 = jnp.where(opposite, b, a)
        fa2 = jnp.where(opposite, fb, fa / 2)
        return (a2, x, fa2, fx, k + 1, done2)

    a, b, fa, fb, _, _ = lax.while_loop(
        cond, body, (a, b, fa, fb, jnp.asarray(0, jnp.int32),
                     jnp.asarray(False)))
    return b


def _illinois_ls(Y, G, f0, f1, fargs, x, y, g, n_dir, inc, beta):
    """Exact line search: root of phi(s) = <grad f(x - s n), n>; falls back
    to shrinking s when the trial is rejected (non-finite)."""

    def phi(s):
        xn = x - s * n_dir
        yn = f0(xn, *fargs)
        gn = f1(xn, *fargs)
        return jnp.where(Y.isfinite(yn), G.dot(gn, n_dir), jnp.nan)

    def attempt(s):
        fb = phi(s)
        usable = jnp.isfinite(fb)
        s_root = jnp.where(
            usable,
            jnp.where(inc * fb >= 0, s,
                      _illinois_root(phi, jnp.zeros_like(s), s, inc, fb)),
            s)
        xn = x - s_root * n_dir
        yn = f0(xn, *fargs)
        gn = f1(xn, *fargs)
        ok = usable & Y.isfinite(yn) & G.finite(gn)
        return xn, yn, gn, ok

    def cond(carry):
        s, _, _, _, accepted, trials = carry
        return (~accepted) & (s > 0) & (trials < _MAX_LS_TRIALS)

    def body(carry):
        s, xb, yb, gb, _, trials = carry
        xn, yn, gn, ok = attempt(s)
        xb = jnp.where(ok, xn, xb)
        yb = jnp.where(ok, yn, yb)
        gb = G.sel(ok, gn, gb)
        return (jnp.where(ok, s, s * beta), xb, yb, gb, ok, trials + 1)

    init = (jnp.asarray(1.0, dtype=x.dtype), x, y, g, jnp.asarray(False),
            jnp.asarray(0, jnp.int32))
    _, xb, yb, gb, _, _ = lax.while_loop(cond, body, init)
    return xb, yb, gb


def make_newton_core(f0, f1, f2, *, line_search=("backtracking", 0.5, 0.1),
                     solve=None, dd=False, nd_dd=None):
    """Build the un-jitted Newton loop for embedding into larger programs
    (the fused t-ramp kernel jits a whole path-following loop around it).

    Returned fn signature:
    ``newton(x0, fargs, maxit, lambda_tol, theta) -> (x, y, k, status, cg)``
    where ``fargs`` are the extra arguments threaded to f0/f1/f2
    (ops, Dz0, wc, bw, args...), ``lambda_tol < 0`` selects the exact
    criterion, and ``cg`` is the total inner-CG iteration count across the
    run (0 for direct solves) — the honest-PCG diagnostic surfaced in
    MGBSOL.
    """
    ls_kind, ls_beta, ls_c1 = line_search
    if solve is None:
        def solve(H, g, pre=None, rtol=None):
            from .levelops import GramHessian

            if isinstance(H, GramHessian):
                if H.ctx is None or getattr(H.ctx, "nd", None) is not None:
                    # dense explicit inverse or nested-dissection factors:
                    # both run the same GMRES-IR machinery, only the
                    # preconditioner application differs
                    return dense_ir_solve(H, g, pre=pre, rtol=rtol,
                                          return_stats=True)
                return pcg_solve(H, g, pre=pre, rel_tol=rtol,
                                 return_stats=True)
            return equilibrated_solve(H, g), jnp.asarray(0, jnp.int32)

        def make_pre(H):
            # build the factorization chain once per centering and let
            # the CG corrector absorb the O(lambda) staleness
            from .levelops import GramHessian

            if isinstance(H, GramHessian):
                return make_dense_pre(H) if H.ctx is None \
                    else make_pcg_pre(H, nd_dd=nd_dd)
            return None
    else:
        _user_solve = solve

        def solve(H, g, pre=None, rtol=None):
            return _user_solve(H, g), jnp.asarray(0, jnp.int32)

        def make_pre(H):
            return None
    Y = _DDY if dd else _PlainY
    G = _DDG if dd else _PlainG

    # Roundoff floor for the lambda^2 <= 0 convergence test. The at-floor
    # CONVERGED window scales with |y| (which grows ~t through the ramp), so
    # it must sit at the OBJECTIVE's actual evaluation noise: on the dd path
    # everything through the decrement is double-float, noise ~2^-48|y| — a
    # floor at eps(f32)|y| would accept lambda up to ~4 near the target
    # t ~ 6.7e7 (|y| ~ 3e7). 16x margin over the dd ulp.
    dd_eps = 16.0 * 2.0 ** -48

    tight_rtol = IR_RTOL if dd else 1e-5

    def _predict(x0, fargs, H0, pre0, pred_r):
        """Central-path tangent predictor (warm start for one t-step).

        At the previous center the gradient is g(x, t) = G'(bw F1 + t wcc),
        so dg/dt = G' wcc and the path tangent is dx/dt = -H^{-1} G' wcc.
        The extrapolation is taken in 1/t, not t: in log-barrier
        coordinates the center is LINEAR in 1/t (scalar model
        min t c x - log x: x(t) = 1/(tc), where the t-tangent overshoots
        to x < 0 for kappa-sized jumps and the 1/t-tangent is exact), so
        x(t1) ~ x0 + (1/t1 - 1/t) dx/d(1/t) = x0 - (t/t1)(t1 - t) dx/dt.
        With fargs carrying wc = t1 * wcc this is x0 - r H0^{-1} G'(wc)
        with r = (t/t1)(1 - t/t1) — no extra operands needed. Measured at
        fem2d_P1 L=7 f64 (2x-budget baseline 289 its / 19 steps): t-tangent
        257 its / 14 steps, 1/t-tangent 251 its / 15 steps; fem2d_P2 L=6
        f64: 116 -> 105 its. Fewer steps because cheaper centerings keep
        kappa at kappa0. G'(wc) is f1 with the barrier weights
        masked to zero (bw == 0 nodes are dropped before arithmetic, so
        this is exact, not a small-residual trick), and H0/pre0 are already
        built at the previous center for the corrector. A fraction-to-
        boundary bisection keeps the warm start strictly inside the barrier
        domain; any failure falls back to the cold start. The reference has
        no predictor (pure corrector ramp, src/mgb.jl:91-183)."""
        ops, Dz0, wc, bw = fargs[0], fargs[1], fargs[2], fargs[3]
        rest = fargs[4:]

        def do(x0):
            g_lin = f1(x0, ops, Dz0, wc, jnp.zeros_like(bw), *rest)
            d, _ = solve(H0, g_lin, pre0,
                         jnp.asarray(RTOL_LOOSE, x0.dtype))
            step = pred_r * d
            step = jnp.where(jnp.all(jnp.isfinite(step)), step, 0.0)

            def fcond(c):
                s, accepted, k = c
                return (~accepted) & (k < 8)

            def fbody(c):
                s, accepted, k = c
                fin = Y.isfinite(f0(x0 - s * step, *fargs))
                return (jnp.where(fin, s, 0.5 * s), fin, k + 1)

            s, accepted, _ = lax.while_loop(
                fcond, fbody, (jnp.asarray(1.0, x0.dtype),
                               jnp.asarray(False), jnp.asarray(0, jnp.int32)))
            return x0 - jnp.where(accepted, s, 0.0) * step

        return lax.cond(pred_r > 0, do, lambda x: x, x0)

    def newton(x0, fargs, maxit, lambda_tol, theta, pred_r=None):
        dtype = x0.dtype
        epsT = jnp.asarray(dd_eps if dd else jnp.finfo(dtype).eps, dtype)
        H0 = f2(x0, *fargs)
        pre0 = make_pre(H0)
        if pred_r is not None:
            x0 = _predict(x0, fargs, H0, pre0, pred_r)
        y0 = f0(x0, *fargs)
        g0 = f1(x0, *fargs)
        ok0 = Y.isfinite(y0) & G.finite(g0)
        carry_pre = (PRE_REFRESH == "auto" and pre0 is not None
                     and _refresh_allowed(H0)
                     and not _always_refresh(H0, nd_dd))

        def cond(carry):
            (x, y, g, ymin, gmin, k, status, lam_prev, cg), _pc = carry
            return (status == RUNNING) & (k < maxit)

        def body(carry):
            (x, y, g, ymin, gmin, k, status, lam_prev, cg), _pc = carry
            from .levelops import GramHessian

            H = f2(x, *fargs)
            # inexact-Newton forcing: far from the centered point
            # (lam_prev >> lambda_tol) the direction only has to make line-
            # search progress, so the corrector tolerance is relaxed; any
            # iteration allowed to fire the inexact stop re-solves tight so
            # the reported decrement is honest (stop gated on ~use_loose).
            use_loose = (jnp.asarray(FORCING)
                         & (lambda_tol >= 0)
                         & (lam_prev > 8.0 * lambda_tol))
            rtol_k = jnp.where(use_loose, RTOL_LOOSE, tight_rtol).astype(dtype)
            if PRE_REFRESH == "1" or _always_refresh(H, nd_dd):
                pre_k = make_pre(H)
            elif carry_pre:
                pre_prev, cg_last = _pc
                pre_k = lax.cond(cg_last > _refresh_at(H),
                                 lambda: make_pre(H), lambda: pre_prev)
            else:
                pre_k = pre0
            n_dir, k_cg = solve(H, g, pre_k, rtol_k)
            inc = G.dot(g, n_dir)
            if _os.environ.get("MGBTPU_IR_DEBUG"):  # pragma: no cover
                jax.debug.print(
                    "newton it {k}: cg={c} inc={i} loose={lo}",
                    k=k, c=k_cg, i=inc, lo=use_loose)
            if _os.environ.get("MGBTPU_IR_DUMP"):  # pragma: no cover
                _dump_at = int(_os.environ.get("MGBTPU_IR_DUMP_AT", 250))

                def _dump(xv, dzh, dzl, wcv, kcgv, _at=_dump_at):
                    import numpy as _n
                    if int(kcgv) > _at:
                        import time as _t
                        _n.savez(f"/tmp/heavy_{int(_t.time()*1e6) % 10**9}"
                                 f"_{int(kcgv)}.npz", x=xv, dzh=dzh, dzl=dzl,
                                 wc=wcv)
                from ..ops.ddarray import DD as _DDx
                _dz = fargs[1]
                _dzh, _dzl = (_dz.hi, _dz.lo) if isinstance(_dz, _DDx) \
                    else (_dz, _dz)
                jax.debug.callback(_dump, x, _dzh, _dzl, fargs[2], k_cg)
            if not dd and not isinstance(H, GramHessian):
                # lambda^2 <= 0 away from the objective roundoff floor: the
                # Hessian solve failed (iterate pinned to the barrier wall).
                # Retry once with the regularized fallback direction; its
                # decrement is a different quadratic form, so the inexact
                # stop is suppressed on fallback iterations. (The dd path
                # assembles H in Gram form — PSD by construction — so its
                # shifted-Cholesky solve cannot produce lambda^2 <= 0 and
                # the fallback would only bloat the program.)
                at_floor0 = jnp.abs(inc) <= epsT * jnp.maximum(
                    jnp.abs(Y.hi(y)), 1.0)
                need_fb = (inc <= 0) & ~at_floor0 & jnp.all(jnp.isfinite(H))
                n_dir = lax.cond(need_fb,
                                 lambda _: regularized_direction(H, g),
                                 lambda _: n_dir, None)
                inc = jnp.where(need_fb, G.dot(g, n_dir), inc)
            else:
                need_fb = jnp.asarray(False)
            dir_ok = jnp.all(jnp.isfinite(n_dir))
            # lambda^2 <= 0 (post-fallback): converged only at the objective
            # roundoff floor, else report failure so the caller bisects /
            # shrinks kappa (reference newton.jl:256-270)
            # floor window: the objective's evaluation noise, OR lambda at
            # most lambda_tol/4 (inexact mode) — honest acceptance at any
            # |y| scale (|y| grows ~t through the ramp)
            at_floor = jnp.abs(inc) <= jnp.maximum(
                epsT * jnp.maximum(jnp.abs(Y.hi(y)), 1.0),
                jnp.where(lambda_tol >= 0, (0.25 * lambda_tol) ** 2, 0.0))
            bad_inc = inc <= 0

            if ls_kind == "illinois":
                xn, yn, gn = _illinois_ls(Y, G, f0, f1, fargs, x, y, g, n_dir,
                                          inc, ls_beta)
            else:
                xn, yn, gn = _backtracking(Y, G, f0, f1, fargs, x, y, g, n_dir,
                                           inc, ls_beta, ls_c1)
            sqrt_inc = jnp.sqrt(jnp.maximum(inc, 0.0))
            stop_inexact = ((lambda_tol >= 0) & (sqrt_inc < lambda_tol)
                            & ~need_fb & ~use_loose)
            stop_exact = Y.le(ymin, yn) & (G.norm(gn) >= theta * gmin)
            stopped = stop_inexact | stop_exact

            status = jnp.where(
                ~dir_ok, BAD_DIRECTION,
                jnp.where(bad_inc,
                          jnp.where(at_floor, CONVERGED, BAD_HESSIAN),
                          jnp.where(stopped, CONVERGED, RUNNING))
            ).astype(jnp.int32)
            take = dir_ok & ~bad_inc
            x2 = jnp.where(take, xn, x)
            y2 = jax.tree_util.tree_map(
                lambda a, b: jnp.where(take, a, b), yn, y)
            g2 = G.sel(take, gn, g)
            pc2 = (pre_k, k_cg) if carry_pre else _pc
            return ((x2, y2, g2,
                     Y.minimum(ymin, y2),
                     jnp.minimum(gmin, G.norm(g2)),
                     k + 1, status,
                     jnp.where(take, sqrt_inc, lam_prev), cg + k_cg), pc2)

        init = ((x0, y0, g0, y0, G.norm(g0),
                 jnp.asarray(0, jnp.int32),
                 jnp.where(ok0, RUNNING, BAD_INIT).astype(jnp.int32),
                 jnp.asarray(jnp.inf, x0.dtype), jnp.asarray(0, jnp.int32)),
                (pre0, jnp.asarray(0, jnp.int32)) if carry_pre else ())
        ((x, y, g, ymin, gmin, k, status, lam_prev, cg),
         _pc) = lax.while_loop(cond, body, init)
        status = jnp.where(status == RUNNING, DIVERGED, status)
        return x, Y.value(y), k, status, cg

    return newton


def make_newton(f0, f1, f2, *, line_search=("backtracking", 0.5, 0.1),
                solve=None, dd=False, nd_dd=None):
    """The jitted Newton runner (see ``make_newton_core`` for the contract)."""
    return jax.jit(make_newton_core(f0, f1, f2, line_search=line_search,
                                    solve=solve, dd=dd, nd_dd=nd_dd))
