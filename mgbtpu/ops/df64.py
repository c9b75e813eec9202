"""Double-float ("df64") arithmetic: ~49-bit-mantissa reals as float32 pairs.

The float32 solve path (``dtype=np.float32``) emulates float64 where the
multigrid barrier method needs higher-than-f32 accuracy in exactly two places — the reductions that
assemble the Newton system (sums of PSD per-node contributions whose f32
rounding makes the assembled Hessian numerically indefinite) and the solve's
residual/decrement dot products. This module provides error-free transforms
(Knuth two_sum, Dekker split/two_prod — all plain IEEE f32 adds/muls, no FMA
required) and fully vectorized pairwise tree reductions over an axis, so
every df64 reduction is a log-depth chain of elementwise ops.

A df64 value is a pair (hi, lo) with |lo| <= ulp(hi)/2; arrays are pairs of
equal-shape f32 arrays. Relative accuracy ~ 2^-48 ~ 4e-15.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_SPLIT = 4097.0  # 2^12 + 1 (Dekker splitting constant for float32)


def two_sum(a, b):
    """Error-free a + b = s + e (Knuth, 6 flops, no branch)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def quick_two_sum(a, b):
    """Error-free a + b = s + e assuming |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free a * b = p + e via Dekker splitting (IEEE f32 ops only)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dd_add(x, y):
    """(hi,lo) + (hi,lo) -> (hi,lo)."""
    xh, xl = x
    yh, yl = y
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    return quick_two_sum(s, e)


def dd_add_f(x, b):
    xh, xl = x
    s, e = two_sum(xh, b)
    return quick_two_sum(s, e + xl)


def dd_neg(x):
    return (-x[0], -x[1])


def dd_sub(x, y):
    return dd_add(x, dd_neg(y))


def dd_mul_f(x, b):
    """(hi,lo) * f32 -> (hi,lo)."""
    xh, xl = x
    p, e = two_prod(xh, b)
    e = e + xl * b
    return quick_two_sum(p, e)


def dd_mul(x, y):
    xh, xl = x
    yh, yl = y
    p, e = two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return quick_two_sum(p, e)


def dd_from_f(a):
    return (a, jnp.zeros_like(a))


def dd_to_f(x):
    return x[0] + x[1]


def dd_tree_sum(x, axis):
    """Pairwise (tree) reduction of a df64 array along ``axis``.

    log2(K) vectorized dd_add rounds; equivalent accuracy to sequential
    compensated summation but fully parallel.
    """
    hi, lo = x
    hi = jnp.moveaxis(hi, axis, -1)
    lo = jnp.moveaxis(lo, axis, -1)
    n = hi.shape[-1]
    while n > 1:
        m = n // 2
        a = (hi[..., :m], lo[..., :m])
        b = (hi[..., m:2 * m], lo[..., m:2 * m])
        s = dd_add(a, b)
        if n % 2:
            sh = jnp.concatenate([s[0], hi[..., -1:]], axis=-1)
            sl = jnp.concatenate([s[1], lo[..., -1:]], axis=-1)
        else:
            sh, sl = s
        hi, lo = sh, sl
        n = hi.shape[-1]
    return hi[..., 0], lo[..., 0]


def dd_dot(a, b):
    """df64 dot product of two f32 vectors."""
    p, e = two_prod(a, b)
    return dd_tree_sum((p, e), axis=-1)


def dd_sum_f(a, axis):
    """df64 sum of an f32 array along axis."""
    return dd_tree_sum((a, jnp.zeros_like(a)), axis=axis)


def dd_matvec(Ah, Al, x):
    """df64 matvec: (Ah + Al) @ x with x f32; returns a df64 pair."""
    p, e = two_prod(Ah, x[None, :])
    e = e + Al * x[None, :]
    return dd_tree_sum((p, e), axis=-1)


# ---------------------------------------------------------------------------
# Elementwise dd algebra and transcendentals (the per-node barrier-derivative
# kit: the catastrophic cancellation r = s^alpha - |q|^2 has r ~ 1/t, so f32
# evaluation noise is amplified by t ~ 1/tol; evaluated in dd it stays at
# ~2^-48 relative).
# ---------------------------------------------------------------------------

import numpy as _np


def dd_sqr(x):
    xh, xl = x
    p, e = two_prod(xh, xh)
    e = e + 2.0 * (xh * xl)
    return quick_two_sum(p, e)


def dd_recip(y):
    """1 / y to dd accuracy (Newton on the f32 reciprocal)."""
    yh, yl = y
    r0 = 1.0 / yh
    p, pe = two_prod(yh, r0)
    e = ((1.0 - p) - pe) - yl * r0          # 1 - y*r0, |e| ~ eps
    corr = r0 * (e * (1.0 + e))             # r0*(e + e^2); e^3 below dd eps
    return quick_two_sum(r0, corr)


def dd_div(x, y):
    return dd_mul(x, dd_recip(y))


def dd_sqrt(x):
    """sqrt(x) to dd accuracy; NaN for x < 0 (propagates), 0 at 0."""
    xh, xl = x
    s0 = jnp.sqrt(xh)
    p, pe = two_prod(s0, s0)
    d = ((xh - p) - pe) + xl                # x - s0^2, |d| ~ eps*x
    denom = jnp.where(s0 > 0, 2.0 * s0, 1.0)
    corr = jnp.where(s0 > 0, d / denom, 0.0)
    return quick_two_sum(s0, corr)


_LN2 = 0.6931471805599453
_LN2_HI = _np.float32(_LN2)
_LN2_LO = _np.float32(_LN2 - float(_np.float32(_LN2)))
# inverse factorials 1/k! for k = 2..13 as (hi, lo) f32 splits
_INV_FACT = []
for _k in range(2, 14):
    _v = 1.0
    for _j in range(2, _k + 1):
        _v /= _j
    _h = _np.float32(_v)
    _INV_FACT.append((_h, _np.float32(_v - float(_h))))


def dd_exp(x):
    """exp(x) to ~dd accuracy: range reduction by ln2 + degree-13 Taylor.

    x = k*ln2 + r with |r| <= ln2/2; exp(r) by Taylor (term 14 is below
    2^-49 at this radius); scale by 2^k. -inf -> 0, +inf -> inf.
    """
    xh, xl = x
    k = jnp.round(xh / _np.float32(_LN2))
    kc = jnp.clip(k, -126.0, 126.0)          # keep 2^k finite/normal
    ln2 = (jnp.full_like(xh, _LN2_HI), jnp.full_like(xh, _LN2_LO))
    r = dd_sub((xh, xl), dd_mul_f(ln2, kc))
    # Horner in dd: p = 1/13! ; p = p*r + 1/12! ; ... ; p = p*r + 1/2!
    p = (jnp.full_like(xh, _INV_FACT[-1][0]),
         jnp.full_like(xh, _INV_FACT[-1][1]))
    for c in reversed(_INV_FACT[:-1]):
        p = dd_mul(p, r)
        p = dd_add(p, (jnp.full_like(xh, c[0]), jnp.full_like(xh, c[1])))
    # exp(r) = 1 + r + r^2 * p
    p = dd_mul(p, dd_sqr(r))
    p = dd_add(p, r)
    p = dd_add_f(p, 1.0)
    # 2^k must be EXACT (jnp.exp2 lowers to exp(k*ln2): 1e-6-level error);
    # build it from the IEEE exponent bits
    scale = jax.lax.bitcast_convert_type(
        ((kc.astype(jnp.int32) + 127) << 23).astype(jnp.int32), jnp.float32)
    h, l = p[0] * scale, p[1] * scale
    big = xh > 88.0                          # exp overflows f32
    neg = xh < -88.0
    h = jnp.where(big, jnp.inf, jnp.where(neg, 0.0, h))
    l = jnp.where(big | neg, 0.0, l)
    nan = jnp.isnan(xh)
    h = jnp.where(nan, jnp.nan, h)
    return h, l


def dd_log(x):
    """log(x) to ~dd accuracy for x > 0 (one dd Newton step on f32 log);
    x <= 0 -> -inf (0) / NaN (negative), matching jnp.log."""
    xh, xl = x
    pos = xh > 0
    safe = jnp.where(pos, xh, 1.0)
    y0 = jnp.log(safe)
    w = dd_mul((jnp.where(pos, xh, 1.0), jnp.where(pos, xl, 0.0)),
               dd_exp((-y0, jnp.zeros_like(y0))))
    e = dd_add_f(w, -1.0)                    # x*exp(-y0) - 1, |e| ~ eps
    corr = dd_sub(e, dd_mul_f(dd_sqr(e), 0.5))
    h, l = dd_add(corr, (y0, jnp.zeros_like(y0)))
    neg = xh < 0
    h = jnp.where(pos, h, jnp.where(neg, jnp.nan, -jnp.inf))
    l = jnp.where(pos, l, 0.0)
    inf = jnp.isinf(xh) & pos
    h = jnp.where(inf, jnp.inf, h)
    l = jnp.where(inf, 0.0, l)
    h = jnp.where(jnp.isnan(xh), jnp.nan, h)
    return h, l


def dd_log_barrier(x):
    """The convex programmer's Log in dd: log(x) for x > 0, else -inf."""
    h, l = dd_log(x)
    bad = ~(x[0] > 0)
    return jnp.where(bad, -jnp.inf, h), jnp.where(bad, 0.0, l)


def dd_pow(x, a):
    """x**a as exp(a * Log(x)) in dd; a is f32 (or a dd pair).

    Matches safe_pow semantics: x <= 0 with a > 0 -> 0 (exp(-inf)), so
    enclosing barrier terms go +/-inf and the trial is rejected.
    """
    lg = dd_log_barrier(x)
    t = dd_mul(lg, a) if isinstance(a, tuple) else dd_mul_f(lg, a)
    # exp of (-inf) hi with a*(-inf) = nan when a == 0: pow(x<=0, 0) -> 1
    return dd_exp(t)


def dd_dot_pair(a, b, axis=-1):
    """dd dot product of two dd arrays along ``axis``."""
    p = dd_mul(a, b)
    return dd_tree_sum(p, axis=axis)


def dd_mv(A, x, b=None):
    """A @ x (+ b) with f32 matrix A (..., m, n) and dd vector x (..., n)
    -> dd (..., m). Products are error-free; reduction is a dd tree sum."""
    xh, xl = x
    ph, pe = two_prod(A, xh[..., None, :])
    pe = pe + A * xl[..., None, :]
    h, l = dd_tree_sum((ph, pe), axis=-1)
    if b is not None:
        h, l = dd_add((h, l), (b, jnp.zeros_like(b)))
    return h, l


def f64_split(a, dtype=_np.float32):
    """Split a float64 host array into an (hi, lo) f32 pair (error-free)."""
    a = _np.asarray(a, dtype=_np.float64)
    hi = a.astype(dtype)
    lo = (a - hi.astype(_np.float64)).astype(dtype)
    return hi, lo


# ---------------------------------------------------------------------------
# Stacked df64 scalars: shape (2,) arrays [hi, lo] flowing through jit carries
# (objective values in the float32 Newton path — their differences along a
# line search are ~lambda^2, far below the f32 ulp of the value itself).
# ---------------------------------------------------------------------------

def s_pack(hi, lo=None):
    hi = jnp.asarray(hi)
    lo = jnp.zeros_like(hi) if lo is None else lo
    return jnp.stack([hi, lo])


def s_hi(y):
    return y[0]


def s_val(y):
    return y[0] + y[1]


def s_add_f(y, b):
    s, e = two_sum(y[0], b)
    s2, e2 = quick_two_sum(s, e + y[1])
    return jnp.stack([s2, e2])


def s_le(a, b):
    """a <= b for stacked dd scalars (normalized -> lexicographic)."""
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] <= b[1]))


def s_min(a, b):
    return jnp.where(s_le(a, b), a, b)


def s_isfinite(y):
    return jnp.isfinite(y[0]) & jnp.isfinite(y[1])
