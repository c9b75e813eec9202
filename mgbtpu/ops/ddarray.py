"""DD: double-float arrays with numpy-style operators.

The per-node barrier derivative evaluations contain catastrophic
cancellations (the power-cone residual r = s^(2/p) - ||q||^2 is ~1/t at
active nodes while its operands are O(1): f32 evaluation noise there is
amplified by t ~ 1/tol and floors the computed Newton decrement around
3e-3 — the round-1 accuracy wall). Writing the per-node barrier functions
generically over the scalar type and feeding them ``DD`` inputs evaluates
them in double-float (~2^-48 relative) with zero code duplication: the same
source serves the f64 path with plain arrays and the f32 path with DD.

A ``DD`` wraps (hi, lo) f32 arrays with |lo| <= ulp(hi)/2 and overloads
``+ - * / ** @``, indexing, ``sum``; ``Log``/``safe_pow`` in
``mgbtpu.utils.log`` dispatch on the type, and the helpers below
(``cat``, ``zeros_like_spec``, ``.at[...]``) cover the jnp idioms the
barrier code uses. Infinities entering dd arithmetic may degrade to NaN
(inf - inf in the error terms): both are rejected by the solver's
finiteness checks, so domain-escape semantics are preserved.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from . import df64


def _as_pair(v):
    """Promote a plain array/scalar to an exact (hi, lo=0) pair."""
    if isinstance(v, DD):
        return v.hi, v.lo
    v = jnp.asarray(v)
    return v, jnp.zeros_like(v)


class DD:
    """Double-float array: hi + lo with numpy-style operators."""

    __slots__ = ("hi", "lo")
    __array_priority__ = 200  # DD ops win over numpy's

    def __init__(self, hi, lo=None):
        self.hi = jnp.asarray(hi)
        self.lo = jnp.zeros_like(self.hi) if lo is None else jnp.asarray(lo)

    # -- pytree ------------------------------------------------------------
    def tree_flatten(self):
        return (self.hi, self.lo), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.hi, obj.lo = children
        return obj

    # -- shape/introspection -------------------------------------------------
    @property
    def shape(self):
        return self.hi.shape

    @property
    def ndim(self):
        return self.hi.ndim

    @property
    def dtype(self):
        return self.hi.dtype

    def __len__(self):
        return len(self.hi)

    def fl(self):
        """Narrow to a plain array (correctly rounded)."""
        return self.hi + self.lo

    def __repr__(self):
        return f"DD({self.hi!r}, {self.lo!r})"

    # -- indexing ------------------------------------------------------------
    def __getitem__(self, i):
        return DD(self.hi[i], self.lo[i])

    def reshape(self, *s):
        return DD(self.hi.reshape(*s), self.lo.reshape(*s))

    @property
    def T(self):
        return DD(self.hi.T, self.lo.T)

    @property
    def at(self):
        return _At(self)

    # -- arithmetic ------------------------------------------------------------
    def __neg__(self):
        return DD(-self.hi, -self.lo)

    def __add__(self, o):
        return DD(*df64.dd_add((self.hi, self.lo), _as_pair(o)))

    __radd__ = __add__

    def __sub__(self, o):
        return DD(*df64.dd_sub((self.hi, self.lo), _as_pair(o)))

    def __rsub__(self, o):
        return DD(*df64.dd_sub(_as_pair(o), (self.hi, self.lo)))

    def __mul__(self, o):
        if isinstance(o, DD):
            return DD(*df64.dd_mul((self.hi, self.lo), (o.hi, o.lo)))
        return DD(*df64.dd_mul_f((self.hi, self.lo), jnp.asarray(o)))

    __rmul__ = __mul__

    def __truediv__(self, o):
        return DD(*df64.dd_div((self.hi, self.lo), _as_pair(o)))

    def __rtruediv__(self, o):
        return DD(*df64.dd_div(_as_pair(o), (self.hi, self.lo)))

    def __pow__(self, a):
        if isinstance(a, DD):
            return DD(*df64.dd_pow((self.hi, self.lo), (a.hi, a.lo)))
        return DD(*df64.dd_pow((self.hi, self.lo), jnp.asarray(a)))

    def __matmul__(self, o):
        return matmul(self, o)

    def __rmatmul__(self, o):
        return matmul(o, self)

    # -- comparisons (on the narrowed value; used only for masks) -----------
    def _cmp(self, o, op):
        ov = o.fl() if isinstance(o, DD) else o
        return op(self.fl(), ov)

    def __lt__(self, o):
        return self._cmp(o, jnp.less)

    def __le__(self, o):
        return self._cmp(o, jnp.less_equal)

    def __gt__(self, o):
        return self._cmp(o, jnp.greater)

    def __ge__(self, o):
        return self._cmp(o, jnp.greater_equal)

    # -- reductions ------------------------------------------------------------
    def sum(self, axis=None):
        if axis is None:
            h, l = self.hi.reshape(-1), self.lo.reshape(-1)
            return DD(*df64.dd_tree_sum((h, l), axis=0))
        return DD(*df64.dd_tree_sum((self.hi, self.lo), axis=axis))


class _At:
    def __init__(self, d):
        self._d = d

    def __getitem__(self, i):
        return _AtIdx(self._d, i)


class _AtIdx:
    def __init__(self, d, i):
        self._d, self._i = d, i

    def set(self, v):
        vh, vl = _as_pair(v)
        return DD(self._d.hi.at[self._i].set(vh),
                  self._d.lo.at[self._i].set(vl))

    def add(self, v):
        # exact-sum add is overkill for the scatter sites the barrier code
        # uses (disjoint index sets); plain componentwise add is enough
        vh, vl = _as_pair(v)
        return DD(self._d.hi.at[self._i].add(vh),
                  self._d.lo.at[self._i].add(vl))


jax.tree_util.register_pytree_node(
    DD, lambda d: d.tree_flatten(), DD.tree_unflatten)
from ..utils.pytree import register_export_serialization  # noqa: E402

register_export_serialization(DD)


# ---------------------------------------------------------------------------
# numpy-style module functions, DD-aware (fall through to jnp on plain input)
# ---------------------------------------------------------------------------

def is_dd(*vs):
    return any(isinstance(v, DD) for v in vs)


def matmul(a, b):
    """a @ b for any mix of DD and plain arrays (1D/2D operands)."""
    if not is_dd(a, b):
        return jnp.asarray(a) @ jnp.asarray(b)
    ah, al = _as_pair(a)
    bh, bl = _as_pair(b)
    a1 = ah.ndim == 1
    b1 = bh.ndim == 1
    if a1:
        ah, al = ah[None, :], al[None, :]
    if b1:
        bh, bl = bh[:, None], bl[:, None]
    # result[i, j] = sum_k a[i, k] b[k, j] in dd
    ph, pl = df64.dd_mul((ah[:, :, None], al[:, :, None]),
                         (bh[None, :, :], bl[None, :, :]))
    h, l = df64.dd_tree_sum((ph, pl), axis=1)
    if a1:
        h, l = h[0], l[0]
    if b1:
        h, l = (h[..., 0], l[..., 0])
    return DD(h, l)


def cat(parts, axis=0):
    """concatenate, DD-aware (any DD part promotes the result)."""
    if not is_dd(*parts):
        return jnp.concatenate(parts, axis=axis)
    pairs = [_as_pair(p) for p in parts]
    return DD(jnp.concatenate([p[0] for p in pairs], axis=axis),
              jnp.concatenate([p[1] for p in pairs], axis=axis))


def outer(a, b):
    if not is_dd(a, b):
        return jnp.outer(a, b)
    ah, al = _as_pair(a)
    bh, bl = _as_pair(b)
    return DD(*df64.dd_mul((ah[:, None], al[:, None]),
                           (bh[None, :], bl[None, :])))


def where(c, a, b):
    if not is_dd(a, b):
        return jnp.where(c, a, b)
    ah, al = _as_pair(a)
    bh, bl = _as_pair(b)
    return DD(jnp.where(c, ah, bh), jnp.where(c, al, bl))


def zeros(shape, like):
    """Zeros of the same kind (DD or plain) and dtype as ``like``."""
    if isinstance(like, DD):
        z = jnp.zeros(shape, dtype=like.dtype)
        return DD(z, z)
    return jnp.zeros(shape, dtype=like.dtype)


def dd_log(x):
    return DD(*df64.dd_log_barrier((x.hi, x.lo)))


def dd_exp(x):
    return DD(*df64.dd_exp((x.hi, x.lo)))


def dd_sqrt(x):
    return DD(*df64.dd_sqrt((x.hi, x.lo)))


def hi(x):
    """The leading component (plain array) of a DD or plain value."""
    return x.hi if isinstance(x, DD) else x


def fl(x):
    """Narrow a DD (or pass through a plain value) to a plain array."""
    return x.fl() if isinstance(x, DD) else x
