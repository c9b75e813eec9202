"""Double-float GEMM from bf16 matmuls via Ozaki-style error-free slicing.

The dd multifrontal factorization (ops/ndchol.py + ops/ddlinalg.py) was
built on elementwise error-free transforms: its Schur/SYRK updates and
triangular-solve GEMMs cost ~30 flops per inner element, O(n^1.5) total
per factorization — the dominant per-Newton-iteration cost at deep levels.

This module computes dd-accurate matrix products as a small number of
bf16 matmuls (the Ozaki scheme, cf. Ozaki et al. 2012 / modern
"matmul emulation" on low-precision units):

- Each dd operand row is scaled by a power of two (its running-max
  exponent) and split into S slices of s mantissa bits each; each slice
  is EXACTLY representable in bfloat16 (s <= 7 plus a carry bit).
- Products of two slices are exact in f32, and a length-n sum of such
  products stays exact when 2*s + ceil(log2 n) <= 22 — s is chosen per
  call from the inner dimension, so every matmul
  (bf16 x bf16 -> f32 accumulation) is ERROR-FREE.
- The ~S(S+1)/2 exact partial products are combined with a compensated
  (two_sum) tree reduction and rescaled; dropped slices contribute below
  ~2^-48 of the row scale — the same backward-error level as the
  elementwise dd pipeline, at matmul throughput.

Used by ops/ddlinalg.py for the Schur SYRK and the blocked triangular
solve / Cholesky trailing updates whenever the inner dimension crosses
OZAKI_MIN_INNER; the rolled elementwise path remains for small fronts and as the
oracle in tests.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from . import df64

# below this inner dimension the slicing overhead beats the split-GEMM
# win; tunable for sweeps
import os as _os

OZAKI_MIN_INNER = int(_os.environ.get("MGBTPU_OZAKI_MIN_INNER", 32))
# target significand coverage (bits): dd carries ~48; one extra slice of
# margin keeps the dropped tail below the dd pipeline's own roundoff.
# Tunable (MGBTPU_OZAKI_BITS) for precision/speed A-Bs: the factor only
# PRECONDITIONS an IR/CG loop, so a ~2^-b factor with b >= log2(kappa)+4
# still converges — fewer slices = quadratically fewer matmuls.
_TARGET_BITS = int(_os.environ.get("MGBTPU_OZAKI_BITS", 49))


def _slice_params(n_inner: int):
    """Slice width s (bits) and slice count S for an exact f32 accumulation
    of length-``n_inner`` products: 2s + ceil(log2 n) <= 22."""
    lg = max(1, int(np.ceil(np.log2(max(n_inner, 2)))))
    s = max(1, min(7, (22 - lg) // 2))
    S = int(np.ceil(_TARGET_BITS / s)) + 1
    return s, S


def _row_scale(Ah, axis):
    """Power-of-two per-row scale sigma >= max|Ah| along ``axis`` (1 for
    all-zero rows), and its exact reciprocal.

    Exponent extraction by f32 bit manipulation (bitcast + shift) instead
    of frexp/ldexp: identical semantics on the normal range, guaranteed
    lowering on every backend, and no transcendental path."""
    m = jnp.max(jnp.abs(Ah), axis=axis, keepdims=True)
    m = jnp.where(m > 0, m, 1.0).astype(jnp.float32)
    bits = lax.bitcast_convert_type(m, jnp.int32)
    b = (bits >> 23) & 0xFF                       # biased exponent
    frac = (bits & 0x7FFFFF) != 0
    bp = jnp.clip(b + frac.astype(jnp.int32), 1, 253)  # ceil(log2 m) + 127
    sigma = lax.bitcast_convert_type((bp << 23), jnp.float32)
    sigma_inv = lax.bitcast_convert_type(((254 - bp) << 23), jnp.float32)
    return sigma.astype(Ah.dtype), sigma_inv.astype(Ah.dtype)


def _slices(xh, xl, s: int, S: int):
    """Split a row-scaled dd array (|x| <= 1) into S bf16 slices of s bits.

    Slice i is x rounded to a multiple of 2^{-(i+1)s} after removing the
    previous slices; extraction and removal are error-free, so
    sum(slices) == x up to the dropped sub-2^{-Ss} tail.
    """
    out = []
    rh, rl = xh, xl
    for i in range(S):
        k = (i + 1) * s
        # truncate to the absolute grid 2^-k via scale/trunc/unscale: all
        # three steps are exact (|rh * 2^k| < 2^s+1 << 2^24; powers of two
        # rescale exactly), and trunc has no algebraic identity for XLA to
        # fold — the classic (x + C) - C rounding trick gets simplified or
        # recomputed across fusion boundaries on XLA:CPU (measured 2e-3
        # relative corruption under jit), this form survives jit on every
        # backend
        up = jnp.asarray(2.0 ** k, rh.dtype)
        t = jnp.trunc(rh * up) * jnp.asarray(2.0 ** -k, rh.dtype)
        rh = rh - t                          # exact (t matches top bits)
        # renormalize: pull lo-word bits up once the remainder digs below
        # the hi word's precision (two_sum, not quick_two_sum: deep in the
        # extraction |rl| can exceed the shrinking |rh|)
        rh, rl = df64.two_sum(rh, rl)
        out.append(t.astype(jnp.bfloat16))
    return out


def _combine(parts, weights=None, s=0):
    """Compensated tree-sum of exact f32 partial products -> dd.

    With ``weights`` (slice-index sum i+j per part) and slice width ``s``:
    parts in a weight class k with k*s >= 29 are PLAIN-f32 summed within
    the class first, and only the class sums enter the compensated tree.
    A class of g <= 16 parts at magnitude <= n * 2^{-ks} plain-sums with
    error < g * eps32 * n * 2^{-ks} <= n * 2^{-49} — below the dd
    pipeline's own ~2^-48 tail — while the tree shrinks from S(S+1)/2
    parts to ~half. The combine is the measured dominant elementwise cost of the
    factor-path GEMMs at inner dim 32 (36 compensated parts per product
    at the default 49 bits), so this is latency on the ND critical path,
    not bookkeeping."""
    if weights is not None and s > 0:
        head, classes = [], {}
        for w, p in zip(weights, parts):
            if w * s >= 29:
                classes.setdefault(w, []).append(p)
            else:
                head.append(p)
        for w in sorted(classes):
            acc = classes[w][0]
            for p in classes[w][1:]:
                acc = acc + p
            head.append(acc)
        parts = head
    hi = jnp.stack(parts, axis=0)
    return df64.dd_tree_sum((hi, jnp.zeros_like(hi)), axis=0)


def dd_matmul_nt(A, B):
    """dd A @ B^T: A = (Ah, Al) (..., m, n), B = (Bh, Bl) (..., p, n) ->
    dd (..., m, p), accurate to ~2^-48 of the row-scale products."""
    Ah, Al = A
    Bh, Bl = B
    n = Ah.shape[-1]
    s, S = _slice_params(n)
    sa, sa_inv = _row_scale(Ah, axis=-1)
    sb, sb_inv = _row_scale(Bh, axis=-1)
    ta = _slices(Ah * sa_inv, Al * sa_inv, s, S)
    tb = _slices(Bh * sb_inv, Bl * sb_inv, s, S)

    nbatch = Ah.ndim - 2
    dnums = (((Ah.ndim - 1,), (Bh.ndim - 1,)),
             (tuple(range(nbatch)), tuple(range(nbatch))))
    parts, wts = [], []
    for i in range(S):
        for j in range(S - i):
            parts.append(lax.dot_general(
                ta[i], tb[j], dnums, preferred_element_type=jnp.float32))
            wts.append(i + j)
    oh, ol = _combine(parts, wts, s)
    # rescale: power-of-two multiplies are exact
    sc = sa * jnp.swapaxes(sb, -1, -2)
    return oh * sc, ol * sc


def dd_matmul_exact_nt(A, B, b_bits: int = 1):
    """dd A (..., m, n) @ exact B^T (B (..., p, n)) where B's entries are
    EXACTLY representable in bf16 with <= ``b_bits`` significand bits
    (e.g. 0/1 incidence panels: 1 bit). Only A is sliced, so the product
    costs S matmuls instead of S(S+1)/2 — the fast path of the one-hot
    GEMM-form front assembly (ops/ndchol.py). Exactness: an s-bit slice
    times a b-bit value is exact in f32, and a length-n accumulation of
    such products is exact when s + b_bits + ceil(log2 n) <= 22."""
    Ah, Al = A
    n = Ah.shape[-1]
    lg = max(1, int(np.ceil(np.log2(max(n, 2)))))
    s = max(1, min(7, 22 - b_bits - lg))
    S = int(np.ceil(_TARGET_BITS / s)) + 1
    sa, sa_inv = _row_scale(Ah, axis=-1)
    ta = _slices(Ah * sa_inv, Al * sa_inv, s, S)
    Bb = B.astype(jnp.bfloat16)

    nbatch = Ah.ndim - 2
    dnums = (((Ah.ndim - 1,), (B.ndim - 1,)),
             (tuple(range(nbatch)), tuple(range(nbatch))))
    parts = [lax.dot_general(ta[i], Bb, dnums,
                             preferred_element_type=jnp.float32)
             for i in range(S)]
    oh, ol = _combine(parts)
    return oh * sa, ol * sa


def dd_syrk_ozaki(C, U):
    """dd C - U @ U^T with one slicing of U (SYRK symmetry: P_ij' = P_ji)."""
    Ch, Cl = C
    Uh, Ul = U
    n = Uh.shape[-1]
    s, S = _slice_params(n)
    su, su_inv = _row_scale(Uh, axis=-1)
    t = _slices(Uh * su_inv, Ul * su_inv, s, S)

    nbatch = Uh.ndim - 2
    dnums = (((Uh.ndim - 1,), (Uh.ndim - 1,)),
             (tuple(range(nbatch)), tuple(range(nbatch))))
    parts, wts = [], []
    for i in range(S):
        for j in range(i, S - i):
            P = lax.dot_general(t[i], t[j], dnums,
                                preferred_element_type=jnp.float32)
            parts.append(P)
            wts.append(i + j)
            if j > i:
                # P_ji = P_ij^T: a separate compensated part (an in-place
                # f32 add of P + P^T would round above the dd tail)
                parts.append(jnp.swapaxes(P, -1, -2))
                wts.append(i + j)
    oh, ol = _combine(parts, wts, s)
    sc = su * jnp.swapaxes(su, -1, -2)
    return df64.dd_sub((Ch, Cl), (oh * sc, ol * sc))
