"""Ozaki split dd-GEMM (ops/ozaki.py) vs float64 oracles.

Accuracy bar: the scheme is error-free through the bf16 matmuls and drops
only sub-2^-48-of-row-scale slices, so products of f64-representable dd
inputs must match the f64 result to ~2^-45 of the result norm — far
tighter than anything a plain f32 path could produce. Oracle comparisons
run EAGERLY: XLA:CPU jit is known to break error-free-transform
compositions at f32-eps level in some fusion patterns; a separate
jit-vs-eager check uses a bar above that wobble (``chip_smoke.py`` checks
the jitted product on the GPU against the 2^-44 bar).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mgbtpu.ops.df64 import f64_split
from mgbtpu.ops.ozaki import dd_matmul_nt, dd_syrk_ozaki, _slice_params


def _dd(rng, shape, scale=1.0, spread=0.0):
    """Random f64 values (optionally with per-element magnitude spread),
    split error-free into dd pairs."""
    x = rng.standard_normal(shape) * scale
    if spread:
        x = x * np.exp(spread * rng.uniform(-1, 1, shape))
    hi, lo = f64_split(x)
    return (jnp.asarray(hi), jnp.asarray(lo)), x


@pytest.mark.parametrize("m,n,p", [(5, 16, 7), (33, 64, 9), (17, 300, 17),
                                   (8, 1024, 8)])
def test_dd_matmul_nt_oracle(m, n, p):
    rng = np.random.default_rng(n)
    A, Af = _dd(rng, (3, m, n), spread=4.0)
    B, Bf = _dd(rng, (3, p, n), spread=4.0)
    oh, ol = dd_matmul_nt(A, B)
    got = np.asarray(oh, np.float64) + np.asarray(ol, np.float64)
    want = Af @ np.swapaxes(Bf, -1, -2)
    err = np.abs(got - want).max()
    bar = 2.0 ** -45 * max(np.abs(want).max(), 1.0)
    assert err <= bar, (err, bar)


def test_dd_matmul_extreme_scales():
    """Rows spanning 2^±30 exercise the per-row power-of-two scaling."""
    rng = np.random.default_rng(0)
    m, n = 12, 128
    Af = rng.standard_normal((1, m, n)) * np.logspace(
        -9, 9, m).reshape(1, m, 1)
    Bf = rng.standard_normal((1, m, n)) * np.logspace(
        9, -9, m).reshape(1, m, 1)
    A = tuple(map(jnp.asarray, f64_split(Af)))
    B = tuple(map(jnp.asarray, f64_split(Bf)))
    oh, ol = dd_matmul_nt(A, B)
    got = np.asarray(oh, np.float64) + np.asarray(ol, np.float64)
    want = Af @ np.swapaxes(Bf, -1, -2)
    # row-wise bar: error scales with |row_A| * |row_B|
    sa = np.abs(Af).max(axis=-1, keepdims=True)
    sb = np.abs(Bf).max(axis=-1, keepdims=True)
    bar = 2.0 ** -44 * n * sa * np.swapaxes(sb, -1, -2)
    assert np.all(np.abs(got - want) <= bar)


def test_dd_syrk_oracle():
    rng = np.random.default_rng(3)
    Bk, m, n = 4, 21, 96
    U, Uf = _dd(rng, (Bk, m, n), spread=3.0)
    Cr = np.random.default_rng(4).standard_normal((Bk, m, m)) * 50.0
    Cf = Cr + np.swapaxes(Cr, -1, -2)
    C = tuple(map(jnp.asarray, f64_split(Cf)))
    oh, ol = dd_syrk_ozaki(C, U)
    got = np.asarray(oh, np.float64) + np.asarray(ol, np.float64)
    want = Cf - Uf @ np.swapaxes(Uf, -1, -2)
    scale = max(np.abs(want).max(), np.abs(Uf @ np.swapaxes(Uf, -1, -2)).max())
    err = np.abs(got - want).max()
    bar = 2.0 ** -44 * scale
    assert err <= bar, (err, bar)
    # symmetric to the dd tail (P and P^T enter as separate tree parts)
    assert np.abs(got - np.swapaxes(got, -1, -2)).max() <= bar


def test_slice_params_exactness_window():
    """2s + ceil(log2 n) <= 22 (exact f32 accumulation) at every n."""
    for n in (2, 16, 100, 512, 1024, 4096):
        s, S = _slice_params(n)
        assert 2 * s + int(np.ceil(np.log2(n))) <= 22
        assert s * S >= 49


def test_jit_matches_eager_loosely():
    """jit on CPU may wobble EFT compositions at ~eps(f32) of the row
    scale; the dd result must still be far better than plain f32."""
    rng = np.random.default_rng(7)
    A, Af = _dd(rng, (2, 9, 64))
    B, Bf = _dd(rng, (2, 9, 64))
    eager = dd_matmul_nt(A, B)
    jitted = jax.jit(dd_matmul_nt)(A, B)
    e = (np.asarray(eager[0], np.float64) + np.asarray(eager[1], np.float64))
    j = (np.asarray(jitted[0], np.float64) + np.asarray(jitted[1], np.float64))
    want = Af @ np.swapaxes(Bf, -1, -2)
    assert np.abs(j - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(e - j).max() <= 1e-5 * np.abs(want).max()
