"""Double-float barrier evaluation: accuracy oracles vs float64.

The f32 path evaluates the per-node barrier derivatives in double-float
(DD inputs through the generic barrier code, ``mgbtpu/ops/ddarray.py``).
These tests pin the two claims the solver relies on:

1. the DD-evaluated gradient/Hessian match a float64 evaluation of the same
   closed forms to ~2^-45 relative — including next to the barrier wall
   where the f32 evaluation loses ~half its digits to the r = s^a - |q|^2
   cancellation;
2. the full f32/dd solve at the *reference* (Float64) tolerance reproduces
   the float64 solution to ~1e-8 — the reference's CPU-vs-GPU agreement bar
   (``/root/reference/test/test_cuda.jl:52``), met here across a precision
   boundary rather than a device boundary.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mgbtpu.ops.ddarray import DD, fl


def _f64_power_barrier_grad(A, b, p, mu, y, idx):
    """float64 oracle of the euclidian-power F1 (same closed form)."""
    nz = len(b)
    Ax = A.reshape(nz, nz).astype(np.float64)
    yi = y[np.asarray(idx)].astype(np.float64)
    z = Ax @ yi + b.astype(np.float64)
    q, s = z[:-1], z[-1]
    alpha = 2.0 / float(p)
    r = s ** alpha - q @ q
    inv_r = 1.0 / r
    grad_q = 2.0 * inv_r * q
    grad_s = -alpha * s ** (alpha - 1.0) * inv_r - float(mu) / s
    g = Ax.T @ np.concatenate([grad_q, [grad_s]])
    out = np.zeros(y.shape[0])
    out[np.asarray(idx)] = g
    return out


@pytest.mark.parametrize("p", [1.0, 1.5, 3.0])
def test_dd_gradient_matches_f64_near_wall(p):
    """DD gradient at points ever closer to the cone boundary: the f32
    evaluation loses digits as r -> 0 while the DD one stays at ~2^-45."""
    from mgbtpu.convex import convex_euclidian_power

    x = np.zeros((1, 1), dtype=np.float32)
    Q = convex_euclidian_power(x=x, idx=(0, 1, 2), p=p, dtype=np.float32)
    F1 = Q.barrier[1]
    args0 = tuple(np.asarray(a)[0] for a in Q.args)
    rng = np.random.default_rng(0)
    for margin in [1e-1, 1e-3, 1e-5, 1e-7]:
        q = rng.normal(size=2).astype(np.float32)
        qn = float(np.linalg.norm(q.astype(np.float64)) ** p)
        s = np.float32(qn * (1.0 + margin))
        y = np.array([q[0], q[1], s], dtype=np.float32)
        g_dd = np.asarray(fl(F1(*args0, DD(jnp.asarray(y)))), dtype=np.float64)
        g_64 = _f64_power_barrier_grad(np.asarray(Q.args[0])[0],
                                       np.asarray(Q.args[1])[0],
                                       np.asarray(Q.args[2])[0],
                                       np.asarray(Q.args[3])[0],
                                       y, (0, 1, 2))
        scale = np.abs(g_64).max()
        assert np.abs(g_dd - g_64).max() <= 3e-7 * scale, \
            f"margin={margin}: dd gradient off by " \
            f"{np.abs(g_dd - g_64).max() / scale:.2e} (rel)"


def test_dd_hessian_matches_f64():
    from mgbtpu.convex import convex_euclidian_power

    x = np.zeros((1, 1), dtype=np.float32)
    Q = convex_euclidian_power(x=x, idx=(0, 1, 2), p=1.0, dtype=np.float32)
    F2 = Q.barrier[2]
    args0 = tuple(np.asarray(a)[0] for a in Q.args)
    y = np.array([0.3, -0.2, 0.3606, ], dtype=np.float32)  # r ~ 2e-4 rel
    H_dd = np.asarray(fl(F2(*args0, DD(jnp.asarray(y)))), dtype=np.float64)
    yj = jnp.asarray(y, jnp.float64)
    F0 = Q.barrier[0]
    H_ad = np.asarray(jax.hessian(lambda yy: F0(*args0, yy))(yj))
    scale = np.abs(H_ad).max()
    assert np.abs(H_dd - H_ad).max() <= 1e-5 * scale


def test_f32_dd_solve_matches_f64_at_reference_tol():
    """The dd path at the reference tolerance
    reproduces the f64 solution to ~1e-8 with comparable Newton counts."""
    from mgbtpu import amg, assemble, fem1d, mgb_solve, subdivide

    geom64 = subdivide(fem1d(dtype=np.float64), 1)
    sol64 = mgb_solve(assemble(amg(geom64), p=1.0, dtype=np.float64))
    its64 = int(sol64.SOL_main["its"].sum())

    geom32 = subdivide(fem1d(dtype=np.float32), 1)
    sol32 = mgb_solve(assemble(amg(geom32), p=1.0, dtype=np.float32))
    its32 = int(sol32.SOL_main["its"].sum())

    assert np.abs(sol32.z - sol64.z).max() < 5e-8
    assert its32 <= 1.5 * its64 + 5
