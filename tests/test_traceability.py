"""Compilability proxy (reference test_cuda.jl model): every barrier,
cobarrier, and slack function of every Convex constructor must be
jit-traceable under jax.eval_shape — the precondition for device
compilation, just as isbits was the precondition for CUDA kernel
compilation. The chip-marked test checks GPU-vs-CPU agreement."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgbtpu import (amg, fem1d, convex_euclidian_power, convex_linear,
                    convex_piecewise, intersect)
from mgbtpu.solver.mgb import make_feasibility_fs


def _mg():
    return amg(fem1d(nodes=np.linspace(-1, 1, 5)))


def _trace_all(Q, ny):
    n = np.asarray(Q.args[0]).shape[0]
    row_shapes = [jax.ShapeDtypeStruct(np.asarray(a).shape[1:] or (),
                                       np.asarray(a).dtype) for a in Q.args]
    y = jax.ShapeDtypeStruct((ny,), np.asarray(Q.args[0]).dtype)
    yhat = jax.ShapeDtypeStruct((ny + 1,), np.asarray(Q.args[0]).dtype)
    for F in Q.barrier:
        jax.eval_shape(F, *row_shapes, y)
    for F in Q.cobarrier:
        jax.eval_shape(F, *row_shapes, yhat)
    jax.eval_shape(Q.slack, *row_shapes, y)


def test_euclidian_power_traceable():
    mg = _mg()
    for p in (1.0, 1.5, 2.0, 3.0):
        _trace_all(convex_euclidian_power(mg, idx=(1, 2), p=p), 3)


def test_linear_traceable():
    mg = _mg()
    Q = convex_linear(mg, idx=(0,), A=lambda x: np.array([[1.0], [-1.0]]),
                      b=lambda x: np.array([0.1, 1.0]))
    _trace_all(Q, 3)


def test_piecewise_and_intersect_traceable():
    mg = _mg()
    Q1 = convex_euclidian_power(mg, idx=(1, 2), p=2.0)
    Q2 = convex_linear(mg, idx=(0,), A=lambda x: np.array([[1.0]]),
                       b=lambda x: np.array([1.0]))
    _trace_all(intersect(mg, Q1, Q2), 3)


def test_feasibility_wrapper_traceable():
    mg = _mg()
    Q = convex_euclidian_power(mg, idx=(1, 2), p=1.5)
    nD = 3
    F0, F1, F2 = make_feasibility_fs(Q.cobarrier, nD + 1)
    dt = np.asarray(Q.args[0]).dtype
    rows = [jax.ShapeDtypeStruct(np.asarray(a).shape[1:] or (), dt)
            for a in Q.args]
    box = [jax.ShapeDtypeStruct((), dt)] * 2       # b, R per-node scalars
    nu = 2
    yy = jax.ShapeDtypeStruct((nD + 1 + nu,), dt)
    for F in (F0, F1, F2):
        jax.eval_shape(F, *rows, *box, yy)


@pytest.mark.chip
def test_gpu_cpu_agreement(gpu):
    """float64 solve on the GPU against the same solve on XLA:CPU, to the
    reference's cross-backend bar (test/test_cuda.jl:52)."""
    from mgbtpu import assemble, mgb_solve

    prob = assemble(_mg(), p=1.5)
    z_gpu = mgb_solve(prob, device=gpu).z
    z_cpu = mgb_solve(prob, device="cpu").z
    assert np.abs(z_gpu - z_cpu).max() < 1e-8
