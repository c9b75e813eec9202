"""AOT export cache (utils/aot.py): store/reload round-trip and key
hygiene.

The cross-process behavior that matters in production (skip re-tracing in
a warm process; jaxlib cholesky/triangular_solve priming) is exercised by
reloading through a FRESH XJit instance whose in-memory map is empty, so
the call must go through deserialize + exp.call — the same code path a
new process takes.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mgbtpu.utils import aot
from mgbtpu.utils.pytree import pytree_dataclass


@pytree_dataclass(static=("n",))
class _Toy:
    a: object
    n: int


def _fn(t, x):
    def body(i, c):
        return c * 0.5 + t.a @ x + i
    return jax.lax.fori_loop(0, t.n, body, jnp.zeros_like(x))


def test_xjit_roundtrip(tmp_path, monkeypatch):
    monkeypatch.setenv("MGBTPU_AOT_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("MGBTPU_AOT_CACHE", "1")
    jfn = jax.jit(_fn)
    t = _Toy(a=jnp.eye(8, dtype=jnp.float32) * 0.25, n=3)
    x = jnp.arange(8, dtype=jnp.float32)
    x1 = aot.XJit(jfn, "toy")
    r1 = np.asarray(x1(t, x))
    blobs = [f for f in os.listdir(tmp_path) if f.endswith(".jaxexp")]
    assert len(blobs) == 1 and blobs[0].startswith("toy-")
    # fresh instance: must load from disk (empty in-memory map), not retrace
    x2 = aot.XJit(jax.jit(_fn), "toy")
    r2 = np.asarray(x2(t, x))
    np.testing.assert_array_equal(r1, r2)
    assert list(x2._calls) and None not in x2._calls


def test_xjit_key_separates_shapes_and_statics(tmp_path, monkeypatch):
    monkeypatch.setenv("MGBTPU_AOT_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("MGBTPU_AOT_CACHE", "1")
    xj = aot.XJit(jax.jit(_fn), "toy2")
    t8 = _Toy(a=jnp.eye(8, dtype=jnp.float32), n=3)
    t8b = _Toy(a=jnp.eye(8, dtype=jnp.float32), n=5)   # static differs
    t4 = _Toy(a=jnp.eye(4, dtype=jnp.float32), n=3)    # shape differs
    xj(t8, jnp.ones(8, jnp.float32))
    xj(t8b, jnp.ones(8, jnp.float32))
    xj(t4, jnp.ones(4, jnp.float32))
    assert len([f for f in os.listdir(tmp_path)
                if f.startswith("toy2-")]) == 3
    # and the static-field difference changes the RESULT via the right blob
    r3 = np.asarray(xj(_Toy(a=jnp.eye(8, dtype=jnp.float32), n=3),
                       jnp.ones(8, jnp.float32)))
    r5 = np.asarray(xj(_Toy(a=jnp.eye(8, dtype=jnp.float32), n=5),
                       jnp.ones(8, jnp.float32)))
    assert not np.allclose(r3, r5)


def test_env_knobs_change_key(monkeypatch):
    """MGBTPU_* knobs select different traced programs at the same call
    signature (e.g. MGBTPU_ND_REFRESH flips the ramp's refresh policy), so
    they must be part of the cache key — while the AOT-cache admin vars
    must NOT be (changing the cache cap cannot strand every blob)."""
    monkeypatch.delenv("MGBTPU_ND_REFRESH", raising=False)
    base = aot._env_fingerprint()
    monkeypatch.setenv("MGBTPU_ND_REFRESH", "auto")
    assert aot._env_fingerprint() != base
    monkeypatch.delenv("MGBTPU_ND_REFRESH")
    assert aot._env_fingerprint() == base
    monkeypatch.setenv("MGBTPU_AOT_CACHE_MAX", "123")
    assert aot._env_fingerprint() == base


def test_xjit_disabled_is_passthrough(tmp_path, monkeypatch):
    monkeypatch.setenv("MGBTPU_AOT_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("MGBTPU_AOT_CACHE", "0")
    xj = aot.XJit(jax.jit(_fn), "toy3")
    t = _Toy(a=jnp.eye(4, dtype=jnp.float32), n=2)
    xj(t, jnp.ones(4, jnp.float32))
    assert not [f for f in os.listdir(tmp_path) if f.startswith("toy3-")]


def test_xjit_unpicklable_static_falls_back(tmp_path, monkeypatch):
    """A pytree whose static fields can't pickle (e.g. closures) must fall
    back to the plain jit, never error."""
    monkeypatch.setenv("MGBTPU_AOT_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("MGBTPU_AOT_CACHE", "1")

    @pytree_dataclass(static=("f",))
    class _Cl:
        a: object
        f: object

    t = _Cl(a=jnp.ones((4, 4), jnp.float32), f=lambda q: q)
    xj = aot.XJit(jax.jit(lambda t, x: t.a @ x), "toy4")
    r = np.asarray(xj(t, jnp.ones(4, jnp.float32)))
    np.testing.assert_allclose(r, 4.0)


@pytest.mark.skipif(jax.default_backend() != "cpu", reason="cpu-only probe")
def test_prime_linalg_runs():
    aot._PRIMED = False
    aot._prime_linalg()
    assert aot._PRIMED


def test_xjit_distinguishes_baked_closures(tmp_path, monkeypatch):
    """Two jitted programs with IDENTICAL abstract signatures but different
    closure-captured constants must get different cache keys. Regression:
    convex_euclidian_power's static-alpha specialization bakes 2/p into
    the barrier functor, so fem1d p=1.0 and p=1.5 solves collided and the
    p=1.5 warm-start solve silently reused the p=1.0 program."""
    monkeypatch.setenv("MGBTPU_AOT_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("MGBTPU_AOT_CACHE", "1")

    def make(scale):
        def f(x):
            return x * scale
        return jax.jit(f)

    x = jnp.ones(4, jnp.float32)
    r1 = np.asarray(aot.XJit(make(2.0), "clos")(x))
    r2 = np.asarray(aot.XJit(make(3.0), "clos")(x))
    np.testing.assert_allclose(r1, 2.0)
    np.testing.assert_allclose(r2, 3.0)
    assert len([f for f in os.listdir(tmp_path)
                if f.startswith("clos-")]) == 2


def test_checkpoint_warmstart_not_poisoned_by_aot(tmp_path, monkeypatch):
    """End-to-end pin of the collision scenario: p=1.0 then p=1.5 on the
    same tiny mesh, same shapes, shared AOT dir — the p=1.5 solution must
    match its no-cache value."""
    monkeypatch.setenv("MGBTPU_AOT_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("MGBTPU_AOT_CACHE", "1")
    from mgbtpu import amg, assemble, fem1d, mgb_solve

    mg = amg(fem1d(nodes=np.linspace(-1, 1, 3)))
    mgb_solve(assemble(mg, p=1.0))
    z15 = mgb_solve(assemble(mg, p=1.5)).z
    monkeypatch.setenv("MGBTPU_AOT_CACHE", "0")
    z15_ref = mgb_solve(assemble(mg, p=1.5)).z
    np.testing.assert_allclose(z15, z15_ref, atol=1e-8)


def test_evict_lru(tmp_path, monkeypatch):
    monkeypatch.setenv("MGBTPU_AOT_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("MGBTPU_AOT_CACHE_MAX", "600")
    import time
    for i in range(4):
        p = tmp_path / f"b{i}.jaxexp"
        p.write_bytes(b"x" * 256)
        t = 1_000_000 + i
        os.utime(p, (t, t))
    aot._evict_lru(keep=str(tmp_path / "b0.jaxexp"))
    left = sorted(f.name for f in tmp_path.iterdir())
    # b0 is pinned (keep), b1 (oldest unpinned) evicted until under 600B
    assert "b3.jaxexp" in left and "b0.jaxexp" in left
    assert sum(1 for f in left) <= 3


def test_cache_off_under_explicit_device(monkeypatch):
    """Exports lower for the default backend, so an explicit
    ``jax.default_device`` (``mgb_solve(device=...)``) runs the plain jit."""
    import jax

    from mgbtpu.utils import aot

    monkeypatch.setenv("MGBTPU_AOT_CACHE", "1")
    assert aot.enabled()
    with jax.default_device(jax.devices("cpu")[0]):
        assert not aot.enabled()
    assert aot.enabled()


def test_cache_off_without_flatbuffers(monkeypatch):
    """Without the serializer package every export would trace in vain:
    the cache switches itself off."""
    from mgbtpu.utils import aot

    monkeypatch.setenv("MGBTPU_AOT_CACHE", "1")
    monkeypatch.setattr(aot, "_can_serialize", lambda: False)
    assert not aot.enabled()
