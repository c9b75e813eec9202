"""AOT export cache: skip Python re-tracing on process warm-up.

The persistent XLA compilation cache (``jax_compilation_cache_dir``)
removes the *compile* cost of a warm start across processes, but the big
solver programs — the per-level Newton runners and the fused t-ramp —
still pay seconds to tens of seconds of Python tracing + lowering in
every new process. ``jax.export`` serializes the
lowered StableHLO; reloading it skips tracing entirely, and the XLA
compile of the reloaded module then hits the persistent compilation
cache. Measured at fem2d_P2 L=2 on one CPU core: warm solve 79 s cold,
31.6 s with only the compile cache, ~3 s with both caches.

The reference has no analog (Julia caches native code per session via
precompilation; the CUDA extension re-JITs kernels per process).

Cache key: program name + hash of every ``mgbtpu`` source file + jax
version + backend platform/version + x64 and matmul-precision config +
the abstract call signature (treedef string + shape/dtype of every leaf).
All problem DATA flows through arguments (the ops pytrees, grids, scalar
knobs), so blobs are value-independent and a key collision cannot change
numerics. Gated off under a device mesh (exports bake shardings), under an
explicit ``jax.default_device`` (exports lower for the default backend),
without the ``flatbuffers`` package, and by ``MGBTPU_AOT_CACHE=0``.
"""
from __future__ import annotations

import functools
import hashlib
import importlib.util
import logging
import os
import tempfile
import threading

import jax

log = logging.getLogger("mgbtpu.aot")

_CODE_HASH = None
_LOCK = threading.Lock()


# packages whose code can be TRACED into solver programs (everything the
# jitted Newton/ramp graphs call through). Host-only packages — plot,
# frontends, hierarchy, discretize, native — produce program *arguments*
# (grids, plans, tables), which the abstract call signature + value
# fingerprints already key; hashing them too made every bench-harness or
# plotting edit invalidate the whole AOT cache.
_TRACED_PKGS = ("solver", "ops", "convex", "zoo", "utils", "parallel")


def _code_hash() -> str:
    """Content hash of the traced mgbtpu sources (computed once)."""
    global _CODE_HASH
    if _CODE_HASH is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        h = hashlib.sha256()
        roots = [root] + [os.path.join(root, p) for p in _TRACED_PKGS]
        for base in roots:
            walk = [(base, [], [f for f in sorted(os.listdir(base))
                              if os.path.isfile(os.path.join(base, f))])] \
                if base == root else sorted(os.walk(base))
            for dirpath, dirnames, files in walk:
                if isinstance(dirnames, list):
                    dirnames.sort()
                for fn in sorted(files):
                    if fn.endswith(".py"):
                        p = os.path.join(dirpath, fn)
                        h.update(os.path.relpath(p, root).encode())
                        with open(p, "rb") as f:
                            h.update(f.read())
        _CODE_HASH = h.hexdigest()[:16]
    return _CODE_HASH


def cache_dir() -> str:
    from mgbtpu._config import CACHE_ROOT

    return os.environ.get("MGBTPU_AOT_CACHE_DIR",
                          os.path.join(CACHE_ROOT, "aot"))


def enabled() -> bool:
    return (os.environ.get("MGBTPU_AOT_CACHE", "1") != "0"
            and jax.config.jax_default_device is None
            and _can_serialize())


@functools.cache
def _can_serialize() -> bool:
    """jax.export serializes through the optional ``flatbuffers`` package;
    without it every export would trace the program once in vain."""
    return importlib.util.find_spec("flatbuffers") is not None


def _env_fingerprint() -> str:
    import jaxlib

    dev = jax.devices()[0]
    # MGBTPU_* env knobs select different traced programs at the SAME call
    # signature (e.g. MGBTPU_ND_REFRESH flips the ramp's refresh policy,
    # MGBTPU_DD_PANEL swaps the dd panel factor): they must be part of
    # the key or an A/B run silently loads the other configuration's blob.
    # Excluded: the AOT-cache admin vars and knobs that provably never
    # reach a trace — MGBTPU_TIMING (host-side phase prints),
    # MGBTPU_ND_DD_T (host-side two-phase chunk targeting; the chunk
    # target is a TRACED argument and the factor-precision variant is in
    # the program NAME).
    host_only = {"MGBTPU_TIMING", "MGBTPU_ND_DD_T"}
    knobs = "|".join(f"{k}={v}" for k, v in sorted(os.environ.items())
                     if k.startswith("MGBTPU_")
                     and not k.startswith("MGBTPU_AOT_CACHE")
                     and k not in host_only)
    return "|".join([
        jax.__version__, getattr(jaxlib, "__version__", "?"),
        dev.platform, str(getattr(dev, "device_kind", "?")),
        str(jax.config.jax_enable_x64),
        str(jax.config.jax_default_matmul_precision),
        knobs,
    ])


def _abstract_sig(args, kwargs) -> str:
    from jax import tree_util as jtu

    leaves, treedef = jtu.tree_flatten((args, kwargs))
    parts = [str(treedef)]
    for x in leaves:
        a = jax.api_util.shaped_abstractify(x)
        parts.append(f"{a.shape}:{a.dtype}")
    return "\n".join(parts)


def _evict_lru(keep=None):
    """Bound the cache dir (default 16 GB, MGBTPU_AOT_CACHE_MAX bytes):
    blobs are keyed by package-source hash, so every commit strands the
    previous ones. Evict least-recently-used until under the cap."""
    try:
        cap = int(os.environ.get("MGBTPU_AOT_CACHE_MAX", 16 << 30))
        d = cache_dir()
        ents = []
        for fn in os.listdir(d):
            if fn.endswith(".jaxexp"):
                p = os.path.join(d, fn)
                st = os.stat(p)
                ents.append((st.st_atime, st.st_size, p))
        total = sum(e[1] for e in ents)
        for atime, size, p in sorted(ents):
            if total <= cap:
                break
            if p == keep:
                continue
            os.unlink(p)
            total -= size
    except OSError:  # pragma: no cover - concurrent eviction
        pass


class _Unfingerprintable(Exception):
    pass


def _fp_value(v, h, seen, depth=0):
    """Hash a closure-captured VALUE into h (deterministic across
    processes). Raises _Unfingerprintable for anything not understood —
    the caller then disables the cache for that program (safety over
    speed: a missed attribute would mean a silent key collision)."""
    import types

    import numpy as _np

    if depth > 64:
        raise _Unfingerprintable("depth")
    if v is None or isinstance(v, (bool, int, float, complex, str, bytes)):
        h.update(repr(v).encode())
        return
    if isinstance(v, (tuple, list)):
        h.update(f"seq{len(v)}".encode())
        for e in v:
            _fp_value(e, h, seen, depth + 1)
        return
    if isinstance(v, dict):
        h.update(f"dict{len(v)}".encode())
        for k in sorted(v, key=repr):
            _fp_value(k, h, seen, depth + 1)
            _fp_value(v[k], h, seen, depth + 1)
        return
    if isinstance(v, (type, _np.dtype)):
        h.update(f"T{getattr(v, '__module__', '')}."
                 f"{getattr(v, '__qualname__', repr(v))}".encode())
        return
    if isinstance(v, types.ModuleType):
        h.update(f"M{v.__name__}".encode())
        return
    if isinstance(v, (_np.ndarray, _np.generic)) or isinstance(v, jax.Array):
        a = _np.asarray(v)
        h.update(f"arr{a.shape}{a.dtype}".encode())
        h.update(a.tobytes())
        return
    if callable(v):
        _fp_fn(v, h, seen, depth + 1)
        return
    raise _Unfingerprintable(type(v))


def _fp_fn(fn, h, seen, depth=0):
    """Hash a FUNCTION identity + everything baked into it: code bytes,
    defaults, and (recursively) every closure cell. Package-defined code
    semantics are already covered by the mgbtpu source hash in the key;
    this pins WHICH functions were selected and what data they captured
    (e.g. the static-alpha specialization in convex_euclidian_power that
    bakes 2/p into the barrier functor for constant p)."""
    import functools
    import inspect

    if id(fn) in seen:
        return
    seen.add(id(fn))
    fn = inspect.unwrap(fn)
    if isinstance(fn, functools.partial):
        h.update(b"partial")
        _fp_fn(fn.func, h, seen, depth + 1)
        _fp_value(fn.args, h, seen, depth + 1)
        _fp_value(fn.keywords, h, seen, depth + 1)
        return
    if inspect.ismethod(fn):
        _fp_value(fn.__self__, h, seen, depth + 1)
        fn = fn.__func__
    h.update(f"F{getattr(fn, '__module__', '')}."
             f"{getattr(fn, '__qualname__', '?')}".encode())
    code = getattr(fn, "__code__", None)
    if code is None:
        if not isinstance(fn, type) and hasattr(fn, "__dict__") \
                and type(fn).__call__ is not type.__call__:
            # callable instance: type identity + captured attributes
            _fp_value(type(fn), h, seen, depth + 1)
            _fp_value(vars(fn), h, seen, depth + 1)
        return  # builtin: module+qualname above is the identity
    _fp_code(code, h, seen, depth)
    _fp_value(getattr(fn, "__defaults__", None), h, seen, depth + 1)
    kw = getattr(fn, "__kwdefaults__", None)
    if kw:
        _fp_value(kw, h, seen, depth + 1)
    for cell in fn.__closure__ or ():
        try:
            cv = cell.cell_contents
        except ValueError:
            h.update(b"emptycell")
        else:
            _fp_value(cv, h, seen, depth + 1)


def _fp_code(code, h, seen, depth):
    h.update(code.co_code)
    for c in code.co_consts:
        if hasattr(c, "co_code"):
            _fp_code(c, h, seen, depth + 1)
        else:
            _fp_value(c, h, seen, depth + 1)


def fn_fingerprint(jfn) -> str:
    """Deterministic hash of a jitted function's baked-in content, or
    raises _Unfingerprintable."""
    h = hashlib.sha256()
    _fp_fn(jfn, h, set())
    return h.hexdigest()[:16]


_PRIMED = False


def _prime_linalg():
    """Work around a jaxlib 0.9.0 XLA:CPU crash: executing a DESERIALIZED
    module containing ``stablehlo.cholesky`` / ``stablehlo.triangular_solve``
    segfaults unless the process has lowered those primitives through jax's
    own path at least once (any shape) — some expander state is initialized
    lazily by the normal lowering and skipped by deserialized compilation.
    Reproduced minimally (512,14,14 batched cholesky: direct ok, fresh-
    process deserialized exec SIGSEGV; priming with a 1x1 cholesky fixes
    it). Priming costs ~ms once per process."""
    global _PRIMED
    if _PRIMED:
        return
    _PRIMED = True
    try:
        import jax.numpy as jnp
        from jax import lax

        one = jnp.ones((1, 1), jnp.float32)
        jax.block_until_ready(jnp.linalg.cholesky(one[None]))
        jax.block_until_ready(lax.linalg.triangular_solve(
            one, one, left_side=True, lower=True))
    except Exception:  # pragma: no cover - priming is best-effort
        pass


class XJit:
    """Wrap an already-``jax.jit``-ed function with an export cache.

    First call in a cold process: deserialize the stored StableHLO for
    this (code, env, signature) key if present — no tracing — else trace,
    export, and persist. Falls back to the plain jitted function on any
    export/deserialize error (the cache is an optimization, never a
    correctness dependency).
    """

    def __init__(self, jfn, name: str):
        self._jfn = jfn
        self._name = name
        self._fp = None   # lazy closure fingerprint; False = disabled
        self._calls = {}  # key -> callable

    def __call__(self, *args, **kwargs):
        if not enabled():
            return self._jfn(*args, **kwargs)
        if self._fp is None:
            try:
                self._fp = fn_fingerprint(self._jfn)
            except _Unfingerprintable as e:
                log.warning("aot cache off for %s (unfingerprintable "
                            "closure: %s)", self._name, e)
                self._fp = False
        if self._fp is False:
            return self._jfn(*args, **kwargs)
        try:
            key = hashlib.sha256(
                "\0".join([self._name, self._fp, _code_hash(),
                           _env_fingerprint(),
                           _abstract_sig(args, kwargs)]).encode()
            ).hexdigest()[:32]
        except Exception as e:  # pragma: no cover - unabstractifiable arg
            log.warning("aot key failed for %s: %s", self._name, e)
            return self._jfn(*args, **kwargs)
        call = self._calls.get(key)
        if call is None:
            call = self._load_or_export(key, args, kwargs)
            self._calls[key] = call
        return call(*args, **kwargs)

    def _load_or_export(self, key, args, kwargs):
        from jax import export as jexport

        path = os.path.join(cache_dir(), f"{self._name}-{key}.jaxexp")
        if os.path.exists(path):
            try:
                _prime_linalg()
                with open(path, "rb") as f:
                    exp = jexport.deserialize(bytearray(f.read()))
                jcall = jax.jit(exp.call)
                log.info("aot cache hit: %s", os.path.basename(path))

                # exported modules take flat (args, kwargs) exactly as
                # exported; exp.call already replays that calling
                # convention, so pass through unchanged
                return jcall
            except Exception as e:  # pragma: no cover - version skew
                log.warning("aot cache load failed (%s): %s", path, e)
        try:
            checks = [jexport.DisabledSafetyCheck.custom_call(t)
                      for t in ("Sharding", "annotate_device_placement")]
            exp = jexport.export(self._jfn, disabled_checks=checks)(
                *args, **kwargs)
            blob = exp.serialize()
            with _LOCK:
                os.makedirs(cache_dir(), exist_ok=True)
                fd, tmp = tempfile.mkstemp(dir=cache_dir(),
                                           suffix=".tmp")
                with os.fdopen(fd, "wb") as f:
                    f.write(blob)
                os.replace(tmp, path)  # atomic vs concurrent writers
            log.info("aot cache store: %s (%.1f MB)",
                     os.path.basename(path), len(blob) / 1e6)
            _evict_lru(keep=path)
            return jax.jit(exp.call)
        except Exception as e:
            log.warning("aot export failed for %s: %s", self._name, e)
            return self._jfn
