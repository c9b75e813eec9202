"""Global configuration for mgbtpu.

The reference package (sloisel/MultiGridBarrier.jl) is Float64-throughout
(default solver tolerance ``sqrt(eps(T))``, see reference ``src/mgb.jl:96``),
so x64 is enabled at import and every backend solves in float64: golden
parity holds to 1e-6 on the CPU and on the GPU. ``dtype=np.float32``
selects the float32 + double-float path instead (on the host; the GPU
refuses it, see ``solver.mgb.check_dtype_for_device``).

x64 is enabled at import unless MGBTPU_NO_X64 is set (it must happen before
any JAX array is created).
"""
from __future__ import annotations

import os

# XLA:CPU's fusion emitters (jaxlib 0.9.0) infinite-loop at execution on the
# double-float barrier graphs (deep chains of error-free transforms; repro:
# the level f0 with a DD Dz carried into both the barrier and linear terms).
# The legacy emitters are correct; only the CPU backend is affected. Must be
# set before the CPU client is created.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_cpu_use_fusion_emitters" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_cpu_use_fusion_emitters=false").strip()

import jax

if not os.environ.get("MGBTPU_NO_X64"):
    jax.config.update("jax_enable_x64", True)

# float32 matmuls on the GPU may run in TF32 (about three decimal digits),
# which would silently break the float32 + double-float path's products (the
# barrier Hessian SYRK, the panel einsums, the factorizations). HIGHEST keeps
# every float32 product at full float32 accuracy.
jax.config.update("jax_default_matmul_precision", "highest")

# The checkout that holds this package: fixed per installation, so a
# persistent cache kept under it is found again by the next process.
CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache")


def compile_cache_dir():
    """Directory for JAX's persistent compilation cache, or None when
    ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then uses that directory)."""
    if "JAX_COMPILATION_CACHE_DIR" in os.environ:
        return None
    return os.path.join(CACHE_ROOT, "jaxcache")


def enable_compile_cache():
    """Keep compiled executables across processes: in the directory
    ``JAX_COMPILATION_CACHE_DIR`` names if it is set (left untouched),
    otherwise at the fixed ``<checkout>/.cache/jaxcache``."""
    d = compile_cache_dir()
    if d is not None:
        jax.config.update("jax_compilation_cache_dir", d)


def default_dtype():
    """float64 when x64 is enabled (the default), else float32."""
    import numpy as np

    return np.float64 if jax.config.read("jax_enable_x64") else np.float32


def eps(dtype) -> float:
    import numpy as np

    return float(np.finfo(np.dtype(dtype)).eps)
