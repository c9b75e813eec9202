"""Tiny frozen-dataclass pytree helper (no external deps)."""
from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls=None, *, static=()):
    """Register a frozen dataclass as a JAX pytree.

    Fields named in ``static`` become metadata (hashed into jit cache keys);
    the rest are traced leaves.
    """

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        fields = dataclasses.fields(c)
        data = [f.name for f in fields if f.name not in static]
        meta = [f.name for f in fields if f.name in static]
        jax.tree_util.register_dataclass(c, data_fields=data, meta_fields=meta)
        register_export_serialization(c)
        return c

    return wrap(cls) if cls is not None else wrap


def register_export_serialization(c):
    """Make a custom pytree class serializable by ``jax.export``.

    Needed by the AOT export cache (``utils/aot.py``): exported modules
    record the call-signature treedefs, and custom nodes must declare how
    to (de)serialize their aux data. Static fields here are plain ints/
    bools/strings, so pickle round-trips them exactly; classes with
    unpicklable statics (e.g. ``Convex`` holding barrier callables) fail
    registration lazily at export time, which the cache treats as a plain
    fallback to the un-exported jit.
    """
    import pickle

    try:
        from jax import export as jexport

        jexport.register_pytree_node_serialization(
            c, serialized_name=f"{c.__module__}.{c.__qualname__}",
            serialize_auxdata=pickle.dumps,
            deserialize_auxdata=pickle.loads)
    except Exception:  # pragma: no cover - older jax without export
        pass
    return c


def to_dev(x, dtype=None):
    """Host->device transfer WITHOUT an eager XLA op.

    ``jnp.asarray(x, dtype)`` with a dtype change (or an x64 input under
    x64-disabled) lowers to an eager ``convert_element_type`` — a separate
    XLA *compile* per distinct shape. The host-side plan builders
    (``build_panel_ops``/``build_ell``/``build_fsai_plan``) emit dozens of
    distinct shapes per hierarchy. Converting in NumPy first makes the
    transfer a pure ``device_put``: no compile, async, amortized by the
    runtime.
    """
    import numpy as np
    import jax

    a = np.asarray(x)
    if dtype is not None:
        a = np.ascontiguousarray(a, dtype=dtype)
    return jax.device_put(a)
