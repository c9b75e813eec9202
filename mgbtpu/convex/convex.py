"""The Convex container: barrier/cobarrier/slack + per-node parameter grids.

Re-design of the reference's ``Convex{T}`` (``src/convex.jl:80-97``):
the barrier is specified by pure per-node functions ``F(args_rows..., y)``
evaluated via ``jax.vmap`` over the node axis — the exact analogue of the
reference's "isbits functor broadcast through map_rows_gpu" design, which
already was the JAX design in Julia clothing. All problem data lives in
``args`` (per-node grids), so a ``Convex`` is a pytree and moving it across
devices is plain array movement.

Index semantics are 0-based. ``idx=None`` means "all rows" (the reference's
``Colon()``).
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np

from ..utils import pytree_dataclass


@pytree_dataclass(static=("barrier", "cobarrier", "slack", "input_spec"))
class Convex:
    args: Tuple[Any, ...]           # tuple of per-node grids, each (n,) or (n,k)
    barrier: Tuple[Callable, Callable, Callable]     # (F0, F1, F2)
    cobarrier: Tuple[Callable, Callable, Callable]   # slack-augmented (phase I)
    slack: Callable                                   # initial-slack estimator
    input_spec: Tuple                                 # D-row count validation


def input_spec_from_idx(idx, n: int):
    """Build the construction-time D-row validation spec.

    Mirrors reference ``src/convex.jl:71-78``: ``idx=None`` (Colon) demands
    exactly ``n`` D rows; an explicit index set demands at least ``max(idx)+1``
    rows (0-based).
    """
    if idx is None:
        return ("exact", n)
    idx = tuple(int(i) for i in idx)
    if len(idx) == 0:
        raise ValueError("idx must contain at least one input row")
    if any(i < 0 for i in idx):
        raise ValueError(f"idx entries must be >= 0; got {idx}")
    return ("atleast", max(idx) + 1)


def validate_convex_inputs(Q: Convex, nD: int) -> None:
    """Check Q's expected input-row layout against the problem's D table.

    Mirrors reference ``src/convex.jl:54-68`` / ``_validate_convex_inputs``.
    """

    def _check(spec):
        kind = spec[0]
        if kind == "exact":
            if spec[1] != nD:
                raise ValueError(
                    f"convex constraint with idx=None expects exactly {spec[1]} "
                    f"D row(s), but D has {nD} row(s)"
                )
        elif kind == "atleast":
            if spec[1] > nD:
                raise ValueError(
                    f"convex constraint indexes input row {spec[1] - 1} (0-based), "
                    f"but D has only {nD} row(s)"
                )
        elif kind == "all":
            for s in spec[1]:
                _check(s)
        # ("any",) -> unchecked

    _check(Q.input_spec)


def intersect(mg, *Qs: Convex) -> Convex:
    """Intersection of convex domains: all pieces active at every node.

    Mirrors reference ``src/convex.jl:110-122``.
    """
    from .piecewise import convex_piecewise

    if len(Qs) == 0:
        raise ValueError("intersect needs at least one Convex")
    return convex_piecewise(Qs, mg=mg, select=lambda x: (True,) * len(Qs))
