"""Barrier log, safe power, and the solve logger.

The "convex programmer's log" returns -inf outside the domain instead of
raising, so an infeasible trial point makes the barrier value +/-inf (rejected
by finite-ness checks in the line search) rather than aborting. The reference
chose exactly this convention so its kernels never throw (reference
``src/utils.jl:4-14``); under ``jax.jit`` there are no exceptions at all, so
the same convention is load-bearing here.
"""
from __future__ import annotations

import jax.numpy as jnp


def _barrier_floor(dtype):
    """Smallest admissible barrier argument: sqrt(tiny) of the dtype, so
    that the Hessian terms 1/x^2 stay representable. A trial point inside
    this eps-thin shell at the wall has a finite log and gradient but an
    overflowing Hessian (f32: x in (1e-38, 5e-20) gives Inf -> NaN blocks),
    which turned full-step overshoots into failed Newton attempts; treating
    the shell as out-of-domain makes the line search back off instead. The
    central path itself never enters it (r ~ 1/t >> sqrt(tiny))."""
    import numpy as _np

    return float(_np.sqrt(_np.finfo(_np.dtype(dtype)).tiny))


def Log(x):
    """log(x) for x > sqrt(tiny), else -inf (never raises, jit-safe).

    Dispatches on the input kind: a ``DD`` double-float input (the f32
    barrier-derivative path) is evaluated in double-float.
    """
    from ..ops.ddarray import DD, dd_log

    if isinstance(x, DD):
        import jax.numpy as _jnp

        floor = _barrier_floor(x.dtype)
        out = dd_log(x)
        bad = ~(x.hi > floor)
        return type(out)(_jnp.where(bad, -_jnp.inf, out.hi),
                         _jnp.where(bad, 0.0, out.lo))
    x = jnp.asarray(x)
    floor = _barrier_floor(x.dtype)
    return jnp.where(x > floor, jnp.log(jnp.where(x > 0, x, 1.0)), -jnp.inf)


def safe_pow(s, alpha):
    """s**alpha computed as exp(alpha*Log(s)).

    For s <= 0 and alpha > 0 this yields 0 (so enclosing barrier terms go
    +/-inf and the trial point is rejected) instead of a NaN from a negative
    base with fractional exponent. Mirrors reference
    ``src/convex_linear.jl:379-391`` (``_safe_pow``). DD inputs evaluate in
    double-float (the residual s^a - |q|^2 is the solver's dominant
    cancellation; see ``ops/ddarray.py``).
    """
    from ..ops.ddarray import DD

    if isinstance(s, DD):
        return s ** alpha
    return jnp.exp(alpha * Log(s))


class Logger:
    """In-memory per-solve log.

    Mirrors the reference's ``printlog`` closure + ``@mgblog`` tag convention
    (reference ``src/utils.jl:148-155``): each line is prefixed with the name
    of the emitting routine, lines accumulate into ``MGBSOL.log``, and nothing
    is ever written to stdout unless a stream is supplied.
    """

    def __init__(self, stream=None):
        self.lines: list[str] = []
        if isinstance(stream, (str, bytes)):
            # a path: line-buffered append, matching the reference's
            # logfile= kwarg (src/mgb.jl:729-797)
            stream = open(stream, "a", buffering=1)
        self.stream = stream

    def __call__(self, tag: str, *args):
        msg = tag + ":" + "".join(str(a) for a in args)
        self.lines.append(msg)
        if self.stream is not None:
            print(msg, file=self.stream)

    def text(self) -> str:
        return "\n".join(self.lines) + ("\n" if self.lines else "")


def null_log(tag: str, *args):  # pragma: no cover - trivial
    pass
