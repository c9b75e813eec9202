"""Barrier objective/gradient/Hessian over a hierarchy level.

Given per-node barrier functions F0/F1/F2, builds level functions of the
search coefficient s with the level's PanelOps threaded as an *argument*
(a pytree of arrays, not a closure constant): one jitted Newton then serves
every level (the jit cache keys on shapes), the large panel tensors are
never baked into executables, and the element/node axes shard across a
device mesh by simply sharding the fargs.

    f0(s) = sum_i bw_i F0(args_i, Dz_i) + sum_i <wc_i, Dz_i>,  Dz = Dz0 + G s
    f1(s) = G' (bw * F1 + wc)
    f2(s) = G' diag-blocks(bw * F2) G        (batched A'DA einsum)

``bw`` is the per-node barrier weight: the flat average 1/n by default, a
masked mean for ``barrier_nodes`` selections; nodes with bw == 0 are dropped
*before* arithmetic so an infeasible excluded node (F = +/-inf) cannot
poison the sum (the 0*inf=NaN hazard; reference ``src/convex.jl:207-257``).
The linear term always uses the physical quadrature weights (passed combined
as wc = w * t * c).

float32 path (``ops.dd``): the entire per-node evaluation runs in
double-float — Dz0 is threaded as a DD pair, Dz = Dz0 + G s accumulates in
dd, and the per-node F0/F1/F2 (written generically over the scalar type,
see ``ops/ddarray.py``) see DD inputs. The objective is a stacked df64
scalar; the gradient's barrier-vs-cost cancellation happens in dd inside
``apply_Gt``; the Hessian narrows to f32 after its (dd) node evaluation.
This removes the f32 evaluation noise that floored the computed Newton
decrement at ~3e-3 in round 1.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def make_level_fns(Fs):
    """Level functions with signature f(s, ops, Dz0, wc, bw, *args).

    In dd mode (``ops.dd``) ``Dz0`` must be a DD pair; otherwise a plain
    array.
    """
    F0, F1, F2 = Fs

    def _Dz(s, ops, Dz0):
        if ops.dd:
            return Dz0 + ops.apply_G_dd(s)
        return Dz0 + ops.apply_G(s)

    def _node(F, args, Dz, dd):
        """vmap(F) over nodes."""
        return jax.vmap(F)(*args, Dz)

    def f0(s, ops, Dz0, wc, bw, *args):
        Dz = _Dz(s, ops, Dz0)
        v = _node(F0, args, Dz, ops.dd)
        if not ops.dd:
            per_node = jnp.where(bw != 0, bw * v, 0.0) + (wc * Dz).sum(axis=1)
            return per_node.sum()
        # float32 path: the objective is a stacked df64 scalar — its
        # differences along a line search are ~lambda^2, far below the f32
        # ulp of the value itself
        from ..ops import df64
        from ..ops.ddarray import DD

        if not isinstance(v, DD):
            v = DD(v)
        bh, bl = df64.dd_mul_f((v.hi, v.lo), bw)
        bh = jnp.where(bw != 0, bh, 0.0)
        bl = jnp.where(bw != 0, bl, 0.0)
        lh, ll = df64.dd_mul_f((Dz.hi, Dz.lo), wc)
        lh, ll = df64.dd_tree_sum((lh, ll), axis=1)
        ph, pl = df64.dd_add((bh, bl), (lh, ll))
        hi, lo = df64.dd_tree_sum((ph, pl), axis=0)
        return df64.s_pack(hi, lo)

    def f1(s, ops, Dz0, wc, bw, *args):
        Dz = _Dz(s, ops, Dz0)
        gv = _node(F1, args, Dz, ops.dd)
        if not ops.dd:
            y = jnp.where(bw[:, None] != 0, bw[:, None] * gv, 0.0) + wc
            return ops.apply_Gt(y)
        from ..ops import df64
        from ..ops.ddarray import DD

        if not isinstance(gv, DD):
            gv = DD(gv)
        yh, yl = df64.dd_mul_f((gv.hi, gv.lo), bw[:, None])
        yh = jnp.where(bw[:, None] != 0, yh, 0.0)
        yl = jnp.where(bw[:, None] != 0, yl, 0.0)
        yh, yl = df64.dd_add((yh, yl), (wc, jnp.zeros_like(wc)))
        # the gradient stays a DD vector all the way into the Newton solve
        # (f32 narrowing would be amplified by the ~t-conditioned solve)
        return ops.apply_Gt_dd(DD(yh, yl))

    def f2(s, ops, Dz0, wc, bw, *args):
        from .levelops import GramHessian

        Dz = _Dz(s, ops, Dz0)
        hv = _node(F2, args, Dz, ops.dd)
        if not ops.dd:
            Y = jnp.where(bw[:, None, None] != 0, bw[:, None, None] * hv, 0.0)
            if ops.pcg_ctx is not None:
                # large level: matrix-free Gram Hessian, solved by multigrid-
                # preconditioned CG (no dense factorization at this size)
                return GramHessian(ops=ops, Lnode=node_factors(Y),
                                   ctx=ops.pcg_ctx)
            return ops.assemble_dense(Y)
        # float32 path: the per-node Hessian blocks stay in double-float all
        # the way into the assembly/matvec — narrowing them to f32 is an
        # eps(f32)-componentwise perturbation that the Newton solve amplifies
        # by the equilibrated condition number ~ t (the round-2 stall at
        # t ~ 3e5). The f32 narrowed blocks serve only the preconditioner.
        from ..ops import df64
        from ..ops.ddarray import DD

        if not isinstance(hv, DD):
            hv = DD(hv)
        Yh, Yl = df64.dd_mul_f((hv.hi, hv.lo), bw[:, None, None])
        mask = bw[:, None, None] != 0
        Ydd = DD(jnp.where(mask, Yh, 0.0), jnp.where(mask, Yl, 0.0))
        L32 = node_factors(Ydd.fl())
        if ops.pcg_ctx is not None:
            return GramHessian(ops=ops, Lnode=L32, ctx=ops.pcg_ctx, Ydd=Ydd)
        # dense level: the f32 Gram assembly is only the Cholesky
        # preconditioner; directions come from dd refinement against the
        # matrix-free dd operator (newton.dense_ir_solve)
        return GramHessian(ops=ops, Lnode=L32, ctx=None, Ydd=Ydd,
                           H32=ops.assemble_gram(L32))

    return f0, f1, f2


def node_factors(Y):
    """Per-node lower Cholesky factors of the (PSD) barrier Hessian blocks,
    with a jitter ladder sized to each block's own evaluation noise; a
    still-failing node contributes its absolute-diagonal surrogate."""
    eps = jnp.finfo(Y.dtype).eps
    scale = jnp.max(jnp.abs(Y), axis=(1, 2))
    eye = jnp.eye(Y.shape[1], dtype=Y.dtype)
    L = None
    for c in (8.0, 1024.0):
        Lc = jnp.linalg.cholesky(Y + (c * eps) * scale[:, None, None] * eye)
        if L is None:
            L = Lc
        else:
            ok = jnp.all(jnp.isfinite(L), axis=(1, 2))
            L = jnp.where(ok[:, None, None], L, Lc)
    ok = jnp.all(jnp.isfinite(L), axis=(1, 2))
    diag_sqrt = jnp.sqrt(jnp.abs(
        jnp.diagonal(Y, axis1=1, axis2=2)))[:, :, None] * eye
    return jnp.where(ok[:, None, None], L, diag_sqrt)
