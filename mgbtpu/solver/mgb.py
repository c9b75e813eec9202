"""The multigrid barrier method: V-cycle step, t-ramp, phase I, driver.

Host-side orchestration (the outer loops are O(log)-count, data-light, and
inherently dynamic) around jit-compiled per-level Newton solves: the same
split the reference has between cheap outer logic and hot inner evaluations.
Algorithmic parity with reference ``src/mgb.jl`` (mgb_step :16-82, mgb_core
:91-183, phase I machinery :185-572, driver :332-584, assemble :711-727,
mgb_solve :798-843). Exceptions from the reference's broad-catch protocol
become status codes threaded out of the jits.
"""
from __future__ import annotations

import time

import numpy as np
import jax
import jax.numpy as jnp

from .._config import eps as dtype_eps


def _debug_timing(tag, t0):
    """Phase timing for the host-side plan builders (MGBTPU_TIMING=1)."""
    import os as _o

    if _o.environ.get("MGBTPU_TIMING"):
        print(f"[mgbtpu-timing] {tag}: {time.time() - t0:.2f}s", flush=True)

from ..convex.convex import Convex, validate_convex_inputs
from ..hierarchy.multigrid import AMGSystem, prepare_amg
from ..utils.errors import MGBConvergenceFailure
from ..utils.log import Log, Logger
from .barrier import make_level_fns
from .levelops import build_panel_ops
from .ramp import _EASY_BONUS
from .newton import (CONVERGED, PREDICTOR, make_newton, stopping_exact,
                     stopping_inexact,
                     linesearch_backtracking)

# Two-phase ND factor precision for the fused ramp (dd path only): below
# t = ND_DD_T the chunk kernel factors the ND fronts in NATIVE f32 (batched
# lax.linalg Cholesky/triangular solves) and above it in double-float. The
# f32 factor's preconditioned residual is ~ kappa_eq(t) * eps(f32), so the
# dd GMRES-IR corrector should tolerate it at low t; measured on earlier
# hardware the split cost more Newton and CG iterations than the cheap
# factors saved. Default 0 (pure dd ramp); the knob stays for A/Bs.
import os as _os_mod

ND_DD_T = float(_os_mod.environ.get("MGBTPU_ND_DD_T", 0))


def _nd_dd_for(kern, t1):
    """Factor-precision flag for a centering at t1: False (cheap f32 ND
    fronts) below ND_DD_T on the dd path, None (defaults) otherwise."""
    return False if (kern.dd and ND_DD_T > 0 and t1 < ND_DD_T) else None


def check_dtype_for_device(dtype):
    """Refuse the float32 + double-float path on the GPU, which has float64
    in hardware: measured on an H100 at fem2d_P2 L=5-6, dd ran 2.3-3.9x
    slower than float64 and missed its 1e-5 bar against it (max|dz|
    2.0e-5 at L=5, the same as on the CPU: the float32 rounding of the
    problem data, not GPU arithmetic)."""
    if np.dtype(dtype) == np.float32 and _solve_platform() == "gpu":
        raise ValueError(
            "float32 (double-float) solves are refused on the GPU, where "
            "they miss their 1e-5 accuracy bar against float64; use "
            "dtype=np.float64 (the default)")


def effective_eps(dtype):
    """Precision the solver actually works at: double-float (~2^-48) on the
    float32 path — the per-node barrier derivatives, reductions, and
    carries all run in dd (solver/barrier.py, ops/ddarray.py) — else the
    dtype's own eps. Clamped to eps(f64) so the default tolerance
    sqrt(eff_eps) matches the reference's Float64 semantics
    (reference src/mgb.jl:96)."""
    if np.dtype(dtype) == np.float32:
        return float(np.finfo(np.float64).eps)
    return dtype_eps(dtype)


# ---------------------------------------------------------------------------
# Defaults (reference src/mgb.jl:586-613)
# ---------------------------------------------------------------------------

def default_f(dim):
    def f(x):
        out = np.zeros(dim + 2)
        out[0] = 0.5
        out[-1] = 1.0
        return out
    return f


def default_g(dim):
    if dim == 1:
        return lambda x: np.array([x[0], 2.0])
    return lambda x: np.array([float(np.sum(np.asarray(x[:dim]) ** 2)), 100.0])


def default_D(dim):
    ops = ["dx", "dy", "dz"][:dim]
    return [("u", "id")] + [("u", o) for o in ops] + [("s", "id")]


def default_idx(dim):
    return tuple(range(1, dim + 2))


def barrier_weights(w: np.ndarray, barrier_nodes):
    """Resolve the barrier-node selection to per-node weights (mean over the
    selection). Reference ``_barrier_weights`` (``src/convex.jl:279-304``)."""
    n = len(w)
    if barrier_nodes is None:
        sel = (w != 0).astype(w.dtype)
    elif barrier_nodes is Ellipsis or (isinstance(barrier_nodes, str)
                                       and barrier_nodes == "all"):
        sel = np.ones(n, dtype=w.dtype)
    else:
        bn = np.asarray(barrier_nodes)
        if bn.dtype == bool:
            if len(bn) != n:
                raise ValueError("barrier_nodes mask length mismatch")
            sel = bn.astype(w.dtype)
        else:
            sel = np.zeros(n, dtype=w.dtype)
            sel[bn.astype(np.int64)] = 1
    m = sel.sum()
    if m == 0:
        raise ValueError("barrier_nodes selects no nodes")
    return sel / m


def flat_weights(w):
    return np.full(len(w), 1.0 / len(w), dtype=w.dtype)


# ---------------------------------------------------------------------------
# Per-problem kernels: panel plans + jitted newtons, cached per AMGSystem
# ---------------------------------------------------------------------------

class ProblemKernels:
    """Lazy per-level jitted solvers for one (AMGSystem, barrier-triple)."""

    def __init__(self, M: AMGSystem, Fs, line_search, dtype, mesh=None):
        self.M = M
        self.Fs = Fs
        self.line_search = line_search
        self.dtype = dtype
        self.mesh = mesh
        self.p = M.geometry.x.shape[0]
        self._ops = {}
        self._ops_solve = {}
        # double-float reductions + df64 objective on the float32 path:
        # plain f32 accumulation makes the assembled Hessian numerically
        # indefinite and floors the Newton decrement above its tolerance
        self.dd = np.dtype(dtype) == np.float32
        self.fns = make_level_fns(Fs)
        self._newton = make_newton(*self.fns, line_search=line_search,
                                   dd=self.dd)
        if mesh is None:
            # AOT export cache: skip Python re-tracing of the Newton
            # program in warm processes (utils/aot.py; exports bake
            # shardings, so mesh runs use the plain jit)
            from ..utils.aot import XJit

            self._newton = XJit(self._newton, "newton")
        self._newton_cheap = None
        F0 = Fs[0]
        self._node_f0 = jax.jit(lambda args, Dz: jax.vmap(F0)(*args, Dz))
        _, _f1, _f2 = self.fns

        def _matched(s0, wc0, wcc, ops, Dz0, bw, *args):
            from .levelops import GramHessian
            from .newton import (dense_ir_solve, equilibrated_solve,
                                 pcg_solve)

            fa0 = (ops, Dz0, wc0, bw) + args
            fac = (ops, Dz0, wcc, bw) + args
            g_phi = _f1(s0, *fa0)
            g_c = _f1(s0, *fac) - g_phi
            H = _f2(s0, *fac)
            if isinstance(H, GramHessian):
                pcg_like = H.ctx is not None and \
                    getattr(H.ctx, "nd", None) is None
                solve = pcg_solve if pcg_like else dense_ir_solve
            else:
                solve = equilibrated_solve
            n_phi = solve(H, g_phi)
            n_c = solve(H, g_c)
            from ..ops.ddarray import fl

            return (fl(g_c @ n_c), fl(g_phi @ n_c) + fl(g_c @ n_phi))

        self._matched = jax.jit(_matched)
        if mesh is None:
            from ..utils.aot import XJit

            self._matched = XJit(self._matched, "matched")

    def _newton_for(self, nd_dd=None):
        """The per-step Newton program for the requested ND factor
        precision: the default (dd on the f32 path), or the lazily built
        cheap variant (native f32 ND fronts) for low-t centerings — the
        same two-phase split as the fused ramp (ND_DD_T)."""
        if nd_dd is not False or not self.dd:
            return self._newton
        if self._newton_cheap is None:
            n = make_newton(*self.fns, line_search=self.line_search,
                            dd=self.dd, nd_dd=nd_dd)
            if self.mesh is None:
                from ..utils.aot import XJit

                n = XJit(n, "newton32")
            self._newton_cheap = n
        return self._newton_cheap

    # Levels above DENSE_MAX coefficients solve by a sparse direct or
    # multigrid-preconditioned CG Newton solve instead of a dense
    # factorization; the V-cycle's dense base is the largest level below
    # DENSE_BASE, and the cycle uses at most MAX_VCYCLE levels (transfer
    # chains are composed host-side to skip intermediates). Measured on the
    # CPU at fem2d_P2 L=5 (top n_J 5057): ND direct 164 s / 155 CG its vs
    # dense 800-980 s / 14k-26k CG its; small tops stay dense. Neither
    # threshold has been measured on the GPU yet.
    DENSE_MAX = int(__import__("os").environ.get("MGBTPU_DENSE_MAX", 1024))
    DENSE_BASE = int(__import__("os").environ.get("MGBTPU_DENSE_BASE", 2048))
    MAX_VCYCLE = int(__import__("os").environ.get("MGBTPU_MAX_VCYCLE", 3))
    # nested-dissection leaf size (elements per leaf front); not yet tuned
    # on the GPU.
    ND_LEAF_ELEMS = int(__import__("os").environ.get("MGBTPU_ND_LEAF", 8))

    def _plain_ops(self, l):
        if l not in self._ops:
            t0 = time.time()
            self._ops[l] = build_panel_ops(self.M.D_fine, self.M.nu,
                                           self.M.R_fine[l], self.p,
                                           self.dtype, dd=self.dd)
            _debug_timing(f"plain_ops[{l}] n_J={self._ops[l].n_J}", t0)
        return self._ops[l]

    def ops(self, l):
        if l in self._ops_solve:
            return self._ops_solve[l]
        base = self._plain_ops(l)
        if base.n_J <= self.DENSE_MAX or base.N < 4:
            # few-big-elements discretizations (spectral: N=1) have no
            # useful element partition for nested dissection — their "ND"
            # factor degenerates to a rolled dense Cholesky; keep the
            # batched dense path regardless of size
            self._ops_solve[l] = base
            return base
        import dataclasses

        from .levelops import PCGContext, build_ell
        from .newton import BIG_PRE

        if BIG_PRE != "nd" and any(self.M.T_fine[j] is None for j in range(l)):
            # a non-nested subspace: no coefficient transfers, so no
            # V-cycle; fall back to the dense path (may be large). The
            # nested-dissection solver needs no transfers and handles
            # non-nested subspaces.
            self._ops_solve[l] = base
            return base

        cols_host = getattr(base, "host_cols", None)
        if cols_host is None:  # pragma: no cover - legacy pickles
            cols_host = np.asarray(base.cols)
        nd = None
        if BIG_PRE == "nd":
            # nested-dissection direct factorization plan (ops/ndchol.py):
            # the default large-level solver. Element centroids from the
            # fine geometry; symbolic analysis once per level.
            from ..ops.ndchol import NDPlan, NDDevicePlan

            t0 = time.time()
            X = np.asarray(self.M.geometry.xflat(), np.float64)
            exy = X.reshape(base.N, base.p, -1).mean(axis=1)
            nd = NDDevicePlan(
                NDPlan(cols_host, base.n_J, exy,
                       leaf_elems=self.ND_LEAF_ELEMS)).to_device(
                           mesh=self.mesh)
            _debug_timing(f"nd_plan[{l}] n_J={base.n_J}", t0)
            ctx = PCGContext(coarse_ops=(), transfers=(),
                             n_levels=0, dense_level=-1, nd=nd)
            out = dataclasses.replace(base, pcg_ctx=ctx)
            self._ops_solve[l] = out
            return out
        dense_level = 0
        for j in range(l):
            if self._plain_ops(j).n_J <= self.DENSE_BASE:
                dense_level = j
        # pick the V-cycle's level subset: the dense base, then at most
        # MAX_VCYCLE-1 smoothing levels geometrically spaced up to l
        chosen = [dense_level]
        candidates = list(range(dense_level + 1, l))
        keep = min(self.MAX_VCYCLE - 1, len(candidates))
        if keep > 0:
            pick = np.unique(np.linspace(0, len(candidates) - 1,
                                         keep).round().astype(int))
            chosen += [candidates[i] for i in pick]
        # composed transfers between consecutive chosen levels (and up to l)
        hops = chosen + [l]
        transfers = []
        t0 = time.time()
        for a, b in zip(hops[:-1], hops[1:]):
            T = self.M.T_fine[a]
            for j in range(a + 1, b):
                T = self.M.T_fine[j] @ T
            transfers.append(build_ell(T.astype(self.dtype), self.dtype))
        _debug_timing(f"transfers[{l}]", t0)
        from .fsai import build_fsai_plan

        t0 = time.time()
        fsai = build_fsai_plan(cols_host, base.n_J)
        _debug_timing(f"fsai_plan[{l}]", t0)
        t0 = time.time()
        # composed transfer dense-base -> solve level for the 2-level
        # coarse-grid correction, 128-block tiled (ops/bsr.py)
        from ..ops.bsr import build_bsr

        T_all = self.M.T_fine[chosen[0]]
        for j in range(chosen[0] + 1, l):
            T_all = self.M.T_fine[j] @ T_all
        coarse_T = build_bsr(T_all.astype(self.dtype), self.dtype)
        _debug_timing(f"coarse_T[{l}]", t0)
        t0 = time.time()
        ctx = PCGContext(
            coarse_ops=tuple(self._plain_ops(j) for j in chosen),
            transfers=tuple(transfers),
            n_levels=len(chosen), dense_level=0,
            fsai=fsai, coarse_T=coarse_T)
        out = dataclasses.replace(base, pcg_ctx=ctx)
        _debug_timing(f"ctx_replace[{l}]", t0)
        self._ops_solve[l] = out
        return out

    def _Dz0_for(self, z):
        """Dz0 in the barrier-fargs representation: a DD pair in dd mode
        (computed in f64 on host, split error-free — the per-node barrier
        evaluations need Dz to more than f32 bits, see solver/barrier.py),
        else a plain device array."""
        if not self.dd:
            return jnp.asarray(self.M.apply_D_full(z).astype(self.dtype))
        from ..ops.ddarray import DD
        from ..ops.df64 import f64_split

        Dz = self.M.apply_D_full(np.asarray(z, dtype=np.float64))
        hi, lo = f64_split(Dz, dtype=self.dtype)
        return DD(jnp.asarray(hi), jnp.asarray(lo))

    def _fargs(self, l, z, wc, bw, args):
        fa = (self.ops(l), self._Dz0_for(z),
              jnp.asarray(wc.astype(self.dtype)),
              jnp.asarray(bw.astype(self.dtype))) + tuple(args)
        if self.mesh is not None:
            from ..parallel.sharding import shard_fargs

            ops = self.ops(l)
            fa = shard_fargs(self.mesh, fa, ops.n_nodes, ops.N)
        return fa

    def run_newton(self, l, z, wc, bw, args, *, maxit, stopping,
                   pred_r=None, nd_dd=None):
        """Newton in the level-l search space from s0 = 0 (or, when
        ``pred_r`` is given, from the central-path tangent predictor —
        see ``newton.make_newton_core``). ``nd_dd=False`` selects the
        cheap (native f32 ND fronts) program for low-t centerings."""
        kind, theta, lambda_tol = stopping
        x0 = jnp.zeros((self.ops(l).n_J,), dtype=self.dtype)
        x, y, k, status, cg = self._newton_for(nd_dd)(
            x0, self._fargs(l, z, wc, bw, args), jnp.asarray(maxit, jnp.int32),
            jnp.asarray(lambda_tol if kind == "inexact" else -1.0, self.dtype),
            jnp.asarray(theta, self.dtype),
            pred_r=(None if pred_r is None
                    else jnp.asarray(pred_r, self.dtype)))
        return (np.asarray(x), float(y), int(k), int(status), int(cg))

    def _R_ell(self, l):
        if not hasattr(self, "_r_ell_cache"):
            self._r_ell_cache = {}
        if l not in self._r_ell_cache:
            from .levelops import build_ell

            self._r_ell_cache[l] = build_ell(
                self.M.R_fine[l].astype(self.dtype), self.dtype)
        return self._r_ell_cache[l]

    def _ramp_for(self, feas_block, nd_dd=None):
        if not hasattr(self, "_ramp_cache"):
            self._ramp_cache = {}
        key = (feas_block, nd_dd)
        if key not in self._ramp_cache:
            from .ramp import make_ramp

            ramp = make_ramp(
                self.fns, line_search=self.line_search, dd=self.dd,
                feas_block=feas_block, nd_dd=nd_dd)
            if self.mesh is None:
                from ..utils.aot import XJit

                tag = ("ramp" + ("" if feas_block is None else "F")
                       + ("" if nd_dd is None else ("DD" if nd_dd else "32")))
                ramp = XJit(ramp, tag)
            self._ramp_cache[key] = ramp
        return self._ramp_cache[key]

    def run_ramp(self, z, t, kappa, t_first, wcc, bw, args, *, target,
                 kappa0, max_newton, max_newton_retry, easy_its, stopping,
                 feas_block, max_steps, nd_dd=None):
        """One fused on-device ramp chunk from (z, t, kappa) at the finest
        level; returns a RampChunk (see ``solver/ramp.py``)."""
        from .ramp import HIST, RampChunk

        kind, theta, lambda_tol = stopping
        l = self.M.depth - 1
        ops = self.ops(l)
        dtype = self.dtype
        Dz0 = self._Dz0_for(z)
        if self.dd:
            from ..ops.ddarray import DD
            from ..ops.df64 import f64_split

            # error-free split of the (host f64) iterate: at deep t the
            # distance-to-wall r ~ 1/t is below the f32 resolution of z, so
            # truncating z to f32 would push the iterate off the central
            # path (the t ~ 3e7 fused-path stall)
            zh, zl = f64_split(np.asarray(z, dtype=np.float64), dtype=dtype)
            z_dev = DD(jnp.asarray(zh), jnp.asarray(zl))
        else:
            z_dev = jnp.asarray(np.asarray(z, dtype=dtype))
        ramp = self._ramp_for(feas_block, nd_dd)
        arrs = (z_dev, Dz0, self._R_ell(l), ops,
                jnp.asarray(wcc.astype(dtype)), jnp.asarray(bw.astype(dtype)),
                tuple(args))
        if self.mesh is not None:
            # shard the node/element axes exactly like the per-step Newton
            # path (_fargs); GSPMD propagates the shardings through the
            # fused while_loop and inserts the same collective set the
            # pinned contract test checks (tests/test_sharding.py)
            from ..parallel.sharding import shard_fargs

            arrs = shard_fargs(self.mesh, arrs, ops.n_nodes, ops.N)
        (z_dev, Dz0, R_ell, ops_s, wcc_dev, bw_dev, args_s) = arrs
        out = ramp(
            z_dev, Dz0, R_ell, ops_s, wcc_dev, bw_dev, args_s,
            jnp.asarray(t, dtype), jnp.asarray(kappa, dtype),
            jnp.asarray(t_first, dtype), jnp.asarray(target, dtype),
            jnp.asarray(kappa0, dtype), jnp.asarray(max_newton, jnp.int32),
            jnp.asarray(max_newton_retry, jnp.int32),
            jnp.asarray(easy_its, dtype),
            jnp.asarray(lambda_tol if kind == "inexact" else -1.0, dtype),
            jnp.asarray(theta, dtype),
            jnp.asarray(min(max_steps, HIST), jnp.int32))
        return RampChunk(out)

    def node_f0(self, args, Dz):
        return np.asarray(self._node_f0(tuple(args), jnp.asarray(Dz)))


def _kernels_for(M: AMGSystem, Fs, line_search, dtype,
                 mesh=None) -> ProblemKernels:
    cache = getattr(M, "_kernel_cache", None)
    if cache is None:
        cache = {}
        M._kernel_cache = cache
    # the kernels hold device arrays: one set per device the solve runs on
    key = (tuple(map(id, Fs)), line_search, np.dtype(dtype).name, id(mesh),
           str(jax.config.jax_default_device))
    if key not in cache:
        cache[key] = ProblemKernels(M, Fs, line_search, dtype, mesh=mesh)
    return cache[key]


# ---------------------------------------------------------------------------
# mgb_step: one centering across the hierarchy (divide & conquer)
# ---------------------------------------------------------------------------

def divide_and_conquer(eta, j, J):
    """Try the coarse->level-J jump; on failure bisect the level interval.
    Reference ``src/mgb.jl:10-15``."""
    if eta(j, J):
        return True
    jmid = (j + J) // 2
    if jmid == j or jmid == J:
        return False
    return divide_and_conquer(eta, j, jmid) and divide_and_conquer(eta, jmid, J)


def mgb_step(kern: ProblemKernels, z, wc, bw, args, *, maxit, max_newton,
             stopping, finalize, log, initial_step=False, pred_r=None,
             first_budget=None, nd_dd=None):
    """One centering at fixed t over the hierarchy; returns (z, its, conv).

    Never early-stops mid-V-cycle: the iterate handed back must be centered
    at its t (reference ``src/mgb.jl:36-46``). Multi-level jumps are capped
    at ``max_newton`` so failures trigger bisection; initial single-level
    steps run to the global ``maxit`` (``src/mgb.jl:64-72``). ``pred_r``
    warm-starts the FIRST attempt (the direct full jump, whose start is the
    previous center) with the path-tangent predictor; later divide&conquer
    attempts start from a coarse-corrected iterate where the tangent's
    linearization point is gone, so they stay cold. ``first_budget`` (the
    2x attempt budget, see mgb_core) applies to that first attempt ONLY:
    giving it to every bisection attempt as well turns a structural
    cascade's D&C recovery from ~55 its into ~150 (measured fem2d_P1 L=8:
    287 -> 417 total), while the direct jump is where a marginal failure
    converts into a ~50-it saving.
    """
    M = kern.M
    L = M.depth
    its = np.zeros(L, dtype=np.int64)
    cg_tot = [0]
    state = {"z": z, "pred_r": pred_r, "first": first_budget}

    def eta(j, J, stop, mi):
        log("mgb_step", f"j={j} J={J}")
        pr, state["pred_r"] = state["pred_r"], None
        fb, state["first"] = state["first"], None
        # initial single-level centerings run to the global maxit (see mn);
        # the 2x first-attempt budget must not cap them
        use_fb = fb is not None and not (initial_step and J - j == 1)
        x, y, k, status, cg = kern.run_newton(J - 1, state["z"], wc, bw, args,
                                              maxit=(fb if use_fb else mi),
                                              stopping=stop,
                                              pred_r=pr, nd_dd=nd_dd)
        its[J - 1] += k
        cg_tot[0] += cg
        conv = status == CONVERGED
        # Keep PARTIAL progress from a failed attempt: the damped Newton's
        # returned iterate is Armijo-monotone for this same t1-centering
        # objective, so it is a strictly better starting point for the
        # divide&conquer recovery than the previous center — discarding it
        # (as the reference does, src/mgb.jl:36-46) re-pays the whole
        # approach. Measured f64: fem2d_P2 L=7 318 -> 195 its, fem2d_P1
        # L=8 241 -> 196, with the kappa ladder never shrinking (12/12
        # steps at every level) because the rescued D&C now always lands.
        if conv or np.all(np.isfinite(x)):
            state["z"] = state["z"] + M.R_fine[J - 1] @ x
        if not conv:
            log("mgb_step", f"level {J} newton status={status} k={k}")
        return conv

    def mn(j, J):
        return maxit if (initial_step and J - j == 1) else max_newton

    converged = divide_and_conquer(
        lambda j, J: eta(j, J, stopping, mn(j, J)), 0, L)
    z_unfinalized = state["z"]
    if finalize is not None:
        log("mgb_step", "finalize")
        ok = eta(L - 1, L, finalize, maxit)
        converged = converged and ok
    log("mgb_step", f"converged={converged}")
    return state["z"], z_unfinalized, its, cg_tot[0], converged


# ---------------------------------------------------------------------------
# mgb_core: the t-ramp (path following with kappa adaptation)
# ---------------------------------------------------------------------------

def _solve_platform():
    """Platform the current solve runs on: the ``jax.default_device`` in
    force (``mgb_solve(device=...)``), else the default backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def _early(f, z, t):
    try:
        return f(z, t)
    except TypeError:
        return f(z)


def _fused_ramp_loop(kern, z, z_unf, t, kappa, k, args, *, w, c, bw, target,
                     tinit, kappa0, maxit, max_newton, stopping, finalize,
                     feas_block, wc_at, record, hists, progress, log, L,
                     budget, easy_its):
    """Drive the fused on-device ramp; fall back to the classic level-bisected
    ``mgb_step`` only for the (rare) centering failures. Returns
    (z, z_unf, t, kappa, k, converged, attempts): ``attempts`` counts every
    centering attempt (in-kernel k_att + each assisted mgb_step), so failed
    kappa-ladder retries are visible in SOL.steps_attempted. An error in a
    chunk dispatch propagates to the caller."""
    from .ramp import R_EARLY, R_NEED_HELP, R_TARGET

    its_hist, ts_hist, kappa_hist, time_hist, cdz_hist, cg_hist = hists
    wcc = w[:, None] * c
    attempts = 0
    t_first = np.inf
    if feas_block is not None:
        lo, hi = feas_block
        if float(np.max(z[lo:hi])) < 0:
            t_first = t
    converged = t >= target
    while not converged and kappa > 1 and k < maxit:
        prog = float(np.clip(np.log(t / tinit) / np.log(target / tinit), 0, 1)) \
            if tinit < target else 1.0
        progress(prog)
        # two-phase factor precision: cheap f32 ND fronts while t is below
        # ND_DD_T (capping the chunk target there so the program never
        # centers past its precision regime), dd fronts beyond
        cheap = bool(kern.dd and ND_DD_T > 0 and t < min(ND_DD_T, target))
        chunk_target = min(target, ND_DD_T) if cheap else target
        log("mgb_core", f"fused ramp chunk from t={t} kappa={kappa} k={k}"
            + (f" [f32 fronts to t={chunk_target:g}]" if cheap else ""))
        chunk = kern.run_ramp(
            z, t, kappa, t_first, wcc, bw, args, target=chunk_target,
            kappa0=kappa0,
            max_newton=budget, max_newton_retry=max_newton,
            easy_its=easy_its, stopping=stopping,
            feas_block=feas_block, max_steps=maxit - k,
            nd_dd=False if cheap else None)
        now = time.time()
        for i in range(chunk.nrec):
            e = np.zeros(L, dtype=np.int64)
            e[L - 1] = int(chunk.its[i])
            its_hist.append(e)
            ts_hist.append(float(chunk.ts[i]))
            kappa_hist.append(float(chunk.kappas[i]))
            time_hist.append(now)
            cdz_hist.append(float(chunk.cdz[i]))
            cg_hist.append(int(chunk.cg[i]))
        k += chunk.k_att
        attempts += chunk.k_att
        if chunk.k_att or chunk.status in (R_TARGET, R_EARLY):
            # always adopt the kernel's iterate: failed in-kernel attempts
            # also advanced z (kept-partial, Armijo-monotone — see ramp.py),
            # which is exactly the starting point the assisted divide &
            # conquer should resume from
            z, z_unf = chunk.z, chunk.z_unf
        t, kappa, t_first = chunk.t, chunk.kappa, chunk.t_first
        log("mgb_core",
            f"chunk: {chunk.nrec} steps to t={t}, status={chunk.status}")
        if chunk.status == R_TARGET and cheap and t < target:
            # the cheap chunk reached its capped target (= ND_DD_T), not
            # the real one: re-enter the loop, which now picks dd fronts
            continue
        if chunk.status == R_TARGET:
            # host-side finalize polish at the reached t (the exact-stopping
            # Newton is kept out of the ramp kernel for compile size)
            if finalize is not None:
                log("mgb_core", "finalize")
                L_idx = kern.M.depth
                x, yv, kf, st, cgf = kern.run_newton(
                    L_idx - 1, z, wc_at(t), bw, args, maxit=maxit,
                    stopping=finalize)
                if st == CONVERGED:
                    z_unf = z
                    z = z + kern.M.R_fine[L_idx - 1] @ x
                    its_hist[-1][L_idx - 1] += kf
                    cg_hist[-1] += cgf
                else:
                    log("mgb_core", f"finalize stalled (status={st}); "
                        "keeping the centered iterate")
            converged = True
        elif chunk.status == R_EARLY:
            converged = True
        elif chunk.status == R_NEED_HELP:
            # the on-device centering failed: classic divide & conquer for
            # this one t (level bisection), reference src/mgb.jl:131-158
            its_acc = np.zeros(L, dtype=np.int64)
            its_acc[L - 1] += chunk.last_its
            cg_acc = 0
            while kappa > 1:
                t1 = min(kappa * t, target)   # never center past 1/tol
                # marginal-centering razor edge: when the decrement hovers at
                # ~lambda_tol a centering can need ~max_newton+1 iterations
                # and the sqrt(kappa) ladder then grinds asymptotically (the
                # L=5/L=6 t~180 stall). Once kappa has collapsed, make ONE
                # full-budget attempt; only its failure is a true stall.
                boost = kappa < 1.05
                log("mgb_core", f"assisted step: t={t} kappa={kappa} t1={t1}"
                    + (" (full budget)" if boost else ""))
                fin = finalize if t1 >= target else None
                z_try, z_unf_try, its, cg_s, conv = mgb_step(
                    kern, z, wc_at(t1), bw, args, maxit=maxit,
                    max_newton=(min(max(4 * max_newton, 2 * budget), maxit)
                                if boost else max_newton),
                    first_budget=None if boost else budget,
                    stopping=stopping, finalize=fin,
                    log=log,
                    pred_r=((t / t1) * (1.0 - t / t1)) if PREDICTOR else None,
                    nd_dd=_nd_dd_for(kern, t1))
                attempts += 1
                its_acc += its
                cg_acc += cg_s
                if conv:
                    if its.max() <= easy_its:
                        kappa = min(kappa0, kappa ** 2)
                    z, z_unf = z_try, z_unf_try
                    t = t1
                    break
                if boost:
                    kappa = 1.0
                    break
                log("mgb_core", "t refinement failed, shrinking kappa")
                kappa = np.sqrt(kappa)
            k += 1
            record(t, kappa, its_acc, z, cg_acc)
            if feas_block is not None and kappa > 1:
                lo, hi = feas_block
                if float(np.max(z[lo:hi])) < 0:
                    t_first = min(t_first, t)
                    if t >= 2 * t_first:
                        converged = True
            if t >= target:
                converged = True
        # else: chunk exhausted its step budget; loop re-enters
    return z, z_unf, t, kappa, k, converged, attempts


def mgb_core(kern: ProblemKernels, z, c, args, *, w, bw, tol, t, maxit=10000,
             kappa=6.5, early_stop=None, progress=None, max_newton=None,
             stopping, finalize, log):
    """Path following from t to 1/tol; adaptive kappa (t-step factor).

    Success with few Newton its -> kappa = min(kappa0, kappa^2); failure ->
    kappa = sqrt(kappa); kappa <= 1 -> stall. Reference ``src/mgb.jl:91-183``
    (whose default kappa0 = 10). Default kappa0 = 6.5 here: a sweep at
    fem2d_P2 L=4/L=5 f64 found total Newton its 76/90 at 6.5 vs 156/155 at
    10.0 (p=1; similar at p=1.5, 2.0) — kappa = 10 steps routinely cost more
    than max_newton/2 its so the ramp never re-accelerates after the first
    shrink, while 6.5 keeps every step "easy" and halves the iteration bill.
    """
    t_begin = time.time()
    dtype = kern.dtype
    epsT = effective_eps(dtype)
    if max_newton is None:
        # reference formula (src/mgb.jl:101) + 2 extra: each kappa-jump
        # centering lands at ~8 iterations, exactly the reference's budget —
        # a razor edge where marginal centerings flip into failure cascades.
        # Swept at L=6: f32/dd 329 -> 176 its, f64 235 -> 180 its with the
        # +2; kappa0 = 10 or 4 are both worse at either budget.
        max_newton = int(np.ceil(np.log2(-np.log2(epsT)))) + 4
    # Attempt budget vs acceleration threshold — decoupled. max_newton is
    # the BASE: the kappa-acceleration threshold stays at base/2 (+bonus),
    # but each centering attempt may run to BUDGET_FACTOR x base before it
    # is declared failed. The deep-L cascade profile (fem2d_P1 L=7/8 f64)
    # shows the hard centerings need 15-20 its — just over the base budget
    # of 10 — and a failed attempt restarts from x0=0, so declaring failure
    # at 10 wastes the whole attempt and triggers a ~50-it divide&conquer.
    # Pinned-threshold sweep at L=7: factor 1.0 = 444 its (3 cascades),
    # 1.4 = 460, 2.0 = 289 its (1 cascade), 3.0 = 339 — the survivor at 2.0
    # is structural (>30 its direct) and exactly what D&C is for. Earlier
    # budget sweeps that moved the threshold WITH the budget (easy = half
    # the budget) made big budgets look bad: kappa accelerated on 11-it
    # steps and overshot into new failures.
    budget = int(np.ceil(float(
        __import__("os").environ.get("MGBTPU_BUDGET_FACTOR", 2.0))
        * max_newton))
    easy_its = max_newton * 0.5 + _EASY_BONUS
    fusable_stop = early_stop is None or (isinstance(early_stop, tuple)
                                          and early_stop[0] == "feasibility")
    if early_stop is None:
        early_stop = lambda z_: False
    if progress is None:
        progress = lambda x: None
    tinit = t
    target = 1.0 / tol
    kappa0 = kappa
    L = kern.M.depth
    (its_hist, ts_hist, kappa_hist, time_hist, cdz_hist,
     cg_hist) = [], [], [], [], [], []

    def wc_at(tv):
        return w[:, None] * (tv * c)

    def record(tv, kv, its, zv, cg=0):
        its_hist.append(its)
        ts_hist.append(tv)
        kappa_hist.append(kv)
        time_hist.append(time.time())
        cg_hist.append(int(cg))
        Dz = kern.M.apply_D_full(zv)
        cdz_hist.append(float(np.sum(w[:, None] * c * Dz)))

    initial_finalize = finalize if t >= target else None
    z, z_unf, its, cg0, conv = mgb_step(kern, z, wc_at(t), bw, args,
                                        maxit=maxit,
                                        max_newton=max_newton,
                                        first_budget=budget,
                                        stopping=stopping,
                                        finalize=initial_finalize, log=log,
                                        initial_step=True,
                                        nd_dd=_nd_dd_for(kern, t))
    log("mgb_core", "initial centering done")
    if not conv:
        raise MGBConvergenceFailure(
            f"Initial centering failed at t={t}, tol={tol}, maxit={maxit}.",
            "stall")
    record(t, kappa, its, z, cg0)
    k = 1
    attempts = 1  # the initial centering
    # The fused on-device ramp pays for itself on a device that is not the
    # host: one dispatch and one host sync per ramp instead of per
    # centering. On the host the classic loop reuses the per-level newton
    # jits that the initial centering / bisection need anyway, so fusing
    # only adds compile time. MGBTPU_FUSED_RAMP=1/0 overrides (tests force
    # 1 for ramp coverage).
    env_fused = __import__("os").environ.get("MGBTPU_FUSED_RAMP")
    want_fused = (env_fused != "0") if env_fused is not None \
        else _solve_platform() != "cpu"
    fused = fusable_stop and want_fused
    if isinstance(early_stop, tuple):
        # materialize the structured feasibility stop as a host closure for
        # the classic loop (same semantics as the fused on-device check)
        feas_block_host = early_stop[1]
        lo_b, hi_b = early_stop[1]
        t_first_box = [np.inf]

        def early_stop_host(zz, tv, _lo=lo_b, _hi=hi_b, _tf=t_first_box):
            if float(np.max(zz[_lo:_hi])) >= 0:
                return False
            _tf[0] = min(_tf[0], tv)
            return tv >= 2 * _tf[0]
    else:
        feas_block_host = None
        early_stop_host = early_stop
    if fused:
        (z, z_unf, t, kappa, k, converged, att_f) = _fused_ramp_loop(
            kern, z, z_unf, t, kappa, k, args, w=w, c=c, bw=bw,
            target=target, tinit=tinit, kappa0=kappa0, maxit=maxit,
            max_newton=max_newton, stopping=stopping, finalize=finalize,
            feas_block=feas_block_host,
            wc_at=wc_at, record=record, hists=(its_hist, ts_hist, kappa_hist,
                                               time_hist, cdz_hist, cg_hist),
            progress=progress, log=log, L=L, budget=budget,
            easy_its=easy_its)
        attempts += att_f
    else:
        early_stop = early_stop_host
        while t < target and kappa > 1 and k < maxit \
                and not _early(early_stop, z, t):
            k += 1
            prog = float(np.clip(np.log(t / tinit) / np.log(target / tinit), 0, 1)) \
                if tinit < target else 1.0
            progress(prog)
            its_acc = np.zeros(L, dtype=np.int64)
            cg_acc = 0
            while kappa > 1:
                # clamp the jump at the target: centering beyond 1/tol buys
                # nothing and the overshoot step (up to kappa x too far) is
                # the most expensive centering of the whole ramp (L=8
                # profile: 98 of 378 its in the final step at 1.3x target)
                t1 = min(kappa * t, target)
                boost = kappa < 1.05   # final full-budget attempt (see the
                                       # assisted-step ladder note)
                log("mgb_core", f"k={k} t={t} kappa={kappa} t1={t1}"
                    + (" (full budget)" if boost else ""))
                fin = finalize if t1 >= target else None
                z_try, z_unf_try, its, cg_s, conv = mgb_step(
                    kern, z, wc_at(t1), bw, args, maxit=maxit,
                    max_newton=(min(max(4 * max_newton, 2 * budget), maxit)
                                if boost else max_newton),
                    first_budget=None if boost else budget,
                    stopping=stopping, finalize=fin, log=log,
                    pred_r=((t / t1) * (1.0 - t / t1)) if PREDICTOR else None,
                    nd_dd=_nd_dd_for(kern, t1))
                attempts += 1
                its_acc += its
                cg_acc += cg_s
                if conv:
                    if its.max() <= easy_its:
                        log("mgb_core", "increasing t step size")
                        kappa = min(kappa0, kappa ** 2)
                    z, z_unf = z_try, z_unf_try
                    t = t1
                    break
                if boost:
                    kappa = 1.0
                    break
                log("mgb_core", "t refinement failed, shrinking kappa")
                kappa = np.sqrt(kappa)
            record(t, kappa, its_acc, z, cg_acc)
        converged = (t >= target) or _early(early_stop, z, t)
    if not converged:
        code = "stall" if kappa <= 1 else "iteration_limit"
        raise MGBConvergenceFailure(
            f"Convergence failure at t={t}, k={k}, kappa={kappa}, tol={tol}, "
            f"maxit={maxit}.", code)
    progress(1.0)
    log("mgb_core", f"success. t={t} tol={tol}")
    t_end = time.time()
    return dict(z=z, z_unfinalized=z_unf, c=c,
                its=np.stack(its_hist, axis=1), ts=np.array(ts_hist),
                kappas=np.array(kappa_hist), t_begin=t_begin, t_end=t_end,
                t_elapsed=t_end - t_begin, times=np.array(time_hist),
                c_dot_Dz=np.array(cdz_hist), cg=np.array(cg_hist),
                # cascade diagnostics: attempted centerings — EVERY
                # mgb_step/newton attempt, including failed kappa-ladder
                # retries in the classic loop's inner ladder and the fused
                # ramp's in-kernel k_att — vs accepted ramp steps. A large
                # gap localizes the deep-L marginal-centering cascades.
                steps_attempted=int(attempts),
                steps_accepted=len(its_hist))


# ---------------------------------------------------------------------------
# Phase I: feasibility barrier with bounding box
# ---------------------------------------------------------------------------

def make_feasibility_fs(cobarrier, NC: int):
    """Wrap a cobarrier triple with the phase-I box barriers.

    Per node, with yy = (D rows..., slack u, component values v_i...) and box
    scalars (b, R) threaded as trailing per-node args:

        F0 = cobarrier(yy[:NC]) - log(b-u) - log(b+u)
             - sum_i [log(R-v_i) + log(R+v_i)]

    The factored log(R-v)+log(R+v) form avoids the catastrophic cancellation
    of log(R^2-v^2) near the walls (reference ``src/mgb.jl:190-287``).
    """
    C0, C1, C2 = cobarrier

    def F0(*aa):
        y = aa[-1]
        b, R = aa[-3], aa[-2]
        args = aa[:-3]
        yc = y[:NC]
        u = yc[NC - 1]
        v = y[NC:]
        return (C0(*args, yc) - Log(b - u) - Log(b + u)
                + (-Log(R - v) - Log(R + v)).sum())

    def F1(*aa):
        from ..ops.ddarray import cat

        y = aa[-1]
        b, R = aa[-3], aa[-2]
        args = aa[:-3]
        yc = y[:NC]
        u = yc[NC - 1]
        v = y[NC:]
        gc = C1(*args, yc)
        gs = 1.0 / (b - u) - 1.0 / (b + u)
        gv = 1.0 / (R - v) - 1.0 / (R + v)
        return cat([gc[:NC - 1], (gc[NC - 1] + gs)[None], gv])

    def F2(*aa):
        from ..ops import ddarray

        y = aa[-1]
        b, R = aa[-3], aa[-2]
        args = aa[:-3]
        yc = y[:NC]
        u = yc[NC - 1]
        v = y[NC:]
        Hc = C2(*args, yc)
        ibm, ibp = 1.0 / (b - u), 1.0 / (b + u)
        ivm, ivp = 1.0 / (R - v), 1.0 / (R + v)
        hs = ibm * ibm + ibp * ibp
        hv = ivm * ivm + ivp * ivp
        NF = y.shape[0]
        H = ddarray.zeros((NF, NF), like=y)
        H = H.at[:NC, :NC].set(Hc)
        H = H.at[NC - 1, NC - 1].add(hs)
        H = H.at[jnp.arange(NC, NF), jnp.arange(NC, NF)].add(hv)
        return H

    return (F0, F1, F2)


def _matched_t(kern: ProblemKernels, z, c, t_default, args, *, w, bw, log):
    """Barrier parameter whose central point z best approximates, capped at
    t_default: minimize the quadratic lambda_t^2 = (g_phi + t g_c)' H^-1
    (g_phi + t g_c) — two Hessian solves. Reference ``src/mgb.jl:289-330``."""
    import jax.numpy as jnp

    L = kern.M.depth
    l = L - 1
    ops = kern.ops(l)
    dtype = kern.dtype
    Dz0 = kern._Dz0_for(z)
    s0 = jnp.zeros((ops.n_J,), dtype=dtype)
    zero_wc = jnp.zeros((len(w), c.shape[1]), dtype=dtype)
    wcc = jnp.asarray((w[:, None] * c).astype(dtype))
    d, b = kern._matched(s0, zero_wc, wcc, ops, Dz0,
                         jnp.asarray(bw.astype(dtype)), *args)
    d, b = float(d), float(b)
    if not (np.isfinite(d) and np.isfinite(b) and d > 0):
        return t_default
    tstar = -b / (2 * d)
    if not (np.isfinite(tstar) and tstar > 0):
        return t_default
    tm = float(np.clip(tstar, np.sqrt(effective_eps(kern.dtype)), t_default))
    log("_matched_t", f"warm start matches t={tstar}, starting main ramp at t={tm}")
    return tm


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def mgb_driver(Mpair, f_grid, g_grid, Q: Convex, *, tol=None, t=0.1,
               t_feasibility=None, feasibility_Rmax=None, maxit=10000,
               kappa=6.5, early_stop=None, max_newton=None,
               stopping_criterion=None, line_search=None, finalize="default",
               barrier_nodes=None, progress=None, log=None, dtype=None,
               mesh=None):
    M1, M2 = Mpair
    dtype = dtype or np.asarray(f_grid).dtype
    check_dtype_for_device(dtype)
    # the dd path solves to the reference's Float64 tolerance (validated:
    # f32/dd matches the f64 solution to ~7e-9 at the same Newton counts)
    epsT = effective_eps(dtype)
    tol = tol if tol is not None else float(np.sqrt(epsT))
    t_feasibility = t_feasibility if t_feasibility is not None else t
    feasibility_Rmax = feasibility_Rmax if feasibility_Rmax is not None \
        else 1.0 / np.sqrt(epsT)
    if progress is None:
        progress = lambda x: None
    if log is None:
        log = lambda *a: None
    if stopping_criterion is None:
        # flat-averaged barrier has self-concordance constant sqrt(n):
        # lambda < eta/sqrt(n) with eta = 1/4 (reference src/mgb.jl:348-360).
        # The float32 path evaluates the per-node barrier derivatives in
        # double-float (solver/barrier.py), so the computed decrement is
        # trustworthy at this scale — no absolute floor is needed.
        lam = 0.25 / np.sqrt(len(M1.w))
        stopping_criterion = stopping_inexact(lam, 0.9)
    if line_search is None:
        line_search = linesearch_backtracking()
    if finalize == "default":
        finalize = stopping_exact(0.9)
    elif finalize is False:
        finalize = None

    w = M1.w.astype(dtype)
    bw_main = barrier_weights(w, barrier_nodes)
    bw_flat = flat_weights(w)
    m = M1.n_nodes
    nD = len(M1.D_fine)
    nu = M1.nu
    c0 = np.asarray(f_grid, dtype=dtype)
    z0 = np.asarray(g_grid, dtype=dtype)
    if z0.shape != (m, nu):
        raise ValueError(f"g grid must be ({m}, {nu}), got {z0.shape}")
    if c0.shape != (m, nD):
        raise ValueError(f"f grid must be ({m}, {nD}), got {c0.shape}")
    z2 = z0.T.reshape(-1).copy()            # stacked (nu*m,), component-major

    kern1 = _kernels_for(M1, Q.barrier, line_search, dtype, mesh=mesh)
    kern1.Q_args = tuple(Q.args)

    SOL_feasibility = None
    pbarfeas = 0.0
    Dz = M1.apply_D_full(z2)
    vals = kern1.node_f0(Q.args, Dz.astype(dtype))
    if not np.all(np.isfinite(vals)):
        pbarfeas = 0.1
        log("mgb_driver", "initial point infeasible: entering phase I")
        slack_vals = np.asarray(jax.vmap(Q.slack)(*Q.args,
                                                  jnp.asarray(Dz.astype(dtype))))
        u0 = 2 * np.maximum(slack_vals, 1.0)
        b = float(2 * max(1.0, u0.max()))
        nD2 = nD + 1 + nu
        c1 = np.zeros((m, nD2), dtype=dtype)
        c1[:, nD] = 1.0
        z1 = np.concatenate([z2, u0.astype(dtype)])
        feas_fs = make_feasibility_fs(Q.cobarrier, nD + 1)
        kern2 = _kernels_for(M2, feas_fs, line_search, dtype, mesh=mesh)
        Rbox = max(10.0, 10.0 * float(np.abs(z2).max()))
        Rmax = max(float(feasibility_Rmax), Rbox)

        def feasible(zz):
            return float(zz[nu * m:(nu + 1) * m].max()) < 0

        while True:
            log("mgb_driver", f"feasibility phase with bounding box R={Rbox}")
            args_feas = tuple(Q.args) + (
                jnp.full((m,), b, dtype=dtype), jnp.full((m,), Rbox, dtype=dtype))
            # structured early stop: mgb_core fuses the feasibility check
            # (max slack < 0 over this z block) and the 2*t_first margin
            # into the on-device ramp
            feas_stop = ("feasibility", (nu * m, (nu + 1) * m))
            failure = None
            try:
                SOL_feasibility = mgb_core(
                    kern2, z1, c1, args_feas, w=w, bw=bw_flat, tol=tol,
                    t=t_feasibility, maxit=maxit, kappa=kappa,
                    early_stop=feas_stop,
                    progress=lambda x: progress(pbarfeas * x),
                    max_newton=max_newton, stopping=stopping_criterion,
                    finalize=finalize, log=log)
            except MGBConvergenceFailure as e:
                failure = e
            except FloatingPointError as e:  # pragma: no cover
                failure = e
            if failure is None:
                zf = SOL_feasibility["z"]
                if feasible(zf):
                    break
                vmax = max(float(np.abs(zf[k2 * m:(k2 + 1) * m]).max())
                           for k2 in range(nu))
                smax = float(zf[nu * m:(nu + 1) * m].max())
                if vmax <= Rbox / 2:
                    raise MGBConvergenceFailure(
                        "The problem appears to be infeasible: the phase-I "
                        f"minimizer has positive violation (max slack ~ {smax}) "
                        f"strictly inside the bounding box (max nodal value "
                        f"~ {vmax} <= R/2 with R = {Rbox}).", "infeasible")
                log("mgb_driver",
                    f"phase-I minimizer presses the box (|v|max={vmax}, "
                    f"smax={smax}); growing R")
            else:
                log("mgb_driver", f"feasibility solve failed at R={Rbox}: {failure}")
            Rnext = 10 * Rbox
            if Rnext > Rmax:
                reason = ("the phase-I minimizer still presses the bounding box"
                          if failure is None else f"the last attempt failed: {failure}")
                raise MGBConvergenceFailure(
                    f"Could not find a strictly feasible point with nodal "
                    f"values bounded by R = {Rbox} (cap ~ {Rmax}); {reason}. "
                    "The problem is infeasible, or its feasible points exceed "
                    "the cap (rescale, or raise feasibility_Rmax).",
                    "feasibility_Rmax")
            Rbox = Rnext
            # no warm start across box rounds: restart from the pristine z1
        z2 = SOL_feasibility["z"][:nu * m].copy()
        t = min(t, _matched_t(kern1, z2, c0, t, tuple(Q.args),
                              w=w, bw=bw_main, log=log))

    SOL_main = mgb_core(kern1, z2, c0, tuple(Q.args), w=w, bw=bw_main, tol=tol,
                        t=t, maxit=maxit, kappa=kappa, early_stop=early_stop,
                        progress=lambda x: progress((1 - pbarfeas) * x + pbarfeas),
                        max_newton=max_newton, stopping=stopping_criterion,
                        finalize=finalize, log=log)
    z = SOL_main["z"].reshape(nu, m).T
    return dict(z=z, SOL_feasibility=SOL_feasibility, SOL_main=SOL_main)


# ---------------------------------------------------------------------------
# assemble / mgb_solve / solution containers
# ---------------------------------------------------------------------------

class MGBProblem:
    """Assembled, closure-free convex problem: pure data + per-node barrier
    functions; the device sees only arrays. Reference ``MGBProblem``
    (``src/mgb.jl:649-674``)."""

    def __init__(self, M, f_grid, g_grid, Q, geometry):
        self.M = M
        self.f_grid = f_grid
        self.g_grid = g_grid
        self.Q = Q
        self.geometry = geometry


class MGBSOL:
    """Solution: z (n_nodes, n_components), phase diagnostics, log, geometry."""

    def __init__(self, z, SOL_feasibility, SOL_main, log, geometry):
        self.z = z
        self.SOL_feasibility = SOL_feasibility
        self.SOL_main = SOL_main
        self.log = log
        self.geometry = geometry


def assemble(mg, *, dim=None, state_variables=None, D=None, x=None, p=1.0,
             f=None, g=None, f_grid=None, g_grid=None, Q=None, M=None,
             dtype=None, **solver_kwargs):
    """Lower a problem specification to a closure-free MGBProblem.

    Reference ``assemble`` (``src/mgb.jl:676-727``): f/g closures are sampled
    to grids, the constraint defaults to the p-Laplace power cone, and the
    (main, feasibility) AMG pair is built from the state table.
    """
    from ..convex import convex_euclidian_power
    from ..utils.maps import sample_rows

    geom = mg.geometry
    dtype = dtype or geom.dtype
    check_dtype_for_device(dtype)
    if dim is None:
        dim = geom.discretization.dim
    if state_variables is None:
        state_variables = [("u", "dirichlet"),
                           ("s", geom.discretization.default_slack_space())]
    if D is None:
        D = default_D(dim)
    if x is None:
        x = geom.xflat()
    if M is None:
        M = prepare_amg(mg, state_variables=state_variables, D=D)
    nD = len(D)
    nu = len(state_variables)
    if f_grid is None:
        f_grid = sample_rows(f or default_f(dim), x, dtype, width=nD)
    if g_grid is None:
        g_grid = sample_rows(g or default_g(dim), x, dtype, width=nu)
    if Q is None:
        Q = convex_euclidian_power(mg, idx=default_idx(dim),
                                   p=float(p), dtype=dtype)
    validate_convex_inputs(Q, nD)
    return MGBProblem(M, np.asarray(f_grid, dtype=dtype),
                      np.asarray(g_grid, dtype=dtype), Q, geom)


def mgb_solve(prob: MGBProblem, *, verbose=False, logfile=None, device=None,
              profile_dir=None, **kwargs) -> MGBSOL:
    """Solve an assembled problem; returns an MGBSOL (host arrays).

    Keyword arguments mirror the reference's solver controls: tol, t,
    t_feasibility, feasibility_Rmax, maxit, kappa, early_stop, max_newton,
    stopping_criterion, line_search, finalize, barrier_nodes, progress,
    mesh (multi-device sharding), device ("cpu"/"gpu"/a jax.Device; default
    = the default backend — the reference's device= CPU/CUDA selection).
    """
    import contextlib

    logger = Logger(stream=logfile)
    progress = kwargs.pop("progress", None)
    if verbose and progress is None:
        state = {"last": -1}

        def progress(x):  # pragma: no cover - cosmetic
            pct = int(x * 100)
            if pct > state["last"]:
                state["last"] = pct
                print(f"\rmgb_solve: {pct:3d}%", end="", flush=True)
    if isinstance(device, str):
        device = jax.devices(device)[0]
    ctx = jax.default_device(device) if device is not None \
        else contextlib.nullcontext()
    prof = (jax.profiler.trace(profile_dir) if profile_dir
            else contextlib.nullcontext())
    with ctx, prof:
        logger("mgb_solve", "device = ",
               device if device is not None else jax.default_backend())
        SOL = mgb_driver(prob.M, prob.f_grid, prob.g_grid, prob.Q,
                         progress=progress, log=logger, **kwargs)
    if verbose and progress is not None:
        print()
    return MGBSOL(SOL["z"], SOL["SOL_feasibility"], SOL["SOL_main"],
                  logger.text(), prob.geometry)


def mgb_cleanup(obj=None):
    """Flush cached per-problem kernels/plans (the reference's mgb_cleanup:
    plan caches live per hierarchy; jit executables stay in JAX's cache).

    Pass an MGBProblem, an AMGSystem, or nothing (clears JAX's caches too).
    """
    targets = []
    if obj is None:
        jax.clear_caches()
        return
    if isinstance(obj, MGBProblem):
        targets = list(obj.M)
    elif isinstance(obj, AMGSystem):
        targets = [obj]
    for M in targets:
        if hasattr(M, "_kernel_cache"):
            M._kernel_cache.clear()
