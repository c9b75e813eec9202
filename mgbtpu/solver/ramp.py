"""Fused on-device t-ramp: the whole path-following loop in one program.

Driving the t-ramp from the host costs one dispatch and one host sync per
Newton centering; fused, the ramp costs one round trip. This kernel runs
the reference's ``mgb_core`` inner loop (``src/mgb.jl:91-183``) entirely on
device at the finest level — carrying (z, Dz, t, kappa) through a ``lax.while_loop`` whose
body is a full damped-Newton centering — and exits to the host only when:

- the target t is reached (optionally after an on-device finalize pass),
- the phase-I early-stop fires (feasible and t >= 2 t_first, the reference's
  duality-gap margin, ``src/mgb.jl:478-495``), or
- a centering fails: the host then runs the classic ``mgb_step`` divide &
  conquer for that one t (coarse-level bisection is inherently level-shaped
  and rare) and re-enters the kernel.

The common path (every centering succeeds at the fine level — exactly the
reference's common path, whose ``divide_and_conquer`` tries the direct
coarse->fine jump first) costs ONE round trip for the entire ramp.

State carried on device: z (fine stacked broken coefficients, updated by an
ELL matvec with R_fine), Dz (updated incrementally by the panel apply_G so
no sparse D matvec is needed), t, kappa, t_first, and fixed-size history
arrays (ts / its / kappas / c.Dz) written at accepted steps.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .newton import CONVERGED, PREDICTOR, make_newton_core

# ramp exit statuses
R_RUNNING, R_TARGET, R_EARLY, R_NEED_HELP = range(4)

HIST = 512  # per-chunk history capacity (and outer-step bound per call)

# see easy_its in make_ramp
import os as _os

_EASY_BONUS = int(_os.environ.get("MGBTPU_KAPPA_EASY_BONUS", 1))


def make_ramp(fns, *, line_search, dd, feas_block=None, nd_dd=None):
    """Build the jitted ramp kernel.

    ``fns``: (f0, f1, f2) level functions (signature f(s, ops, Dz0, wc, bw,
    *args)); ``feas_block``: static (lo, hi) slice of z holding the phase-I
    slack values (enables the on-device feasibility early stop). The
    exact-stopping finalize polish runs HOST-side after the ramp reaches the
    target (one extra round trip): embedding a second Newton instance in the
    kernel doubled the program and its compile time.

    ``nd_dd`` statically selects the ND factor precision for this program
    (None = global default, False = native f32 fronts, True = dd fronts).
    The two-phase ramp (solver/mgb.py ND_DD_T) compiles one kernel per
    phase instead of branching inside — a lax.cond would double the
    already compile-heavy program.
    """
    newton_core = make_newton_core(*fns, line_search=line_search, dd=dd,
                                   nd_dd=nd_dd)

    def adv_Dz(ops, Dz0, x):
        return Dz0 + (ops.apply_G_dd(x) if dd else ops.apply_G(x))

    def adv_z(R_ell, z, x):
        return z + (R_ell.mv_dd(x) if dd else R_ell.mv(x))

    @jax.jit
    def ramp(z, Dz0, R_ell, ops, wcc, bw, args, t, kappa, t_first,
             target, kappa0, max_newton, max_newton_retry, easy_its,
             lambda_tol, theta, max_steps):
        """``max_newton`` is the budget for a fresh attempt at a new t;
        ``max_newton_retry`` (the base budget) caps the in-loop
        sqrt(kappa)-ladder retries after a failure — a structural centering
        otherwise burns the full 2x budget on every rung of the collapsing
        ladder before the host divide&conquer takes over."""
        dtype = z.dtype
        n_J = ops.n_J
        x0 = jnp.zeros((n_J,), dtype)

        def wr(a, idx, pred, v):
            return a.at[idx].set(jnp.where(pred, v, a[idx]))

        def cond(c):
            (z, z_unf, Dz0, t, kappa, t_first, k_att, nrec, last_its,
             h_its, h_ts, h_kap, h_cdz, h_cg, status, fail_prev) = c
            return (status == R_RUNNING) & (k_att < max_steps) & (nrec < HIST)

        def body(c):
            (z, z_unf, Dz0, t, kappa, t_first, k_att, nrec, last_its,
             h_its, h_ts, h_kap, h_cdz, h_cg, status, fail_prev) = c
            # clamp at the target: the ramp must only REACH 1/tol, and the
            # unclamped final jump centers up to kappa x past it — the most
            # expensive centering of the ramp (see mgb_core)
            t1 = jnp.minimum(kappa * t, target)
            wc = t1 * wcc
            x, y, kits, nst, kcg = newton_core(
                x0, (ops, Dz0, wc, bw) + args,
                jnp.where(fail_prev, max_newton_retry, max_newton),
                lambda_tol, theta,
                pred_r=((t / t1) * (1.0 - t / t1)) if PREDICTOR else None)
            conv = nst == CONVERGED
            Dz0n = adv_Dz(ops, Dz0, x)
            zn = adv_z(R_ell, z, x)
            reach = t1 >= target
            z_fin, Dz0f, kits_tot, conv_all = zn, Dz0n, kits, conv

            kap_n = jnp.where(kits_tot <= easy_its,
                              jnp.minimum(kappa0, kappa * kappa), kappa)
            # failed centering: retry IN the loop at kappa = sqrt(kappa)
            # (reference ``src/mgb.jl:91-183``); exit to the host's level
            # bisection only when kappa has collapsed to 1 (true stall)
            kap_fail = jnp.sqrt(kappa)
            stall = kap_fail <= 1.0 + 1e-9

            if feas_block is not None:
                lo, hi = feas_block
                zs = z_fin[lo:hi]
                if dd:
                    zs = zs.fl()
                feas_now = jnp.max(zs) < 0
                t_first_n = jnp.where(feas_now, jnp.minimum(t_first, t1),
                                      t_first)
                stop_early = feas_now & (t1 >= 2 * t_first_n)
            else:
                t_first_n = t_first
                stop_early = jnp.asarray(False)

            status_n = jnp.where(
                ~conv_all, jnp.where(stall, R_NEED_HELP, R_RUNNING),
                jnp.where(stop_early, R_EARLY,
                          jnp.where(reach, R_TARGET, R_RUNNING))
            ).astype(jnp.int32)

            # record history at accepted steps
            rec = conv_all
            idx = jnp.minimum(nrec, HIST - 1)
            from ..ops.ddarray import fl
            cdz = jnp.sum(wcc * fl(Dz0f))
            h_its = wr(h_its, idx, rec, kits_tot)
            h_ts = wr(h_ts, idx, rec, t1)
            h_kap = wr(h_kap, idx, rec, kap_n)
            h_cdz = wr(h_cdz, idx, rec, cdz)
            h_cg = wr(h_cg, idx, rec, kcg)
            nrec_n = nrec + rec.astype(jnp.int32)

            # keep PARTIAL progress from failed centerings too: the damped
            # Newton iterate is Armijo-monotone for the t1 objective, so
            # the in-loop sqrt(kappa) retry (and the host divide&conquer on
            # stall) restarts from it rather than from the previous center
            # (see mgb_step). t/kappa still only advance on success.
            adv = conv_all | jnp.all(jnp.isfinite(x))
            sel = lambda a, b: jax.tree_util.tree_map(
                lambda p, q: jnp.where(adv, p, q), a, b)
            return (sel(z_fin, z), sel(zn, z_unf), sel(Dz0f, Dz0),
                    jnp.where(conv_all, t1, t),
                    jnp.where(conv_all, kap_n, kap_fail), t_first_n,
                    k_att + 1, nrec_n, kits_tot,
                    h_its, h_ts, h_kap, h_cdz, h_cg, status_n, ~conv_all)

        zeros_h = jnp.zeros((HIST,), dtype)
        init = (z, z, Dz0, t, kappa, t_first,
                jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                jnp.asarray(0, jnp.int32),
                jnp.zeros((HIST,), jnp.int32), zeros_h, zeros_h, zeros_h,
                jnp.zeros((HIST,), jnp.int32),
                jnp.asarray(R_RUNNING, jnp.int32), jnp.asarray(False))
        out = lax.while_loop(cond, body, init)
        (z, z_unf, Dz0, t, kappa, t_first, k_att, nrec, last_its,
         h_its, h_ts, h_kap, h_cdz, h_cg, status, _fail) = out
        return dict(z=z, z_unf=z_unf, Dz0=Dz0, t=t, kappa=kappa,
                    t_first=t_first, k_att=k_att, nrec=nrec,
                    last_its=last_its, h_its=h_its, h_ts=h_ts, h_kap=h_kap,
                    h_cdz=h_cdz, h_cg=h_cg, status=status)

    return ramp


class RampChunk:
    """Host-side view of one ramp-kernel invocation."""

    def __init__(self, out):
        self.status = int(out["status"])
        self.t = float(out["t"])
        self.kappa = float(out["kappa"])
        self.t_first = float(out["t_first"])
        self.k_att = int(out["k_att"])
        self.nrec = int(out["nrec"])
        self.last_its = int(out["last_its"])
        n = self.nrec
        self.its = np.asarray(out["h_its"])[:n]
        self.ts = np.asarray(out["h_ts"])[:n]
        self.kappas = np.asarray(out["h_kap"])[:n]
        self.cdz = np.asarray(out["h_cdz"])[:n]
        self.cg = np.asarray(out["h_cg"])[:n]
        self._z = out["z"]
        self._z_unf = out["z_unf"]

    @staticmethod
    def _to_host(z):
        from ..ops.ddarray import DD

        if isinstance(z, DD):
            # reconstruct in f64: the dd low words carry the iterate's
            # sub-f32 position relative to the barrier walls
            return (np.asarray(z.hi, np.float64)
                    + np.asarray(z.lo, np.float64))
        return np.asarray(z)

    @property
    def z(self):
        return self._to_host(self._z)

    @property
    def z_unf(self):
        return self._to_host(self._z_unf)
