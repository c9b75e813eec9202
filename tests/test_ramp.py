"""Fused on-device t-ramp vs the classic host-stepped loop.

On a device other than the host the whole path-following loop runs in one
jitted program (``solver/ramp.py``); these tests force it on the CPU
(MGBTPU_FUSED_RAMP=1) and
require bit-level agreement of the trajectory endpoints with the host loop,
plus the phase-I early stop through the fused feasibility check.
"""
import io

import numpy as np
import pytest


@pytest.fixture()
def fused(monkeypatch):
    monkeypatch.setenv("MGBTPU_FUSED_RAMP", "1")


def test_fused_matches_host_loop(fused, monkeypatch):
    from mgbtpu import amg, assemble, fem1d, mgb_solve, subdivide

    geom = subdivide(fem1d(dtype=np.float64), 1)
    mg = amg(geom)
    buf = io.StringIO()
    sol_f = mgb_solve(assemble(mg, p=1.5, dtype=np.float64), logfile=buf)
    assert "fused ramp chunk" in buf.getvalue()

    monkeypatch.setenv("MGBTPU_FUSED_RAMP", "0")
    sol_h = mgb_solve(assemble(mg, p=1.5, dtype=np.float64))
    assert np.abs(sol_f.z - sol_h.z).max() < 1e-10
    # same t-trajectory endpoints and comparable step counts
    assert sol_f.SOL_main["ts"][-1] == sol_h.SOL_main["ts"][-1]
    assert abs(len(sol_f.SOL_main["ts"]) - len(sol_h.SOL_main["ts"])) <= 1


def test_fused_phase1_early_stop(fused):
    """Infeasible start: phase I must run its fused feasibility ramp and
    stop at the 2*t_first margin, then the main solve proceeds."""
    from mgbtpu import amg, assemble, fem1d, mgb_solve, subdivide

    geom = subdivide(fem1d(dtype=np.float64), 1)
    mg = amg(geom)
    # g puts the slack below the cone: |u'|^1.5 > s at the start
    prob = assemble(mg, p=1.5,
                    g=lambda x: np.array([x[0], 0.01]))
    buf = io.StringIO()
    sol = mgb_solve(prob, logfile=buf)
    log = buf.getvalue()
    assert "entering phase I" in log
    assert sol.SOL_feasibility is not None
    assert np.all(np.isfinite(sol.z))


def test_ramp_lands_exactly_on_target(fused, monkeypatch):
    """The t-ramp clamps every jump at target = 1/tol: the unclamped final
    step centered up to kappa x past the target and was the most expensive
    centering of the whole ramp (L=8 profile: 98 of 378 Newton its).
    Both loops must land the final t exactly on 1/tol."""
    from mgbtpu import amg, assemble, fem1d, mgb_solve, subdivide

    geom = subdivide(fem1d(dtype=np.float64), 1)
    prob = assemble(amg(geom), p=1.5, dtype=np.float64)
    tol = 1e-6
    sol_f = mgb_solve(prob, tol=tol)
    assert sol_f.SOL_main["ts"][-1] == 1.0 / tol

    monkeypatch.setenv("MGBTPU_FUSED_RAMP", "0")
    sol_h = mgb_solve(prob, tol=tol)
    assert sol_h.SOL_main["ts"][-1] == 1.0 / tol


def test_predictor_equivalence_and_gain(monkeypatch):
    """The central-path tangent predictor (newton._predict) is a warm start
    only: solutions must match the cold-start ramp to solver tolerance, and
    it must not cost iterations (measured at this size: 42 its vs 59).
    Fresh amg() per variant — the ramp kernel caches per AMGSystem and the
    PREDICTOR flag is baked into the traced program."""
    import mgbtpu.solver.mgb as Mg
    import mgbtpu.solver.newton as N
    import mgbtpu.solver.ramp as R
    from mgbtpu import amg, assemble, fem2d_P2, mgb_solve, subdivide

    sol_on = mgb_solve(assemble(amg(subdivide(fem2d_P2(dtype=np.float64), 2)),
                                p=1.0, dtype=np.float64))
    its_on = int(np.asarray(sol_on.SOL_main["its"]).sum())
    for m in (N, Mg, R):
        monkeypatch.setattr(m, "PREDICTOR", False)
    sol_off = mgb_solve(assemble(amg(subdivide(fem2d_P2(dtype=np.float64), 2)),
                                 p=1.0, dtype=np.float64))
    its_off = int(np.asarray(sol_off.SOL_main["its"]).sum())
    assert np.abs(sol_on.z - sol_off.z).max() < 1e-8
    assert its_on <= its_off


def test_two_phase_nd_factor_matches_pure_dd(fused, monkeypatch):
    """The two-phase fused ramp (solver/mgb.py ND_DD_T: native f32 ND
    fronts below the threshold, dd fronts above) must reproduce the
    pure-dd ramp's solution to solver tolerance. The phase switch caps the
    cheap chunk's target at ND_DD_T, so the trajectory inserts one extra
    centering there; both runs converge to the same central point at
    t = 1/tol. ND is forced down to L=3 size via DENSE_MAX (same pattern
    as tests/test_ndchol.py)."""
    from mgbtpu import amg, assemble, fem2d_P2, mgb_solve, subdivide
    from mgbtpu.solver import mgb as M

    monkeypatch.setattr(M.ProblemKernels, "DENSE_MAX", 50)
    monkeypatch.setattr(M.ProblemKernels, "DENSE_BASE", 40)
    prob = assemble(amg(subdivide(fem2d_P2(dtype=np.float32), 3)), p=1.0,
                    dtype=np.float32)
    tol = 1e-5
    monkeypatch.setattr(M, "ND_DD_T", 100.0)   # mid-ramp switch
    s1 = mgb_solve(prob, tol=tol)
    monkeypatch.setattr(M, "ND_DD_T", 0.0)     # pure dd
    s2 = mgb_solve(prob, tol=tol)
    assert np.all(np.isfinite(s1.z)) and np.all(np.isfinite(s2.z))
    # the ramp clamps at target = 1/tol; the f32 path rounds t to eps(f32)
    assert abs(s1.SOL_main["ts"][-1] * tol - 1.0) < 1e-6
    assert abs(s2.SOL_main["ts"][-1] * tol - 1.0) < 1e-6
    # different paths to the same center: agreement is at the duality-gap
    # scale (tol * problem scale), not bitwise
    scale = max(np.abs(np.asarray(s2.z)).max(), 1.0)
    assert np.abs(np.asarray(s1.z) - np.asarray(s2.z)).max() < 50 * tol * scale
    # the cheap phase must not cost Newton iterations beyond noise
    its1 = int(np.asarray(s1.SOL_main["its"]).sum())
    its2 = int(np.asarray(s2.SOL_main["its"]).sum())
    assert its1 <= its2 + 12, (its1, its2)


def test_failing_ramp_program_raises(fused, monkeypatch):
    """An error in the fused ramp's dispatch propagates out of mgb_solve:
    no silent resume on the host-stepped loop."""
    from mgbtpu import amg, assemble, fem1d, mgb_solve, subdivide
    from mgbtpu.solver.mgb import ProblemKernels

    def boom(self, *a, **k):
        raise RuntimeError("ramp program failed")

    monkeypatch.setattr(ProblemKernels, "run_ramp", boom)
    prob = assemble(amg(subdivide(fem1d(dtype=np.float64), 1)), p=1.5)
    with pytest.raises(RuntimeError, match="ramp program failed"):
        mgb_solve(prob)


def test_solve_platform_follows_explicit_device():
    """The fused-ramp switch reads the platform the solve runs on:
    ``mgb_solve(device="cpu")`` inside a process whose default backend is
    a GPU still takes the host loop."""
    import jax

    from mgbtpu.solver.mgb import _solve_platform

    assert _solve_platform() == jax.default_backend()
    with jax.default_device(jax.devices("cpu")[0]):
        assert _solve_platform() == "cpu"


def test_float32_refused_on_gpu(monkeypatch):
    """On the GPU the float32 + double-float path misses its accuracy bar:
    assembling (or solving) a float32 problem there raises and names
    float64; float64 problems and host float32 solves are unaffected."""
    from mgbtpu import amg, assemble, fem1d, subdivide
    from mgbtpu.solver import mgb

    mg = amg(subdivide(fem1d(dtype=np.float32), 1))
    assemble(mg, p=1.5, dtype=np.float32)       # the host runs dd
    monkeypatch.setattr(mgb, "_solve_platform", lambda: "gpu")
    with pytest.raises(ValueError, match="float64"):
        assemble(mg, p=1.5, dtype=np.float32)
    assemble(amg(subdivide(fem1d(), 1)), p=1.5)
