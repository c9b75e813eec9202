"""Nested-dissection multifrontal Cholesky (ops/ndchol.py).

Correctness against dense oracles on synthetic FEM meshes, and the
deep-t level-independence the BASELINE asks for: with a direct-grade
fine-level factorization the Newton-solve CG counts stay bounded across
levels at barrier parameters where every smoother+coarse-space
combination collapses (the measured t~178 L=6 stall)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mgbtpu.ops.ndchol import (NDPlan, NDDevicePlan, nd_factor, nd_solve,
                               nd_factor_ref, nd_solve_ref, _assemble_dense)


def _grid_case(nx, ny, seed=0):
    rng = np.random.default_rng(seed)
    elems = []
    for i in range(nx):
        for j in range(ny):
            a = i * (ny + 1) + j
            b = (i + 1) * (ny + 1) + j
            elems.append([a, b, a + 1])
            elems.append([b, b + 1, a + 1])
    t = np.array(elems)
    xy = np.stack([(t // (ny + 1)).mean(axis=1),
                   (t % (ny + 1)).mean(axis=1)], axis=1)
    He = np.zeros((len(t), 3, 3))
    for e in range(len(t)):
        B = rng.standard_normal((5, 3))
        He[e] = B.T @ B + 0.1 * np.eye(3)
    return t, (nx + 1) * (ny + 1), xy, He


@pytest.mark.parametrize("nx,ny,leaf", [(4, 4, 2), (13, 7, 3), (20, 20, 6)])
def test_nd_matches_dense_oracle(nx, ny, leaf):
    cols, n, xy, He = _grid_case(nx, ny)
    plan = NDPlan(cols, n, xy, leaf_elems=leaf)
    dp = NDDevicePlan(plan).to_device()
    rng = np.random.default_rng(1)
    rhs = rng.standard_normal(n)
    fact = nd_factor(dp, jnp.asarray(He), 1e-12)
    x = np.asarray(nd_solve(dp, fact, jnp.asarray(rhs)))
    x0 = np.linalg.solve(_assemble_dense(plan, He, 1e-12), rhs)
    assert np.abs(x - x0).max() <= 1e-10 * np.abs(x0).max()
    # reference (pure numpy) implementation agrees too
    f_ref = nd_factor_ref(plan, He, jitter=1e-12)
    x_ref = nd_solve_ref(plan, f_ref, rhs)
    assert np.abs(x_ref - x0).max() <= 1e-10 * np.abs(x0).max()


def test_nd_under_jit_as_argument():
    """The device plan is a pytree: passes through jit as an ARGUMENT (no
    multi-GB captured constants)."""
    cols, n, xy, He = _grid_case(8, 8)
    dp = NDDevicePlan(NDPlan(cols, n, xy, leaf_elems=4)).to_device()
    rng = np.random.default_rng(2)
    rhs = jnp.asarray(rng.standard_normal(n))

    @jax.jit
    def solve(dp, He, rhs):
        fact = nd_factor(dp, He, 1e-12)
        return nd_solve(dp, fact, rhs)

    x = np.asarray(solve(dp, jnp.asarray(He), rhs))
    from mgbtpu.ops.ndchol import NDPlan as P
    x0 = np.linalg.solve(
        _assemble_dense(NDPlan(cols, n, xy, leaf_elems=4), He, 1e-12),
        np.asarray(rhs))
    assert np.abs(x - x0).max() <= 1e-10 * np.abs(x0).max()


def test_newton_cg_counts_bounded_deep_t(monkeypatch):
    """Fine-level Newton solves at t = 1e6 (the deep-t regime where the
    V-cycle preconditioner collapses — equilibrated near-null cluster, see
    ops/ndchol.py): with the nested-dissection direct factors the inner CG
    counts stay small and level-independent."""
    from mgbtpu import amg, assemble, fem2d_P2, subdivide
    from mgbtpu.solver import mgb as M
    from mgbtpu.solver.mgb import _kernels_for, barrier_weights
    from mgbtpu.solver.newton import linesearch_backtracking

    monkeypatch.setattr(M.ProblemKernels, "DENSE_MAX", 50)
    monkeypatch.setattr(M.ProblemKernels, "DENSE_BASE", 40)
    counts = {}
    for L in (2, 3, 4):
        prob = assemble(amg(subdivide(fem2d_P2(), L)), p=2.0)
        M1, _ = prob.M
        kern = _kernels_for(M1, prob.Q.barrier, linesearch_backtracking(),
                            np.float64)
        l = M1.depth - 1
        ops = kern.ops(l)
        assert ops.pcg_ctx is not None and ops.pcg_ctx.nd is not None
        w = M1.w.astype(np.float64)
        bw = barrier_weights(w, None)
        # Newton iterations at t=1e6 from the p=2 interior start (feasible
        # at any t; the START is far from the center, so the run is damped-
        # phase Newton — full centering is not the point, the per-iteration
        # CG cost with the direct-factor preconditioner is)
        wc = (w[:, None] * (1e6 * prob.f_grid)).astype(np.float64)
        z = np.asarray(prob.g_grid, np.float64).T.reshape(-1)
        x, y, k, status, cg = kern.run_newton(
            l, z, wc, bw, tuple(prob.Q.args), maxit=20,
            stopping=("inexact", 0.9, 0.25 / np.sqrt(len(w))))
        assert np.all(np.isfinite(x)), (L, status)
        assert k > 0
        counts[L] = cg / k
    ks = list(counts.values())
    assert max(ks) <= 3 * max(min(ks), 1) + 20, counts
    assert max(ks) < 60, counts


def test_nd_dd_factor_is_direct_grade():
    """dd factorization solves to far beyond f32-factor accuracy: rel err
    ~ eps_dd * kappa, not eps_f32 * kappa (the late-ramp CG explosion was
    the f32 factor's 2-eps shift swamping lambda_min ~ 1/t)."""
    from mgbtpu.ops.ndchol import nd_factor_dd, nd_solve_dd

    cols, n, xy, He = _grid_case(13, 7, seed=5)
    plan = NDPlan(cols, n, xy, leaf_elems=3)
    dp = NDDevicePlan(plan).to_device()
    rng = np.random.default_rng(3)
    rhs = rng.standard_normal(n)
    Heh = jnp.asarray(He, jnp.float32)
    Hel = jnp.asarray(He - np.asarray(Heh, np.float64), jnp.float32)
    fact = nd_factor_dd(dp, Heh, Hel, 2.0 ** -46)
    xh, xl = nd_solve_dd(dp, fact, jnp.asarray(rhs, jnp.float32),
                         jnp.asarray(rhs - np.asarray(
                             jnp.asarray(rhs, jnp.float32), np.float64),
                             jnp.float32))
    x = np.asarray(xh, np.float64) + np.asarray(xl, np.float64)
    x0 = np.linalg.solve(_assemble_dense(plan, He, 0.0), rhs)
    rel = np.abs(x - x0).max() / np.abs(x0).max()
    assert rel <= 1e-8, rel    # f32-grade factors land at ~1e-4 here


def test_nd_dd_duplicate_padded_columns():
    """``cols`` pads by repeating the last real column; the real panel data
    sits on the FIRST occurrence. The gather-form dd leaf assembly must
    keep that slot — keeping a pad slot instead silently drops the
    element's contribution at that dof (measured in production as a fake
    null direction with 1/shift = 7e13 preconditioner amplification)."""
    from mgbtpu.ops.ndchol import nd_factor_dd, nd_solve_dd

    cols, n, xy, He = _grid_case(6, 6, seed=7)
    N = len(cols)
    # pad every element to C=5 by repeating its last column; zero blocks on
    # pad slots (production layout: duplicate slots carry zero panels)
    cols5 = np.concatenate([cols, cols[:, 2:3], cols[:, 2:3]], axis=1)
    He5 = np.zeros((N, 5, 5))
    He5[:, :3, :3] = He
    plan = NDPlan(cols5, n, xy, leaf_elems=3)
    dp = NDDevicePlan(plan).to_device()
    rng = np.random.default_rng(8)
    rhs = rng.standard_normal(n)
    fact = nd_factor_dd(dp, jnp.asarray(He5, jnp.float32),
                        jnp.zeros((N, 5, 5), jnp.float32), 2.0 ** -40)
    xh, xl = nd_solve_dd(dp, fact, jnp.asarray(rhs, jnp.float32))
    x = np.asarray(xh, np.float64) + np.asarray(xl, np.float64)
    x0 = np.linalg.solve(_assemble_dense(plan, He5, 0.0), rhs)
    rel = np.abs(x - x0).max() / np.abs(x0).max()
    assert rel <= 1e-5, rel    # dropping dup contributions gives O(1) error


def test_nd_memory_report():
    """The analytic memory model counts exactly the arrays nd_factor_dd
    materializes; it is the capacity planner for the 1M-DOF target and the
    replicated-factor multi-chip story (each device holds the full factor)."""
    from mgbtpu.ops.ndchol import nd_factor_dd, nd_memory_report

    cols, n, xy, He = _grid_case(8, 8, seed=3)
    plan = NDPlan(cols, n, xy, leaf_elems=4)
    dph = NDDevicePlan(plan)
    dp = dph.to_device()
    rep = nd_memory_report(dp)
    assert rep == nd_memory_report(dph)   # both plan flavors agree
    fact = nd_factor_dd(dp, jnp.asarray(He, jnp.float32),
                        jnp.zeros_like(jnp.asarray(He, jnp.float32)),
                        2.0 ** -40)
    measured = sum(int(np.prod(a.shape)) * 4
                   for (Lh, Ll), (Uh, Ul) in fact
                   for a in (Lh, Ll, Uh, Ul))
    assert measured == rep["factor_dd_bytes"]
    assert rep["peak_dd_bytes"] > rep["factor_dd_bytes"]


def test_nd_dd_large_fronts_ozaki_path():
    """Fronts wide enough to cross OZAKI_MIN_INNER: the Schur SYRK runs
    through the split-GEMM path (ops/ozaki.py) and the factorization must
    keep its dd-grade accuracy (bar matches the small-front dd cases)."""
    from mgbtpu.ops.ndchol import nd_factor_dd, nd_solve_dd
    from mgbtpu.ops.ozaki import OZAKI_MIN_INNER

    cols, n, xy, He = _grid_case(40, 40, seed=11)
    plan = NDPlan(cols, n, xy, leaf_elems=128)
    dph = NDDevicePlan(plan)
    assert max(L["amax"] for L in dph.levels) >= OZAKI_MIN_INNER
    dp = dph.to_device()
    rng = np.random.default_rng(12)
    rhs = rng.standard_normal(n)
    fact = nd_factor_dd(dp, jnp.asarray(He, jnp.float32),
                        jnp.zeros((len(cols), 3, 3), jnp.float32), 2.0 ** -40)
    xh, xl = nd_solve_dd(dp, fact, jnp.asarray(rhs, jnp.float32))
    x = np.asarray(xh, np.float64) + np.asarray(xl, np.float64)
    x0 = np.linalg.solve(_assemble_dense(plan, He, 0.0), rhs)
    rel = np.abs(x - x0).max() / np.abs(x0).max()
    assert rel <= 1e-7, rel


def test_panel_slots_beyond_int32_keys():
    """Regression: scipy COO indices are int32, and NEP-50 weak promotion
    kept the _vector_slots key product in int32 — elements past
    2^31/(n_J+2) got garbage slots and their panel data silently vanished
    (first hit in production: fem2d_P1 L=8, 38% of dofs lost their Hessian
    rows and every solve at L>=8 stalled). Build a panel plan whose
    element-key products exceed 2^31 and check no data is dropped."""
    import scipy.sparse as sp
    from mgbtpu.ops.blockdiag import BlockDiagHost
    from mgbtpu.solver.levelops import build_panel_ops

    N, n_J = 40000, 60000          # N * (n_J + 2) = 2.4e9 > 2^31
    p, nu = 1, 1
    rng = np.random.default_rng(0)
    op = BlockDiagHost(np.ones((N, 1, 1)))
    rows = np.arange(N, dtype=np.int64)
    cols_r = (rows * 7919) % n_J   # scatter columns across the range
    vals = rng.uniform(1.0, 2.0, N)
    R = sp.csr_matrix((vals, (rows, cols_r)), shape=(N, n_J))
    ops = build_panel_ops([(op, 0)], nu, R, p, np.float64)
    # every element's single coefficient must survive into its panel slot
    P = np.asarray(ops.panels)[0, :, 0, :]        # (N, C)
    colsd = np.asarray(ops.cols)
    got = np.zeros(n_J)
    np.add.at(got, colsd.reshape(-1), P.reshape(-1))
    want = np.zeros(n_J)
    np.add.at(want, cols_r, vals)
    assert np.abs(got - want).max() < 1e-12


def test_pform_tri_solve_matches_substitution():
    """Partitioned-inverse (P-form) triangular apply is substitution-grade
    on an ill-conditioned factor, where the FULL explicit inverse's apply
    is not (measured kappa=1e10 probe: subst 2.4e-5, P-form 2.1e-4, full
    inverse 3.8e-3 in |I - M A|; the full-inverse damage showed up as a
    127 -> 1907 ramp-CG blow-up at fem2d_P2 L=6). Pins the left-solve
    (the nd_solve_dd path) to agree with rolled substitution, and the
    full P-chain to beat the full-inverse chain by >= 4x."""
    from mgbtpu.ops import df64
    from mgbtpu.ops import ddlinalg as ddl

    rng = np.random.default_rng(0)
    n = 96
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    ev = np.logspace(-10, 0, n)
    A = 0.5 * ((Q * ev) @ Q.T + ((Q * ev) @ Q.T).T)
    Ah, Al = df64.f64_split(A[None], dtype=np.float32)
    Ah, Al = jnp.asarray(Ah), jnp.asarray(Al)
    L = ddl.dd_cholesky(Ah, Al)
    P = ddl.dd_tri_pinv(L[0], L[1])

    def chain_err(apply_inv):
        I3 = jnp.broadcast_to(jnp.eye(n, dtype=jnp.float32), (1, n, n))
        if apply_inv:
            Li = ddl.dd_tri_inverse(L[0], L[1])
            Z = (jnp.swapaxes(Li[0], 1, 2), jnp.swapaxes(Li[1], 1, 2))
            Y = ddl.dd_matmul_nt_any(Z, Z)
        else:
            Z = ddl.dd_tri_solve_right_pinv(P[0], P[1], I3,
                                            jnp.zeros_like(I3))
            Y = ddl.dd_matmul_nt_any(Z, Z)
        M = np.asarray(Y[0], np.float64) + np.asarray(Y[1], np.float64)
        return np.linalg.norm(np.eye(n) - M[0] @ A, 2)

    assert chain_err(False) * 4 < chain_err(True)

    # left-solve (fwd + transpose) equals rolled substitution to ~eps_dd
    b = rng.standard_normal(n).astype(np.float32)
    bh, bl = jnp.asarray(b[None]), jnp.zeros((1, n), jnp.float32)
    yp = ddl.dd_tri_solve_left_pinv(P[0], P[1], bh, bl)
    xp = ddl.dd_tri_solve_left_pinv(P[0], P[1], yp[0], yp[1],
                                    transpose=True)
    ys = ddl.dd_tri_solve_left(L[0], L[1], bh, bl)
    xs = ddl.dd_tri_solve_left(L[0], L[1], ys[0], ys[1], transpose=True)
    xpd = np.asarray(xp[0], np.float64)[0] + np.asarray(xp[1], np.float64)[0]
    xsd = np.asarray(xs[0], np.float64)[0] + np.asarray(xs[1], np.float64)[0]
    x_ref = np.linalg.solve(A, b.astype(np.float64))
    rel = np.linalg.norm(x_ref)
    assert np.linalg.norm(xpd - x_ref) < 3e-6 * rel
    assert np.linalg.norm(xpd - xsd) < 1e-6 * rel


def test_dd_cholesky_pform_matches_pinv_of_cholesky():
    """dd_cholesky_pform (the always-refresh factor's fused P-form path)
    must match dd_tri_pinv(dd_cholesky(A)) to the dd floor. The pform is
    ROLLED (one fori_loop panel step, masked full-width trailing updates —
    O(1) program size; the unrolled recursion put one ~3k-op panel block
    per _BLOCK columns into every Newton/ramp program), so it is no longer
    bitwise equal:
    the masked Ozaki GEMMs see padded operands whose slice decomposition
    can differ at the last compensation bit. Equality bar: eps_dd-grade
    relative, plus a direct solve-quality check against f64."""
    from mgbtpu.ops import ddlinalg as ddl
    from mgbtpu.ops import df64

    rng = np.random.default_rng(7)
    for n in (17, 32, 96):       # sub-panel, exact panel, multi-panel
        X = rng.standard_normal((2, n, n + 3))
        A = X @ np.swapaxes(X, 1, 2) + 0.1 * np.eye(n)
        Ah, Al = df64.f64_split(A, dtype=np.float32)
        Ah, Al = jnp.asarray(Ah), jnp.asarray(Al)
        L = ddl.dd_cholesky(Ah, Al)
        P_ref = ddl.dd_tri_pinv(L[0], L[1])
        P = jax.jit(ddl.dd_cholesky_pform)(Ah, Al)
        ref = np.asarray(P_ref[0], np.float64) + np.asarray(P_ref[1],
                                                            np.float64)
        got = np.asarray(P[0], np.float64) + np.asarray(P[1], np.float64)
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() < 1e-12 * scale, n
        # solve quality vs f64 oracle through the pinv substitutions
        b = rng.standard_normal((2, n)).astype(np.float32)
        bh, bl = jnp.asarray(b), jnp.zeros_like(jnp.asarray(b))
        y = ddl.dd_tri_solve_left_pinv(P[0], P[1], bh, bl)
        x = ddl.dd_tri_solve_left_pinv(P[0], P[1], y[0], y[1],
                                       transpose=True)
        xd = np.asarray(x[0], np.float64) + np.asarray(x[1], np.float64)
        x_ref = np.linalg.solve(A, b.astype(np.float64)[..., None])[..., 0]
        assert np.abs(xd - x_ref).max() < 1e-6 * np.abs(x_ref).max(), n


def test_dd_panel_ir_mode_solve_quality(monkeypatch):
    """MGBTPU_DD_PANEL=ir (f32-seeded Newton-IR panel factor, all GEMMs)
    must deliver the same solve quality as the rolled panel loop for
    panels within its kappa range (~2^21), including genuinely
    ill-conditioned multi-panel matrices (kappa ~ 1e6)."""
    from mgbtpu.ops import ddlinalg as ddl
    from mgbtpu.ops import df64

    monkeypatch.setattr(ddl, "PANEL_MODE", "ir")
    rng = np.random.default_rng(11)
    for n, cond in ((32, 1e4), (96, 1e6)):
        Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
        lam = np.geomspace(1.0, 1.0 / cond, n)
        A = (Q * lam) @ Q.T
        A = np.broadcast_to(A, (2, n, n)).copy()
        Ah, Al = df64.f64_split(A, dtype=np.float32)
        Ah, Al = jnp.asarray(Ah), jnp.asarray(Al)
        P = jax.jit(ddl.dd_cholesky_pform)(Ah, Al)
        b = rng.standard_normal((2, n)).astype(np.float32)
        bh, bl = jnp.asarray(b), jnp.zeros_like(jnp.asarray(b))
        y = ddl.dd_tri_solve_left_pinv(P[0], P[1], bh, bl)
        x = ddl.dd_tri_solve_left_pinv(P[0], P[1], y[0], y[1],
                                       transpose=True)
        xd = np.asarray(x[0], np.float64) + np.asarray(x[1], np.float64)
        x_ref = np.linalg.solve(A, b.astype(np.float64)[..., None])[..., 0]
        # backward-stable direct-solve bar: kappa * eps_dd-grade
        assert np.abs(xd - x_ref).max() < cond * 3e-13 * np.abs(x_ref).max(), n


def test_ozaki_bits_35_syrk_accuracy():
    """Reduced-slice Ozaki GEMMs (MGBTPU_OZAKI_BITS target) must hold the
    advertised ~2^-bits relative accuracy — the knob trades factor
    precision for quadratically fewer matmuls."""
    from mgbtpu.ops import df64, ozaki

    rng = np.random.default_rng(3)
    A = rng.standard_normal((2, 48, 64)) * np.exp(
        rng.uniform(-8, 8, (2, 48, 1)))
    C = rng.standard_normal((2, 48, 48))
    Ah, Al = map(jnp.asarray, df64.f64_split(A, dtype=np.float32))
    Ch, Cl = map(jnp.asarray, df64.f64_split(C, dtype=np.float32))
    ref = C - A @ np.swapaxes(A, 1, 2)
    for bits, tol in ((49, 2e-14), (35, 2e-10)):
        old = ozaki._TARGET_BITS
        ozaki._TARGET_BITS = bits
        try:
            oh, ol = ozaki.dd_syrk_ozaki((Ch, Cl), (Ah, Al))
        finally:
            ozaki._TARGET_BITS = old
        got = np.asarray(oh, np.float64) + np.asarray(ol, np.float64)
        scale = np.abs(A @ np.swapaxes(A, 1, 2)).max()
        assert np.abs(got - ref).max() < tol * scale, bits


def test_nd_factor_subtree_sharding():
    """Multi-chip factor distribution (subtree-per-device): under a mesh
    the per-device bytes of every mesh-divisible tree level's factor
    blocks drop to total/n_devices (contiguous subtree ordering keeps
    children with their parent shard); only the top nk < n_devices fronts
    replicate. Solutions match the unsharded factorization exactly.

    Reference row-partition contract: /root/reference/src/mgb.jl:393-403
    (the reference ships the hooks; the factors there live rank-local in
    the out-of-tree MPI backend — here the mesh shards them natively)."""
    n_dev = min(8, len(jax.devices()))
    if n_dev < 2:
        pytest.skip("needs multiple devices")
    from mgbtpu.parallel.sharding import make_mesh

    cols, n, xy, He = _grid_case(20, 20, seed=3)
    plan = NDPlan(cols, n, xy, leaf_elems=6)
    mesh = make_mesh(n_dev)
    dp = NDDevicePlan(plan).to_device(mesh=mesh)
    rng = np.random.default_rng(7)
    rhs = jnp.asarray(rng.standard_normal(n))
    fact = jax.jit(nd_factor, static_argnames=())(
        dp, jnp.asarray(He), 1e-12)
    x = np.asarray(nd_solve(dp, fact, rhs))
    x0 = np.linalg.solve(_assemble_dense(plan, He, 1e-12), np.asarray(rhs))
    assert np.abs(x - x0).max() <= 1e-10 * np.abs(x0).max()

    total = shard_max = 0
    saw_sharded = False
    for (Lf, U), L in zip(fact, dp.levels):
        for a in (Lf, U):
            total += a.nbytes
            per_dev = int(np.prod(a.sharding.shard_shape(a.shape))
                          ) * a.dtype.itemsize
            shard_max += per_dev
            if L.nk % n_dev == 0 and L.nk >= n_dev:
                # mesh-divisible level: must actually shard 1/n per device
                assert per_dev * n_dev == a.nbytes, (L.nk, a.shape)
                saw_sharded = True
    assert saw_sharded
    # the replicated top-of-tree is a small fraction: per-device footprint
    # must be well under half of the full factor for an 8-device mesh
    assert shard_max < 0.55 * total, (shard_max, total)
