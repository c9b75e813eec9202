"""Multi-device sharding dry run on the virtual 8-device CPU mesh."""
import jax
import numpy as np
import pytest


def test_dryrun_multichip_8():
    n = min(8, len(jax.devices()))
    if n < 2:
        pytest.skip("needs multiple devices")
    import __graft_entry__ as ge

    ge.dryrun_multichip(n)


def test_entry_compiles():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    x, y, k, status, cg = out
    assert np.isfinite(float(y))


def test_sharded_solve_matches_unsharded():
    """Full mgb_solve through an 8-device mesh == single-device solution."""
    n = min(8, len(jax.devices()))
    if n < 2:
        pytest.skip("needs multiple devices")
    from mgbtpu import amg, assemble, fem2d_P2, mgb_solve, subdivide
    from mgbtpu.parallel import make_mesh

    g = subdivide(fem2d_P2(), 2)   # 32 elements: divisible by 8
    mg = amg(g)
    prob = assemble(mg, p=1.5)
    z0 = mgb_solve(prob).z
    z1 = mgb_solve(prob, mesh=make_mesh(n)).z
    # sharded reductions reorder sums; with inexact-Newton forcing the
    # direction sequences can differ slightly between meshes, so the match
    # is to ~10x the solver tolerance, not bitwise
    assert np.abs(z0 - z1).max() < 2e-7


def test_sharded_solve_L5_default_config(monkeypatch):
    """L=5 fem2d_P2 through the 8-device mesh with DEFAULT thresholds — the
    nested-dissection direct solver engages (n_J > DENSE_MAX) and the fused
    on-device ramp runs UNDER the mesh (no host loop): the result must match
    the single-device solve. This is the at-scale multi-chip case the toy
    L=2/3 tests don't cover; the ND factors are replicated per device (see
    ``ops/ndchol.nd_memory_report``), only element/node-axis work shards."""
    n = min(8, len(jax.devices()))
    if n < 2:
        pytest.skip("needs multiple devices")
    from mgbtpu import amg, assemble, fem2d_P2, mgb_solve, subdivide
    from mgbtpu.parallel import make_mesh

    monkeypatch.setenv("MGBTPU_FUSED_RAMP", "1")   # CPU defaults it off
    g = subdivide(fem2d_P2(), 5)
    mg = amg(g)
    prob = assemble(mg, p=1.0)
    z0 = mgb_solve(prob).z
    z1 = mgb_solve(prob, mesh=make_mesh(n)).z
    # measured gap 3.9e-14 (f64; same ramp program, sharded reductions
    # reorder sums); bar at ~100x that margin but well below solver tol
    assert np.abs(z0 - z1).max() < 5e-12


def test_sharded_pcg_path_matches(monkeypatch):
    """The PCG/GramHessian path (the dominant one at scale) under the
    8-device mesh must reproduce the single-device solution closely:
    DENSE_MAX is forced down so the V-cycle-preconditioned CG engages at a
    shardable size; GSPMD inserts the collectives for the element-axis
    einsums and segment-sum scatters."""
    n = min(8, len(jax.devices()))
    if n < 2:
        pytest.skip("needs multiple devices")
    from mgbtpu import amg, assemble, fem2d_P2, mgb_solve, subdivide
    from mgbtpu.parallel import make_mesh
    from mgbtpu.solver import mgb as M
    from mgbtpu.solver.mgb import _kernels_for
    from mgbtpu.solver.newton import linesearch_backtracking

    monkeypatch.setattr(M.ProblemKernels, "DENSE_MAX", 50)
    monkeypatch.setattr(M.ProblemKernels, "DENSE_BASE", 40)
    g = subdivide(fem2d_P2(), 3)   # 128 elements: shards over 8 devices
    mg = amg(g)
    prob = assemble(mg, p=2.0)
    kern = _kernels_for(prob.M[0], prob.Q.barrier, linesearch_backtracking(),
                        np.float64)
    assert kern.ops(prob.M[0].depth - 1).pcg_ctx is not None
    z0 = mgb_solve(prob).z
    z1 = mgb_solve(prob, mesh=make_mesh(n)).z
    # Sharded reductions reorder sums, which perturbs preconditioner values
    # and line-search sequences; the two runs follow slightly different
    # central-path approaches, so their solutions agree only to a multiple
    # of the duality-gap tolerance (tol = sqrt(eps) ~ 1.5e-8), not bitwise.
    # Measured gap 3.1e-7 (~20x tol) across forcing settings and
    # preconditioners; the bar is ~2x that margin.
    assert np.abs(z0 - z1).max() < 6e-7


def test_fine_pcg_matvec_collectives():
    """Pin the GSPMD collective contract of the sharded Hessian matvec:
    element-sharded compute + ONE all-reduce (the segment-sum assembly),
    and no all-gather anywhere — in particular nothing materializes an
    (n_J, n_J)-sized dense object on the fine level. This is the
    equivalent of the reference's row-partitioned matvec-only MPI contract
    (src/mgb.jl:393-403): O(n_J) bytes of collectives per matvec."""
    import re
    from collections import Counter

    n = min(8, len(jax.devices()))
    if n < 2:
        pytest.skip("needs multiple devices")
    import jax.numpy as jnp

    from mgbtpu import amg, assemble, fem2d_P2, subdivide
    from mgbtpu.parallel import make_mesh
    from mgbtpu.parallel.sharding import shard_fargs
    from mgbtpu.solver import mgb as M
    from mgbtpu.solver.levelops import gram_matvec, y_matvec_rel
    from mgbtpu.solver.mgb import _kernels_for
    from mgbtpu.solver.newton import linesearch_backtracking
    from mgbtpu.ops.ddarray import DD

    monkeypatch_ctx = pytest.MonkeyPatch()
    monkeypatch_ctx.setattr(M.ProblemKernels, "DENSE_MAX", 50)
    monkeypatch_ctx.setattr(M.ProblemKernels, "DENSE_BASE", 40)
    try:
        prob = assemble(amg(subdivide(fem2d_P2(dtype=np.float32), 3)),
                        p=1.0, dtype=np.float32)
        mesh = make_mesh(n)
        kern = _kernels_for(prob.M[0], prob.Q.barrier,
                            linesearch_backtracking(), np.float32, mesh=mesh)
        l = prob.M[0].depth - 1
        ops = kern.ops(l)
        assert ops.pcg_ctx is not None
        (ops_sh,) = shard_fargs(mesh, (ops,), ops.n_nodes, ops.N)
        sh_nodes = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("nodes"))
        Ln = jax.device_put(
            jnp.ones((ops.n_nodes, ops.nD, ops.nD), jnp.float32), sh_nodes)
        v = jnp.ones((ops.n_J,), jnp.float32)

        def collectives(comp):
            txt = comp.as_text()
            names = re.findall(
                r"(all-reduce|all-gather|reduce-scatter|all-to-all)", txt)
            return Counter(names), txt

        comp = jax.jit(gram_matvec).lower(ops_sh, Ln, v).compile()
        c, txt = collectives(comp)
        assert c.get("all-gather", 0) == 0, c
        assert c.get("all-reduce", 0) >= 1
        assert f"f32[{ops.n_J},{ops.n_J}]" not in txt

        Ydd = DD(jax.device_put(
            jnp.ones((ops.n_nodes, ops.nD, ops.nD), jnp.float32), sh_nodes))
        comp2 = jax.jit(y_matvec_rel).lower(ops_sh, Ydd, v).compile()
        c2, txt2 = collectives(comp2)
        assert c2.get("all-gather", 0) == 0, c2
        assert f"f32[{ops.n_J},{ops.n_J}]" not in txt2
    finally:
        monkeypatch_ctx.undo()


def test_four_device_rehearsal():
    """chip_smoke.py --four's phase on four virtual CPU devices: the ND
    direct path (L=4 tops DENSE_MAX) sharded over a 4-device mesh matches
    the one-device solve."""
    if len(jax.devices()) < 4:
        pytest.skip("needs four devices")
    import chip_smoke

    dz, peaks = chip_smoke.phase_four(L=4, n=4)
    assert dz <= chip_smoke.AGREE_BAR
    assert len(peaks) == 4
