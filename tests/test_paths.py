"""Cross-discretization solver paths: pure P2, 3D, mixed BC, prolongator
independence (reference test_algebraic.jl / test_pure_p2.jl / test_mesh3d.jl
/ test_mixed_bc.jl models)."""
import numpy as np
import pytest

from mgbtpu import (amg, amg_ruge_stuben, amg_smoothed_aggregation, assemble,
                    fem1d, fem2d_P1, fem2d_P2, fem3d, find_boundary,
                    mgb_solve, subdivide)


def test_pure_p2_zero_corner_weights_and_slack():
    g = fem2d_P2(bubble=False)
    assert (g.w == 0).sum() == 6        # corner weights exactly zero
    assert g.discretization.default_slack_space() == "broken_P1"
    sol = mgb_solve(assemble(amg(g), p=1.0), tol=1e-6)
    assert np.all(np.isfinite(sol.z))


def test_bubble_vs_pure_p2_consistent():
    # same continuous problem, two element variants: u solutions close
    gb = subdivide(fem2d_P2(bubble=True), 2)
    gp = subdivide(fem2d_P2(bubble=False), 2)
    zb = mgb_solve(assemble(amg(gb), p=2.0)).z
    zp = mgb_solve(assemble(amg(gp), p=2.0)).z
    assert np.isfinite(zb).all() and np.isfinite(zp).all()
    # compare u at the shared corner/edge nodes (the first 6 broken nodes of
    # each element coincide between the 7-node bubble and 6-node pure layouts)
    ub = zb[:, 0].reshape(-1, 7)[:, :6]
    up = zp[:, 0].reshape(-1, 6)
    xb = gb.xflat().reshape(-1, 7, 2)[:, :6]
    xp = gp.xflat().reshape(-1, 6, 2)
    assert np.abs(xb - xp).max() < 1e-12   # same nodes, same order
    # the u spaces differ by the cubic bubble: agreement to discretization err
    assert np.abs(ub - up).max() < 2e-2


def test_fem3d_solve():
    g3 = subdivide(fem3d(k=1), 2)
    sol = mgb_solve(assemble(amg(g3), p=1.5), tol=1e-6)
    assert np.all(np.isfinite(sol.z))


def test_fem2d_P1_solve():
    g = subdivide(fem2d_P1(), 3)
    sol = mgb_solve(assemble(amg(g), p=1.0), tol=1e-6)
    assert np.all(np.isfinite(sol.z))


def test_structured_blockdiag_operators():
    # every FEM geometry carries BlockDiag operators (the batched layout) and
    # to_sparse/extract round-trips (reference runtests.jl:59-76)
    from mgbtpu.ops import BlockDiagHost, extract_block_diag

    for g in (fem1d(nodes=np.linspace(-1, 1, 3)), fem2d_P1(), fem2d_P2(),
              fem3d(k=1)):
        for key, op in g.operators.items():
            assert isinstance(op, BlockDiagHost)
            sp = op.to_sparse()
            bd = extract_block_diag(sp, op.data.shape[1], op.data.shape[2])
            assert np.abs(bd.data - op.data).max() < 1e-12


def test_mixed_bc_changes_solution():
    g = fem1d(nodes=np.linspace(-1, 1, 5))
    pairs = find_boundary(g)
    xf = g.xflat()
    left = [p for p in pairs if xf[p[1] * 2 + p[0], 0] < 0]
    mg_full = amg(g)
    mg_left = amg(g, dirichlet_nodes={"dleft": left})
    z_full = mgb_solve(assemble(mg_full, p=2.0), tol=1e-6).z
    z_left = mgb_solve(assemble(
        mg_left, state_variables=[("u", "dleft"), ("s", "full")], p=2.0),
        tol=1e-6).z
    # with only the left end clamped the right-end value departs from g
    assert abs(z_full[-1, 0] - 1.0) < 1e-4    # dirichlet lift g(1) = 1
    assert abs(z_left[-1, 0] - 1.0) > 1e-2


def test_prolongator_independence():
    g = subdivide(fem2d_P2(), 2)
    z_rs = mgb_solve(assemble(
        amg(g, prolongator=amg_ruge_stuben(max_coarse=2)), p=1.5)).z
    z_sa = mgb_solve(assemble(
        amg(g, prolongator=amg_smoothed_aggregation(max_coarse=2)), p=1.5)).z
    assert np.abs(z_rs - z_sa).max() < 1e-6


def test_illinois_line_search():
    from mgbtpu import linesearch_illinois, mgb_solve as solve

    gold = np.array([[-1, 0], [-1, 0], [-1, 2], [1, 2.0]])
    sol = solve(assemble(amg(fem1d(nodes=np.linspace(-1, 1, 3))), p=1.0),
                line_search=linesearch_illinois())
    assert np.linalg.norm(sol.z - gold) < 1e-6


def test_slit_domain_connectivity():
    """Coincident-but-distinct nodes (slit) stay topologically separate when
    t is supplied (reference test_connectivity.jl model)."""
    from mgbtpu import tensor_dofmap

    # two 1D elements sharing the point x=0 -- glued vs slit
    K = np.empty((2, 2, 1))
    K[:, 0, 0] = [-1.0, 0.0]
    K[:, 1, 0] = [0.0, 1.0]
    g_glued = fem1d(K=K)
    assert g_glued.t.max() + 1 == 3        # dedup glues the middle node
    t_slit = np.array([[0, 2], [1, 3]])
    g_slit = fem1d(K=K, t=t_slit)
    assert g_slit.t.max() + 1 == 4         # slit keeps 4 distinct nodes
    # glued solve is continuous at 0; slit solve decouples the elements
    from mgbtpu import amg, assemble, mgb_solve

    def solve(g):
        mg = amg(g)
        return mgb_solve(assemble(mg, p=2.0), tol=1e-6).z[:, 0]

    zg = solve(g_glued)
    zs = solve(g_slit)
    assert abs(zg[1] - zg[2]) < 1e-6       # same node value (glued)
    assert np.isfinite(zs).all()


def test_pyamg_prolongator_adapter(monkeypatch):
    """The pyamg-backed prolongator adapter (hierarchy/prolongators.py
    amg_pyamg): solver-name dispatch, csr conversion, and per-level P
    extraction — driven end-to-end through amg()/mgb_solve with a stub
    pyamg module whose rootnode_solver wraps the in-tree smoothed-
    aggregation coarsening (pyamg itself is not in this image; the real-
    pyamg agreement case below engages wherever it imports). Mirrors the
    reference's cross-prolongator agreement design
    (/root/reference/test/test_algebraic.jl:1-76)."""
    import sys
    import types

    import scipy.sparse as sp

    from mgbtpu.hierarchy.prolongators import (amg_pyamg,
                                               amg_smoothed_aggregation)

    sa = amg_smoothed_aggregation(max_coarse=2)
    calls = {}

    def rootnode_solver(K, **kwargs):
        calls["K"] = K
        levels = []
        for P in sa(sp.csr_matrix(K)):
            lvl = types.SimpleNamespace(P=sp.csr_matrix(P))
            levels.append(lvl)
        levels.append(types.SimpleNamespace(P=None))   # coarsest level
        return types.SimpleNamespace(levels=levels)

    fake = types.ModuleType("pyamg")
    fake.rootnode_solver = rootnode_solver
    fake.smoothed_aggregation_solver = rootnode_solver
    fake.ruge_stuben_solver = rootnode_solver
    monkeypatch.setitem(sys.modules, "pyamg", fake)

    g = subdivide(fem2d_P2(), 2)
    z_py = mgb_solve(assemble(
        amg(g, prolongator=amg_pyamg(solver="rootnode")), p=1.5)).z
    z_sa = mgb_solve(assemble(
        amg(g, prolongator=amg_smoothed_aggregation(max_coarse=2)), p=1.5)).z
    assert sp.issparse(calls["K"])
    assert np.abs(z_py - z_sa).max() < 1e-6


def test_pyamg_prolongator_real():
    """Real-pyamg agreement (runs wherever pyamg is installed): rootnode
    prolongators solve the same p-Laplacian to the same solution as the
    in-tree Ruge-Stuben coarsening (reference cross-prolongator contract,
    /root/reference/ext/MultiGridBarrierPyAMGExt.jl:27-49)."""
    pytest.importorskip("pyamg")
    from mgbtpu.hierarchy.prolongators import amg_pyamg

    g = subdivide(fem2d_P2(), 2)
    z_py = mgb_solve(assemble(
        amg(g, prolongator=amg_pyamg(solver="rootnode")), p=1.5)).z
    z_rs = mgb_solve(assemble(
        amg(g, prolongator=amg_ruge_stuben(max_coarse=2)), p=1.5)).z
    assert np.abs(z_py - z_rs).max() < 1e-6
