"""interpolate + plot smoke/correctness tests (reference runtests model:
interpolate(sol, 0.75) ~ 0.5 for the 1D golden; spectral extrapolation must
work on BOTH sides)."""
import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from mgbtpu import (amg, assemble, fem1d, fem2d_P2, interpolate, mgb_solve,
                    spectral1d, spectral2d)
from mgbtpu.plot import plot


def test_interpolate_fem1d_golden():
    sol = mgb_solve(assemble(amg(fem1d(nodes=np.linspace(-1, 1, 3))), p=1.0))
    v = interpolate(sol.geometry, sol.z[:, 0], 0.75)
    assert abs(v - 0.5) < 1e-6
    assert plot(sol) is not None


def test_interpolate_fem1d_quadratic_exact():
    g = fem1d(nodes=np.linspace(-1, 1, 4), k=2)
    z = g.xflat()[:, 0] ** 2
    ts = np.array([-0.9, -0.3, 0.1, 0.77])
    np.testing.assert_allclose(interpolate(g, z, ts), ts ** 2, atol=1e-12)


def test_spectral_extrapolation_both_sides():
    gs = spectral1d(n=6)
    zq = gs.xflat()[:, 0] ** 2
    left = interpolate(gs, zq, [-1.5])[0]
    right = interpolate(gs, zq, [1.5])[0]
    np.testing.assert_allclose(left, 2.25, atol=1e-10)
    np.testing.assert_allclose(left, right, atol=1e-10)


def test_interpolate_spectral2d():
    g = spectral2d(n=5)
    xf = g.xflat()
    z = xf[:, 0] ** 2 + 2 * xf[:, 1]
    pts = np.array([[0.0, 0.0], [0.5, 0.5], [-0.5, 0.3]])
    np.testing.assert_allclose(interpolate(g, z, pts),
                               pts[:, 0] ** 2 + 2 * pts[:, 1], atol=1e-10)


def test_plot_2d():
    g = fem2d_P2()
    z = g.xflat()[:, 0]
    assert plot(g, z) is not None


def test_checkpoint_roundtrip(tmp_path):
    from mgbtpu.utils.checkpoint import (load_solution, save_solution,
                                         warm_start_grid)
    from mgbtpu import amg, assemble, fem1d, mgb_solve
    import numpy as np

    mg = amg(fem1d(nodes=np.linspace(-1, 1, 3)))
    prob = assemble(mg, p=1.5)
    sol = mgb_solve(prob)
    p = str(tmp_path / "sol.npz")
    save_solution(p, sol)
    back = load_solution(p)
    np.testing.assert_array_equal(back.z, sol.z)
    assert "mgb_solve" in back.log
    # warm start: re-solving from the solution grid is fast and matches
    prob2 = assemble(mg, p=1.5, g_grid=warm_start_grid(sol))
    sol2 = mgb_solve(prob2)
    assert np.abs(sol2.z - sol.z).max() < 1e-5


def test_plot_3d_boundary_shell():
    """Volumetric fem3d solutions render as the boundary surface colored by
    the solution (reference ext/.../plot3d.jl renders the same view via
    PyVista)."""
    from mgbtpu import fem3d

    g = fem3d()
    xf = g.xflat()
    z = xf[:, 0] + xf[:, 1] * xf[:, 2]
    ax = plot(g, z)
    assert ax is not None
    # every rendered triangle got a per-face solution color
    surf = ax.collections[0]
    fc = surf.get_facecolors()
    assert len(fc) > 0 and np.asarray(fc).shape[1] == 4


def test_animation_html():
    from mgbtpu import amg, fem1d, parabolic_solve
    from mgbtpu.plot.plotting import animation_html

    mg = amg(fem1d(nodes=np.linspace(-1, 1, 3)))
    psol = parabolic_solve(mg, h=0.5, t0=0.0, t1=1.0, p=1.0)
    html = animation_html(psol)
    assert isinstance(html, str) and ("<video" in html or "<script" in html)
