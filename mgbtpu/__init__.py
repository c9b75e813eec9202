"""mgbtpu — multigrid barrier framework in JAX.

A from-scratch JAX/XLA implementation of quasi-optimal interior-point
solvers for convex variational problems in function spaces (p-Laplacian for
p in [1, inf], total-variation denoising, obstacle problems, minimal
surfaces, power-law elasticity, and parabolic variants), with the capability
surface of sloisel/MultiGridBarrier.jl: broken FEM operators as batched
dense blocks, hierarchy transfers as static gather/segment-sum plans,
barrier functionals as vmapped pure per-node functions, damped Newton and
the t-ramp as jitted lax.while_loops in float64 on the GPU or the CPU, and
node/element axes sharded over a device mesh.
"""
from . import _config  # noqa: F401  (enables x64)

from .utils import Log, MGBConvergenceFailure, map_rows, interpolate, chebfun
from .convex import (Convex, convex_euclidian_power, convex_Euclidian_power,
                     convex_linear, convex_piecewise, intersect)
from .discretize import (fem1d, fem2d, fem3d, fem2d_P1, fem2d_P2,
                         spectral1d, spectral2d, tensor_dofmap, Geometry)
from .hierarchy import (amg, geometric_mg, subdivide, find_boundary,
                        amg_ruge_stuben, amg_smoothed_aggregation,
                        prepare_amg, MultiGrid)
from .solver import (assemble, mgb_solve, mgb_cleanup, MGBProblem, MGBSOL,
                     linesearch_backtracking, linesearch_illinois,
                     stopping_exact, stopping_inexact,
                     default_D, default_f, default_g, default_idx)
from .solver.parabolic import parabolic_solve, ParabolicSOL
from .frontends import gmsh_import
from .frontends.model import Model
from .parallel import make_mesh
from .utils.checkpoint import save_solution, load_solution, warm_start_grid
from . import zoo
# the function shadows the subpackage on purpose: plot(sol) is the API
# (reference extends PyPlot.plot); the module stays importable as
# ``from mgbtpu.plot.plotting import ...``
from .plot.html3d import plot3d_html
from .plot.plotting import animation_html, plot, save_animation

__version__ = "0.1.0"

__all__ = [
    "Log", "MGBConvergenceFailure", "map_rows", "interpolate", "chebfun",
    "Convex", "convex_euclidian_power", "convex_Euclidian_power",
    "convex_linear", "convex_piecewise", "intersect",
    "fem1d", "fem2d", "fem3d", "fem2d_P1", "fem2d_P2",
    "spectral1d", "spectral2d", "tensor_dofmap", "Geometry",
    "amg", "geometric_mg", "subdivide", "find_boundary",
    "amg_ruge_stuben", "amg_smoothed_aggregation", "prepare_amg", "MultiGrid",
    "assemble", "mgb_solve", "mgb_cleanup", "MGBProblem", "MGBSOL",
    "linesearch_backtracking", "linesearch_illinois",
    "stopping_exact", "stopping_inexact",
    "default_D", "default_f", "default_g", "default_idx",
    "parabolic_solve", "ParabolicSOL", "gmsh_import", "Model", "make_mesh",
    "save_solution", "load_solution", "warm_start_grid", "zoo",
    "animation_html", "plot", "plot3d_html", "save_animation",
]
