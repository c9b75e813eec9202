"""Benchmark: fem2d_P2 p=1 p-Laplacian solve wall time on the GPU (the
reference's headline workload, bench.md). Prints ONE JSON line.

Baseline: reference CUDA extension (A40, structured batched-GEMM path)
solve times from bench.md. vs_baseline = baseline_seconds / our_seconds
(>1 = faster). Float64, to the reference's tolerance tol = sqrt(eps(f64)).

    python bench.py                 # MGB_BENCH_L (default 5), MGB_BENCH_FEM

Exits non-zero when JAX finds no GPU.
"""
import json
import os
import time

import numpy as np

# reference A40 structured-path solve times (bench.md) per FEM family
_BASELINES = {
    "fem2d_P2": {4: 0.664, 5: 1.039, 6: 1.851, 7: 5.122},
    "fem2d_P1": {4: 0.888, 5: 1.276, 6: 3.781, 7: 13.152, 8: 60.045},
    "fem3d": {2: 0.790},   # Q_k k=3, GPU AMG (bench.md fem3d table)
}
BENCH_FEM = os.environ.get("MGB_BENCH_FEM", "fem2d_P2")
BASELINE_GPU = _BASELINES.get(BENCH_FEM, {})


def run(L: int, dtype):
    import mgbtpu
    from mgbtpu import amg, assemble, mgb_solve, subdivide

    fem = getattr(mgbtpu, BENCH_FEM)
    t0 = time.time()
    geom = subdivide(fem(dtype=dtype), L)
    mg = amg(geom)
    setup_s = time.time() - t0

    # assemble once: the solve metric matches the reference's bench.md,
    # which times the solver given an assembled problem (re-assembling
    # would re-trace the jitted programs and measure host tracing instead)
    prob = assemble(mg, p=1.0, dtype=dtype)

    def solve():
        t1 = time.time()
        sol = mgb_solve(prob)
        return time.time() - t1, sol

    warm_s, sol = solve()          # includes jit compiles
    if os.environ.get("MGB_BENCH_ONESHOT"):
        # scale runs (L >= 9): one solve is hours; report it as both
        solve_s = warm_s
    else:
        solve_s, sol = solve()     # warm caches
    n_dofs = sol.z.size
    its = int(sol.SOL_main["its"].sum())
    att = int(sol.SOL_main.get("steps_attempted", 0))
    acc = int(sol.SOL_main.get("steps_accepted", 0))
    # its/sqrt(n): the reference's theory predicts total Newton its
    # ~ O(sqrt(n)) along the ramp (paper/paper.md:36-39); a per-L trend of
    # this ratio exposes deep-L failure cascades as a rising tail
    return dict(setup_s=setup_s, warm_s=warm_s, solve_s=solve_s,
                n_dofs=n_dofs, newton_its=its,
                its_per_sqrt_n=round(its / np.sqrt(n_dofs), 3),
                steps=f"{acc}/{att}",   # accepted/attempted centerings
                finite=bool(np.all(np.isfinite(sol.z))))


def main():
    from mgbtpu._config import default_dtype, enable_compile_cache
    from mgbtpu.utils.device import card_info, device_record, require_gpu

    require_gpu()
    enable_compile_cache()
    L = int(os.environ.get("MGB_BENCH_L", "5"))
    dtype = default_dtype()
    r = run(L, dtype)
    base = BASELINE_GPU.get(L)
    vs = (base / r["solve_s"]) if base else None
    dev = device_record()
    print(json.dumps({
        "metric": f"{BENCH_FEM} p=1 L={L} ({r['n_dofs']//2} dofs/component) "
                  f"solve wall time, {dev['kind']} {np.dtype(dtype).name}",
        "value": r["solve_s"],
        "unit": "s",
        "vs_baseline": vs,
        "device": dev,
        "card": card_info(),
        "extra": {"warm_s": r["warm_s"],
                  "setup_s": r["setup_s"],
                  "newton_its": r["newton_its"],
                  "its_per_sqrt_n": r["its_per_sqrt_n"],
                  "steps": r["steps"],
                  "finite": r["finite"],
                  "baseline_A40_s": base},
    }))


if __name__ == "__main__":
    main()
