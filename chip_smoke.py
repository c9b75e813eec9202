"""Smoke test of the solver on the GPU, through the entry points a user calls.

    python chip_smoke.py          # phases 1-4 on one card
    python chip_smoke.py --four   # phase 5 only: the L=6 solve over four
                                  # cards against the one-card solve

Phases (one line of numbers each, then one JSON object as the last line):

1. the card: JAX's device kind and count, and ``nvidia-smi``'s name and
   power limit;
2. the golden vectors of ``tests/test_golden.py``, solved on the GPU in
   float64 (bar 1e-6, as on the CPU);
3. fem2d_P2 p=1 at L=5: the float64 GPU solve against the same solve on
   XLA:CPU in this process; the refusal of a float32 + double-float
   problem on the GPU (where it misses its 1e-5 bar against float64); one
   Ozaki dd GEMM per ND front inner width against a float64 oracle;
4. fem2d_P2 p=1 at L=7 (57,344 dofs per component), float64: cold and warm
   solve time, Newton iterations, ramp steps and peak device memory.

Exits non-zero, with no JSON line, when JAX finds no GPU or a phase fails.
The compile cache is kept where ``JAX_COMPILATION_CACHE_DIR`` says, else at
``<checkout>/.cache/jaxcache``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

GOLDEN_BAR = 1e-6
# float64 GPU vs XLA:CPU: scatter-adds use atomics on the GPU, so sums are
# taken in an order that changes from run to run
AGREE_BAR = 1e-6
REFERENCE_BAR = 1e-8   # the reference's cross-backend bar (test/test_cuda.jl:52)
OZAKI_BAR = 2.0 ** -44  # relative to the product's scale (tests/test_ozaki.py)
OZAKI_WIDTHS = (32, 64, 128, 256, 512)   # ND front inner widths


class PhaseFailure(RuntimeError):
    pass


def _check(ok, what):
    if not ok:
        raise PhaseFailure(what)


def _problem(L, dtype=np.float64):
    from mgbtpu import amg, assemble, fem2d_P2, subdivide

    return assemble(amg(subdivide(fem2d_P2(dtype=dtype), L)), p=1.0,
                    dtype=dtype)


def _counts(sol):
    m = sol.SOL_main
    return (int(m["its"].sum()),
            f"{m['steps_accepted']}/{m['steps_attempted']}")


def phase_card():
    import jax

    from mgbtpu.utils.device import card_info

    devices = jax.devices()
    card = card_info()
    print(f"card: device_kind={devices[0].device_kind!r} "
          f"count={len(devices)} nvidia-smi={card!r}", flush=True)
    return card


def golden_cases():
    """``tests/test_golden.py``'s cases, loaded by path (another installed
    package may own the name ``tests``)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "test_golden.py")
    spec = importlib.util.spec_from_file_location("mgbtpu_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CASES


def phase_golden(cases):
    """Golden-vector errors of ``cases`` (each returns (sol, got, gold))
    on the default device."""
    errs = {}
    for case in cases:
        _, got, gold = case()
        errs[case.__name__] = float(np.linalg.norm(np.asarray(got) - gold))
    print("golden: " + " ".join(f"{k}={v:.3e}" for k, v in errs.items())
          + f" bar={GOLDEN_BAR:g}", flush=True)
    _check(all(e < GOLDEN_BAR for e in errs.values()),
           f"golden vectors off by more than {GOLDEN_BAR:g}: {errs}")
    return errs


def phase_agreement(L=5, cpu=None):
    """The float64 solve on the default device (a GPU) against the same
    solve on ``cpu``; a float32 + double-float problem must be refused."""
    from mgbtpu import mgb_solve

    prob = _problem(L)
    t0 = time.perf_counter()
    sol_dev = mgb_solve(prob)
    dev_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol_cpu = mgb_solve(prob, device=cpu)
    cpu_s = time.perf_counter() - t0
    dz = float(np.abs(sol_dev.z - sol_cpu.z).max())
    its_dev, steps_dev = _counts(sol_dev)
    its_cpu, steps_cpu = _counts(sol_cpu)
    print(f"agreement L={L} float64: max|dz|={dz:.3e} bar={AGREE_BAR:g} "
          f"(reference bar {REFERENCE_BAR:g}: "
          f"{'met' if dz <= REFERENCE_BAR else 'not met'}) "
          f"its device={its_dev} cpu={its_cpu} steps device={steps_dev} "
          f"cpu={steps_cpu} cold_s device={dev_s:.3f} cpu={cpu_s:.3f}",
          flush=True)
    _check(dz <= AGREE_BAR, f"float64 device vs CPU max|dz|={dz:.3e}")

    try:
        _problem(L, np.float32)
        refusal = None
    except ValueError as e:
        refusal = str(e)
    print(f"agreement L={L} float32+dd: refused={refusal!r}", flush=True)
    _check(refusal is not None and "float64" in refusal,
           "a float32 + double-float problem was not refused on the GPU")
    return dz


def phase_ozaki(widths=OZAKI_WIDTHS, rows=64, batch=4, seed=0):
    """Jitted Ozaki dd GEMM A B^T at each inner width vs float64."""
    import jax
    import jax.numpy as jnp

    from mgbtpu.ops.df64 import f64_split
    from mgbtpu.ops.ozaki import dd_matmul_nt

    rng = np.random.default_rng(seed)
    mm = jax.jit(dd_matmul_nt)
    errs = {}
    for n in widths:
        A, B = (rng.standard_normal((batch, rows, n))
                * np.exp(4.0 * rng.uniform(-1, 1, (batch, rows, n)))
                for _ in range(2))
        oh, ol = mm(tuple(map(jnp.asarray, f64_split(A))),
                    tuple(map(jnp.asarray, f64_split(B))))
        got = np.asarray(oh, np.float64) + np.asarray(ol, np.float64)
        want = A @ np.swapaxes(B, -1, -2)
        errs[n] = float(np.abs(got - want).max() / np.abs(want).max())
    print("ozaki dd_matmul_nt rel err: "
          + " ".join(f"n={n}:{e:.3e}" for n, e in errs.items())
          + f" bar={OZAKI_BAR:.3e}", flush=True)
    _check(all(e <= OZAKI_BAR for e in errs.values()),
           f"Ozaki dd GEMM above 2^-44: {errs}")
    return errs


def _peak_bytes(device):
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def phase_full(card, L=7):
    """The real-size float64 solve: cold (compile + solve) and warm."""
    import jax

    from mgbtpu import mgb_solve

    t0 = time.perf_counter()
    prob = _problem(L)
    setup_s = time.perf_counter() - t0
    # mgb_solve returns host arrays: each time includes the device's work
    t0 = time.perf_counter()
    mgb_solve(prob)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sol = mgb_solve(prob)
    warm_s = time.perf_counter() - t0
    its, steps = _counts(sol)
    finite = bool(np.isfinite(sol.z).all())
    print(f"fem2d_P2 p=1 L={L} float64 ({sol.z.shape[0]} nodes): "
          f"setup_s={setup_s:.3f} cold_s={cold_s:.3f} warm_s={warm_s:.3f} "
          f"its={its} steps={steps} finite={finite} "
          f"peak_bytes_in_use={_peak_bytes(jax.devices()[0])} "
          f"card={card!r}", flush=True)
    _check(finite, f"L={L} solve produced non-finite values")
    return dict(cold_s=cold_s, warm_s=warm_s, its=its, steps=steps)


def phase_four(L=6, n=4, devices=None):
    """The same solve sharded over ``n`` devices (``mesh=make_mesh``)
    against the one-device solve; per-device peak memory of the sharded
    run (taken before the one-device solve)."""
    import jax

    from mgbtpu import make_mesh, mgb_solve

    devices = list(devices if devices is not None else jax.devices())
    _check(len(devices) >= n, f"--four needs {n} devices, "
           f"found {len(devices)}")
    prob = _problem(L)
    t0 = time.perf_counter()
    z_n = mgb_solve(prob, mesh=make_mesh(devices=devices[:n])).z
    mesh_s = time.perf_counter() - t0
    peaks = [_peak_bytes(d) for d in devices[:n]]
    t0 = time.perf_counter()
    z_1 = mgb_solve(prob, device=devices[0]).z
    one_s = time.perf_counter() - t0
    dz = float(np.abs(z_n - z_1).max())
    print(f"four L={L}: max|dz| {n} devices vs 1={dz:.3e} bar={AGREE_BAR:g} "
          f"cold_s {n}={mesh_s:.3f} 1={one_s:.3f} "
          f"peak_bytes_in_use={peaks}", flush=True)
    _check(dz <= AGREE_BAR, f"{n}-device vs 1-device max|dz|={dz:.3e}")
    if all(p is not None for p in peaks):
        # the ND factor blocks spread over the mesh (ops/ndchol._bshard)
        # rather than all landing on the first device
        _check(min(peaks) >= 0.25 * max(peaks),
               f"peak memory not spread over the devices: {peaks}")
    return dz, peaks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the L=6 solve over four cards vs one card")
    args = ap.parse_args(argv)

    import jax

    from mgbtpu._config import enable_compile_cache
    from mgbtpu.utils.device import device_record, require_gpu

    require_gpu()
    enable_compile_cache()
    card = phase_card()
    if args.four:
        phase_four()
    else:
        phase_golden(golden_cases())
        phase_agreement(cpu=jax.devices("cpu")[0])
        phase_ozaki()
        phase_full(card)
    print(json.dumps({"ok": True, "device": device_record()}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
