"""Compile-cache placement and the GPU-only entry points."""
import os
import subprocess
import sys

import jax
import pytest

import mgbtpu._config as C

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_env_left_untouched(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    before = jax.config.jax_compilation_cache_dir
    assert C.compile_cache_dir() is None
    C.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert C.compile_cache_dir() == os.path.join(REPO, ".cache", "jaxcache")
    assert C.compile_cache_dir() == C.compile_cache_dir()


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_entry_point_fails_without_gpu(script):
    """A measurement that finds no GPU exits non-zero and prints no
    result; it never falls back to the host."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout and '"value"' not in r.stdout


def test_pallas_imports_name_a_gpu_route():
    """Any Pallas submodule the package imports is a GPU route (Triton or
    Mosaic GPU): kernels for other hardware do not lower on the card."""
    import ast
    import importlib.util

    base = "jax.experimental.pallas"
    allowed = {base, base + ".triton", base + ".mosaic_gpu"}
    bad = []
    for dirpath, _, files in os.walk(os.path.join(REPO, "mgbtpu")):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            with open(os.path.join(dirpath, fn)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif (isinstance(node, ast.ImportFrom) and node.level == 0
                      and (node.module or "").startswith(base)):
                    mods = [node.module] + [
                        f"{node.module}.{a.name}" for a in node.names
                        if importlib.util.find_spec(
                            f"{node.module}.{a.name}") is not None]
                else:
                    continue
                bad += [(fn, m) for m in mods
                        if m.startswith(base) and m not in allowed]
    assert bad == []
