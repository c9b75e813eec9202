"""The accelerator a measurement runs on.

A measurement that finds no GPU fails: it never falls back to the host,
whose times would be read as the device's.
"""
from __future__ import annotations

import subprocess

import jax


def require_gpu():
    """The GPU devices JAX found; raises SystemExit when there are none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX found only {devices[0].platform} devices")
    return devices


def card_info() -> str:
    """Name and power limit of each card, one line per card, as
    ``nvidia-smi`` reports them (a child process that stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def device_record() -> dict:
    """Platform, kind and count of the default backend's devices."""
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}
