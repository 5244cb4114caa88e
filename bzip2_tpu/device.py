"""What a measurement runs on: the JAX device record and the card's name and
power limit.  Measurement entry points (bench.py, chip_smoke.py) call
``require_gpu`` first and refuse to run anywhere but on a GPU."""
from __future__ import annotations

import subprocess


def require_gpu() -> dict:
    """The device record ``{"platform", "kind", "count"}`` as JAX reports
    it; raises RuntimeError unless JAX's default backend is a GPU (JAX
    silently runs on the CPU when its CUDA plugin fails to start)."""
    import jax

    devs = jax.devices()
    if jax.default_backend() != "gpu" or devs[0].platform != "gpu":
        raise RuntimeError(f"needs a GPU; JAX's default backend is "
                           f"{jax.default_backend()!r} "
                           f"({devs[0].device_kind})")
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_info() -> str:
    """``name, power.limit`` of each card, one line each, from nvidia-smi
    (a plain subprocess, not a JAX process)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()
