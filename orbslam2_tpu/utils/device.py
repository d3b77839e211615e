"""What the measurement scripts know about the device they run on.

Every JSON line a measurement prints names the platform, the device kind
and the device count. A measurement that finds no GPU fails instead of
timing the CPU, unless the CPU was asked for with `JAX_PLATFORMS=cpu`.
"""

from __future__ import annotations

import os
import subprocess


def device_info() -> dict:
    """{"platform", "kind", "count"} as JAX reports the first device."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def require_gpu() -> None:
    """Exit non-zero unless JAX runs on a GPU or the CPU was asked for."""
    import jax

    backend = jax.default_backend()
    cpu_requested = os.environ.get("JAX_PLATFORMS", "").strip().lower() == "cpu"
    if backend != "gpu" and not cpu_requested:
        raise SystemExit(
            f"no GPU found (JAX backend {backend!r}); set JAX_PLATFORMS=cpu "
            "to run on the CPU on purpose")


def gpu_name_and_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of each card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
