"""What the measuring entry points (``bench.py``, ``chip_smoke.py``)
need to know about the card: they run only on a GPU and name it."""

from __future__ import annotations

import subprocess


def require_gpu():
    """JAX's first device; SystemExit (non-zero) when it is not a GPU —
    a measurement never falls back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"no GPU found: JAX's default device is {dev.platform!r} "
            f"({dev.device_kind}); this runs only on a GPU")
    return dev


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` lines, one per card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
