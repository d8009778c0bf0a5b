"""What a measurement ran on.

Every number this repository reports names its device: JAX's view
(platform, device_kind, device count) and the card's name and power limit
as nvidia-smi reports them.  A card set below its maximum power limit runs
slower under load, so the limit travels with every time.
"""

from __future__ import annotations

import subprocess

NVIDIA_SMI = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]


def card_name_and_power_limit() -> str:
    """nvidia-smi's `name, power.limit` line(s), read by a child process
    that does not import JAX; a short reason when nvidia-smi is absent."""
    try:
        out = subprocess.run(NVIDIA_SMI, capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
    if out.returncode != 0:
        return f"nvidia-smi failed (exit {out.returncode})"
    return "; ".join(ln.strip() for ln in out.stdout.splitlines()
                     if ln.strip())


def device_summary() -> dict:
    """JAX's device view: {"platform", "kind", "count"}."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def peak_bytes(device=None) -> int | None:
    """Peak bytes in use on a device (None where the backend keeps no
    memory statistics, as XLA:CPU)."""
    import jax
    stats = (device or jax.devices()[0]).memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")
