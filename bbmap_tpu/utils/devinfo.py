"""Which device a run used: JAX's view and nvidia-smi's, for the lines
that report results."""

import subprocess
from typing import List


def card_lines() -> List[str]:
    """nvidia-smi's ``name, power.limit`` of each card ([] where
    nvidia-smi is missing)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def device_identity() -> dict:
    """platform, device_kind and count as JAX reports them, and the
    cards' names and power limits."""
    import jax
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "cards": card_lines()}
