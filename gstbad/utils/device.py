"""What a measurement ran on: the JAX device and the card behind it."""

from __future__ import annotations

import subprocess

import jax


def device_info() -> dict:
    """The default backend's device as JAX reports it."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_info() -> str:
    """The card's name and power limit, one line per card, from
    nvidia-smi in a child process (it never touches JAX).  A card may be
    capped below its top power, which slows it under load, so every
    timing is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())
