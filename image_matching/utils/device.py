"""The accelerator this program runs on: a GPU check, the device as JAX
reports it, and the card's name and power limit as nvidia-smi reports them
(a card set below its maximum power runs slower under load, so every
timing is printed beside it)."""

from __future__ import annotations

import subprocess
from typing import Optional, Sequence


def card_info() -> Optional[str]:
    """`name, power.limit` of the first card, from nvidia-smi in a child
    process (which never touches JAX), or None when there is no card."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = r.stdout.strip().splitlines()
    return lines[0].strip() if r.returncode == 0 and lines else None


def require_gpu(devices: Sequence, allow_cpu: bool = False):
    """Return devices[0] if it is a GPU (or, with `allow_cpu`, the CPU of
    an explicit rehearsal); raise otherwise.  There is no silent fallback:
    a CPU timing is never reported as a device timing."""
    dev = devices[0]
    if dev.platform == "gpu" or (allow_cpu and dev.platform == "cpu"):
        return dev
    raise RuntimeError(
        f"no GPU found: JAX's first device is {dev.platform} "
        f"({dev.device_kind})")


def describe(devices: Sequence) -> dict:
    dev = devices[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}
