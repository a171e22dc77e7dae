"""What the benchmark and the smoke test record about the device."""

from __future__ import annotations

import subprocess


def card_name_power() -> str:
    """`name, power.limit` of the first GPU as nvidia-smi reports it (a
    card below its maximum power limit runs slower under load)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.strip().splitlines()[0] if out.strip() else "unknown"
