"""The run's environment: cache directories inside the checkout, the
look for the cards, the look for JAX once the window has closed, and the
age of the process."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

# whole top-level module names the port's process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def pin_caches(root: Path) -> None:
    """Every build and kernel cache of the program in fixed directories
    of the checkout (set before torch is imported); a variable already
    set is overridden, so that no cache is shared with another checkout."""
    build = root / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(build / "cardbench" / sub)
    os.environ["USE_FLAX"] = "0"


def process_age_s() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} &
                  set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them, or
    an empty string."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return r.stdout.strip().splitlines()[0] if r.stdout.strip() else ""
