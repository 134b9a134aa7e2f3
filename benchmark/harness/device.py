"""What a run records of its device and process: the card's name and
count, the allocator's peak, the card's power limit, the start of the
process, and the modules of the JAX package that must not be loaded."""

from __future__ import annotations

import os
import subprocess
import sys
import time

# top-level module names, compared whole: the port's own name begins with
# the JAX package's and passes
FORBIDDEN = ("jax", "jaxlib", "flax", "ideepcolor_tpu")


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def power_limit() -> str:
    """``name, power.limit`` as nvidia-smi reads them, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            out.stderr.strip()[:200]
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def record(torch, count: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


class Clock:
    """Host clock with the process start as its origin."""

    def __init__(self):
        self.origin = time.perf_counter() - process_age_s()

    def since_start(self) -> float:
        return time.perf_counter() - self.origin
