"""The card a run measures, and what the result line says of it."""

from __future__ import annotations

import subprocess
import sys
from typing import Optional

# Modules that may not be loaded in a measured process: JAX and the JAX
# package, compared by whole top-level name (`polaris_tpu_torch` is allowed).
FORBIDDEN = ("jax", "jaxlib", "flax", "polaris_tpu")


def forbidden_loaded(modules=None) -> list:
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def require_cards(count: int) -> None:
    """Exit 1, printing no result, without ``count`` CUDA cards."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the benchmark measures the card and never the CPU")
    if torch.cuda.device_count() < count:
        sys.exit(f"the cell needs {count} CUDA devices, {torch.cuda.device_count()} present")


def power_limit() -> Optional[str]:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=True,
        )
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def describe(device, count: int, memory_peak_bytes: int) -> dict:
    import torch

    if device.type == "cuda":
        return {
            "platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(memory_peak_bytes), "power": power_limit(),
        }
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
