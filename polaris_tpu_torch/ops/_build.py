"""Build and load the package's CUDA kernels: ``nvcc`` by hand, ``ctypes``.

Each source under ``csrc/`` is compiled on first use into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), written to ``build/`` next to the package and keyed by a hash of
the source text and flags. A failed build or load raises with the
compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "polaris_tpu_torch")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels can only be built where the CUDA toolkit is installed"
    )


def load_library(source: str, extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` if its build is missing or stale, load it
    and return the ``ctypes`` handle (cached per process)."""
    key = (source, tuple(extra_flags))
    if key in _LIBS:
        return _LIBS[key]
    src = os.path.join(CSRC_DIR, source)
    with open(src, "rb") as f:
        text = f.read()
    flags = list(NVCC_FLAGS) + list(extra_flags)
    digest = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_find_nvcc(), *flags, "-o", tmp, src]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    lib = ctypes.CDLL(out)
    _LIBS[key] = lib
    return lib
