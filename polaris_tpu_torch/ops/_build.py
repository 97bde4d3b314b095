"""Build and load the package's CUDA kernels: ``nvcc`` by hand, ``ctypes``.

Each source under ``csrc/`` is compiled on first use into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), written to ``build/`` next to the package and keyed by a hash of
the flags and of the text of the source and of every header under ``csrc/``
it includes. A failed build or load raises with the compiler's output;
nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List, Sequence

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


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _source_closure(source: str) -> List[str]:
    """``source`` and every file under ``csrc/`` it includes, directly or
    through another header, in a fixed order."""
    seen: List[str] = []
    todo = [source]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.append(name)
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            text = f.read()
        for inc in _INCLUDE.findall(text):
            inc = inc.decode()
            if os.path.exists(os.path.join(CSRC_DIR, inc)):
                todo.append(inc)
    return sorted(seen)


def _plan(source: str, extra_flags: Sequence[str]):
    """(output path, temporary path, nvcc arguments) of one library. The path is keyed by a
    hash of the flags and of the text of every file the source includes, so
    an edit to a shared header rebuilds every library that uses it."""
    flags = list(NVCC_FLAGS) + list(extra_flags)
    h = hashlib.sha256(" ".join(flags).encode())
    for name in _source_closure(source):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read() + b"\0")
    stem = os.path.splitext(source)[0]
    out = os.path.join(BUILD_DIR, f"lib{stem}_{h.hexdigest()[:16]}.so")
    tmp = f"{out}.{os.getpid()}.tmp"
    return out, tmp, [*flags, "-o", tmp, os.path.join(CSRC_DIR, source)]


def build_libraries(sources: Sequence[str], extra_flags: Sequence[str] = ()) -> Dict[str, float]:
    """Compile every library of ``sources`` whose build is missing or stale,
    one ``nvcc`` process each, all started together. Returns the seconds each
    took (0.0 for a build that was current). Raises with the compiler's
    output if any fails."""
    running = []
    seconds = {}
    for source in dict.fromkeys(sources):  # a source named twice builds once
        out, tmp, args = _plan(source, extra_flags)
        if os.path.exists(out):
            seconds[source] = 0.0
            continue
        cmd = [_find_nvcc(), *args]
        os.makedirs(BUILD_DIR, exist_ok=True)
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        running.append((source, out, tmp, cmd, proc, time.perf_counter()))
    failures = []
    for source, out, tmp, cmd, proc, t0 in running:
        stdout, stderr = proc.communicate()
        seconds[source] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{stdout}\n{stderr}"
            )
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load_library(source: str, extra_flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` if its build is missing or stale, load it
    and return the ``ctypes`` handle (cached per process)."""
    key = (source, tuple(extra_flags))
    if key not in _LIBS:
        build_libraries([source], extra_flags)
        _LIBS[key] = ctypes.CDLL(_plan(source, extra_flags)[0])
    return _LIBS[key]
