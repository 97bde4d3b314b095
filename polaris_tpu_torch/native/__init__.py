"""Native (C++) host components, loaded via ctypes.

The reference's host tier is Go with cgo FFI into OpenCL
(``tracer/opencl/device/``); here the device interop is JAX/Pallas, and the
native tier accelerates host-side scene compilation — currently the SAH BVH
builder. Compiled lazily with g++ on first use and cached next to the
source; falls back to the NumPy builder when no toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

from ..utils.log import get_logger

_log = get_logger("native")
_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


_SOURCES = ("bvh_builder.cpp", "exr_piz.cpp")


def _compile_lib() -> Optional[str]:
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    out = os.path.join(_HERE, "_libpolaris_native.so")
    if os.path.exists(out) and all(
        os.path.getmtime(out) >= os.path.getmtime(s) for s in srcs
    ):
        return out
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", out]
            + srcs,
            check=True,
            capture_output=True,
        )
        _log.info("compiled native library %s", out)
        return out
    except (OSError, subprocess.CalledProcessError) as exc:
        _log.warning("native build failed (%s); using NumPy fallback", exc)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        path = _compile_lib()
        if path:
            lib = ctypes.CDLL(path)
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            lib.polaris_build_bvh.restype = ctypes.c_int
            lib.polaris_build_bvh.argtypes = [
                ctypes.c_int, f32p, f32p, f32p, ctypes.c_int,
                f32p, f32p, i32p, i32p, i32p, i32p, i32p, i32p,
            ]
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
            lib.polaris_piz_decode.restype = ctypes.c_int
            lib.polaris_piz_decode.argtypes = [
                u8p, ctypes.c_long, i32p, ctypes.c_int, ctypes.c_int, u16p,
            ]
            _LIB = lib
    return _LIB


def piz_decode_native(raw: bytes, chan_shorts, n_lines: int):
    """Native PIZ chunk decode -> interleaved u16 array, or None when the
    native library is unavailable (callers fall back to the Python path)."""
    lib = get_lib()
    if lib is None:
        return None
    cs = np.asarray(chan_shorts, np.int32)
    total = int(cs.sum()) * n_lines
    out = np.empty(total, np.uint16)
    buf = np.frombuffer(raw, np.uint8)
    rc = lib.polaris_piz_decode(
        np.ascontiguousarray(buf), len(raw), cs, len(cs), n_lines, out
    )
    if rc != 0:
        raise ValueError(f"native PIZ decode failed (code {rc})")
    return out


def build_bvh_native(bboxes_min, bboxes_max, centers, min_leaf_items, leaf_cb):
    """C++ SAH build with the Python LeafCallback contract; returns
    BvhArrays or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    from ..asset.compiler.bvh import BvhArrays

    n = int(bboxes_min.shape[0])
    max_nodes = 2 * n
    out_bmin = np.empty((max_nodes, 3), np.float32)
    out_bmax = np.empty((max_nodes, 3), np.float32)
    ldata = np.empty(max_nodes, np.int32)
    rdata = np.empty(max_nodes, np.int32)
    perm = np.empty(n, np.int32)
    leaf_first = np.empty(n, np.int32)
    leaf_count = np.empty(n, np.int32)
    n_leaves = np.zeros(1, np.int32)
    n_nodes = lib.polaris_build_bvh(
        n,
        np.ascontiguousarray(bboxes_min, np.float32),
        np.ascontiguousarray(bboxes_max, np.float32),
        np.ascontiguousarray(centers, np.float32),
        int(min_leaf_items),
        out_bmin, out_bmax, ldata, rdata, perm, leaf_first, leaf_count,
        n_leaves,
    )
    ldata = ldata[:n_nodes].copy()
    rdata = rdata[:n_nodes].copy()
    # rewrite leaf ordinals through the caller's leaf callback, preserving
    # the node-creation order (left subtree first, like the recursion)
    for i in range(n_nodes):
        if ldata[i] < 0:
            ordinal = -int(ldata[i]) - 1
            first = int(leaf_first[ordinal])
            count = int(leaf_count[ordinal])
            l, r = leaf_cb(perm[first : first + count].astype(np.int64))
            ldata[i] = l
            rdata[i] = r
    return BvhArrays(
        bmin=out_bmin[:n_nodes].copy(),
        bmax=out_bmax[:n_nodes].copy(),
        ldata=ldata,
        rdata=rdata,
    )
