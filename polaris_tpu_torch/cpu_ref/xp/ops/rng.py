"""Deterministic counter-based RNG shared by the JAX and NumPy renderers.

Replaces the reference's ad-hoc stateful hash PRNG
(``CL/samplers/random_sampler.cl:7-16``), whose output depends on the order of
in-kernel draws. On TPU we want an *order-independent* generator keyed by
(pixel, sample, bounce, stream) so that

  * the image is bit-identical regardless of tiling/sharding layout
    (multi-host determinism for the allclose gates), and
  * the NumPy golden renderer can reproduce the exact same numbers.

The mixer is the 32-bit finalizer family used by murmur3/splitmix
(xor-shift + odd multiplies), applied to a combined counter. Uniform floats
use the top 24 bits -> [0, 1).

Both implementations operate on uint32 lane values; the NumPy variant uses
uint64 intermediates with explicit masking to avoid overflow warnings.
"""

from __future__ import annotations

import numpy as np

_MASK = np.uint64(0xFFFFFFFF)
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def np_hash_u32(x: np.ndarray) -> np.ndarray:
    """murmur3-style finalizer on uint32 arrays (NumPy)."""
    x = x.astype(np.uint64) & _MASK
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(_C1)) & _MASK
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(_C2)) & _MASK
    x ^= x >> np.uint64(16)
    return x.astype(np.uint32)


def np_combine(*parts) -> np.ndarray:
    """Combine counters into one u32 key, splitmix-style sequential mixing."""
    acc = None
    for p in parts:
        p = np.asarray(p, dtype=np.uint64) & _MASK
        if acc is None:
            acc = p.copy()
        else:
            acc = (acc + np.uint64(_GOLDEN)) & _MASK
            acc ^= p
            acc = np_hash_u32(acc).astype(np.uint64)
    return np_hash_u32(acc)


def np_uniform(*parts) -> np.ndarray:
    """float32 uniforms in [0, 1) keyed by the given counters."""
    bits = np_combine(*parts)
    return ((bits >> np.uint32(8)).astype(np.float32) * np.float32(1.0 / 16777216.0))


def make_uniform(uniform_fn, seed, pixel_idx, sample_idx, bounce, rr_key=None):
    """Bind the per-draw counter layout into a stream closure.

    Layout: uniform(seed, pixel, sample, bounce*64 + stream). Both renderers
    MUST build their closures through this function so streams line up.

    ``rr_key``: optional alternative key array for the STREAM_RR draw only —
    tile-coherent Russian roulette (RenderOptions.rr_tile_coherent) keys the
    survival uniform by 32x32 block id instead of pixel id so blocks die
    atomically. All other streams always key by pixel.
    """

    def U(stream):
        key = pixel_idx
        if rr_key is not None and stream == STREAM_RR:
            key = rr_key
        return uniform_fn(seed, key, sample_idx, bounce * 64 + stream)

    return U


def rr_block_key(xp, pixel_idx, width: int):
    """32x32-block id of each full-frame pixel id (tile-coherent RR key)."""
    pix = pixel_idx.astype(xp.uint32)
    x = pix % xp.uint32(width)
    y = pix // xp.uint32(width)
    nbx = xp.uint32((width + 31) // 32)
    return (y // xp.uint32(32)) * nbx + (x // xp.uint32(32))


# Stream ids: each logical draw site gets a fixed stream so draw order never
# matters. (The reference draws sample0/1/2 sequentially from one state —
# pt_integrator.cl:82-84; here every site is independent.)
STREAM_LENS_U = 0
STREAM_LENS_V = 1
STREAM_BXDF_U = 2
STREAM_BXDF_V = 3
STREAM_LIGHT_SELECT = 4
STREAM_LIGHT_U = 5
STREAM_LIGHT_V = 6
STREAM_RR = 7
STREAM_MAT_MIX = 8  # + tree depth offset per level
STREAM_DISPERSE = 24
