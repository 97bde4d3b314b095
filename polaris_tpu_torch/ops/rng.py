"""Deterministic counter-based RNG, bit-equal to the JAX package's
``np_uniform`` / ``jnp_uniform``.

Keyed by (seed, pixel, sample, bounce, stream), so the image is independent
of lane order, tiling and launch chunking. The mixer is the 32-bit
murmur3/splitmix finalizer family (xor-shift + odd multiplies) applied to a
combined counter; uniform floats use the top 24 bits -> [0, 1).

PyTorch has no complete ``uint32`` arithmetic, so lanes are ``int64`` values
masked to 32 bits after every add/multiply (the layout of the NumPy variant,
which uses uint64 intermediates). A masked value is non-negative, so ``>>``
on it is a logical shift, and a product of two 32-bit values wraps mod 2**64
in int64 without touching its low 32 bits.
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def hash_u32(x: torch.Tensor) -> torch.Tensor:
    """murmur3-style finalizer on int64 lanes holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * _C1) & _MASK
    x = x ^ (x >> 13)
    x = (x * _C2) & _MASK
    x = x ^ (x >> 16)
    return x


def _as_u32(p):
    """Tensor -> int64 tensor holding the value mod 2**32; a Python int stays
    a Python int (mod 2**32), which a tensor op takes as a scalar argument:
    no host-to-device copy, so a draw can be captured into a CUDA graph."""
    if isinstance(p, torch.Tensor):
        return p.to(torch.int64) & _MASK
    return int(p) & _MASK


def _fold(acc, parts):
    """Mix further counters into a running u32 key (splitmix-style)."""
    for p in parts:
        p = _as_u32(p)
        if acc is None:
            acc = p
        else:
            acc = (acc + _GOLDEN) & _MASK
            acc = acc ^ p
            acc = hash_u32(acc)
    return acc


def _device_of(*parts):
    return next((p.device for p in parts if isinstance(p, torch.Tensor)), None)


def combine(*parts) -> torch.Tensor:
    """Combine counters into one u32 key, splitmix-style sequential mixing."""
    key = hash_u32(_fold(None, parts))
    if isinstance(key, torch.Tensor):
        return key
    return torch.tensor(key, dtype=torch.int64, device=_device_of(*parts))


def _to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def uniform(*parts) -> torch.Tensor:
    """float32 uniforms in [0, 1) keyed by the given counters."""
    return _to_unit_float(combine(*parts))


def make_uniform(seed, pixel_idx, sample_idx, bounce, rr_key=None):
    """Bind the per-draw counter layout into a stream closure.

    Layout: uniform(seed, pixel, sample, bounce*64 + stream). ``seed``,
    ``bounce`` and ``sample_idx`` may be Python ints, 0-d tensors (a captured
    graph reads the seed and the sample index from device memory) or, the
    last two, per-lane tensors (path regeneration mixes bounce depths and
    sample indices in one pass).

    ``rr_key``: optional alternative key tensor for the STREAM_RR draw only —
    tile-coherent Russian roulette keys the survival uniform by 32x32 block
    id instead of pixel id. All other streams always key by pixel.

    The mix of (seed, key, sample) is the same for every stream, so it is
    folded once per key and reused; a draw then costs one more mixing round.

    The closure carries its counters as ``U.counters`` (a dict with the keys
    ``seed``, ``pixel``, ``sample``, ``bounce``, ``rr_key``), from which the
    shading kernel (ops/shade_cuda.py) makes the same draws.
    """
    prefix = {}

    def U(stream):
        by_block = rr_key is not None and stream == STREAM_RR
        if by_block not in prefix:
            key = rr_key if by_block else pixel_idx
            prefix[by_block] = _fold(None, (seed, key, sample_idx))
        acc = _fold(prefix[by_block], (bounce * 64 + stream,))
        return _to_unit_float(hash_u32(acc))

    U.counters = dict(
        seed=seed, pixel=pixel_idx, sample=sample_idx, bounce=bounce, rr_key=rr_key
    )
    return U


def rr_block_key(pixel_idx: torch.Tensor, width: int) -> torch.Tensor:
    """32x32-block id of each full-frame pixel id (tile-coherent RR key)."""
    pix = pixel_idx.to(torch.int64) & _MASK
    x = pix % width
    y = pix // width
    nbx = (width + 31) // 32
    return (y // 32) * nbx + (x // 32)


# Stream ids: each logical draw site gets a fixed stream so draw order never
# matters.
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
