"""Texture loading into TPU-friendly float32 RGBA arrays.

Counterpart of the reference's OpenImageIO-backed loader
(``asset/texure/texture.go:25-147``), which normalizes every image to one of
four storage formats (Luminance8/Luminance32F/Rgba8/Rgba32F) and keeps raw
bytes to be decoded per-sample in the OpenCL texture sampler
(texture_sampler.cl:14-252).

TPU-first redesign: textures are decoded **once at compile time** to float32
RGBA and concatenated into a single flat atlas array. Device-side sampling is
then a pure gather + bilinear mix with no per-sample format decoding, and the
atlas is a differentiable leaf of the scene parameter pytree.

Formats: PNG/JPEG/BMP/TGA/GIF/TIFF/WEBP via Pillow; Radiance RGBE (.hdr) via
a built-in decoder (HDR env maps are a headline feature — BASELINE config 5).
LDR sources are converted with the same ``v/255`` scaling the reference
sampler applies (texture_sampler.cl Rgba8 path); no gamma is applied.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..utils.log import get_logger

_log = get_logger("texture")

# Storage-format provenance tags (ref: asset/texure/texture_fmt.go:5-10)
LUMINANCE8 = 0
LUMINANCE32F = 1
RGBA8 = 2
RGBA32F = 3


@dataclass
class Texture:
    """A decoded texture: float32 RGBA pixels + provenance format tag."""

    data: np.ndarray  # (H, W, 4) float32
    format: int

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def height(self) -> int:
        return int(self.data.shape[0])


def load_texture(res) -> Texture:
    """Load a texture from a Resource (or local path)."""
    path = res if isinstance(res, str) else res.local_path
    name = res if isinstance(res, str) else res.path
    ext = os.path.splitext(name)[1].lower()
    if ext == ".hdr":
        return _load_hdr(path)
    if ext == ".exr":
        from .exr import read_exr

        return Texture(read_exr(path).astype(np.float32), RGBA32F)
    return _load_pil(path)


# byte -> float scaling: a MULTIPLY by the f32-rounded reciprocal, not a
# true division. XLA rewrites x/255.0 to x*(1/255) inside programs, so the
# device-side dequantization of byte-stored textures (ops/texture.py) can
# only be bit-identical to the load-time conversion if the host applies
# the exact same multiply. numpy and XLA both round a*b exactly, so every
# consumer (oracle, device, u8 or f32 storage) sees identical values.
INV255 = np.float32(1.0 / 255.0)


def _load_pil(path: str) -> Texture:
    from PIL import Image

    img = Image.open(path)
    if img.mode in ("L", "I;16", "I"):
        arr = np.asarray(img.convert("L"), dtype=np.float32) * INV255
        rgba = np.stack([arr, arr, arr, np.ones_like(arr)], axis=-1)
        return Texture(rgba.astype(np.float32), LUMINANCE8)
    if img.mode == "F":
        arr = np.asarray(img, dtype=np.float32)
        rgba = np.stack([arr, arr, arr, np.ones_like(arr)], axis=-1)
        return Texture(rgba.astype(np.float32), LUMINANCE32F)
    rgba = np.asarray(img.convert("RGBA"), dtype=np.float32) * INV255
    return Texture(rgba.astype(np.float32), RGBA8)


def _load_hdr(path: str) -> Texture:
    """Minimal Radiance RGBE (.hdr) decoder (flat + RLE scanlines)."""
    with open(path, "rb") as f:
        data = f.read()

    # header: lines until blank, then resolution line
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance RGBE file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res_line = data[pos:eol].decode("ascii").split()
    pos = eol + 1
    if len(res_line) != 4 or res_line[0] != "-Y" or res_line[2] != "+X":
        raise ValueError(f"{path}: unsupported RGBE resolution line {res_line}")
    height, width = int(res_line[1]), int(res_line[3])

    raw = np.frombuffer(data, dtype=np.uint8, offset=pos)
    rgbe = np.zeros((height, width, 4), dtype=np.uint8)
    idx = 0
    for y in range(height):
        if (
            idx + 4 <= raw.size
            and raw[idx] == 2
            and raw[idx + 1] == 2
            and (int(raw[idx + 2]) << 8 | int(raw[idx + 3])) == width
        ):
            # adaptive RLE scanline: 4 component planes
            idx += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(raw[idx])
                    idx += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = raw[idx]
                        idx += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = raw[idx : idx + count]
                        idx += count
                        x += count
        else:  # flat scanline
            row = raw[idx : idx + width * 4].reshape(width, 4)
            rgbe[y] = row
            idx += width * 4

    mantissa = rgbe[..., :3].astype(np.float32)
    exponent = rgbe[..., 3].astype(np.int32)
    scale = np.where(
        exponent == 0, 0.0, np.ldexp(1.0, exponent - 136)
    ).astype(np.float32)
    rgb = mantissa * scale[..., None]
    rgba = np.concatenate([rgb, np.ones((*rgb.shape[:2], 1), np.float32)], axis=-1)
    return Texture(rgba.astype(np.float32), RGBA32F)


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """Write a float32 RGB image as flat (uncompressed) Radiance RGBE."""
    h, w, _ = rgb.shape
    maxc = rgb.max(axis=-1)
    exp = np.zeros((h, w), np.int32)
    nz = maxc > 1e-32
    exp[nz] = np.frexp(maxc[nz])[1]
    scale = np.where(nz, np.ldexp(1.0, -exp) * 256.0, 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, exp + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode("ascii"))
        f.write(rgbe.tobytes())
