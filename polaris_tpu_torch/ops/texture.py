"""Texture sampling from the scene's atlases, and texture-or-constant
material sampling.

Counterpart of the JAX package's ``ops/texture.py`` (itself the counterpart
of the reference's manual texture fetch, ``CL/samplers/texture_sampler.cl``):
repeat wrap, bilinear filtering with the +1 texel CLAMPED at the edge (not
wrapped), and the 3-tap bump-to-normal reconstruction, over three storage
kinds (``tex_store``): 0 float32 RGBA in ``tex_data``, 1 Rgba8 and
2 Luminance8 in ``tex_data_u8``. A scene may mix them.

The JAX module is plain array code, and so is this one; on a card the
shading kernel samples the atlas itself (``csrc/shade_texture.cuh``, the
same arithmetic), and this module is its plain version.

What is carried over is the arithmetic, expression for expression:
``su = (u - floor(u)) * w``, the truncating cast and the clip to
``[0, w - 1]``, the clamped neighbour, bytes dequantised AFTER the fetch by
``* float32(1/255)``, the bilinear blend in its association, the bump normal.
PyTorch rounds every multiply and add on its own, as NumPy does, so the
bilinear samplers agree with the NumPy evaluation of the original bit for
bit; the bump normal takes a square root, which the two libraries may round
an ulp apart.

What is NOT carried over is the TPU staging: the JAX module builds a
neighbourhood atlas (every texel stored with its 2x2 footprint, 16 floats a
row) so that a lane makes ONE lookup, and resolves the per-texture table with
where-chains (``take_small``), because a per-lane gather costs a TPU about an
element a cycle. Here the corners are GATHERED DIRECTLY from the atlas, all
four in one indexed read: the same texels, no table built per call, nothing
staged. The per-texture table
(offset, width, height, storage) is a small device tensor made at upload
(``texture_table``).

Every atlas read is a differentiable index into ``tex_data`` (no ``detach``,
no in-place write), so a gradient flows from a sample to the float atlas.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .statics import tex_on
from .vec import take_small

# the loader's exact dequantisation factor (asset/texture.py INV255)
_INV255 = float(np.float32(1.0 / 255.0))

STORE_F32, STORE_RGBA8, STORE_LUM8 = 0, 1, 2


def texture_table(rows, device) -> torch.Tensor:
    """The ``_tex_meta`` rows ``(offset, width, height, store)`` as an int64
    tensor ``[n_tex, 4]`` on ``device`` (one row of zeros for a scene without
    textures, so that an index of 0 stays in range)."""
    if not rows:
        rows = ((0, 1, 1, 0),)
    return torch.tensor(rows, dtype=torch.int64, device=device)


def _table(S, device) -> Tuple[torch.Tensor, frozenset]:
    """(table, the storage kinds present). ``upload_scene`` stores the table;
    a hand-built ``S`` with only ``_tex_meta`` gets one made here."""
    rows = S["_tex_meta"].tex
    tab = S.get("_tex_table")
    if tab is None:
        tab = texture_table(rows, device)
    return tab, frozenset(r[3] for r in rows)


def _corners(S, uv, tex_idx, nc: int, taps):
    """uv -> (the ``taps`` of the 2x2 footprint, each ``[..., nc]`` f32; cx;
    cy). Taps are named by ``(dy, dx)``: (0,0) the texel under the sample,
    (0,1) its right neighbour, (1,0) the one below, (1,1) the diagonal one,
    the +1 clamped to the last column / row. Channels beyond a Luminance8
    texel's one repeat it."""
    tab, kinds = _table(S, uv.device)
    # one gather per column: a gather of whole 4-int rows takes PyTorch's row
    # gather kernel, which an H100 ran in 0.63 ms at a million lanes where
    # each of these four takes 0.02 ms
    at_tex = torch.clamp(tex_idx, min=0).to(torch.int64)
    off, w, h, store = (tab[:, k][at_tex] for k in range(4))
    wf = w.to(uv.dtype)
    hf = h.to(uv.dtype)
    su = (uv[..., 0] - torch.floor(uv[..., 0])) * wf
    sv = (uv[..., 1] - torch.floor(uv[..., 1])) * hf
    # a truncating cast, as ``astype(int32)``; the clip catches su == w
    tx = torch.minimum(torch.clamp(su.to(torch.int32).to(torch.int64), min=0), w - 1)
    ty = torch.minimum(torch.clamp(sv.to(torch.int32).to(torch.int64), min=0), h - 1)
    cx = su - tx.to(uv.dtype)
    cy = sv - ty.to(uv.dtype)
    bx = torch.minimum(tx + 1, w - 1)
    by = torch.minimum(ty + 1, h - 1)

    # all taps in ONE gather per atlas: texel coordinates [..., taps]
    ys, xs = (ty, by), (tx, bx)
    y = torch.stack([ys[dy] for dy, _ in taps], dim=-1)
    x = torch.stack([xs[dx] for _, dx in taps], dim=-1)
    has_f32 = STORE_F32 in kinds
    has_u8 = bool(kinds - {STORE_F32})
    # floats (or bytes) from one texel to the next, and from one channel to
    # the next: a Luminance8 texel is one byte that serves every channel
    channels = torch.arange(nc, device=uv.device)
    if STORE_LUM8 in kinds:
        lum = store == STORE_LUM8
        texel = torch.where(lum, 1, 4)[..., None]
        chan = torch.where(lum, 0, 1)[..., None, None] * channels
    else:
        texel, chan = 4, channels
    at = (off[..., None] + (y * w[..., None] + x) * texel)[..., None] + chan
    qf = qu = None
    if has_f32:
        data = S["tex_data"]
        # in a mixed scene the lanes of the other family index out of this
        # atlas's range: clip, their value is dropped below
        qf = take_small(data, torch.clamp(at, max=data.shape[0] - 1) if has_u8 else at)
    if has_u8:
        data = S["tex_data_u8"]
        qu = data[torch.clamp(at, max=data.shape[0] - 1) if has_f32 else at]
        qu = qu.to(uv.dtype) * _INV255
    if qu is None:
        q = qf
    elif qf is None:
        q = qu
    else:
        q = torch.where((store != STORE_F32)[..., None, None], qu, qf)
    return q.unbind(dim=-2), cx, cy


_FOOTPRINT = ((0, 0), (0, 1), (1, 0), (1, 1))  # tl, tr, bl, br


def _bilinear(tl, tr, bl, br, cx, cy):
    return (tl * (1 - cy) + bl * cy) * (1 - cx) + (tr * (1 - cy) + br * cy) * cx


def tex_sample3(S, uv, tex_idx):
    """Bilinear RGB sample; ``uv`` [..., 2] f32, ``tex_idx`` [...] int (a
    negative index samples texture 0; callers select it away)."""
    (tl, tr, bl, br), cx, cy = _corners(S, uv, tex_idx, 3, _FOOTPRINT)
    return _bilinear(tl, tr, bl, br, cx[..., None], cy[..., None])


def tex_sample1(S, uv, tex_idx):
    """Red-channel sample (texture_sampler.cl texGetSample1f)."""
    (tl, tr, bl, br), cx, cy = _corners(S, uv, tex_idx, 1, _FOOTPRINT)
    return _bilinear(tl[..., 0], tr[..., 0], bl[..., 0], br[..., 0], cx, cy)


def tex_sample_rgba(S, uv, tex_idx):
    """Bilinear RGBA sample of a float32 texture. As in the JAX package, only
    float storage keeps an alpha to sample: a scene with byte-stored textures
    raises."""
    if _table(S, uv.device)[1] - {STORE_F32}:
        raise ValueError(
            "byte-stored textures (tex_store != 0) keep no sampled alpha; "
            "use tex_sample3 / tex_sample1, or compile the scene with "
            "float_textures=True"
        )
    (tl, tr, bl, br), cx, cy = _corners(S, uv, tex_idx, 4, _FOOTPRINT)
    return _bilinear(tl, tr, bl, br, cx[..., None], cy[..., None])


def tex_bump_sample3(S, uv, tex_idx):
    """3-tap height-to-normal reconstruction (texture_sampler.cl:187-253).

    Returns ``0.5 + 0.5*normalize(s1-s0, s2-s0, 1)``, like the reference, so
    the caller's ``*2-1`` decode applies uniformly to bump and normal maps.
    The three taps are the tl / tr / bl corners of the bilinear footprint.
    """
    (s0, s1, s2), _, _ = _corners(S, uv, tex_idx, 1, _FOOTPRINT[:3])
    dx = (s1 - s0)[..., 0]
    dy = (s2 - s0)[..., 0]
    inv_len = 1.0 / torch.sqrt(dx * dx + dy * dy + 1.0)
    n = torch.stack([dx * inv_len, dy * inv_len, inv_len], dim=-1)
    return 0.5 + 0.5 * n


def mat_sample3(S, uv, default3, tex_idx, field=None):
    """Texture-or-constant float3 (material_sampler.cl matGetSample3f).

    ``field`` names the material field so texture-free scenes skip the atlas
    entirely (ops/statics.py): when the host proved no node of this field has
    a texture, every ``tex_idx`` is -1 and the select would pick ``default3``
    on all lanes anyway.
    """
    if field is not None and not tex_on(S, field):
        return default3
    sampled = tex_sample3(S, uv, tex_idx)
    return torch.where((tex_idx < 0)[..., None], default3, sampled)


def mat_sample1(S, uv, default1, tex_idx, field=None):
    if field is not None and not tex_on(S, field):
        return default1
    sampled = tex_sample1(S, uv, tex_idx)
    return torch.where(tex_idx < 0, default1, sampled)
