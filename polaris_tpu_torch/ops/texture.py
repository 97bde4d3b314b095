"""Texture-or-constant material sampling.

Counterpart of the JAX package's ``ops/texture.py``. This module ports the
material-field entry points (``mat_sample3`` / ``mat_sample1``) with the
host-static ``tex_on`` pruning: a field that no material node backs with a
texture returns its constant directly.

The atlas sampler itself (neighborhood atlas, bilinear fetch, bump
reconstruction) is not ported yet. Every path that would need it raises
``NotImplementedError`` naming the feature — a textured scene never renders
with a silently substituted constant. ``require_supported`` performs the same
check once per scene at upload time.
"""

from __future__ import annotations

import torch

from .statics import tex_on

# material-tree operators that read the atlas
_TEXTURE_OPS = ("mixmap", "bump", "normal")


def unsupported_features(stx) -> list:
    """Names of the features a scene needs that this port cannot render yet
    (empty list = fully supported). ``stx`` is the ``_stx`` sidecar."""
    missing = [f"texture-backed material field '{f}'" for f in sorted(stx.tex_fields)]
    missing += [
        f"material operator '{op}' (reads the texture atlas)"
        for op in _TEXTURE_OPS
        if op in stx.ops
    ]
    if stx.bg_tex:
        missing.append("textured background (lat-long environment map)")
    return missing


def require_supported(stx) -> None:
    missing = unsupported_features(stx)
    if missing:
        raise NotImplementedError(
            "scene needs features the PyTorch port has not ported yet: "
            + "; ".join(missing)
        )


def tex_sample3(S, uv, tex_idx):
    raise NotImplementedError(
        "texture atlas sampling (tex_sample3) is not ported yet"
    )


def tex_sample1(S, uv, tex_idx):
    raise NotImplementedError(
        "texture atlas sampling (tex_sample1) is not ported yet"
    )


def tex_bump_sample3(S, uv, tex_idx):
    raise NotImplementedError(
        "bump-map atlas sampling (tex_bump_sample3) is not ported yet"
    )


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
