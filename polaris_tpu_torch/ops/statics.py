"""Host-static scene specialization for the shading path.

Captured once per scene on the host: which features can occur at all —
texture-backed material fields, BxDF types, material-tree operators, light
kinds. The result rides in the scene dict under the ``"_stx"`` key; in eager
PyTorch the pruning is a plain Python ``if`` around the branch, so an absent
feature launches no device work at all.

Numerics-preserving by construction: a skipped branch could only ever feed a
``where`` whose predicate is False on every lane (the predicate is a
per-lane comparison against data that the host just proved absent).
"""

from __future__ import annotations

import numpy as np

# material fields that can be texture-backed (matches MATERIAL_FIELDS pairs)
TEXTURE_FIELDS = (
    "reflectance",
    "specularity",
    "transmittance",
    "radiance",
    "roughness",
)


class Static:
    """An immutable, hashable bag of host-side values."""

    def __init__(self, **kw):
        object.__setattr__(self, "_d", dict(kw))

    def __getattr__(self, name):
        try:
            return object.__getattribute__(self, "_d")[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        raise AttributeError("Static is immutable")

    def _key(self):
        return tuple(sorted(self._d.items()))

    def __hash__(self):
        return hash(self._key())

    def __eq__(self, other):
        return isinstance(other, Static) and self._key() == other._key()

    def __repr__(self):
        return f"Static({self._d})"


def scene_statics(scene) -> Static:
    """Derive the specialization sidecar from a compiled SceneData (or any
    object exposing the same array attributes)."""
    from .bxdf import (
        BXDF_CONDUCTOR,
        BXDF_DIELECTRIC,
        BXDF_DIFFUSE,
        BXDF_EMISSIVE,
        BXDF_ROUGH_CONDUCTOR,
        BXDF_ROUGH_DIELECTRIC,
    )
    from .material import (
        OP_BUMP_MAP,
        OP_DISPERSE,
        OP_MIX,
        OP_MIX_MAP,
        OP_NORMAL_MAP,
    )

    mt = np.asarray(scene.mat_type)
    tex_fields = frozenset(
        f
        for f in TEXTURE_FIELDS
        if bool((np.asarray(getattr(scene, f"mat_{f}_tex")) >= 0).any())
    )
    ops = frozenset(
        name
        for name, op in (
            ("mix", OP_MIX),
            ("mixmap", OP_MIX_MAP),
            ("bump", OP_BUMP_MAP),
            ("normal", OP_NORMAL_MAP),
            ("disperse", OP_DISPERSE),
        )
        if bool((mt == op).any())
    )
    bxdf_types = frozenset(
        int(b)
        for b in (
            BXDF_EMISSIVE,
            BXDF_DIFFUSE,
            BXDF_CONDUCTOR,
            BXDF_ROUGH_CONDUCTOR,
            BXDF_DIELECTRIC,
            BXDF_ROUGH_DIELECTRIC,
        )
        if bool((mt == b).any())
    )
    et = np.asarray(scene.emis_type)
    lights = frozenset(
        name for name, v in (("area", 0), ("env", 1)) if bool((et == v).any())
    )
    bg = int(scene.scene_diffuse_mat)
    bg_tex = bool(
        bg >= 0 and int(np.asarray(scene.mat_reflectance_tex)[bg]) >= 0
    )
    return Static(
        tex_fields=tex_fields,
        ops=ops,
        bxdf_types=bxdf_types,
        lights=lights,
        bg_tex=bg_tex,
    )


# ----- lookup helpers (None sidecar = no specialization = full program) -----


def tex_on(S, field: str) -> bool:
    stx = S.get("_stx")
    return stx is None or field in stx.tex_fields


def has_bxdf(S, bit: int) -> bool:
    stx = S.get("_stx")
    return stx is None or int(bit) in stx.bxdf_types


def has_op(S, name: str) -> bool:
    stx = S.get("_stx")
    return stx is None or name in stx.ops


def has_light(S, name: str) -> bool:
    stx = S.get("_stx")
    return stx is None or name in stx.lights


def bg_has_tex(S) -> bool:
    stx = S.get("_stx")
    return stx is None or stx.bg_tex
