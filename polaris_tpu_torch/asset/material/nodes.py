"""Material expression AST + semantic validation.

Counterpart of the reference's ``asset/material/node.go:57-258`` (AST node
types with energy-conservation / arity validation) and
``asset/material/bxdf.go`` / ``op.go`` (type enums). The numeric enum values
intentionally match the reference's so compiled scenes are diff-able against
it: bxdf types are one-hot bits (emissive=2 ... roughDielectric=64,
bxdf.go:6-17) and operator ids start at 10001 (op.go:7-17,
material_sampler.cl:4-8).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple, Union

from .ior import lookup_ior

# --- BxDF type bits (ref: asset/material/bxdf.go:6-17) ---
BXDF_INVALID = 1 << 0
BXDF_EMISSIVE = 1 << 1
BXDF_DIFFUSE = 1 << 2
BXDF_CONDUCTOR = 1 << 3
BXDF_ROUGH_CONDUCTOR = 1 << 4
BXDF_DIELECTRIC = 1 << 5
BXDF_ROUGH_DIELECTRIC = 1 << 6

# --- Operator ids (ref: asset/material/op.go:7-17) ---
OP_MIX = 10001
OP_MIX_MAP = 10002
OP_BUMP_MAP = 10003
OP_NORMAL_MAP = 10004
OP_DISPERSE = 10005

BXDF_NAMES = {
    "emissive": BXDF_EMISSIVE,
    "diffuse": BXDF_DIFFUSE,
    "conductor": BXDF_CONDUCTOR,
    "roughConductor": BXDF_ROUGH_CONDUCTOR,
    "dielectric": BXDF_DIELECTRIC,
    "roughDielectric": BXDF_ROUGH_DIELECTRIC,
}
BXDF_TYPE_TO_NAME = {v: k for k, v in BXDF_NAMES.items()}

# Parameter names (ref: asset/material/node.go:10-19)
PARAM_REFLECTANCE = "reflectance"
PARAM_SPECULARITY = "specularity"
PARAM_TRANSMITTANCE = "transmittance"
PARAM_RADIANCE = "radiance"
PARAM_INT_IOR = "intIOR"
PARAM_EXT_IOR = "extIOR"
PARAM_SCALE = "scale"
PARAM_ROUGHNESS = "roughness"

# Allowed parameters per bxdf type (ref: asset/material/node.go:21-55)
ALLOWED_PARAMS = {
    BXDF_EMISSIVE: {PARAM_RADIANCE, PARAM_SCALE},
    BXDF_DIFFUSE: {PARAM_REFLECTANCE},
    BXDF_CONDUCTOR: {PARAM_SPECULARITY, PARAM_INT_IOR, PARAM_EXT_IOR},
    BXDF_ROUGH_CONDUCTOR: {
        PARAM_SPECULARITY,
        PARAM_INT_IOR,
        PARAM_EXT_IOR,
        PARAM_ROUGHNESS,
    },
    BXDF_DIELECTRIC: {
        PARAM_SPECULARITY,
        PARAM_TRANSMITTANCE,
        PARAM_INT_IOR,
        PARAM_EXT_IOR,
    },
    BXDF_ROUGH_DIELECTRIC: {
        PARAM_SPECULARITY,
        PARAM_TRANSMITTANCE,
        PARAM_INT_IOR,
        PARAM_EXT_IOR,
        PARAM_ROUGHNESS,
    },
}


class MaterialError(ValueError):
    """Raised on parse or validation failure of a material expression."""


# --- AST value nodes ---


@dataclass(frozen=True)
class Vec3Node:
    value: Tuple[float, float, float]

    def validate(self) -> None:
        pass


@dataclass(frozen=True)
class FloatNode:
    value: float

    def validate(self) -> None:
        pass


@dataclass(frozen=True)
class MaterialNameNode:
    """Quoted name used as a named-IOR lookup (e.g. ``"Glass"``)."""

    name: str

    def validate(self) -> None:
        if not self.name:
            raise MaterialError("material name cannot be empty")


@dataclass(frozen=True)
class MaterialRefNode:
    """Quoted operand referencing another scene material by name."""

    name: str

    def validate(self) -> None:
        if not self.name:
            raise MaterialError("material name cannot be empty")


@dataclass(frozen=True)
class TextureNode:
    path: str

    def validate(self) -> None:
        if not self.path:
            raise MaterialError("no texture path specified")


@dataclass(frozen=True)
class BxdfParamNode:
    name: str
    value: Union[Vec3Node, FloatNode, MaterialNameNode, TextureNode]

    def validate(self) -> None:
        """Energy-conservation + named-IOR checks (ref: node.go:137-163)."""
        v = self.value
        if self.name == PARAM_REFLECTANCE and isinstance(v, Vec3Node):
            if any(c >= 1.0 for c in v.value):
                raise MaterialError(
                    f"energy conservation violation for parameter {self.name!r}; "
                    "ensure that all vector components are < 1.0"
                )
        elif self.name in (PARAM_SPECULARITY, PARAM_TRANSMITTANCE) and isinstance(
            v, Vec3Node
        ):
            if any(c > 1.0 for c in v.value):
                raise MaterialError(
                    f"energy conservation violation for parameter {self.name!r}; "
                    "ensure that all vector components are <= 1.0"
                )
        elif self.name == PARAM_ROUGHNESS and isinstance(v, FloatNode):
            if v.value > 1.0:
                raise MaterialError(
                    f"values for parameter {self.name!r} must be in the [0, 1] range"
                )
        elif self.name in (PARAM_INT_IOR, PARAM_EXT_IOR) and isinstance(
            v, MaterialNameNode
        ):
            lookup_ior(v.name)  # raises on unknown name
        v.validate()


@dataclass(frozen=True)
class BxdfNode:
    bxdf_type: int
    params: Tuple[BxdfParamNode, ...] = field(default_factory=tuple)

    def validate(self) -> None:
        if self.bxdf_type not in ALLOWED_PARAMS:
            raise MaterialError("invalid BXDF type")
        allowed = ALLOWED_PARAMS[self.bxdf_type]
        for p in self.params:
            if p.name not in allowed:
                raise MaterialError(
                    f"bxdf type {BXDF_TYPE_TO_NAME[self.bxdf_type]!r} does not "
                    f"support parameter {p.name!r}"
                )
            p.validate()


@dataclass(frozen=True)
class MixNode:
    expressions: Tuple[object, object]
    weight: float

    def validate(self) -> None:
        for i, e in enumerate(self.expressions):
            if e is None:
                raise MaterialError(f"missing expression argument {i} for 'mix'")
            e.validate()
        if not (0.0 <= self.weight <= 1.0):
            raise MaterialError("Mix: mix weight must be in the [0, 1] range")


@dataclass(frozen=True)
class MixMapNode:
    expressions: Tuple[object, object]
    texture: TextureNode

    def validate(self) -> None:
        for i, e in enumerate(self.expressions):
            if e is None:
                raise MaterialError(f"missing expression argument {i} for 'mixMap'")
            e.validate()
        self.texture.validate()


@dataclass(frozen=True)
class BumpMapNode:
    expression: object
    texture: TextureNode

    def validate(self) -> None:
        if self.expression is None:
            raise MaterialError("missing expression argument for 'BumpMap'")
        self.expression.validate()
        self.texture.validate()


@dataclass(frozen=True)
class NormalMapNode:
    expression: object
    texture: TextureNode

    def validate(self) -> None:
        if self.expression is None:
            raise MaterialError("missing expression argument for 'NormalMap'")
        self.expression.validate()
        self.texture.validate()


@dataclass(frozen=True)
class DisperseNode:
    expression: object
    int_ior: Vec3Node
    ext_ior: Vec3Node

    def validate(self) -> None:
        if self.expression is None:
            raise MaterialError("missing expression argument for 'Disperse'")
        self.expression.validate()
        if max(self.int_ior.value) == 0.0 and max(self.ext_ior.value) == 0.0:
            raise MaterialError(
                "Disperse: at least one of the intIOR and extIOR parameters "
                "must contain a non-zero value"
            )


ExprNode = Union[
    BxdfNode, MixNode, MixMapNode, BumpMapNode, NormalMapNode, DisperseNode,
    MaterialRefNode,
]


def is_bxdf_type(t: int) -> bool:
    return BXDF_INVALID < t < (1 << 7)


def is_op_type(t: int) -> bool:
    return OP_MIX <= t <= OP_DISPERSE
