"""Layered material system: expression DSL, AST, IOR database, defaults.

TPU-native counterpart of the reference's ``asset/material/`` package
(goyacc DSL ~1650 LoC -> recursive-descent parser).
"""

from .defaults import (
    DEFAULT_EXT_IOR,
    DEFAULT_INT_IOR,
    DEFAULT_RADIANCE,
    DEFAULT_RADIANCE_SCALER,
    DEFAULT_REFLECTANCE,
    DEFAULT_ROUGHNESS,
    DEFAULT_SPECULARITY,
    DEFAULT_TRANSMITTANCE,
)
from .expr import parse_expression
from .ior import KNOWN_IORS, lookup_ior
from .nodes import (
    BXDF_CONDUCTOR,
    BXDF_DIELECTRIC,
    BXDF_DIFFUSE,
    BXDF_EMISSIVE,
    BXDF_INVALID,
    BXDF_NAMES,
    BXDF_ROUGH_CONDUCTOR,
    BXDF_ROUGH_DIELECTRIC,
    BXDF_TYPE_TO_NAME,
    OP_BUMP_MAP,
    OP_DISPERSE,
    OP_MIX,
    OP_MIX_MAP,
    OP_NORMAL_MAP,
    BumpMapNode,
    BxdfNode,
    BxdfParamNode,
    DisperseNode,
    ExprNode,
    FloatNode,
    MaterialError,
    MaterialNameNode,
    MaterialRefNode,
    MixMapNode,
    MixNode,
    NormalMapNode,
    TextureNode,
    Vec3Node,
    is_bxdf_type,
    is_op_type,
)
