"""Recursive-descent parser for the layered material expression DSL.

Counterpart of the reference's goyacc grammar + hand-written lexer
(``asset/material/material_expr.y:76-360``). The language:

    bxdf_spec  : bxdf '(' [param (',' param)*] ')'
                 bxdf in {diffuse, conductor, roughConductor, dielectric,
                          roughDielectric, emissive}
    param      : reflectance|specularity|transmittance|radiance ':' float3|texture
               | intIOR|extIOR ':' float | "IOR name"
               | scale ':' float
               | roughness ':' float|texture
    float3     : '{' f ',' f ',' f '}'
    op_spec    : mix '(' expr ',' expr ',' float ')'
               | mixMap '(' expr ',' expr ',' texture ')'
               | bumpMap '(' expr ',' texture ')'
               | normalMap '(' expr ',' texture ')'
               | disperse '(' expr ',' intIOR ':' float3 ',' extIOR ':' float3 ')'
    expr       : bxdf_spec | op_spec | "material ref"

A quoted string is a texture if it matches a known image extension
(ref: asset/material/texture.go:7), otherwise a material name/reference.
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from .nodes import (
    BXDF_NAMES,
    PARAM_EXT_IOR,
    PARAM_INT_IOR,
    PARAM_RADIANCE,
    PARAM_REFLECTANCE,
    PARAM_ROUGHNESS,
    PARAM_SCALE,
    PARAM_SPECULARITY,
    PARAM_TRANSMITTANCE,
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
)

SUPPORTED_IMAGE_RE = re.compile(
    r"\.(?:jpg|jpeg|gif|png|tga|tiff|bmp|pnm|hdr|exr|webp)$", re.IGNORECASE
)

_OPS = {"mix", "mixMap", "bumpMap", "normalMap", "disperse"}
_PARAM_NAMES = {
    PARAM_REFLECTANCE,
    PARAM_SPECULARITY,
    PARAM_TRANSMITTANCE,
    PARAM_RADIANCE,
    PARAM_INT_IOR,
    PARAM_EXT_IOR,
    PARAM_SCALE,
    PARAM_ROUGHNESS,
}

_TOKEN_RE = re.compile(
    r"""
    \s*(?:
      (?P<string>"[^"]*")
    | (?P<float>[0-9.][0-9.eE+\-]*)
    | (?P<ident>[A-Za-z_]+)
    | (?P<punct>[(){},:])
    )""",
    re.VERBOSE,
)


class _Tok:
    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value):
        self.kind = kind
        self.value = value

    def __repr__(self):
        return f"{self.kind}({self.value!r})"


def _tokenize(src: str) -> List[_Tok]:
    toks: List[_Tok] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m or m.end() == pos:
            rest = src[pos:].strip()
            if not rest:
                break
            raise MaterialError(f"invalid expression near {rest[:20]!r}")
        pos = m.end()
        if m.lastgroup == "string":
            s = m.group("string")[1:-1]
            if SUPPORTED_IMAGE_RE.search(s):
                toks.append(_Tok("texture", s))
            else:
                toks.append(_Tok("name", s))
        elif m.lastgroup == "float":
            try:
                toks.append(_Tok("float", float(m.group("float"))))
            except ValueError:
                raise MaterialError(f"invalid float value {m.group('float')!r}")
        elif m.lastgroup == "ident":
            toks.append(_Tok("ident", m.group("ident")))
        else:
            toks.append(_Tok(m.group("punct"), m.group("punct")))
    return toks


class _Parser:
    def __init__(self, toks: List[_Tok]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Optional[_Tok]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> _Tok:
        t = self.peek()
        if t is None:
            raise MaterialError("unexpected end of expression")
        self.i += 1
        return t

    def expect(self, kind: str) -> _Tok:
        t = self.next()
        if t.kind != kind:
            raise MaterialError(f"expected {kind!r}, got {t!r}")
        return t

    # expr := bxdf_spec | op_spec | material ref
    def parse_expr(self) -> ExprNode:
        t = self.peek()
        if t is None:
            raise MaterialError("empty material expression")
        if t.kind == "name":
            self.next()
            return MaterialRefNode(t.value)
        if t.kind != "ident":
            raise MaterialError(f"unexpected token {t!r}")
        if t.value in BXDF_NAMES:
            return self.parse_bxdf()
        if t.value in _OPS:
            return self.parse_op()
        raise MaterialError(f"invalid expression {t.value!r}")

    def parse_bxdf(self) -> BxdfNode:
        name = self.next().value
        self.expect("(")
        params: List[BxdfParamNode] = []
        if self.peek() and self.peek().kind != ")":
            while True:
                params.append(self.parse_param())
                if self.peek() and self.peek().kind == ",":
                    self.next()
                    continue
                break
        self.expect(")")
        return BxdfNode(BXDF_NAMES[name], tuple(params))

    def parse_param(self) -> BxdfParamNode:
        t = self.expect("ident")
        if t.value not in _PARAM_NAMES:
            raise MaterialError(f"invalid parameter name {t.value!r}")
        self.expect(":")
        name = t.value
        if name in (PARAM_REFLECTANCE, PARAM_SPECULARITY, PARAM_TRANSMITTANCE,
                    PARAM_RADIANCE):
            v = self.peek()
            if v and v.kind == "{":
                return BxdfParamNode(name, self.parse_float3())
            if v and v.kind == "texture":
                self.next()
                return BxdfParamNode(name, TextureNode(v.value))
            raise MaterialError(f"parameter {name!r} expects a float3 or texture")
        if name in (PARAM_INT_IOR, PARAM_EXT_IOR):
            v = self.next()
            if v.kind == "float":
                return BxdfParamNode(name, FloatNode(v.value))
            if v.kind == "name":
                return BxdfParamNode(name, MaterialNameNode(v.value))
            raise MaterialError(f"parameter {name!r} expects a float or IOR name")
        if name == PARAM_SCALE:
            return BxdfParamNode(name, FloatNode(self.expect("float").value))
        # roughness
        v = self.next()
        if v.kind == "float":
            return BxdfParamNode(name, FloatNode(v.value))
        if v.kind == "texture":
            return BxdfParamNode(name, TextureNode(v.value))
        raise MaterialError(f"parameter {name!r} expects a float or texture")

    def parse_float3(self) -> Vec3Node:
        self.expect("{")
        x = self.expect("float").value
        self.expect(",")
        y = self.expect("float").value
        self.expect(",")
        z = self.expect("float").value
        self.expect("}")
        return Vec3Node((x, y, z))

    def parse_op(self) -> ExprNode:
        op = self.next().value
        self.expect("(")
        if op == "mix":
            a = self.parse_expr()
            self.expect(",")
            b = self.parse_expr()
            self.expect(",")
            w = self.expect("float").value
            self.expect(")")
            return MixNode((a, b), w)
        if op == "mixMap":
            a = self.parse_expr()
            self.expect(",")
            b = self.parse_expr()
            self.expect(",")
            tex = self.expect("texture").value
            self.expect(")")
            return MixMapNode((a, b), TextureNode(tex))
        if op in ("bumpMap", "normalMap"):
            a = self.parse_expr()
            self.expect(",")
            tex = self.expect("texture").value
            self.expect(")")
            cls = BumpMapNode if op == "bumpMap" else NormalMapNode
            return cls(a, TextureNode(tex))
        # disperse(expr, intIOR: {r,g,b}, extIOR: {r,g,b})
        a = self.parse_expr()
        self.expect(",")
        t = self.expect("ident")
        if t.value != PARAM_INT_IOR:
            raise MaterialError("disperse expects an intIOR parameter")
        self.expect(":")
        int_ior = self.parse_float3()
        self.expect(",")
        t = self.expect("ident")
        if t.value != PARAM_EXT_IOR:
            raise MaterialError("disperse expects an extIOR parameter")
        self.expect(":")
        ext_ior = self.parse_float3()
        self.expect(")")
        return DisperseNode(a, int_ior, ext_ior)


def parse_expression(src: str) -> ExprNode:
    """Parse a material expression into an AST (ref: ParseExpression)."""
    p = _Parser(_tokenize(src))
    node = p.parse_expr()
    if p.peek() is not None:
        raise MaterialError(f"trailing tokens after expression: {p.peek()!r}")
    return node
