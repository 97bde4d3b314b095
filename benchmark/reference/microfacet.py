"""The plain reference for scenes of rough conductors, rough dielectrics and
textured diffuse surfaces: `pathtracer`'s integrator (NEE with MIS,
Russian roulette) with upstream polaris's microfacet BxDFs and its texture
sampler, in plain PyTorch.

Written from upstream's kernels, in the arithmetic of the renderer under
test at commit 6e410e3 (its association, its draws from `rng.py`), so that
a pixel here and there sees the same numbers:

- GGX (distribution_sampler.cl:16-112): D, Smith G1 and G, the half-vector
  sample theta = atan(a sqrt(u1 / (1 - u1))), phi = 2 pi u2 with
  sin(phi) = sqrt(1 - cos(phi)^2) (upstream's upper half of phi), and the
  reflection and refraction pdfs.
- roughConductor (rough_conductor.cl:9-78): roughness floored at
  MIN_ROUGHNESS 0.1 and remapped to a = r^2 (Disney); the reflection about
  the sampled h; f * D * G / (4 |i.n| |o.n|) * specularity, f the Schlick
  Fresnel of (extIOR, intIOR), or 1 where intIOR is 0. Every material node
  holds intIOR "Glass" and extIOR "Air" unless its expression sets them
  (defaults.go, compiler.go:330-357), so a conductor whose expression names
  no IOR takes the Fresnel of glass: f = 1 only for an explicit intIOR 0.
- roughDielectric, Walter'07 (rough_dielectric.cl:9-166): the IORs
  swapped where the ray leaves the surface from inside; reflection where
  total internal reflection or u1 <= F, else refraction about h; the
  reflected lobe f D G / (4 i.n o.n) * specularity, the refracted
  (1 - F) D G |eta_t^2 (i.h)(o.h) / ((i.n)(o.n)(eta_i i.h + eta_t o.h)^2)|
  * transmittance; pdf and eval pick the lobe by the side the ray comes
  from (i.n > 0: reflection), which for the shadow rays NEE counts (o.n > 0)
  is upstream's same-side test.
- the texture sampler (texture_sampler.cl): repeat wrap, the bilinear blend
  of the 2x2 footprint with the +1 texel clamped at the edge (not wrapped),
  bytes scaled by float32(1/255) after the fetch, no gamma; a Luminance8
  image serves each channel its one byte; roughness reads the red channel.
- the `.obj` `vt` rows, interpolated by the hit's barycentrics.

Departures from upstream, each the renderer's (docs/parity.md):

- Snell's law with eta^2, cos^2(theta_t) = 1 - eta^2 (1 - cos^2(theta_i))
  (upstream: eta; item 5), so the refracted direction is a unit vector;
  it is (eta i.n - sign(i.n) cos_t) h - eta i, with i.n about the surface
  normal, as the renderer writes it.
- No extra -sign(i.n) on a dielectric's reflection (dielectric.cl:36,
  item 2): reflections are 2 (i.h) h - i.
- The gradient floors (item 11): sin(theta) of the half-vector at least
  1e-6, cos^2 below 1e-12 taken as its limit (D, G1 of 0), a refraction
  cosine of at least 1e-6, every guarded quotient 0 under its threshold.

`load_scene` reads the `.obj`, its `.mtl` and its textures itself (Pillow
decodes the images) and refuses a material it does not render: diffuse
(reflectance a colour or a texture), roughConductor, roughDielectric
(specularity, transmittance and roughness colours or textures; IORs
numbers or names of `IORS`) and emissive (radiance a colour, scale). The
rest of what `harness/cells.py` asks of a reference module is
`pathtracer`'s (`Integrator`, `to_u8`, `primary_rays`, and `RefRenderer`
but for the sampling of a path). Every float tensor is of `dtype`: float32
is the reference, bfloat16 the control. `params` are `pathtracer`'s three
material rows, which `reference/adam.py::BOUNDS` clamps.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, fields
from typing import Dict, List

import numpy as np
import torch

from roofline.traverse import FLT_MAX, dot3

from . import pathtracer, rng
from .pathtracer import (  # noqa: F401  (Integrator, primary_rays, to_u8: the module's exports)
    EPS,
    INV_PI,
    LIGHT_EPS,
    PI,
    TWO_PI,
    Integrator,
    cos_hemisphere,
    luminance,
    maxcomp3,
    normalize3,
    power_heuristic,
    primary_rays,
    safe_div,
    tangent_basis,
    to_u8,
)
from .scene import EMISSIVE, RefScene, _assemble, _read_mtl

# float32 matrix products stay float32 on the card (no TF32)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DIFFUSE = "diffuse"
ROUGH_CONDUCTOR = "roughConductor"
ROUGH_DIELECTRIC = "roughDielectric"
KINDS = (DIFFUSE, ROUGH_CONDUCTOR, ROUGH_DIELECTRIC, EMISSIVE)

MIN_ROUGHNESS = 0.1
INV255 = float(np.float32(1.0 / 255.0))

# upstream's named IORs that the reference knows (ior.go)
IORS = {"air": 1.0002926, "water": 1.33157, "ice": 1.309, "glass": 1.51714, "diamond": 2.417}

# each BxDF's parameters (node.go's allowed parameters) and their defaults
# (defaults.go); a colour or roughness may be a texture
PARAMS = {
    DIFFUSE: ("reflectance",),
    ROUGH_CONDUCTOR: ("specularity", "roughness", "intIOR", "extIOR"),
    ROUGH_DIELECTRIC: ("specularity", "transmittance", "roughness", "intIOR", "extIOR"),
    EMISSIVE: ("radiance", "scale"),
}
DEFAULTS = dict(
    reflectance=(0.2, 0.2, 0.2), specularity=(1.0, 1.0, 1.0), transmittance=(1.0, 1.0, 1.0),
    radiance=(1.0, 1.0, 1.0), scale=1.0, roughness=0.1, intIOR=IORS["glass"], extIOR=IORS["air"],
)
TEXTURED = ("reflectance", "specularity", "transmittance", "roughness")
IMAGE = re.compile(r"\.(?:jpg|jpeg|gif|png|tga|tiff|bmp|pnm|webp)$", re.IGNORECASE)

_EXPR = re.compile(r"^([A-Za-z]+)\s*\((.*)\)$", re.S)
_PARAM = re.compile(
    r'\s*([A-Za-z]+)\s*:\s*(\{[^}]*\}|"[^"]*"|[-+0-9.eE]+)\s*(,|$)'
)


def parse_material(expr: str) -> dict:
    """One material expression as ``{"kind", <parameter>: value}``, each
    parameter of its BxDF there (a float3 tuple, a float, or a texture file
    name as a str). Anything the reference does not render raises."""
    text = expr.strip()
    m = _EXPR.match(text)
    kind = m.group(1) if m else None
    if kind not in PARAMS:
        raise ValueError(f"the reference renders no material {kind or text!r} ({text!r})")
    mat = {"kind": kind}
    mat.update({p: DEFAULTS[p] for p in PARAMS[kind]})
    body, at = m.group(2), 0
    while body[at:].strip():
        p = _PARAM.match(body, at)
        if p is None:
            raise ValueError(f"the reference reads no parameter list {body!r}")
        name, value = p.group(1), p.group(2)
        if name not in PARAMS[kind]:
            raise ValueError(f"{kind} takes no parameter {name!r}")
        if value.startswith("{"):
            mat[name] = tuple(float(x) for x in value[1:-1].split(","))
            if len(mat[name]) != 3:
                raise ValueError(f"{name}: {value} is no colour")
        elif value.startswith('"'):
            s = value[1:-1]
            if IMAGE.search(s):
                if name not in TEXTURED:
                    raise ValueError(f"the reference samples no texture for {name!r}")
                mat[name] = s
            elif name in ("intIOR", "extIOR") and s.lower() in IORS:
                mat[name] = IORS[s.lower()]
            else:
                raise ValueError(f"{name}: the reference knows no {s!r}")
        else:
            mat[name] = float(value)
        at = p.end()
    return mat


def read_texture(path: str) -> np.ndarray:
    """The image's bytes as uint8 (H, W, 3), rows from the top: RGB of its
    RGBA conversion, or its one luminance byte in each channel."""
    from PIL import Image

    with Image.open(path) as img:
        if img.mode in ("L", "I;16", "I"):
            lum = np.asarray(img.convert("L"), dtype=np.uint8)
            return np.ascontiguousarray(np.repeat(lum[..., None], 3, axis=-1))
        if img.mode == "F":
            raise ValueError(f"{path}: the reference samples no float image")
        return np.ascontiguousarray(np.asarray(img.convert("RGBA"), dtype=np.uint8)[..., :3])


@dataclass
class MicrofacetScene(RefScene):
    uvs: np.ndarray  # (T, 3, 2) float32, one per vertex (0 where the face has none)
    materials: List[dict]  # per material row, `parse_material`'s dict
    textures: List[np.ndarray]  # uint8 (H, W, 3), indexed by the materials' texture names
    texture_names: List[str]


def _index(tok: str, n: int) -> int:
    i = int(tok)
    return i - 1 if i > 0 else n + i


def read_obj(path: str) -> MicrofacetScene:
    """The scene of a Wavefront `.obj`, its `.mtl` and the textures they
    name: triangles and quads (a quad split 0-1-2, 0-2-3), `v`, `vn`,
    `vt`, `usemtl`, `mtllib` and the `camera_*` lines. Anything else
    raises. `scene.py::read_obj` with the `vt` rows kept: that file stays
    as it is, its bytes being part of the compiled-scene cache's key."""
    verts: List[List[float]] = []
    norms: List[List[float]] = []
    uvl: List[List[float]] = []
    tris, tri_norms, tri_uvs, tri_mat_names = [], [], [], []
    mtl: Dict[str, str] = {}
    cam = dict(fov=45.0, eye=[0, 0, 0], look=[0, 0, -1], up=[0, 1, 0])
    cur = None
    base = os.path.dirname(path)
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok or tok[0].startswith("#"):
                continue
            cmd = tok[0]
            if cmd == "v":
                verts.append([float(x) for x in tok[1:4]])
            elif cmd == "vn":
                norms.append([float(x) for x in tok[1:4]])
            elif cmd == "vt":
                uvl.append([float(x) for x in tok[1:3]])
            elif cmd == "f":
                idx = [t.split("/") for t in tok[1:]]
                if len(idx) not in (3, 4):
                    raise ValueError(f"face of {len(idx)} vertices")
                p = np.asarray([verts[_index(i[0], len(verts))] for i in idx], np.float32)
                uv = np.zeros((len(idx), 2), np.float32)
                if len(idx[0]) > 1 and idx[0][1]:
                    uv = np.asarray([uvl[_index(i[1], len(uvl))] for i in idx], np.float32)
                if len(idx[0]) > 2 and idx[0][2]:
                    n = np.asarray([norms[_index(i[2], len(norms))] for i in idx], np.float32)
                else:
                    fn = np.cross(p[1] - p[0], p[2] - p[0])
                    fn = fn / np.linalg.norm(fn)
                    n = np.repeat(fn[None, :], len(idx), axis=0).astype(np.float32)
                for sel in ([0, 1, 2],) if len(idx) == 3 else ([0, 1, 2], [0, 2, 3]):
                    tris.append(p[sel])
                    tri_norms.append(n[sel])
                    tri_uvs.append(uv[sel])
                    tri_mat_names.append(cur)
            elif cmd == "usemtl":
                cur = tok[1]
            elif cmd == "mtllib":
                mtl.update(_read_mtl(os.path.join(base, tok[1])))
            elif cmd == "camera_fov":
                cam["fov"] = float(tok[1])
            elif cmd in ("camera_eye", "camera_look", "camera_up"):
                cam[cmd[7:]] = [float(x) for x in tok[1:4]]
            elif cmd in ("o", "g", "s"):
                continue
            else:
                raise ValueError(f"the reference reads no .obj line {line!r}")
    names = list(dict.fromkeys(tri_mat_names))
    mats = [parse_material(mtl[n]) for n in names]
    tex_names = list(dict.fromkeys(
        m[k] for m in mats for k in TEXTURED if isinstance(m.get(k), str)
    ))
    textures = [read_texture(os.path.join(base, t)) for t in tex_names]
    rows = [
        (m["kind"], _colour(m, "reflectance"), _colour(m, "radiance"), float(m.get("scale", 0.0)))
        for m in mats
    ]
    scene = _assemble(
        np.stack(tris), np.stack(tri_norms),
        np.asarray([names.index(n) for n in tri_mat_names], np.int64), rows, cam,
    )
    return MicrofacetScene(
        **{f.name: getattr(scene, f.name) for f in fields(RefScene)},
        uvs=np.stack(tri_uvs).astype(np.float32), materials=mats, textures=textures,
        texture_names=tex_names,
    )


def _colour(mat: dict, key: str):
    """A material's constant colour ``key``: 0 where its BxDF has none; the
    default where a texture stands in for it (the program keeps one there)."""
    if key not in mat:
        return [0.0, 0.0, 0.0]
    v = mat[key]
    return list(DEFAULTS[key]) if isinstance(v, str) else list(v)


def load_scene(config: dict, bench_dir: str) -> MicrofacetScene:
    """The configuration's `.obj` scene under ``bench_dir``."""
    spec = config["scene"]
    if "obj" not in spec:
        raise ValueError(f"the microfacet reference reads an .obj scene, not {spec}")
    return read_obj(os.path.join(bench_dir, spec["obj"]))


# ------------------------------------------------------------------ texture


def sample_texture(tex: torch.Tensor, uv: torch.Tensor, dtype) -> torch.Tensor:
    """Bilinear sample [..., 3] of the uint8 image ``tex`` (H, W, 3) at
    ``uv``: repeat wrap, the +1 texel clamped to the last column and row,
    bytes scaled after the fetch."""
    h, w = tex.shape[0], tex.shape[1]
    su = (uv[..., 0] - torch.floor(uv[..., 0])) * float(w)
    sv = (uv[..., 1] - torch.floor(uv[..., 1])) * float(h)
    # a truncating cast; the clip catches su == w
    tx = torch.clamp(su.to(torch.int32).to(torch.int64), 0, w - 1)
    ty = torch.clamp(sv.to(torch.int32).to(torch.int64), 0, h - 1)
    cx = (su - tx.to(dtype))[..., None]
    cy = (sv - ty.to(dtype))[..., None]
    bx = torch.clamp(tx + 1, max=w - 1)
    by = torch.clamp(ty + 1, max=h - 1)

    def texel(y, x):
        return tex[y, x].to(dtype) * INV255

    tl, tr, bl, br = texel(ty, tx), texel(ty, bx), texel(by, tx), texel(by, bx)
    return (tl * (1 - cy) + bl * cy) * (1 - cx) + (tr * (1 - cy) + br * cy) * cx


# ------------------------------------------------------------------ GGX


def ggx_d(alpha, n, m):
    """GGX normal distribution (distribution_sampler.cl:36-50)."""
    c = dot3(n, m)
    c2 = c * c
    tan2 = safe_div(1.0 - c2, c2, 1e-12)
    a2 = alpha * alpha
    d = safe_div(a2, PI * c2 * c2 * (a2 + tan2) * (a2 + tan2), 1e-12)
    d = torch.where(c2 > 1e-12, d, torch.zeros_like(d))
    return torch.where(c <= 0.0, torch.zeros_like(d), d)


def ggx_g1(alpha, v, n, m):
    """Smith G1 (distribution_sampler.cl:17-31)."""
    c = dot3(n, v)
    c2 = c * c
    tan2 = safe_div(1.0 - c2, c2, 1e-12)
    g = 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))
    g = torch.where(c2 > 1e-12, g, torch.zeros_like(g))
    return torch.where(c * dot3(m, v) <= 0.0, torch.zeros_like(g), g)


def ggx_g(alpha, i, o, n, m):
    return ggx_g1(alpha, i, n, m) * ggx_g1(alpha, o, n, m)


def ggx_sample_h(alpha, n, u1, u2):
    """A GGX half-vector about ``n`` (distribution_sampler.cl:53-72)."""
    tu, tv = tangent_basis(n)
    theta = torch.atan(alpha * torch.sqrt(u1 / torch.clamp(1.0 - u1, min=1e-9)))
    cos_t = torch.cos(theta)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=1e-12))
    cos_p = torch.cos(TWO_PI * u2)
    sin_p = torch.sqrt(torch.clamp(1.0 - cos_p * cos_p, min=0.0))
    return normalize3(
        tu * (sin_t * cos_p)[..., None] + tv * (sin_t * sin_p)[..., None] + n * cos_t[..., None]
    )


def reflection_pdf(alpha, o, n, h):
    """D |h.n| / (4 |o.h|) (distribution_sampler.cl:74-84)."""
    return safe_div(ggx_d(alpha, n, h) * torch.abs(dot3(n, h)), 4.0 * torch.abs(dot3(o, h)), 1e-12)


def refraction_pdf(alpha, eta_i, eta_t, i, o, n, h):
    """(distribution_sampler.cl:86-97)"""
    i_h, o_h = torch.abs(dot3(i, h)), torch.abs(dot3(o, h))
    return safe_div(
        ggx_d(alpha, n, h) * torch.abs(dot3(h, n)) * o_h * eta_t * eta_t,
        (eta_i * i_h + eta_t * o_h) ** 2, 1e-12,
    )


def fresnel(eta_i, eta_t, i_dot_n):
    """Schlick (fresnel.cl:8-17)."""
    eta = eta_i / torch.where(eta_t == 0.0, torch.ones_like(eta_t), eta_t)
    r0 = ((1.0 - eta) ** 2) / ((1.0 + eta) ** 2)
    c = 1.0 - torch.abs(i_dot_n)
    return r0 + (1.0 - r0) * c * c * c * c * c


def _abs_quotient(num, den, thresh):
    ok = torch.abs(den) > thresh
    return torch.abs(torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), torch.zeros_like(num)))


def refraction_value(alpha, eta_i, eta_t, f, i, o, n, h, i_dot_n):
    """(1 - F) D G |eta_t^2 (i.h)(o.h) / ((i.n)(o.n)(eta_i i.h + eta_t o.h)^2)|
    (rough_dielectric.cl:60-96)."""
    i_h, o_h = torch.abs(dot3(i, h)), torch.abs(dot3(o, h))
    focus = _abs_quotient(
        eta_t * eta_t * i_h * o_h, i_dot_n * dot3(o, n) * (eta_i * i_h + eta_t * o_h) ** 2, 1e-12
    )
    return (1.0 - f) * ggx_d(alpha, n, h) * ggx_g(alpha, i, o, n, h) * focus


def reflection_value(alpha, f, i, o, n, h, i_dot_n):
    """f D G / (4 (i.n)(o.n)) (rough_conductor.cl:25-41)."""
    return safe_div(f * ggx_d(alpha, n, h) * ggx_g(alpha, i, o, n, h), 4.0 * i_dot_n * dot3(o, n), 1e-12)


# ------------------------------------------------------------------ renderer


class RefRenderer(pathtracer.RefRenderer):
    """`pathtracer.RefRenderer` (traversal, lights, camera, `params`,
    `render_frames`, `loss`) with the microfacet BxDFs and textures in its
    `sample`."""

    def __init__(self, scene: MicrofacetScene, bvh, device, dtype=torch.float32):
        super().__init__(scene, bvh, device, dtype)
        dev = self.device

        def f(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device=dev, dtype=dtype)

        mats = scene.materials
        self.uvs = f(scene.uvs.reshape(-1, 6))
        self.kind = torch.tensor([KINDS.index(m["kind"]) for m in mats], device=dev)
        self.rows = {
            k: f([_colour(m, k) for m in mats]) for k in ("specularity", "transmittance")
        }
        for k in ("roughness", "intIOR", "extIOR"):
            self.rows[k] = f([m[k] if isinstance(m.get(k), float) else DEFAULTS[k] for m in mats])
        self.tex_of = {
            k: torch.tensor([scene.texture_names.index(m[k]) if isinstance(m.get(k), str) else -1
                             for m in mats], device=dev)
            for k in TEXTURED
        }
        self.tex_used = {k: sorted({int(x) for x in v.tolist() if x >= 0}) for k, v in self.tex_of.items()}
        self.textures = [torch.from_numpy(t).to(dev) for t in scene.textures]

    def _field(self, const, key, m, uv):
        """Each lane's ``key`` of its material ``m``: the constant row, or the
        texture's sample where the material has one (roughness: red)."""
        idx = self.tex_of[key].index_select(0, m)
        for k in self.tex_used[key]:
            s = sample_texture(self.textures[k], uv, self.dtype)
            if const.dim() == 1:
                const = torch.where(idx == k, s[..., 0], const)
            else:
                const = torch.where((idx == k)[..., None], s, const)
        return const

    def _material(self, P, m, uv):
        r = self.rows
        rough = torch.clamp(self._field(r["roughness"].index_select(0, m), "roughness", m, uv),
                            MIN_ROUGHNESS, 1.0)
        return dict(
            kind=self.kind[m],
            kd=self._field(P["mat_reflectance"].index_select(0, m), "reflectance", m, uv),
            ks=self._field(r["specularity"].index_select(0, m), "specularity", m, uv),
            tf=self._field(r["transmittance"].index_select(0, m), "transmittance", m, uv),
            alpha=rough * rough, int_ior=r["intIOR"].index_select(0, m),
            ext_ior=r["extIOR"].index_select(0, m),
        )

    @staticmethod
    def _iors(mat, i_dot_n):
        """(eta_i, eta_t): swapped where the ray leaves from inside
        (dielectric.cl:18-24)."""
        inside = i_dot_n < 0.0
        return (torch.where(inside, mat["int_ior"], mat["ext_ior"]),
                torch.where(inside, mat["ext_ior"], mat["int_ior"]))

    @staticmethod
    def _conductor_f(mat, i_dot_n):
        f = fresnel(mat["ext_ior"], mat["int_ior"], i_dot_n)
        return torch.where(mat["int_ior"] != 0.0, f, torch.ones_like(f))

    def _sample_bxdf(self, mat, n, i, u1, u2):
        """(out, pdf, value) of each lane's BxDF (bxdf.cl:13-40)."""
        kind, alpha = mat["kind"], mat["alpha"]
        i_dot_n = dot3(i, n)
        # diffuse (diffuse.cl:13-21)
        out = cos_hemisphere(n, u1, u2)
        pdf = dot3(n, out) * INV_PI
        val = mat["kd"] * INV_PI

        h = ggx_sample_h(alpha, n, u1, u2)
        refl = (2.0 * dot3(i, h))[..., None] * h - i
        refl_h = normalize3(i + refl)

        # roughConductor (rough_conductor.cl:9-41)
        rc_pdf = reflection_pdf(alpha, refl, n, h)
        rc_val = reflection_value(alpha, self._conductor_f(mat, i_dot_n), i, refl, n, refl_h,
                                  i_dot_n)[..., None] * mat["ks"]

        # roughDielectric (rough_dielectric.cl:9-96)
        eta_i, eta_t = self._iors(mat, i_dot_n)
        eta = eta_i / torch.where(eta_t == 0.0, torch.ones_like(eta_t), eta_t)
        f = fresnel(eta_i, eta_t, i_dot_n)
        cos_t2 = 1.0 + eta * eta * (i_dot_n * i_dot_n - 1.0)
        tir = cos_t2 <= 0.0
        reflect = tir | (u1 <= f)
        cos_t = torch.sqrt(torch.clamp(cos_t2, min=1e-12))
        rd_refl_pdf = torch.where(tir, torch.ones_like(f), reflection_pdf(alpha, refl, n, refl_h))
        rd_refl_val = reflection_value(alpha, f, i, refl, n, refl_h, i_dot_n)[..., None] * mat["ks"]
        refr = (eta * i_dot_n - torch.sign(i_dot_n) * cos_t)[..., None] * h - eta[..., None] * i
        refr_h = normalize3(-(eta_i[..., None] * i + eta_t[..., None] * refr))
        rd_refr_pdf = refraction_pdf(alpha, eta_i, eta_t, i, refr, n, refr_h)
        rd_refr_val = refraction_value(alpha, eta_i, eta_t, f, i, refr, n, refr_h,
                                       i_dot_n)[..., None] * mat["tf"]
        rd_out = torch.where(reflect[..., None], refl, refr)
        rd_pdf = torch.where(reflect, rd_refl_pdf, rd_refr_pdf)
        rd_val = torch.where(reflect[..., None], rd_refl_val, rd_refr_val)

        rc, rd = kind == KINDS.index(ROUGH_CONDUCTOR), kind == KINDS.index(ROUGH_DIELECTRIC)
        out = torch.where(rc[..., None], refl, torch.where(rd[..., None], rd_out, out))
        pdf = torch.where(rc, rc_pdf, torch.where(rd, rd_pdf, pdf))
        val = torch.where(rc[..., None], rc_val, torch.where(rd[..., None], rd_val, val))
        return out, pdf, val

    def _pdf_and_eval(self, mat, n, i, o):
        """(pdf, value) of each lane's BxDF for the direction ``o`` (NEE)."""
        kind, alpha = mat["kind"], mat["alpha"]
        i_dot_n = dot3(i, n)
        pdf = torch.where(kind == KINDS.index(DIFFUSE), dot3(n, o) * INV_PI, torch.zeros_like(i_dot_n))
        val = torch.where((kind == KINDS.index(DIFFUSE))[..., None], mat["kd"] * INV_PI,
                          torch.zeros_like(mat["kd"]))

        h = normalize3(i + o)
        r_pdf = reflection_pdf(alpha, o, n, h)
        rc = kind == KINDS.index(ROUGH_CONDUCTOR)
        rc_val = reflection_value(alpha, self._conductor_f(mat, i_dot_n), i, o, n, h,
                                  i_dot_n)[..., None] * mat["ks"]

        eta_i, eta_t = self._iors(mat, i_dot_n)
        f = fresnel(eta_i, eta_t, i_dot_n)
        refr_h = normalize3(-(eta_i[..., None] * i + eta_t[..., None] * o))
        front = i_dot_n > 0.0
        rd_pdf = torch.where(front, r_pdf, refraction_pdf(alpha, eta_i, eta_t, i, o, n, refr_h))
        rd_val = torch.where(
            front[..., None], reflection_value(alpha, f, i, o, n, h, i_dot_n)[..., None] * mat["ks"],
            refraction_value(alpha, eta_i, eta_t, f, i, o, n, refr_h, i_dot_n)[..., None] * mat["tf"],
        )
        rd = kind == KINDS.index(ROUGH_DIELECTRIC)
        pdf = torch.where(rc, r_pdf, torch.where(rd, rd_pdf, pdf))
        val = torch.where(rc[..., None], rc_val, torch.where(rd[..., None], rd_val, val))
        return pdf, val

    def sample(self, P, seed, pix, px, py, s, width, height, frustum, eye, opt: Integrator):
        """Radiance [n, 3] of sample ``s`` of pixels ``pix`` (full-frame
        indices, with coordinates ``px``, ``py``)."""
        dt, dev = self.dtype, self.device
        n = pix.shape[0]

        def uni(U):
            return lambda stream: U(stream).to(dt)

        o, d = primary_rays(seed, pix, px, py, s, width, height, frustum, eye, dt)
        throughput = torch.ones((n, 3), dtype=dt, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        radiance = torch.zeros((n, 3), dtype=dt, device=dev)
        maxt = torch.full((n,), FLT_MAX, dtype=torch.float32, device=dev)
        ke_all, sc_all = P["mat_radiance"], P["mat_scale"]
        L = self.num_lights
        for b in range(opt.num_bounces):
            U = uni(rng.make_uniform(seed, pix, s, b))
            hit = self.tr.closest(o.detach(), d.detach(), maxt, alive)
            t = torch.where(hit.mask, hit.t, torch.zeros_like(hit.t))
            i = -d
            point = o + t[..., None] * d
            w = 1.0 - hit.u - hit.v
            tn = self.normals[hit.tri]
            normal = normalize3(
                w[..., None] * tn[..., 0:3] + hit.u[..., None] * tn[..., 3:6]
                + hit.v[..., None] * tn[..., 6:9]
            )
            tuv = self.uvs[hit.tri]
            uv = w[..., None] * tuv[..., 0:2] + hit.u[..., None] * tuv[..., 2:4] + hit.v[..., None] * tuv[..., 4:6]
            m = self.tri_mat[hit.tri]
            mat = self._material(P, m, uv)
            is_emis = self.is_emissive[m]
            emit = hit.mask & is_emis & (dot3(i, normal) > 0.0)
            radiance = radiance + torch.where(
                emit[..., None], throughput * sc_all.index_select(0, m)[..., None] * ke_all.index_select(0, m),
                torch.zeros_like(throughput),
            )

            shade = hit.mask & ~is_emis
            rr_on = b >= opt.min_bounces_for_rr
            rr_p = torch.clamp(torch.clamp(luminance(throughput), max=0.5), min=0.01)
            survive = torch.ones_like(shade) if not rr_on else (rr_p >= U(rng.STREAM_RR))
            if rr_on:
                boost = shade & survive
                throughput = torch.where(boost[..., None], throughput / rr_p[..., None], throughput)
            shade = shade & survive

            b_out, b_pdf, b_val = self._sample_bxdf(mat, normal, i, U(rng.STREAM_BXDF_U), U(rng.STREAM_BXDF_V))
            displace = torch.sign(dot3(normal, b_out))
            next_o = point + (displace * EPS)[..., None] * normal
            shadow_o = point + EPS * normal

            # next-event estimation on a uniformly picked light
            l_idx = torch.clamp((U(rng.STREAM_LIGHT_SELECT).float() * L).to(torch.int32), 0, L - 1).long()
            sel_pdf = torch.full_like(b_pdf, 1.0 / L)
            lv0, le1, le2, ln = self.l_v0[l_idx], self.l_e1[l_idx], self.l_e2[l_idx], self.l_n[l_idx]
            r1s = torch.sqrt(torch.clamp(U(rng.STREAM_LIGHT_U), min=0.0))
            u2 = U(rng.STREAM_LIGHT_V)
            ru, rv = (1.0 - u2) * r1s, u2 * r1s
            l_point = lv0 + ru[..., None] * le1 + rv[..., None] * le2
            l_normal = (
                (1.0 - ru - rv)[..., None] * ln[..., 0, :] + ru[..., None] * ln[..., 1, :]
                + rv[..., None] * ln[..., 2, :]
            )
            to_light = l_point - point
            sq_raw = dot3(to_light, to_light)
            e_dist = torch.sqrt(torch.clamp(sq_raw, min=1e-20))
            e_dir = to_light / e_dist[..., None]
            n_dot_out = dot3(l_normal, -e_dir)
            area = self.l_area[l_idx]
            e_pdf = torch.where(n_dot_out > 0.0, 1.0 / torch.clamp(area, min=1e-20), torch.zeros_like(area))
            lm = self.l_mat[l_idx]
            inv_sq = safe_div(torch.ones_like(sq_raw), sq_raw, 1e-8)
            e_val = torch.where(
                (n_dot_out > 0.0)[..., None],
                (sc_all.index_select(0, lm) * n_dot_out * inv_sq)[..., None] * ke_all.index_select(0, lm),
                torch.zeros_like(throughput),
            )
            bxdf_e_pdf, b_eval = self._pdf_and_eval(mat, normal, i, e_dir)
            e_weight = power_heuristic(e_pdf, bxdf_e_pdf)
            b_weight = power_heuristic(b_pdf, self._light_pdf(point, l_idx, b_out))
            n_dot_e = torch.clamp(dot3(normal, e_dir), min=0.0)
            valid_e = (maxcomp3(e_val) > 0.0) & (e_pdf > 0.0) & (n_dot_e > 0.0)
            e_sample = e_val * b_eval * throughput * safe_div(e_weight * n_dot_e, e_pdf * sel_pdf, 1e-12)[..., None]
            occl = shade & valid_e & (maxcomp3(e_sample) > 0.0)
            occl_maxt = torch.where(occl, e_dist - LIGHT_EPS, torch.zeros_like(e_dist))

            tp_mul = b_val * (b_weight * torch.abs(dot3(normal, b_out)))[..., None]
            alive = shade & (maxcomp3(tp_mul) > 0.0) & (b_pdf > 1e-12)
            inv_pdf = safe_div(torch.ones_like(b_pdf), b_pdf, 1e-12)
            throughput = torch.where(alive[..., None], throughput * tp_mul * inv_pdf[..., None], throughput)

            blocked = self.tr.any_hit(shadow_o.detach(), e_dir.detach(), occl_maxt.detach().float(), occl)
            radiance = radiance + torch.where((occl & ~blocked)[..., None], e_sample, torch.zeros_like(e_sample))
            o, d = next_o, b_out
        return radiance
