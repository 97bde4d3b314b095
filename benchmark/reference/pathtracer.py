"""The plain reference path tracer: unidirectional path tracing with
next-event estimation weighted by the power heuristic and Russian roulette,
for scenes of diffuse and emissive triangles, in plain PyTorch.

It follows upstream polaris's integrator (pt_integrator.cl:17-211: shade,
NEE with MIS, RR after `min_bounces_for_rr` bounces with survival
`clamp(luminance(throughput), 0.01, 0.5)`; camera.cl:5-58: tent-filtered
primary rays; emissive_sampler.cl: uniform light pick, sqrt-warped point on
the light triangle; hdr.cl:5-28: Reinhard and gamma 1/2.2) in the
arithmetic of the renderer under test at commit 70823ee, with its
counter-based random numbers (`rng.py`), so that a pixel here and there
sees the same draws. Intersection is its own: the benchmark's BVH
(`roofline/bvh.py`) walked by `roofline/traverse.py`, with the quotient
Moller-Trumbore test.

It is the reference of every configuration that names no other, and
exports what `harness/cells.py` asks of a reference module; `load_scene`
reads the scene with `scene.py`. Every float tensor is of `dtype`: float32
is the reference, bfloat16 the control. The material rows (`reflectance`,
`radiance`, `scale`) may carry gradients; hit geometry and discrete choices
do not.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from roofline.bvh import Bvh
from roofline.traverse import FLT_MAX, Traverser, cross3, dot3

from . import rng
from .scene import EMISSIVE, RefScene, read_obj, terrain_scene

PI = 3.14159265358979323846
INV_PI = 1.0 / PI
TWO_PI = 2.0 * PI
EPS = 1e-5
LIGHT_EPS = EPS * 1e3


@dataclass
class Integrator:
    num_bounces: int = 5
    min_bounces_for_rr: int = 3
    exposure: float = 1.2


def normalize3(v, eps=1e-20):
    return v / torch.sqrt(torch.clamp(dot3(v, v), min=eps))[..., None]


def safe_div(num, den, thresh):
    ok = den > thresh
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), torch.zeros_like(num))


def maxcomp3(v):
    return torch.maximum(v[..., 0], torch.maximum(v[..., 1], v[..., 2]))


def luminance(v):
    return 0.2126 * v[..., 0] + 0.7152 * v[..., 1] + 0.0722 * v[..., 2]


def power_heuristic(a, b):
    a2 = a * a
    denom = a2 + b * b
    return torch.where(denom > 0.0, a2 / torch.clamp(denom, min=1e-30), torch.zeros_like(a2))


def tent(s):
    return torch.where(
        s < 0.5,
        torch.sqrt(torch.clamp(2.0 * s, min=0.0)) - 0.5,
        1.5 - torch.sqrt(torch.clamp(2.0 - 2.0 * s, min=0.0)),
    )


def tangent_basis(n):
    use_z = torch.abs(n[..., 2]) < 0.999
    zero = torch.zeros_like(n[..., 0])
    one = torch.ones_like(zero)
    ref = torch.stack(
        [torch.where(use_z, zero, one), zero, torch.where(use_z, one, zero)], dim=-1
    )
    u = normalize3(cross3(ref, n))
    return u, cross3(n, u)


def cos_hemisphere(n, u1, u2):
    rd = torch.sqrt(torch.clamp(u1, min=0.0))
    phi = TWO_PI * u2
    tu, tv = tangent_basis(n)
    return normalize3(
        tu * (rd * torch.cos(phi))[..., None]
        + tv * (rd * torch.sin(phi))[..., None]
        + n * torch.sqrt(torch.clamp(1.0 - u1, min=0.0))[..., None]
    )


def tonemap(accum, sample_weight, exposure):
    hdr = accum * (sample_weight * exposure)
    return torch.clamp((hdr / (hdr + 1.0)) ** (1.0 / 2.2), 0.0, 1.0)


def to_u8(accum, spp: int, exposure: float):
    """The frame as the user gets it: weight 1/spp times the exposure, one
    float32 product, then Reinhard, gamma, and truncation to 0..255."""
    scale = float(np.float32(1.0 / spp) * np.float32(exposure))
    return (torch.clamp(tonemap(accum, scale, 1.0), 0.0, 1.0) * 255.0).to(torch.uint8)


def primary_rays(seed, pix, px, py, s, width, height, frustum, eye, dtype):
    """Tent-filtered primary rays through pixels (``px``, ``py``) of sample
    ``s``: the bilinear mix of the four frustum corner rays."""
    U0 = rng.make_uniform(seed, pix, s, 0)
    ox = tent(U0(rng.STREAM_LENS_U).to(dtype))
    oy = tent(U0(rng.STREAM_LENS_V).to(dtype))
    tx = (px.to(dtype) + ox) / width
    ty = (py.to(dtype) + oy) / height
    tl, tr, bl, br = frustum[0], frustum[1], frustum[2], frustum[3]
    left = tl[None, :] + (bl - tl)[None, :] * ty[..., None]
    right = tr[None, :] + (br - tr)[None, :] * ty[..., None]
    d = normalize3(left + (right - left) * tx[..., None])
    return eye.expand_as(d).contiguous(), d


def load_scene(config: dict, bench_dir: str) -> RefScene:
    """The scene of a configuration: its `.obj` under ``bench_dir``, or the
    terrain of ``terrain_grid`` cells a side (`scene.py`)."""
    spec = config["scene"]
    if "obj" in spec:
        return read_obj(os.path.join(bench_dir, spec["obj"]))
    return terrain_scene(int(spec["terrain_grid"]))


class RefRenderer:
    def __init__(self, scene: RefScene, bvh: Bvh, device, dtype=torch.float32):
        self.scene, self.device, self.dtype = scene, torch.device(device), dtype
        self.tr = Traverser(bvh, scene.v0, scene.e1, scene.e2, device, dtype)

        def f(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

        self.normals = f(scene.normals.reshape(-1, 9))
        self.tri_mat = torch.from_numpy(scene.tri_mat).to(device)
        self.is_emissive = torch.tensor([k == EMISSIVE for k in scene.mat_kind], device=device)
        lt = scene.light_tri
        self.l_v0, self.l_e1, self.l_e2 = f(scene.v0[lt]), f(scene.e1[lt]), f(scene.e2[lt])
        self.l_n = f(scene.normals[lt])
        self.l_area = f(scene.light_area)
        self.l_mat = torch.from_numpy(scene.tri_mat[lt]).to(device)
        self.num_lights = int(lt.size)

    def params(self, requires_grad: bool = False) -> Dict[str, torch.Tensor]:
        """The material rows, as leaves of their own."""
        s = self.scene
        out = {
            "mat_reflectance": s.reflectance, "mat_radiance": s.radiance, "mat_scale": s.scale,
        }
        return {
            k: torch.from_numpy(v.copy()).to(self.device, self.dtype).requires_grad_(requires_grad)
            for k, v in out.items()
        }

    def camera(self, width: int, height: int):
        fr = torch.from_numpy(self.scene.frustum(width, height)).to(self.device, self.dtype)
        eye = torch.from_numpy(self.scene.eye).to(self.device, self.dtype)
        return fr, eye

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
        kd_all, ke_all, sc_all = P["mat_reflectance"], P["mat_radiance"], P["mat_scale"]
        L = self.num_lights
        for b in range(opt.num_bounces):
            U = uni(rng.make_uniform(seed, pix, s, b))
            hit = self.tr.closest(o.detach(), d.detach(), maxt, alive)
            t = torch.where(hit.mask, hit.t, torch.zeros_like(hit.t))
            in_dir = -d
            point = o + t[..., None] * d
            w = 1.0 - hit.u - hit.v
            tn = self.normals[hit.tri]
            normal = normalize3(
                w[..., None] * tn[..., 0:3] + hit.u[..., None] * tn[..., 3:6]
                + hit.v[..., None] * tn[..., 6:9]
            )
            m = self.tri_mat[hit.tri]
            kd = kd_all.index_select(0, m)
            is_emis = self.is_emissive[m]
            i_dot_n = dot3(in_dir, normal)
            emit = hit.mask & is_emis & (i_dot_n > 0.0)
            ke = ke_all.index_select(0, m)
            radiance = radiance + torch.where(
                emit[..., None], throughput * sc_all.index_select(0, m)[..., None] * ke,
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

            b_out = cos_hemisphere(normal, U(rng.STREAM_BXDF_U), U(rng.STREAM_BXDF_V))
            b_pdf = dot3(normal, b_out) * INV_PI
            b_val = kd * INV_PI
            displace = torch.sign(dot3(normal, b_out))
            next_o = point + (displace * EPS)[..., None] * normal
            shadow_o = point + EPS * normal

            # next-event estimation on a uniformly picked light
            l_idx = torch.clamp((U(rng.STREAM_LIGHT_SELECT).float() * L).to(torch.int32), 0, L - 1).long()
            sel_pdf = torch.full_like(b_pdf, 1.0 / L)
            lv0, le1, le2 = self.l_v0[l_idx], self.l_e1[l_idx], self.l_e2[l_idx]
            ln = self.l_n[l_idx]
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
            diffuse = ~is_emis
            bxdf_e_pdf = torch.where(diffuse, dot3(normal, e_dir) * INV_PI, torch.zeros_like(b_pdf))
            e_weight = power_heuristic(e_pdf, bxdf_e_pdf)
            e_bxdf_pdf = self._light_pdf(point, l_idx, b_out)
            b_weight = power_heuristic(b_pdf, e_bxdf_pdf)
            n_dot_e = torch.clamp(dot3(normal, e_dir), min=0.0)
            valid_e = (maxcomp3(e_val) > 0.0) & (e_pdf > 0.0) & (n_dot_e > 0.0)
            b_eval = torch.where(diffuse[..., None], kd * INV_PI, torch.zeros_like(kd))
            e_sample = e_val * b_eval * throughput * safe_div(e_weight * n_dot_e, e_pdf * sel_pdf, 1e-12)[..., None]
            occl = shade & valid_e & (maxcomp3(e_sample) > 0.0)
            occl_maxt = torch.where(occl, e_dist - LIGHT_EPS, torch.zeros_like(e_dist))

            tp_mul = b_val * (b_weight * torch.abs(dot3(normal, b_out)))[..., None]
            alive = shade & (maxcomp3(tp_mul) > 0.0) & (b_pdf > 1e-12)
            inv_pdf = safe_div(torch.ones_like(b_pdf), b_pdf, 1e-12)
            throughput = torch.where(alive[..., None], throughput * tp_mul * inv_pdf[..., None], throughput)

            blocked = self.tr.any_hit(
                shadow_o.detach(), e_dir.detach(), occl_maxt.detach().float(), occl
            )
            radiance = radiance + torch.where((occl & ~blocked)[..., None], e_sample, torch.zeros_like(e_sample))
            o, d = next_o, b_out
        return radiance

    def _light_pdf(self, point, l_idx, out_dir):
        """Density of the light sampler at ``out_dir`` (solid angle)."""
        v0, e1, e2 = self.l_v0[l_idx], self.l_e1[l_idx], self.l_e2[l_idx]
        pvec = cross3(out_dir, e2)
        det = dot3(e1, pvec)
        inv_det = 1.0 / torch.where(torch.abs(det) < EPS, torch.ones_like(det), det)
        tvec = point - v0
        u = dot3(tvec, pvec) * inv_det
        qvec = cross3(tvec, e1)
        v = dot3(out_dir, qvec) * inv_det
        t = dot3(e2, qvec) * inv_det
        hit = (torch.abs(det) >= EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= EPS)
        face_n = normalize3(cross3(e1, e2))
        denom = self.l_area[l_idx] * torch.abs(dot3(face_n, out_dir))
        return torch.where(hit & (denom > 0.0), t * t / torch.clamp(denom, min=1e-20), torch.zeros_like(t))

    def render_frames(self, seeds, pix: torch.Tensor, width: int, height: int, spp: int,
                      opt: Integrator, chunk: int = 8, P: Optional[Dict] = None) -> torch.Tensor:
        """Summed radiance [F, n, 3] of samples ``0 .. spp-1`` of pixels
        ``pix`` (full-frame indices) in each frame of seed ``seeds[f]``, all
        as one batch of lanes: each chunk of ``chunk`` samples summed from
        zero in sample order, the chunks then added in order (the frame
        loop's association)."""
        P = P or self.params()
        frustum, eye = self.camera(width, height)
        F, n = len(seeds), pix.shape[0]
        dev = self.device
        seed = torch.tensor([int(x) & 0xFFFFFFFF for x in seeds], device=dev).repeat_interleave(spp * n)
        s = torch.arange(spp, device=dev).repeat_interleave(n).repeat(F)
        lp = pix.repeat(F * spp)
        with torch.no_grad():
            r = self.sample(P, seed, lp, lp % width, lp // width, s, width, height, frustum, eye, opt)
        parts = r.reshape(F, spp, n, 3)
        accum = None
        for c0 in range(0, spp, chunk):
            part = parts[:, c0]
            for k in range(c0 + 1, min(c0 + chunk, spp)):
                part = part + parts[:, k]
            accum = part if accum is None else accum + part
        return accum

    def loss(self, P, seed: int, target: torch.Tensor, width: int, height: int, spp: int,
             opt: Integrator) -> torch.Tensor:
        """Mean squared error of the tonemapped frame (samples summed from
        zero in sample order, plus 1e-6) against ``target`` [H, W, 3]."""
        frustum, eye = self.camera(width, height)
        n = width * height
        pix = torch.arange(n, device=self.device).repeat(spp)
        s = torch.arange(spp, device=self.device).repeat_interleave(n)
        r = self.sample(P, int(seed) & 0xFFFFFFFF, pix, pix % width, pix // width, s,
                        width, height, frustum, eye, opt)
        parts = r.reshape(spp, n, 3)
        accum = parts[0]
        for k in range(1, spp):
            accum = accum + parts[k]
        img = tonemap(accum.reshape(height, width, 3) + 1e-6, 1.0 / spp, opt.exposure)
        return torch.mean((img - target.to(img.dtype)) ** 2)
