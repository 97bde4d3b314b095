// Light sampling of the shading kernel: ops/emissive.py for one lane
// (CL/samplers/emissive_sampler.cl). Uniform light selection, area lights
// (a sqrt-warped point of the world-space triangle, pdf 1/area, the pdf of a
// direction by a Moller-Trumbore test against the triangle) and the
// lat-long environment light (a cosine-hemisphere sample). A lane takes the
// branch of its light's kind: the value the plain version's select picks.

#pragma once

#include "shade_args.cuh"
#include "shade_texture.cuh"
#include "shade_vec.cuh"

namespace polaris_shade {

constexpr int ENVIRONMENT_LIGHT = 1;

struct LightPick {
    int idx;
    float sel_pdf;
};

// uniform pick (emissive_sampler.cl:227-237)
__device__ __forceinline__ LightPick emissive_select(long long num, float u) {
    LightPick p;
    p.idx = min(max(static_cast<int>(u * static_cast<float>(num)), 0), static_cast<int>(num) - 1);
    p.sel_pdf = static_cast<float>(1.0 / static_cast<double>(num));
    return p;
}

// one light: its kind and, for an area light, its world-space triangle
// (emissive._light_rows)
struct LightTri {
    bool env;
    int tri;
    F3 v0, e1, e2;
};

__device__ __forceinline__ LightTri light_triangle(const ShadeArgs& a, int l) {
    LightTri L;
    L.env = __ldg(a.emis_type + l) == ENVIRONMENT_LIGHT;
    if (L.env) return L;
    L.tri = __ldg(a.emis_tri + l);
    float m[12];
#pragma unroll
    for (int k = 0; k < 12; ++k) m[k] = __ldg(a.emis_o2w + 16 * l + k);
    L.v0 = transform_point(m, ldg3(a.tri_v0, L.tri));
    L.e1 = transform_dir(m, ldg3(a.tri_e1, L.tri));
    L.e2 = transform_dir(m, ldg3(a.tri_e2, L.tri));
    return L;
}

struct LightSample {
    F3 val, dir;
    float pdf, dist;
};

// a direction to light l from `point` (emissive_sampler.cl:16-38, 51-114)
__device__ __forceinline__ LightSample emissive_sample(const ShadeArgs& a, int l,
                                                       const LightTri& L, F3 point, F3 normal,
                                                       float u1, float u2) {
    const int mat = __ldg(a.emis_mat + l);
    const float scale = __ldg(a.mat_scale + mat);
    const F3 radiance = ldg3(a.mat_radiance, mat);
    const int radiance_tex = __ldg(a.mat_radiance_tex + mat);
    LightSample s;
    if (L.env) {
        s.dir = cos_weighted_hemisphere(normal, u1, u2);
        s.pdf = clamp_min(dot3(normal, s.dir), 0.0f) * F32(INV_PI);
        float eu = 0.0f, ev = 0.0f;
        if (radiance_tex >= 0) ray_to_latlong_uv(s.dir, eu, ev);
        s.val = (scale * F32(INV_PI)) * mat_sample3(a, eu, ev, radiance, radiance_tex);
        s.dist = F32(FLT_MAX_F);
        return s;
    }
    const float* tn = a.tri_normals + 9 * static_cast<int64_t>(L.tri);
    const float r1s = sqrtf(clamp_min(u1, 0.0f));
    const float ru = (1.0f - u2) * r1s;
    const float rv = u2 * r1s;
    const float w = 1.0f - ru - rv;
    const F3 l_point = L.v0 + ru * L.e1 + rv * L.e2;
    const F3 n_obj = w * ldg3(tn, 0) + ru * ldg3(tn, 1) + rv * ldg3(tn, 2);
    const float* nm = a.emis_nmat + 9 * l;
    const F3 l_normal = f3(__ldg(nm) * n_obj.x + __ldg(nm + 1) * n_obj.y + __ldg(nm + 2) * n_obj.z,
                           __ldg(nm + 3) * n_obj.x + __ldg(nm + 4) * n_obj.y + __ldg(nm + 5) * n_obj.z,
                           __ldg(nm + 6) * n_obj.x + __ldg(nm + 7) * n_obj.y + __ldg(nm + 8) * n_obj.z);
    const F3 to_light = l_point - point;
    const float sq_dist_raw = dot3(to_light, to_light);
    s.dist = sqrtf(clamp_min(sq_dist_raw, F32(1e-20)));
    s.dir = to_light / s.dist;
    const float n_dot_out = dot3(l_normal, -s.dir);
    F3 ke = radiance;
    if (radiance_tex >= 0) {
        const float* tuv = a.tri_uvs + 6 * static_cast<int64_t>(L.tri);
        const float lu = w * __ldg(tuv) + ru * __ldg(tuv + 2) + rv * __ldg(tuv + 4);
        const float lv = w * __ldg(tuv + 1) + ru * __ldg(tuv + 3) + rv * __ldg(tuv + 5);
        ke = tex_sample3(a, lu, lv, radiance_tex);
    }
    // 1.0 / x: PyTorch's reciprocal, times 1
    s.pdf = n_dot_out > 0.0f ? (1.0f / clamp_min(__ldg(a.emis_area + l), F32(1e-20))) * 1.0f : 0.0f;
    const float inv_sq = safe_div(1.0f, sq_dist_raw, F32(1e-8));
    s.val = n_dot_out > 0.0f ? (scale * n_dot_out * inv_sq) * ke : f3(0.0f, 0.0f, 0.0f);
    return s;
}

// the pdf of light l's sampler generating `out` (emissive_sampler.cl:41-47,
// 118-173)
__device__ __forceinline__ float emissive_pdf(const ShadeArgs& a, int l, const LightTri& L,
                                              F3 point, F3 normal, F3 out) {
    if (L.env) return clamp_min(dot3(normal, out) * F32(INV_PI), 0.0f);
    const float eps = F32(INTERSECTION_EPSILON);
    const F3 pvec = cross3(out, L.e2);
    const float det = dot3(L.e1, pvec);
    const float inv_det = (1.0f / (fabsf(det) < eps ? 1.0f : det)) * 1.0f;
    const F3 tvec = point - L.v0;
    const float u = dot3(tvec, pvec) * inv_det;
    const F3 qvec = cross3(tvec, L.e1);
    const float v = dot3(out, qvec) * inv_det;
    const float t = dot3(L.e2, qvec) * inv_det;
    const bool hit = fabsf(det) >= eps && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
                     t >= eps;
    const F3 face_n = normalize3(cross3(L.e1, L.e2));
    const float denom = __ldg(a.emis_area + l) * fabsf(dot3(face_n, out));
    return hit && denom > 0.0f ? t * t / clamp_min(denom, F32(1e-20)) : 0.0f;
}

}  // namespace polaris_shade
