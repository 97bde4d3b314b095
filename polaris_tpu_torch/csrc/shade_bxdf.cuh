// BxDF sample, pdf and eval of the shading kernel: ops/bxdf.py for one lane
// (CL/bxdf/*.cl, the GGX helpers of distribution_sampler.cl).
//
// The plain version evaluates the branch of every BxDF type the scene holds
// and where-selects by the lane's type; a lane here evaluates its own type's
// branch alone, which is the value the select picks. Only lanes that go on
// shading (hit, not emissive, past Russian roulette) get here.

#pragma once

#include "shade_args.cuh"
#include "shade_material.cuh"
#include "shade_texture.cuh"
#include "shade_vec.cuh"

namespace polaris_shade {

constexpr int BXDF_EMISSIVE = 1 << 1;
constexpr int BXDF_DIFFUSE = 1 << 2;
constexpr int BXDF_CONDUCTOR = 1 << 3;
constexpr int BXDF_ROUGH_CONDUCTOR = 1 << 4;
constexpr int BXDF_DIELECTRIC = 1 << 5;
constexpr int BXDF_ROUGH_DIELECTRIC = 1 << 6;
constexpr int BXDF_SINGULAR_MASK = BXDF_CONDUCTOR | BXDF_DIELECTRIC;

struct BxdfSample {
    F3 out;
    float pdf;
    F3 val;
};

// ----------------------------------------------------------- GGX helpers

__device__ __forceinline__ float ggx_g1(float r, F3 v, F3 n, F3 m) {
    const float n_dot_v = dot3(n, v);
    const float m_dot_v = dot3(m, v);
    const float sq = n_dot_v * n_dot_v;
    const float tan_sq = safe_div(1.0f - sq, sq, F32(1e-12));
    const float a_sq = r * r;
    // 2.0 / x: PyTorch's reciprocal, times 2
    float g = (1.0f / (1.0f + sqrtf(1.0f + a_sq * tan_sq))) * 2.0f;
    g = sq > F32(1e-12) ? g : 0.0f;
    return n_dot_v * m_dot_v <= 0.0f ? 0.0f : g;
}

__device__ __forceinline__ float ggx_g(float r, F3 i, F3 o, F3 n, F3 m) {
    return ggx_g1(r, i, n, m) * ggx_g1(r, o, n, m);
}

__device__ __forceinline__ float ggx_d(float r, F3 n, F3 m) {
    const float n_dot_m = dot3(n, m);
    const float sq = n_dot_m * n_dot_m;
    const float tan_sq = safe_div(1.0f - sq, sq, F32(1e-12));
    const float a_sq = r * r;
    const float denom = F32(PI) * sq * sq * (a_sq + tan_sq) * (a_sq + tan_sq);
    float d = safe_div(a_sq, denom, F32(1e-12));
    d = sq > F32(1e-12) ? d : 0.0f;
    return n_dot_m <= 0.0f ? 0.0f : d;
}

__device__ __forceinline__ F3 ggx_sample_h(float r, F3 n, float u1, float u2) {
    F3 tu, tv;
    tangent_basis(n, tu, tv);
    const float theta = atanf(r * sqrtf(u1 / clamp_min(1.0f - u1, F32(1e-9))));
    const float cos_t = cosf(theta);
    const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, F32(1e-12)));
    const float cos_p = cosf(F32(TWO_PI) * u2);
    const float sin_p = sqrtf(clamp_min(1.0f - cos_p * cos_p, 0.0f));
    return normalize3(tu * (sin_t * cos_p) + tv * (sin_t * sin_p) + n * cos_t);
}

__device__ __forceinline__ float ggx_reflection_pdf(float r, F3 out, F3 n, F3 h) {
    const float n_dot_h = fabsf(dot3(n, h));
    const float o_dot_h = fabsf(dot3(out, h));
    return safe_div(ggx_d(r, n, h) * n_dot_h, 4.0f * o_dot_h, F32(1e-12));
}

__device__ __forceinline__ float ggx_refraction_pdf(float r, float eta_i, float eta_t, F3 in,
                                                    F3 out, F3 n, F3 h) {
    const float i_dot_h = fabsf(dot3(in, h));
    const float o_dot_h = fabsf(dot3(out, h));
    const float h_dot_n = fabsf(dot3(h, n));
    const float s = eta_i * i_dot_h + eta_t * o_dot_h;
    return safe_div(ggx_d(r, n, h) * h_dot_n * o_dot_h * eta_t * eta_t, s * s, F32(1e-12));
}

// ----------------------------------------------------------- material fields

__device__ __forceinline__ F3 leaf_reflectance(const ShadeArgs& a, int node, float u, float v) {
    return mat_sample3(a, u, v, ldg3(a.mat_reflectance, node), __ldg(a.mat_reflectance_tex + node));
}
__device__ __forceinline__ F3 leaf_specularity(const ShadeArgs& a, int node, float u, float v) {
    return mat_sample3(a, u, v, ldg3(a.mat_specularity, node), __ldg(a.mat_specularity_tex + node));
}
__device__ __forceinline__ F3 leaf_transmittance(const ShadeArgs& a, int node, float u, float v) {
    return mat_sample3(a, u, v, ldg3(a.mat_transmittance, node),
                       __ldg(a.mat_transmittance_tex + node));
}

// Disney remap clamp(roughness, MIN_ROUGHNESS, 1)^2 (rough_conductor.cl:11-12)
__device__ __forceinline__ float rough_alpha(const ShadeArgs& a, int node, float u, float v) {
    float r = mat_sample1(a, u, v, __ldg(a.mat_roughness + node), __ldg(a.mat_roughness_tex + node));
    r = clampf(r, F32(MIN_ROUGHNESS), 1.0f);
    return r * r;
}

__device__ __forceinline__ float conductor_fresnel(const Leaf& m, float i_dot_n) {
    return m.int_ior != 0.0f ? fresnel_dielectric(m.ext_ior, m.int_ior, i_dot_n) : 1.0f;
}

// int/ext IOR swapped when hitting from inside (dielectric.cl:18-24)
__device__ __forceinline__ void eta_swapped(const Leaf& m, float i_dot_n, float& eta_i,
                                            float& eta_t) {
    const bool inside = i_dot_n < 0.0f;
    eta_i = inside ? m.int_ior : m.ext_ior;
    eta_t = inside ? m.ext_ior : m.int_ior;
}

// ----------------------------------------------------------- sample

__device__ __forceinline__ BxdfSample bxdf_sample(const ShadeArgs& a, const Leaf& m, F3 n,
                                                  float u, float v, F3 in, float u1, float u2) {
    BxdfSample s;
    const float i_dot_n = dot3(in, n);
    const int t = m.type;
    if (t == BXDF_DIFFUSE) {  // diffuse.cl:13-21
        const F3 kd = leaf_reflectance(a, m.node, u, v);
        s.out = cos_weighted_hemisphere(n, u1, u2);
        s.pdf = dot3(n, s.out) * F32(INV_PI);
        s.val = kd * F32(INV_PI);
        return s;
    }
    const F3 ks = leaf_specularity(a, m.node, u, v);
    if (t == BXDF_CONDUCTOR) {  // conductor.cl:13-30
        s.out = (2.0f * dot3(in, n)) * n - in;
        s.pdf = 1.0f;
        s.val = safe_div_abs(conductor_fresnel(m, i_dot_n), i_dot_n, F32(1e-8)) * ks;
        return s;
    }
    if (t == BXDF_ROUGH_CONDUCTOR) {  // rough_conductor.cl:9-41
        const float alpha = rough_alpha(a, m.node, u, v);
        const F3 h = ggx_sample_h(alpha, n, u1, u2);
        s.out = (2.0f * dot3(in, h)) * h - in;
        s.pdf = ggx_reflection_pdf(alpha, s.out, n, h);
        const F3 rc_h = normalize3(in + s.out);
        const float d = ggx_d(alpha, n, rc_h);
        const float g = ggx_g(alpha, in, s.out, n, rc_h);
        const float denom = 4.0f * i_dot_n * dot3(s.out, n);
        s.val = safe_div(conductor_fresnel(m, i_dot_n) * d * g, denom, F32(1e-12)) * ks;
        return s;
    }
    // dielectric.cl:13-47, rough_dielectric.cl:9-96: what the two share
    const F3 tf = leaf_transmittance(a, m.node, u, v);
    float eta_i, eta_t;
    eta_swapped(m, i_dot_n, eta_i, eta_t);
    const float eta = eta_i / (eta_t == 0.0f ? 1.0f : eta_t);
    const float f_diel = fresnel_dielectric(eta_i, eta_t, i_dot_n);
    const float cos_t_sq = 1.0f + eta * eta * (i_dot_n * i_dot_n - 1.0f);
    const bool tir = cos_t_sq <= 0.0f;
    const bool pick_reflect = tir || (u1 <= f_diel);
    const float sgn = signf(i_dot_n);
    const float refr_cos = sqrtf(clamp_min(cos_t_sq, F32(1e-12)));
    if (t == BXDF_DIELECTRIC) {
        const F3 refl_out = (2.0f * i_dot_n) * n - in;
        const F3 refr_out = (eta * i_dot_n - sgn * refr_cos) * n - eta * in;
        s.out = sel3(pick_reflect, refl_out, refr_out);
        s.pdf = pick_reflect ? (tir ? 1.0f : f_diel) : 1.0f - f_diel;
        const F3 k = sel3(pick_reflect, ks, (eta * eta) * tf);
        s.val = safe_div(s.pdf, fabsf(i_dot_n), F32(1e-8)) * k;
        return s;
    }
    if (t == BXDF_ROUGH_DIELECTRIC) {
        const float alpha = rough_alpha(a, m.node, u, v);
        const F3 h = ggx_sample_h(alpha, n, u1, u2);
        if (pick_reflect) {
            const F3 out = (2.0f * dot3(in, h)) * h - in;
            const F3 rh = normalize3(in + out);
            s.out = out;
            s.pdf = tir ? 1.0f : ggx_reflection_pdf(alpha, out, n, rh);
            const float d = ggx_d(alpha, n, rh);
            const float g = ggx_g(alpha, in, out, n, rh);
            const float denom = 4.0f * i_dot_n * dot3(out, n);
            s.val = safe_div(f_diel * d * g, denom, F32(1e-12)) * ks;
        } else {
            const F3 out = (eta * i_dot_n - sgn * refr_cos) * h - eta * in;
            const F3 rh = normalize3(-(eta_i * in + eta_t * out));
            s.out = out;
            s.pdf = ggx_refraction_pdf(alpha, eta_i, eta_t, in, out, n, rh);
            const float i_dot_h = fabsf(dot3(in, rh));
            const float o_dot_h = fabsf(dot3(out, rh));
            const float o_dot_n = dot3(out, n);
            const float w = eta_i * i_dot_h + eta_t * o_dot_h;
            const float focus_denom = i_dot_n * o_dot_n * (w * w);
            const float focus = fabsf(
                safe_div_abs(eta_t * eta_t * i_dot_h * o_dot_h, focus_denom, F32(1e-12)));
            const float d = ggx_d(alpha, n, rh);
            const float g = ggx_g(alpha, in, out, n, rh);
            s.val = ((1.0f - f_diel) * d * g * focus) * tf;
        }
        return s;
    }
    // no other type reaches here (emissive lanes do not shade)
    s.out = n;
    s.pdf = 1.0f;
    s.val = f3(0.0f, 0.0f, 0.0f);
    return s;
}

// ----------------------------------------------------------- pdf / eval

// the pdf of the lane's BxDF generating `out` (for MIS); singular types 0
__device__ __forceinline__ float bxdf_pdf(const ShadeArgs& a, const Leaf& m, F3 n, float u,
                                          float v, F3 in, F3 out) {
    const int t = m.type;
    if (t == BXDF_DIFFUSE) return dot3(n, out) * F32(INV_PI);
    if (t != BXDF_ROUGH_CONDUCTOR && t != BXDF_ROUGH_DIELECTRIC) return 0.0f;
    const float i_dot_n = dot3(in, n);
    const float alpha = rough_alpha(a, m.node, u, v);
    if (t == BXDF_ROUGH_CONDUCTOR || i_dot_n > 0.0f)
        return ggx_reflection_pdf(alpha, out, n, normalize3(in + out));
    float eta_i, eta_t;
    eta_swapped(m, i_dot_n, eta_i, eta_t);
    const F3 h_refr = normalize3(-(eta_i * in + eta_t * out));
    return ggx_refraction_pdf(alpha, eta_i, eta_t, in, out, n, h_refr);
}

// the lane's BxDF for the out ray `out` (for NEE); singular types 0
__device__ __forceinline__ F3 bxdf_eval(const ShadeArgs& a, const Leaf& m, F3 n, float u, float v,
                                        F3 in, F3 out) {
    const int t = m.type;
    if (t == BXDF_DIFFUSE) {
        const F3 kd = leaf_reflectance(a, m.node, u, v);
        return kd * F32(INV_PI);
    }
    if (t != BXDF_ROUGH_CONDUCTOR && t != BXDF_ROUGH_DIELECTRIC) return f3(0.0f, 0.0f, 0.0f);
    const float i_dot_n = dot3(in, n);
    const float o_dot_n = dot3(out, n);
    const F3 ks = leaf_specularity(a, m.node, u, v);
    const float alpha = rough_alpha(a, m.node, u, v);
    const F3 h_refl = normalize3(in + out);
    const float denom = 4.0f * i_dot_n * o_dot_n;
    if (t == BXDF_ROUGH_CONDUCTOR) {
        const float d = ggx_d(alpha, n, h_refl);
        const float g = ggx_g(alpha, in, out, n, h_refl);
        return safe_div(conductor_fresnel(m, i_dot_n) * d * g, denom, F32(1e-12)) * ks;
    }
    float eta_i, eta_t;
    eta_swapped(m, i_dot_n, eta_i, eta_t);
    const float f_diel = fresnel_dielectric(eta_i, eta_t, i_dot_n);
    if (i_dot_n > 0.0f) {
        const float d = ggx_d(alpha, n, h_refl);
        const float g = ggx_g(alpha, in, out, n, h_refl);
        return safe_div(f_diel * d * g, denom, F32(1e-12)) * ks;
    }
    const F3 tf = leaf_transmittance(a, m.node, u, v);
    const F3 h_refr = normalize3(-(eta_i * in + eta_t * out));
    const float i_dot_h = fabsf(dot3(in, h_refr));
    const float o_dot_h = fabsf(dot3(out, h_refr));
    const float w = eta_i * i_dot_h + eta_t * o_dot_h;
    const float focus_denom = i_dot_n * o_dot_n * (w * w);
    const float focus =
        fabsf(safe_div_abs(eta_t * eta_t * i_dot_h * o_dot_h, focus_denom, F32(1e-12)));
    const float d = ggx_d(alpha, n, h_refr);
    const float g = ggx_g(alpha, in, out, n, h_refr);
    return ((1.0f - f_diel) * d * g * focus) * tf;
}

}  // namespace polaris_shade
