// Small vector helpers of the shading kernel: the device counterpart of
// ops/vec.py, one lane's float3 at a time.
//
// Every function rounds as the PyTorch op it mirrors does on a card: each
// multiply and add on its own (the library is built with -fmad=false), sums
// in the association the plain version writes, constants given in double
// and rounded to float where they meet a float tensor, a division by a
// Python number taken as a multiply by its float reciprocal (PyTorch's
// division by a host scalar on a card), and clamps and maxima that pass a
// NaN on as PyTorch's do.

#pragma once

#include <cstdint>

namespace polaris_shade {

// a Python float constant as it meets a float32 tensor
#define F32(x) static_cast<float>(x)

constexpr double PI = 3.14159265358979323846;
constexpr double INV_PI = 1.0 / PI;
constexpr double TWO_PI = 2.0 * PI;
constexpr double INTERSECTION_EPSILON = 1e-5;
constexpr double INTERSECTION_WITH_LIGHT_EPSILON = INTERSECTION_EPSILON * 1e3;
constexpr double MIN_ROUGHNESS = 0.1;
constexpr double FLT_MAX_F = 3.4028234663852886e38;

struct F3 {
    float x, y, z;
};

__device__ __forceinline__ F3 f3(float x, float y, float z) { return F3{x, y, z}; }
__device__ __forceinline__ F3 operator+(F3 a, F3 b) { return f3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ F3 operator-(F3 a, F3 b) { return f3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ F3 operator*(F3 a, F3 b) { return f3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ F3 operator*(F3 a, float s) { return f3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ F3 operator*(float s, F3 a) { return f3(s * a.x, s * a.y, s * a.z); }
__device__ __forceinline__ F3 operator/(F3 a, float s) { return f3(a.x / s, a.y / s, a.z / s); }
__device__ __forceinline__ F3 operator-(F3 a) { return f3(-a.x, -a.y, -a.z); }
__device__ __forceinline__ F3 sel3(bool c, F3 a, F3 b) { return c ? a : b; }

__device__ __forceinline__ F3 load3(const float* p, int64_t i) {
    return f3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}
__device__ __forceinline__ F3 ldg3(const float* p, int64_t i) {
    return f3(__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2));
}
__device__ __forceinline__ void store3(float* p, int64_t i, F3 v) {
    p[3 * i] = v.x;
    p[3 * i + 1] = v.y;
    p[3 * i + 2] = v.z;
}

__device__ __forceinline__ bool is_nan(float v) { return v != v; }

// torch.clamp(v, min=lo), clamp(v, max=hi), clamp(v, lo, hi): NaN passes
__device__ __forceinline__ float clamp_min(float v, float lo) { return is_nan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return is_nan(v) ? v : fminf(v, hi); }
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return is_nan(v) ? v : fminf(fmaxf(v, lo), hi);
}
// torch.maximum: a NaN on either side wins
__device__ __forceinline__ float maximum(float a, float b) {
    return is_nan(a) ? a : (is_nan(b) ? b : fmaxf(a, b));
}
// torch.sign
__device__ __forceinline__ float signf(float a) {
    return static_cast<float>(static_cast<int>(0.0f < a) - static_cast<int>(a < 0.0f));
}

__device__ __forceinline__ float dot3(F3 a, F3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ F3 cross3(F3 a, F3 b) {
    return f3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}

__device__ __forceinline__ F3 normalize3(F3 v) {
    const float n = sqrtf(clamp_min(dot3(v, v), F32(1e-20)));
    return v / n;
}

__device__ __forceinline__ float maxcomp3(F3 v) { return maximum(v.x, maximum(v.y, v.z)); }

__device__ __forceinline__ float luminance(F3 v) {
    return F32(0.2126) * v.x + F32(0.7152) * v.y + F32(0.0722) * v.z;
}

// V.safe_div / safe_div_abs: num/den where den (|den|) > thresh, else +0
__device__ __forceinline__ float safe_div(float num, float den, float thresh) {
    return den > thresh ? num / den : 0.0f;
}
__device__ __forceinline__ float safe_div_abs(float num, float den, float thresh) {
    return fabsf(den) > thresh ? num / den : 0.0f;
}

// (tangent, bitangent) of a normal (CL/util/surface.cl TANGENT_VECTORS)
__device__ __forceinline__ void tangent_basis(F3 n, F3& u, F3& v) {
    const bool use_z = fabsf(n.z) < F32(0.999);
    const F3 ref = f3(use_z ? 0.0f : 1.0f, 0.0f, use_z ? 1.0f : 0.0f);
    u = normalize3(cross3(ref, n));
    v = cross3(n, u);
}

// rows of a row-major 4x4: m[i][j] = m[4 * i + j]
__device__ __forceinline__ F3 transform_point(const float* m, F3 p) {
    return f3(m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
              m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
              m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]);
}
__device__ __forceinline__ F3 transform_dir(const float* m, F3 d) {
    return f3(m[0] * d.x + m[1] * d.y + m[2] * d.z,
              m[4] * d.x + m[5] * d.y + m[6] * d.z,
              m[8] * d.x + m[9] * d.y + m[10] * d.z);
}
// normals transform by w2o^T
__device__ __forceinline__ F3 transform_normal(const float* w, F3 n) {
    return f3(w[0] * n.x + w[4] * n.y + w[8] * n.z,
              w[1] * n.x + w[5] * n.y + w[9] * n.z,
              w[2] * n.x + w[6] * n.y + w[10] * n.z);
}

// direction -> lat-long uv (CL/util/transform.cl rayToLatLongUV); the two
// divisions by pi and 2 pi are PyTorch's multiplies by float reciprocals
__device__ __forceinline__ void ray_to_latlong_uv(F3 d, float& u, float& v) {
    const float z_safe = (d.x == 0.0f && d.z == 0.0f) ? F32(1e-12) : d.z;
    float at2 = atan2f(d.x, z_safe);
    at2 = at2 >= 0.0f ? at2 : at2 + F32(TWO_PI);
    const float r = sqrtf(dot3(d, d));
    const float c = clampf(d.y / clamp_min(r, F32(1e-20)), F32(-1.0 + 1e-7), F32(1.0 - 1e-7));
    v = acosf(c) * (1.0f / F32(PI));
    u = at2 * (1.0f / F32(TWO_PI));
}

// Schlick (CL/util/fresnel.cl:8-17)
__device__ __forceinline__ float fresnel_dielectric(float eta_i, float eta_t, float i_dot_n) {
    const float eta = eta_i / (eta_t == 0.0f ? 1.0f : eta_t);
    const float a = 1.0f - eta;
    const float b = 1.0f + eta;
    const float r0 = (a * a) / (b * b);
    const float c = 1.0f - fabsf(i_dot_n);
    return r0 + (1.0f - r0) * c * c * c * c * c;
}

// cosine-weighted hemisphere sample (distribution_sampler.cl:100-112)
__device__ __forceinline__ F3 cos_weighted_hemisphere(F3 n, float u1, float u2) {
    const float rd = sqrtf(clamp_min(u1, 0.0f));
    const float phi = F32(TWO_PI) * u2;
    F3 tu, tv;
    tangent_basis(n, tu, tv);
    return normalize3(tu * (rd * cosf(phi)) + tv * (rd * sinf(phi)) +
                      n * sqrtf(clamp_min(1.0f - u1, 0.0f)));
}

}  // namespace polaris_shade
