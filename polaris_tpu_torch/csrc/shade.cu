// The shading of one bounce for NVIDIA Hopper (sm_90a), one thread a lane.
//
// Replaces no TPU kernel: in the JAX package the shading of a bounce is jnp
// code that XLA fuses around the Pallas traversal. Its upstream counterpart
// is the reference's shadeHits mega-kernel (CL/kernels/pt_integrator.cl:
// 17-211) with the miss shading (pt_integrator.cl:214-275). Its plain
// version is render/shade.py::shade and shade_miss, with the adds to the
// radiance of render/integrator.py::_trace_bounce, which run as some 740
// PyTorch kernels a bounce, each streaming million-lane tensors through
// device memory.
//
// What bounds it: bytes. A lane reads its ray, hit, throughput, flags,
// radiance and counters (about 90 B), gathers its triangle's normal rows
// (and uv rows where the scene has textures), and writes the next ray, its
// throughput and flags, the shadow ray with its NEE value and the radiance
// (about 95 B); the arithmetic, a few hundred flops and a dozen hashes, is
// far below the card's rate. So every intermediate stays in registers, the
// small tables (materials, instances, lights, the texture table) come
// through the read-only path, and a lane that neither hits nor misses into
// a background writes its pass-through values and leaves at once; so does
// a lane that stops shading (an emissive hit, or Russian roulette), after
// its emission and its throughput.
//
// Every output a later stage reads is the plain version's, bit for bit: the
// same operations in the same association, rounded one by one (the library
// is built with -fmad=false), the same draws (shade_rng.cuh). Where a lane
// does not shade, the values no later stage reads (its next and shadow
// rays, whose masks are false) are its incoming ray, not the plain
// version's unused arithmetic. One kernel serves every scene: a lane takes
// the branch of its own material and BxDF type, so a scene of one type runs
// warp-uniform branches, and a triangle's uv rows are read only where the
// scene samples a texture at a surface (STATIC_UV).
//
// Plain C interface (no torch headers): the entry points take the argument
// struct or raw device pointers and a stream and return a CUDA error code.

#include <cuda_runtime.h>

#include "shade_args.cuh"
#include "shade_bxdf.cuh"
#include "shade_emissive.cuh"
#include "shade_material.cuh"
#include "shade_rng.cuh"
#include "shade_texture.cuh"
#include "shade_vec.cuh"

namespace polaris_shade {

constexpr int THREADS = 256;

// a counter's value as the integer the plain version compares (bounce >=
// min_bounces_for_rr): an int32 sign-extended
__device__ __forceinline__ long long read_signed(const Counter& c, int64_t lane) {
    if (c.ptr == 0) return c.imm;
    const int64_t j = c.per_lane ? lane : 0;
    if (c.is64 == 1) return reinterpret_cast<const long long*>(c.ptr)[j];
    if (c.is64 == 2) return reinterpret_cast<const uint8_t*>(c.ptr)[j];
    return reinterpret_cast<const int*>(c.ptr)[j];
}

// a^2 / (a^2 + b^2) (pt_integrator.cl:9)
__device__ __forceinline__ float power_heuristic(float a, float b) {
    const float a2 = a * a;
    const float denom = a2 + b * b;
    return denom > 0.0f ? a2 / clamp_min(denom, F32(1e-30)) : 0.0f;
}

__global__ void __launch_bounds__(THREADS) shade_bounce_kernel(const ShadeArgs a) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (i >= a.n) return;
    const F3 ray_o = load3(a.ray_o, i);
    const F3 ray_d = load3(a.ray_d, i);
    const F3 tp_in = load3(a.throughput, i);
    F3 radiance = load3(a.radiance, i);
    int flags = a.flags[i];
    const bool hit = a.hit_mask[i] != 0;

    // what the plain version leaves for a lane that does not shade
    F3 tp = tp_in;
    bool next_mask = false, occl_mask = false;
    float occl_maxt = 0.0f;
    F3 next_o = ray_o, next_d = ray_d, occl_o = ray_o, occl_d = ray_d;
    F3 occl_value = f3(0.0f, 0.0f, 0.0f), emit_add = f3(0.0f, 0.0f, 0.0f);

    // the background of a miss (shade.shade_miss)
    if (a.scene_diffuse_mat >= 0) {
        F3 bg = f3(0.0f, 0.0f, 0.0f);
        if (!hit && a.alive[i]) {
            const int m = static_cast<int>(a.scene_diffuse_mat);
            F3 kd = ldg3(a.mat_reflectance, m);
            const int tex = __ldg(a.mat_reflectance_tex + m);
            if (tex >= 0) {
                float u, v;
                ray_to_latlong_uv(ray_d, u, v);
                kd = tex_sample3(a, u, v, tex);
            }
            bg = read_signed(a.is_primary, i) != 0 ? kd : tp_in * kd;
        }
        radiance = radiance + bg;
    }

    if (hit) {
        // --- surface (CL/util/surface.cl surfaceInit)
        const float t = a.hit_t[i];
        const float bu = a.hit_u[i];
        const float bv = a.hit_v[i];
        const int tri = a.hit_tri[i];
        const int inst = a.hit_inst[i];
        const F3 in_dir = -ray_d;
        const F3 point = ray_o + t * ray_d;
        const float w = 1.0f - bu - bv;
        const float* tn = a.tri_normals + 9 * static_cast<int64_t>(tri);
        const F3 n_obj = w * ldg3(tn, 0) + bu * ldg3(tn, 1) + bv * ldg3(tn, 2);
        float w2o[11];
#pragma unroll
        for (int k = 0; k < 11; ++k) w2o[k] = __ldg(a.inst_w2o + 16 * inst + k);
        F3 normal = normalize3(transform_normal(w2o, n_obj));
        float u = 0.0f, v = 0.0f;
        if (a.statics & STATIC_UV) {
            const float* tuv = a.tri_uvs + 6 * static_cast<int64_t>(tri);
            u = w * __ldg(tuv) + bu * __ldg(tuv + 2) + bv * __ldg(tuv + 4);
            v = w * __ldg(tuv + 1) + bu * __ldg(tuv + 3) + bv * __ldg(tuv + 5);
        }

        // --- the lane's draws (rng.make_uniform)
        const uint32_t seed = read_counter(a.seed, i);
        const uint32_t sample = read_counter(a.sample, i);
        const long long bounce = read_signed(a.bounce, i);
        Draws U;
        U.prefix = fold(fold(seed, read_counter(a.pixel, i)), sample);
        U.rr_prefix = a.rr_key.ptr ? fold(fold(seed, read_counter(a.rr_key, i)), sample) : U.prefix;
        U.bounce64 = static_cast<uint32_t>(bounce) * 64u;

        // --- layered material (material_sampler.cl matSelectNode)
        F3 tint = f3(1.0f, 1.0f, 1.0f);
        const Leaf m = select_material(a, U, __ldg(a.tri_material + tri), normal, u, v, tint,
                                       flags);
        const float i_dot_n = dot3(in_dir, normal);
        const bool is_emissive = m.type == BXDF_EMISSIVE;

        // --- emissive hit (pt_integrator.cl:103-107)
        if (is_emissive && i_dot_n > 0.0f) {
            const F3 radiance_m = ldg3(a.mat_radiance, m.node);
            const F3 ke = mat_sample3(a, u, v, radiance_m, __ldg(a.mat_radiance_tex + m.node));
            emit_add = tp_in * m.scale * ke;
        }

        // --- Russian roulette (pt_integrator.cl:112-124)
        const bool rr_on = bounce >= a.min_bounces_for_rr;
        const float rr_p = clamp_min(clamp_max(luminance(tp_in), 0.5f), F32(0.01));
        const bool rr_survive = !rr_on || rr_p >= U(STREAM_RR);
        if (!is_emissive && rr_on && rr_survive) tp = tp_in / rr_p;

        if (!is_emissive && rr_survive) {
            // --- BxDF importance sample (pt_integrator.cl:128-138)
            const float u1 = U(STREAM_BXDF_U);
            const float u2 = U(STREAM_BXDF_V);
            const BxdfSample b = bxdf_sample(a, m, normal, u, v, in_dir, u1, u2);
            const float displace = signf(dot3(normal, b.out));
            next_o = point + (displace * F32(INTERSECTION_EPSILON)) * normal;
            next_d = b.out;
            occl_o = point + F32(INTERSECTION_EPSILON) * normal;
            occl_d = b.out;

            // --- NEE with MIS (pt_integrator.cl:140-167)
            float b_weight = 1.0f;
            if (a.num_emissives > 0) {
                const LightPick lp = emissive_select(a.num_emissives, U(STREAM_LIGHT_SELECT));
                const LightTri L = light_triangle(a, lp.idx);
                const LightSample e = emissive_sample(a, lp.idx, L, point, normal,
                                                      U(STREAM_LIGHT_U), U(STREAM_LIGHT_V));
                const float bxdf_e_pdf = bxdf_pdf(a, m, normal, u, v, in_dir, e.dir);
                const float e_weight = power_heuristic(e.pdf, bxdf_e_pdf);
                const float e_bxdf_pdf = emissive_pdf(a, lp.idx, L, point, normal, b.out);
                b_weight = power_heuristic(b.pdf, e_bxdf_pdf);
                const float n_dot_e = clamp_min(dot3(normal, e.dir), 0.0f);
                const bool valid_e = maxcomp3(e.val) > 0.0f && e.pdf > 0.0f && n_dot_e > 0.0f;
                const F3 b_eval_e = bxdf_eval(a, m, normal, u, v, in_dir, e.dir);
                occl_value = e.val * b_eval_e * tp *
                             safe_div(e_weight * n_dot_e, e.pdf * lp.sel_pdf, F32(1e-12));
                occl_mask = valid_e && maxcomp3(occl_value) > 0.0f;
                occl_maxt = occl_mask ? e.dist - F32(INTERSECTION_WITH_LIGHT_EPSILON) : 0.0f;
                occl_d = e.dir;
            }
            // singular BxDFs keep weight 1 (pt_integrator.cl:166-168)
            if (m.type & BXDF_SINGULAR_MASK) b_weight = 1.0f;

            // --- throughput and the indirect ray (pt_integrator.cl:170-177)
            const F3 tp_mul = b.val * tint * (b_weight * fabsf(dot3(normal, b.out)));
            next_mask = maxcomp3(tp_mul) > 0.0f && b.pdf > F32(1e-12);
            const float inv_pdf = safe_div(1.0f, b.pdf, F32(1e-12));
            if (next_mask) tp = tp * tp_mul * inv_pdf;
        }
    }
    radiance = radiance + emit_add;

    store3(a.out_radiance, i, radiance);
    store3(a.next_o, i, next_o);
    store3(a.next_d, i, next_d);
    a.next_mask[i] = next_mask;
    store3(a.out_throughput, i, tp);
    a.out_flags[i] = flags;
    store3(a.occl_o, i, occl_o);
    store3(a.occl_d, i, occl_d);
    a.occl_maxt[i] = occl_maxt;
    a.occl_mask[i] = occl_mask;
    store3(a.occl_value, i, occl_value);
}

// radiance += occl_value where the shadow ray reached its light
__global__ void __launch_bounds__(THREADS)
    nee_add_kernel(long long n, float* radiance, const uint8_t* occl_mask,
                   const uint8_t* occluded, const float* value) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (i >= n) return;
    const bool nee = occl_mask[i] && !occluded[i];
#pragma unroll
    for (int c = 0; c < 3; ++c)
        radiance[3 * i + c] = radiance[3 * i + c] + (nee ? value[3 * i + c] : 0.0f);
}

inline unsigned blocks(long long n) { return static_cast<unsigned>((n + THREADS - 1) / THREADS); }

}  // namespace polaris_shade

using polaris_shade::blocks;
using polaris_shade::ShadeArgs;
using polaris_shade::THREADS;

extern "C" int polaris_shade_bounce(const ShadeArgs* args, void* stream) {
    if (args->n <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    polaris_shade::shade_bounce_kernel<<<blocks(args->n), THREADS, 0, s>>>(*args);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int polaris_nee_add(long long n, float* radiance, const uint8_t* occl_mask,
                               const uint8_t* occluded, const float* value, void* stream) {
    if (n <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
    polaris_shade::nee_add_kernel<<<blocks(n), THREADS, 0, s>>>(n, radiance, occl_mask,
                                                                occluded, value);
    return static_cast<int>(cudaGetLastError());
}

// registers a thread and local memory bytes (a spill shows there) of the
// shading kernel, as the loaded binary has them
extern "C" int polaris_shade_attributes(int* regs, int* local_bytes) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, polaris_shade::shade_bounce_kernel);
    if (err != cudaSuccess) return static_cast<int>(err);
    *regs = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    return 0;
}
