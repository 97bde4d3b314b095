// The layered-material walk of the shading kernel: ops/material.py's
// select_material for one lane (material_sampler.cl:21-108, matSelectNode).
//
// The plain version moves every lane one tree level per iteration of a loop
// of material_depth levels; here a lane walks its own tree and stops at its
// leaf, where the plain version's lane holds still: the same nodes, draws
// (stream STREAM_MAT_MIX / STREAM_DISPERSE + level) and updates.

#pragma once

#include "shade_args.cuh"
#include "shade_rng.cuh"
#include "shade_texture.cuh"
#include "shade_vec.cuh"

namespace polaris_shade {

constexpr int OP_MIX = 10001;
constexpr int OP_MIX_MAP = 10002;
constexpr int OP_BUMP_MAP = 10003;
constexpr int OP_NORMAL_MAP = 10004;
constexpr int OP_DISPERSE = 10005;

constexpr int PATH_FLAG_DISPERSE_R = 1;
constexpr int PATH_FLAG_DISPERSE_G = 2;
constexpr int PATH_FLAG_DISPERSE_B = 4;

// the fields of the leaf a lane's walk ends on (material.gather_material)
struct Leaf {
    int node, type;
    float int_ior, ext_ior, scale;
};

// material_sampler.cl:124-131
__device__ __forceinline__ F3 apply_bump_map(const ShadeArgs& a, F3 normal, float u, float v,
                                             int tex) {
    const F3 t = tex_bump_sample3(a, u, v, tex);
    const F3 s = f3(t.x * 2.0f - 1.0f, t.y * 2.0f - 1.0f, t.z * 2.0f - 1.0f);
    F3 tu, tv;
    tangent_basis(normal, tu, tv);
    return normalize3(tu * s.x + tv * s.y + normal * s.z);
}

// material_sampler.cl:111-121: R/G in [-1, 1], B halved
__device__ __forceinline__ F3 apply_normal_map(const ShadeArgs& a, F3 normal, float u, float v,
                                               int tex) {
    const F3 t = tex_sample3(a, u, v, tex);
    const F3 s = f3(t.x * 2.0f - 1.0f, t.y * 2.0f - 1.0f, t.z * 2.0f - 1.0f);
    F3 tu, tv;
    tangent_basis(normal, tu, tv);
    return normalize3(tu * s.x + tv * s.y + (0.5f * normal) * s.z);
}

// walks from `root`; updates normal, tint and flags as the plain version does
__device__ __forceinline__ Leaf select_material(const ShadeArgs& a, const Draws& U, int root,
                                                F3& normal, float u, float v, F3& tint,
                                                int& flags) {
    int node = root;
    float force_int = 0.0f, force_ext = 0.0f;
    for (int level = 0; level < a.material_depth; ++level) {
        const int t = __ldg(a.mat_type + node);
        if (t < OP_MIX) break;  // a leaf: the plain lane holds still from here
        const int left = __ldg(a.mat_left + node);
        if (t == OP_MIX || t == OP_MIX_MAP) {
            const float draw = U(STREAM_MAT_MIX + level);
            const float mix_w = t == OP_MIX_MAP
                                    ? tex_sample1(a, u, v, __ldg(a.mat_bump_tex + node))
                                    : __ldg(a.mat_mix_weight + node);
            node = draw < mix_w ? left : __ldg(a.mat_right + node);
            continue;
        }
        if (t == OP_BUMP_MAP) {
            normal = apply_bump_map(a, normal, u, v, __ldg(a.mat_bump_tex + node));
        } else if (t == OP_NORMAL_MAP) {
            normal = apply_normal_map(a, normal, u, v, __ldg(a.mat_bump_tex + node));
        } else if (t == OP_DISPERSE) {
            // material_sampler.cl:46-82
            const float du = U(STREAM_DISPERSE + level);
            const bool has_r = (flags & PATH_FLAG_DISPERSE_R) != 0;
            const bool has_g = (flags & PATH_FLAG_DISPERSE_G) != 0;
            const bool has_b = (flags & PATH_FLAG_DISPERSE_B) != 0;
            const bool has_any = has_r || has_g || has_b;
            const bool new_r = !has_any && du < F32(0.333);
            const bool new_g = !has_any && !new_r && du < F32(0.666);
            const bool new_b = !has_any && !new_r && !new_g;
            const bool sel_r = has_r || new_r;
            const bool sel_g = has_g || new_g;
            const bool sel_b = !sel_r && !sel_g && (has_b || new_b);
            tint = f3(sel_r ? 1.0f : 0.0f, sel_g ? 1.0f : 0.0f, sel_b ? 1.0f : 0.0f);
            const float* ia = a.mat_int_disp_ior + 3 * node;
            const float* ea = a.mat_ext_disp_ior + 3 * node;
            force_int = sel_r ? __ldg(ia) : (sel_g ? __ldg(ia + 1) : __ldg(ia + 2));
            force_ext = sel_r ? __ldg(ea) : (sel_g ? __ldg(ea + 1) : __ldg(ea + 2));
            if (!has_any)
                flags |= new_r ? PATH_FLAG_DISPERSE_R
                               : (new_g ? PATH_FLAG_DISPERSE_G : PATH_FLAG_DISPERSE_B);
        }
        node = left;
    }
    Leaf leaf;
    leaf.node = node;
    leaf.type = __ldg(a.mat_type + node);
    leaf.int_ior = __ldg(a.mat_int_ior + node);
    leaf.ext_ior = __ldg(a.mat_ext_ior + node);
    leaf.scale = __ldg(a.mat_scale + node);
    if (a.statics & STATIC_DISPERSE) {
        leaf.int_ior = maximum(leaf.int_ior, force_int);
        leaf.ext_ior = maximum(leaf.ext_ior, force_ext);
    }
    return leaf;
}

}  // namespace polaris_shade
