// The arguments of one shading launch, as ops/shade_cuda.py fills them: one
// struct of 8-byte fields (device pointers and 64-bit integers, so the
// layout has no padding and ctypes declares the same fields in the same
// order, SHADE_FIELDS there), passed to the kernel by value.

#pragma once

#include <cstdint>

#include "shade_rng.cuh"

namespace polaris_shade {

struct ShadeArgs {
    // the scene (scene.py::upload_scene), read-only
    const float* tri_normals;  // [T, 9]
    const float* tri_uvs;      // [T, 6]
    const int* tri_material;   // [T]
    const float* inst_w2o;     // [I, 4, 4]
    const int* mat_type;
    const int* mat_left;
    const int* mat_right;
    const float* mat_mix_weight;
    const int* mat_bump_tex;
    const float* mat_reflectance;    // [M, 3]
    const float* mat_specularity;    // [M, 3]
    const float* mat_transmittance;  // [M, 3]
    const float* mat_radiance;       // [M, 3]
    const float* mat_int_ior;
    const float* mat_ext_ior;
    const float* mat_scale;
    const float* mat_roughness;
    const int* mat_reflectance_tex;
    const int* mat_specularity_tex;
    const int* mat_transmittance_tex;
    const int* mat_radiance_tex;
    const int* mat_roughness_tex;
    const float* mat_int_disp_ior;  // [M, 3]
    const float* mat_ext_disp_ior;  // [M, 3]
    const long long* tex_table;     // [n_tex, 4]: offset, width, height, store
    const float* tex_data;
    const uint8_t* tex_data_u8;
    long long tex_f32_len, tex_u8_len;
    const int* emis_tri;
    const float* emis_o2w;   // [L, 4, 4]
    const float* emis_nmat;  // [L, 3, 3]
    const float* emis_area;
    const int* emis_type;
    const int* emis_mat;
    const float* tri_v0;  // [T, 3]
    const float* tri_e1;
    const float* tri_e2;
    // what the scene holds (bits of ops/shade_cuda.py: STATIC_*), and the
    // integrator's constants
    long long statics, num_emissives, scene_diffuse_mat, min_bounces_for_rr,
        material_depth;
    // the lanes
    long long n;
    const float* ray_o;  // [N, 3]
    const float* ray_d;  // [N, 3]
    const uint8_t* alive;
    const float* hit_t;
    const float* hit_u;
    const float* hit_v;
    const int* hit_tri;
    const int* hit_inst;
    const uint8_t* hit_mask;
    const float* throughput;  // [N, 3]
    const int* flags;
    const float* radiance;  // [N, 3]
    Counter seed, pixel, sample, bounce, rr_key, is_primary;
    // the results
    float* out_radiance;  // [N, 3]
    float* next_o;        // [N, 3]
    float* next_d;        // [N, 3]
    uint8_t* next_mask;
    float* out_throughput;  // [N, 3]
    int* out_flags;
    float* occl_o;  // [N, 3]
    float* occl_d;  // [N, 3]
    float* occl_maxt;
    uint8_t* occl_mask;
    float* occl_value;  // [N, 3]
};

// ShadeArgs::statics
constexpr long long STATIC_DISPERSE = 1;  // a disperse node: IORs forced
constexpr long long STATIC_TEX_F32 = 2;   // a texture stored as float32
constexpr long long STATIC_TEX_U8 = 4;    // one stored as bytes
constexpr long long STATIC_TEX_LUM8 = 8;  // one stored as Luminance8
constexpr long long STATIC_UV = 16;       // a surface samples a texture at its uv

}  // namespace polaris_shade
