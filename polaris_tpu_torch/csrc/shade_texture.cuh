// Texture sampling of the shading kernel: ops/texture.py for one lane.
//
// Repeat wrap, bilinear taps with the +1 texel clamped at the edge, bytes
// dequantised after the fetch by float32(1/255), the blend in the plain
// version's association, and the 3-tap bump normal; over the three storage
// kinds (float32 RGBA, Rgba8, Luminance8), which a scene may mix. A lane
// samples only where its texture index is set: the plain version samples
// every lane and selects the constant where the index is negative, the same
// value.

#pragma once

#include "shade_args.cuh"
#include "shade_vec.cuh"

namespace polaris_shade {

constexpr long long STORE_F32 = 0, STORE_LUM8 = 2;

// one lane's 2x2 footprint in one texture (texture._corners)
struct Footprint {
    long long off, w, store, tx, ty, bx, by;
    float cx, cy;
};

__device__ __forceinline__ Footprint footprint(const ShadeArgs& a, float u, float v, int tex_idx) {
    const long long* row = a.tex_table + 4 * static_cast<long long>(max(tex_idx, 0));
    Footprint f;
    f.off = __ldg(row);
    f.w = __ldg(row + 1);
    const long long h = __ldg(row + 2);
    f.store = __ldg(row + 3);
    const float su = (u - floorf(u)) * static_cast<float>(f.w);
    const float sv = (v - floorf(v)) * static_cast<float>(h);
    // a truncating cast, then the clip that catches su == w
    f.tx = min(max(static_cast<long long>(static_cast<int>(su)), 0LL), f.w - 1);
    f.ty = min(max(static_cast<long long>(static_cast<int>(sv)), 0LL), h - 1);
    f.cx = su - static_cast<float>(f.tx);
    f.cy = sv - static_cast<float>(f.ty);
    f.bx = min(f.tx + 1, f.w - 1);
    f.by = min(f.ty + 1, h - 1);
    return f;
}

// channel c of the texel at (x, y); a Luminance8 texel serves every channel
__device__ __forceinline__ float texel(const ShadeArgs& a, const Footprint& f, long long y,
                                       long long x, int c) {
    const bool has_f32 = (a.statics & STATIC_TEX_F32) != 0;
    const bool has_u8 = (a.statics & STATIC_TEX_U8) != 0;
    long long step = 4, chan = c;
    if (a.statics & STATIC_TEX_LUM8) {
        const bool lum = f.store == STORE_LUM8;
        step = lum ? 1 : 4;
        chan = lum ? 0 : c;
    }
    const long long at = f.off + (y * f.w + x) * step + chan;
    // in a mixed scene the lanes of the other family index out of this
    // atlas's range: clipped, as the plain version clips, and dropped below
    float qf = 0.0f, qu = 0.0f;
    if (has_f32) qf = __ldg(a.tex_data + min(max(at, 0LL), a.tex_f32_len - 1));
    if (has_u8)
        qu = static_cast<float>(__ldg(a.tex_data_u8 + min(max(at, 0LL), a.tex_u8_len - 1))) *
             F32(1.0 / 255.0);
    if (has_f32 && has_u8) return f.store != STORE_F32 ? qu : qf;
    return has_f32 ? qf : qu;
}

__device__ __forceinline__ float bilinear(float tl, float tr, float bl, float br, float cx,
                                          float cy) {
    return (tl * (1.0f - cy) + bl * cy) * (1.0f - cx) + (tr * (1.0f - cy) + br * cy) * cx;
}

__device__ __forceinline__ float tex_channel(const ShadeArgs& a, const Footprint& f, int c) {
    return bilinear(texel(a, f, f.ty, f.tx, c), texel(a, f, f.ty, f.bx, c),
                    texel(a, f, f.by, f.tx, c), texel(a, f, f.by, f.bx, c), f.cx, f.cy);
}

__device__ __forceinline__ F3 tex_sample3(const ShadeArgs& a, float u, float v, int tex_idx) {
    const Footprint f = footprint(a, u, v, tex_idx);
    return f3(tex_channel(a, f, 0), tex_channel(a, f, 1), tex_channel(a, f, 2));
}

__device__ __forceinline__ float tex_sample1(const ShadeArgs& a, float u, float v, int tex_idx) {
    return tex_channel(a, footprint(a, u, v, tex_idx), 0);
}

// 0.5 + 0.5 * normalize(s1 - s0, s2 - s0, 1) (texture_sampler.cl:187-253)
__device__ __forceinline__ F3 tex_bump_sample3(const ShadeArgs& a, float u, float v, int tex_idx) {
    const Footprint f = footprint(a, u, v, tex_idx);
    const float s0 = texel(a, f, f.ty, f.tx, 0);
    const float dx = texel(a, f, f.ty, f.bx, 0) - s0;
    const float dy = texel(a, f, f.by, f.tx, 0) - s0;
    // 1.0 / x: PyTorch's reciprocal, times 1
    const float inv_len = (1.0f / sqrtf(dx * dx + dy * dy + 1.0f)) * 1.0f;
    return f3(0.5f + 0.5f * (dx * inv_len), 0.5f + 0.5f * (dy * inv_len), 0.5f + 0.5f * inv_len);
}

// texture-or-constant (material_sampler.cl matGetSample3f / 1f)
__device__ __forceinline__ F3 mat_sample3(const ShadeArgs& a, float u, float v, F3 def,
                                          int tex_idx) {
    return tex_idx < 0 ? def : tex_sample3(a, u, v, tex_idx);
}
__device__ __forceinline__ float mat_sample1(const ShadeArgs& a, float u, float v, float def,
                                             int tex_idx) {
    return tex_idx < 0 ? def : tex_sample1(a, u, v, tex_idx);
}

}  // namespace polaris_shade
