// Dense (traversal-free) intersection for small scenes on NVIDIA Hopper
// (sm_90a): closest hit and any hit.
//
// Replaces the TPU kernel polaris_tpu/ops/intersect_pallas_dense.py::_kernel.
// What is kept is what it computes: no BVH; every instance in order, the ray
// moved into the instance's space once (the transform hoisted out of the
// triangle loop), then every triangle of the instance's contiguous range
// [first, first + count) in order, through the det^2-scaled Moller-Trumbore
// test with a strict cross-multiplied best-hit compare. The best hit stays
// numerators over one denominator across EVERY triangle of EVERY instance and
// is divided ONCE per ray at the end (the BVH kernels divide at each leaf),
// so an acceptance compare rounds differently here and a near-tie may keep
// another triangle than a BVH kernel does. What is not carried over: the
// (8,128) ray tiles, the SMEM copies of triangles and matrices, and the
// ranges passed as data to keep Mosaic from unrolling.
//
// What bounds it on this card: float operations. Every ray tests every
// triangle (56 flops each) and moves into every instance (36); the bytes are
// the rays, the results and at most 4096 triangles. Built with -fmad=false
// (each multiply and add its own instruction, as the plain version rounds),
// it can reach about half of the bound, which counts a fused multiply-add as
// two operations.
//
// Design, on the block-local schedule of traverse_block.cuh (no counter,
// live rays compacted per window):
//   * K5's own buffer (ops/intersect_dense.py::pack_scene_k5) of 16-byte
//     words: a 64-byte row per instance [3x4 world->object matrix, first,
//     count, 0, 0], then a 48-byte row per triangle [v0, e1, e2] (.w
//     unused), the rows scaled_math takes. It sits in shared memory when it
//     is small (cornell's 2,880 bytes, instanced's 16,704; the byte count
//     picks), so a triangle is three 16-byte loads that every lane of a warp
//     shares (a broadcast), an instance four.
//   * the triangles of an instance through scan_rows of traverse_common.cuh,
//     in order, against the numerators and the one denominator carried as
//     ops/intersect_dense.py::dense_plain carries them, so every lane keeps
//     the plain version's bits; any hit leaves at its first accepted
//     triangle. Computing the geometry of 2 or 4 triangles before accepting
//     them in order bought nothing on the H100 (PERF.md).
//
// Tensor cores have no place here: the work is dependent scalar fp32
// arithmetic whose compares must round as the plain version's do.

#include "traverse_block.cuh"

namespace {

using namespace polaris;

constexpr int INST_WORDS = 4, TRI_WORDS = 3;

// K5's own buffer (see the head of this file)
struct DenseScene {
    const float4* __restrict__ words;
    int num_words, num_inst, num_tris;
    int tri_at;  // the first triangle row's word
};

template <bool ANY_HIT, bool STAGED>
__global__ void __launch_bounds__(BLOCK_RAYS) dense(DenseScene sc, Rays rays) {
    extern __shared__ __align__(16) float4 smem[];
    const float4* base = sc.words;
    if constexpr (STAGED) {
        stage_words_block(smem, sc.words, sc.num_words);
        base = smem;
    }
    const Words<STAGED> w{base};
    const auto rows = [&](int tri, float4& a, float4& b, float4& c) {
        const int at = sc.tri_at + TRI_WORDS * tri;
        a = w[at];
        b = w[at + 1];
        c = w[at + 2];
    };
    live_windows<ANY_HIT>(rays, [&](int ray) {
        if (ray < 0) return;
        const Ray world = load_ray(rays, ray);
        Best best{rays.maxt[ray], 0.0f, 0.0f, 0, 0, false};
        float den = 1.0f;
        bool accepted = false;
        for (int inst = 0; inst < sc.num_inst; ++inst) {
            const int at = INST_WORDS * inst;
            Ray r = world;
            to_instance_rows(r, w[at], w[at + 1], w[at + 2]);
            const float4 range = w[at + 3];
            if (scan_rows<ANY_HIT, LEAF_DET2>(r, rows, __float_as_int(range.x),
                                              __float_as_int(range.y), sc.num_tris - 1,
                                              inst, best, den, accepted))
                break;
        }
        if (!ANY_HIT) to_quotients(best, den);
        store_hit<ANY_HIT>(rays, ray, best);
    });
}

template <bool ANY_HIT>
int run(const void* words, int num_words, int num_inst, int num_tris, int staged,
        const Rays& rays, void* stream) {
    const DenseScene sc{static_cast<const float4*>(words), num_words, num_inst,
                        num_tris, INST_WORDS * num_inst};
    if (staged)
        return launch_block<ANY_HIT, true>(dense<ANY_HIT, true>, sc, 16 * (size_t)num_words, rays, stream);
    return launch_block<ANY_HIT, false>(dense<ANY_HIT, false>, sc, 0, rays, stream);
}

}  // namespace

// K5's buffer (ops/intersect_dense.py::pack_scene_k5) and whether it is
// staged in shared memory
#define K5_ARGS const void *words, int num_words, int num_inst, int num_tris, int staged
#define K5_SCENE words, num_words, num_inst, num_tris, staged

extern "C" int polaris_dense_closest_hit(K5_ARGS, POLARIS_CLOSEST_ARGS) {
    return run<false>(K5_SCENE, POLARIS_CLOSEST_RAYS, stream);
}

extern "C" int polaris_dense_any_hit(K5_ARGS, POLARIS_ANY_ARGS) {
    return run<true>(K5_SCENE, POLARIS_ANY_RAYS, stream);
}
