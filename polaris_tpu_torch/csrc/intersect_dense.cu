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
// Design: one thread per ray, no stack at all. All threads of a warp read
// the same triangle at the same time, so each 36-byte triangle is one
// broadcast load from L1. The triangle test is scan_scaled<LEAF_DET2> of
// traverse_common.cuh, the arithmetic of ops/intersect_dense.py::dense_plain.
//
// What bounds it on this card: float operations. Every ray tests every
// triangle (59 flops each), the bytes are the rays plus at most 4096
// triangles. The design does nothing about it: testing everything is what
// the kernel is. On the TPU that bought a loop free of scalar-core votes; a
// GPU thread pays nothing for its own control flow, and the measurements in
// PERF.md show the BVH kernels ahead of this one from a few dozen triangles
// on. It stays as the counterpart of the TPU kernel, as the second kernel of
// the 'hybrid' mode and as an order-free reference for the others.

#include "traverse_common.cuh"

namespace {

using namespace polaris;

struct Scene {
    const int* __restrict__ ranges;  // (I,2): first triangle, count
    Tris tris;                       // packed (T,9)
    const float* __restrict__ w2o;   // (I,12) rows of the 3x4 matrices
    int num_inst;
};

template <bool ANY_HIT>
__global__ void __launch_bounds__(THREADS) dense(Scene s, Rays rays) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= rays.n) return;

    Best best{0.0f, 0.0f, 0.0f, 0, 0, false};
    if (rays.active[i]) {
        const Ray world = load_ray(rays, i);
        best.t = rays.maxt[i];
        float den = 1.0f;
        bool accepted = false;
        for (int inst = 0; inst < s.num_inst; ++inst) {
            Ray r = world;
            to_instance(r, s.w2o + 12 * (size_t)inst);
            const int first = __ldg(s.ranges + 2 * inst);
            const int count = __ldg(s.ranges + 2 * inst + 1);
            if (scan_scaled<ANY_HIT, LEAF_DET2>(r, s.tris, first, count, inst,
                                                best, den, accepted))
                break;
        }
        if (!ANY_HIT) to_quotients(best, den);
    }
    store_hit<ANY_HIT>(rays, i, best);
}

}  // namespace

#define SCENE_ARGS                                                             \
    const int *ranges, const float *tris, const float *w2o, int num_tris,      \
        int num_inst
#define SCENE                                                                  \
    Scene {                                                                    \
        ranges, polaris::Tris{tris, tris + 3, tris + 6, 9, num_tris}, w2o,     \
            num_inst                                                           \
    }

extern "C" int polaris_dense_closest_hit(SCENE_ARGS, POLARIS_CLOSEST_ARGS) {
    return polaris::launch(dense<false>, SCENE, POLARIS_CLOSEST_RAYS, stream);
}

extern "C" int polaris_dense_any_hit(SCENE_ARGS, POLARIS_ANY_ARGS) {
    return polaris::launch(dense<true>, SCENE, POLARIS_ANY_RAYS, stream);
}
