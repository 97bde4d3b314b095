// 8-wide two-level BVH traversal, boxes and entries in separate arrays, for
// NVIDIA Hopper (sm_90a): closest hit and any hit.
//
// Replaces the TPU kernel polaris_tpu/ops/intersect_pallas8.py::_kernel. What
// is kept is its node layout, entry encoding, child order and leaf test:
//
//   * the binary BVH collapsed host-side into nodes of up to 8 children:
//     boxes (W,48) f32, child c at [6c, 6c+6) as (min xyz, max xyz), and
//     entries (W,8) i32
//   * entry = type<<28 | count<<22 | index (type 0 empty, 1 wide node,
//     2 triangle leaf, 3 instance), so index and node count stay below 2^22
//   * one visit slab-tests all 8 children, continues at the nearest and
//     pushes the rest in slot order (traverse_wide.cuh)
//   * quotient-form Moller-Trumbore over the leaf's count triangles
//     (LEAF_QUOT of traverse_common.cuh): this TPU kernel, alone among the
//     five, divides per triangle
//
// What is not carried over: the (8,128) ray tiles, the per-child tile-min
// reductions (dmin_ref) that ordered a tile's shared stack, the SMEM copies
// of every array.
//
// Design: one thread per ray with a private 96-entry stack of entries; the
// host packer refuses a tree that could need more. Boxes and entries are
// read through the read-only path, 6 scalar loads per child box: a simple
// kernel first.
//
// What bounds it on this card: dependent cache loads and divergence, as the
// binary kernels; a wide visit makes its 8 boxes' loads independently of
// each other, which is what the layout buys over two-children nodes.

#include "traverse_wide.cuh"

namespace {

using namespace polaris;

struct Layout {
    const float* __restrict__ boxes;      // (W,48)
    const int* __restrict__ entries;      // (W,8)
    const int* __restrict__ inst_entries; // (I,)
    Tris tris;                            // packed (T,9)
    const float* __restrict__ w2o;        // (I,12)
    int root_entry;
    int num_wide;
    int num_inst;

    __device__ __forceinline__ uint32_t root() const {
        return (uint32_t)root_entry;
    }
    __device__ __forceinline__ uint32_t inst_entry(int id) const {
        return (uint32_t)__ldg(inst_entries + id);
    }
    __device__ __forceinline__ uint32_t entry(int node, int c) const {
        return (uint32_t)__ldg(entries + 8 * (size_t)min(node, num_wide - 1) + c);
    }
    __device__ __forceinline__ float slab(int node, int c, const Ray& r,
                                          float best) const {
        const float* b = boxes + 48 * (size_t)min(node, num_wide - 1) + 6 * c;
        return polaris::slab(r, __ldg(b + 0), __ldg(b + 1), __ldg(b + 2),
                             __ldg(b + 3), __ldg(b + 4), __ldg(b + 5), best);
    }
    static __device__ __forceinline__ void decode(uint32_t e, int& typ,
                                                  int& cnt, int& idx) {
        typ = (int)((e >> 28) & 0x7u);
        cnt = (int)((e >> 22) & 0x3Fu);
        idx = (int)(e & 0x3FFFFFu);
    }
};

template <bool ANY_HIT>
__global__ void __launch_bounds__(THREADS) traverse(Layout s, Rays rays) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= rays.n) return;
    traverse_wide<ANY_HIT, LEAF_QUOT>(s, rays, i);
}

}  // namespace

#define SCENE_ARGS                                                             \
    const float *boxes, const int *entries, const int *inst_entries,           \
        const float *tris, const float *w2o, int root_entry, int num_wide,     \
        int num_tris, int num_inst
#define SCENE                                                                  \
    Layout {                                                                   \
        boxes, entries, inst_entries,                                          \
            polaris::Tris{tris, tris + 3, tris + 6, 9, num_tris}, w2o,         \
            root_entry, num_wide, num_inst                                     \
    }

extern "C" int polaris_wide8_closest_hit(SCENE_ARGS, POLARIS_CLOSEST_ARGS) {
    return polaris::launch(traverse<false>, SCENE, POLARIS_CLOSEST_RAYS, stream);
}

extern "C" int polaris_wide8_any_hit(SCENE_ARGS, POLARIS_ANY_ARGS) {
    return polaris::launch(traverse<true>, SCENE, POLARIS_ANY_RAYS, stream);
}
