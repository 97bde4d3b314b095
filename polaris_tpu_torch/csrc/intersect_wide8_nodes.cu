// 8-wide two-level BVH traversal over 64-float node records for NVIDIA
// Hopper (sm_90a): closest hit and any hit. The kernel of the big-scene path.
//
// Replaces the TPU kernel polaris_tpu/ops/intersect_pallas8_nodes.py::_kernel.
// What is kept is its node layout, entry encoding and child order:
//
//   * the binary BVH collapsed host-side into nodes of up to 8 children, one
//     64-float record each: boxes(48), child c at [6c, 6c+6) as (min xyz,
//     max xyz), then (lo, hi) x 8: each child entry as two exact small floats,
//     lo = index, hi = type*64 + count
//   * entry = type<<30 | count<<24 | index (type 0 empty, 1 wide node,
//     2 triangle leaf, 3 instance): 24-bit indices, counts below 64
//   * records numbered by BFS depth, so the top of the forest is contiguous
//   * one visit slab-tests all 8 children, continues at the nearest and
//     pushes the rest in slot order (traverse_wide.cuh)
//
// This is a second LAYOUT of the traversal body that intersect_wide8.cu
// uses, in a library of its own, with the TPU kernel's own leaf arithmetic:
// det^2-scaled Moller-Trumbore, the denominator reset at every leaf and one
// divide when the leaf ends (LEAF_DET2 of traverse_common.cuh). On the same
// triangle it returns the binary kernels' t, u, v bit for bit.
//
// What is not carried over: the (8,128) ray tiles and their tile-min
// reductions, the resident SMEM prefix of nodes, the 2-way LRU window caches
// for records and triangles with their DMAs, the STREAM_ALIGN padding.
//
// Design: one thread per ray, a private 96-entry stack of entries (the host
// packer refuses a tree that could need more). A visit touches one 256-byte
// record: two 128-byte cache lines hold all 8 boxes and all 8 entries, where
// the binary kernels chase a pointer per level. Scalar loads through the
// read-only path: a simple kernel first.
//
// What bounds it on this card: dependent cache loads and divergence; on the
// 819k-triangle terrain the leaves (up to 48 triangles of 36 bytes, 29 MB in
// all) no longer fit L1, and the L2 hit rate decides. Fewer, fatter visits
// are what the layout does about the first.

#include "traverse_wide.cuh"

namespace {

using namespace polaris;

constexpr int REC = 64;

struct Layout {
    const float* __restrict__ records;    // (W,64)
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
        const float* e = records + REC * (size_t)min(node, num_wide - 1) + 48 + 2 * c;
        return ((uint32_t)__ldg(e + 1) << 24) | (uint32_t)__ldg(e);
    }
    __device__ __forceinline__ float slab(int node, int c, const Ray& r,
                                          float best) const {
        const float* b = records + REC * (size_t)min(node, num_wide - 1) + 6 * c;
        return polaris::slab(r, __ldg(b + 0), __ldg(b + 1), __ldg(b + 2),
                             __ldg(b + 3), __ldg(b + 4), __ldg(b + 5), best);
    }
    static __device__ __forceinline__ void decode(uint32_t e, int& typ,
                                                  int& cnt, int& idx) {
        typ = (int)(e >> 30);
        cnt = (int)((e >> 24) & 0x3Fu);
        idx = (int)(e & 0xFFFFFFu);
    }
};

template <bool ANY_HIT>
__global__ void __launch_bounds__(THREADS) traverse(Layout s, Rays rays) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= rays.n) return;
    traverse_wide<ANY_HIT, LEAF_DET2>(s, rays, i);
}

}  // namespace

#define SCENE_ARGS                                                             \
    const float *records, const int *inst_entries, const float *tris,          \
        const float *w2o, int root_entry, int num_wide, int num_tris,          \
        int num_inst
#define SCENE                                                                  \
    Layout {                                                                   \
        records, inst_entries,                                                 \
            polaris::Tris{tris, tris + 3, tris + 6, 9, num_tris}, w2o,         \
            root_entry, num_wide, num_inst                                     \
    }

extern "C" int polaris_wide8_nodes_closest_hit(SCENE_ARGS, POLARIS_CLOSEST_ARGS) {
    return polaris::launch(traverse<false>, SCENE, POLARIS_CLOSEST_RAYS, stream);
}

extern "C" int polaris_wide8_nodes_any_hit(SCENE_ARGS, POLARIS_ANY_ARGS) {
    return polaris::launch(traverse<true>, SCENE, POLARIS_ANY_RAYS, stream);
}
