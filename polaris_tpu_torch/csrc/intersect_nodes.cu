// K3: two-level binary BVH traversal over depth-ordered 64-byte node records
// for NVIDIA Hopper (sm_90a): closest hit and any hit.
//
// Replaces the TPU kernel polaris_tpu/ops/intersect_pallas_nodes.py::_kernel,
// the streamed-nodes kernel of the big-scene path. What is kept is its node
// layout and what it computes:
//
//   * one record per node, [ld, rd, leftChildBox(6), rightChildBox(6), pad2];
//     ld > 0: inner node with children ld and rd; ld <= 0, rd == 0: TLAS leaf
//     of instance -ld; else a BLAS leaf of rd triangles from -ld
//   * records numbered by BFS depth (host packer)
//   * the traversal order, the det^2-scaled leaf test (LEAF_DET2 of
//     traverse_common.cuh) and so the results of K1 (intersect.cu), bit for
//     bit: near child first, strict best-hit update, ray restored at the
//     stack watermark
//
// What is not carried over: the (8,128) ray tiles and their votes, the
// 2-way LRU window caches and their DMAs, the STREAM_ALIGN padding, and the
// RESIDENT PREFIX (intersect_pallas_nodes.py:14, the reads at :147 and :187,
// the budget pn_resident at :523-589), the shallowest records kept in the
// TPU core's SMEM. Redone as the first R records copied into shared memory
// by each block, it was timed on the H100 at R = 0, 768 (48 KB) and 3,040
// (all the shared memory the stacks leave) on the 819k-triangle terrain,
// and R = 0 read best on every ray set: shared memory is carved out of the
// SRAM that L1 uses, and L1 keeps the hot top of the tree anyway
// (PERF.md).
//
// What bounds K3 on this card (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// and scripts/torch_k1_timing.py --kernels K3, numbers in PERF.md): not
// device-memory bytes nor the fp32 rate (the rays of a 512x512 terrain
// frame touch a few MB and need 2-4% of the time this kernel takes), but
// lanes that wait: on inactive rays (9,813 live shadow rays of 262,144 on
// the 819k-triangle terrain), on the busiest lane of their warp, and on
// chains of dependent loads that miss L1 (the terrain's 39 MB of triangle
// rows and its node records live in L2). The one-thread-per-ray kernel that
// stood here lost most of its time to the schedule, not to the layout: K1,
// on the same tree with its own schedule, took half its time. So K3 is K1's
// schedule (traverse_common.cuh: persistent warps that fetch only live rays,
// while-while, the stack in shared memory) over K1's reader (BinaryReader)
// reading K3's own buffer, ops/intersect_nodes.py::pack_scene_k3: the
// depth-ordered records above with ld and rd as int bits, then 48-byte
// triangle rows (three 16-byte loads each, where the (T,9) rows take nine
// scalar ones; timed against them, they read best on closest hit) and
// 64-byte instance rows [3x4 matrix, root]. The buffer is staged in shared
// memory when it fits beside the stacks (instanced, sphere: K1's shared
// branch), else read through L1 and L2 (the terrains).
//
// Plain C interface (no torch headers): the entry points take raw device
// pointers and a stream and return a CUDA error code.

#include "traverse_common.cuh"

namespace {

using namespace polaris;

// K3's own scene type: the schedule's templates instantiated with it are
// this library's alone, not K1's (see traverse_common.cuh)
struct K3Scene : BinaryScene {};

template <bool ANY_HIT>
int run(const void* words, int num_words, int num_nodes, int num_tris,
        int num_inst, int stack_cap, int staged, unsigned* counters,
        const Rays& rays, void* stream) {
    const int tri_at = 4 * num_nodes;
    const K3Scene s{{static_cast<const float4*>(words), num_words, num_tris,
                     num_inst, tri_at, tri_at + 3 * num_tris, stack_cap}};
    return launch_staged<ANY_HIT, LEAF_DET2>(s, staged, rays, counters, stream);
}

}  // namespace

// K3's own buffer (ops/intersect_nodes.py::pack_scene_k3): its words, node,
// triangle and instance counts, the stack entries per thread and whether the
// buffer is staged in shared memory, and the two counters of the persistent
// launch
#define K3_ARGS                                                                \
    const void *words, int num_words, int num_nodes, int num_tris,             \
        int num_inst, int stack_cap, int staged, unsigned *counters
#define K3_SCENE                                                               \
    words, num_words, num_nodes, num_tris, num_inst, stack_cap, staged,        \
        counters

extern "C" int polaris_nodes_closest_hit(K3_ARGS, POLARIS_CLOSEST_ARGS) {
    return run<false>(K3_SCENE, POLARIS_CLOSEST_RAYS, stream);
}

extern "C" int polaris_nodes_any_hit(K3_ARGS, POLARIS_ANY_ARGS) {
    return run<true>(K3_SCENE, POLARIS_ANY_RAYS, stream);
}
