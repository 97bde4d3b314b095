// K2: 8-wide two-level BVH traversal over depth-ordered wide-node records
// for NVIDIA Hopper (sm_90a): closest hit and any hit. The kernel of the
// big-scene path.
//
// Replaces the TPU kernel polaris_tpu/ops/intersect_pallas8_nodes.py::_kernel.
// What is kept is its node layout, entry encoding and child order:
//
//   * the binary BVH collapsed host-side into nodes of up to 8 children, one
//     record each: 8 child boxes (min xyz, max xyz) and 8 child entries
//   * entry = type<<30 | count<<24 | index (type 0 empty, 1 wide node,
//     2 triangle leaf, 3 instance): 24-bit indices, counts below 64
//   * records numbered by BFS depth, so the top of the forest is contiguous
//   * one visit slab-tests all 8 children, continues at the nearest hit
//     child (the first of equal distances) and pushes the other hit children
//     in slot order; an instance entry moves the ray into the instance's
//     space and the stack watermark restores it
//   * the TPU kernel's own leaf arithmetic: det^2-scaled Moller-Trumbore,
//     the denominator reset at every leaf and one divide when the leaf ends
//     (LEAF_DET2 of traverse_common.cuh); on the same triangle it returns
//     the binary kernels' t, u, v bit for bit
//
// What is not carried over: the (8,128) ray tiles and their tile-min
// reductions, the 2-way LRU window caches for records and triangles with
// their DMAs, the STREAM_ALIGN padding, and the resident prefix of records
// (p8n_resident, intersect_pallas8_nodes.py:189-239): redone as the first R
// records in shared memory it read slower on the H100 than R = 0 at 219
// and 685 records, as K3's did (intersect_nodes.cu).
//
// What bounds K2 on this card (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// and scripts/torch_k1_timing.py --kernels K2, numbers in PERF.md): as K1
// and K3, lanes that wait, not bytes or fp32 operations: on inactive rays
// (9,813 live shadow rays of 262,144 on the 819k-triangle terrain), on the
// busiest lane of their warp, on a neighbour's 48-triangle leaf, and on
// loads that miss L1. The one-thread-per-ray kernel that stood here rebuilt
// every child entry from two floats read by scalar loads, read each child's
// box by six more and each triangle by nine, and kept a 96-entry stack in
// local memory. The design:
//
//   * K1's schedule (traverse_common.cuh): persistent warps that fetch only
//     live rays, while-while (the inner steps are wide-node visits and
//     instance entries, the leaf steps triangle-leaf entries), the stack in
//     shared memory sized by the packer's stack_need
//   * K2's own buffer, ops/intersect_wide8_nodes.py::pack_scene_k2: a
//     224-byte record per wide node, the 48 box floats as twelve 16-byte
//     words and the 8 entries as two words of ready
//     typ<<30 | count<<24 | index ints, so a visit is fourteen independent
//     16-byte loads (WideReader, traverse_wide.cuh); then 48-byte triangle
//     rows and 64-byte instance rows [3x4 matrix, the instance's entry], all
//     in one buffer of 16-byte words
//   * the staging of that schedule, picked by the host by byte count: the
//     whole buffer in shared memory (instanced, sphere), else every read
//     through L1 and L2 (the terrains)
//
// It takes 77-78 registers (a visit holds eight distances and entries), so
// one block of 512 threads per SM; capped at 64 for two blocks it spills and
// reads 4-7% slower on closest hit (PERF.md).
//
// Plain C interface (no torch headers): the entry points take raw device
// pointers and a stream and return a CUDA error code.

#include "traverse_wide.cuh"

namespace {

using namespace polaris;

// K2's own scene type: the schedule's templates instantiated with it are
// this library's alone (see traverse_common.cuh)
struct K2Scene : WideScene {};

template <bool ANY_HIT>
int run(const void* words, int num_words, int root_entry, int num_wide,
        int num_tris, int num_inst, int stack_cap, int staged,
        unsigned* counters, const Rays& rays, void* stream) {
    const int tri_at = WIDE_REC_WORDS * num_wide;
    const K2Scene s{{static_cast<const float4*>(words), num_words, num_tris,
                     num_inst, tri_at, tri_at + 3 * num_tris, stack_cap,
                     root_entry, num_wide}};
    return launch_staged<ANY_HIT, LEAF_DET2>(s, staged, rays, counters, stream);
}

}  // namespace

// K2's own buffer (ops/intersect_wide8_nodes.py::pack_scene_k2): its words,
// the root entry, the wide-record, triangle and instance counts, the stack
// entries per thread and whether the buffer is staged in shared memory, and
// the two counters of the persistent launch
#define K2_ARGS                                                                \
    const void *words, int num_words, int root_entry, int num_wide,            \
        int num_tris, int num_inst, int stack_cap, int staged,                 \
        unsigned *counters
#define K2_SCENE                                                               \
    words, num_words, root_entry, num_wide, num_tris, num_inst, stack_cap,     \
        staged, counters

extern "C" int polaris_wide8_nodes_closest_hit(K2_ARGS, POLARIS_CLOSEST_ARGS) {
    return run<false>(K2_SCENE, POLARIS_CLOSEST_RAYS, stream);
}

extern "C" int polaris_wide8_nodes_any_hit(K2_ARGS, POLARIS_ANY_ARGS) {
    return run<true>(K2_SCENE, POLARIS_ANY_RAYS, stream);
}
