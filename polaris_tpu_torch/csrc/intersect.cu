// K1: two-level BVH traversal for NVIDIA Hopper (sm_90a), closest hit and
// any hit.
//
// Replaces the TPU kernel polaris_tpu/ops/intersect_pallas.py::_kernel, with
// both of its triangle tests: det^2-scaled Moller-Trumbore (`mt`, the
// default) and the Havel-Herout precomputed planes (`hh`, chosen when the
// scene is packed). That kernel walks a 1024-ray tile with ONE shared stack
// on the scalar core and votes across the tile at every node, because a TPU
// has no per-lane control flow. None of that staging is carried over. What
// is kept is what it computes:
//
//   * closest hit / any hit over a TLAS of instances and one BLAS per mesh;
//     a TLAS leaf transforms the ray by the instance's 3x4 world->object
//     matrix and the ray is restored when the BLAS is exhausted (stack
//     watermark `msbi`)
//   * slab test with a 1e-30 direction floor; a child is skipped when
//     tf < 0 | tn > tf | tn >= best; the near child is visited first
//   * the leaf arithmetic, det^2-scaled in both tests: numerators u*det,
//     v*det, t*det over det^2 >= EPS^2, 0 <= u_num <= det^2, v_num >= 0,
//     u_num + v_num <= det^2, t_num > EPS*det^2; the best hit compared by
//     cross-multiplication (strict: the first of two equal hits wins), the
//     denominator reset to 1 at every leaf and ONE divide when a leaf ends;
//     any hit compares t_num < maxt*det^2 and never divides
//   * inactive lanes return found = 0, t = 0
//
// Every ray visits the same nodes in the same order and runs the same leaf
// arithmetic as the plain PyTorch version ops/intersect.py::intersect_bvh
// (leaf="det2" | "hh"), so every output is that version's, bit for bit. The
// design below only decides which thread holds a ray, when, and where the
// scene and the stack live.
//
// What bounds K1 on this card (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// and scripts/torch_k1_timing.py, numbers in PERF.md): neither
// device-memory bytes (the rays, the results and the scene records touched
// are a few MB per launch) nor the fp32 rate (the slab and triangle tests
// of a frame's rays come to 2-6% of what a one-thread-per-ray kernel takes,
// 4-14% of this one). The time goes to lanes that wait: on inactive rays,
// on the busiest lane of their warp (the SIMT ceiling of a frame's rays,
// useful lane-steps over issued ones when each warp lasts as long as its
// busiest lane, is 0.72 for primary rays and 0.18-0.51 for bounce and
// shadow rays), on the tail of a single wave, and on dependent loads through
// L1/L2 and a stack in local memory. The design answers each:
//
//   1. PERSISTENT WARPS THAT FETCH ONLY LIVE RAYS. The grid fills the card
//      once (blocks per SM from the occupancy the runtime reports). Each
//      warp takes windows of 32 ray indices from a counter in global memory
//      (one atomicAdd each), writes the results of a window's inactive rays
//      at once and hands only the active ones to its lanes (__ballot_sync,
//      __fns); a lane whose ray is done takes a new one as soon as REFILL
//      lanes of its warp are free (dynamic fetch, Aila and Laine 2009). The
//      last block to finish resets the counter, so a launch needs no memset
//      and replays from a CUDA graph.
//   2. WHILE-WHILE. The lanes of a warp walk inner nodes and TLAS leaves
//      until every live lane holds a BLAS leaf or is done (__any_sync), and
//      only then test leaves, together: a lane no longer waits through a
//      neighbour's 33 triangle tests one inner node at a time. Each ray's
//      visits keep their order; only their timing moves.
//   3. THE SCENE IN SHARED MEMORY. K1's own layout
//      (ops/intersect_cuda.py::pack_scene_k1) is one buffer of 16-byte
//      words: 64-byte node records [ld, rd, left box, right box], 48-byte
//      triangle rows, 64-byte instance rows [3x4 matrix, root]. Each block
//      copies it into shared memory once, by one bulk copy (cp.async.bulk,
//      completion on an mbarrier), when the scene and the block's stacks
//      fit; every read is then a 16-byte shared load, one load level per
//      inner node, and lanes on the same triangle get a broadcast. A scene
//      that does not fit (the terrains) takes the same kernel reading the
//      buffer from global memory (template parameter STAGED); the byte
//      count alone picks.
//   4. THE STACK IN SHARED MEMORY, laid out [depth][thread] so the 32 lanes
//      of a warp always fall on 32 banks, sized by the scene's own depth
//      (the packer's stack_need, at most 64 entries, clamped as the plain
//      version clamps).
//
// The schedule (1, 2, 4 and the copy of 3) lives in traverse_common.cuh, which
// K3 (intersect_nodes.cu) and K2 (intersect_wide8_nodes.cu) share; K1 is
// that schedule over the binary reader (BinaryReader) in two staging
// branches, the whole buffer in shared memory or none of it.
//
// What it costs: 0.013-0.014 ms a launch that traces nothing (every lane
// inactive; the one-thread-per-ray kernel took 0.0035 ms), mostly the
// counter's atomics and the copy of the scene. On launches that take
// 0.02-0.03 ms in all (cornell) that is more than the design saves.
//
// Tensor cores have no place here: the work is dependent scalar fp32
// arithmetic whose compares must round as the plain version's do.
//
// Every sum is written in the plain version's association, and the file is
// compiled with -fmad=false so each multiply and add rounds on its own as it
// does there: kernel and plain version take identical hit/miss decisions.
//
// Plain C interface (no torch headers): the entry points take raw device
// pointers and a stream and return a CUDA error code.

#include "traverse_common.cuh"

namespace {

using namespace polaris;

// threads per block, as ops/intersect_cuda.py's staging rule counts them
constexpr int K1_THREADS = 512;
static_assert(K1_THREADS == BLOCK, "K1 runs the schedule's blocks");

// K1's own scene type: the schedule's templates instantiated with it are
// this library's alone (see traverse_common.cuh)
struct K1Scene : BinaryScene {};

template <bool ANY_HIT, int LEAF>
int run(const void* words, int num_words, int num_tris, int num_inst,
        int tri_at, int inst_at, int stack_cap, int staged, unsigned* counters,
        const Rays& rays, void* stream) {
    const K1Scene s{{static_cast<const float4*>(words), num_words, num_tris,
                     num_inst, tri_at, inst_at, stack_cap}};
    return launch_staged<ANY_HIT, LEAF>(s, staged, rays, counters, stream);
}

}  // namespace

// the packed scene (ops/intersect_cuda.py::pack_scene_k1), whether it is
// staged in shared memory, and the two counters of the persistent launch
#define K1_ARGS                                                                \
    const void *words, int num_words, int num_tris, int num_inst, int tri_at,  \
        int inst_at, int stack_cap, int staged, unsigned *counters
#define K1_SCENE                                                               \
    words, num_words, num_tris, num_inst, tri_at, inst_at, stack_cap, staged,  \
        counters

extern "C" int polaris_closest_hit(K1_ARGS, POLARIS_CLOSEST_ARGS) {
    return run<false, LEAF_DET2>(K1_SCENE, POLARIS_CLOSEST_RAYS, stream);
}

extern "C" int polaris_any_hit(K1_ARGS, POLARIS_ANY_ARGS) {
    return run<true, LEAF_DET2>(K1_SCENE, POLARIS_ANY_RAYS, stream);
}

extern "C" int polaris_closest_hit_hh(K1_ARGS, POLARIS_CLOSEST_ARGS) {
    return run<false, LEAF_HH>(K1_SCENE, POLARIS_CLOSEST_RAYS, stream);
}

extern "C" int polaris_any_hit_hh(K1_ARGS, POLARIS_ANY_ARGS) {
    return run<true, LEAF_HH>(K1_SCENE, POLARIS_ANY_RAYS, stream);
}
