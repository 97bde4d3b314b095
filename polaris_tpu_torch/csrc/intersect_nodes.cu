// Two-level binary BVH traversal over 16-float node records for NVIDIA Hopper
// (sm_90a): closest hit and any hit.
//
// Replaces the TPU kernel polaris_tpu/ops/intersect_pallas_nodes.py::_kernel,
// the streamed-nodes kernel of the big-scene path. What is kept is its node
// layout and what it computes:
//
//   * one record per node, [ld, rd, leftChildBox(6), rightChildBox(6), pad2],
//     ld / rd stored as exact small floats; ld > 0: inner node with children
//     ld and rd; ld <= 0, rd == 0: TLAS leaf of instance -ld; else a BLAS
//     leaf of rd triangles from -ld
//   * records numbered by BFS depth (host packer), so the top of the forest
//     is one contiguous, always-cached range
//   * the traversal order, the det^2-scaled leaf test (LEAF_DET2 of
//     traverse_common.cuh) and so the results of the binary kernel
//     (intersect.cu), bit for bit: near child first, strict best-hit update,
//     ray restored at the stack watermark
//
// What is not carried over: the (8,128) ray tiles and their votes, the
// resident SMEM prefix, the 2-way LRU window caches and their DMAs, the
// STREAM_ALIGN padding. Here the record array lies in global memory behind
// L2 as a whole.
//
// Design: one thread per ray, a private 64-entry stack (the packer refuses a
// deeper forest). A visit reads its record as float4s through the read-only
// path: the first 16 bytes decide the node's kind, the other 48 follow only
// for an inner node, and both children's slab tests then need no further
// load, where intersect.cu makes four dependent ones. Triangles are rows of
// one packed (T,9) array, one 36-byte read each.
//
// What bounds it on this card: as intersect.cu, dependent cache loads and
// warp divergence, not device-memory bytes or fp32 operations; on scenes
// whose records and triangles exceed L1 (the 819k-triangle terrain holds
// 29 MB of triangles) the L2 hit rate. The depth order and the one-fetch
// record are what the design does about it.

#include "traverse_common.cuh"

namespace {

using namespace polaris;

constexpr int STACK_SIZE = 64;

struct Scene {
    const float4* __restrict__ nodes;  // (N,4) float4 = (N,16) floats
    Tris tris;                         // packed (T,9)
    const float* __restrict__ w2o;     // (I,12) rows of the 3x4 matrices
    const int* __restrict__ roots;     // (I,)
    int num_nodes;
    int num_inst;
};

template <bool ANY_HIT>
__global__ void __launch_bounds__(THREADS) traverse(Scene s, Rays rays) {
    constexpr int LEAF = LEAF_DET2;
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= rays.n) return;

    Best best{0.0f, 0.0f, 0.0f, 0, 0, false};

    if (rays.active[i]) {
        const Ray world = load_ray(rays, i);
        Ray r = world;
        best.t = rays.maxt[i];

        int stack[STACK_SIZE];
        int sp = 0, msbi = -1, node = 0, inst = 0;

        while (true) {
            const float4* rec = s.nodes + 4 * (size_t)min(max(node, 0), s.num_nodes - 1);
            const float4 a = __ldg(rec);  // ld, rd, left min x, left min y
            const int ld = (int)a.x;
            const int rd = (int)a.y;
            bool pop = false;
            if (ld <= 0) {
                if (rd == 0) {
                    // TLAS leaf: move the ray into the instance's space
                    int id = min(max(-ld, 0), s.num_inst - 1);
                    to_instance(r, s.w2o + 12 * (size_t)id);
                    msbi = sp;
                    inst = id;
                    node = __ldg(s.roots + id);
                    continue;
                }
                // BLAS leaf: rd triangles starting at -ld
                if (test_leaf<ANY_HIT, LEAF>(r, s.tris, -ld, rd, inst, best)) break;
                pop = true;
            } else {
                // inner node: both children's boxes are in the record
                const float4 b = __ldg(rec + 1);  // l min z, l max x y z
                const float4 c = __ldg(rec + 2);  // r min x y z, r max x
                const float4 e = __ldg(rec + 3);  // r max y z, pad, pad
                float l_dist = slab(r, a.z, a.w, b.x, b.y, b.z, b.w, best.t);
                float r_dist = slab(r, c.x, c.y, c.z, c.w, e.x, e.y, best.t);
                bool want_l = l_dist < FLT_MAX_F, want_r = r_dist < FLT_MAX_F;
                if (want_l & want_r) {
                    bool near_is_l = l_dist <= r_dist;
                    stack[min(sp, STACK_SIZE - 1)] = near_is_l ? rd : ld;
                    ++sp;
                    node = near_is_l ? ld : rd;
                } else if (want_l | want_r) {
                    node = want_l ? ld : rd;
                } else {
                    pop = true;
                }
            }
            if (pop) {
                if (sp == msbi) {
                    // leaving the BLAS: back to the world-space ray
                    r = world;
                    msbi = -1;
                }
                --sp;
                if (sp < 0) break;
                node = stack[min(sp, STACK_SIZE - 1)];
            }
        }
    }
    store_hit<ANY_HIT>(rays, i, best);
}

}  // namespace

#define SCENE_ARGS                                                             \
    const float *nodes, const float *tris, const float *w2o, const int *roots, \
        int num_nodes, int num_tris, int num_inst
#define SCENE                                                                  \
    Scene {                                                                    \
        reinterpret_cast<const float4*>(nodes),                                \
            polaris::Tris{tris, tris + 3, tris + 6, 9, num_tris}, w2o, roots,  \
            num_nodes, num_inst                                                \
    }

extern "C" int polaris_nodes_closest_hit(SCENE_ARGS, POLARIS_CLOSEST_ARGS) {
    return polaris::launch(traverse<false>, SCENE, POLARIS_CLOSEST_RAYS, stream);
}

extern "C" int polaris_nodes_any_hit(SCENE_ARGS, POLARIS_ANY_ARGS) {
    return polaris::launch(traverse<true>, SCENE, POLARIS_ANY_RAYS, stream);
}
