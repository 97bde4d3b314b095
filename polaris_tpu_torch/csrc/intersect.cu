// Two-level BVH traversal for NVIDIA Hopper (sm_90a): closest hit and any hit.
//
// Replaces the TPU kernel polaris_tpu/ops/intersect_pallas.py::_kernel, with
// both of its triangle tests: the default Moller-Trumbore (`mt`) and the
// Havel-Herout precomputed planes (`hh`, chosen when the scene is packed).
// That kernel walks a 1024-ray tile with ONE shared stack on the scalar core
// and votes across the tile at every node, because a TPU has no per-lane
// control flow. None of that staging is carried over. What is kept is what
// it computes:
//
//   * closest hit / any hit over a TLAS of instances and one BLAS per mesh;
//     a TLAS leaf transforms the ray by the instance's 3x4 world->object
//     matrix and the ray is restored when the BLAS is exhausted (stack
//     watermark `msbi`)
//   * slab test with a 1e-30 direction floor; a child is skipped when
//     tf < 0 | tn > tf | tn >= best
//   * the leaf arithmetic, det^2-scaled in both tests: numerators u*det,
//     v*det, t*det over det^2 >= EPS^2, 0 <= u_num <= det^2, v_num >= 0,
//     u_num + v_num <= det^2, t_num > EPS*det^2; the best hit compared by
//     cross-multiplication (strict: the first of two equal hits wins), the
//     denominator reset to 1 at every leaf and ONE divide when a leaf ends;
//     any hit compares t_num < maxt*det^2 and never divides
//   * inactive lanes return found = 0, t = 0
//
// Design: ONE THREAD PER RAY. Each thread owns a 64-entry stack in local
// memory, descends near-child-first by its own slab entry distances, and
// reads nodes, triangles, matrices and roots straight from global memory
// through the read-only path (__ldg): the flagship scene is well under
// 100 KB and stays resident in L1/L2. Rays arrive in 32x32-pixel blocked
// order, so the 32 rays of a warp are neighbours on screen and mostly take
// the same branches.
//
// What bounds it on this card: neither device-memory bytes (56 B per ray in
// and out) nor fp32 operations come near the card's rates; the time goes to
// dependent L1/L2 loads (node -> child boxes -> next node) and to warp
// divergence once bounce rays scatter. The design answers the first with
// cache-resident scene data and the second only with the blocked ray order;
// packet traversal, shared-memory staging and wide nodes are left out on
// purpose.
//
// Triangle tests: LEAF_DET2 and LEAF_HH of traverse_common.cuh, exactly as
// the plain PyTorch version ops/intersect.py::intersect_bvh writes them
// (leaf="det2" over tri_v0/e1/e2, leaf="hh" over the (T,12) rows of
// pack_tris_hh). Every sum is written in that version's association, and the
// file is compiled with -fmad=false so each multiply and add rounds on its
// own as it does there: kernel and plain version then take identical
// hit/miss decisions.
//
// The ray, the slab test, the instance transform, the triangle test and the
// launcher are shared with the package's other traversal kernels
// (traverse_common.cuh); this file holds the binary node layout of the
// uploaded scene (separate bvh_min / bvh_max / ldata / rdata arrays) and its
// traversal order.
//
// Plain C interface (no torch headers): the entry points take raw device
// pointers and a stream and return cudaGetLastError().

#include "traverse_common.cuh"

namespace {

using namespace polaris;

constexpr int STACK_SIZE = 64;

struct Scene {
    const float* __restrict__ bvh_min;   // (N,3)
    const float* __restrict__ bvh_max;   // (N,3)
    const int* __restrict__ ldata;       // (N,)
    const int* __restrict__ rdata;       // (N,)
    Tris tris;                           // tri_v0 / tri_e1 / tri_e2, each (T,3),
                                         // or the (T,12) Havel-Herout rows
    const float* __restrict__ w2o;       // (I,4,4) row-major
    const int* __restrict__ roots;       // (I,)
    int num_inst;
};

// entry distance of the ray into a node's box, FLT_MAX on a miss
__device__ __forceinline__ float node_slab(const Scene& s, int node,
                                           const Ray& r, float best) {
    const float* mn = s.bvh_min + 3 * (size_t)node;
    const float* mx = s.bvh_max + 3 * (size_t)node;
    return slab(r, __ldg(mn + 0), __ldg(mn + 1), __ldg(mn + 2), __ldg(mx + 0),
                __ldg(mx + 1), __ldg(mx + 2), best);
}

template <bool ANY_HIT, int LEAF>
__global__ void __launch_bounds__(THREADS) traverse(Scene s, Rays rays) {
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
            const int ld = __ldg(s.ldata + node);
            const int rd = __ldg(s.rdata + node);
            bool pop = false;
            if (ld <= 0) {
                if (rd == 0) {
                    // TLAS leaf: move the ray into the instance's space
                    int id = min(max(-ld, 0), s.num_inst - 1);
                    to_instance(r, s.w2o + 16 * (size_t)id);
                    msbi = sp;
                    inst = id;
                    node = __ldg(s.roots + id);
                    continue;
                }
                // BLAS leaf: rd triangles starting at -ld
                if (test_leaf<ANY_HIT, LEAF>(r, s.tris, -ld, rd, inst, best)) break;
                pop = true;
            } else {
                // inner node: both children, near first
                float l_dist = node_slab(s, ld, r, best.t);
                float r_dist = node_slab(s, rd, r, best.t);
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
    const float *bvh_min, const float *bvh_max, const int *ldata,              \
        const int *rdata, const float *tri_v0, const float *tri_e1,            \
        const float *tri_e2, const float *w2o, const int *roots, int num_tris, \
        int num_inst
#define SCENE                                                                  \
    Scene {                                                                    \
        bvh_min, bvh_max, ldata, rdata,                                        \
            polaris::Tris{tri_v0, tri_e1, tri_e2, 3, num_tris}, w2o, roots,    \
            num_inst                                                           \
    }

// the same scene with the triangles as (T,12) Havel-Herout rows
#define SCENE_HH_ARGS                                                          \
    const float *bvh_min, const float *bvh_max, const int *ldata,              \
        const int *rdata, const float *tri_rows, const float *w2o,             \
        const int *roots, int num_tris, int num_inst
#define SCENE_HH                                                               \
    Scene {                                                                    \
        bvh_min, bvh_max, ldata, rdata,                                        \
            polaris::Tris{tri_rows, tri_rows + 4, tri_rows + 8, 12, num_tris}, \
            w2o, roots, num_inst                                               \
    }

extern "C" int polaris_closest_hit(SCENE_ARGS, POLARIS_CLOSEST_ARGS) {
    return polaris::launch(traverse<false, LEAF_DET2>, SCENE,
                           POLARIS_CLOSEST_RAYS, stream);
}

extern "C" int polaris_any_hit(SCENE_ARGS, POLARIS_ANY_ARGS) {
    return polaris::launch(traverse<true, LEAF_DET2>, SCENE, POLARIS_ANY_RAYS,
                           stream);
}

extern "C" int polaris_closest_hit_hh(SCENE_HH_ARGS, POLARIS_CLOSEST_ARGS) {
    return polaris::launch(traverse<false, LEAF_HH>, SCENE_HH,
                           POLARIS_CLOSEST_RAYS, stream);
}

extern "C" int polaris_any_hit_hh(SCENE_HH_ARGS, POLARIS_ANY_ARGS) {
    return polaris::launch(traverse<true, LEAF_HH>, SCENE_HH, POLARIS_ANY_RAYS,
                           stream);
}
