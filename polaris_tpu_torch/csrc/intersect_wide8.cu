// 8-wide two-level BVH traversal, boxes and entries in separate arrays, for
// NVIDIA Hopper (sm_90a): closest hit and any hit.
//
// Replaces the TPU kernel polaris_tpu/ops/intersect_pallas8.py::_kernel. What
// is kept is its node layout, entry encoding, child order and leaf test:
//
//   * the binary BVH collapsed host-side into nodes of up to 8 children,
//     child c's box (min xyz, max xyz) and entry in slot c
//   * entry = type<<28 | count<<22 | index (type 0 empty, 1 wide node,
//     2 triangle leaf, 3 instance), so index and node count stay below 2^22
//   * one visit slab-tests all 8 children, continues at the nearest (the
//     first of equal distances) and pushes the other hit children in slot
//     order; an instance entry moves the ray into the instance's space and
//     the stack's watermark restores it
//   * quotient-form Moller-Trumbore over the leaf's count triangles
//     (leaf_rows_quot of traverse_common.cuh): this TPU kernel, alone among
//     the five, divides per triangle
//
// What is not carried over: the (8,128) ray tiles, the per-child tile-min
// reductions (dmin_ref) that ordered a tile's shared stack, the SMEM copies
// of every array.
//
// What bounds it on this card: dependent loads and divergence, as in the
// other BVH kernels. On cornell's frames (4 wide nodes, 18 instances of two
// triangles) a launch is a few microseconds of work, so what a launch costs
// before it traces anything counts as much as the traversal.
//
// Design, on the block-local schedule of traverse_block.cuh (a static grid
// with no counter, live rays compacted per window):
//   * K4's own buffer (ops/intersect_wide8.py::pack_scene_k4) of 16-byte
//     words: a 224-byte record per wide node, 12 words of boxes (children 2p
//     and 2p+1 in words 3p .. 3p+2) and 2 words of entries in K4's own
//     28/22-bit encoding, so a visit is 14 vector loads and no clamp per
//     child; 64-byte instance rows [3x4 world->object matrix, the
//     instance's entry]; 48-byte triangle rows [v0, e1, e2]. The whole
//     buffer sits in shared memory when it is small (cornell, instanced: the
//     byte count picks), else it is read through L1 and L2.
//   * the stack in shared memory, [depth][thread] so the 32 lanes of a warp
//     fall on 32 banks, sized by the tree's own depth (stack_need)
//   * while-while, as walk_rays does it: the lanes of a warp take inner
//     steps (wide nodes, instance entries) until every live lane holds a
//     triangle leaf or is done, then test their leaves together
//
// Every sum is written in the plain version's association, and the file is
// compiled with -fmad=false: kernel and plain version
// (ops/intersect_wide8.py::wide8_plain) agree bit for bit.

#include "traverse_block.cuh"
#include "traverse_wide.cuh"

namespace {

using namespace polaris;

// K4's own buffer (see the head of this file)
struct Wide8Scene {
    const float4* __restrict__ words;
    int num_words, num_wide, num_inst, num_tris;
    int inst_at, tri_at;  // the first instance row's and triangle row's word
    int root;             // the entry the walk starts at
    int stack_cap;        // stack entries per thread
};

__device__ __forceinline__ void decode(uint32_t e, int& typ, int& cnt, int& idx) {
    typ = (int)((e >> 28) & 0x7u);
    cnt = (int)((e >> 22) & 0x3Fu);
    idx = (int)(e & 0x3FFFFFu);
}

// One inner step from entry `cur`, as one trip of the plain version:
// STEP_WALK (cur, the ray and the stack moved on), STEP_LEAF (cur is a leaf
// of `count` triangles from `first`) or STEP_POP.
template <bool STAGED>
__device__ __forceinline__ int step(const Wide8Scene& sc, const Words<STAGED>& w,
                                    uint32_t& cur, Ray& r, int& sp, int& msbi,
                                    int& inst, float best_t, int* stack,
                                    int& first, int& count) {
    int typ, cnt, idx;
    decode(cur, typ, cnt, idx);
    if (typ == T_BOT) {
        first = idx;
        count = cnt;
        return STEP_LEAF;
    }
    if (typ == T_TOP) {
        // instance entry: move the ray into the instance's space
        const int id = min(idx, sc.num_inst - 1);
        const int at = sc.inst_at + 4 * id;
        to_instance_rows(r, w[at], w[at + 1], w[at + 2]);
        msbi = sp;
        inst = id;
        cur = (uint32_t)__float_as_int(w[at + 3].x);
        return STEP_WALK;
    }
    if (typ != T_WIDE) return STEP_POP;  // an empty entry holds no work

    // wide node: slab-test the 8 children; continue at the nearest hit
    // child, push the other hit children in slot order
    const int at = WIDE_REC_WORDS * min(idx, sc.num_wide - 1);
    const float4 e0 = w[at + 12], e1 = w[at + 13];
    const uint32_t ent[WIDTH] = {
        (uint32_t)__float_as_int(e0.x), (uint32_t)__float_as_int(e0.y),
        (uint32_t)__float_as_int(e0.z), (uint32_t)__float_as_int(e0.w),
        (uint32_t)__float_as_int(e1.x), (uint32_t)__float_as_int(e1.y),
        (uint32_t)__float_as_int(e1.z), (uint32_t)__float_as_int(e1.w)};
    float dist[WIDTH];
#pragma unroll
    for (int p = 0; p < WIDTH / 2; ++p) {
        // children 2p and 2p+1 fill three words: min and max xyz each
        const float4 a = w[at + 3 * p];
        const float4 b = w[at + 3 * p + 1];
        const float4 c = w[at + 3 * p + 2];
        dist[2 * p] = slab(r, a.x, a.y, a.z, a.w, b.x, b.y, best_t);
        dist[2 * p + 1] = slab(r, b.z, b.w, c.x, c.y, c.z, c.w, best_t);
    }
    float near_d = FLT_MAX_F;
    int near_s = -1;
#pragma unroll
    for (int c = 0; c < WIDTH; ++c) {
        if (((ent[c] >> 28) & 0x7u) == T_EMPTY) dist[c] = FLT_MAX_F;
        if (dist[c] < near_d) {
            near_d = dist[c];
            near_s = c;
        }
    }
    if (near_s < 0) return STEP_POP;
    const int top = sc.stack_cap - 1;
#pragma unroll
    for (int c = 0; c < WIDTH; ++c) {
        if (c != near_s && dist[c] < FLT_MAX_F) {
            stack[min(sp, top) * BLOCK_RAYS] = (int)ent[c];
            ++sp;
        }
    }
#pragma unroll
    for (int c = 0; c < WIDTH; ++c)
        if (c == near_s) cur = ent[c];
    return STEP_WALK;
}

// the next entry from this thread's stack, restoring the world-space ray
// when the pop leaves an instance's tree; true when the stack is empty
__device__ __forceinline__ bool pop(const Wide8Scene& sc, int& sp, int& msbi,
                                    uint32_t& cur, Ray& r, const Ray& world,
                                    const int* stack) {
    if (sp == msbi) {
        r = world;
        msbi = -1;
    }
    --sp;
    if (sp < 0) return true;
    cur = (uint32_t)stack[min(sp, sc.stack_cap - 1) * BLOCK_RAYS];
    return false;
}

template <bool ANY_HIT, bool STAGED>
__global__ void __launch_bounds__(BLOCK_RAYS) traverse(Wide8Scene sc, Rays rays) {
    extern __shared__ __align__(16) float4 smem[];
    const float4* base = sc.words;
    if constexpr (STAGED) {
        stage_words_block(smem, sc.words, sc.num_words);
        base = smem;
    }
    const Words<STAGED> w{base};
    int* stack = reinterpret_cast<int*>(smem + (STAGED ? sc.num_words : 0)) + threadIdx.x;
    const auto rows = [&](int tri, float4& a, float4& b, float4& c) {
        const int at = sc.tri_at + 3 * tri;
        a = w[at];
        b = w[at + 1];
        c = w[at + 2];
    };
    live_windows<ANY_HIT>(rays, [&](int ray) {
        Ray world, r;
        Best best{0.0f, 0.0f, 0.0f, 0, 0, false};
        int sp = 0, msbi = -1, inst = 0;
        uint32_t cur = (uint32_t)sc.root;
        bool done = ray < 0;
        if (!done) {
            world = load_ray(rays, ray);
            r = world;
            best.t = rays.maxt[ray];
        }
        while (__any_sync(FULL, !done)) {
            // while-while: inner steps until every live lane of the warp
            // holds a triangle leaf or is done; then the leaves together
            bool at_leaf = false;
            int first = 0, count = 0;
            while (__any_sync(FULL, !done && !at_leaf)) {
                if (done || at_leaf) continue;
                const int k = step(sc, w, cur, r, sp, msbi, inst, best.t, stack, first, count);
                if (k == STEP_LEAF)
                    at_leaf = true;
                else if (k == STEP_POP)
                    done = pop(sc, sp, msbi, cur, r, world, stack);
            }
            if (at_leaf) {
                if (leaf_rows_quot<ANY_HIT>(r, rows, first, count, sc.num_tris - 1, inst, best))
                    done = true;  // an any-hit query is settled
                else
                    done = pop(sc, sp, msbi, cur, r, world, stack);
            }
        }
        if (ray >= 0) store_hit<ANY_HIT>(rays, ray, best);
    });
}

template <bool ANY_HIT>
int run(const void* words, int num_words, int num_wide, int num_inst, int num_tris,
        int root, int stack_cap, int staged, const Rays& rays, void* stream) {
    const int inst_at = WIDE_REC_WORDS * num_wide;
    const Wide8Scene sc{static_cast<const float4*>(words), num_words, num_wide,
                        num_inst, num_tris, inst_at, inst_at + 4 * num_inst,
                        root, stack_cap};
    const size_t stacks = sizeof(int) * (size_t)stack_cap * BLOCK_RAYS;
    if (staged)
        return launch_block<ANY_HIT, true>(traverse<ANY_HIT, true>, sc, 16 * (size_t)num_words + stacks,
                            rays, stream);
    return launch_block<ANY_HIT, false>(traverse<ANY_HIT, false>, sc, stacks, rays, stream);
}

}  // namespace

// K4's buffer (ops/intersect_wide8.py::pack_scene_k4), its counts, the root
// entry, the stack entries per thread and whether the buffer is staged in
// shared memory
#define K4_ARGS                                                                \
    const void *words, int num_words, int num_wide, int num_inst,              \
        int num_tris, int root, int stack_cap, int staged
#define K4_SCENE                                                               \
    words, num_words, num_wide, num_inst, num_tris, root, stack_cap, staged

extern "C" int polaris_wide8_closest_hit(K4_ARGS, POLARIS_CLOSEST_ARGS) {
    return run<false>(K4_SCENE, POLARIS_CLOSEST_RAYS, stream);
}

extern "C" int polaris_wide8_any_hit(K4_ARGS, POLARIS_ANY_ARGS) {
    return run<true>(K4_SCENE, POLARIS_ANY_RAYS, stream);
}
