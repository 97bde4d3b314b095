// What the two 8-wide kernels share (sm_90a): K2 (intersect_wide8_nodes.cu)
// on the persistent schedule of traverse_common.cuh, through WideReader
// below, and K4 (intersect_wide8.cu) on the block-local schedule of
// traverse_block.cuh, through a reader of its own (K4's entries are
// type<<28 | count<<22 | index, K2's type<<30 | count<<24 | index). Both
// walk the same order:
//
//   instance (3)  move the ray into instance idx's space, remember the stack
//                 height (watermark msbi), continue at the instance's entry,
//                 which is a wide node or, for a one-leaf mesh, a triangle
//                 leaf
//   leaf (2)      cnt triangles from idx through the kernel's leaf test
//                 (K2 det^2-scaled, K4 the quotient form, as their TPU
//                 kernels)
//   wide node (1) slab-test the 8 children; continue at the nearest hit
//                 child (the first of equal distances) and push the other
//                 hit children in slot order
//   pop           when a pop finds the stack at the watermark the instance's
//                 subtree is exhausted and the world-space ray is restored
//
// Entries are self-describing work items: the stack holds entries, and a
// popped entry dispatches straight to its phase. The TPU kernels order the
// children by the least distance over a 1024-ray tile and leave an any-hit
// query when the whole tile is occluded; here each ray orders by its own
// distances and leaves at its own first hit. Up to 7 entries are pushed per
// visit; the host packers work out the deepest the stack can get for the
// packed tree (stack_need) and refuse a tree that needs more than 96.

#pragma once

#include "traverse_common.cuh"

namespace polaris {

constexpr int WIDTH = 8;
constexpr int T_EMPTY = 0, T_WIDE = 1, T_BOT = 2, T_TOP = 3;

// ---------------------------------------------------------------------------
// K2's reader on the persistent schedule (walk_rays in traverse_common.cuh),
// over K2's own buffer of 16-byte words (ops/intersect_wide8_nodes.py::
// pack_scene_k2): a record of WIDE_REC_WORDS words per wide node, twelve of
// boxes (children 2p and 2p+1 in words 3p .. 3p+2, min xyz then max xyz
// each) and two of entries typ<<30 | count<<24 | index; then 48-byte
// triangle rows from tri_at and 64-byte instance rows [3x4 world->object
// matrix, the instance's entry] from inst_at. A step is one entry of the
// order above: an instance entry or a wide-node visit; a triangle-leaf
// entry ends the lane's inner steps. K4's records have the same 14 words.

constexpr int WIDE_REC_WORDS = 14;

template <bool STAGED>
struct WideReader {
    Words<STAGED> w;
    int num_tris, num_inst, tri_at, inst_at;
    int root, num_wide;

    __device__ __forceinline__ int start() const { return root; }

    __device__ __forceinline__ void rows(int tri, float4& a, float4& b,
                                         float4& c) const {
        const int at = tri_at + 3 * tri;
        a = w[at];
        b = w[at + 1];
        c = w[at + 2];
    }

    __device__ __forceinline__ int step(int& cur, Ray& r, int& sp, int& msbi,
                                        int& inst, float best_t, int* stack,
                                        int top, int& first,
                                        int& count) const {
        const uint32_t e = (uint32_t)cur;
        const int typ = (int)(e >> 30);
        const int idx = (int)(e & 0xFFFFFFu);
        if (typ == T_BOT) {
            first = idx;
            count = (int)((e >> 24) & 0x3Fu);
            return STEP_LEAF;
        }
        if (typ == T_TOP) {
            // instance entry: move the ray into the instance's space
            const int id = min(idx, num_inst - 1);
            const int at = inst_at + 4 * id;
            to_instance_rows(r, w[at], w[at + 1], w[at + 2]);
            msbi = sp;
            inst = id;
            cur = __float_as_int(w[at + 3].x);
            return STEP_WALK;
        }
        if (typ != T_WIDE) return STEP_POP;  // an empty entry holds no work

        // wide node: slab-test the 8 children; continue at the nearest hit
        // child, push the other hit children in slot order
        const int at = WIDE_REC_WORDS * min(idx, num_wide - 1);
        const float4 e0 = w[at + 12], e1 = w[at + 13];
        const int ent[WIDTH] = {
            __float_as_int(e0.x), __float_as_int(e0.y), __float_as_int(e0.z),
            __float_as_int(e0.w), __float_as_int(e1.x), __float_as_int(e1.y),
            __float_as_int(e1.z), __float_as_int(e1.w)};
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
            if (((uint32_t)ent[c] >> 30) == T_EMPTY) dist[c] = FLT_MAX_F;
            if (dist[c] < near_d) {
                near_d = dist[c];
                near_s = c;
            }
        }
        if (near_s < 0) return STEP_POP;
#pragma unroll
        for (int c = 0; c < WIDTH; ++c) {
            if (c != near_s && dist[c] < FLT_MAX_F) {
                stack[min(sp, top) * BLOCK] = ent[c];
                ++sp;
            }
        }
#pragma unroll
        for (int c = 0; c < WIDTH; ++c)
            if (c == near_s) cur = ent[c];
        return STEP_WALK;
    }
};

// K2's own buffer (ops/intersect_wide8_nodes.py::pack_scene_k2)
struct WideScene {
    const float4* __restrict__ words;
    int num_words, num_tris, num_inst;
    int tri_at, inst_at;
    int stack_cap;  // stack entries per thread
    int root, num_wide;

    template <bool STAGED>
    __device__ __forceinline__ WideReader<STAGED> reader(const Words<STAGED>& w) const {
        return WideReader<STAGED>{w, num_tris, num_inst, tri_at, inst_at, root, num_wide};
    }
};

}  // namespace polaris
