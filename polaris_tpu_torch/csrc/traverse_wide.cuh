// The 8-wide two-level BVH traversal of intersect_wide8.cu (K4), one thread
// per ray (sm_90a). It is written over a Layout, which says how a wide node
// is laid out in memory and how a child entry is encoded:
//
//   uint32_t root()                       entry the traversal starts at
//   uint32_t inst_entry(int inst)         entry of an instance's subtree
//   uint32_t entry(int node, int slot)    child entry of a wide node
//   float slab(node, slot, ray, best)     entry distance into a child's box
//   static decode(e, typ, cnt, idx)       typ: 0 empty, 1 wide node,
//                                         2 triangle leaf, 3 instance
//   tris, w2o (I,12), num_inst
//
// K2 (intersect_wide8_nodes.cu) walks the same order over its own records
// on the persistent schedule of traverse_common.cuh instead: its reader,
// WideReader, is at the end of this file.
//
// Entries are self-describing work items: the stack holds entries, and a
// popped entry dispatches straight to its phase.
//
//   instance (3)  move the ray into instance idx's space, remember the stack
//                 height (watermark msbi), continue at inst_entry(idx), which
//                 is a wide node or, for a one-leaf mesh, a triangle leaf
//   leaf (2)      cnt triangles from idx through the kernel's leaf test
//                 (LEAF: the quotient form in intersect_wide8.cu, as its TPU
//                 kernel)
//   wide node (1) slab-test the 8 children; continue at the nearest hit
//                 child (the first of equal distances) and push the other
//                 hit children in slot order
//   pop           when a pop finds the stack at the watermark the instance's
//                 subtree is exhausted and the world-space ray is restored
//
// The TPU kernels order the children by the least distance over a 1024-ray
// tile and leave an any-hit query when the whole tile is occluded; here each
// ray orders by its own distances and leaves at its own first hit. Up to 7
// entries are pushed per visit; the host packers work out the deepest the
// stack can get for the packed tree and refuse a tree that needs more than
// WIDE_STACK entries, so the clamp below never bites.

#pragma once

#include "traverse_common.cuh"

namespace polaris {

constexpr int WIDE_STACK = 96;
constexpr int WIDTH = 8;
constexpr int T_EMPTY = 0, T_WIDE = 1, T_BOT = 2, T_TOP = 3;

template <bool ANY_HIT, int LEAF, typename Layout>
__device__ __forceinline__ void traverse_wide(const Layout& s, const Rays& rays,
                                              int i) {
    Best best{0.0f, 0.0f, 0.0f, 0, 0, false};

    if (rays.active[i]) {
        const Ray world = load_ray(rays, i);
        Ray r = world;
        best.t = rays.maxt[i];

        uint32_t stack[WIDE_STACK];
        int sp = 0, msbi = -1, inst = 0;
        uint32_t entry = s.root();

        while (true) {
            int typ, cnt, idx;
            Layout::decode(entry, typ, cnt, idx);
            bool pop = false;
            if (typ == T_TOP) {
                int id = min(idx, s.num_inst - 1);
                to_instance(r, s.w2o + 12 * (size_t)id);
                msbi = sp;
                inst = id;
                entry = s.inst_entry(id);
                continue;
            } else if (typ == T_BOT) {
                if (test_leaf<ANY_HIT, LEAF>(r, s.tris, idx, cnt, inst, best)) break;
                pop = true;
            } else if (typ == T_WIDE) {
                uint32_t ent[WIDTH];
                float dist[WIDTH];
                float near_d = FLT_MAX_F;
                int near_s = -1;
#pragma unroll
                for (int c = 0; c < WIDTH; ++c) {
                    ent[c] = s.entry(idx, c);
                    int ctyp, ccnt, cidx;
                    Layout::decode(ent[c], ctyp, ccnt, cidx);
                    dist[c] = ctyp != T_EMPTY ? s.slab(idx, c, r, best.t)
                                              : FLT_MAX_F;
                    if (dist[c] < near_d) {
                        near_d = dist[c];
                        near_s = c;
                    }
                }
                if (near_s < 0) {
                    pop = true;
                } else {
#pragma unroll
                    for (int c = 0; c < WIDTH; ++c) {
                        if (c != near_s && dist[c] < FLT_MAX_F) {
                            stack[min(sp, WIDE_STACK - 1)] = ent[c];
                            ++sp;
                        }
                    }
#pragma unroll
                    for (int c = 0; c < WIDTH; ++c)
                        if (c == near_s) entry = ent[c];
                }
            } else {
                pop = true;  // an empty entry holds no work
            }
            if (pop) {
                if (sp == msbi) {
                    // the instance's subtree is exhausted: world-space ray
                    r = world;
                    msbi = -1;
                }
                --sp;
                if (sp < 0) break;
                entry = stack[min(sp, WIDE_STACK - 1)];
            }
        }
    }
    store_hit<ANY_HIT>(rays, i, best);
}

// ---------------------------------------------------------------------------
// K2's reader on the persistent schedule (walk_rays in traverse_common.cuh),
// over K2's own buffer of 16-byte words (ops/intersect_wide8_nodes.py::
// pack_scene_k2): a record of WIDE_REC_WORDS words per wide node, twelve of
// boxes (children 2p and 2p+1 in words 3p .. 3p+2, min xyz then max xyz
// each) and two of entries typ<<30 | count<<24 | index; then 48-byte
// triangle rows from tri_at and 64-byte instance rows [3x4 world->object
// matrix, the instance's entry] from inst_at. A step is one entry of the
// body above: an instance entry or a wide-node visit, in the same order;
// a triangle-leaf entry ends the lane's inner steps.

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
