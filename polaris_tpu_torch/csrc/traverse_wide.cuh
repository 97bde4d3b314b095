// The 8-wide two-level BVH traversal shared by intersect_wide8.cu and
// intersect_wide8_nodes.cu (sm_90a). The two kernels differ only in how a
// wide node is laid out in memory and how a child entry is encoded; each
// supplies a Layout with
//
//   uint32_t root()                       entry the traversal starts at
//   uint32_t inst_entry(int inst)         entry of an instance's subtree
//   uint32_t entry(int node, int slot)    child entry of a wide node
//   float slab(node, slot, ray, best)     entry distance into a child's box
//   static decode(e, typ, cnt, idx)       typ: 0 empty, 1 wide node,
//                                         2 triangle leaf, 3 instance
//   tris, w2o (I,12), num_inst
//
// Entries are self-describing work items: the stack holds entries, and a
// popped entry dispatches straight to its phase.
//
//   instance (3)  move the ray into instance idx's space, remember the stack
//                 height (watermark msbi), continue at inst_entry(idx), which
//                 is a wide node or, for a one-leaf mesh, a triangle leaf
//   leaf (2)      cnt triangles from idx through the kernel's leaf test
//                 (LEAF: quotient form in intersect_wide8.cu, det^2-scaled
//                 in intersect_wide8_nodes.cu, as their TPU kernels)
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

}  // namespace polaris
