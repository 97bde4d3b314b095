// Device code shared by every traversal kernel of the package (sm_90a).
//
// Two schedules use it. K1, K2 and K3 (intersect.cu, intersect_wide8_nodes.cu,
// intersect_nodes.cu) run persistent warps that fetch only the live rays from
// a counter, with their packed buffer staged in shared memory where it fits
// and the stack in shared memory: the persistent schedule at the end of this
// file, with its own launcher. K4 and K5 (intersect_wide8.cu,
// intersect_dense.cu) run the block-local schedule of traverse_block.cuh: a
// static grid, each block's windows of rays compacted to their live rays,
// no counter. What differs between the kernels is the node layout, the
// entry encoding and the child order; what they share lives here:
//
//   * the ray (origin, direction, reciprocal direction with a 1e-30 floor)
//   * the slab test: a box is skipped when tf < 0 | tn > tf | tn >= best
//   * the move into an instance's space by a row-major 3x4 world->object
//     matrix (to_instance_rows on three rows wherever they were loaded from)
//   * the three leaf tests, chosen at compile time by a kernel's LEAF
//     parameter, each the form its TPU kernel has:
//       LEAF_QUOT  quotient-form Moller-Trumbore, one divide per triangle:
//                  |det| >= EPS, 0 <= u <= 1, v >= 0, u + v <= 1,
//                  EPS < t < best (plain version: ops/intersect.py::mt_block)
//       LEAF_DET2  det^2-scaled Moller-Trumbore: numerators u*det, v*det,
//                  t*det over the positive denominator det^2, the best hit
//                  compared by cross-multiplication, ONE divide per leaf
//                  (mt_block_det2)
//       LEAF_HH    Havel-Herout precomputed planes on 12-float rows
//                  [N, d0, N1, d1, N2, d2], det^2-scaled like LEAF_DET2
//                  (hh_block)
//     all with strict updates: the first of two equal hits wins. Each takes
//     a triangle as three 16-byte rows from a row loader, so a kernel may
//     load them from its own layout and memory (leaf_rows_quot for the
//     quotient form; scaled_math, scan_rows and leaf_rows for the others)
//   * loading a ray and storing a hit (inactive lanes: found = 0, t = 0)
//
// Every sum is written in the association of the plain PyTorch versions
// (ops/intersect.py), and every file that includes this header is compiled
// with -fmad=false, so that each multiply and add rounds on its own as it
// does there: one contracted multiply-add in a numerator that feeds a compare
// would flip a lane. Kernels that share a leaf form take identical hit/miss
// decisions on the same triangle; across forms t, u, v differ by an ulp or
// so and a near-tie may keep another triangle.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace polaris {

constexpr float EPS = 1e-5f;
// EPS * EPS as the TPU kernels spell it: the product in double, then rounded
constexpr float EPS2 = (float)(1e-5 * 1e-5);

// the leaf forms (see the head of this file)
constexpr int LEAF_QUOT = 0, LEAF_DET2 = 1, LEAF_HH = 2;
constexpr float FLT_MAX_F = 3.4028235e38f;

struct Ray {
    float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// the rays of one launch and where their results go
struct Rays {
    int n;
    const float* __restrict__ o;        // (n,3)
    const float* __restrict__ d;        // (n,3)
    const float* __restrict__ maxt;     // (n,)
    const uint8_t* __restrict__ active; // (n,)
    float* __restrict__ out_t;          // closest hit only, as u, v, tri, inst
    float* __restrict__ out_u;
    float* __restrict__ out_v;
    int* __restrict__ out_tri;
    int* __restrict__ out_inst;
    uint8_t* __restrict__ out_found;
};

struct Best {
    float t, u, v;
    int tri, inst;
    bool found;
};

__device__ __forceinline__ float inv_dir(float d) {
    float f = d < 0.0f ? -1e-30f : 1e-30f;
    return 1.0f / (fabsf(d) < 1e-30f ? f : d);
}

__device__ __forceinline__ void set_ray(Ray& r, float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
    r.ox = ox; r.oy = oy; r.oz = oz;
    r.dx = dx; r.dy = dy; r.dz = dz;
    r.ix = inv_dir(dx); r.iy = inv_dir(dy); r.iz = inv_dir(dz);
}

__device__ __forceinline__ Ray load_ray(const Rays& rays, int i) {
    Ray r;
    const float* o = rays.o + 3 * (size_t)i;
    const float* d = rays.d + 3 * (size_t)i;
    set_ray(r, o[0], o[1], o[2], d[0], d[1], d[2]);
    return r;
}

// entry distance of the ray into the box (mn, mx), FLT_MAX on a miss
__device__ __forceinline__ float slab(const Ray& r, float mnx, float mny,
                                      float mnz, float mxx, float mxy,
                                      float mxz, float best) {
    float tx0 = (mnx - r.ox) * r.ix, tx1 = (mxx - r.ox) * r.ix;
    float ty0 = (mny - r.oy) * r.iy, ty1 = (mxy - r.oy) * r.iy;
    float tz0 = (mnz - r.oz) * r.iz, tz1 = (mxz - r.oz) * r.iz;
    float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
    float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
    bool miss = (tf < 0.0f) | (tn > tf) | (tn >= best);
    return miss ? FLT_MAX_F : tn;
}

// move the ray into an instance's space by the rows a, b, c of a 3x4
// world->object matrix
__device__ __forceinline__ void to_instance_rows(Ray& r, float4 a, float4 b,
                                                 float4 c) {
    float px = r.ox, py = r.oy, pz = r.oz, qx = r.dx, qy = r.dy, qz = r.dz;
    set_ray(r,
            ((a.x * px + a.y * py) + a.z * pz) + a.w,
            ((b.x * px + b.y * py) + b.z * pz) + b.w,
            ((c.x * px + c.y * py) + c.z * pz) + c.w,
            (a.x * qx + a.y * qy) + a.z * qz,
            (b.x * qx + b.y * qy) + b.z * qz,
            (c.x * qx + c.y * qy) + c.z * qz);
}

// `count` triangles from `first` (indices clamped to `last`) against the
// ray, quotient form; `rows(tri, a, b, c)` loads a triangle's rows v0, e1,
// e2 (.w unused). Closest hit keeps the nearest in `best`; any hit returns
// at the first one. Returns true when an any-hit query is settled.
template <bool ANY_HIT, class Rows>
__device__ __forceinline__ bool leaf_rows_quot(const Ray& r, const Rows& rows,
                                               int first, int count, int last,
                                               int inst, Best& best) {
    for (int j = 0; j < count; ++j) {
        const int tri = min(first + j, last);
        float4 p0, p1, p2;
        rows(tri, p0, p1, p2);
        const float e1x = p1.x, e1y = p1.y, e1z = p1.z;
        const float e2x = p2.x, e2y = p2.y, e2z = p2.z;
        // pvec = d x e2
        float pvx = r.dy * e2z - r.dz * e2y;
        float pvy = r.dz * e2x - r.dx * e2z;
        float pvz = r.dx * e2y - r.dy * e2x;
        float det = (e1x * pvx + e1y * pvy) + e1z * pvz;
        bool ok = fabsf(det) >= EPS;
        float inv_det = 1.0f / (ok ? det : 1.0f);
        float tvx = r.ox - p0.x, tvy = r.oy - p0.y, tvz = r.oz - p0.z;
        float uu = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv_det;
        ok &= (uu >= 0.0f) & (uu <= 1.0f);
        // qvec = tvec x e1
        float qvx = tvy * e1z - tvz * e1y;
        float qvy = tvz * e1x - tvx * e1z;
        float qvz = tvx * e1y - tvy * e1x;
        float vv = ((r.dx * qvx + r.dy * qvy) + r.dz * qvz) * inv_det;
        ok &= (vv >= 0.0f) & (uu + vv <= 1.0f);
        float tt = ((e2x * qvx + e2y * qvy) + e2z * qvz) * inv_det;
        ok &= (tt > EPS) & (tt < best.t);
        if (ok) {
            best.found = true;
            if (ANY_HIT) return true;
            best.t = tt;
            best.u = uu;
            best.v = vv;
            best.tri = tri;
            best.inst = inst;
        }
    }
    return false;
}

// The geometry half of a det^2-scaled test of one triangle, given as three
// rows: numerators u*det, v*det, t*det and the denominator det^2; true when
// the ray meets the triangle's plane inside it and in front of the origin.
// LEAF_DET2 is Moller-Trumbore on the rows v0, e1, e2 (.w unused); LEAF_HH
// the plane equations of a 12-float row [N d0], [N1 d1], [N2 d2], with the
// hit point scaled by det: P' = det*o + t_raw*d.
template <int LEAF>
__device__ __forceinline__ bool scaled_math(const Ray& r, float4 a, float4 b,
                                            float4 c, float& u_num,
                                            float& v_num, float& t_num,
                                            float& det_a) {
    if constexpr (LEAF == LEAF_HH) {
        const float4 n = a, n1 = b, n2 = c;
        float det = (r.dx * n.x + r.dy * n.y) + r.dz * n.z;
        float t_raw = n.w - ((r.ox * n.x + r.oy * n.y) + r.oz * n.z);
        det_a = det * det;
        bool ok = det_a >= EPS2;
        float hx = det * r.ox + t_raw * r.dx;
        float hy = det * r.oy + t_raw * r.dy;
        float hz = det * r.oz + t_raw * r.dz;
        u_num = (((n1.x * hx + n1.y * hy) + n1.z * hz) + det * n1.w) * det;
        v_num = (((n2.x * hx + n2.y * hy) + n2.z * hz) + det * n2.w) * det;
        ok &= (u_num >= 0.0f) & (v_num >= 0.0f) & (u_num + v_num <= det_a);
        t_num = t_raw * det;
        ok &= t_num > EPS * det_a;
        return ok;
    } else {
        const float e1x = b.x, e1y = b.y, e1z = b.z;
        const float e2x = c.x, e2y = c.y, e2z = c.z;
        // pvec = d x e2
        float pvx = r.dy * e2z - r.dz * e2y;
        float pvy = r.dz * e2x - r.dx * e2z;
        float pvz = r.dx * e2y - r.dy * e2x;
        float det = (e1x * pvx + e1y * pvy) + e1z * pvz;
        det_a = det * det;
        bool ok = det_a >= EPS2;
        float tvx = r.ox - a.x, tvy = r.oy - a.y, tvz = r.oz - a.z;
        u_num = ((tvx * pvx + tvy * pvy) + tvz * pvz) * det;
        ok &= (u_num >= 0.0f) & (u_num <= det_a);
        // qvec = tvec x e1
        float qvx = tvy * e1z - tvz * e1y;
        float qvy = tvz * e1x - tvx * e1z;
        float qvz = tvx * e1y - tvy * e1x;
        v_num = ((r.dx * qvx + r.dy * qvy) + r.dz * qvz) * det;
        ok &= (v_num >= 0.0f) & (u_num + v_num <= det_a);
        t_num = ((e2x * qvx + e2y * qvy) + e2z * qvz) * det;
        ok &= t_num > EPS * det_a;
        return ok;
    }
}

// `count` triangles from `first` (indices clamped to `last`) through a
// det^2-scaled test, WITHOUT the closing divide; `rows(tri, a, b, c)` loads
// a triangle's three rows. While it runs, best.t / best.u / best.v hold
// numerators over `den` (a quotient over den = 1 on entry). Closest hit
// accepts a triangle when t_num * den < best.t * det_a; with best.t =
// FLT_MAX the right side overflows to +inf and the compare still holds, as
// IEEE arithmetic has it. Any hit compares t_num < maxt * det_a and returns
// at the first one. `accepted` is set when the best hit changed.
template <bool ANY_HIT, int LEAF, class Rows>
__device__ __forceinline__ bool scan_rows(const Ray& r, const Rows& rows,
                                          int first, int count, int last,
                                          int inst, Best& best, float& den,
                                          bool& accepted) {
    for (int j = 0; j < count; ++j) {
        const int tri = min(first + j, last);
        float4 a, b, c;
        rows(tri, a, b, c);
        float u_num, v_num, t_num, det_a;
        bool ok = scaled_math<LEAF>(r, a, b, c, u_num, v_num, t_num, det_a);
        if (ANY_HIT) {
            ok &= t_num < best.t * det_a;
            if (ok) {
                best.found = true;
                return true;
            }
        } else {
            ok &= t_num * den < best.t * det_a;
            if (ok) {
                best.found = true;
                accepted = true;
                best.t = t_num;
                den = det_a;
                best.u = u_num;
                best.v = v_num;
                best.tri = tri;
                best.inst = inst;
            }
        }
    }
    return false;
}

// numerators over `den` back to quotients: one divide
__device__ __forceinline__ void to_quotients(Best& best, float den) {
    const float inv = 1.0f / den;
    best.t = best.t * inv;
    best.u = best.u * inv;
    best.v = best.v * inv;
}

// One leaf visit of a det^2-scaled form over `rows` (see scan_rows): every
// leaf starts at den = 1 and divides at its end, so between leaves best.t is
// a quotient; the divide is skipped when no triangle of the leaf was
// accepted (x * (1 / 1) is x exactly).
template <bool ANY_HIT, int LEAF, class Rows>
__device__ __forceinline__ bool leaf_rows(const Ray& r, const Rows& rows,
                                          int first, int count, int last,
                                          int inst, Best& best) {
    float den = 1.0f;
    bool accepted = false;
    if (scan_rows<ANY_HIT, LEAF>(r, rows, first, count, last, inst, best, den,
                                 accepted))
        return true;
    if (accepted) to_quotients(best, den);
    return false;
}

template <bool ANY_HIT>
__device__ __forceinline__ void store_hit(const Rays& rays, int i,
                                          const Best& best) {
    rays.out_found[i] = best.found ? 1 : 0;
    if (!ANY_HIT) {
        rays.out_t[i] = best.found ? best.t : 0.0f;
        rays.out_u[i] = best.u;
        rays.out_v[i] = best.v;
        rays.out_tri[i] = best.tri;
        rays.out_inst[i] = best.inst;
    }
}

// ===========================================================================
// The persistent live-ray schedule shared by the three BVH kernels that walk
// a packed buffer of 16-byte words: K1 (intersect.cu), K3
// (intersect_nodes.cu) and K2 (intersect_wide8_nodes.cu). The kernels differ
// only in their READER, the struct that knows their node layout; everything
// else is here:
//
//   * PERSISTENT WARPS THAT FETCH ONLY LIVE RAYS. The grid fills the card
//     once (blocks per SM from the occupancy the runtime reports, asked once
//     per device and shared-memory size). Each warp takes windows of 32 ray
//     indices from a counter in global memory (one atomicAdd each), writes
//     the results of a window's inactive rays at once and hands only the
//     active ones to its lanes (__ballot_sync, __fns); a lane whose ray is
//     done takes a new one as soon as REFILL lanes of its warp are free
//     (dynamic fetch, Aila and Laine 2009). The last block to finish resets
//     the counters, so a launch needs no memset and replays from a CUDA
//     graph.
//   * WHILE-WHILE. The lanes of a warp take inner steps (inner nodes and
//     instance entries, whatever the reader calls a step) until every live
//     lane holds a triangle leaf or is done (__any_sync), and only then test
//     leaves, together. Each ray's visits keep their order; only their
//     timing moves.
//   * THE BUFFER IN SHARED MEMORY when it fits beside the stacks: each block
//     copies it there by one bulk copy (cp.async.bulk, completion on an
//     mbarrier) and every read is a shared load (STAGED); else every read
//     goes through the read-only path, L1 and L2. The host picks by byte
//     count. A middle branch, the first node records of a depth-ordered
//     buffer in shared memory and the rest through L1 (the TPU kernels'
//     resident prefix), was timed on the H100 and lost to L1 at every size
//     of prefix: shared memory is carved out of the same SRAM as L1, which
//     keeps the top of the tree anyway (PERF.md).
//   * THE STACK IN SHARED MEMORY, laid out [depth][thread] so the 32 lanes
//     of a warp always fall on 32 banks, sized by the tree's own depth (the
//     packers' stack_need, clamped as the plain versions clamp).
//
// A reader provides
//
//   int start()                         the first entry of a ray's walk
//   int step(cur, r, sp, msbi, inst, best_t, stack, top, first, count)
//                                       one inner step from entry `cur`:
//                                       STEP_WALK (cur, the ray, the stack
//                                       moved on), STEP_LEAF (cur is a
//                                       triangle leaf of `count` triangles
//                                       from `first`) or STEP_POP
//   void rows(tri, a, b, c)             a triangle's three 16-byte rows
//   int num_tris
//
// Every output is the plain version's, bit for bit: the leaf arithmetic is
// the helpers' above, and the order of a ray's visits is the reader's. The
// binary reader (K1, K3) follows; K2's wide reader is in traverse_wide.cuh.
//
// Each library instantiates these templates with a scene type declared in
// its own unnamed namespace (K1Scene, K3Scene, K2Scene), so its kernels and
// launch state have internal linkage: K1's and K3's libraries would
// otherwise both export the same kernels, and the one loaded second would
// launch through the first one's.

// threads per block of a persistent kernel
constexpr int BLOCK = 512;
constexpr unsigned FULL = 0xffffffffu;
// a warp fetches more rays when at least this many of its lanes are free
constexpr int REFILL = 8;

// what an inner step left the lane holding
constexpr int STEP_WALK = 0, STEP_LEAF = 1, STEP_POP = 2;

// the packed buffer as a kernel reads it: its copy in shared memory
// (STAGED) or the buffer itself through the read-only path
template <bool STAGED>
struct Words {
    const float4* base;

    __device__ __forceinline__ float4 operator[](int i) const {
        if constexpr (STAGED) {
            return base[i];
        } else {
            return __ldg(base + i);
        }
    }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one bulk copy of the first `num_words` words of `src` into shared memory,
// waited for on the mbarrier `bar`
__device__ __forceinline__ void stage_words(float4* dst, const float4* src,
                                            int num_words, uint64_t* bar) {
    const uint32_t b = smem_u32(bar);
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(b) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        const uint32_t bytes = 16u * (uint32_t)num_words;
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     ::"r"(b), "r"(bytes) : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];"
            ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(b) : "memory");
    }
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done) : "r"(b), "r"(0u) : "memory");
    }
}

// the next entry from this thread's stack, restoring the world-space ray
// when the pop leaves an instance's tree; true when the stack is empty
__device__ __forceinline__ bool pop_entry(int& sp, int& msbi, int& cur, Ray& r,
                                          const Ray& world, const int* stack,
                                          int top) {
    if (sp == msbi) {
        r = world;
        msbi = -1;
    }
    --sp;
    if (sp < 0) return true;
    cur = stack[min(sp, top) * BLOCK];
    return false;
}

// The schedule: every ray of `rays` through the reader `s`, on this
// thread's stack (entry k at stack[k * BLOCK]) of `top + 1` entries.
template <bool ANY_HIT, int LEAF, class Reader>
__device__ __forceinline__ void walk_rays(const Reader& s, const Rays& rays,
                                          unsigned* __restrict__ counters,
                                          int* stack, int top) {
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;

    const auto rows = [&](int tri, float4& a, float4& b, float4& c) {
        s.rows(tri, a, b, c);
    };

    int ray = -1;  // the ray this lane holds, -1 when free
    Ray world, r;
    Best best;
    int sp = 0, msbi = -1, cur = 0, inst = 0;
    // the warp's window: 32 ray indices from win_base, the active ones not
    // yet handed out in win
    int win_base = 0;
    unsigned win = 0;
    bool more = true;

    while (true) {
        unsigned idle = __ballot_sync(FULL, ray < 0);
        if (more && __popc(idle) >= REFILL) {
            while (idle) {
                if (win == 0) {
                    // the next window; its inactive rays get their result now
                    int b = 0;
                    if (lane == 0) b = (int)atomicAdd(counters, 32u);
                    b = __shfl_sync(FULL, b, 0);
                    if (b >= rays.n) {
                        more = false;
                        break;
                    }
                    const int i = b + lane;
                    const bool live = i < rays.n && rays.active[i];
                    if (i < rays.n && !live)
                        store_hit<ANY_HIT>(rays, i, Best{0.0f, 0.0f, 0.0f, 0, 0, false});
                    win_base = b;
                    win = __ballot_sync(FULL, live);
                    continue;
                }
                // the k-th free lane takes the k-th active ray of the window
                const int take = min(__popc(idle), __popc(win));
                const int rank = __popc(idle & below);
                if (((idle >> lane) & 1u) && rank < take) {
                    ray = win_base + (int)__fns(win, 0, rank + 1);
                    world = load_ray(rays, ray);
                    r = world;
                    best = Best{rays.maxt[ray], 0.0f, 0.0f, 0, 0, false};
                    sp = 0;
                    msbi = -1;
                    cur = s.start();
                    inst = 0;
                }
                const int last = (int)__fns(win, 0, take);
                win = last >= 31 ? 0u : win & (FULL << (last + 1));
                idle = __ballot_sync(FULL, ray < 0);
            }
        }
        if (idle == FULL) break;  // no ray left to fetch, none in flight

        // while-while: every lane with a ray takes inner steps until each
        // live lane of the warp holds a triangle leaf or is done; then the
        // lanes at a leaf test it together
        bool done = false, at_leaf = false;
        int first = 0, count = 0;
        while (__any_sync(FULL, ray >= 0 && !at_leaf && !done)) {
            if (ray < 0 || at_leaf || done) continue;
            const int k = s.step(cur, r, sp, msbi, inst, best.t, stack, top, first, count);
            if (k == STEP_LEAF)
                at_leaf = true;
            else if (k == STEP_POP)
                done = pop_entry(sp, msbi, cur, r, world, stack, top);
        }
        if (at_leaf) {
            if (leaf_rows<ANY_HIT, LEAF>(r, rows, first, count, s.num_tris - 1, inst, best))
                done = true;  // an any-hit query is settled
            else
                done = pop_entry(sp, msbi, cur, r, world, stack, top);
        }
        if (done) {
            store_hit<ANY_HIT>(rays, ray, best);
            ray = -1;
        }
    }

    // the last block to finish sets the counters back to 0 for the next
    // launch: by then every block has had the answer to its last fetch
    __syncthreads();
    if (threadIdx.x == 0 && atomicAdd(counters + 1, 1u) == gridDim.x - 1) {
        atomicExch(counters, 0u);
        atomicExch(counters + 1, 0u);
    }
}

// A persistent kernel over a Scene: a struct with the packed buffer
// (`words`, `num_words`), `stack_cap` and `reader(Words<STAGED>)`, which
// gives the kernel's reader.
template <bool ANY_HIT, int LEAF, bool STAGED, class Scene>
__global__ void __launch_bounds__(BLOCK)
    persistent_kernel(Scene sc, Rays rays, unsigned* __restrict__ counters) {
    extern __shared__ __align__(16) float4 smem[];
    __shared__ uint64_t bar;
    const float4* base = sc.words;
    if constexpr (STAGED) {
        stage_words(smem, sc.words, sc.num_words, &bar);
        base = smem;
    }
    int* stack = reinterpret_cast<int*>(smem + (STAGED ? sc.num_words : 0)) + threadIdx.x;
    walk_rays<ANY_HIT, LEAF>(sc.reader(Words<STAGED>{base}), rays, counters, stack,
                             sc.stack_cap - 1);
}

constexpr int MAX_DEVICES = 64;

// persistent blocks per SM of one kernel at one shared-memory size, asked
// of the runtime once per (device, size) and kept
struct Occupancy {
    int device = -1;
    size_t smem = 0;
    int blocks = 0;
};

// Launch the persistent kernel of (ANY_HIT, LEAF, STAGED, Scene) on
// `stream` with enough blocks to fill the card once; returns
// cudaGetLastError().
template <bool ANY_HIT, int LEAF, bool STAGED, class Scene>
int launch_persistent(const Scene& sc, const Rays& rays, unsigned* counters,
                      void* stream) {
    // one copy per host thread: the renderers of a worker pool launch from
    // threads of their own, with Python's lock released
    static thread_local int sms[MAX_DEVICES];  // SM count per device, 0 until read
    static thread_local bool attr_set[MAX_DEVICES];
    static thread_local Occupancy cache[8];
    static thread_local int next = 0;
    auto kernel = persistent_kernel<ANY_HIT, LEAF, STAGED, Scene>;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (sms[dev] == 0) {
        err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
    }
    if (!attr_set[dev]) {
        // allow every block the most dynamic shared memory the card offers
        int optin = 0;
        cudaFuncAttributes fa;
        err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kernel);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       optin - (int)fa.sharedSizeBytes);
        if (err != cudaSuccess) return (int)err;
        attr_set[dev] = true;
    }
    const size_t smem = (STAGED ? 16 * (size_t)sc.num_words : 0) +
                        sizeof(int) * (size_t)sc.stack_cap * BLOCK;
    int per_sm = 0;
    for (const Occupancy& o : cache)
        if (o.device == dev && o.smem == smem) per_sm = o.blocks;
    if (per_sm == 0) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK, smem);
        if (err != cudaSuccess) return (int)err;
        if (per_sm == 0) return (int)cudaErrorLaunchOutOfResources;
        cache[next] = Occupancy{dev, smem, per_sm};
        next = (next + 1) % 8;
    }
    // enough blocks to fill the card once, and no more than the rays need
    const int wanted = (rays.n + BLOCK - 1) / BLOCK;
    const int blocks = std::min(sms[dev] * per_sm, wanted);
    kernel<<<blocks, BLOCK, smem, (cudaStream_t)stream>>>(sc, rays, counters);
    return (int)cudaGetLastError();
}

// the launch of the branch the host picked: the buffer `staged` in shared
// memory, or not
template <bool ANY_HIT, int LEAF, class Scene>
int launch_staged(const Scene& sc, int staged, const Rays& rays,
                  unsigned* counters, void* stream) {
    if (rays.n <= 0) return (int)cudaSuccess;
    return staged ? launch_persistent<ANY_HIT, LEAF, true>(sc, rays, counters, stream)
                  : launch_persistent<ANY_HIT, LEAF, false>(sc, rays, counters, stream);
}

// ---------------------------------------------------------------------------
// The binary reader, K1's and K3's: one buffer of 16-byte words, 64-byte
// node records [ld, rd, left box, right box] (ld, rd as int bits) from word
// 0, 48-byte triangle rows in the leaf form's layout from tri_at, 64-byte
// instance rows [3x4 world->object matrix, BLAS root] from inst_at. ld > 0:
// inner node with children ld and rd; ld <= 0, rd == 0: TLAS leaf of
// instance -ld; else a BLAS leaf of rd triangles from -ld.

template <bool STAGED>
struct BinaryReader {
    Words<STAGED> w;
    int num_tris, num_inst, tri_at, inst_at;

    __device__ __forceinline__ int start() const { return 0; }

    __device__ __forceinline__ void rows(int tri, float4& a, float4& b,
                                         float4& c) const {
        const int at = tri_at + 3 * tri;
        a = w[at];
        b = w[at + 1];
        c = w[at + 2];
    }

    __device__ __forceinline__ int step(int& node, Ray& r, int& sp, int& msbi,
                                        int& inst, float best_t, int* stack,
                                        int top, int& first,
                                        int& count) const {
        const float4 w0 = w[4 * node];
        const int ld = __float_as_int(w0.x);
        const int rd = __float_as_int(w0.y);
        if (ld <= 0) {
            if (rd == 0) {
                // TLAS leaf: move the ray into the instance's space
                const int id = min(max(-ld, 0), num_inst - 1);
                const int at = inst_at + 4 * id;
                to_instance_rows(r, w[at], w[at + 1], w[at + 2]);
                msbi = sp;
                inst = id;
                node = __float_as_int(w[at + 3].x);
                return STEP_WALK;
            }
            first = -ld;
            count = rd;
            return STEP_LEAF;
        }
        // inner node: both children's boxes are in its record
        const float4 w1 = w[4 * node + 1];
        const float4 w2 = w[4 * node + 2];
        const float4 w3 = w[4 * node + 3];
        const float l_dist = slab(r, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, best_t);
        const float r_dist = slab(r, w2.x, w2.y, w2.z, w2.w, w3.x, w3.y, best_t);
        const bool want_l = l_dist < FLT_MAX_F, want_r = r_dist < FLT_MAX_F;
        if (want_l & want_r) {
            const bool near_is_l = l_dist <= r_dist;
            stack[min(sp, top) * BLOCK] = near_is_l ? rd : ld;
            ++sp;
            node = near_is_l ? ld : rd;
            return STEP_WALK;
        }
        if (want_l | want_r) {
            node = want_l ? ld : rd;
            return STEP_WALK;
        }
        return STEP_POP;
    }
};

// a binary packed scene (ops/intersect_cuda.py::pack_scene_k1, and K3's
// own buffer ops/intersect_nodes.py::pack_scene_k3)
struct BinaryScene {
    const float4* __restrict__ words;
    int num_words, num_tris, num_inst;
    int tri_at, inst_at;
    int stack_cap;  // stack entries per thread

    template <bool STAGED>
    __device__ __forceinline__ BinaryReader<STAGED> reader(const Words<STAGED>& w) const {
        return BinaryReader<STAGED>{w, num_tris, num_inst, tri_at, inst_at};
    }
};

}  // namespace polaris

// the ray and result arguments every C entry point takes after its scene
#define POLARIS_CLOSEST_ARGS                                                   \
    int n, const float *o, const float *d, const float *maxt,                  \
        const uint8_t *active, float *out_t, float *out_u, float *out_v,       \
        int *out_tri, int *out_inst, uint8_t *out_found, void *stream
#define POLARIS_CLOSEST_RAYS                                                   \
    polaris::Rays {                                                            \
        n, o, d, maxt, active, out_t, out_u, out_v, out_tri, out_inst,         \
            out_found                                                          \
    }
#define POLARIS_ANY_ARGS                                                       \
    int n, const float *o, const float *d, const float *maxt,                  \
        const uint8_t *active, uint8_t *out_found, void *stream
#define POLARIS_ANY_RAYS                                                       \
    polaris::Rays {                                                            \
        n, o, d, maxt, active, nullptr, nullptr, nullptr, nullptr, nullptr,    \
            out_found                                                          \
    }
