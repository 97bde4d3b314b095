// Two-level BVH traversal for NVIDIA Hopper (sm_90a): closest hit and any hit.
//
// Replaces the TPU kernel polaris_tpu/ops/intersect_pallas.py::_kernel (the
// default Moller-Trumbore, resident-triangle variant). That kernel walks a
// 1024-ray tile with ONE shared stack on the scalar core and votes across
// the tile at every node, because a TPU has no per-lane control flow. None
// of that staging is carried over. What is kept is what it computes:
//
//   * closest hit / any hit over a TLAS of instances and one BLAS per mesh;
//     a TLAS leaf transforms the ray by the instance's 3x4 world->object
//     matrix and the ray is restored when the BLAS is exhausted (stack
//     watermark `msbi`)
//   * slab test with a 1e-30 direction floor; a child is skipped when
//     tf < 0 | tn > tf | tn >= best
//   * Moller-Trumbore with |det| >= EPS, 0 <= u <= 1, v >= 0, u + v <= 1,
//     t > EPS, and a strict t < best update (first of two equal hits wins)
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
// Triangle test: the QUOTIENT form (one divide per triangle, u = dot*inv_det)
// exactly as the plain PyTorch version ops/intersect.py::intersect_bvh
// writes it, not the det^2-scaled form of the TPU kernel. Every sum is
// written in that version's association, and the file is compiled with
// -fmad=false so each multiply and add rounds on its own as it does there:
// kernel and plain version then take identical hit/miss decisions.
//
// Plain C interface (no torch headers): the launchers take raw device
// pointers and a stream and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int STACK_SIZE = 64;
constexpr int THREADS = 128;
constexpr float EPS = 1e-5f;
constexpr float FLT_MAX_F = 3.4028235e38f;

struct Scene {
    const float* __restrict__ bvh_min;   // (N,3)
    const float* __restrict__ bvh_max;   // (N,3)
    const int* __restrict__ ldata;       // (N,)
    const int* __restrict__ rdata;       // (N,)
    const float* __restrict__ tri_v0;    // (T,3)
    const float* __restrict__ tri_e1;    // (T,3)
    const float* __restrict__ tri_e2;    // (T,3)
    const float* __restrict__ w2o;       // (I,4,4) row-major
    const int* __restrict__ roots;       // (I,)
    int num_tris;
    int num_inst;
};

__device__ __forceinline__ float inv_dir(float d) {
    float f = d < 0.0f ? -1e-30f : 1e-30f;
    return 1.0f / (fabsf(d) < 1e-30f ? f : d);
}

// entry distance of the ray into a node's box, FLT_MAX on a miss
__device__ __forceinline__ float slab(const Scene& s, int node, float ox,
                                      float oy, float oz, float ix, float iy,
                                      float iz, float best) {
    const float* mn = s.bvh_min + 3 * (size_t)node;
    const float* mx = s.bvh_max + 3 * (size_t)node;
    float tx0 = (__ldg(mn + 0) - ox) * ix, tx1 = (__ldg(mx + 0) - ox) * ix;
    float ty0 = (__ldg(mn + 1) - oy) * iy, ty1 = (__ldg(mx + 1) - oy) * iy;
    float tz0 = (__ldg(mn + 2) - oz) * iz, tz1 = (__ldg(mx + 2) - oz) * iz;
    float tn = fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1));
    float tf = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
    bool miss = (tf < 0.0f) | (tn > tf) | (tn >= best);
    return miss ? FLT_MAX_F : tn;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(THREADS)
traverse(Scene s, int n, const float* __restrict__ o,
         const float* __restrict__ d, const float* __restrict__ maxt,
         const uint8_t* __restrict__ active, float* __restrict__ out_t,
         float* __restrict__ out_u, float* __restrict__ out_v,
         int* __restrict__ out_tri, int* __restrict__ out_inst,
         uint8_t* __restrict__ out_found) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;

    float best_t = 0.0f, best_u = 0.0f, best_v = 0.0f;
    int best_tri = 0, best_inst = 0;
    bool found = false;

    if (active[i]) {
        const float wox = o[3 * (size_t)i + 0], woy = o[3 * (size_t)i + 1],
                    woz = o[3 * (size_t)i + 2];
        const float wdx = d[3 * (size_t)i + 0], wdy = d[3 * (size_t)i + 1],
                    wdz = d[3 * (size_t)i + 2];
        float ox = wox, oy = woy, oz = woz, dx = wdx, dy = wdy, dz = wdz;
        float ix = inv_dir(dx), iy = inv_dir(dy), iz = inv_dir(dz);
        best_t = maxt[i];

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
                    const float* m = s.w2o + 16 * (size_t)id;
                    float m0 = __ldg(m + 0), m1 = __ldg(m + 1), m2 = __ldg(m + 2),
                          m3 = __ldg(m + 3), m4 = __ldg(m + 4), m5 = __ldg(m + 5),
                          m6 = __ldg(m + 6), m7 = __ldg(m + 7), m8 = __ldg(m + 8),
                          m9 = __ldg(m + 9), m10 = __ldg(m + 10),
                          m11 = __ldg(m + 11);
                    float px = ox, py = oy, pz = oz, qx = dx, qy = dy, qz = dz;
                    ox = ((m0 * px + m1 * py) + m2 * pz) + m3;
                    oy = ((m4 * px + m5 * py) + m6 * pz) + m7;
                    oz = ((m8 * px + m9 * py) + m10 * pz) + m11;
                    dx = (m0 * qx + m1 * qy) + m2 * qz;
                    dy = (m4 * qx + m5 * qy) + m6 * qz;
                    dz = (m8 * qx + m9 * qy) + m10 * qz;
                    ix = inv_dir(dx); iy = inv_dir(dy); iz = inv_dir(dz);
                    msbi = sp;
                    inst = id;
                    node = __ldg(s.roots + id);
                    continue;
                }
                // BLAS leaf: rd triangles starting at -ld
                const int first = -ld;
                for (int j = 0; j < rd; ++j) {
                    const int tri = min(first + j, s.num_tris - 1);
                    const float* p0 = s.tri_v0 + 3 * (size_t)tri;
                    const float* p1 = s.tri_e1 + 3 * (size_t)tri;
                    const float* p2 = s.tri_e2 + 3 * (size_t)tri;
                    float e2x = __ldg(p2 + 0), e2y = __ldg(p2 + 1), e2z = __ldg(p2 + 2);
                    float e1x = __ldg(p1 + 0), e1y = __ldg(p1 + 1), e1z = __ldg(p1 + 2);
                    // pvec = d x e2
                    float pvx = dy * e2z - dz * e2y;
                    float pvy = dz * e2x - dx * e2z;
                    float pvz = dx * e2y - dy * e2x;
                    float det = (e1x * pvx + e1y * pvy) + e1z * pvz;
                    bool ok = fabsf(det) >= EPS;
                    float inv_det = 1.0f / (ok ? det : 1.0f);
                    float tvx = ox - __ldg(p0 + 0), tvy = oy - __ldg(p0 + 1),
                          tvz = oz - __ldg(p0 + 2);
                    float uu = ((tvx * pvx + tvy * pvy) + tvz * pvz) * inv_det;
                    ok &= (uu >= 0.0f) & (uu <= 1.0f);
                    // qvec = tvec x e1
                    float qvx = tvy * e1z - tvz * e1y;
                    float qvy = tvz * e1x - tvx * e1z;
                    float qvz = tvx * e1y - tvy * e1x;
                    float vv = ((dx * qvx + dy * qvy) + dz * qvz) * inv_det;
                    ok &= (vv >= 0.0f) & (uu + vv <= 1.0f);
                    float tt = ((e2x * qvx + e2y * qvy) + e2z * qvz) * inv_det;
                    ok &= (tt > EPS) & (tt < best_t);
                    if (ok) {
                        found = true;
                        if (ANY_HIT) break;
                        best_t = tt;
                        best_u = uu;
                        best_v = vv;
                        best_tri = tri;
                        best_inst = inst;
                    }
                }
                if (ANY_HIT && found) break;
                pop = true;
            } else {
                // inner node: both children, near first
                float l_dist = slab(s, ld, ox, oy, oz, ix, iy, iz, best_t);
                float r_dist = slab(s, rd, ox, oy, oz, ix, iy, iz, best_t);
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
                    ox = wox; oy = woy; oz = woz;
                    dx = wdx; dy = wdy; dz = wdz;
                    ix = inv_dir(dx); iy = inv_dir(dy); iz = inv_dir(dz);
                    msbi = -1;
                }
                --sp;
                if (sp < 0) break;
                node = stack[min(sp, STACK_SIZE - 1)];
            }
        }
    }

    out_found[i] = found ? 1 : 0;
    if (!ANY_HIT) {
        out_t[i] = found ? best_t : 0.0f;
        out_u[i] = best_u;
        out_v[i] = best_v;
        out_tri[i] = best_tri;
        out_inst[i] = best_inst;
    }
}

template <bool ANY_HIT>
int launch(const Scene& s, int n, const float* o, const float* d,
           const float* maxt, const uint8_t* active, float* out_t,
           float* out_u, float* out_v, int* out_tri, int* out_inst,
           uint8_t* out_found, cudaStream_t stream) {
    if (n <= 0) return (int)cudaSuccess;
    int blocks = (n + THREADS - 1) / THREADS;
    traverse<ANY_HIT><<<blocks, THREADS, 0, stream>>>(
        s, n, o, d, maxt, active, out_t, out_u, out_v, out_tri, out_inst,
        out_found);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int polaris_closest_hit(
    const float* bvh_min, const float* bvh_max, const int* ldata,
    const int* rdata, const float* tri_v0, const float* tri_e1,
    const float* tri_e2, const float* w2o, const int* roots, int num_tris,
    int num_inst, int n, const float* o, const float* d, const float* maxt,
    const uint8_t* active, float* out_t, float* out_u, float* out_v,
    int* out_tri, int* out_inst, uint8_t* out_found, void* stream) {
    Scene s{bvh_min, bvh_max, ldata, rdata, tri_v0, tri_e1, tri_e2, w2o,
            roots, num_tris, num_inst};
    return launch<false>(s, n, o, d, maxt, active, out_t, out_u, out_v,
                         out_tri, out_inst, out_found, (cudaStream_t)stream);
}

extern "C" int polaris_any_hit(
    const float* bvh_min, const float* bvh_max, const int* ldata,
    const int* rdata, const float* tri_v0, const float* tri_e1,
    const float* tri_e2, const float* w2o, const int* roots, int num_tris,
    int num_inst, int n, const float* o, const float* d, const float* maxt,
    const uint8_t* active, uint8_t* out_found, void* stream) {
    Scene s{bvh_min, bvh_max, ldata, rdata, tri_v0, tri_e1, tri_e2, w2o,
            roots, num_tris, num_inst};
    return launch<true>(s, n, o, d, maxt, active, nullptr, nullptr, nullptr,
                        nullptr, nullptr, out_found, (cudaStream_t)stream);
}
