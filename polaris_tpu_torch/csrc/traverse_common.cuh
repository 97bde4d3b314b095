// Device code shared by every traversal kernel of the package (sm_90a).
//
// All kernels follow one design: ONE THREAD PER RAY, a private stack in local
// memory, scene arrays read from global memory through the read-only path
// (__ldg). What differs between them is the node layout, the entry encoding
// and the child order; what they share lives here:
//
//   * the ray (origin, direction, reciprocal direction with a 1e-30 floor)
//   * the slab test: a box is skipped when tf < 0 | tn > tf | tn >= best
//   * the move into an instance's space by a row-major 3x4 world->object
//     matrix
//   * the triangle test: QUOTIENT-form Moller-Trumbore with |det| >= EPS,
//     0 <= u <= 1, v >= 0, u + v <= 1, EPS < t < best, and the leaf loop with
//     its strict t < best update (the first of two equal hits wins)
//   * loading a ray and storing a hit (inactive lanes: found = 0, t = 0)
//
// Every sum is written in the association of the plain PyTorch versions
// (ops/intersect.py), and every file that includes this header is compiled
// with -fmad=false, so that each multiply and add rounds on its own as it
// does there. Because all kernels call this one triangle test, they take
// identical hit/miss decisions and return identical t, u, v: a closest hit
// depends on the visit order only on an exact tie in t.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace polaris {

constexpr int THREADS = 128;
constexpr float EPS = 1e-5f;
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

// triangles as three base pointers and a common stride in floats: separate
// (T,3) arrays have stride 3, one packed (T,9) array [v0, e1, e2] stride 9
struct Tris {
    const float* __restrict__ v0;
    const float* __restrict__ e1;
    const float* __restrict__ e2;
    int stride;
    int count;
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

// move the ray into an instance's space; m: 12 floats, rows of a 3x4 matrix
__device__ __forceinline__ void to_instance(Ray& r, const float* m) {
    float m0 = __ldg(m + 0), m1 = __ldg(m + 1), m2 = __ldg(m + 2),
          m3 = __ldg(m + 3), m4 = __ldg(m + 4), m5 = __ldg(m + 5),
          m6 = __ldg(m + 6), m7 = __ldg(m + 7), m8 = __ldg(m + 8),
          m9 = __ldg(m + 9), m10 = __ldg(m + 10), m11 = __ldg(m + 11);
    float px = r.ox, py = r.oy, pz = r.oz, qx = r.dx, qy = r.dy, qz = r.dz;
    set_ray(r,
            ((m0 * px + m1 * py) + m2 * pz) + m3,
            ((m4 * px + m5 * py) + m6 * pz) + m7,
            ((m8 * px + m9 * py) + m10 * pz) + m11,
            (m0 * qx + m1 * qy) + m2 * qz,
            (m4 * qx + m5 * qy) + m6 * qz,
            (m8 * qx + m9 * qy) + m10 * qz);
}

// `count` triangles from `first` against the ray. Closest hit keeps the
// nearest in `best`; any hit returns at the first one. Returns true when an
// any-hit query is settled.
template <bool ANY_HIT>
__device__ __forceinline__ bool test_leaf(const Ray& r, const Tris& tris,
                                          int first, int count, int inst,
                                          Best& best) {
    for (int j = 0; j < count; ++j) {
        const int tri = min(first + j, tris.count - 1);
        const size_t at = (size_t)tri * tris.stride;
        const float* p0 = tris.v0 + at;
        const float* p1 = tris.e1 + at;
        const float* p2 = tris.e2 + at;
        float e2x = __ldg(p2 + 0), e2y = __ldg(p2 + 1), e2z = __ldg(p2 + 2);
        float e1x = __ldg(p1 + 0), e1y = __ldg(p1 + 1), e1z = __ldg(p1 + 2);
        // pvec = d x e2
        float pvx = r.dy * e2z - r.dz * e2y;
        float pvy = r.dz * e2x - r.dx * e2z;
        float pvz = r.dx * e2y - r.dy * e2x;
        float det = (e1x * pvx + e1y * pvy) + e1z * pvz;
        bool ok = fabsf(det) >= EPS;
        float inv_det = 1.0f / (ok ? det : 1.0f);
        float tvx = r.ox - __ldg(p0 + 0), tvy = r.oy - __ldg(p0 + 1),
              tvz = r.oz - __ldg(p0 + 2);
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

// Launch `kernel` (one thread per ray) on `stream`; returns cudaGetLastError().
// The C entry points of every traversal library end here: they take raw
// device pointers and a stream, no PyTorch headers.
template <typename SceneT>
inline int launch(void (*kernel)(SceneT, Rays), const SceneT& s,
                  const Rays& rays, void* stream) {
    if (rays.n <= 0) return (int)cudaSuccess;
    int blocks = (rays.n + THREADS - 1) / THREADS;
    kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(s, rays);
    return (int)cudaGetLastError();
}

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
