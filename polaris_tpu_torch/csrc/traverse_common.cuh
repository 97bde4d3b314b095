// Device code shared by every traversal kernel of the package (sm_90a).
//
// Two designs use it. K2-K5 run ONE THREAD PER RAY in launch order, with a
// private stack in local memory and the scene read from global memory
// through the read-only path (__ldg); polaris::launch below starts them. K1
// (intersect.cu) runs persistent warps that fetch only the live rays, with
// the scene staged in shared memory where it fits and the stack in shared
// memory; it has its own launcher. What differs between the kernels is the
// node layout, the entry encoding and the child order; what they share
// lives here:
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
//     all with strict updates: the first of two equal hits wins. The
//     scaled forms take a triangle as three 16-byte rows (scaled_math), so a
//     kernel may load them from its own layout and memory (scan_rows,
//     leaf_rows with a row loader; tri_rows reads the separate arrays)
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

namespace polaris {

constexpr int THREADS = 128;
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

// triangles as three base pointers and a common stride in floats: separate
// (T,3) arrays have stride 3, one packed (T,9) array [v0, e1, e2] stride 9;
// Havel-Herout rows (T,12) are three groups of four, [N d0], [N1 d1], [N2 d2],
// stride 12
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

// the same from 12 floats in global memory, rows of a 3x4 matrix
__device__ __forceinline__ void to_instance(Ray& r, const float* m) {
    to_instance_rows(
        r, make_float4(__ldg(m + 0), __ldg(m + 1), __ldg(m + 2), __ldg(m + 3)),
        make_float4(__ldg(m + 4), __ldg(m + 5), __ldg(m + 6), __ldg(m + 7)),
        make_float4(__ldg(m + 8), __ldg(m + 9), __ldg(m + 10), __ldg(m + 11)));
}

// `count` triangles from `first` against the ray, quotient form. Closest hit
// keeps the nearest in `best`; any hit returns at the first one. Returns true
// when an any-hit query is settled.
template <bool ANY_HIT>
__device__ __forceinline__ bool test_leaf_quot(const Ray& r, const Tris& tris,
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

// the three rows of triangle `tri` of `tris` in the kernel's leaf form:
// v0, e1, e2 (LEAF_DET2) or the Havel-Herout rows (LEAF_HH, 16-byte loads)
template <int LEAF>
__device__ __forceinline__ void tri_rows(const Tris& tris, int tri, float4& a,
                                         float4& b, float4& c) {
    const size_t at = (size_t)tri * tris.stride;
    if constexpr (LEAF == LEAF_HH) {
        a = __ldg(reinterpret_cast<const float4*>(tris.v0 + at));
        b = __ldg(reinterpret_cast<const float4*>(tris.e1 + at));
        c = __ldg(reinterpret_cast<const float4*>(tris.e2 + at));
    } else {
        const float* p0 = tris.v0 + at;
        const float* p1 = tris.e1 + at;
        const float* p2 = tris.e2 + at;
        c = make_float4(__ldg(p2 + 0), __ldg(p2 + 1), __ldg(p2 + 2), 0.0f);
        b = make_float4(__ldg(p1 + 0), __ldg(p1 + 1), __ldg(p1 + 2), 0.0f);
        a = make_float4(__ldg(p0 + 0), __ldg(p0 + 1), __ldg(p0 + 2), 0.0f);
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

// scan_rows over the triangles of `tris`
template <bool ANY_HIT, int LEAF>
__device__ __forceinline__ bool scan_scaled(const Ray& r, const Tris& tris,
                                            int first, int count, int inst,
                                            Best& best, float& den,
                                            bool& accepted) {
    const auto rows = [&](int tri, float4& a, float4& b, float4& c) {
        tri_rows<LEAF>(tris, tri, a, b, c);
    };
    return scan_rows<ANY_HIT, LEAF>(r, rows, first, count, tris.count - 1, inst,
                                    best, den, accepted);
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

// One leaf visit in the kernel's leaf form over the triangles of `tris`.
template <bool ANY_HIT, int LEAF>
__device__ __forceinline__ bool test_leaf(const Ray& r, const Tris& tris,
                                          int first, int count, int inst,
                                          Best& best) {
    if constexpr (LEAF == LEAF_QUOT) {
        return test_leaf_quot<ANY_HIT>(r, tris, first, count, inst, best);
    } else {
        const auto rows = [&](int tri, float4& a, float4& b, float4& c) {
            tri_rows<LEAF>(tris, tri, a, b, c);
        };
        return leaf_rows<ANY_HIT, LEAF>(r, rows, first, count, tris.count - 1,
                                        inst, best);
    }
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
