// K1: two-level BVH traversal for NVIDIA Hopper (sm_90a), closest hit and
// any hit.
//
// Replaces the TPU kernel polaris_tpu/ops/intersect_pallas.py::_kernel, with
// both of its triangle tests: det^2-scaled Moller-Trumbore (`mt`, the
// default) and the Havel-Herout precomputed planes (`hh`, chosen when the
// scene is packed). That kernel walks a 1024-ray tile with ONE shared stack
// on the scalar core and votes across the tile at every node, because a TPU
// has no per-lane control flow. None of that staging is carried over. What
// is kept is what it computes:
//
//   * closest hit / any hit over a TLAS of instances and one BLAS per mesh;
//     a TLAS leaf transforms the ray by the instance's 3x4 world->object
//     matrix and the ray is restored when the BLAS is exhausted (stack
//     watermark `msbi`)
//   * slab test with a 1e-30 direction floor; a child is skipped when
//     tf < 0 | tn > tf | tn >= best; the near child is visited first
//   * the leaf arithmetic, det^2-scaled in both tests: numerators u*det,
//     v*det, t*det over det^2 >= EPS^2, 0 <= u_num <= det^2, v_num >= 0,
//     u_num + v_num <= det^2, t_num > EPS*det^2; the best hit compared by
//     cross-multiplication (strict: the first of two equal hits wins), the
//     denominator reset to 1 at every leaf and ONE divide when a leaf ends;
//     any hit compares t_num < maxt*det^2 and never divides
//   * inactive lanes return found = 0, t = 0
//
// Every ray visits the same nodes in the same order and runs the same leaf
// arithmetic as the plain PyTorch version ops/intersect.py::intersect_bvh
// (leaf="det2" | "hh"), so every output is that version's, bit for bit. The
// design below only decides which thread holds a ray, when, and where the
// scene and the stack live.
//
// What bounds K1 on this card (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py
// and scripts/torch_k1_timing.py, numbers in PERF.md): neither
// device-memory bytes (the rays, the results and the scene records touched
// are a few MB per launch) nor the fp32 rate (the slab and triangle tests
// of a frame's rays come to 2-6% of what a one-thread-per-ray kernel takes,
// 4-14% of this one). The time goes to lanes that wait: on inactive rays,
// on the busiest lane of their warp (the SIMT ceiling of a frame's rays,
// useful lane-steps over issued ones when each warp lasts as long as its
// busiest lane, is 0.72 for primary rays and 0.18-0.51 for bounce and
// shadow rays), on the tail of a single wave, and on dependent loads through
// L1/L2 and a stack in local memory. The design answers each:
//
//   1. PERSISTENT WARPS THAT FETCH ONLY LIVE RAYS. The grid fills the card
//      once (blocks per SM from the occupancy the runtime reports). Each
//      warp takes windows of 32 ray indices from a counter in global memory
//      (one atomicAdd each), writes the results of a window's inactive rays
//      at once and hands only the active ones to its lanes (__ballot_sync,
//      __fns); a lane whose ray is done takes a new one as soon as REFILL
//      lanes of its warp are free (dynamic fetch, Aila and Laine 2009). The
//      last block to finish resets the counter, so a launch needs no memset
//      and replays from a CUDA graph.
//   2. WHILE-WHILE. The lanes of a warp walk inner nodes and TLAS leaves
//      until every live lane holds a BLAS leaf or is done (__any_sync), and
//      only then test leaves, together: a lane no longer waits through a
//      neighbour's 33 triangle tests one inner node at a time. Each ray's
//      visits keep their order; only their timing moves.
//   3. THE SCENE IN SHARED MEMORY. K1's own layout
//      (ops/intersect_cuda.py::pack_scene_k1) is one buffer of 16-byte
//      words: 64-byte node records [ld, rd, left box, right box], 48-byte
//      triangle rows, 64-byte instance rows [3x4 matrix, root]. Each block
//      copies it into shared memory once, by one bulk copy (cp.async.bulk,
//      completion on an mbarrier), when the scene and the block's stacks
//      fit; every read is then a 16-byte shared load, one load level per
//      inner node, and lanes on the same triangle get a broadcast. A scene
//      that does not fit (the terrains) takes the same kernel reading the
//      buffer from global memory (template parameter STAGED); the byte
//      count alone picks.
//   4. THE STACK IN SHARED MEMORY, laid out [depth][thread] so the 32 lanes
//      of a warp always fall on 32 banks, sized by the scene's own depth
//      (the packer's stack_need, at most 64 entries, clamped as the plain
//      version clamps).
//
// What it costs: 0.013-0.014 ms a launch that traces nothing (every lane
// inactive; the one-thread-per-ray kernel took 0.0035 ms), mostly the
// counter's atomics and the copy of the scene. On launches that take
// 0.02-0.03 ms in all (cornell) that is more than the design saves.
//
// Tensor cores have no place here: the work is dependent scalar fp32
// arithmetic whose compares must round as the plain version's do.
//
// Every sum is written in the plain version's association, and the file is
// compiled with -fmad=false so each multiply and add rounds on its own as it
// does there: kernel and plain version take identical hit/miss decisions.
//
// Plain C interface (no torch headers): the entry points take raw device
// pointers and a stream and return a CUDA error code.

#include <algorithm>

#include "traverse_common.cuh"

namespace {

using namespace polaris;

constexpr int K1_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;
// a warp fetches more rays when at least this many of its lanes are free
constexpr int REFILL = 8;

// K1's packed scene: one buffer of 16-byte words, node records (4 words
// each) from word 0, triangle rows (3 words) from tri_at, instance rows
// (4 words) from inst_at
struct K1Scene {
    const float4* __restrict__ words;
    int num_words, num_tris, num_inst;
    int tri_at, inst_at;
    int stack_cap;  // stack entries per thread
};

template <bool STAGED>
__device__ __forceinline__ float4 word(const float4* base, int i) {
    if constexpr (STAGED) {
        return base[i];
    } else {
        return __ldg(base + i);
    }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one bulk copy of the scene into shared memory, waited for on the mbarrier
// `bar`
__device__ __forceinline__ void stage_scene(float4* dst, const float4* src,
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

// the next node from this thread's stack, restoring the world-space ray
// when the pop leaves a BLAS; true when the stack is empty
__device__ __forceinline__ bool pop_node(int& sp, int& msbi, int& node, Ray& r,
                                         const Ray& world, const int* stack,
                                         int top) {
    if (sp == msbi) {
        r = world;
        msbi = -1;
    }
    --sp;
    if (sp < 0) return true;
    node = stack[min(sp, top) * K1_THREADS];
    return false;
}

template <bool ANY_HIT, int LEAF, bool STAGED>
__global__ void __launch_bounds__(K1_THREADS)
    k1_traverse(K1Scene s, Rays rays, unsigned* __restrict__ counters) {
    extern __shared__ __align__(16) float4 smem[];
    __shared__ uint64_t bar;
    const float4* base = s.words;
    if constexpr (STAGED) {
        stage_scene(smem, s.words, s.num_words, &bar);
        base = smem;
    }
    // this thread's stack: entry k at stack[k * K1_THREADS]
    int* stack = reinterpret_cast<int*>(smem + (STAGED ? s.num_words : 0)) +
                 threadIdx.x;
    const int top = s.stack_cap - 1;
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;

    const auto rows = [&](int tri, float4& a, float4& b, float4& c) {
        const int at = s.tri_at + 3 * tri;
        a = word<STAGED>(base, at);
        b = word<STAGED>(base, at + 1);
        c = word<STAGED>(base, at + 2);
    };

    int ray = -1;  // the ray this lane holds, -1 when free
    Ray world, r;
    Best best;
    int sp = 0, msbi = -1, node = 0, inst = 0;
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
                    node = 0;
                    inst = 0;
                }
                const int last = (int)__fns(win, 0, take);
                win = last >= 31 ? 0u : win & (FULL << (last + 1));
                idle = __ballot_sync(FULL, ray < 0);
            }
        }
        if (idle == FULL) break;  // no ray left to fetch, none in flight

        // while-while: every lane with a ray walks inner nodes and TLAS
        // leaves until each live lane of the warp holds a BLAS leaf or is
        // done; then the lanes at a leaf test it together
        bool done = false, at_leaf = false;
        int ld = 0, rd = 0;
        while (__any_sync(FULL, ray >= 0 && !at_leaf && !done)) {
            if (ray < 0 || at_leaf || done) continue;
            bool pop = false;
            const float4 w0 = word<STAGED>(base, 4 * node);
            ld = __float_as_int(w0.x);
            rd = __float_as_int(w0.y);
            if (ld <= 0) {
                if (rd == 0) {
                    // TLAS leaf: move the ray into the instance's space
                    const int id = min(max(-ld, 0), s.num_inst - 1);
                    const int at = s.inst_at + 4 * id;
                    to_instance_rows(r, word<STAGED>(base, at), word<STAGED>(base, at + 1),
                                     word<STAGED>(base, at + 2));
                    msbi = sp;
                    inst = id;
                    node = __float_as_int(word<STAGED>(base, at + 3).x);
                } else {
                    at_leaf = true;
                }
            } else {
                // inner node: both children's boxes are in its record
                const float4 w1 = word<STAGED>(base, 4 * node + 1);
                const float4 w2 = word<STAGED>(base, 4 * node + 2);
                const float4 w3 = word<STAGED>(base, 4 * node + 3);
                const float l_dist = slab(r, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, best.t);
                const float r_dist = slab(r, w2.x, w2.y, w2.z, w2.w, w3.x, w3.y, best.t);
                const bool want_l = l_dist < FLT_MAX_F, want_r = r_dist < FLT_MAX_F;
                if (want_l & want_r) {
                    const bool near_is_l = l_dist <= r_dist;
                    stack[min(sp, top) * K1_THREADS] = near_is_l ? rd : ld;
                    ++sp;
                    node = near_is_l ? ld : rd;
                } else if (want_l | want_r) {
                    node = want_l ? ld : rd;
                } else {
                    pop = true;
                }
            }
            if (pop) done = pop_node(sp, msbi, node, r, world, stack, top);
        }
        if (at_leaf) {
            if (leaf_rows<ANY_HIT, LEAF>(r, rows, -ld, rd, s.num_tris - 1, inst, best))
                done = true;  // an any-hit query is settled
            else
                done = pop_node(sp, msbi, node, r, world, stack, top);
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

constexpr int MAX_DEVICES = 64;

// persistent blocks per SM of one kernel at one shared-memory size, asked
// of the runtime once per (device, size) and kept
struct Occupancy {
    int device = -1;
    size_t smem = 0;
    int blocks = 0;
};

template <bool ANY_HIT, int LEAF, bool STAGED>
int launch_k1(const K1Scene& s, const Rays& rays, unsigned* counters,
              void* stream) {
    static int sms[MAX_DEVICES];  // SM count per device, 0 until read
    static bool attr_set[MAX_DEVICES];
    static Occupancy cache[8];
    auto kernel = k1_traverse<ANY_HIT, LEAF, STAGED>;
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
    const size_t smem = (STAGED ? 16 * (size_t)s.num_words : 0) +
                        sizeof(int) * (size_t)s.stack_cap * K1_THREADS;
    int per_sm = 0;
    for (const Occupancy& o : cache)
        if (o.device == dev && o.smem == smem) per_sm = o.blocks;
    if (per_sm == 0) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, K1_THREADS, smem);
        if (err != cudaSuccess) return (int)err;
        if (per_sm == 0) return (int)cudaErrorLaunchOutOfResources;
        static int next = 0;
        cache[next] = Occupancy{dev, smem, per_sm};
        next = (next + 1) % 8;
    }
    // enough blocks to fill the card once, and no more than the rays need
    const int wanted = (rays.n + K1_THREADS - 1) / K1_THREADS;
    const int blocks = std::min(sms[dev] * per_sm, wanted);
    kernel<<<blocks, K1_THREADS, smem, (cudaStream_t)stream>>>(s, rays, counters);
    return (int)cudaGetLastError();
}

template <bool ANY_HIT, int LEAF>
int run(const void* words, int num_words, int num_tris, int num_inst,
        int tri_at, int inst_at, int stack_cap, int staged, unsigned* counters,
        const Rays& rays, void* stream) {
    if (rays.n <= 0) return (int)cudaSuccess;
    const K1Scene s{static_cast<const float4*>(words), num_words, num_tris,
                    num_inst, tri_at, inst_at, stack_cap};
    return staged ? launch_k1<ANY_HIT, LEAF, true>(s, rays, counters, stream)
                  : launch_k1<ANY_HIT, LEAF, false>(s, rays, counters, stream);
}

}  // namespace

// the packed scene (ops/intersect_cuda.py::pack_scene_k1), whether it is
// staged in shared memory, and the two counters of the persistent launch
#define K1_ARGS                                                                \
    const void *words, int num_words, int num_tris, int num_inst, int tri_at,  \
        int inst_at, int stack_cap, int staged, unsigned *counters
#define K1_SCENE                                                               \
    words, num_words, num_tris, num_inst, tri_at, inst_at, stack_cap, staged,  \
        counters

extern "C" int polaris_closest_hit(K1_ARGS, POLARIS_CLOSEST_ARGS) {
    return run<false, LEAF_DET2>(K1_SCENE, POLARIS_CLOSEST_RAYS, stream);
}

extern "C" int polaris_any_hit(K1_ARGS, POLARIS_ANY_ARGS) {
    return run<true, LEAF_DET2>(K1_SCENE, POLARIS_ANY_RAYS, stream);
}

extern "C" int polaris_closest_hit_hh(K1_ARGS, POLARIS_CLOSEST_ARGS) {
    return run<false, LEAF_HH>(K1_SCENE, POLARIS_CLOSEST_RAYS, stream);
}

extern "C" int polaris_any_hit_hh(K1_ARGS, POLARIS_ANY_ARGS) {
    return run<true, LEAF_HH>(K1_SCENE, POLARIS_ANY_RAYS, stream);
}
