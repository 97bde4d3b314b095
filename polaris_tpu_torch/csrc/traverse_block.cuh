// The block-local live-ray schedule of K4 (intersect_wide8.cu) and K5
// (intersect_dense.cu), sm_90a.
//
// K1, K2 and K3 run the persistent schedule of traverse_common.cuh: warps
// that fetch 32-ray windows from a counter in device memory. On the H100 a
// launch of it that traces nothing costs 0.010-0.015 ms (the counter's
// atomics 4-5 us, the scene copy 0.6-3.3 us; PERF.md), as much as a whole
// launch of K4 or K5 on cornell's frames. This schedule keeps what paid off
// there (only live rays reach lanes, the scene and the stack in shared
// memory) and drops the counter:
//
//   * A STATIC GRID WITH NO COUNTER. At most SMs x resident blocks (the
//     occupancy the runtime reports, asked once per device and shared-memory
//     size), and no more blocks than windows. Block b takes the windows
//     b, b + gridDim.x, b + 2 gridDim.x, ... of BLOCK_RAYS consecutive ray
//     indices. No atomics, no counters, nothing to reset: a launch replays
//     from a CUDA graph as it is, and launches on any streams may overlap.
//   * LIVE RAYS ONLY. In each window every thread reads one `active` flag;
//     an inactive ray gets its result at once (found 0, t 0, as store_hit
//     writes it). Each warp writes the indices of its active rays, in order,
//     into its own slot of a shared array (__ballot_sync, __popc) and its
//     count beside them; after one barrier thread j finds compacted ray j by
//     a prefix over the warps' counts. The live rays fill the leading warps;
//     a warp past the last live ray skips the window whole. The arrays are
//     double-buffered, so one barrier per window is enough.
//   * THE SCENE IN SHARED MEMORY when it is small (the host picks by byte
//     count, ops/intersect_cuda.py::block_staging): each block copies the
//     kernel's buffer once, by cooperative 16-byte loads issued before the
//     first window's compaction, which the window's barrier completes. Else
//     every read goes through the read-only path, L1 and L2. On the H100 a
//     bulk copy (cp.async.bulk on an mbarrier) cost about a microsecond more
//     a launch on cornell's frames, and a buffer above 48 KB read faster
//     from L1 than staged, one copy per block (PERF.md).
//
// A lane's result depends on its own ray only, so the bits are the plain
// version's whichever lane, window or block takes the ray.

#pragma once

#include "traverse_common.cuh"

namespace polaris {

// threads per block, and rays per window (BLOCK_THREADS in
// ops/intersect_cuda.py, whose staging rule counts them)
constexpr int BLOCK_RAYS = 256;
constexpr int BLOCK_WARPS = BLOCK_RAYS / 32;
static_assert(BLOCK_RAYS % 32 == 0 && BLOCK_WARPS <= 32, "whole warps, at most 32");

// Copy the first `num_words` words of `src` into shared memory `dst`, every
// thread of the block a share of them; complete at the block's next barrier.
__device__ __forceinline__ void stage_words_block(float4* dst, const float4* src,
                                                  int num_words) {
    for (int k = threadIdx.x; k < num_words; k += BLOCK_RAYS) dst[k] = __ldg(src + k);
}

// The schedule. `body(ray)` runs on every thread of every warp that holds a
// live ray in a window, with the ray's index, or -1 on a thread past the
// window's last live ray (so a body may use warp-wide votes); the body
// stores the ray's result. Shared memory written before the call (the
// staged scene) is complete when the first body runs.
template <bool ANY_HIT, class Body>
__device__ __forceinline__ void live_windows(const Rays& rays, const Body& body) {
    __shared__ int order[2][BLOCK_RAYS];
    __shared__ int counts[2][BLOCK_WARPS];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int buf = 0;
    for (int base = blockIdx.x * BLOCK_RAYS; base < rays.n;
         base += gridDim.x * BLOCK_RAYS, buf ^= 1) {
        const int i = base + threadIdx.x;
        const bool live = i < rays.n && rays.active[i];
        if (i < rays.n && !live)
            store_hit<ANY_HIT>(rays, i, Best{0.0f, 0.0f, 0.0f, 0, 0, false});
        const unsigned votes = __ballot_sync(FULL, live);
        if (live) order[buf][32 * warp + __popc(votes & ((1u << lane) - 1u))] = i;
        if (lane == 0) counts[buf][warp] = __popc(votes);
        __syncthreads();
        // compacted ray j = threadIdx.x: the warp slot it falls in
        int ray = -1, before = 0;
#pragma unroll
        for (int w = 0; w < BLOCK_WARPS; ++w) {
            const int c = counts[buf][w];
            if (ray < 0 && threadIdx.x < before + c) ray = order[buf][32 * w + threadIdx.x - before];
            before += c;
        }
        if (32 * warp < before) body(ray);
    }
}

// blocks per SM of one kernel at one shared-memory size, asked of the
// runtime once per (device, size) and kept
struct BlockOccupancy {
    int device = -1;
    size_t smem = 0;
    int blocks = 0;
};

// Launch `kernel`, the (ANY_HIT, STAGED) kernel of a Scene type from the
// library's own unnamed namespace (so these statics are that kernel's
// alone), over `rays` on `stream`, with `smem` bytes of dynamic shared
// memory and a static grid: at most SMs x resident blocks, and no more
// blocks than windows. Returns cudaGetLastError().
template <bool ANY_HIT, bool STAGED, class Scene>
int launch_block(void (*kernel)(Scene, Rays), const Scene& sc, size_t smem,
                 const Rays& rays, void* stream) {
    // one copy per host thread, as in launch_persistent
    static thread_local int sms[MAX_DEVICES];
    static thread_local bool attr_set[MAX_DEVICES];
    static thread_local BlockOccupancy cache[8];
    static thread_local int next = 0;
    if (rays.n <= 0) return (int)cudaSuccess;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (sms[dev] == 0) {
        err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
    }
    if (!attr_set[dev]) {
        // allow a block the most dynamic shared memory the card offers
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
    int per_sm = 0;
    for (const BlockOccupancy& o : cache)
        if (o.device == dev && o.smem == smem) per_sm = o.blocks;
    if (per_sm == 0) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BLOCK_RAYS, smem);
        if (err != cudaSuccess) return (int)err;
        if (per_sm == 0) return (int)cudaErrorLaunchOutOfResources;
        cache[next] = BlockOccupancy{dev, smem, per_sm};
        next = (next + 1) % 8;
    }
    const int windows = (rays.n + BLOCK_RAYS - 1) / BLOCK_RAYS;
    const int blocks = std::min(sms[dev] * per_sm, windows);
    kernel<<<blocks, BLOCK_RAYS, smem, (cudaStream_t)stream>>>(sc, rays);
    return (int)cudaGetLastError();
}

}  // namespace polaris
