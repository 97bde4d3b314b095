// The gradient of a small parameter table's gather for NVIDIA Hopper (sm_90a):
// grad_table[r, c] = sum over the lanes i with idx[i] = r of grad_rows[i, c].
//
// Replaces no TPU kernel: in the JAX package the gather is jnp code whose
// transpose XLA emits. It stands in for PyTorch's index_add_, the backward of
// torch.index_select, which adds one float atomically a lane and column into
// the table. A material table has two or three rows that every lane of a
// million-lane bounce reads, so those atomics all land on a few addresses and
// serialise in L2: some 0.4 ms a call where the bytes (12 B of gradient and
// 8 B of index a lane) take a few microseconds.
//
// What bounds it: bytes, once nothing contends. So no lane adds into global
// memory. Each block takes a fixed range of LANES_PER_BLOCK lanes, each of
// its warps ROUNDS rounds of 32 of them in turn. In a round, the lanes on one
// row are summed in lane order, from 0.0f, and the round's sum is added to
// that warp's own slab of rows x width floats in shared memory. The block
// sums its warps' slabs in warp order into one partial a table element
// (table_grad_partials), and a second kernel sums the blocks' partials
// (table_grad_reduce): lane l of a warp adds the blocks l, l + 32, ... in
// turn, and the warp's 32 sums meet in a shuffle tree. Every order depends
// on n, rows and width alone, so the result is the same bit for bit from run
// to run; ops/table_grad_cuda.py::table_grad_plain takes the same sums in
// the same order. The reduce writes every element, so nothing is zeroed
// first; neither kernel synchronises with the host or allocates, so both run
// inside a captured CUDA graph.
//
// Plain C interface (no torch headers): the entry point takes raw device
// pointers and a stream and returns a CUDA error code.

#include <cuda_runtime.h>

namespace polaris_table {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROUNDS = 4;  // rounds of 32 lanes a warp takes
constexpr int LANES_PER_WARP = ROUNDS * 32;
constexpr int LANES_PER_BLOCK = WARPS * LANES_PER_WARP;
constexpr int MAX_TABLE = 1024;  // floats of a table: a warp's slab is 4 KB at most
constexpr unsigned FULL = 0xffffffffu;

// one block's partial of every table element, element-major:
// partials[e * gridDim.x + blockIdx.x]
__global__ void __launch_bounds__(THREADS)
    table_grad_partials(const float* __restrict__ grad_rows, const long long* __restrict__ idx,
                        long long n, int rows, int width, float* __restrict__ partials) {
    extern __shared__ float slab[];  // WARPS slabs of rows * width floats
    const int size = rows * width;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    float* mine = slab + warp * size;
    for (int e = lane; e < size; e += 32) mine[e] = 0.0f;
    __syncwarp();
    const long long base =
        static_cast<long long>(blockIdx.x) * LANES_PER_BLOCK + warp * LANES_PER_WARP;
    for (int k = 0; k < ROUNDS; ++k) {
        const long long i = base + k * 32 + lane;
        int row = -1;  // a lane past the end, or on no row of the table
        if (i < n) {
            const long long r = idx[i];
            if (r >= 0 && r < rows) row = static_cast<int>(r);
        }
        const unsigned peers = __match_any_sync(FULL, row);
        const bool leader = row >= 0 && __ffs(peers) - 1 == lane;
        for (int c = 0; c < width; ++c) {
            const float v = i < n ? grad_rows[i * width + c] : 0.0f;
            float acc = 0.0f;
#pragma unroll
            for (int t = 0; t < 32; ++t) {
                const float vt = __shfl_sync(FULL, v, t);
                if ((peers >> t) & 1u) acc = acc + vt;
            }
            if (leader) mine[row * width + c] = mine[row * width + c] + acc;
        }
        __syncwarp();  // the next round's leader of a row may be another lane
    }
    __syncthreads();
    for (int e = threadIdx.x; e < size; e += THREADS) {
        float s = 0.0f;
        for (int w = 0; w < WARPS; ++w) s = s + slab[w * size + e];
        partials[static_cast<long long>(e) * gridDim.x + blockIdx.x] = s;
    }
}

// grad_table[e] = the sum of the blocks' partials of element e; a warp a
// table element
__global__ void __launch_bounds__(THREADS)
    table_grad_reduce(const float* __restrict__ partials, int blocks, int size,
                      float* __restrict__ grad_table) {
    const int e = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (e >= size) return;  // the whole warp: e is the same on its lanes
    const float* p = partials + static_cast<long long>(e) * blocks;
    float s = 0.0f;
    for (int b = lane; b < blocks; b += 32) s = s + p[b];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = s + __shfl_down_sync(FULL, s, off);
    if (lane == 0) grad_table[e] = s;
}

}  // namespace polaris_table

using namespace polaris_table;

// grad_rows [n, width] float32 and idx [n] int64, both contiguous; partials
// holds blocks * rows * width floats, blocks = ceil(n / LANES_PER_BLOCK)
// (a wrapper that counts another layout is refused); grad_table [rows,
// width] is written whole
extern "C" int polaris_table_grad(const float* grad_rows, const long long* idx, long long n,
                                  int rows, int width, int blocks, float* partials,
                                  float* grad_table, void* stream) {
    const long long size = static_cast<long long>(rows) * width;
    if (n < 0 || rows <= 0 || width <= 0 || size > MAX_TABLE ||
        static_cast<long long>(blocks) != (n + LANES_PER_BLOCK - 1) / LANES_PER_BLOCK)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    if (blocks > 0) {
        const size_t shared = sizeof(float) * WARPS * size;
        table_grad_partials<<<blocks, THREADS, shared, s>>>(grad_rows, idx, n, rows, width,
                                                             partials);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const unsigned grid = static_cast<unsigned>((size + WARPS - 1) / WARPS);
    table_grad_reduce<<<grid, THREADS, 0, s>>>(partials, blocks, static_cast<int>(size),
                                               grad_table);
    return static_cast<int>(cudaGetLastError());
}

// registers a thread and local-memory bytes (spills land there) of the two
// kernels, as the loaded binary has them
extern "C" int polaris_table_grad_attributes(int* regs, int* local_bytes) {
    cudaFuncAttributes attr[2];
    cudaError_t err = cudaFuncGetAttributes(&attr[0], table_grad_partials);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr[1], table_grad_reduce);
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int k = 0; k < 2; ++k) {
        regs[k] = attr[k].numRegs;
        local_bytes[k] = static_cast<int>(attr[k].localSizeBytes);
    }
    return 0;
}
