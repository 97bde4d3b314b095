// The counter-based RNG of the shading kernel: ops/rng.py's make_uniform in
// 32-bit integer arithmetic, bit for bit.
//
// A draw is uniform(seed, key, sample, bounce * 64 + stream): the prefix
// (seed, key, sample) folded once a lane, then one more fold and the
// finalizer, and the top 24 bits as a float in [0, 1). The key is the pixel,
// or for the Russian-roulette stream of tile-coherent roulette the lane's
// 32x32 block (rng.rr_block_key). Every counter is a Python int passed by
// value, or a tensor read through its pointer: one value (a 0-d tensor, as
// the seed and sample index a captured graph reads) or one per lane
// (regeneration, batch_samples and compact), int32 or int64, taken mod 2**32
// as rng._as_u32 takes it.

#pragma once

#include <cstdint>

namespace polaris_shade {

constexpr uint32_t RNG_C1 = 0x85EBCA6Bu;
constexpr uint32_t RNG_C2 = 0xC2B2AE35u;
constexpr uint32_t RNG_GOLDEN = 0x9E3779B9u;

// ops/rng.py's stream ids
constexpr int STREAM_BXDF_U = 2;
constexpr int STREAM_BXDF_V = 3;
constexpr int STREAM_LIGHT_SELECT = 4;
constexpr int STREAM_LIGHT_U = 5;
constexpr int STREAM_LIGHT_V = 6;
constexpr int STREAM_RR = 7;
constexpr int STREAM_MAT_MIX = 8;
constexpr int STREAM_DISPERSE = 24;

// one counter: `ptr` null takes `imm`; else ptr[per_lane ? lane : 0], an
// int64 where is64, an int32 (or a bool, where is64 is 2) otherwise
struct Counter {
    long long ptr, per_lane, is64, imm;
};

__device__ __forceinline__ uint32_t read_counter(const Counter& c, int64_t lane) {
    if (c.ptr == 0) return static_cast<uint32_t>(c.imm);
    const int64_t j = c.per_lane ? lane : 0;
    if (c.is64 == 1) return static_cast<uint32_t>(reinterpret_cast<const long long*>(c.ptr)[j]);
    if (c.is64 == 2) return reinterpret_cast<const uint8_t*>(c.ptr)[j];
    return static_cast<uint32_t>(reinterpret_cast<const int*>(c.ptr)[j]);
}

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
    x ^= x >> 16;
    x *= RNG_C1;
    x ^= x >> 13;
    x *= RNG_C2;
    x ^= x >> 16;
    return x;
}

// rng._fold of one more counter into a running key
__device__ __forceinline__ uint32_t fold(uint32_t acc, uint32_t p) {
    return hash_u32((acc + RNG_GOLDEN) ^ p);
}

__device__ __forceinline__ float unit_float(uint32_t bits) {
    return static_cast<float>(bits >> 8) * (1.0f / 16777216.0f);
}

// one lane's draws: make_uniform's closure
struct Draws {
    uint32_t prefix;     // fold(seed, pixel, sample)
    uint32_t rr_prefix;  // fold(seed, rr key, sample), or prefix
    uint32_t bounce64;   // bounce * 64

    __device__ __forceinline__ float operator()(int stream) const {
        const uint32_t p = stream == STREAM_RR ? rr_prefix : prefix;
        return unit_float(hash_u32(fold(p, bounce64 + static_cast<uint32_t>(stream))));
    }
};

}  // namespace polaris_shade
