// Counter-PRNG hash and flip masks shared by every kernel of the port: the
// cim_read decode-on-read kernels and the fault_inject kernels.
//
// Contract (repro/core/cim.py, repro/kernels/fault_inject/kernel.py): bit p
// of the word at C-order flat store index e flips iff
//     hash_u32((e * 32 + p) ^ seed * 0x9E3779B9) < threshold
// with wrapping uint32 arithmetic throughout.
#pragma once
#include <cstdint>

__device__ __forceinline__ uint32_t hash_u32(uint32_t z) {
  // murmur3 32-bit finalizer
  z ^= z >> 16;
  z *= 0x85EBCA6Bu;
  z ^= z >> 13;
  z *= 0xC2B2AE35u;
  z ^= z >> 16;
  return z;
}

// Flip mask over the lanes set in `lanes` for the word at flat index `elem`;
// `seed_mul` is the plane seed already multiplied by 0x9E3779B9. Only the
// span from the lowest to the highest set lane is walked (a 10-lane
// mantissa draws 10 hashes, not 32); with `lanes` known at compile time the
// span is a constant and the loop unrolls.
__device__ __forceinline__ uint32_t flip_mask(uint32_t elem, uint32_t seed_mul,
                                              uint32_t threshold,
                                              uint32_t lanes) {
  if (threshold == 0u || lanes == 0u) return 0u;
  const uint32_t base = elem * 32u;
  const int lo = __ffs(lanes) - 1, hi = 31 - __clz(lanes);
  uint32_t mask = 0u;
#pragma unroll 4
  for (int p = lo; p <= hi; ++p) {
    if ((lanes >> p) & 1u) {
      if (hash_u32((base + (uint32_t)p) ^ seed_mul) < threshold) mask |= 1u << p;
    }
  }
  return mask;
}

__host__ __device__ constexpr int low_lane(uint32_t v, int p = 0) {
  return ((v >> p) & 1u) ? p : low_lane(v, p + 1);
}

__host__ __device__ constexpr int high_lane(uint32_t v, int p = 31) {
  return ((v >> p) & 1u) ? p : high_lane(v, p - 1);
}

// The same mask for lanes known at compile time (a fp16 mantissa's 0x3FF):
// the span is a constant and the draw loop unrolls completely, so the draws
// of neighbouring words interleave.
template <uint32_t LANES>
__device__ __forceinline__ uint32_t flip_mask(uint32_t elem, uint32_t seed_mul,
                                              uint32_t threshold) {
  static_assert(LANES != 0u, "no lane to draw");
  constexpr int lo = low_lane(LANES), hi = high_lane(LANES);
  if (threshold == 0u) return 0u;
  const uint32_t base = elem * 32u;
  uint32_t mask = 0u;
#pragma unroll
  for (int p = lo; p <= hi; ++p) {
    if ((LANES >> p) & 1u) {
      if (hash_u32((base + (uint32_t)p) ^ seed_mul) < threshold) mask |= 1u << p;
    }
  }
  return mask;
}
