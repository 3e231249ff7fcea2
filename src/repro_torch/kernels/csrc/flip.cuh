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

// Fault processes (repro/core/faultmodels.py): burst and correlated scale a
// plane's threshold per element, from the element's row and macro-column
// unit in the plane's C-order layout (row = e / width, col = (e % width) /
// col_div) and one hash of that unit or column group, keyed by the plane's
// unit seed. Drift scales the threshold on the host and runs the i.i.d.
// code. Both scaled thresholds stay at or below the i.i.d. one, so a
// process flips a subset of the i.i.d. flips at the same seed.
enum ModelKind { MODEL_IID = 0, MODEL_BURST = 1, MODEL_CORRELATED = 2 };
enum ModelAxis { AXIS_ROW = 0, AXIS_COL = 1, AXIS_BANK = 2 };

// unit_seed(plane_seed) * 0x9E3779B9: the plane seed folded by
// MODEL_SEED_SALT (0x0DD5EED5), so unit decisions never alias the flip
// stream of the same seed.
__device__ __forceinline__ uint32_t unit_seed_mul(uint32_t plane_seed) {
  constexpr uint32_t SALT = 0x0DD5EED5u * 0x85EBCA6Bu + 0x9E3779B9u;
  return hash_u32(plane_seed ^ SALT) * 0x9E3779B9u;
}

// The burst unit of (row, col): aligned runs of m_len rows, of m_len
// columns, or m_len x m_len tiles mixed into one index.
__device__ __forceinline__ uint32_t burst_unit(int axis, uint32_t row, uint32_t col,
                                               uint32_t m_len) {
  return axis == AXIS_ROW ? row / m_len
       : axis == AXIS_COL ? col / m_len
                          : (row / m_len) * 0x10001u + col / m_len;
}

// The correlated threshold of a column group whose hash is h:
// thr * s / 65536 with s = 65536 - m_thr * (h >> 16) / 65536, as a split
// multiply that keeps every product below 2^32.
__device__ __forceinline__ uint32_t correlated_threshold(uint32_t h, uint32_t m_thr,
                                                        uint32_t thr) {
  const uint32_t s = 65536u - ((m_thr * (h >> 16)) >> 16);
  return (thr >> 16) * s + (((thr & 0xFFFFu) * s) >> 16);
}

// The threshold of one element at (row, col) for a process of `kind`;
// `useed` is unit_seed_mul of the plane seed, `col` already divided by the
// plane's col_div.
__device__ __forceinline__ uint32_t model_threshold(int kind, int axis, uint32_t row,
                                                    uint32_t col, uint32_t useed,
                                                    uint32_t m_thr, uint32_t m_len,
                                                    uint32_t thr) {
  if (kind == MODEL_BURST)
    return hash_u32(burst_unit(axis, row, col, m_len) ^ useed) < m_thr ? thr : 0u;
  if (kind == MODEL_CORRELATED)
    return correlated_threshold(hash_u32((col / m_len) ^ useed), m_thr, thr);
  return thr;
}
