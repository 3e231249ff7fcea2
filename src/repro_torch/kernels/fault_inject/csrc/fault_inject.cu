// Counter-PRNG fault injection into a stored-bit plane, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/fault_inject/kernel.py:
//   fault_inject_batched_kernel <- fault_inject_batched_pallas (K3): T
//       faulted copies [T, R, C] of a uint8 / uint16 / uint32 plane [R, C],
//       one per trial seed, with a runtime threshold and runtime positions;
//   the same kernel at T = 1 <- fault_inject_pallas (K4), whose seed and
//       threshold the TPU kernel bakes in at compile time.
// Bit p of element e = r*C + c flips in trial t iff
//     hash_u32((e*32 + p) ^ seeds[t]*0x9E3779B9) < threshold
// (flip.cuh, the hash the cim_read kernels use), for every p set in `lanes`.
// The stream depends on (seed, e, p) only, never on a block shape. Under a
// burst or correlated fault process the threshold is the element's own
// (flip.cuh's model_threshold: its row e / C, its macro-column unit
// (e % C) / col_div and one hash keyed by the trial seed), as the
// reference's _fault_kernel_batched compiles it; the i.i.d. instantiation
// keeps the code above, and burst takes fault_inject_burst_kernel, which
// draws for its live elements alone.
// At shard offsets (fault_inject_at, K4 on a block of a sharded leaf): the
// plane is a [rows, cols] block of a global plane `width` words wide, its
// element (r, c) drawn at the counter (row_off + r)*width + col_off + c of
// the global counter chunk it lies in, so each block draws exactly the
// flips of its region of the one-device draw. The i.i.d. kernel takes a
// compile-time flag for it; without the flag its code is the one above.
//
// Bound on this card: integer throughput. Each (trial, element, position)
// costs one murmur3 finalizer and its compare: 10 instructions on the ALU
// pipe (xors, shifts, compare, or) and 2 multiplies, which issue as IMADs on
// the FMA pipe alongside. The element moves 2 bytes in once and 2*T bytes
// out: at the Fig. 6 unembed mantissa plane ([2048, 50304] uint16, T = 4,
// 10 positions) that is 4.1 G hashes against 1.03 GB of traffic, ~2.5 ms of
// ALU issue (64 lanes per SM) against ~0.31 ms of HBM time.
// Design against that bound: one thread per 16-byte chunk of the plane
// (8 uint16, 4 uint32 or 16 uint8 elements), loaded once with one 16-byte
// load and kept in registers while the thread loops over the T trials,
// writing each faulted copy with one 16-byte store; the position loop walks
// only the span [lowest, highest] set lane. A plane whose size or pointers
// do not allow 16-byte access takes the same kernel at one element a thread.
// Simple by design: no shared memory, grid-stride over the chunks.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -I ../../csrc
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#include "flip.cuh"

namespace {

constexpr int NT = 256;                      // threads per block
constexpr int MAX_BLOCKS = 132 * 32;         // grid-stride beyond this
constexpr uint32_t GOLD = 0x9E3779B9u;
constexpr uint64_t MAX_COUNTER_ELEMENTS = 1ull << 27;

template <typename W, int VEC>
struct alignas(sizeof(W) * VEC) Pack {
  W w[VEC];
};

// A fault process's payload (faultmodels.model_scalars) and the plane's
// layout: `width` words a row (the plane's C), `col_div` words a
// macro-column unit.
struct Model {
  uint32_t m_thr, m_len, width, col_div;
  int axis;
};

// A block's place in its global plane (fault_inject_at): its first row's
// offset in the counter chunk, its first column, the global row width and
// its own column count.
struct At {
  uint32_t row_off, col_off, width, cols;
};

// The process key of each element of the chunk at e0: its burst unit, or
// its correlated column group, from its row e / width and its macro-column
// unit (e % width) / col_div.
template <int VEC, int KIND>
__device__ __forceinline__ void chunk_keys(uint32_t (&key)[VEC], uint32_t e0, const Model& md) {
  uint32_t row = e0 / md.width, col = e0 - row * md.width;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const uint32_t cu = col / md.col_div;
    key[k] = KIND == MODEL_BURST ? burst_unit(md.axis, row, cu, md.m_len) : cu / md.m_len;
    if (++col == md.width) { col = 0u; ++row; }
  }
}

// KIND picks the threshold code at compile time: MODEL_IID (drift too, its
// threshold pre-scaled on the host) is the plain kernel, unchanged;
// MODEL_BURST and MODEL_CORRELATED scale the threshold per element. The
// unit or column group of each element of a chunk is found once a chunk;
// its hash (keyed by the trial seed) once a trial, and only where it
// differs from the previous element's. Burst takes this kernel on the row
// axis only, where a warp's 32 chunks lie in one row and so in one unit:
// its warps draw in full or not at all.
template <typename W, int VEC, int KIND, bool AT = false>
__global__ void __launch_bounds__(NT)
fault_inject_batched_kernel(const W* __restrict__ bits, W* __restrict__ out,
                            const uint32_t* __restrict__ seeds, int n_trials,
                            uint32_t n, uint32_t lanes, uint32_t threshold,
                            Model md, At at) {
  const uint32_t n_chunks = n / VEC;         // VEC divides n (host checks)
  const int lo = __ffs(lanes) - 1;           // -1 when no lane is set
  const int hi = 31 - __clz(lanes);
  for (uint32_t c = blockIdx.x * NT + threadIdx.x; c < n_chunks;
       c += gridDim.x * NT) {
    const uint32_t e0 = c * VEC;
    const Pack<W, VEC> in = *reinterpret_cast<const Pack<W, VEC>*>(bits + e0);
    uint32_t key[KIND == MODEL_IID ? 1 : VEC];   // burst unit / column group
    if constexpr (KIND != MODEL_IID) chunk_keys<VEC, KIND>(key, e0, md);
    uint32_t ctr[AT ? VEC : 1];   // each element's global counter
    if constexpr (AT) {
      uint32_t r = e0 / at.cols, c = e0 - r * at.cols;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        ctr[k] = (at.row_off + r) * at.width + at.col_off + c;
        if (++c == at.cols) { c = 0u; ++r; }
      }
    }
    for (int t = 0; t < n_trials; ++t) {
      const uint32_t seed = __ldg(seeds + t);
      const uint32_t seed_mul = seed * GOLD;
      uint32_t useed = 0u, h = 0u;
      if constexpr (KIND != MODEL_IID) useed = unit_seed_mul(seed);
      Pack<W, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        uint32_t thr = threshold;
        if constexpr (KIND != MODEL_IID) {
          if (k == 0 || key[k] != key[k - 1]) h = hash_u32(key[k] ^ useed);
          thr = KIND == MODEL_BURST ? (h < md.m_thr ? threshold : 0u)
                                    : correlated_threshold(h, md.m_thr, threshold);
        }
        uint32_t base = (e0 + k) * 32u;
        if constexpr (AT) base = ctr[k] * 32u;
        uint32_t mask = 0u;
        if (thr != 0u) {
          for (int p = lo; p <= hi; ++p) {
            if (((lanes >> p) & 1u) &&
                hash_u32((base + (uint32_t)p) ^ seed_mul) < thr)
              mask |= 1u << p;
          }
        }
        o.w[k] = in.w[k] ^ static_cast<W>(mask);
      }
      *reinterpret_cast<Pack<W, VEC>*>(out + (size_t)t * n + e0) = o;
    }
  }
}

// Position of the r-th (from 0) set bit of v; r < popc(v).
__device__ __forceinline__ int nth_set_bit(uint32_t v, int r) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w; w >>= 1) {
    const int c = __popc(v & ((1u << w) - 1u));   // set bits among the low w
    if (r >= c) {
      r -= c;
      v >>= w;
      pos += w;
    }
  }
  return pos;
}

constexpr int BURST_U = 2;   // live elements a lane draws at once

// Burst on the col and bank axes: a unit draws in full or not at all, and a
// warp's 32 chunks hold both kinds (a column unit of 4 words is half a
// 16-byte uint16 chunk), so per-thread draws would keep the warp busy on
// every element of any live chunk. Here each lane stores its chunk
// unflipped, the warp scans its lanes' live-element counts, and lane t draws
// the warp's live elements t, t + 32, ..., BURST_U of them at once, storing
// each flipped over its copy (after a __syncwarp, which orders the warp's
// stores). A warp draws as often as it has live elements. The chunk loop is
// warp-uniform, so every lane takes part in the shuffles.
template <typename W, int VEC>
__global__ void __launch_bounds__(NT)
fault_inject_burst_kernel(const W* __restrict__ bits, W* __restrict__ out,
                          const uint32_t* __restrict__ seeds, int n_trials,
                          uint32_t n, uint32_t lanes, uint32_t threshold,
                          Model md) {
  constexpr unsigned FULL = 0xFFFFFFFFu;
  const uint32_t n_chunks = n / VEC;
  const int lo = __ffs(lanes) - 1, hi = 31 - __clz(lanes);
  const int lane = threadIdx.x & 31;
  for (uint32_t w0 = blockIdx.x * NT + (threadIdx.x & ~31u); w0 < n_chunks;
       w0 += gridDim.x * NT) {
    const uint32_t c = w0 + lane, e0 = c * VEC;
    const bool valid = c < n_chunks;
    Pack<W, VEC> in{};
    uint32_t key[VEC];
    if (valid) {
      in = *reinterpret_cast<const Pack<W, VEC>*>(bits + e0);
      chunk_keys<VEC, MODEL_BURST>(key, e0, md);
    }
    for (int t = 0; t < n_trials; ++t) {
      const uint32_t seed = __ldg(seeds + t);
      const uint32_t seed_mul = seed * GOLD, useed = unit_seed_mul(seed);
      W* out_t = out + (size_t)t * n;
      uint32_t live = 0u, h = 0u;
      if (valid && threshold != 0u) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          if (k == 0 || key[k] != key[k - 1]) h = hash_u32(key[k] ^ useed);
          live |= (uint32_t)(h < md.m_thr) << k;
        }
      }
      if (valid) *reinterpret_cast<Pack<W, VEC>*>(out_t + e0) = in;
      const int cnt = __popc(live);
      int incl = cnt;   // inclusive scan of the counts over the warp
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += v;
      }
      const int total = __shfl_sync(FULL, incl, 31), excl = incl - cnt;
      __syncwarp();   // every unflipped copy stored before the flipped words
      for (int base = 0; base < total; base += 32 * BURST_U) {
        uint32_t e[BURST_U], mask[BURST_U];
        bool ok[BURST_U];
#pragma unroll
        for (int u = 0; u < BURST_U; ++u) {
          const int i = base + 32 * u + lane;
          int o = 0;   // the lane that owns live element i
#pragma unroll
          for (int step = 16; step; step >>= 1)
            if (__shfl_sync(FULL, incl, o + step - 1) <= i) o += step;
          const uint32_t olive = __shfl_sync(FULL, live, o);
          const uint32_t oe0 = __shfl_sync(FULL, e0, o);
          const int r = i - __shfl_sync(FULL, excl, o);
          ok[u] = i < total;
          e[u] = oe0 + (uint32_t)nth_set_bit(olive, ok[u] ? r : 0);
          mask[u] = 0u;
        }
        for (int p = lo; p <= hi; ++p) {
          if ((lanes >> p) & 1u) {
#pragma unroll
            for (int u = 0; u < BURST_U; ++u)
              mask[u] |= (uint32_t)(hash_u32((e[u] * 32u + (uint32_t)p) ^ seed_mul) <
                                    threshold) << p;
          }
        }
#pragma unroll
        for (int u = 0; u < BURST_U; ++u)
          if (ok[u] && mask[u]) out_t[e[u]] = bits[e[u]] ^ static_cast<W>(mask[u]);
      }
    }
  }
}

template <typename W, int VEC, int KIND>
void launch(const void* bits, void* out, const void* seeds, int n_trials,
            uint32_t n, uint32_t lanes, uint32_t threshold, const Model& md,
            cudaStream_t stream) {
  const uint32_t n_chunks = n / VEC;
  const int blocks = (int)((n_chunks + NT - 1) / NT < MAX_BLOCKS
                               ? (n_chunks + NT - 1) / NT : MAX_BLOCKS);
  // burst: the row axis keeps per-thread draws while a warp's chunks lie in
  // one row; other axes (and narrower rows) draw for their live elements
  if (KIND == MODEL_BURST && !(md.axis == AXIS_ROW && md.width >= 32u * VEC))
    fault_inject_burst_kernel<W, VEC><<<blocks, NT, 0, stream>>>(
        static_cast<const W*>(bits), static_cast<W*>(out),
        static_cast<const uint32_t*>(seeds), n_trials, n, lanes, threshold, md);
  else
    fault_inject_batched_kernel<W, VEC, KIND><<<blocks, NT, 0, stream>>>(
        static_cast<const W*>(bits), static_cast<W*>(out),
        static_cast<const uint32_t*>(seeds), n_trials, n, lanes, threshold, md,
        At{});
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename W, int VEC>
void launch_kind(int kind, const void* bits, void* out, const void* seeds,
                 int n_trials, uint32_t n, uint32_t lanes, uint32_t threshold,
                 const Model& md, cudaStream_t stream) {
  switch (kind) {
    case MODEL_BURST:
      launch<W, VEC, MODEL_BURST>(bits, out, seeds, n_trials, n, lanes, threshold, md, stream);
      break;
    case MODEL_CORRELATED:
      launch<W, VEC, MODEL_CORRELATED>(bits, out, seeds, n_trials, n, lanes, threshold, md,
                                       stream);
      break;
    default:
      launch<W, VEC, MODEL_IID>(bits, out, seeds, n_trials, n, lanes, threshold, md, stream);
  }
}

template <typename W>
void dispatch(int kind, const void* bits, void* out, const void* seeds, int n_trials,
              uint32_t n, uint32_t lanes, uint32_t threshold, const Model& md,
              cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(W);
  if (aligned16(bits) && aligned16(out) && n % VEC == 0)
    launch_kind<W, VEC>(kind, bits, out, seeds, n_trials, n, lanes, threshold, md, stream);
  else
    launch_kind<W, 1>(kind, bits, out, seeds, n_trials, n, lanes, threshold, md, stream);
}

template <typename W, int VEC>
void launch_at(const void* bits, void* out, const void* seeds, int n_trials,
               uint32_t n, uint32_t lanes, uint32_t threshold, const At& at,
               cudaStream_t stream) {
  const uint32_t n_chunks = n / VEC;
  const int blocks = (int)((n_chunks + NT - 1) / NT < MAX_BLOCKS
                               ? (n_chunks + NT - 1) / NT : MAX_BLOCKS);
  fault_inject_batched_kernel<W, VEC, MODEL_IID, true><<<blocks, NT, 0, stream>>>(
      static_cast<const W*>(bits), static_cast<W*>(out),
      static_cast<const uint32_t*>(seeds), n_trials, n, lanes, threshold,
      Model{0u, 0u, at.width, 1u, AXIS_ROW}, at);
}

}  // namespace

// C interface (ctypes). `bits` is the [rows, cols] plane of `elem_bytes`-wide
// words, `out` the [n_trials, rows, cols] result, `seeds` uint32 [n_trials]
// on the device. `m_thr`, `m_len`, `model_kind` (0 i.i.d. or drift, 1
// burst, 2 correlated), `model_axis` (0 row, 1 col, 2 bank) and `col_div`
// are the fault-process slots of the reference's batched kernel; the i.i.d.
// kind takes zero parameters. Returns 0 on success, a cudaError_t after a
// refused launch, or -1 for arguments the kernel does not take.
extern "C" int fault_inject_batched(const void* bits, void* out,
                                    const void* seeds, int n_trials, int rows,
                                    int cols, int elem_bytes, unsigned int lanes,
                                    unsigned int threshold, unsigned int m_thr,
                                    unsigned int m_len, int model_kind,
                                    int model_axis, int col_div, void* stream) {
  const uint64_t n = (uint64_t)rows * (uint64_t)cols;
  const int width = 8 * elem_bytes;
  const bool iid = model_kind == MODEL_IID;
  if (n_trials < 1 || rows < 1 || cols < 1 || n > MAX_COUNTER_ELEMENTS ||
      (width < 32 && (lanes >> width) != 0u) || model_kind < MODEL_IID ||
      model_kind > MODEL_CORRELATED || model_axis < AXIS_ROW ||
      model_axis > AXIS_BANK || col_div < 1 ||
      (iid ? (m_thr != 0u || m_len != 0u) : m_len < 1u))
    return -1;
  const Model md{m_thr, m_len, (uint32_t)cols, (uint32_t)col_div, model_axis};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: dispatch<uint8_t>(model_kind, bits, out, seeds, n_trials, (uint32_t)n, lanes, threshold, md, s); break;
    case 2: dispatch<uint16_t>(model_kind, bits, out, seeds, n_trials, (uint32_t)n, lanes, threshold, md, s); break;
    case 4: dispatch<uint32_t>(model_kind, bits, out, seeds, n_trials, (uint32_t)n, lanes, threshold, md, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// The i.i.d. draw of a block at shard offsets: `bits` is the [rows, cols]
// block (uint16 words), drawn as the region at row `row_off` of a global
// counter chunk `width` words wide, from column `col_off`. The whole region
// must lie in one counter chunk: (row_off + rows - 1) * width + col_off +
// cols <= 2^27. Returns as fault_inject_batched.
extern "C" int fault_inject_at(const void* bits, void* out, const void* seeds,
                               int n_trials, int rows, int cols,
                               unsigned int lanes, unsigned int threshold,
                               int row_off, int col_off, int width,
                               void* stream) {
  const uint64_t n = (uint64_t)rows * (uint64_t)cols;
  if (n_trials < 1 || rows < 1 || cols < 1 || row_off < 0 || col_off < 0 ||
      width < 1 || (uint64_t)col_off + (uint64_t)cols > (uint64_t)width ||
      ((uint64_t)row_off + (uint64_t)rows - 1u) * (uint64_t)width +
              (uint64_t)col_off + (uint64_t)cols > MAX_COUNTER_ELEMENTS ||
      (lanes >> 16) != 0u)
    return -1;
  const At at{(uint32_t)row_off, (uint32_t)col_off, (uint32_t)width,
              (uint32_t)cols};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  constexpr int VEC = 8;   // 16 bytes of uint16
  if (aligned16(bits) && aligned16(out) && n % VEC == 0)
    launch_at<uint16_t, VEC>(bits, out, seeds, n_trials, (uint32_t)n, lanes, threshold, at, s);
  else
    launch_at<uint16_t, 1>(bits, out, seeds, n_trials, (uint32_t)n, lanes, threshold, at, s);
  return (int)cudaGetLastError();
}
