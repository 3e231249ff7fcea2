// Counter-PRNG fault injection into a stored-bit plane, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/fault_inject/kernel.py:
//   fault_inject_batched_kernel <- fault_inject_batched_pallas (K3): T
//       faulted copies [T, R, C] of a uint8 / uint16 / uint32 plane [R, C],
//       one per trial seed, with a runtime threshold and runtime positions;
//   fault_inject_runs_kernel <- fault_inject_pallas (K4), whose seed and
//       threshold the TPU kernel bakes in at compile time: one seed over a
//       uint16 plane, or over the fp16 bit patterns of a float32 plane (the
//       round trip to fp16 and back fused into the draw), drawn as a table
//       of runs of rows of a larger counter plane (below).
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
// K4 over a run table (fault_inject_runs): the plane [rows, cols] is a leaf
// or a block of a leaf whose counter plane is `width` words wide and cut
// into counter chunks of at most 2^27 elements, each drawn from its own
// seed. Run j = (r0, k, row_off) holds rows r0 .. (the next run's r0) - 1,
// which lie at consecutive rows of chunk k from its row row_off: element
// (r, c) draws at the counter (row_off + r - r0)*width + col_off + c from
// the chunk's seed hash_u32(seed ^ (k*0x85EBCA6B + 0x9E3779B9))
// (cim.fold_seed; the seed itself when the table is not folded), exactly
// the flips of its region of the one-device draw of the whole leaf.
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
// K4 has the same bound per draw (a 4x1 block [40 x 1024, 12800] of
// granite-3-8b's w_gate at 10 mantissa positions: 5.243 G draws, 3.13 ms of
// ALU issue); a float32 plane moves 8 bytes an element (1.25 ms at that
// block), which stays below it. Its design against that bound: one launch
// for the whole leaf or block, its grid what is resident on the card (the
// occupancy API x the SM count), each thread grid-striding over 8-element
// chunks (one 16-byte load of uint16, two of float32), the position loop
// outside the 8 elements' draws, so that its control is paid once for 8
// hashes; the run table staged in shared memory (a binary search a chunk,
// a step at each run boundary inside it), or read from global memory when
// it does not fit. The float32 instantiation narrows each value to its fp16
// bit pattern with __float2half_rn (the conversion torch's own cast uses on
// the card), flips it, widens it back with integer code (NaN payloads
// shifted up 13 bits with the quiet bit set, as the reference's widening)
// and writes every element, in place when the source is the destination.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -I ../../csrc
#include <cstddef>
#include <cstdint>
#include <cuda_fp16.h>
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
template <typename W, int VEC, int KIND>
__global__ void __launch_bounds__(NT)
fault_inject_batched_kernel(const W* __restrict__ bits, W* __restrict__ out,
                            const uint32_t* __restrict__ seeds, int n_trials,
                            uint32_t n, uint32_t lanes, uint32_t threshold,
                            Model md) {
  const uint32_t n_chunks = n / VEC;         // VEC divides n (host checks)
  const int lo = __ffs(lanes) - 1;           // -1 when no lane is set
  const int hi = 31 - __clz(lanes);
  for (uint32_t c = blockIdx.x * NT + threadIdx.x; c < n_chunks;
       c += gridDim.x * NT) {
    const uint32_t e0 = c * VEC;
    const Pack<W, VEC> in = *reinterpret_cast<const Pack<W, VEC>*>(bits + e0);
    uint32_t key[KIND == MODEL_IID ? 1 : VEC];   // burst unit / column group
    if constexpr (KIND != MODEL_IID) chunk_keys<VEC, KIND>(key, e0, md);
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
        const uint32_t base = (e0 + k) * 32u;
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
        static_cast<const uint32_t*>(seeds), n_trials, n, lanes, threshold, md);
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

// ---- K4: one seed over a leaf or a block, from a table of runs ----------

constexpr int RUNS_VEC = 8;        // elements a chunk: 16 bytes of uint16
constexpr int MAX_STAGED_RUNS = 4096;   // 48 KB of staged runs a block

// A run as the kernel uses it: its first row, the counter of its element
// (0, 0) less r0 * width (wrapping: the counters themselves stay below
// 2^27), and its chunk seed times 0x9E3779B9.
struct Run {
  uint32_t r0, base, seed_mul;
};

__device__ __forceinline__ Run make_run(const int* __restrict__ table, int j,
                                        uint32_t width, uint32_t col_off,
                                        uint32_t seed, bool fold) {
  const uint32_t r0 = (uint32_t)__ldg(table + 3 * j);
  const uint32_t k = (uint32_t)__ldg(table + 3 * j + 1);
  const uint32_t row_off = (uint32_t)__ldg(table + 3 * j + 2);
  const uint32_t s = fold ? hash_u32(seed ^ (k * 0x85EBCA6Bu + GOLD)) : seed;
  return Run{r0, (row_off - r0) * width + col_off, s * GOLD};
}

// The table's runs, staged in shared memory when they fit, else read (and
// their seeds folded) from global memory at each lookup.
struct Runs {
  const int* table;
  const Run* staged;   // the shared copy, set by the kernel when `stage`
  int n;
  uint32_t rows, width, col_off, seed;
  bool fold, stage;

  __device__ __forceinline__ uint32_t r0(int j) const {
    if (j >= n) return rows;
    return staged ? staged[j].r0 : (uint32_t)__ldg(table + 3 * j);
  }
  __device__ __forceinline__ Run at(int j) const {
    return staged ? staged[j] : make_run(table, j, width, col_off, seed, fold);
  }
  // the run that holds row r: the last j with r0(j) <= r (r0(0) = 0)
  __device__ __forceinline__ int find(uint32_t r) const {
    int lo = 0, hi = n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (r0(mid) <= r) lo = mid; else hi = mid - 1;
    }
    return lo;
  }
};

// fp16 bit pattern -> float32 bits, as bitops.fp16_bits_to_f32: a normal
// number re-biased; e = 31 gives inf, or a NaN with its payload shifted up
// and the quiet bit set; e = 0 gives m * 2^-24, exact in float32.
__device__ __forceinline__ uint32_t widen_fp16(uint32_t b) {
  const uint32_t sign = (b & 0x8000u) << 16, e = (b >> 10) & 0x1Fu, m = b & 0x3FFu;
  if (e == 0u) return sign | __float_as_uint((float)m * 5.9604644775390625e-8f);
  if (e == 31u) return sign | 0x7F800000u | (m ? 0x400000u | (m << 13) : 0u);
  return sign | ((e + 112u) << 23) | (m << 13);
}

template <typename In>
__device__ __forceinline__ uint32_t to_fp16_bits(In v) {
  if constexpr (sizeof(In) == 2) return v;
  else return __half_as_ushort(__float2half_rn(v));
}

template <typename In>
__device__ __forceinline__ In from_fp16_bits(uint32_t b) {
  if constexpr (sizeof(In) == 2) return (In)b;
  else return __uint_as_float(widen_fp16(b));
}

// K4 over a run table: src and dst are [rows, cols] planes of In (uint16
// bit patterns, or float32 values on the fp16 grid), possibly the same
// pointer (in place: each element is read and then written by one
// thread, so neither is __restrict__). Each thread grid-strides over
// chunks of VEC elements; a chunk finds its run once, and steps to the next
// run where a row boundary inside it starts one (ragged widths).
template <typename In, int VEC>
__global__ void __launch_bounds__(NT)
fault_inject_runs_kernel(const In* src, In* dst, uint32_t n, uint32_t cols,
                         uint32_t lanes, uint32_t threshold, Runs runs) {
  extern __shared__ Run staged[];
  if (runs.stage) {   // stage the table: every run's seed folded once a block
    for (int j = threadIdx.x; j < runs.n; j += NT)
      staged[j] = make_run(runs.table, j, runs.width, runs.col_off, runs.seed, runs.fold);
    __syncthreads();
    runs.staged = staged;
  }
  constexpr int PER = 16 / (int)sizeof(In);   // elements a 16-byte access
  const uint32_t n_chunks = n / VEC;          // VEC divides n (host checks)
  const int lo = __ffs(lanes) - 1, hi = 31 - __clz(lanes);
  // a 64-bit chunk index: at one element a chunk, n nears 2^32
  for (uint64_t ch = blockIdx.x * NT + threadIdx.x; ch < n_chunks;
       ch += (uint64_t)gridDim.x * NT) {
    const uint32_t e0 = (uint32_t)ch * VEC;
    In v[VEC];
    if constexpr (VEC == 1) {
      v[0] = src[e0];
    } else {
#pragma unroll
      for (int l = 0; l < VEC / PER; ++l) {
        const Pack<In, PER> p = *reinterpret_cast<const Pack<In, PER>*>(src + e0 + l * PER);
#pragma unroll
        for (int i = 0; i < PER; ++i) v[l * PER + i] = p.w[i];
      }
    }
    // each element's counter (times 32) and chunk seed
    uint32_t r = e0 / cols, c = e0 - r * cols;
    int j = runs.find(r);
    Run run = runs.at(j);
    uint32_t next = runs.r0(j + 1);
    uint32_t ctr32[VEC], smul[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      ctr32[k] = (run.base + r * runs.width + c) * 32u;
      smul[k] = run.seed_mul;
      if (++c == cols) {
        c = 0u;
        if (++r == next && k + 1 < VEC) {
          run = runs.at(++j);
          next = runs.r0(j + 1);
        }
      }
    }
    uint32_t mask[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) mask[k] = 0u;
    if (threshold != 0u) {
      for (int p = lo; p <= hi; ++p) {
        if (!((lanes >> p) & 1u)) continue;
        const uint32_t bit = 1u << p;
#pragma unroll
        for (int k = 0; k < VEC; ++k)   // ctr32 has its low 5 bits clear: | is +
          if (hash_u32((ctr32[k] | (uint32_t)p) ^ smul[k]) < threshold) mask[k] |= bit;
      }
    }
    In o[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[k] = from_fp16_bits<In>(to_fp16_bits(v[k]) ^ mask[k]);
    if constexpr (VEC == 1) {
      dst[e0] = o[0];
    } else {
#pragma unroll
      for (int l = 0; l < VEC / PER; ++l) {
        Pack<In, PER> p;
#pragma unroll
        for (int i = 0; i < PER; ++i) p.w[i] = o[l * PER + i];
        *reinterpret_cast<Pack<In, PER>*>(dst + e0 + l * PER) = p;
      }
    }
  }
}

// One launch over the whole plane, its grid what is resident on the card.
template <typename In, int VEC>
int launch_runs(const void* src, void* dst, uint32_t n, uint32_t cols, uint32_t lanes,
                uint32_t threshold, Runs runs, cudaStream_t stream) {
  auto kernel = fault_inject_runs_kernel<In, VEC>;
  const size_t smem = runs.stage ? (size_t)runs.n * sizeof(Run) : 0u;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
  if (err != cudaSuccess) return (int)err;
  const uint64_t need = ((uint64_t)(n / VEC) + NT - 1) / NT;
  const uint64_t resident = (uint64_t)(per_sm > 0 ? per_sm : 1) * (uint64_t)sms;
  const int blocks = (int)(need < resident ? (need ? need : 1) : resident);
  kernel<<<blocks, NT, smem, stream>>>(static_cast<const In*>(src), static_cast<In*>(dst), n,
                                       cols, lanes, threshold, runs);
  return (int)cudaGetLastError();
}

template <typename In>
int dispatch_runs(const void* src, void* dst, uint32_t n, uint32_t cols, uint32_t lanes,
                  uint32_t threshold, const Runs& runs, cudaStream_t stream) {
  if (aligned16(src) && aligned16(dst) && n % RUNS_VEC == 0)
    return launch_runs<In, RUNS_VEC>(src, dst, n, cols, lanes, threshold, runs, stream);
  return launch_runs<In, 1>(src, dst, n, cols, lanes, threshold, runs, stream);
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

// K4 over a run table. `src` and `dst` are [rows, cols] planes (the same
// pointer for in place) of `elem_bytes`-wide words: 2 for uint16 bit
// patterns, 4 for float32 values (each narrowed to fp16, flipped and
// widened back). `runs` is int32 [n_runs, 3] on the device, rows
// (r0, chunk k, row_off) with r0 = 0 first and strictly increasing below
// rows; `fold` != 0 draws run j from hash_u32(seed ^ (k*0x85EBCA6B +
// 0x9E3779B9)), 0 from `seed`. The host checks that every run's counters
// stay in its chunk ((row_off + its rows - 1)*width + col_off + cols <=
// 2^27). Returns 0, a cudaError_t, or -1 for arguments the kernel does not
// take.
extern "C" int fault_inject_runs(const void* src, void* dst, int elem_bytes, int rows,
                                 int cols, int col_off, int width, unsigned int lanes,
                                 unsigned int threshold, unsigned int seed, int fold,
                                 const void* runs, int n_runs, void* stream) {
  const uint64_t n = (uint64_t)rows * (uint64_t)cols;
  if (rows < 1 || cols < 1 || n >= (1ull << 32) || col_off < 0 || width < 1 ||
      (uint64_t)col_off + (uint64_t)cols > (uint64_t)width || (lanes >> 16) != 0u ||
      n_runs < 1 || n_runs > rows || runs == nullptr)
    return -1;
  const Runs r{static_cast<const int*>(runs), nullptr, n_runs, (uint32_t)rows,
               (uint32_t)width, (uint32_t)col_off, seed, fold != 0,
               n_runs <= MAX_STAGED_RUNS};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 2: return dispatch_runs<uint16_t>(src, dst, (uint32_t)n, (uint32_t)cols, lanes, threshold, r, s);
    case 4: return dispatch_runs<float>(src, dst, (uint32_t)n, (uint32_t)cols, lanes, threshold, r, s);
    default: return -1;
  }
}
