// Counter-PRNG fault injection into a stored-bit plane, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/fault_inject/kernel.py:
//   fault_inject_batched_kernel and, under a burst process,
//   fault_inject_burst_tile_kernel <- fault_inject_batched_pallas (K3): T
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
// keeps the code above. Under burst the unit of element (r, c) is r / m_len
// (row axis), c / (col_div*m_len) (col) or (r / m_len)*0x10001 +
// c / (col_div*m_len) (bank, wrapping); a live unit (its hash below m_thr)
// keeps the threshold, a dead one copies. fault_inject_burst_tile_kernel
// draws for the live elements alone (design below, at the kernel).
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
// The burst pass has the same bound per draw it performs: only its live
// units' elements draw (rate 0.25 on that plane: 1.03 G draws, 0.615 ms of
// ALU issue against the same 0.31 ms of bytes). Its design: shared-memory
// tiles whose live elements every thread of the block draws, at the kernel.
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

// The correlated column group of each element of the chunk at e0, from its
// macro-column unit (e % width) / col_div.
template <int VEC>
__device__ __forceinline__ void chunk_keys(uint32_t (&key)[VEC], uint32_t e0, const Model& md) {
  uint32_t row = e0 / md.width, col = e0 - row * md.width;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    key[k] = col / md.col_div / md.m_len;
    if (++col == md.width) col = 0u;
  }
}

// KIND picks the threshold code at compile time: MODEL_IID (drift too, its
// threshold pre-scaled on the host) is the plain kernel, unchanged;
// MODEL_CORRELATED scales the threshold per element. The column group of
// each element of a chunk is found once a chunk; its hash (keyed by the
// trial seed) once a trial, and only where it differs from the previous
// element's. Burst takes fault_inject_burst_tile_kernel below.
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
    uint32_t key[KIND == MODEL_IID ? 1 : VEC];   // column group
    if constexpr (KIND != MODEL_IID) chunk_keys<VEC>(key, e0, md);
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
          thr = correlated_threshold(h, md.m_thr, threshold);
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

// ---- K3 under a burst process: tiles in shared memory --------------------
//
// A burst unit draws in full or not at all, so only the elements of hit
// units draw. One kernel takes the three axes. A block walks tiles of
// BURST_ROWS x burst_cols<W>() words of the [rows, cols] plane, block b the
// tiles b, b + gridDim.x, ... (the grid is what is resident), so that each
// block meets many units. A tile's words are copied once into shared
// memory (16-byte cp.async copies, neighbouring threads on neighbouring
// addresses, each thread its own chunks) and each trial's copy is stored
// once from them, XORed with a mask tile that the draws fill and the store
// clears again. A band is the tile's rows of one row unit (the whole tile
// on the col axis); the unit indices cost two divisions a tile and one a
// tile column. For each trial t the block
//   (a) lists each band's live columns in order, warp w the bands w,
//       w + 4, ...: a lane hashes its column's unit, 8 column chunks at
//       once, and the ballots place the live ones (on the row axis the
//       band's one hash says all or none, its list is every column);
//   (b) deals the live elements, band by band and row-major in a band, to
//       the threads in turn: thread j draws elements j, j + BURST_NT, ...,
//       each decoded from its band's first element by a multiply (exact at
//       these sizes) and the band's list, 8 at once with the position loop
//       outside their draws; a warp's threads run the same groups (8, then
//       4, 2 and 1) for the most one of them holds, a missing last element
//       drawn for nothing, so no warp diverges on them. Nonzero masks go
//       into the mask tile: an element is one thread's, so no atomics;
//   (c) stores copy t, the words XOR their masks, and clears the masks.
// Two barriers a trial. An element's mask depends on (seed, e, p) alone,
// never on the tile order.
constexpr int BURST_ROWS = 16;    // rows a tile
constexpr int BURST_NT = 128;     // threads a block

template <typename W>
__host__ __device__ constexpr int burst_cols() {   // words a tile row
  return sizeof(W) == 4 ? 128 : 256;
}

// The plane and its process as the burst kernel takes them: unit lengths
// clamped to the plane (m_row = min(m_len, rows), cd = min(col_div * m_len,
// cols): a longer unit holds the whole plane either way), and the tile
// grid, tiles_c tiles a row of tiles.
struct BurstTiles {
  uint32_t rows, cols, m_row, cd, m_thr, tiles_c, n_tiles;
  int axis;
};

template <typename W>
struct __align__(16) BurstSmem {
  static constexpr int TILE = BURST_ROWS * burst_cols<W>();
  W words[TILE];                         // the tile, as read
  W mask[TILE];                          // the trial's flip masks
  uint8_t list[TILE];                    // live columns, a list a band
  uint8_t ucol[burst_cols<W>()];         // column -> its unit in the tile
  uint32_t rs[BURST_ROWS + 1];           // band b: rows rs[b] .. rs[b+1]-1
  uint32_t n[BURST_ROWS], mag[BURST_ROWS];   // its live columns, 2^31 / n
};

// 16 bytes from global to shared memory, not through registers
// (cp.async), and the wait for this thread's copies.
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src));
}
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The band that deal index i falls in, and what decodes i there: its
// first and end deal indices, live columns, first row and list.
struct Band {
  uint32_t b, off, end, mag, n, rs, list;
};

template <typename W>
__device__ __forceinline__ void enter_band(Band& bd, const BurstSmem<W>& sm, uint32_t b,
                                           uint32_t off, bool bank) {
  bd.b = b;
  bd.off = off;
  bd.n = sm.n[b];
  bd.mag = sm.mag[b];
  bd.rs = sm.rs[b];
  bd.end = off + (sm.rs[b + 1] - bd.rs) * bd.n;
  bd.list = bank ? b * burst_cols<W>() : 0u;
}

// U deal indices from i on (i, i + BURST_NT, ...), those below `total`
// live elements: decode, draw with the position loop outside the U draws,
// write the nonzero masks. A slot past `total` draws for nothing.
template <int U, typename W>
__device__ __forceinline__ void draw_live(uint32_t& i, uint32_t total, Band& bd,
                                          BurstSmem<W>& sm, bool bank, uint32_t base,
                                          uint32_t cols, uint32_t lanes, int lo, int hi,
                                          uint32_t threshold, uint32_t seed_mul) {
  constexpr uint32_t TC = burst_cols<W>(), NONE = BurstSmem<W>::TILE;
  uint32_t ctr32[U], at[U], mask[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    at[u] = NONE;
    ctr32[u] = 0u;
    mask[u] = 0u;
    if (i < total) {
      while (i >= bd.end) enter_band(bd, sm, bd.b + 1, bd.end, bank);
      const uint32_t j = i - bd.off;           // j < 2^13, n <= 256: exact
      const uint32_t q = __umulhi(j << 1, bd.mag);
      const uint32_t col = sm.list[bd.list + j - q * bd.n];
      const uint32_t row = bd.rs + q;
      at[u] = row * TC + col;
      ctr32[u] = (base + row * cols + col) * 32u;
    }
    i += BURST_NT;
  }
  for (int p = lo; p <= hi; ++p) {
    if (!((lanes >> p) & 1u)) continue;
    const uint32_t bit = 1u << p;
#pragma unroll
    for (int u = 0; u < U; ++u)   // ctr32 has its low 5 bits clear: | is +
      if (hash_u32((ctr32[u] | (uint32_t)p) ^ seed_mul) < threshold) mask[u] |= bit;
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (mask[u] && at[u] < NONE) sm.mask[at[u]] = static_cast<W>(mask[u]);
}

// Eight blocks an SM at 16-byte chunks (the registers capped to fit them).
template <typename W, int VEC>
__global__ void __launch_bounds__(BURST_NT, VEC > 1 ? 8 : 1)
fault_inject_burst_tile_kernel(const W* __restrict__ bits, W* __restrict__ out,
                               const uint32_t* __restrict__ seeds, int n_trials,
                               uint32_t lanes, uint32_t threshold, BurstTiles bt) {
  constexpr uint32_t TR = BURST_ROWS, TC = burst_cols<W>();
  constexpr uint32_t CPR = TC / VEC, CPT = TR * CPR / BURST_NT;   // chunks a row, a thread
  constexpr unsigned FULL = 0xFFFFFFFFu;
  __shared__ BurstSmem<W> sm;
  const uint32_t tid = threadIdx.x, lane = tid & 31u, warp = tid / 32u;
  const bool row_axis = bt.axis == AXIS_ROW, col_axis = bt.axis == AXIS_COL;
  const bool bank = bt.axis == AXIS_BANK;
  const int lo = __ffs(lanes) - 1, hi = 31 - __clz(lanes);
  const size_t n = (size_t)bt.rows * bt.cols;
  for (uint32_t k = tid; k < TR * TC; k += BURST_NT) sm.mask[k] = 0;
  if (row_axis)
    for (uint32_t c = tid; c < TC; c += BURST_NT) sm.list[c] = (uint8_t)c;
  for (uint32_t tile = blockIdx.x; tile < bt.n_tiles; tile += gridDim.x) {
    const uint32_t tr = tile / bt.tiles_c, tc = tile - tr * bt.tiles_c;
    const uint32_t r0 = tr * TR, c0 = tc * TC;
    const uint32_t trv = min(TR, bt.rows - r0), tcv = min(TC, bt.cols - c0);
    const uint32_t base = r0 * bt.cols + c0;
    // the thread's chunks tid + k * BURST_NT, whole where they lie in the
    // plane (VEC divides cols): into its own slots, read back by itself at
    // the first store (the last store of the tile before has read them)
#pragma unroll
    for (uint32_t k = 0; k < CPT; ++k) {
      const uint32_t ch = tid + k * BURST_NT, row = ch / CPR, col = ch % CPR * VEC;
      if (row < trv && col < tcv) {
        if constexpr (VEC > 1)
          copy16_async(sm.words + ch * VEC, bits + base + row * bt.cols + col);
        else
          sm.words[ch] = bits[base + row * bt.cols + col];
      }
    }
    // bands: the tile's rows of each row unit (one band on the col axis)
    uint32_t ru_lo = 0u, nb = 1u;
    if (!col_axis) {
      ru_lo = r0 / bt.m_row;
      nb = (r0 + trv - 1u) / bt.m_row - ru_lo + 1u;
    }
    if (tid <= nb)
      sm.rs[tid] = tid == 0u ? 0u : tid == nb ? trv : (ru_lo + tid) * bt.m_row - r0;
    // column units: each column's, less the tile's first (none on the row axis)
    const uint32_t cu_lo = row_axis ? 0u : c0 / bt.cd;
    if (!row_axis)
      for (uint32_t c = tid; c < tcv; c += BURST_NT)
        sm.ucol[c] = (uint8_t)((c0 + c) / bt.cd - cu_lo);
    __syncthreads();
    for (int t = 0; t < n_trials; ++t) {
      const uint32_t seed = __ldg(seeds + t);
      const uint32_t seed_mul = seed * GOLD, useed = unit_seed_mul(seed);
      // (a) each band's live columns, in order: warp w the bands w, w + 4, ...
      for (uint32_t b = warp; b < nb; b += BURST_NT / 32u) {
        const uint32_t row_key = col_axis ? 0u : (ru_lo + b) * (bank ? 0x10001u : 1u);
        uint32_t n_live = 0u;
        if (row_axis) {
          n_live = threshold != 0u && hash_u32(row_key ^ useed) < bt.m_thr ? tcv : 0u;
        } else {
          unsigned bal[TC / 32u];
#pragma unroll
          for (uint32_t ch = 0; ch < TC / 32u; ++ch) {
            const uint32_t c = ch * 32u + lane;
            bal[ch] = __ballot_sync(
                FULL, c < tcv && threshold != 0u &&
                          hash_u32((row_key + cu_lo + sm.ucol[c]) ^ useed) < bt.m_thr);
          }
#pragma unroll
          for (uint32_t ch = 0; ch < TC / 32u; ++ch) {
            if ((bal[ch] >> lane) & 1u)
              sm.list[b * TC + n_live + __popc(bal[ch] & ((1u << lane) - 1u))] =
                  (uint8_t)(ch * 32u + lane);
            n_live += __popc(bal[ch]);
          }
        }
        if (lane == 0u) {
          sm.n[b] = n_live;
          sm.mag[b] = 0x7FFFFFFFu / (n_live ? n_live : 1u) + 1u;
        }
      }
      __syncthreads();
      // (b) the live elements, dealt to the threads in turn
      uint32_t total = 0u;
      for (uint32_t b = 0; b < nb; ++b) total += (sm.rs[b + 1] - sm.rs[b]) * sm.n[b];
      // a warp's threads run the groups of its first thread's count (the
      // others hold that or one less): no warp diverges on them
      uint32_t i = tid;
      uint32_t rem = total > tid - lane ? (total - (tid - lane) + BURST_NT - 1u) / BURST_NT : 0u;
      Band bd;
      enter_band(bd, sm, 0u, 0u, bank);
      for (; rem >= 8u; rem -= 8u)
        draw_live<8>(i, total, bd, sm, bank, base, bt.cols, lanes, lo, hi, threshold, seed_mul);
      if (rem & 4u)
        draw_live<4>(i, total, bd, sm, bank, base, bt.cols, lanes, lo, hi, threshold, seed_mul);
      if (rem & 2u)
        draw_live<2>(i, total, bd, sm, bank, base, bt.cols, lanes, lo, hi, threshold, seed_mul);
      if (rem & 1u)
        draw_live<1>(i, total, bd, sm, bank, base, bt.cols, lanes, lo, hi, threshold, seed_mul);
      __syncthreads();
      // (c) copy t: the words XOR their masks, one store each; masks cleared
      if constexpr (VEC > 1)
        if (t == 0) copies_wait();
      W* out_t = out + (size_t)t * n + base;
#pragma unroll
      for (uint32_t k = 0; k < CPT; ++k) {
        const uint32_t ch = tid + k * BURST_NT, row = ch / CPR, col = ch % CPR * VEC;
        if (row < trv && col < tcv) {
          auto* m = reinterpret_cast<Pack<W, VEC>*>(sm.mask + row * TC + col);
          Pack<W, VEC> o = *m;
          const Pack<W, VEC> w = *reinterpret_cast<const Pack<W, VEC>*>(sm.words + ch * VEC);
#pragma unroll
          for (int v = 0; v < VEC; ++v) o.w[v] ^= w.w[v];
          *reinterpret_cast<Pack<W, VEC>*>(out_t + row * bt.cols + col) = o;
          *m = Pack<W, VEC>{};
        }
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
  if (kind == MODEL_CORRELATED)
    launch<W, VEC, MODEL_CORRELATED>(bits, out, seeds, n_trials, n, lanes, threshold, md,
                                     stream);
  else
    launch<W, VEC, MODEL_IID>(bits, out, seeds, n_trials, n, lanes, threshold, md, stream);
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

// The burst kernel over the whole plane, its grid what is resident on the
// card (the occupancy API x the SM count), at most a block a tile.
template <typename W, int VEC>
int launch_burst(const void* bits, void* out, const void* seeds, int n_trials,
                 uint32_t lanes, uint32_t threshold, const BurstTiles& bt,
                 cudaStream_t stream) {
  auto kernel = fault_inject_burst_tile_kernel<W, VEC>;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, BURST_NT, 0);
  if (err != cudaSuccess) return (int)err;
  const uint64_t resident = (uint64_t)(per_sm > 0 ? per_sm : 1) * (uint64_t)sms;
  const int blocks = (int)(bt.n_tiles < resident ? bt.n_tiles : resident);
  kernel<<<blocks, BURST_NT, 0, stream>>>(static_cast<const W*>(bits), static_cast<W*>(out),
                                          static_cast<const uint32_t*>(seeds), n_trials,
                                          lanes, threshold, bt);
  return (int)cudaGetLastError();
}

// 16-byte chunks when both planes are aligned and every row starts on a
// chunk (VEC divides cols), else one word a chunk.
template <typename W>
int dispatch_burst(const void* bits, void* out, const void* seeds, int n_trials,
                   uint32_t rows, uint32_t cols, uint32_t lanes, uint32_t threshold,
                   const Model& md, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(W);
  constexpr uint32_t TC = burst_cols<W>();
  const uint64_t cd = (uint64_t)md.col_div * md.m_len;
  const uint32_t tiles_c = (cols + TC - 1) / TC;
  const BurstTiles bt{rows, cols, md.m_len < rows ? md.m_len : rows,
                      cd < cols ? (uint32_t)cd : cols, md.m_thr, tiles_c,
                      (rows + BURST_ROWS - 1) / BURST_ROWS * tiles_c, md.axis};
  if (aligned16(bits) && aligned16(out) && cols % VEC == 0)
    return launch_burst<W, VEC>(bits, out, seeds, n_trials, lanes, threshold, bt, stream);
  return launch_burst<W, 1>(bits, out, seeds, n_trials, lanes, threshold, bt, stream);
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
  if (model_kind == MODEL_BURST) {
    const uint32_t r = (uint32_t)rows, c = (uint32_t)cols;
    switch (elem_bytes) {
      case 1: return dispatch_burst<uint8_t>(bits, out, seeds, n_trials, r, c, lanes, threshold, md, s);
      case 2: return dispatch_burst<uint16_t>(bits, out, seeds, n_trials, r, c, lanes, threshold, md, s);
      case 4: return dispatch_burst<uint32_t>(bits, out, seeds, n_trials, r, c, lanes, threshold, md, s);
      default: return -1;
    }
  }
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
