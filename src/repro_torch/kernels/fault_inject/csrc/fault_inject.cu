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
// The stream depends on (seed, e, p) only, never on a block shape.
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

template <typename W, int VEC>
__global__ void __launch_bounds__(NT)
fault_inject_batched_kernel(const W* __restrict__ bits, W* __restrict__ out,
                            const uint32_t* __restrict__ seeds, int n_trials,
                            uint32_t n, uint32_t lanes, uint32_t threshold) {
  const uint32_t n_chunks = n / VEC;         // VEC divides n (host checks)
  const int lo = __ffs(lanes) - 1;           // -1 when no lane is set
  const int hi = 31 - __clz(lanes);
  for (uint32_t c = blockIdx.x * NT + threadIdx.x; c < n_chunks;
       c += gridDim.x * NT) {
    const uint32_t e0 = c * VEC;
    const Pack<W, VEC> in = *reinterpret_cast<const Pack<W, VEC>*>(bits + e0);
    for (int t = 0; t < n_trials; ++t) {
      const uint32_t seed_mul = __ldg(seeds + t) * GOLD;
      Pack<W, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const uint32_t base = (e0 + k) * 32u;
        uint32_t mask = 0u;
        if (threshold != 0u) {
          for (int p = lo; p <= hi; ++p) {
            if (((lanes >> p) & 1u) &&
                hash_u32((base + (uint32_t)p) ^ seed_mul) < threshold)
              mask |= 1u << p;
          }
        }
        o.w[k] = in.w[k] ^ static_cast<W>(mask);
      }
      *reinterpret_cast<Pack<W, VEC>*>(out + (size_t)t * n + e0) = o;
    }
  }
}

template <typename W, int VEC>
void launch(const void* bits, void* out, const void* seeds, int n_trials,
            uint32_t n, uint32_t lanes, uint32_t threshold,
            cudaStream_t stream) {
  const uint32_t n_chunks = n / VEC;
  const int blocks = (int)((n_chunks + NT - 1) / NT < MAX_BLOCKS
                               ? (n_chunks + NT - 1) / NT : MAX_BLOCKS);
  fault_inject_batched_kernel<W, VEC><<<blocks, NT, 0, stream>>>(
      static_cast<const W*>(bits), static_cast<W*>(out),
      static_cast<const uint32_t*>(seeds), n_trials, n, lanes, threshold);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename W>
void dispatch(const void* bits, void* out, const void* seeds, int n_trials,
              uint32_t n, uint32_t lanes, uint32_t threshold,
              cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(W);
  if (aligned16(bits) && aligned16(out) && n % VEC == 0)
    launch<W, VEC>(bits, out, seeds, n_trials, n, lanes, threshold, stream);
  else
    launch<W, 1>(bits, out, seeds, n_trials, n, lanes, threshold, stream);
}

}  // namespace

// C interface (ctypes). `bits` is the [rows, cols] plane of `elem_bytes`-wide
// words, `out` the [n_trials, rows, cols] result, `seeds` uint32 [n_trials]
// on the device. `m_thr`, `m_len`, `model_kind` and `col_div` are the fault
// process slots of the reference's batched kernel; only the i.i.d. process
// (kind 0, zero parameters) is ported. Returns 0 on success, a cudaError_t
// after a refused launch, or -1 for arguments the kernel does not take.
extern "C" int fault_inject_batched(const void* bits, void* out,
                                    const void* seeds, int n_trials, int rows,
                                    int cols, int elem_bytes, unsigned int lanes,
                                    unsigned int threshold, unsigned int m_thr,
                                    unsigned int m_len, int model_kind,
                                    int col_div, void* stream) {
  const uint64_t n = (uint64_t)rows * (uint64_t)cols;
  const int width = 8 * elem_bytes;
  if (n_trials < 1 || rows < 1 || cols < 1 || n > MAX_COUNTER_ELEMENTS ||
      (width < 32 && (lanes >> width) != 0u) || model_kind != 0 ||
      m_thr != 0u || m_len != 0u || col_div < 1)
    return -1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1: dispatch<uint8_t>(bits, out, seeds, n_trials, (uint32_t)n, lanes, threshold, s); break;
    case 2: dispatch<uint16_t>(bits, out, seeds, n_trials, (uint32_t)n, lanes, threshold, s); break;
    case 4: dispatch<uint32_t>(bits, out, seeds, n_trials, (uint32_t)n, lanes, threshold, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
