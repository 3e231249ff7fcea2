// Fused decode-on-read matmul over the packed CIM image, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/cim_read/kernel.py:
//   cim_read_one4n_kernel <- cim_read_matmul_one4n (protect='one4n'):
//       x @ W with W decoded per tile from the uint16 mantissa plane and the
//       word-packed One4N SECDED codewords [K/n, J/rw, S, W];
//   cim_read_raw_kernel   <- cim_read_matmul_raw (protect='none'):
//       the same over a raw uint8 shared-exponent plane [K/n, J] and K-packed
//       uint32 sign words [ceil(K/32), J].
// With `dynamic` set, each kernel first XORs counter-PRNG flip masks into
// the words it loaded (flip.cuh), at GLOBAL store element indices, so a
// dynamic read equals a static read of the image `inject_with_seeds` leaves.
//
// Bound on this card: bytes. The serving call has M = batch (a few rows), so
// the work is a matrix-vector product: every packed word is read once and
// used for M multiply-adds. For the full-width olmo-1b unembed (K = 2048,
// J = 50304) K1 reads 206.0 MB of mantissas + 25.8 MB of codewords, K2
// 206.0 + 12.9 + 12.9 MB: about 232 MB a call, ~69 us at 3.35 TB/s.
// Design against that bound: the decoded fp32 matrix never exists in device
// memory — each block streams its [64 x 64] mantissa tile (16-byte loads)
// and the codeword / exponent / sign words covering it into registers and
// shared memory, decodes there, and feeds the rebuilt tile straight into
// f32 FMAs. The grid covers (J/64 column tiles) x (M/16 row tiles), so the
// 786 column tiles of the unembed keep every SM busy with resident blocks.
// Simple by design (no TMA, no wgmma, no multi-stage pipeline yet).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: the rebuild must be exact).
#include <cstdint>
#include <cuda_runtime.h>

#include "flip.cuh"

namespace {

constexpr int BM = 16;    // output rows per block
constexpr int BN = 64;    // output columns per block: whole row_weights groups
constexpr int BK = 64;    // K rows per chunk: whole exponent blocks, sign words
constexpr int NT = 256;   // threads per block
constexpr int ROW_GROUPS = NT / BN;          // 4
constexpr int ROWS_PER_THREAD = BM / ROW_GROUPS;
constexpr int MAX_CW_WORDS = 512;            // codeword words of one chunk
constexpr int MAX_PAYLOAD_BITS = 512;
constexpr int MAX_W = 4;                     // words per codeword (n <= 112)
constexpr int MAX_R = 8;                     // Hamming syndrome bits
constexpr uint32_t GOLD = 0x9E3779B9u;

enum { THR_MAN = 0, THR_META, SEED_MAN, SEED_META, SEED_CW, OFF_K, OFF_J,
       M_THR, M_LEN, N_SCALARS };

struct Scalars { uint32_t v[N_SCALARS]; };

struct One4NGeo {
  int n_group, rw, S, W, seg_bits, n_body, r, payload_bits;
  uint32_t body_mask[MAX_W];   // stored body bits of each codeword word
  uint32_t code_mask[MAX_W];   // body + overall parity bit
};

struct Fmt { int man_bits, exp_bits, bias; };

// IEEE-faithful fp16-grid rebuild (subnormals, inf, NaN), the scale built in
// the float32 exponent field rather than with exp2f.
__device__ __forceinline__ float reconstruct(uint32_t sign, uint32_t e,
                                             uint32_t m, Fmt f) {
  const float man_f = (float)(m & ((1u << f.man_bits) - 1u));
  const float frac = man_f * __int_as_float((127 - f.man_bits) << 23);
  const uint32_t emax = (1u << f.exp_bits) - 1u;
  float mag;
  if (e == 0u) {
    mag = frac * __int_as_float((1 - f.bias + 127) << 23);
  } else if (e == emax) {
    mag = man_f == 0.0f ? __int_as_float(0x7F800000) : __int_as_float(0x7FC00000);
  } else {
    mag = (1.0f + frac) * __int_as_float(((int)e - f.bias + 127) << 23);
  }
  return (sign & 1u) ? -mag : mag;
}

// x tile [BM][BK], zero outside [M, K_log).
__device__ __forceinline__ void load_x(float (*x_s)[BK], const float* __restrict__ x,
                                       int m0, int k0, int M, int K_log) {
  for (int i = threadIdx.x; i < BM * BK; i += NT) {
    const int m = i / BK, kk = i % BK, gm = m0 + m, gk = k0 + kk;
    x_s[m][kk] = (gm < M && gk < K_log) ? x[(size_t)gm * K_log + gk] : 0.0f;
  }
}

// This thread's 16 mantissas of the chunk (row kk = tid / 4, columns
// 16 * (tid % 4) ..), two 16-byte loads, with dynamic flips applied.
__device__ __forceinline__ void load_man(uint32_t mv[16], const uint16_t* __restrict__ man,
                                         int k0, int c0, int k_pad, int j_pad,
                                         int dynamic, uint32_t thr, uint32_t seed_mul,
                                         uint32_t off_k, uint32_t off_j,
                                         uint32_t store_j, uint32_t lanes) {
  const int kk = threadIdx.x >> 2, cs = (threadIdx.x & 3) * 16;
  const int gk = k0 + kk, gc = c0 + cs;
  if (gk < k_pad && gc < j_pad) {
    const uint4* p = reinterpret_cast<const uint4*>(man + (size_t)gk * j_pad + gc);
    const uint4 a = p[0], b = p[1];
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      mv[2 * q] = w[q] & 0xFFFFu;
      mv[2 * q + 1] = w[q] >> 16;
    }
    if (dynamic && thr) {
      const uint32_t row = ((uint32_t)gk + off_k) * store_j;
#pragma unroll
      for (int q = 0; q < 16; ++q)
        mv[q] ^= flip_mask(row + (uint32_t)(gc + q) + off_j, seed_mul, thr, lanes);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 16; ++q) mv[q] = 0u;
  }
}

// acc[i] += x_s[rg + ROW_GROUPS * i][:] . w_s[:][oc]
__device__ __forceinline__ void accumulate(float acc[ROWS_PER_THREAD],
                                           float (*x_s)[BK], float (*w_s)[BN]) {
  const int oc = threadIdx.x % BN, rg = threadIdx.x / BN;
#pragma unroll 8
  for (int kk = 0; kk < BK; ++kk) {
    const float wv = w_s[kk][oc];
#pragma unroll
    for (int i = 0; i < ROWS_PER_THREAD; ++i)
      acc[i] = fmaf(x_s[rg + ROW_GROUPS * i][kk], wv, acc[i]);
  }
}

__device__ __forceinline__ void store_out(float* __restrict__ out,
                                          const float acc[ROWS_PER_THREAD],
                                          int m0, int c0, int M, int n_out) {
  const int oc = threadIdx.x % BN, rg = threadIdx.x / BN, c = c0 + oc;
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int m = m0 + rg + ROW_GROUPS * i;
    if (m < M && c < n_out) out[(size_t)m * n_out + c] = acc[i];
  }
}

__global__ void __launch_bounds__(NT) cim_read_one4n_kernel(
    const float* __restrict__ x, const uint16_t* __restrict__ man,
    const uint32_t* __restrict__ cw, float* __restrict__ out, int M, int K_log,
    int k_pad, int j_pad, int n_out, One4NGeo geo, Fmt fmt, Scalars sc,
    int dynamic, uint32_t store_g, uint32_t store_j) {
  __shared__ float x_s[BM][BK];
  __shared__ float w_s[BK][BN];
  __shared__ uint32_t cw_s[MAX_CW_WORDS];
  __shared__ uint8_t e_s[BK][BN];
  __shared__ uint16_t ptab[MAX_PAYLOAD_BITS];
  __shared__ uint32_t hmask[MAX_R][MAX_W];

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n = geo.n_group, rw = geo.rw, W = geo.W, SW = geo.S * geo.W;
  const int gpt = BN / rw, bpc = BK / n;
  const int n_codewords = bpc * gpt * geo.S;
  const int g_local = j_pad / rw;

  // payload bit p -> word/lane of its data bit inside the block row's
  // codeword set: segment p / seg_bits, data bit q = p % seg_bits sits at
  // the q-th non-power-of-two (1-based) Hamming position
  for (int p = tid; p < geo.payload_bits; p += NT) {
    int pos = p % geo.seg_bits + 1;
    for (int j = 0; j < geo.r; ++j)
      if (pos >= (1 << j)) ++pos;
    ptab[p] = (uint16_t)((p / geo.seg_bits) * W * 32 + pos - 1);
  }
  // syndrome column masks: bit i of the body is in syndrome j iff bit j of
  // its 1-based position i + 1 is set
  if (tid < MAX_R * MAX_W) {
    const int j = tid / MAX_W, w = tid % MAX_W;
    uint32_t m = 0u;
    if (j < geo.r && w < W)
      for (int l = 0; l < 32; ++l) {
        const int i = 32 * w + l;
        if (i < geo.n_body && (((i + 1) >> j) & 1)) m |= 1u << l;
      }
    hmask[j][w] = m;
  }

  const uint32_t thr_man = sc.v[THR_MAN], thr_meta = sc.v[THR_META];
  const uint32_t seed_man = sc.v[SEED_MAN] * GOLD, seed_cw = sc.v[SEED_CW] * GOLD;
  const uint32_t off_k = sc.v[OFF_K], off_j = sc.v[OFF_J];
  const uint32_t man_lanes = (1u << fmt.man_bits) - 1u;
  const int kk_t = tid >> 2, cs_t = (tid & 3) * 16;
  float acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0.0f;
  uint32_t mv[16];

  for (int k0 = 0; k0 < k_pad; k0 += BK) {
    __syncthreads();  // tables ready; previous chunk's tiles consumed
    load_x(x_s, x, m0, k0, M, K_log);
    load_man(mv, man, k0, c0, k_pad, j_pad, dynamic, thr_man, seed_man, off_k,
             off_j, store_j, man_lanes);
    const int b0 = k0 / n;
    const int nb = min(bpc, (k_pad - k0) / n);
    const int ng = min(gpt, (j_pad - c0) / rw);
    for (int i = tid; i < n_codewords * W; i += NT) {
      const int sw = i % SW, gl = (i / SW) % gpt, bl = i / (SW * gpt);
      uint32_t v = 0u;
      if (bl < nb && gl < ng) {
        const uint32_t gb = (uint32_t)(b0 + bl), gg = (uint32_t)(c0 / rw + gl);
        v = cw[((size_t)gb * g_local + gg) * SW + sw];
        if (dynamic) {
          const uint32_t celem = ((gb + off_k / (uint32_t)n) * store_g + gg
                                  + off_j / (uint32_t)rw) * (uint32_t)SW + (uint32_t)sw;
          v ^= flip_mask(celem, seed_cw, thr_meta, geo.code_mask[sw % W]);
        }
      }
      cw_s[i] = v;
    }
    __syncthreads();
    // SECDED syndrome folds + single-error correction, one thread per
    // codeword: syndrome bit j is the parity of the body bits in column mask
    // j; the overall parity R[7] is the parity of every stored bit (body and
    // the overall check bit)
    for (int i = tid; i < n_codewords; i += NT) {
      uint32_t* c = cw_s + i * W;
      uint32_t syn = 0u, par = 0u;
      for (int w = 0; w < W; ++w) {
        const uint32_t word = c[w];
        const uint32_t body = word & geo.body_mask[w];
        par ^= word & geo.code_mask[w];
        for (int j = 0; j < geo.r; ++j)
          syn ^= (uint32_t)(__popc(body & hmask[j][w]) & 1) << j;
      }
      if ((__popc(par) & 1) && syn > 0u && (int)(syn - 1u) < geo.n_body)
        c[(syn - 1u) >> 5] ^= 1u << ((syn - 1u) & 31u);
    }
    __syncthreads();
    // shared exponent of each (block row, column): rw exponent fields lead
    // the payload, exp_bits each
    for (int i = tid; i < bpc * BN; i += NT) {
      const int bl = i / BN, cc = i % BN, t = cc % rw;
      const uint32_t* c = cw_s + (bl * gpt + cc / rw) * SW;
      uint32_t e = 0u;
      for (int q = 0; q < fmt.exp_bits; ++q) {
        const int pt = ptab[t * fmt.exp_bits + q];
        e |= ((c[pt >> 5] >> (pt & 31)) & 1u) << q;
      }
      e_s[bl][cc] = (uint8_t)e;
    }
    __syncthreads();
    {
      const int gk = k0 + kk_t, bl = kk_t / n, i_n = kk_t % n;
      const int sign_base = rw * fmt.exp_bits + i_n * rw;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int cc = cs_t + q;
        float wv = 0.0f;
        if (gk < k_pad && c0 + cc < j_pad) {
          const uint32_t* c = cw_s + (bl * gpt + cc / rw) * SW;
          const int pt = ptab[sign_base + cc % rw];
          wv = reconstruct((c[pt >> 5] >> (pt & 31)) & 1u, e_s[bl][cc], mv[q], fmt);
        }
        w_s[kk_t][cc] = wv;
      }
    }
    __syncthreads();
    accumulate(acc, x_s, w_s);
  }
  store_out(out, acc, m0, c0, M, n_out);
}

__global__ void __launch_bounds__(NT) cim_read_raw_kernel(
    const float* __restrict__ x, const uint16_t* __restrict__ man,
    const uint8_t* __restrict__ expw, const uint32_t* __restrict__ signw,
    float* __restrict__ out, int M, int K_log, int k_pad, int j_pad, int n_out,
    int sw_rows, int n_group, Fmt fmt, Scalars sc, int dynamic,
    uint32_t store_k, uint32_t store_j) {
  __shared__ float x_s[BM][BK];
  __shared__ float w_s[BK][BN];
  __shared__ uint8_t e_s[BK][BN];
  __shared__ uint32_t s_s[BK / 32][BN];

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n = n_group, bpc = BK / n;
  const uint32_t thr_man = sc.v[THR_MAN], thr_meta = sc.v[THR_META];
  const uint32_t seed_man = sc.v[SEED_MAN] * GOLD, seed_meta = sc.v[SEED_META] * GOLD;
  const uint32_t seed_sign = sc.v[SEED_CW] * GOLD;
  const uint32_t off_k = sc.v[OFF_K], off_j = sc.v[OFF_J];
  const uint32_t man_lanes = (1u << fmt.man_bits) - 1u;
  const uint32_t exp_lanes = (1u << fmt.exp_bits) - 1u;
  const int kk_t = tid >> 2, cs_t = (tid & 3) * 16;
  float acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0.0f;
  uint32_t mv[16];

  for (int k0 = 0; k0 < k_pad; k0 += BK) {
    __syncthreads();
    load_x(x_s, x, m0, k0, M, K_log);
    load_man(mv, man, k0, c0, k_pad, j_pad, dynamic, thr_man, seed_man, off_k,
             off_j, store_j, man_lanes);
    const int b0 = k0 / n, nb = min(bpc, (k_pad - k0) / n);
    for (int i = tid; i < bpc * BN; i += NT) {
      const int bl = i / BN, gc = c0 + i % BN;
      uint32_t e = 0u;
      if (bl < nb && gc < j_pad) {
        const uint32_t gb = (uint32_t)(b0 + bl);
        e = expw[(size_t)gb * j_pad + gc];
        if (dynamic)
          e ^= flip_mask((gb + off_k / (uint32_t)n) * store_j + (uint32_t)gc + off_j,
                         seed_meta, thr_meta, exp_lanes);
      }
      e_s[bl][i % BN] = (uint8_t)e;
    }
    const int w0 = k0 / 32;
    for (int i = tid; i < (BK / 32) * BN; i += NT) {
      const int wl = i / BN, gw = w0 + wl, gc = c0 + i % BN;
      uint32_t v = 0u;
      if (gw < sw_rows && gc < j_pad) {
        v = signw[(size_t)gw * j_pad + gc];
        if (dynamic) {
          // lanes at or past the store's K rows are not cells
          const uint32_t grow = (uint32_t)gw + off_k / 32u;
          const uint64_t first = (uint64_t)grow * 32u;
          const uint64_t valid = first >= store_k ? 0u : store_k - first;
          const uint32_t lanes = (uint32_t)((1ull << (valid < 32u ? valid : 32u)) - 1ull);
          v ^= flip_mask(grow * store_j + (uint32_t)gc + off_j, seed_sign, thr_meta,
                         lanes);
        }
      }
      s_s[wl][i % BN] = v;
    }
    __syncthreads();
    {
      const int gk = k0 + kk_t, bl = kk_t / n;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int cc = cs_t + q;
        float wv = 0.0f;
        if (gk < k_pad && c0 + cc < j_pad)
          wv = reconstruct((s_s[kk_t >> 5][cc] >> (kk_t & 31)) & 1u, e_s[bl][cc],
                           mv[q], fmt);
        w_s[kk_t][cc] = wv;
      }
    }
    __syncthreads();
    accumulate(acc, x_s, w_s);
  }
  store_out(out, acc, m0, c0, M, n_out);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

Scalars read_scalars(const uint32_t* s) {
  Scalars sc;
  for (int i = 0; i < N_SCALARS; ++i) sc.v[i] = s[i];
  return sc;
}

}  // namespace

// C interface (ctypes). Returns 0 on success, a cudaError_t after a refused
// launch, or -1 when the arguments fall outside what the kernels tile.
extern "C" int cim_read_one4n(const void* x, const void* man, const void* cw,
                              void* out, int M, int K_log, int k_pad, int j_pad,
                              int n_out, int n_group, int rw, int S, int W,
                              int seg_bits, int n_body, int r, int payload_bits,
                              int man_bits, int exp_bits, int bias,
                              unsigned int store_g, unsigned int store_j,
                              const unsigned int* masks,
                              const unsigned int* scalars, int dynamic,
                              void* stream) {
  if (M <= 0 || k_pad <= 0 || j_pad <= 0 || BK % n_group != 0 || BN % rw != 0 ||
      j_pad % 16 != 0 || k_pad % n_group != 0 || W > MAX_W || r > MAX_R ||
      payload_bits > MAX_PAYLOAD_BITS || (BK / n_group) * (BN / rw) * S * W > MAX_CW_WORDS ||
      !aligned16(man) || K_log > k_pad || n_out > j_pad)
    return -1;
  One4NGeo geo{n_group, rw, S, W, seg_bits, n_body, r, payload_bits, {}, {}};
  for (int w = 0; w < MAX_W; ++w) {
    geo.body_mask[w] = w < W ? masks[w] : 0u;
    geo.code_mask[w] = w < W ? masks[MAX_W + w] : 0u;
  }
  const Fmt fmt{man_bits, exp_bits, bias};
  const dim3 grid((j_pad + BN - 1) / BN, (M + BM - 1) / BM);
  cim_read_one4n_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint16_t*>(man),
      static_cast<const uint32_t*>(cw), static_cast<float*>(out), M, K_log, k_pad,
      j_pad, n_out, geo, fmt, read_scalars(scalars), dynamic, store_g, store_j);
  return (int)cudaGetLastError();
}

extern "C" int cim_read_raw(const void* x, const void* man, const void* expw,
                            const void* signw, void* out, int M, int K_log,
                            int k_pad, int j_pad, int n_out, int sw_rows,
                            int n_group, int man_bits, int exp_bits, int bias,
                            unsigned int store_k, unsigned int store_j,
                            const unsigned int* scalars, int dynamic,
                            void* stream) {
  if (M <= 0 || k_pad <= 0 || j_pad <= 0 || BK % n_group != 0 || j_pad % 16 != 0 ||
      k_pad % n_group != 0 || sw_rows != (k_pad + 31) / 32 || !aligned16(man) ||
      K_log > k_pad || n_out > j_pad)
    return -1;
  const Fmt fmt{man_bits, exp_bits, bias};
  const dim3 grid((j_pad + BN - 1) / BN, (M + BM - 1) / BM);
  cim_read_raw_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint16_t*>(man),
      static_cast<const uint8_t*>(expw), static_cast<const uint32_t*>(signw),
      static_cast<float*>(out), M, K_log, k_pad, j_pad, n_out, sw_rows, n_group, fmt,
      read_scalars(scalars), dynamic, store_k, store_j);
  return (int)cudaGetLastError();
}
