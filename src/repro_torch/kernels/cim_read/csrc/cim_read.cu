// Fused decode-on-read matmul over the packed CIM image, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of repro/kernels/cim_read/kernel.py:
//   cim_read_one4n_narrow_kernel, for M <= 8, and cim_read_one4n_kernel, for
//   M > 8 <- cim_read_matmul_one4n (protect='one4n', kernel.py:381):
//       x @ W with W decoded per tile from the uint16 mantissa plane and the
//       word-packed One4N SECDED codewords [K/n, J/rw, S, W];
//   cim_read_raw_narrow_kernel, for M <= 8, and cim_read_raw_kernel, for
//   M > 8 <- cim_read_matmul_raw (protect='none', kernel.py:428):
//       the same over a raw uint8 shared-exponent plane [K/n, J] and K-packed
//       uint32 sign words [ceil(K/32), J].
// With `dynamic` set, each kernel first XORs counter-PRNG flip masks into
// the words it loaded (flip.cuh), at GLOBAL store element indices, so a
// dynamic read equals a static read of the image `inject_with_seeds` leaves.
// The host picks the kernel by M alone (ops.resolve_tiles).
//
// The narrow kernel: the read the serving path launches (M = batch, a few
// rows). No tensor cores: at M <= 8 a weight feeds at most 8 multiply-adds,
// so the read is bound by bytes (static) or by integer hashes (dynamic),
// never by FLOPs, and the port keeps fp32 FMAs (no TF32) for parity.
//  * Static read, bound by bytes. The full-width olmo-1b unembed (K = 2048,
//    J = 50304) is 206.0 MB of mantissas + 25.8 MB of codewords: ~69 us at
//    3.35 TB/s. A block owns a strip of 128 columns (whole row_weights
//    groups) and walks K through a ring of 4 shared stages of 128 rows,
//    filled with 16-byte cp.async.cg copies (neighbouring threads on
//    neighbouring addresses), so three stages' loads are in flight while one
//    is decoded. Each weight is decoded once, in registers, and multiplied
//    straight into all M rows of x: no zero-padded rows, no decoded tile in
//    shared memory. x for the K range a block walks sits in shared memory
//    (a slab at a time where K does not fit), read as broadcast vectors.
//  * Decode work spread over all 256 threads: a thread corrects one
//    codeword a stage (the unembed stage holds 256), with the syndrome masks
//    from the host in the parameter bank, and ORs its data bits into the
//    stage's payload strings; then a thread rebuilds 8 rows x 8 columns of
//    weights from one 16-byte mantissa load a row, one payload byte of signs
//    a row and one exponent window a block row. The fp16-grid rebuild is
//    the bit pattern sign | e << 23 | m << 13 scaled by 2^112 (exact for
//    normals and subnormals; e = 31 becomes the all-ones field: inf or NaN).
//  * Dynamic read, bound by the ALU pipe: 10 mantissa lanes a weight and
//    112 code lanes a codeword are ~1.21 G murmur3 draws on the unembed,
//    ~0.72 ms at 10 ALU-pipe ops a draw. Every thread draws (its weights'
//    mantissa lanes and its codeword's lanes); flip_mask walks only the
//    set-lane span, and with the mantissa's lanes fixed at compile time its
//    draws unroll, so the draws of a row's 8 weights interleave.
//  * 393 strips of the unembed fill 132 SMs in three waves (one block an
//    SM: 161-217 KB of shared memory for M = 1..8). Each output is a fixed-order sum: a
//    thread's rows in K order, then the 16 row groups in order through
//    shared memory. No atomics on floats: a call's bits repeat, and a
//    dynamic read equals the read of the statically injected image.
//
// K2's narrow kernel is the same design over the unprotected image, with a
// simpler decode: the exponent is a raw byte per (block row, column), the
// sign a bit of a K-packed word.
//  * Static read, bound by bytes: 206.0 MB of mantissas + 12.9 MB of
//    exponents + 12.9 MB of sign words on the unembed, ~69 us at 3.35 TB/s.
//    Each ring stage holds 128 rows of mantissas (32 KB), their 128/n
//    exponent rows (2 KB at n = 8) and their four 32-row sign-word rows
//    (2 KB), all copied with 16-byte cp.async. A thread's 8 rows lie in one
//    sign word: it reads its 8 columns' sign words once a stage and its 8
//    exponent bytes once a block row, and rebuilds each weight as K1 does.
//  * Dynamic read, bound by the ALU pipe: 1.030 G mantissa draws and
//    0.167 G exponent and sign draws on the unembed, ~0.72 ms at 10 ops a
//    draw. An exponent byte serves n rows and a sign word 32, so the
//    landed stage's meta words are flipped in place in shared memory, each
//    drawn by exactly one thread, before one barrier; the mantissas are
//    flipped in registers. Every draw has its lanes fixed at compile time
//    (0x3FF, 0x1F, all 32 then AND the valid lanes), so all of them unroll.
//
// Fault processes (flip.cuh, repro/core/faultmodels.py): a dynamic read
// under burst or correlated scales each word's threshold, from its row and
// macro-column unit in its own plane (mantissas and K2's exponent bytes and
// sign words: row and column of the 2-D plane; codewords: block row and
// row_weights group) and one hash of that unit, keyed by the plane seed.
// The narrow kernels take the kind as a template parameter, so the i.i.d.
// instantiations keep their code: a thread finds its 8 columns' correlated
// thresholds or burst units once a kernel and its rows' burst hits once a
// row unit, a codeword thread one threshold a codeword, K2's meta flips one
// a word. A burst thread draws only in hit units, but its warp runs the
// draws of any hit lane. The tile kernels branch on the kind at run time.
// Drift comes pre-scaled in the thresholds and runs the i.i.d. code.
//
// The tile kernels (M > 8): a fixed 16 x 64 x 64 tile, 256
// threads, each block streaming its [64 x 64] mantissa tile and the
// codeword / exponent / sign words covering it into registers and shared
// memory, decoding there, and feeding the rebuilt tile into f32 FMAs; simple
// by design (no cp.async pipeline).
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

// The fault process of a dynamic read (flip.cuh): kind and axis from the
// launch, parameters from the scalars. The tile kernels branch on `kind` at
// run time (a uniform branch); the narrow kernels take it as a template
// parameter, so their i.i.d. instantiations keep their code.
struct ReadModel {
  int kind, axis;
  uint32_t m_thr, m_len;
  __device__ __forceinline__ uint32_t thr(uint32_t row, uint32_t col, uint32_t useed,
                                          uint32_t thr_) const {
    return model_threshold(kind, axis, row, col, useed, m_thr, m_len, thr_);
  }
};

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
                                         uint32_t store_j, uint32_t lanes,
                                         const ReadModel& md, uint32_t useed) {
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
      const uint32_t grow = (uint32_t)gk + off_k, row = grow * store_j;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const uint32_t gcol = (uint32_t)(gc + q) + off_j;
        mv[q] ^= flip_mask(row + gcol, seed_mul, md.thr(grow, gcol, useed, thr), lanes);
      }
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
    int dynamic, uint32_t store_g, uint32_t store_j, ReadModel md) {
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
  const uint32_t useed_man = md.kind ? unit_seed_mul(sc.v[SEED_MAN]) : 0u;
  const uint32_t useed_cw = md.kind ? unit_seed_mul(sc.v[SEED_CW]) : 0u;
  const int kk_t = tid >> 2, cs_t = (tid & 3) * 16;
  float acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0.0f;
  uint32_t mv[16];

  for (int k0 = 0; k0 < k_pad; k0 += BK) {
    __syncthreads();  // tables ready; previous chunk's tiles consumed
    load_x(x_s, x, m0, k0, M, K_log);
    load_man(mv, man, k0, c0, k_pad, j_pad, dynamic, thr_man, seed_man, off_k,
             off_j, store_j, man_lanes, md, useed_man);
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
          // codeword plane: row = block row, column unit = row_weights group
          const uint32_t crow = gb + off_k / (uint32_t)n, cgrp = gg + off_j / (uint32_t)rw;
          const uint32_t celem = (crow * store_g + cgrp) * (uint32_t)SW + (uint32_t)sw;
          v ^= flip_mask(celem, seed_cw, md.thr(crow, cgrp, useed_cw, thr_meta),
                         geo.code_mask[sw % W]);
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
    uint32_t store_k, uint32_t store_j, ReadModel md) {
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
  const uint32_t useed_man = md.kind ? unit_seed_mul(sc.v[SEED_MAN]) : 0u;
  const uint32_t useed_meta = md.kind ? unit_seed_mul(sc.v[SEED_META]) : 0u;
  const uint32_t useed_sign = md.kind ? unit_seed_mul(sc.v[SEED_CW]) : 0u;
  const int kk_t = tid >> 2, cs_t = (tid & 3) * 16;
  float acc[ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) acc[i] = 0.0f;
  uint32_t mv[16];

  for (int k0 = 0; k0 < k_pad; k0 += BK) {
    __syncthreads();
    load_x(x_s, x, m0, k0, M, K_log);
    load_man(mv, man, k0, c0, k_pad, j_pad, dynamic, thr_man, seed_man, off_k,
             off_j, store_j, man_lanes, md, useed_man);
    const int b0 = k0 / n, nb = min(bpc, (k_pad - k0) / n);
    for (int i = tid; i < bpc * BN; i += NT) {
      const int bl = i / BN, gc = c0 + i % BN;
      uint32_t e = 0u;
      if (bl < nb && gc < j_pad) {
        const uint32_t gb = (uint32_t)(b0 + bl);
        e = expw[(size_t)gb * j_pad + gc];
        if (dynamic) {
          const uint32_t erow = gb + off_k / (uint32_t)n, ecol = (uint32_t)gc + off_j;
          e ^= flip_mask(erow * store_j + ecol, seed_meta,
                         md.thr(erow, ecol, useed_meta, thr_meta), exp_lanes);
        }
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
          const uint32_t scol = (uint32_t)gc + off_j;
          v ^= flip_mask(grow * store_j + scol, seed_sign,
                         md.thr(grow, scol, useed_sign, thr_meta), lanes);
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

// ---------------------------------------------------------------------------
// The narrow kernel (M <= 8): see the note at the top.
// ---------------------------------------------------------------------------

constexpr int NR_NT = 256;                   // threads a block
constexpr int NR_BN = 128;                   // columns a strip
constexpr int NR_CK = 128;                   // K rows a stage
constexpr int NR_STAGES = 4;                 // ring depth
constexpr int NR_COLS = 8;                   // columns a thread: one 16-byte word
constexpr int NR_ROWS = 8;                   // rows a thread, each stage
constexpr int NR_TPR = NR_BN / NR_COLS;      // 16 threads a row
constexpr int NR_GROUPS = NR_NT / NR_TPR;    // 16 row groups
constexpr int NR_MAN_HALVES = NR_CK * NR_BN; // uint16 mantissas a stage
constexpr int NR_MAX_R = 7;                  // Hamming bits of a <= 104-bit segment
constexpr int NR_PAY_PAD = 2;                // words past a payload (exponent window)
constexpr int SMEM_LIMIT = 232448;           // 227 KB a block on the H100

static_assert(NR_GROUPS * NR_ROWS == NR_CK, "row groups cover a stage");
static_assert(NR_GROUPS * 8 * NR_BN * 4 <= NR_STAGES * NR_MAN_HALVES * 2,
              "the final reduction fits in the mantissa ring");

struct NarrowGeo {
  int n_group, log2n, rw, S, W, seg_bits, n_body, r;
  int gb;         // row_weights groups a strip
  int cb;         // block rows a stage
  int cw_stage;   // codeword words a stage, padded to 16 bytes
  int pw;         // payload words of one (block row, group), padded
  int pay_buf;    // words of one payload buffer, padded to 16 bytes
  int x_slab;     // rows of x held in shared memory at once
  int cw_vec;     // codeword stages copy in 16-byte pieces
  uint32_t body_mask[MAX_W], code_mask[MAX_W], hmask[NR_MAX_R][MAX_W];
};

int up16w(int words) { return (words + 3) & ~3; }

// Dynamic shared memory of the narrow kernel, in bytes; ops.resolve_tiles
// computes the same number.
int narrow_smem_bytes(int cw_stage, int pay_buf, int x_slab, int mp) {
  return NR_STAGES * (NR_MAN_HALVES * 2 + cw_stage * 4) + 2 * pay_buf * 4 +
         x_slab * mp * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A stage's 128 x 128 mantissas into `ms`, 16-byte copies, neighbouring
// threads on neighbouring addresses; rows and columns past the plane are
// zero-filled.
__device__ __forceinline__ void narrow_copy_man(uint16_t* ms, const uint16_t* __restrict__ man,
                                                int k0, int c0, int k_pad, int j_pad) {
#pragma unroll
  for (int q = 0; q < NR_MAN_HALVES / 8 / NR_NT; ++q) {
    const int idx = threadIdx.x + q * NR_NT, row = idx / NR_TPR, piece = idx % NR_TPR;
    const int gk = k0 + row, gc = c0 + piece * 8;
    const bool ok = gk < k_pad && gc < j_pad;
    cp_async16(ms + row * NR_BN + piece * 8, ok ? man + (size_t)gk * j_pad + gc : man, ok);
  }
}

// Rows [k0, k0 + x_slab) of x into shared memory as [row][MP] vectors, zero
// past M and K_log.
template <int MP>
__device__ __forceinline__ void narrow_load_x(float* x_s, const float* __restrict__ x,
                                              int k0, int x_slab, int M, int K_log) {
  for (int k = threadIdx.x; k < x_slab; k += NR_NT) {
    const int gk = k0 + k;
    float v[MP];
#pragma unroll
    for (int m = 0; m < MP; ++m)
      v[m] = (m < M && gk < K_log) ? x[(size_t)m * K_log + gk] : 0.0f;
#pragma unroll
    for (int m = 0; m < MP; ++m) x_s[k * MP + m] = v[m];
  }
}

// The 16 row groups' partial sums meet in the (drained) mantissa ring and
// are added in a fixed order; row group rg, column group cl holds acc.
template <int MP>
__device__ __forceinline__ void narrow_reduce_store(unsigned char* smem,
                                                    const float (&acc)[MP][NR_COLS],
                                                    float* __restrict__ out, int M, int c0,
                                                    int n_out) {
  const int rg = threadIdx.x / NR_TPR, cl = threadIdx.x % NR_TPR;
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);   // [NR_GROUPS][MP][NR_BN]
#pragma unroll
  for (int m = 0; m < MP; ++m) {
    float4* r4 = reinterpret_cast<float4*>(red + (rg * MP + m) * NR_BN + cl * NR_COLS);
    r4[0] = make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    r4[1] = make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < MP * NR_BN; idx += NR_NT) {
    const int m = idx / NR_BN, cc = idx % NR_BN, gc = c0 + cc;
    float sum = red[m * NR_BN + cc];
#pragma unroll
    for (int g = 1; g < NR_GROUPS; ++g) sum += red[(g * MP + m) * NR_BN + cc];
    if (m < M && gc < n_out) out[(size_t)m * n_out + gc] = sum;
  }
}

// 32 bits of the codeword words starting at bit `pos` (a constant after
// unrolling, so the words stay in registers).
__device__ __forceinline__ uint32_t window32(const uint32_t (&w)[MAX_W], int pos) {
  const int q = pos >> 5, sh = pos & 31;
  const uint32_t hi = q + 1 < MAX_W ? w[q + 1] : 0u;
  return sh ? __funnelshift_r(w[q], hi, sh) : w[q];
}

__device__ __forceinline__ void or_at(uint32_t (&d)[MAX_W], uint32_t v, int pos) {
  const int q = pos >> 5, sh = pos & 31;
  d[q] |= v << sh;
  if (sh && q + 1 < MAX_W) d[q + 1] |= v >> (32 - sh);
}

// The mantissa thresholds of a narrow thread's 8 columns [cg, cg + 8)
// (global store columns) under a fault process of kind KIND; for the i.i.d.
// kind every member folds away. Correlated: each column's threshold, once a
// kernel. Burst: each column's unit (col, bank) and the live-column mask of
// the current row (bit q: column q draws), found once a kernel (col axis)
// or once a row unit (row, bank axes): one hash a unit, never one a draw.
template <int KIND>
struct NarrowManModel {
  uint32_t useed, m_thr, m_len, ru, live;
  int axis;
  uint32_t col[NR_COLS];   // correlated: thresholds; burst: column units

  __device__ __forceinline__ void init(const Scalars& sc, int axis_, uint32_t cg,
                                       uint32_t thr) {
    if constexpr (KIND != MODEL_IID) {
      useed = unit_seed_mul(sc.v[SEED_MAN]);
      m_thr = sc.v[M_THR];
      m_len = sc.v[M_LEN];
      axis = axis_;
      ru = 0u;
      live = 0u;
#pragma unroll
      for (int q = 0; q < NR_COLS; ++q) {
        const uint32_t unit = (cg + q) / m_len;
        col[q] = KIND == MODEL_CORRELATED
                     ? correlated_threshold(hash_u32(unit ^ useed), m_thr, thr)
                     : unit;
      }
      if (KIND == MODEL_BURST && axis == AXIS_COL) {
        bool hit = false;
#pragma unroll
        for (int q = 0; q < NR_COLS; ++q) {
          if (q == 0 || col[q] != col[q - 1]) hit = hash_u32(col[q] ^ useed) < m_thr;
          live |= (uint32_t)hit << q;
        }
      }
    }
  }

  // Burst row and bank axes: the live columns of global row `grow`,
  // recomputed where its row unit differs from the last row's (or `fresh`).
  __device__ __forceinline__ void row(uint32_t grow, bool fresh) {
    if constexpr (KIND == MODEL_BURST) {
      if (axis == AXIS_COL) return;
      const uint32_t u = grow / m_len;
      if (!fresh && u == ru) return;
      ru = u;
      if (axis == AXIS_ROW) {
        live = hash_u32(u ^ useed) < m_thr ? 0xFFu : 0u;
      } else {
        live = 0u;
        bool hit = false;
#pragma unroll
        for (int q = 0; q < NR_COLS; ++q) {
          if (q == 0 || col[q] != col[q - 1])
            hit = hash_u32((u * 0x10001u + col[q]) ^ useed) < m_thr;
          live |= (uint32_t)hit << q;
        }
      }
    }
  }

  // The threshold of column q in the current row.
  __device__ __forceinline__ uint32_t thr(int q, uint32_t thr_) const {
    if constexpr (KIND == MODEL_BURST) return (live >> q) & 1u ? thr_ : 0u;
    if constexpr (KIND == MODEL_CORRELATED) return col[q];
    return thr_;
  }
};

// One codeword of the stage: dynamic flips, SECDED syndrome and single-error
// correction, then its data bits (the body without the parity positions
// 2^j - 1) OR-ed into the (block row, group)'s payload string at bit
// s * seg_bits. The string was zeroed beforehand.
template <bool DYN, int KIND>
__device__ __forceinline__ void narrow_decode_codeword(
    const uint32_t* __restrict__ cs, uint32_t* pay, int i, int b0, int g0,
    int n_blocks, int n_groups, const NarrowGeo& geo, uint32_t store_g,
    uint32_t seed_cw, uint32_t thr_meta, uint32_t off_k, uint32_t off_j,
    const ReadModel& md, uint32_t useed_cw) {
  const int s = i % geo.S, bg = i / geo.S;
  uint32_t w[MAX_W];
  if (geo.W == MAX_W) {
    const uint4 v = *reinterpret_cast<const uint4*>(cs + i * MAX_W);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < MAX_W; ++q) w[q] = q < geo.W ? cs[i * geo.W + q] : 0u;
  }
  if (DYN && thr_meta) {
    const int bl = bg / geo.gb, gl = bg - bl * geo.gb;
    const int gbk = b0 + bl, gg = g0 + gl;
    if (gbk < n_blocks && gg < n_groups) {
      const uint32_t celem = (((uint32_t)gbk + off_k / (uint32_t)geo.n_group) * store_g +
                              (uint32_t)gg + off_j / (uint32_t)geo.rw) *
                                 (uint32_t)(geo.S * geo.W) +
                             (uint32_t)(s * geo.W);
      // codeword plane: row = block row, column unit = row_weights group;
      // one threshold a codeword
      uint32_t t = thr_meta;
      if constexpr (KIND != MODEL_IID)
        t = model_threshold(KIND, md.axis, (uint32_t)gbk + off_k / (uint32_t)geo.n_group,
                            (uint32_t)gg + off_j / (uint32_t)geo.rw, useed_cw, md.m_thr,
                            md.m_len, thr_meta);
#pragma unroll
      for (int q = 0; q < MAX_W; ++q)
        if (q < geo.W) w[q] ^= flip_mask(celem + q, seed_cw, t, geo.code_mask[q]);
    }
  }
  // syndrome bit j: parity of the body bits in column mask j; overall
  // parity over every stored bit
  uint32_t syn = 0u, par = 0u;
#pragma unroll
  for (int j = 0; j < NR_MAX_R; ++j) {
    uint32_t t = 0u;
#pragma unroll
    for (int q = 0; q < MAX_W; ++q) t ^= w[q] & geo.body_mask[q] & geo.hmask[j][q];
    syn |= (uint32_t)(__popc(t) & 1) << j;
  }
#pragma unroll
  for (int q = 0; q < MAX_W; ++q) par ^= w[q] & geo.code_mask[q];
  const uint32_t pos = syn - 1u;
  const bool fix = (__popc(par) & 1) && syn > 0u && (int)pos < geo.n_body;
#pragma unroll
  for (int q = 0; q < MAX_W; ++q)
    w[q] ^= (fix && (int)(pos >> 5) == q) ? 1u << (pos & 31u) : 0u;
  // data runs: body bits [2^j, 2^(j+1) - 1) -> data bits from 2^j - j - 1
  uint32_t d[MAX_W] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 1; j < NR_MAX_R; ++j) {
    if (j < geo.r) {
      const int src = 1 << j, dst = (1 << j) - j - 1;
      const int len = min((1 << (j + 1)) - 1, geo.n_body) - src;
#pragma unroll
      for (int o = 0; o < (1 << j) - 1; o += 32) {
        const int l = min(32, len - o);
        if (l > 0)
          or_at(d, window32(w, src + o) & (l == 32 ? ~0u : (1u << l) - 1u), dst + o);
      }
    }
  }
  const int p0 = s * geo.seg_bits, sh = p0 & 31;
  uint32_t* dstw = pay + bg * geo.pw + (p0 >> 5);
#pragma unroll
  for (int q = 0; q <= MAX_W; ++q) {
    uint32_t v = q < MAX_W ? d[q] << sh : 0u;
    if (q > 0 && sh) v |= d[q - 1] >> (32 - sh);
    if (v) atomicOr(dstw + q, v);
  }
}

template <int MP, bool DYN, int KIND>
__global__ void __launch_bounds__(NR_NT, 1) cim_read_one4n_narrow_kernel(
    const float* __restrict__ x, const uint16_t* __restrict__ man,
    const uint32_t* __restrict__ cw, float* __restrict__ out, int M, int K_log,
    int k_pad, int j_pad, int n_out, NarrowGeo geo, Scalars sc, uint32_t store_g,
    uint32_t store_j, ReadModel md) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* man_s = reinterpret_cast<uint16_t*>(smem);
  uint32_t* cw_s = reinterpret_cast<uint32_t*>(smem + NR_STAGES * NR_MAN_HALVES * 2);
  uint32_t* pay_s = cw_s + NR_STAGES * geo.cw_stage;
  float* x_s = reinterpret_cast<float*>(pay_s + 2 * geo.pay_buf);   // [x_slab][MP]

  const int tid = threadIdx.x;
  const int rg = tid / NR_TPR, cl = tid % NR_TPR;
  const int c0 = blockIdx.x * NR_BN, col = c0 + cl * NR_COLS;
  const int gl = (cl * NR_COLS) / geo.rw, t0 = (cl * NR_COLS) % geo.rw;
  const int n_chunks = (k_pad + NR_CK - 1) / NR_CK;
  const int n_blocks = k_pad / geo.n_group, n_groups = j_pad / geo.rw;
  const int g0 = c0 / geo.rw;
  const int sw = geo.S * geo.W;                     // codeword words a group
  const int row_words = geo.gb * sw;                // codeword words a block row
  const int n_cw = geo.cb * geo.gb * geo.S;         // codewords a stage
  const uint32_t thr_man = sc.v[THR_MAN], thr_meta = sc.v[THR_META];
  const uint32_t seed_man = sc.v[SEED_MAN] * GOLD, seed_cw = sc.v[SEED_CW] * GOLD;
  const uint32_t off_k = sc.v[OFF_K], off_j = sc.v[OFF_J];
  uint32_t useed_cw = 0u;
  NarrowManModel<KIND> mm;
  if constexpr (KIND != MODEL_IID) {
    useed_cw = unit_seed_mul(sc.v[SEED_CW]);
    mm.init(sc, md.axis, (uint32_t)col + off_j, thr_man);
  }

  auto load_stage = [&](int c) {
    if (c < n_chunks) {
      const int slot = c % NR_STAGES, k0 = c * NR_CK;
      narrow_copy_man(man_s + slot * NR_MAN_HALVES, man, k0, c0, k_pad, j_pad);
      uint32_t* cs = cw_s + slot * geo.cw_stage;
      const int b0 = k0 / geo.n_group;
      if (geo.cw_vec) {
        for (int i = tid * 4; i < geo.cb * row_words; i += NR_NT * 4) {
          const int bl = i / row_words, wd = i - bl * row_words;
          const bool ok = b0 + bl < n_blocks && g0 + wd / sw < n_groups;
          cp_async16(cs + i, ok ? cw + ((size_t)(b0 + bl) * n_groups + g0) * sw + wd : cw,
                     ok);
        }
      } else {
        for (int i = tid; i < geo.cb * row_words; i += NR_NT) {
          const int bl = i / row_words, wd = i - bl * row_words;
          const bool ok = b0 + bl < n_blocks && g0 + wd / sw < n_groups;
          cp_async4(cs + i, ok ? cw + ((size_t)(b0 + bl) * n_groups + g0) * sw + wd : cw,
                    ok);
        }
      }
    }
    cp_async_commit();
  };
  auto zero_payload = [&](int buf) {
    uint4* p = reinterpret_cast<uint4*>(pay_s + buf * geo.pay_buf);
    for (int i = tid; i < geo.pay_buf / 4; i += NR_NT) p[i] = make_uint4(0u, 0u, 0u, 0u);
  };

  float acc[MP][NR_COLS];
#pragma unroll
  for (int m = 0; m < MP; ++m)
#pragma unroll
    for (int q = 0; q < NR_COLS; ++q) acc[m][q] = 0.0f;

  for (int c = 0; c < NR_STAGES - 1; ++c) load_stage(c);
  zero_payload(0);
  int slab0 = 0;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<NR_STAGES - 2>();
    __syncthreads();   // stage c landed for all; stage c - 1 and its payload consumed
    load_stage(c + NR_STAGES - 1);
    const int k0 = c * NR_CK;
    if (k0 % geo.x_slab == 0) {   // the next slab of x
      slab0 = k0;
      narrow_load_x<MP>(x_s, x, k0, geo.x_slab, M, K_log);
    }
    zero_payload((c + 1) & 1);
    uint32_t* pay = pay_s + (c & 1) * geo.pay_buf;
    {
      const uint32_t* cs = cw_s + (c % NR_STAGES) * geo.cw_stage;
      for (int i = tid; i < n_cw; i += NR_NT)
        narrow_decode_codeword<DYN, KIND>(cs, pay, i, k0 / geo.n_group, g0, n_blocks,
                                          n_groups, geo, store_g, seed_cw, thr_meta, off_k,
                                          off_j, md, useed_cw);
    }
    __syncthreads();   // payload strings complete

    const uint16_t* ms = man_s + (c % NR_STAGES) * NR_MAN_HALVES;
    const unsigned char* payb = reinterpret_cast<const unsigned char*>(pay);
    uint32_t ef[NR_COLS];
    constexpr int ROW_UNROLL = DYN ? 1 : NR_ROWS;
#pragma unroll (ROW_UNROLL)
    for (int i = 0; i < NR_ROWS; ++i) {
      const int kr = rg * NR_ROWS + i, gk = k0 + kr;
      if (gk >= K_log) break;   // the store's padding rows are not weights
      const int bl = kr >> geo.log2n, i_n = kr & (geo.n_group - 1);
      const int pbase = (bl * geo.gb + gl) * geo.pw;
      if (i == 0 || i_n == 0) {
        // the 8 exponent fields of this thread's columns: 40 bits from
        // payload bit 5 * t0
        const int e0 = 5 * t0, q0 = pbase + (e0 >> 5);
        const uint32_t lo = __funnelshift_r(pay[q0], pay[q0 + 1], e0 & 31);
        const uint32_t hi = __funnelshift_r(pay[q0 + 1], pay[q0 + 2], e0 & 31);
#pragma unroll
        for (int q = 0; q < NR_COLS; ++q) {
          const uint32_t e =
              (q < 6 ? lo >> (5 * q) : (q == 6 ? __funnelshift_r(lo, hi, 30) : hi >> 3)) &
              31u;
          ef[q] = (e == 31u ? 0xFFu : e) << 23;
        }
      }
      // sign bits of the row's 8 columns: one byte (rw, t0 are multiples of 8)
      const uint32_t sb = payb[pbase * 4 + ((5 * geo.rw + i_n * geo.rw + t0) >> 3)];
      const uint4 mw = *reinterpret_cast<const uint4*>(ms + kr * NR_BN + cl * NR_COLS);
      uint32_t mv[4] = {mw.x, mw.y, mw.z, mw.w};
      if (DYN && thr_man && col < j_pad) {
        const uint32_t e = ((uint32_t)gk + off_k) * store_j + (uint32_t)col + off_j;
        mm.row((uint32_t)gk + off_k, i == 0);
#pragma unroll
        for (int q = 0; q < NR_COLS; ++q) {
          const uint32_t f = flip_mask<0x3FFu>(e + q, seed_man, mm.thr(q, thr_man));
          mv[q >> 1] ^= (q & 1) ? f << 16 : f;
        }
      }
      float xv[MP];
      const float* xr = x_s + (gk - slab0) * MP;
      if constexpr (MP % 4 == 0) {
#pragma unroll
        for (int m = 0; m < MP; m += 4) {
          const float4 v = *reinterpret_cast<const float4*>(xr + m);
          xv[m] = v.x; xv[m + 1] = v.y; xv[m + 2] = v.z; xv[m + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int m = 0; m < MP; ++m) xv[m] = xr[m];
      }
#pragma unroll
      for (int q = 0; q < NR_COLS; ++q) {
        const uint32_t word = mv[q >> 1];
        const uint32_t mb = ((q & 1) ? word >> 3 : word << 13) & 0x007FE000u;
        const uint32_t bits = ((sb << (31 - q)) & 0x80000000u) | ef[q] | mb;
        const float wv = __uint_as_float(bits) * __uint_as_float((127u + 112u) << 23);
#pragma unroll
        for (int m = 0; m < MP; ++m) acc[m][q] = fmaf(xv[m], wv, acc[m][q]);
      }
    }
  }

  narrow_reduce_store<MP>(smem, acc, out, M, c0, n_out);
}

template <int MP, bool DYN, int KIND>
int launch_narrow_kernel(const void* x, const void* man, const void* cw, void* out, int M,
                  int K_log, int k_pad, int j_pad, int n_out, const NarrowGeo& geo,
                  const Scalars& sc, uint32_t store_g, uint32_t store_j,
                  const ReadModel& md, int smem, cudaStream_t stream) {
  auto kern = cim_read_one4n_narrow_kernel<MP, DYN, KIND>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((j_pad + NR_BN - 1) / NR_BN);
  kern<<<grid, NR_NT, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const uint16_t*>(man),
      static_cast<const uint32_t*>(cw), static_cast<float*>(out), M, K_log, k_pad,
      j_pad, n_out, geo, sc, store_g, store_j, md);
  return (int)cudaGetLastError();
}

// The instantiation of a read: static reads take the i.i.d. code (they draw
// nothing); a dynamic read takes its process's kind.
template <int MP>
int launch_narrow(const void* x, const void* man, const void* cw, void* out, int M,
                  int K_log, int k_pad, int j_pad, int n_out, const NarrowGeo& geo,
                  const Scalars& sc, uint32_t store_g, uint32_t store_j,
                  const ReadModel& md, int smem, bool dynamic, cudaStream_t stream) {
  if (!dynamic)
    return launch_narrow_kernel<MP, false, MODEL_IID>(x, man, cw, out, M, K_log, k_pad,
                                                      j_pad, n_out, geo, sc, store_g,
                                                      store_j, md, smem, stream);
  switch (md.kind) {
    case MODEL_BURST:
      return launch_narrow_kernel<MP, true, MODEL_BURST>(x, man, cw, out, M, K_log, k_pad,
                                                         j_pad, n_out, geo, sc, store_g,
                                                         store_j, md, smem, stream);
    case MODEL_CORRELATED:
      return launch_narrow_kernel<MP, true, MODEL_CORRELATED>(
          x, man, cw, out, M, K_log, k_pad, j_pad, n_out, geo, sc, store_g, store_j, md,
          smem, stream);
    default:
      return launch_narrow_kernel<MP, true, MODEL_IID>(x, man, cw, out, M, K_log, k_pad,
                                                       j_pad, n_out, geo, sc, store_g,
                                                       store_j, md, smem, stream);
  }
}

// ---------------------------------------------------------------------------
// K2's narrow kernel (M <= 8): see the note at the top.
// ---------------------------------------------------------------------------

constexpr int NR_SIGN_WORDS = NR_CK / 32 * NR_BN;   // sign words a stage: 4 rows

struct RawNarrow {
  const float* x;
  const uint16_t* man;
  const uint8_t* expw;
  const uint32_t* signw;
  float* out;
  int M, K_log, k_pad, j_pad, n_out, sw_rows, log2n, x_slab;
  uint32_t store_k, store_j;
  Scalars sc;
  ReadModel md;
};

// Dynamic shared memory of K2's narrow kernel, in bytes (`exp_stage`: the
// exponent bytes of one stage, 128 / n rows of 128); ops.resolve_tiles
// computes the same number.
int raw_narrow_smem_bytes(int exp_stage, int x_slab, int mp) {
  return NR_STAGES * (NR_MAN_HALVES * 2 + NR_SIGN_WORDS * 4 + exp_stage) + x_slab * mp * 4;
}

// The landed stage's exponent bytes and sign words, flipped in place, each
// word drawn by exactly one thread, at the global store indices the tile
// kernel draws: exponent byte (gb + off_k/n) * store_j + gc + off_j, sign
// word (gw + off_k/32) * store_j + gc + off_j, its lanes at or past the
// store's K rows masked out (they are not cells). Under a fault process each
// exponent byte and each sign word takes its own threshold: the exponent
// plane's row is the block row, the sign plane's the sign-word row.
template <int KIND>
__device__ __forceinline__ void raw_narrow_flip_meta(uint8_t* es, uint32_t* ss, int k0, int c0,
                                                     const RawNarrow& p, int n_blocks,
                                                     uint32_t seed_meta, uint32_t seed_sign,
                                                     uint32_t thr_meta, uint32_t useed_meta,
                                                     uint32_t useed_sign) {
  const uint32_t off_k = p.sc.v[OFF_K], off_j = p.sc.v[OFF_J];
  const int cb = NR_CK >> p.log2n;
  uint32_t* ew = reinterpret_cast<uint32_t*>(es);   // 4 exponent bytes a word
  for (int i = threadIdx.x; i < cb * (NR_BN / 4); i += NR_NT) {
    const int gb = (k0 >> p.log2n) + i / (NR_BN / 4), gc = c0 + (i % (NR_BN / 4)) * 4;
    if (gb < n_blocks && gc < p.j_pad) {
      const uint32_t erow = (uint32_t)gb + (off_k >> p.log2n), ecol = (uint32_t)gc + off_j;
      const uint32_t e = erow * p.store_j + ecol;
      uint32_t f = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t t = thr_meta;
        if constexpr (KIND != MODEL_IID)
          t = model_threshold(KIND, p.md.axis, erow, ecol + q, useed_meta, p.md.m_thr,
                              p.md.m_len, thr_meta);
        f |= flip_mask<0x1Fu>(e + q, seed_meta, t) << (8 * q);
      }
      ew[i] ^= f;
    }
  }
  for (int i = threadIdx.x; i < NR_SIGN_WORDS; i += NR_NT) {
    const int gw = (k0 >> 5) + i / NR_BN, gc = c0 + i % NR_BN;
    if (gw < p.sw_rows && gc < p.j_pad) {
      const uint32_t grow = (uint32_t)gw + off_k / 32u;
      const uint64_t first = (uint64_t)grow * 32u;
      const uint64_t valid = first >= p.store_k ? 0u : p.store_k - first;
      const uint32_t lanes = (uint32_t)((1ull << (valid < 32u ? valid : 32u)) - 1ull);
      const uint32_t scol = (uint32_t)gc + off_j;
      uint32_t t = thr_meta;
      if constexpr (KIND != MODEL_IID)
        t = model_threshold(KIND, p.md.axis, grow, scol, useed_sign, p.md.m_thr, p.md.m_len,
                            thr_meta);
      ss[i] ^= flip_mask<0xFFFFFFFFu>(grow * p.store_j + scol, seed_sign, t) & lanes;
    }
  }
}

template <int MP, bool DYN, int KIND>
__global__ void __launch_bounds__(NR_NT, 1) cim_read_raw_narrow_kernel(const __grid_constant__ RawNarrow p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cb = NR_CK >> p.log2n;                   // block rows a stage
  uint16_t* man_s = reinterpret_cast<uint16_t*>(smem);
  uint32_t* sign_s = reinterpret_cast<uint32_t*>(smem + NR_STAGES * NR_MAN_HALVES * 2);
  uint8_t* exp_s = reinterpret_cast<uint8_t*>(sign_s + NR_STAGES * NR_SIGN_WORDS);
  float* x_s = reinterpret_cast<float*>(exp_s + NR_STAGES * cb * NR_BN);   // [x_slab][MP]

  const int tid = threadIdx.x;
  const int rg = tid / NR_TPR, cl = tid % NR_TPR;
  const int c0 = blockIdx.x * NR_BN, col = c0 + cl * NR_COLS;
  const int n_chunks = (p.k_pad + NR_CK - 1) / NR_CK, n_blocks = p.k_pad >> p.log2n;
  const int n_mask = (1 << p.log2n) - 1;
  const uint32_t thr_man = p.sc.v[THR_MAN], thr_meta = p.sc.v[THR_META];
  const uint32_t seed_man = p.sc.v[SEED_MAN] * GOLD, seed_meta = p.sc.v[SEED_META] * GOLD;
  const uint32_t seed_sign = p.sc.v[SEED_CW] * GOLD;
  const uint32_t off_k = p.sc.v[OFF_K], off_j = p.sc.v[OFF_J];
  uint32_t useed_meta = 0u, useed_sign = 0u;
  NarrowManModel<KIND> mm;
  if constexpr (KIND != MODEL_IID) {
    useed_meta = unit_seed_mul(p.sc.v[SEED_META]);
    useed_sign = unit_seed_mul(p.sc.v[SEED_CW]);
    mm.init(p.sc, p.md.axis, (uint32_t)col + off_j, thr_man);
  }

  auto load_stage = [&](int c) {
    if (c < n_chunks) {
      const int slot = c % NR_STAGES, k0 = c * NR_CK;
      narrow_copy_man(man_s + slot * NR_MAN_HALVES, p.man, k0, c0, p.k_pad, p.j_pad);
      uint32_t* ss = sign_s + slot * NR_SIGN_WORDS;
      for (int i = tid; i < NR_SIGN_WORDS / 4; i += NR_NT) {
        const int row = i / (NR_BN / 4), piece = i % (NR_BN / 4);
        const int gw = (k0 >> 5) + row, gc = c0 + piece * 4;
        const bool ok = gw < p.sw_rows && gc < p.j_pad;
        cp_async16(ss + row * NR_BN + piece * 4,
                   ok ? p.signw + (size_t)gw * p.j_pad + gc : p.signw, ok);
      }
      uint8_t* es = exp_s + slot * cb * NR_BN;
      for (int i = tid; i < cb * (NR_BN / 16); i += NR_NT) {
        const int row = i / (NR_BN / 16), piece = i % (NR_BN / 16);
        const int gb = (k0 >> p.log2n) + row, gc = c0 + piece * 16;
        const bool ok = gb < n_blocks && gc < p.j_pad;
        cp_async16(es + row * NR_BN + piece * 16,
                   ok ? p.expw + (size_t)gb * p.j_pad + gc : p.expw, ok);
      }
    }
    cp_async_commit();
  };

  float acc[MP][NR_COLS];
#pragma unroll
  for (int m = 0; m < MP; ++m)
#pragma unroll
    for (int q = 0; q < NR_COLS; ++q) acc[m][q] = 0.0f;

  for (int c = 0; c < NR_STAGES - 1; ++c) load_stage(c);
  int slab0 = 0;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<NR_STAGES - 2>();
    __syncthreads();   // stage c landed for all; stage c - 1 consumed
    load_stage(c + NR_STAGES - 1);
    const int k0 = c * NR_CK, slot = c % NR_STAGES;
    uint32_t* ss = sign_s + slot * NR_SIGN_WORDS;
    uint8_t* es = exp_s + slot * cb * NR_BN;
    bool sync = false;
    if (k0 % p.x_slab == 0) {   // the next slab of x
      slab0 = k0;
      narrow_load_x<MP>(x_s, p.x, k0, p.x_slab, p.M, p.K_log);
      sync = true;
    }
    if (DYN && thr_meta) {
      raw_narrow_flip_meta<KIND>(es, ss, k0, c0, p, n_blocks, seed_meta, seed_sign, thr_meta,
                                 useed_meta, useed_sign);
      sync = true;
    }
    if (sync) __syncthreads();   // x and the flipped meta words seen by all

    const uint16_t* ms = man_s + slot * NR_MAN_HALVES;
    // this thread's 8 columns' sign words (its 8 rows lie in one 32-row
    // word), shifted so that bit i is row i
    const uint4 sw0 = *reinterpret_cast<const uint4*>(ss + (rg >> 2) * NR_BN + cl * NR_COLS);
    const uint4 sw1 = *reinterpret_cast<const uint4*>(ss + (rg >> 2) * NR_BN + cl * NR_COLS + 4);
    const int sh = (rg & 3) * NR_ROWS;
    const uint32_t sg[NR_COLS] = {sw0.x >> sh, sw0.y >> sh, sw0.z >> sh, sw0.w >> sh,
                                  sw1.x >> sh, sw1.y >> sh, sw1.z >> sh, sw1.w >> sh};
    uint32_t ef[NR_COLS];
    constexpr int ROW_UNROLL = DYN ? 1 : NR_ROWS;
#pragma unroll (ROW_UNROLL)
    for (int i = 0; i < NR_ROWS; ++i) {
      const int kr = rg * NR_ROWS + i, gk = k0 + kr;
      if (gk >= p.K_log) break;   // the store's padding rows are not weights
      if (i == 0 || (kr & n_mask) == 0) {
        // the 8 exponent bytes of this block row's columns: one 8-byte load
        const uint2 ev = *reinterpret_cast<const uint2*>(es + (kr >> p.log2n) * NR_BN +
                                                         cl * NR_COLS);
#pragma unroll
        for (int q = 0; q < NR_COLS; ++q) {
          const uint32_t e = ((q < 4 ? ev.x : ev.y) >> (8 * (q & 3))) & 0xFFu;
          ef[q] = (e == 31u ? 0xFFu : e) << 23;
        }
      }
      const uint4 mw = *reinterpret_cast<const uint4*>(ms + kr * NR_BN + cl * NR_COLS);
      uint32_t mv[4] = {mw.x, mw.y, mw.z, mw.w};
      if (DYN && thr_man && col < p.j_pad) {
        const uint32_t elem = ((uint32_t)gk + off_k) * p.store_j + (uint32_t)col + off_j;
        mm.row((uint32_t)gk + off_k, i == 0);
#pragma unroll
        for (int q = 0; q < NR_COLS; ++q) {
          const uint32_t fm = flip_mask<0x3FFu>(elem + q, seed_man, mm.thr(q, thr_man));
          mv[q >> 1] ^= (q & 1) ? fm << 16 : fm;
        }
      }
      float xv[MP];
      const float* xr = x_s + (gk - slab0) * MP;
      if constexpr (MP % 4 == 0) {
#pragma unroll
        for (int m = 0; m < MP; m += 4) {
          const float4 v = *reinterpret_cast<const float4*>(xr + m);
          xv[m] = v.x; xv[m + 1] = v.y; xv[m + 2] = v.z; xv[m + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int m = 0; m < MP; ++m) xv[m] = xr[m];
      }
#pragma unroll
      for (int q = 0; q < NR_COLS; ++q) {
        const uint32_t mword = mv[q >> 1];
        const uint32_t mb = ((q & 1) ? mword >> 3 : mword << 13) & 0x007FE000u;
        const uint32_t bits = ((sg[q] << (31 - i)) & 0x80000000u) | ef[q] | mb;
        const float wv = __uint_as_float(bits) * __uint_as_float((127u + 112u) << 23);
#pragma unroll
        for (int m = 0; m < MP; ++m) acc[m][q] = fmaf(xv[m], wv, acc[m][q]);
      }
    }
  }
  narrow_reduce_store<MP>(smem, acc, p.out, p.M, c0, p.n_out);
}

template <int MP>
int launch_raw_narrow(const RawNarrow& p, bool dynamic, int smem, cudaStream_t stream) {
  auto kern = !dynamic ? cim_read_raw_narrow_kernel<MP, false, MODEL_IID>
            : p.md.kind == MODEL_BURST ? cim_read_raw_narrow_kernel<MP, true, MODEL_BURST>
            : p.md.kind == MODEL_CORRELATED
                ? cim_read_raw_narrow_kernel<MP, true, MODEL_CORRELATED>
                : cim_read_raw_narrow_kernel<MP, true, MODEL_IID>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((p.j_pad + NR_BN - 1) / NR_BN), NR_NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

Scalars read_scalars(const uint32_t* s) {
  Scalars sc;
  for (int i = 0; i < N_SCALARS; ++i) sc.v[i] = s[i];
  return sc;
}

// The fault process of a read, or false when the host passed one the
// kernels do not take (a kind or axis out of range, a burst or correlated
// process with no run length).
bool read_model(int kind, int axis, const Scalars& sc, ReadModel* md) {
  *md = ReadModel{kind, axis, sc.v[M_THR], sc.v[M_LEN]};
  return kind >= MODEL_IID && kind <= MODEL_CORRELATED && axis >= AXIS_ROW &&
         axis <= AXIS_BANK && (kind == MODEL_IID || sc.v[M_LEN] >= 1u);
}

}  // namespace

// C interface (ctypes). Returns 0 on success, a cudaError_t after a refused
// launch, or -1 when the arguments fall outside what the kernels tile.
// `model_kind` (0 i.i.d. or drift, 1 burst, 2 correlated) and `model_axis`
// (0 row, 1 col, 2 bank) name the fault process of a dynamic read; its
// parameters are the scalars' M_THR and M_LEN.
extern "C" int cim_read_one4n(const void* x, const void* man, const void* cw,
                              void* out, int M, int K_log, int k_pad, int j_pad,
                              int n_out, int n_group, int rw, int S, int W,
                              int seg_bits, int n_body, int r, int payload_bits,
                              int man_bits, int exp_bits, int bias,
                              unsigned int store_g, unsigned int store_j,
                              const unsigned int* masks,
                              const unsigned int* scalars, int dynamic,
                              int model_kind, int model_axis, void* stream) {
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
  const Scalars sc = read_scalars(scalars);
  ReadModel md;
  if (!read_model(dynamic ? model_kind : MODEL_IID, model_axis, sc, &md)) return -1;
  const dim3 grid((j_pad + BN - 1) / BN, (M + BM - 1) / BM);
  cim_read_one4n_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint16_t*>(man),
      static_cast<const uint32_t*>(cw), static_cast<float*>(out), M, K_log, k_pad,
      j_pad, n_out, geo, fmt, sc, dynamic, store_g, store_j, md);
  return (int)cudaGetLastError();
}

// The narrow kernel (M <= 8). `x_slab` and `smem_bytes` are the geometry
// ops.resolve_tiles chose; `tables` holds the codeword words' body masks
// [4], their stored-bit masks [4] and the syndrome column masks [7][4].
extern "C" int cim_read_one4n_narrow(const void* x, const void* man, const void* cw,
                                     void* out, int M, int K_log, int k_pad, int j_pad,
                                     int n_out, int n_group, int rw, int S, int W,
                                     int seg_bits, int n_body, int r, int man_bits,
                                     int exp_bits, int bias, int x_slab,
                                     int smem_bytes, unsigned int store_g,
                                     unsigned int store_j, const unsigned int* tables,
                                     const unsigned int* scalars, int dynamic,
                                     int model_kind, int model_axis, void* stream) {
  int log2n = -1;
  for (int b = 0; b < 8; ++b)
    if (n_group == 1 << b) log2n = b;
  if (M <= 0 || M > 8 || k_pad <= 0 || j_pad <= 0 || man_bits != 10 || exp_bits != 5 ||
      bias != 15 || log2n < 0 || NR_CK % n_group != 0 || rw % NR_COLS != 0 ||
      NR_BN % rw != 0 || j_pad % 16 != 0 || k_pad % n_group != 0 || W < 1 ||
      W > MAX_W || r < 2 || r > NR_MAX_R || n_body >= 32 * MAX_W || S < 1 ||
      seg_bits != n_body - r || x_slab <= 0 || x_slab % NR_CK != 0 ||
      !aligned16(man) || !aligned16(cw) || K_log > k_pad || n_out > j_pad)
    return -1;
  const int mp = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8;
  NarrowGeo geo{};
  geo.n_group = n_group; geo.log2n = log2n; geo.rw = rw; geo.S = S; geo.W = W;
  geo.seg_bits = seg_bits; geo.n_body = n_body; geo.r = r;
  geo.gb = NR_BN / rw;
  geo.cb = NR_CK / n_group;
  geo.cw_stage = up16w(geo.cb * geo.gb * S * W);
  geo.pw = (S * seg_bits + 31) / 32 + NR_PAY_PAD;
  geo.pay_buf = up16w(geo.cb * geo.gb * geo.pw);
  geo.x_slab = x_slab;
  geo.cw_vec = (S * W) % 4 == 0;
  for (int q = 0; q < MAX_W; ++q) {
    geo.body_mask[q] = q < W ? tables[q] : 0u;
    geo.code_mask[q] = q < W ? tables[MAX_W + q] : 0u;
    for (int j = 0; j < NR_MAX_R; ++j)
      geo.hmask[j][q] = j < r && q < W ? tables[2 * MAX_W + j * MAX_W + q] : 0u;
  }
  const int smem = narrow_smem_bytes(geo.cw_stage, geo.pay_buf, x_slab, mp);
  if (smem != smem_bytes || smem > SMEM_LIMIT) return -1;
  const Scalars sc = read_scalars(scalars);
  const bool dyn = dynamic != 0;
  ReadModel md;
  if (!read_model(dyn ? model_kind : MODEL_IID, model_axis, sc, &md)) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mp) {
    case 1:
      return launch_narrow<1>(x, man, cw, out, M, K_log, k_pad, j_pad, n_out, geo, sc,
                              store_g, store_j, md, smem, dyn, st);
    case 2:
      return launch_narrow<2>(x, man, cw, out, M, K_log, k_pad, j_pad, n_out, geo, sc,
                              store_g, store_j, md, smem, dyn, st);
    case 4:
      return launch_narrow<4>(x, man, cw, out, M, K_log, k_pad, j_pad, n_out, geo, sc,
                              store_g, store_j, md, smem, dyn, st);
    default:
      return launch_narrow<8>(x, man, cw, out, M, K_log, k_pad, j_pad, n_out, geo, sc,
                              store_g, store_j, md, smem, dyn, st);
  }
}

extern "C" int cim_read_raw(const void* x, const void* man, const void* expw,
                            const void* signw, void* out, int M, int K_log,
                            int k_pad, int j_pad, int n_out, int sw_rows,
                            int n_group, int man_bits, int exp_bits, int bias,
                            unsigned int store_k, unsigned int store_j,
                            const unsigned int* scalars, int dynamic,
                            int model_kind, int model_axis, void* stream) {
  if (M <= 0 || k_pad <= 0 || j_pad <= 0 || BK % n_group != 0 || j_pad % 16 != 0 ||
      k_pad % n_group != 0 || sw_rows != (k_pad + 31) / 32 || !aligned16(man) ||
      K_log > k_pad || n_out > j_pad)
    return -1;
  const Fmt fmt{man_bits, exp_bits, bias};
  const Scalars sc = read_scalars(scalars);
  ReadModel md;
  if (!read_model(dynamic ? model_kind : MODEL_IID, model_axis, sc, &md)) return -1;
  const dim3 grid((j_pad + BN - 1) / BN, (M + BM - 1) / BM);
  cim_read_raw_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const uint16_t*>(man),
      static_cast<const uint8_t*>(expw), static_cast<const uint32_t*>(signw),
      static_cast<float*>(out), M, K_log, k_pad, j_pad, n_out, sw_rows, n_group, fmt,
      sc, dynamic, store_k, store_j, md);
  return (int)cudaGetLastError();
}

// K2's narrow kernel (M <= 8). `x_slab` and `smem_bytes` are the geometry
// ops.resolve_tiles chose; n_group must be a power of two dividing 128, the
// format fp16.
extern "C" int cim_read_raw_narrow(const void* x, const void* man, const void* expw,
                                   const void* signw, void* out, int M, int K_log,
                                   int k_pad, int j_pad, int n_out, int sw_rows,
                                   int n_group, int man_bits, int exp_bits, int bias,
                                   int x_slab, int smem_bytes, unsigned int store_k,
                                   unsigned int store_j, const unsigned int* scalars,
                                   int dynamic, int model_kind, int model_axis,
                                   void* stream) {
  int log2n = -1;
  for (int b = 0; b < 8; ++b)
    if (n_group == 1 << b) log2n = b;
  if (M <= 0 || M > 8 || k_pad <= 0 || j_pad <= 0 || man_bits != 10 || exp_bits != 5 ||
      bias != 15 || log2n < 0 || j_pad % 16 != 0 || k_pad % n_group != 0 ||
      sw_rows != (k_pad + 31) / 32 || x_slab <= 0 || x_slab % NR_CK != 0 ||
      !aligned16(man) || !aligned16(expw) || !aligned16(signw) || K_log > k_pad ||
      n_out > j_pad)
    return -1;
  const int mp = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8;
  const int smem = raw_narrow_smem_bytes((NR_CK / n_group) * NR_BN, x_slab, mp);
  if (smem != smem_bytes || smem > SMEM_LIMIT) return -1;
  const Scalars sc = read_scalars(scalars);
  ReadModel md;
  if (!read_model(dynamic ? model_kind : MODEL_IID, model_axis, sc, &md)) return -1;
  const RawNarrow p{static_cast<const float*>(x), static_cast<const uint16_t*>(man),
                    static_cast<const uint8_t*>(expw), static_cast<const uint32_t*>(signw),
                    static_cast<float*>(out), M, K_log, k_pad, j_pad, n_out, sw_rows, log2n,
                    x_slab, store_k, store_j, sc, md};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool dyn = dynamic != 0;
  switch (mp) {
    case 1: return launch_raw_narrow<1>(p, dyn, smem, st);
    case 2: return launch_raw_narrow<2>(p, dyn, smem, st);
    case 4: return launch_raw_narrow<4>(p, dyn, smem, st);
    default: return launch_raw_narrow<8>(p, dyn, smem, st);
  }
}
