// Block-FP (BFP / One4N) matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel bfp_matmul_pallas of
// repro/kernels/bfp_matmul/kernel.py (helpers _dequant_tile and
// _bfp_matmul_kernel):
//   out[M, N] = x[M, K] @ W,  W[k, n] = ±(1 + m/1024) · 2^(e-15),
// sign (bit 15) and mantissa (bits 0..9) from the uint16 plane man[K, N],
// e = exp[k / n_group, n] from the uint8 plane, fp32 accumulation.
// The weight is rebuilt exactly as the fp32 bit pattern
//   sign<<31 | (e+112)<<23 | m<<13
// (no exp2f, no powf), so x = I returns the aligned weights bit for bit.
// For e >= 143, 2^(e-15) overflows fp32 (the reference's exp2 gives inf):
// the field saturates to all ones and the mantissa is cleared, so the
// weight is +-inf, never NaN or a wrapped exponent.
//
// Two variants, picked by M on the host:
//  * bfp_matmul_narrow_kernel<MR> (M <= 8, decode-shaped). Bound: bytes.
//    Each weight feeds only M FMAs, so the call is a stream over the planes
//    (the full-width olmo-1b unembed: 206 MB of mantissas + 12.9 MB of
//    exponents, ~66 us at 3.35 TB/s). A block owns 128 columns (4 a lane)
//    and walks all of K; its 8 warps split each 256-row chunk of K, and each
//    thread issues 8 mantissa loads before it uses one, so many loads are in
//    flight per column strip. x's chunk sits in shared memory ([256][MR]
//    floats, broadcast reads); a thread keeps its columns' exponent fields in
//    registers and reloads them only when its row crosses a group boundary.
//    The 8 per-warp partial sums meet in shared memory and are added in a
//    fixed order.
//  * bfp_matmul_tc_kernel (M > 8). Bound: tensor-core operations. The
//    product runs on the TF32 tensor cores (mma.sync m16n8k8) and still
//    keeps fp32 accuracy, through a split of x:
//      - every weight is exact in TF32: its low 13 bits are zero and its
//        exponent is fp32's, so W needs no split;
//      - x = hi + lo + r, hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi),
//        |r| <= 2^-22 |x|; hi*W and lo*W are both exact products, so two
//        MMAs give the fp32 product (bf16 x is exact in TF32: lo = 0);
//      - the lo product takes W with its +-inf lanes set to 0, so an inf
//        weight gives +-inf (from hi*W) and not NaN where lo is 0; x = 0
//        against an inf weight gives NaN through hi, as the plain version
//        does; an inf or NaN x gets lo = 0 and hi carries it. Both guards
//        run only in a K stage that holds such a value (a flag a stage), so
//        a finite stage skips them;
//      - the tensor cores align and truncate inside an MMA, so every sum of
//        16 K rows (4 MMAs) starts from a zeroed fragment and is added to the
//        fp32 accumulator with FADDs, in a fixed order (no split-K, no
//        atomics: repeat calls are bitwise equal).
//    A 384-thread block owns a 128 x 128 output tile and is warp-specialized.
//    4 producer warps keep 4 K stages of 32 rows in flight through a 6-slot
//    cp.async ring of the raw operands (x rows, mantissa words, the exponent
//    rows the stage falls in; 16-byte copies where the strides allow, else
//    element loads), dequantize each landed stage once into one of two fp32
//    W tiles (a thread 8 rows x 4 columns, the exponent fields rebuilt once
//    per exponent byte), flag it, and hand it over; 8 consumer warps, each
//    32 x 64 of the tile (16 MMA tiles), split x and issue the MMAs. Named
//    barriers (FULL, EMPTY a W tile) pass the stages between the two, so
//    the dequantization overlaps the MMAs. x rows are padded by 16 bytes and
//    W rows by 8 floats, so the A and B fragment loads hit 32 distinct
//    banks. The grid runs M-fastest: the M blocks that read one column strip
//    of the planes run together, so the planes come from device memory
//    about once and x stays in L2.
//    M = 1024 at the unembed: two TF32 products of 211 GFLOP each, 0.853 ms
//    at 495 TFLOP/s (the fp32-FMA route's bound was 3.149 ms); mma.sync
//    reaches about 325 TFLOP/s on the H100 (1.30 ms for both).
// Ragged M, N and K edges are masked (zeros fill the shared tiles; rows past
// K dequantize to 0.0), so no padded copies are made. x is fp32 or bf16.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// narrow variant
constexpr int NT = 256;            // threads a block
constexpr int NW = NT / 32;        // warps a block
constexpr int NB = 128;            // columns a block: 4 a lane
constexpr int KC = NW * 32;        // rows a chunk: 32 a warp
constexpr int UNROLL = 8;          // mantissa loads issued before use
// tile variant
constexpr int TBM = 128, TBN = 128, TBK = 32;  // block tile; K rows a stage
constexpr int TRS = 6;                         // raw ring slots, one K stage each
constexpr int TLOOK = 4;                       // stages of copies in flight ahead
constexpr int TWP = TBN + 8;                   // W tile row, floats
constexpr int TCW = 8;                         // consumer (MMA) warps
constexpr int TPTH = 128;                      // producer threads: 4 warps
constexpr int TNTH = TCW * 32 + TPTH;          // threads a block: 384
constexpr int TWM = 4;                         // consumer warps along M (2 along N)
constexpr int TMT = TBM / TWM / 16;            // m16 tiles a consumer warp: 2
constexpr int TNT = TBN / (TCW / TWM) / 8;     // n8 tiles a consumer warp: 8

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(uint16_t bf16) {   // bf16 bits
  return __uint_as_float(static_cast<uint32_t>(bf16) << 16);
}

// The fp32 exponent field of 2^(e - 15), (e + 112) << 23, and the mantissa
// bits the weight keeps. From e = 143 the field would carry into the sign:
// it saturates to all ones and the mantissa is dropped (+-inf). Selects,
// not branches: computed once per exponent word, not per weight.
struct ExpField {
  uint32_t field, man_mask;
};

__device__ __forceinline__ ExpField exp_field(uint32_t e) {
  const bool inf = e >= 143u;
  return {inf ? 0x7F800000u : (e + 112u) << 23, inf ? 0u : 0x3FFu};
}

__device__ __forceinline__ float dequant(uint32_t m, ExpField ef) {
  return __uint_as_float(((m & 0x8000u) << 16) | ef.field | ((m & ef.man_mask) << 13));
}

template <int MR, typename XT, bool VEC>
__global__ void __launch_bounds__(NT)
bfp_matmul_narrow_kernel(const XT* __restrict__ x, const uint16_t* __restrict__ man,
                         const uint8_t* __restrict__ expw, float* __restrict__ out,
                         int M, int K, int N, int n_group) {
  __shared__ __align__(16) float xs[KC * MR];          // [row][m]
  __shared__ __align__(16) float red[NW][MR][NB];      // per-warp partial sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * NB + lane * 4;           // first of 4 columns
  float acc[MR][4];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    __syncthreads();                                   // last chunk's reads done
    for (int idx = threadIdx.x; idx < KC * MR; idx += NT) {
      const int mm = idx / KC, r = idx - mm * KC, k = k0 + r;
      xs[r * MR + mm] = (mm < M && k < K) ? to_f32(x[(size_t)mm * K + k]) : 0.f;
    }
    __syncthreads();
    const int kw = k0 + warp * 32;                     // this warp's 32 rows
    if (kw >= K) continue;
    int g = kw / n_group, rem = kw - g * n_group;
    ExpField ef[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ef[j] = c0 + j < N ? exp_field(expw[(size_t)g * N + c0 + j]) : ExpField{0u, 0u};
    for (int i0 = 0; i0 < 32; i0 += UNROLL) {
      uint32_t mv[UNROLL][4];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = kw + i0 + u;
        const uint16_t* row = man + (size_t)k * N;
        if (VEC) {
          uint2 v = make_uint2(0u, 0u);
          if (k < K && c0 < N) v = __ldg(reinterpret_cast<const uint2*>(row + c0));
          mv[u][0] = v.x & 0xFFFFu; mv[u][1] = v.x >> 16;
          mv[u][2] = v.y & 0xFFFFu; mv[u][3] = v.y >> 16;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mv[u][j] = (k < K && c0 + j < N) ? __ldg(row + c0 + j) : 0u;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int r = warp * 32 + i0 + u;
        if (kw + i0 + u >= K) break;                   // uniform across the warp
        float w[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) w[j] = dequant(mv[u][j], ef[j]);
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const float xv = xs[r * MR + i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, w[j], acc[i][j]);
        }
        if (++rem == n_group) {                        // next exponent group
          rem = 0;
          ++g;
          if (kw + i0 + u + 1 < K) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              ef[j] = c0 + j < N ? exp_field(expw[(size_t)g * N + c0 + j])
                                 : ExpField{0u, 0u};
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][i][lane * 4 + j] = acc[i][j];
  __syncthreads();
  for (int idx = threadIdx.x; idx < MR * NB; idx += NT) {
    const int i = idx / NB, c = idx - i * NB, col = blockIdx.x * NB + c;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += red[w][i][c];
    if (i < M && col < N) out[(size_t)i * N + col] = s;
  }
}

// ------------------------------------------------------------ tile variant

// Shared memory of the tile variant for x of type XT: TRS raw slots, each
// one K stage as copied (x rows padded by 16 bytes, so the A fragment loads
// hit 32 banks; the mantissa words; up to TBK exponent rows, which n_group 1
// needs), then two dequantized W tiles, then one flag word a W tile.
template <typename XT>
struct TileSmem {
  static constexpr int XP = TBK + 16 / (int)sizeof(XT);   // x row, elements
  static constexpr int M_OFF = TBM * XP * (int)sizeof(XT);
  static constexpr int E_OFF = M_OFF + TBK * TBN * 2;
  static constexpr int SLOT = E_OFF + TBK * TBN;
  static constexpr int W_OFF = TRS * SLOT;
  static constexpr int W_TILE = TBK * TWP;                 // floats
  static constexpr int F_OFF = W_OFF + 2 * W_TILE * 4;
  static constexpr int TOTAL = F_OFF + 2 * 4;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Named barriers between the producer and the consumer warps: bar_arrive
// signals without waiting, bar_sync waits until n threads have arrived.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Copy the raw operands of the stage at row k0 into a slot, by the TPTH
// producer threads (p = 0..TPTH-1): x [TBM, TBK], the mantissa words [TBK,
// TBN] and the exponent rows that the stage's rows fall in. Outside M, K or
// N the slot holds zeros. VEC: 16-byte cp.async, every chunk wholly inside or
// outside the matrices (the host checks the strides and bases); else element
// loads, stored synchronously.
template <typename XT, bool VEC>
__device__ __forceinline__ void tile_stage_load(uint8_t* slot, const XT* __restrict__ x,
                                                const uint16_t* __restrict__ man,
                                                const uint8_t* __restrict__ expw, int m0,
                                                int n0, int k0, int M, int K, int N,
                                                int n_group, int p) {
  using S = TileSmem<XT>;
  XT* xs = reinterpret_cast<XT*>(slot);
  uint16_t* ms = reinterpret_cast<uint16_t*>(slot + S::M_OFF);
  uint8_t* es = slot + S::E_OFF;
  const int g_lo = k0 / n_group;
  const int g_rows = (min(k0 + TBK, K) - 1) / n_group - g_lo + 1;
  if (VEC) {
    constexpr int XE = 16 / (int)sizeof(XT);          // x elements a chunk
    constexpr int XC = TBK / XE;                      // chunks an x row
#pragma unroll
    for (int j = 0; j < TBM * XC / TPTH; ++j) {
      const int i = p + j * TPTH, r = i / XC, c = (i % XC) * XE;
      const bool ok = m0 + r < M && k0 + c < K;
      cp_async16(xs + r * S::XP + c, ok ? x + (size_t)(m0 + r) * K + k0 + c : x, ok);
    }
#pragma unroll
    for (int j = 0; j < TBK * TBN / 8 / TPTH; ++j) {
      const int i = p + j * TPTH, r = i / (TBN / 8), c = (i % (TBN / 8)) * 8;
      const bool ok = k0 + r < K && n0 + c < N;
      cp_async16(ms + r * TBN + c, ok ? man + (size_t)(k0 + r) * N + n0 + c : man, ok);
    }
    for (int i = p; i < g_rows * (TBN / 16); i += TPTH) {
      const int r = i / (TBN / 16), c = (i % (TBN / 16)) * 16;
      const bool ok = n0 + c < N;
      cp_async16(es + r * TBN + c, ok ? expw + (size_t)(g_lo + r) * N + n0 + c : expw, ok);
    }
  } else {
    for (int i = p; i < TBM * TBK; i += TPTH) {
      const int r = i / TBK, c = i % TBK;
      xs[r * S::XP + c] =
          m0 + r < M && k0 + c < K ? x[(size_t)(m0 + r) * K + k0 + c] : XT(0);
    }
    for (int i = p; i < TBK * TBN; i += TPTH) {
      const int r = i / TBN, c = i % TBN;
      ms[r * TBN + c] =
          k0 + r < K && n0 + c < N ? man[(size_t)(k0 + r) * N + n0 + c] : uint16_t(0);
    }
    for (int i = p; i < g_rows * TBN; i += TPTH) {
      const int r = i / TBN, c = i % TBN;
      es[r * TBN + c] = n0 + c < N ? expw[(size_t)(g_lo + r) * N + n0 + c] : uint8_t(0);
    }
  }
}

// One producer thread's share of dequantizing a landed stage into a W
// tile: rows r0..r0+7 of the stage, columns c..c+3. The row's exponent group
// is tracked as it advances, so each column's exponent field (+-inf from
// e = 143) and mantissa mask are rebuilt once per exponent byte (once a
// stage at n_group 8), not per weight; a weight is then three or four bit
// operations on its mantissa word, bit for bit dequant(). CHECK (the stage
// runs past K): rows at or past K read 0.0, never 2^-15 nor a stale
// exponent row's inf. Only the stage's own exponent rows are read.
struct TileDequant {
  const uint16_t* ms;
  const uint8_t* es;
  int k, K, n_group, g_lo, g, rem;
  uint32_t fld[4], mm[4];          // exponent field; mantissa mask at bits 13..22
  bool inf = false;                // an inf weight among these

  __device__ __forceinline__ TileDequant(const uint8_t* slot, int m_off, int e_off, int k0,
                                         int r0, int c, int K_, int n_group_)
      : ms(reinterpret_cast<const uint16_t*>(slot + m_off) + r0 * TBN + c),
        es(slot + e_off + c), k(k0 + r0), K(K_), n_group(n_group_), g_lo(k0 / n_group_) {
    g = k / n_group;
    rem = k - g * n_group;
    if (k < K) fields();
  }

  __device__ __forceinline__ void fields() {
    const uint32_t e4 = *reinterpret_cast<const uint32_t*>(es + (g - g_lo) * TBN);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const ExpField f = exp_field((e4 >> (8 * j)) & 0xFFu);
      fld[j] = f.field;
      mm[j] = f.man_mask << 13;
      inf |= f.man_mask == 0u;                         // e >= 143
    }
  }

  // row i of the thread's eight, called in order
  template <bool CHECK>
  __device__ __forceinline__ float4 row(int i) {
    const uint2 m = *reinterpret_cast<const uint2*>(ms + i * TBN);
    float4 w = make_float4(
        __uint_as_float(((m.x << 16) & 0x80000000u) | ((m.x << 13) & mm[0]) | fld[0]),
        __uint_as_float((m.x & 0x80000000u) | ((m.x >> 3) & mm[1]) | fld[1]),
        __uint_as_float(((m.y << 16) & 0x80000000u) | ((m.y << 13) & mm[2]) | fld[2]),
        __uint_as_float((m.y & 0x80000000u) | ((m.y >> 3) & mm[3]) | fld[3]));
    if (CHECK && k >= K) w = make_float4(0.f, 0.f, 0.f, 0.f);
    ++k;
    if (++rem == n_group) {                            // next exponent group
      rem = 0;
      ++g;
      if (i + 1 < 8 && (!CHECK || k < K)) fields();    // a row of this stage follows
    }
    return w;
  }
};

// Does row p of a landed fp32 x tile hold an inf or NaN?
__device__ __forceinline__ bool x_row_nonfinite(const float* xs, int p) {
  uint32_t bad = 0u;
#pragma unroll
  for (int j = 0; j < TBK; j += 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(xs + p * TileSmem<float>::XP + j);
    bad |= ((v.x & 0x7F800000u) == 0x7F800000u) | ((v.y & 0x7F800000u) == 0x7F800000u) |
           ((v.z & 0x7F800000u) == 0x7F800000u) | ((v.w & 0x7F800000u) == 0x7F800000u);
  }
  return bad != 0u;
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// The A fragment of one m16n8k8 tile (PTX ISA, .tf32: a0..a3 = A[g][t],
// A[g+8][t], A[g][t+4], A[g+8][t+4]) from p = &x_tile[g][t], split into
// hi and lo. fp32 x: two TF32 parts. GUARD (the stage holds an inf or NaN
// x): where x - hi is NaN, lo = 0, so hi alone carries the inf or NaN.
template <int XP, bool GUARD>
__device__ __forceinline__ void a_frag(const float* p, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float v[4] = {p[0], p[8 * XP], p[4], p[8 * XP + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = tf32_rna(v[i]);
    const float r = v[i] - __uint_as_float(hi[i]);
    lo[i] = !GUARD || r == r ? tf32_rna(r) : 0u;
  }
}

// bf16 x: exact in TF32, so lo = 0. Its lo product adds zeros; it keeps the
// fp32 path's code and registers (without it the compiler hoists more loads
// and spills).
template <int XP, bool GUARD>
__device__ __forceinline__ void a_frag(const uint16_t* p, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  const uint16_t v[4] = {p[0], p[8 * XP], p[4], p[8 * XP + 4]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = static_cast<uint32_t>(v[i]) << 16;
    lo[i] = 0u;
  }
}

// +-inf lanes of a W fragment set to 0 (for the lo product)
__device__ __forceinline__ uint32_t inf_to_zero(uint32_t w) {
  return (w & 0x7FFFFFFFu) == 0x7F800000u ? 0u : w;
}

// d = a b + d on the tensor cores: m16n8k8, TF32 operands, fp32 accumulator
// (b0, b1 = B[t][g], B[t+4][g]; d0..d3 = D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1]).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b (a zero accumulator: the first MMA of a sum)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// Half h (16 rows) of a K stage of a consumer warp's 32 x 64 tile. x's
// fragments are split once; then for each of the 8 n8 columns of tiles the
// two m16 rows' products go into zeroed fragments (hi then lo for each
// 8-row step: 4 MMAs a sum), which are added to acc (the promotion: the
// tensor cores align and truncate inside an MMA, so no sum runs across more
// than 16 rows of K). SPECIAL: the stage holds an inf weight or a
// non-finite x: the lo product takes W with its inf lanes set to 0, and
// lo = 0 where x - hi is NaN.
template <typename XT, bool SPECIAL>
__device__ __forceinline__ void tile_consume_half(float (&acc)[TMT][TNT][4], const XT* xs,
                                                  const float* wb, int g, int t, int h) {
  constexpr int XP = TileSmem<XT>::XP, KH = 2;         // 8-row steps a half
  uint32_t hi[TMT][KH][4], lo[TMT][KH][4];
#pragma unroll
  for (int mt = 0; mt < TMT; ++mt)
#pragma unroll
    for (int kk = 0; kk < KH; ++kk)
      a_frag<XP, SPECIAL>(xs + (mt * 16 + g) * XP + (h * KH + kk) * 8 + t, hi[mt][kk],
                          lo[mt][kk]);
#pragma unroll
  for (int nt = 0; nt < TNT; ++nt) {
    uint32_t b[KH][2];
#pragma unroll
    for (int kk = 0; kk < KH; ++kk) {
      const float* bp = wb + ((h * KH + kk) * 8 + t) * TWP + nt * 8 + g;
      b[kk][0] = __float_as_uint(bp[0]);
      b[kk][1] = __float_as_uint(bp[4 * TWP]);
    }
    float st[TMT][4];
#pragma unroll
    for (int kk = 0; kk < KH; ++kk) {
#pragma unroll
      for (int mt = 0; mt < TMT; ++mt) {
        if (kk == 0) mma_tf32_zero(st[mt], hi[mt][kk], b[kk][0], b[kk][1]);
        else mma_tf32(st[mt], hi[mt][kk], b[kk][0], b[kk][1]);
      }
#pragma unroll
      for (int mt = 0; mt < TMT; ++mt)
        mma_tf32(st[mt], lo[mt][kk], SPECIAL ? inf_to_zero(b[kk][0]) : b[kk][0],
                 SPECIAL ? inf_to_zero(b[kk][1]) : b[kk][1]);
    }
#pragma unroll
    for (int mt = 0; mt < TMT; ++mt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] += st[mt][q];
  }
}

// A K stage of a consumer warp: its two halves, unrolled for fp32 x; for
// bf16 x a loop (unrolled, the bf16 16-byte instantiation spills).
template <typename XT, bool SPECIAL>
__device__ __forceinline__ void tile_consume(float (&acc)[TMT][TNT][4], const XT* xs,
                                             const float* wb, int g, int t) {
  if (sizeof(XT) == 4) {
    tile_consume_half<XT, SPECIAL>(acc, xs, wb, g, t, 0);
    tile_consume_half<XT, SPECIAL>(acc, xs, wb, g, t, 1);
  } else {
#pragma unroll 1
    for (int h = 0; h < 2; ++h) tile_consume_half<XT, SPECIAL>(acc, xs, wb, g, t, h);
  }
}

// Barrier ids: 0 is __syncthreads; then FULL and EMPTY barriers for each of
// the two W tiles (producers -> consumers: stage s is landed and
// dequantized; consumers -> producers: stage s is done, so its W tile and
// the raw slot that stage s + TRS takes may be refilled), and one among the
// producers.
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PROD = 5;

template <typename XT, bool VEC>
__global__ void __launch_bounds__(TNTH, 1)
bfp_matmul_tc_kernel(const XT* __restrict__ x, const uint16_t* __restrict__ man,
                     const uint8_t* __restrict__ expw, float* __restrict__ out, int M,
                     int K, int N, int n_group) {
  using S = TileSmem<XT>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* wt = reinterpret_cast<float*>(smem + S::W_OFF);            // [2][TBK][TWP]
  int* special = reinterpret_cast<int*>(smem + S::F_OFF);           // stage + 1, or stale
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * TBM, n0 = blockIdx.y * TBN;            // M fastest
  const int n_k = (K + TBK - 1) / TBK;
  if (tid < 2) special[tid] = 0;
  __syncthreads();

  if (warp >= TCW) {
    // producers: keep TLOOK stages of copies in flight, dequantize each
    // landed stage into a W tile, flag it, hand it over
    const int p = tid - TCW * 32;
    const int dr = (p >> 5) * 8, dc = (p & 31) * 4;    // dequant share
#pragma unroll
    for (int s = 0; s < TLOOK; ++s) {
      if (s < n_k)
        tile_stage_load<XT, VEC>(smem + s * S::SLOT, x, man, expw, m0, n0, s * TBK, M, K, N,
                                 n_group, p);
      cp_async_commit();
    }
    for (int s = 0; s < n_k; ++s) {
      const uint8_t* slot = smem + (s % TRS) * S::SLOT;
      cp_async_wait<TLOOK - 1>();                      // stage s landed ...
      bar_sync(BAR_PROD, TPTH);                        // ... for every producer
      if (s >= 2) bar_sync(BAR_EMPTY + (s & 1), TNTH);   // stage s - 2 done
      const int sn = s + TLOOK;                        // its slot is stage s - 2's
      if (sn < n_k)
        tile_stage_load<XT, VEC>(smem + (sn % TRS) * S::SLOT, x, man, expw, m0, n0, sn * TBK,
                                 M, K, N, n_group, p);
      cp_async_commit();
      TileDequant dq(slot, S::M_OFF, S::E_OFF, s * TBK, dr, dc, K, n_group);
      float* w = wt + (s & 1) * S::W_TILE;
      if ((s + 1) * TBK <= K) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<float4*>(w + (dr + i) * TWP + dc) = dq.row<false>(i);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<float4*>(w + (dr + i) * TWP + dc) = dq.row<true>(i);
      }
      bool flag = dq.inf;
      if (sizeof(XT) == 4)       // a bf16 x has lo = 0 whatever it holds
        flag |= x_row_nonfinite(reinterpret_cast<const float*>(slot), p);
      if (flag) special[s & 1] = s + 1;
      bar_arrive(BAR_FULL + (s & 1), TNTH);
    }
    return;
  }

  // consumers: a 32 x 64 tile a warp, MMAs only
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp % TWM) * TMT * 16, wn = (warp / TWM) * TNT * 8;
  float acc[TMT][TNT][4];
#pragma unroll
  for (int i = 0; i < TMT; ++i)
#pragma unroll
    for (int j = 0; j < TNT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  for (int s = 0; s < n_k; ++s) {
    bar_sync(BAR_FULL + (s & 1), TNTH);
    const XT* xs = reinterpret_cast<const XT*>(smem + (s % TRS) * S::SLOT) + wm * S::XP;
    const float* wb = wt + (s & 1) * S::W_TILE + wn;
    if (special[s & 1] == s + 1) tile_consume<XT, true>(acc, xs, wb, g, t);
    else tile_consume<XT, false>(acc, xs, wb, g, t);
    if (s + 2 < n_k) bar_arrive(BAR_EMPTY + (s & 1), TNTH);
  }

  const bool pairs = (N & 1) == 0;                     // 8-byte aligned column pairs
#pragma unroll
  for (int mt = 0; mt < TMT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + mt * 16 + g + h * 8;
      if (row >= M) continue;
      float* orow = out + (size_t)row * N;
#pragma unroll
      for (int nt = 0; nt < TNT; ++nt) {
        const int col = n0 + wn + nt * 8 + 2 * t;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (pairs && col < N) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(v0, v1);
        } else {
          if (col < N) orow[col] = v0;
          if (col + 1 < N) orow[col + 1] = v1;
        }
      }
    }
}

template <int MR, typename XT>
void launch_narrow(const void* x, const void* man, const void* expw, void* out,
                   int M, int K, int N, int n_group, bool vec, cudaStream_t s) {
  const dim3 grid((N + NB - 1) / NB);
  const XT* xp = static_cast<const XT*>(x);
  const uint16_t* mp = static_cast<const uint16_t*>(man);
  const uint8_t* ep = static_cast<const uint8_t*>(expw);
  float* op = static_cast<float*>(out);
  if (vec)
    bfp_matmul_narrow_kernel<MR, XT, true><<<grid, NT, 0, s>>>(xp, mp, ep, op, M, K, N, n_group);
  else
    bfp_matmul_narrow_kernel<MR, XT, false><<<grid, NT, 0, s>>>(xp, mp, ep, op, M, K, N, n_group);
}

template <typename XT, bool VEC>
int launch_tile(const void* x, const void* man, const void* expw, void* out, int M, int K,
                int N, int n_group, cudaStream_t s) {
  auto kern = bfp_matmul_tc_kernel<XT, VEC>;
  constexpr int smem = TileSmem<XT>::TOTAL;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + TBM - 1) / TBM, (N + TBN - 1) / TBN);
  kern<<<grid, TNTH, smem, s>>>(static_cast<const XT*>(x), static_cast<const uint16_t*>(man),
                              static_cast<const uint8_t*>(expw), static_cast<float*>(out), M,
                              K, N, n_group);
  return (int)cudaGetLastError();
}

template <typename XT>
int launch(const void* x, const void* man, const void* expw, void* out, int M, int K, int N,
           int n_group, cudaStream_t s) {
  if (M <= 8) {
    // 8-byte mantissa loads need 8-byte aligned rows: N % 4 == 0
    const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(man) % 8 == 0;
    if (M == 1)
      launch_narrow<1, XT>(x, man, expw, out, M, K, N, n_group, vec, s);
    else if (M == 2)
      launch_narrow<2, XT>(x, man, expw, out, M, K, N, n_group, vec, s);
    else if (M <= 4)
      launch_narrow<4, XT>(x, man, expw, out, M, K, N, n_group, vec, s);
    else
      launch_narrow<8, XT>(x, man, expw, out, M, K, N, n_group, vec, s);
    return (int)cudaGetLastError();
  }
  // 16-byte copies: x rows, mantissa rows and exponent rows a whole number
  // of 16-byte chunks, and 16-byte aligned bases
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = K % (16 / (int)sizeof(XT)) == 0 && N % 16 == 0 && a16(x) && a16(man) &&
                   a16(expw);
  return vec ? launch_tile<XT, true>(x, man, expw, out, M, K, N, n_group, s)
             : launch_tile<XT, false>(x, man, expw, out, M, K, N, n_group, s);
}

}  // namespace

// x [M, K] (fp32, or bf16 when x_bf16), man uint16 [K, N], exp uint8
// [K / n_group, N] -> out f32 [M, N]. Returns -1 for arguments the kernel
// does not take, else cudaGetLastError() after the launch.
extern "C" int bfp_matmul(const void* x, int x_bf16, const void* man,
                          const void* expw, void* out, int M, int K, int N,
                          int n_group, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || n_group <= 0 || K % n_group != 0 ||
      (M > 8 && (N + TBN - 1) / TBN > 65535))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) return launch<uint16_t>(x, man, expw, out, M, K, N, n_group, s);
  return launch<float>(x, man, expw, out, M, K, N, n_group, s);
}
