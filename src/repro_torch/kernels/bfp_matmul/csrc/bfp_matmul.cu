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
//  * bfp_matmul_tile_kernel (M > 8). Bound: fp32 FMAs (no tensor cores, no
//    TF32: the product must agree with the fp32 reference to accumulation
//    order). Classic SIMT tiling: a 128 x 128 output tile per 256-thread
//    block, 8 x 8 outputs a thread in registers, K in chunks of 16 rows;
//    each chunk's x tile and dequantized W tile sit in one of two shared
//    stages (the W tile is dequantized once a chunk and read by 16 threads
//    a column). The next chunk's raw words are loaded into registers before
//    this chunk's FMAs and stored to the other stage after them, so global
//    latency hides behind the FMAs and a chunk costs one barrier.
//    M = 1024 at the unembed is 211 GFLOP: 3.15 ms at 67 TFLOP/s.
// Ragged M, N and K edges are masked (zeros fill the shared tiles), so no
// padded copies are made. x is fp32 or bf16 (widened at load).
// Simple by design: no cp.async / TMA pipeline, no tensor cores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;            // threads a block (both variants)
constexpr int NW = NT / 32;        // warps a block
// narrow variant
constexpr int NB = 128;            // columns a block: 4 a lane
constexpr int KC = NW * 32;        // rows a chunk: 32 a warp
constexpr int UNROLL = 8;          // mantissa loads issued before use
// tile variant
constexpr int TBM = 128, TBN = 128, TBK = 16;
constexpr int TXP = TBM + 4;       // padded x-tile row (16-byte aligned)
constexpr int TPT = TBM * TBK / NT;  // words of each tile a thread moves: 8

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

template <typename XT>
__global__ void __launch_bounds__(NT)
bfp_matmul_tile_kernel(const XT* __restrict__ x, const uint16_t* __restrict__ man,
                       const uint8_t* __restrict__ expw, float* __restrict__ out,
                       int M, int K, int N, int n_group, int ng_shift) {
  __shared__ __align__(16) float xs[2][TBK][TXP];     // x tiles, transposed
  __shared__ __align__(16) float ws[2][TBK][TBN];     // dequantized W tiles
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * TBM, n0 = blockIdx.x * TBN;
  // the next chunk's raw words, loaded into registers while this chunk's
  // FMAs run, converted and stored to the other shared stage after them
  XT xr[TPT];
  uint16_t mr[TPT];
  uint8_t er[TPT];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < TPT; ++i) {                   // x: 16 k of a row
      const int idx = tid + i * NT, gm = m0 + (idx >> 4), gk = k0 + (idx & 15);
      xr[i] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : XT(0);
    }
#pragma unroll
    for (int i = 0; i < TPT; ++i) {                   // W: coalesced along N
      const int idx = tid + i * NT, gk = k0 + (idx >> 7), gn = n0 + (idx & 127);
      const bool in = gk < K && gn < N;
      const int g = ng_shift >= 0 ? gk >> ng_shift : gk / n_group;
      mr[i] = in ? __ldg(man + (size_t)gk * N + gn) : uint16_t(0);
      er[i] = in ? __ldg(expw + (size_t)g * N + gn) : uint8_t(0);
    }
  };
  auto store = [&](int s, int k0) {
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int idx = tid + i * NT;
      xs[s][idx & 15][idx >> 4] = to_f32(xr[i]);
    }
#pragma unroll
    for (int i = 0; i < TPT; ++i) {
      const int idx = tid + i * NT, gk = k0 + (idx >> 7), gn = n0 + (idx & 127);
      // out-of-range words must read as 0.0, not 2^-15 (exponent field 0)
      ws[s][idx >> 7][idx & 127] =
          (gk < K && gn < N) ? dequant(mr[i], exp_field(er[i])) : 0.f;
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0, 0);
  __syncthreads();
  int s = 0;
  for (int k0 = 0; k0 < K; k0 += TBK) {
    const bool more = k0 + TBK < K;
    if (more) load(k0 + TBK);
#pragma unroll
    for (int kk = 0; kk < TBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&xs[s][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&xs[s][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[s][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[s][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store(s ^ 1, k0 + TBK);
    __syncthreads();                                  // one barrier a chunk
    s ^= 1;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
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

template <typename XT>
void launch(const void* x, const void* man, const void* expw, void* out, int M,
            int K, int N, int n_group, cudaStream_t s) {
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
    return;
  }
  int ng_shift = -1;                 // n_group a power of two: shift
  for (int b = 0; b < 31; ++b)
    if (n_group == 1 << b) ng_shift = b;
  const dim3 grid((N + TBN - 1) / TBN, (M + TBM - 1) / TBM);
  bfp_matmul_tile_kernel<XT><<<grid, NT, 0, s>>>(
      static_cast<const XT*>(x), static_cast<const uint16_t*>(man),
      static_cast<const uint8_t*>(expw), static_cast<float*>(out), M, K, N, n_group,
      ng_shift);
}

}  // namespace

// x [M, K] (fp32, or bf16 when x_bf16), man uint16 [K, N], exp uint8
// [K / n_group, N] -> out f32 [M, N]. Returns -1 for arguments the kernel
// does not take, else cudaGetLastError() after the launch.
extern "C" int bfp_matmul(const void* x, int x_bf16, const void* man,
                          const void* expw, void* out, int M, int K, int N,
                          int n_group, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || n_group <= 0 || K % n_group != 0 ||
      (M + TBM - 1) / TBM > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    launch<uint16_t>(x, man, expw, out, M, K, N, n_group, s);
  else
    launch<float>(x, man, expw, out, M, K, N, n_group, s);
  return (int)cudaGetLastError();
}
