#!/usr/bin/env python3
"""The card's ceiling for the warp-level tensor-core MMAs that K5's tile uses.

  python3 tools/mma_ceiling.py          # from the repository root, one CUDA card

Builds a small CUDA program (its source is below; nvcc for sm_90a into the
git-ignored ``build/mma_ceiling/``) whose warps issue nothing but
``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`` on registers, 8 to 32
independent accumulators a warp, 1 to 4 blocks an SM, and times each launch
with CUDA events; the bf16 ``m16n8k16`` form beside it for scale. Prints
TFLOP/s per configuration, then the card's name and power limit. The
published dense TF32 peak (495 TFLOP/s) is reached only through ``wgmma``;
this is what ``mma.sync`` gets.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SOURCE = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

template <int NACC>
__global__ void mma_tf32(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + (threadIdx.x << 13);
  b[0] = 0x3f000000u;
  b[1] = 0x3e800000u;
  float d[NACC][4];
  for (int j = 0; j < NACC; ++j)
    for (int q = 0; q < 4; ++q) d[j][q] = 0.f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < NACC; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < NACC; ++j)
    for (int q = 0; q < 4; ++q) s += d[j][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void mma_bf16(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f803f80u;
  b[0] = 0x3f003f00u;
  b[1] = 0x3e803e80u;
  float d[16][4];
  for (int j = 0; j < 16; ++j)
    for (int q = 0; q < 4; ++q) d[j][q] = 0.f;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < 16; ++j)
    for (int q = 0; q < 4; ++q) s += d[j][q];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

template <typename F>
void run(const char* name, F kern, int blocks, int threads, double flop_per_mma, int nacc,
         float* out) {
  const int iters = 4096;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  kern<<<blocks, threads>>>(out, iters);
  cudaEventRecord(a);
  for (int r = 0; r < 5; ++r) kern<<<blocks, threads>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  ms /= 5;
  const double flops = flop_per_mma * nacc * iters * (double)blocks * threads / 32;
  printf("mma_ceiling: %s, %d blocks of %d threads: %.3f ms, %.1f TFLOP/s (%s)\n", name,
         blocks, threads, ms, flops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
}

int main() {
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  float* out;
  cudaMalloc(&out, (size_t)sms * 4 * 1024 * sizeof(float));
  for (int per_sm : {1, 2, 4})
    for (int threads : {128, 256})
      run("tf32 m16n8k8 x16", mma_tf32<16>, sms * per_sm, threads, 2048.0, 16, out);
  run("tf32 m16n8k8 x8", mma_tf32<8>, sms, 256, 2048.0, 8, out);
  run("tf32 m16n8k8 x32", mma_tf32<32>, sms, 256, 2048.0, 32, out);
  run("bf16 m16n8k16 x16", mma_bf16, sms * 2, 256, 4096.0, 16, out);
  return 0;
}
"""


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import nvcc
    out_dir = ROOT / "build" / "mma_ceiling"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, exe = out_dir / "mma_ceiling.cu", out_dir / "mma_ceiling"
    cu.write_text(SOURCE)
    subprocess.run([nvcc.nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(exe), str(cu)], check=True)
    subprocess.run([str(exe)], check=True, timeout=300)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
