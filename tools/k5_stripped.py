#!/usr/bin/env python3
"""Where K5's tile variant spends its time: stripped variants, timed.

  python3 tools/k5_stripped.py          # from the repository root, one CUDA card

Builds K5 (``src/repro_torch/kernels/bfp_matmul/csrc/bfp_matmul.cu``) as it
is and with parts of its tile variant (``bfp_matmul_tc_kernel``) cut out, by
text substitution into copies under the git-ignored ``build/k5_stripped/``
(one nvcc each, all started together), then times each through the binding
at phase 9's call: M = 1024 fp32 rows against BFP planes of the full-width
olmo-1b unembed (K = 2048, N = 50304, n_group 8, random aligned weights),
with CUDA events. Variants:

* ``full``: the kernel as committed;
* ``hi_only``: the consumers' lo product left out (one MMA a tile and step;
  its output is wrong, timing only);
* ``no_dequant``: the producers store the raw mantissa words as W (no
  exponent field, no sign or mantissa placement; the ring, the exponent
  reads and the W tile stores stay);
* ``no_mma``: no MMA at all: the producers' ring, dequantization and scan,
  the hand-over barriers and the epilogue;
* ``no_promote``: every MMA accumulates straight into the fp32 accumulator,
  without the zeroed 16-row sums and their FADDs (right, but with the
  tensor cores' truncation across all of K).

Prints each variant's registers and spills (ptxas, the fp32 16-byte
instantiation that is timed), its time, and for ``full`` and ``no_promote``
the max abs error against a float64 product beside torch.matmul's (fp32,
TF32 off); then the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

M, K, N, N_GROUP = 1024, 2048, 50304, 8
HI = "mma_tf32(st[mt], hi[mt][kk], b[kk][0], b[kk][1]);"
HI0 = "mma_tf32_zero(st[mt], hi[mt][kk], b[kk][0], b[kk][1]);"
LO = "mma_tf32(st[mt], lo[mt][kk],"
DEQUANT = (
    "    float4 w = make_float4(\n"
    "        __uint_as_float(((m.x << 16) & 0x80000000u) | ((m.x << 13) & mm[0]) | fld[0]),\n"
    "        __uint_as_float((m.x & 0x80000000u) | ((m.x >> 3) & mm[1]) | fld[1]),\n"
    "        __uint_as_float(((m.y << 16) & 0x80000000u) | ((m.y << 13) & mm[2]) | fld[2]),\n"
    "        __uint_as_float((m.y & 0x80000000u) | ((m.y >> 3) & mm[3]) | fld[3]));\n")
RAW = ("    float4 w = make_float4(__uint_as_float(m.x << 16), __uint_as_float(m.x & 0xFFFF0000u),\n"
       "                           __uint_as_float(m.y << 16), __uint_as_float(m.y & 0xFFFF0000u));\n")
PROMOTE = "acc[mt][nt][q] += st[mt][q];"
ZERO = "st[mt][0] = st[mt][1] = st[mt][2] = st[mt][3] = 0.f;"


def _cut(src: str, what: str, by: str) -> str:
    assert src.count(what) == 1, f"{what!r} is not in the source once"
    return src.replace(what, by)


def _no_mma(src: str) -> str:
    src = _cut(src, LO, f"if (false) {LO}")
    src = _cut(src, f"if (kk == 0) {HI0}", f"if (kk == 0) {ZERO}")
    return _cut(src, f"else {HI}", "")


def _no_promote(src: str) -> str:
    src = _cut(src, HI0, HI)
    src = _cut(src, f"else {HI}", f"else {HI.replace('st[mt]', 'acc[mt][nt]')}")
    src = _cut(src, f"if (kk == 0) {HI}", f"if (kk == 0) {HI.replace('st[mt]', 'acc[mt][nt]')}")
    src = _cut(src, LO, LO.replace("st[mt]", "acc[mt][nt]"))
    return _cut(src, PROMOTE, ";")


VARIANTS = {
    "full": lambda s: s,
    "hi_only": lambda s: _cut(s, LO, f"if (false) {LO}"),
    "no_dequant": lambda s: _cut(s, DEQUANT, RAW),
    "no_mma": _no_mma,
    "no_promote": _no_promote,
}


def _build(name: str, src: str, out_dir: Path):
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.bfp_matmul import kernel
    cu = out_dir / f"{name}.cu"
    cu.write_text(src)
    lib_path = out_dir / f"{name}.so"
    cmd = [nvcc.nvcc(), *nvcc.NVCC_FLAGS, "-I", str(nvcc.COMMON_CSRC), "-o",
           str(lib_path), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    kernel._bind(lib)
    return lib, proc.stdout + proc.stderr


def _tile_usage(log: str) -> str:
    """Registers and spills of the fp32, 16-byte tile instantiation."""
    inside, found = False, []
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            inside = "bfp_matmul_tc_kernelIfLb1E" in ln
        elif inside and ("spill" in ln or "registers" in ln):
            found.append(ln.split(":", 1)[-1].strip())
    return "; ".join(found)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k5_stripped: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core import align
    from repro_torch.device import resolve_device
    from repro_torch.kernels.bfp_matmul import kernel, ref
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    src = (ROOT / "src/repro_torch/kernels/bfp_matmul/csrc/bfp_matmul.cu").read_text()
    srcs = {name: f(src) for name, f in VARIANTS.items()}
    for name, s in srcs.items():
        assert name == "full" or s != src, f"variant {name} changed nothing"
    out_dir = ROOT / "build" / "k5_stripped"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(lambda kv: _build(*kv, out_dir),
                                        srcs.items())))

    dev = resolve_device("cuda")                  # fp32 matmuls with TF32 off
    g = torch.Generator(device=dev).manual_seed(11)
    w = torch.randn((K, N), generator=g, device=dev) * 0.02
    w_al, _ = align.align_matrix(w, align.AlignmentConfig(n_group=N_GROUP))
    man, exp = ref.pack_bfp(w_al, N_GROUP)
    del w
    x = torch.randn((M, K), generator=g, device=dev)
    want = x.double() @ w_al.double()
    lib_err = float((torch.matmul(x, w_al).double() - want).abs().max())

    def call(lib):
        saved = kernel.LIBRARY._lib
        kernel.LIBRARY._lib = lib
        try:
            return kernel.bfp_matmul(x, man, exp, n_group=N_GROUP)
        finally:
            kernel.LIBRARY._lib = saved

    def timed(lib, reps=5, inner=10):
        for _ in range(3):
            call(lib)
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                call(lib)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / inner)
        return sorted(times)[reps // 2]

    products = 2.0 * M * K * N
    print(f"k5_stripped: tile K5 at M = {M}, K = {K}, N = {N}, n_group "
          f"{N_GROUP}, fp32 x: two TF32 products {2 * products / 1e9:.1f} "
          f"GFLOP ({2 * products / 495e12 * 1e3:.4f} ms at 495 TFLOP/s); "
          f"torch.matmul max err vs float64 {lib_err:.3e}; on {card}")
    for name, (lib, log) in built.items():
        ms = timed(lib)
        err = ""
        if name in ("full", "no_promote"):
            e = float((call(lib).double() - want).abs().max())
            err = f"  max err vs float64 {e:.3e} ({e / lib_err:.2f}x torch.matmul's)"
        print(f"k5_stripped: {name:10s} {ms:.4f} ms  "
              f"({2 * products / ms / 1e9:.1f} TFLOP/s of split products)"
              f"{err}  [{_tile_usage(log)}]")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
