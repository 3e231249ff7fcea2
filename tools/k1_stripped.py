#!/usr/bin/env python3
"""Where K1's narrow kernel spends its time: stripped variants, timed.

  python3 tools/k1_stripped.py          # from the repository root, one CUDA card

Builds the narrow kernel of ``src/repro_torch/kernels/cim_read/csrc/
cim_read.cu`` as it is and with parts cut out (by text substitution into
copies under the git-ignored ``build/k1_stripped/``, one nvcc each, all
started together), then times each on the full-width olmo-1b unembed image
(K = 2048, J = 50304, one4n, n_group 8) at M = 4, static and dynamic (BER
1e-4), with CUDA events. The variants compute wrong outputs on purpose; only
their times mean anything:

* ``full``: the kernel as committed;
* ``no_decode``: no codeword is decoded (the payload strings stay zero);
* ``no_math``: no weight is rebuilt or multiplied (the mantissa, sign and
  exponent words are still read, and folded into one accumulator);
* ``stream``: neither: what is left is the cp.async ring, its barriers and
  the final reduction, the design's own floor for the bytes;
* ``no_cw_flips`` / ``no_man_flips`` (dynamic only): the codeword or the
  mantissa draws left out.

Prints ptxas's registers and shared memory of each narrow instantiation of
the committed kernel, one line per variant, and the card's name and power
limit.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

K, J, M = 2048, 50304, 4
DECODE_LOOP = "      for (int i = tid; i < n_cw; i += NR_NT)\n"
MATH_START = "#pragma unroll\n      for (int q = 0; q < NR_COLS; ++q) {\n" \
             "        const uint32_t word = mv[q >> 1];\n"
MATH_END = "        for (int m = 0; m < MP; ++m) acc[m][q] = fmaf(xv[m], wv, acc[m][q]);\n" \
           "      }\n"
FOLD = "      acc[0][0] += __uint_as_float(mv[0] ^ mv[1] ^ mv[2] ^ mv[3] ^ sb ^ ef[0]) " \
       "* xv[0];\n"
CW_FLIP = "w[q] ^= flip_mask(celem + q, seed_cw, t, geo.code_mask[q]);"
MAN_FLIP = "const uint32_t f = flip_mask<0x3FFu>(e + q, seed_man, mm.thr(q, thr_man));"
KINDS = {"0": "", "1": " burst", "2": " correlated"}


def _variant(m) -> str:
    """'M4 dynamic' (i.i.d.), 'M4 dynamic burst', ... of a narrow kernel's
    template arguments (M rows, dynamic, fault-process kind)."""
    return (f"M{m.group(1)} {'dynamic' if m.group(2) == '1' else 'static'}"
            f"{KINDS[m.group(3)]}")


def _cut_math(src: str) -> str:
    a = src.index(MATH_START)
    b = src.index(MATH_END, a) + len(MATH_END)
    return src[:a] + FOLD + src[b:]


def _no_decode(src: str) -> str:
    assert src.count(DECODE_LOOP) == 1
    return src.replace(DECODE_LOOP, DECODE_LOOP.replace("i < n_cw", "i < 0"))


VARIANTS = {
    "full": lambda s: s,
    "no_decode": _no_decode,
    "no_math": _cut_math,
    "stream": lambda s: _cut_math(_no_decode(s)),
    "no_cw_flips": lambda s: s.replace(CW_FLIP, "(void)celem;"),
    "no_man_flips": lambda s: s.replace(MAN_FLIP, "const uint32_t f = 0u;"),
}


def _build(name: str, src: str, out_dir: Path):
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.cim_read import kernel
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


def _sass_census(lib_path: Path, family: str = "one4n") -> None:
    """Per narrow instantiation of ``family`` (``one4n``: K1, ``raw``: K2):
    SASS instructions, branches and the copies of the hash's first multiply
    (0x85EBCA6B) in the code, i.e. how far the draw loops were unrolled."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    name, counts = None, {}
    for ln in sass.splitlines():
        if "Function :" in ln:
            m = re.search(rf"{family}_narrow_kernelILi(\d)ELb(\d)ELi(\d)E", ln)
            name = _variant(m) if m else None
            if name:
                counts[name] = [0, 0, 0]
            continue
        if name and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s", ln):
            c = counts[name]
            c[0] += 1
            c[1] += " BRA" in ln
            c[2] += "-0x7a143595" in ln
    for name, (n, bra, muls) in sorted(counts.items()):
        print(f"sass: {family} narrow {name}: {n} instructions, {bra} "
              f"branches, {muls} hash bodies in the code")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k1_stripped: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core import align, cim
    from repro_torch.kernels.cim_read import kernel, ops
    from repro_torch.kernels.fault_inject.ops import ber_to_threshold
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    src = (ROOT / "src/repro_torch/kernels/cim_read/csrc/cim_read.cu").read_text()
    srcs = {name: f(src) for name, f in VARIANTS.items()}
    for name, s in srcs.items():
        assert name == "full" or s != src, f"variant {name} changed nothing"
    out_dir = ROOT / "build" / "k1_stripped"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(lambda kv: _build(*kv, out_dir),
                                        srcs.items())))
    for ln in built["full"][1].splitlines():
        m = re.search(r"\d(cim_read_(?:one4n_narrow|raw_narrow|one4n|raw)"
                      r"_kernel)(?:ILi(\d)ELb(\d)ELi(\d)E)?", ln)
        if "Compiling entry" in ln and m:
            v = re.search(r"ILi(\d)ELb(\d)ELi(\d)E", ln)
            print(f"ptxas: {m.group(1)}" + (f" {_variant(v)}" if v else ""))
        elif "registers" in ln or "spill" in ln:
            print(f"ptxas:   {ln.split(':', 1)[-1].strip()}")
    _sass_census(out_dir / "full.so")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    w = torch.randn((K, J), generator=g, device=dev) * 0.02
    w_al, _ = align.align_matrix(w, align.AlignmentConfig(n_group=8))
    store = cim.pack(w_al, cim.CIMConfig(n_group=8))
    del w, w_al
    x = torch.randn((M, K), generator=g, device=dev)
    thr = ber_to_threshold(1e-4)
    scalars = ops.make_scalars({"man": 7, "meta": 8, "cw": 9}, thr, thr)
    tiles = ops.resolve_tiles(store, M)
    codec, code = store.cfg.codec, store.cfg.codec.code
    args = dict(k_log=K, n_out=J, n_group=8, row_weights=16,
                n_segments=codec.n_segments, code_words=codec.codeword_words,
                segment_bits=codec.segment_bits, n_body=code.n_body, r=code.r,
                tables=ops.narrow_tables(code), man_bits=10, exp_bits=5,
                bias=15, x_slab=tiles["x_slab"], smem_bytes=tiles["smem_bytes"],
                store_g=J // 16, store_j=J)

    def timed(lib, dynamic, reps=5, inner=10):
        saved = kernel.LIBRARY._lib
        kernel.LIBRARY._lib = lib
        try:
            def call():
                kernel.cim_read_matmul_one4n_narrow(
                    x, store.man, store.codewords,
                    scalars if dynamic else ops.make_scalars(),
                    dynamic=dynamic, **args)
            for _ in range(3):
                call()
            times = []
            for _ in range(reps):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(inner):
                    call()
                b.record()
                b.synchronize()
                times.append(a.elapsed_time(b) / inner)
            return sorted(times)[reps // 2]
        finally:
            kernel.LIBRARY._lib = saved

    nbytes = store.man.numel() * 2 + store.codewords.numel() * 4
    print(f"k1_stripped: narrow K1 at M = {M}, [{K}, {J}] one4n, "
          f"{nbytes / 1e6:.1f} MB of planes ({nbytes / 3.35e12 * 1e3:.4f} ms "
          f"at 3.35 TB/s); tiles {tiles}; on {card}")
    for name, (lib, _) in built.items():
        static = timed(lib, False) if not name.startswith("no_") or \
            name in ("no_decode", "no_math") else None
        dynamic = timed(lib, True)
        print(f"k1_stripped: {name:13s} static "
              + (f"{static:.4f} ms" if static is not None else "   -     ")
              + f"  dynamic {dynamic:.4f} ms")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
