#!/usr/bin/env python3
"""Where K2's narrow kernel spends its time: stripped variants, timed.

  python3 tools/k2_stripped.py          # from the repository root, one CUDA card

Builds K2's narrow kernel (``cim_read_raw_narrow_kernel`` of
``src/repro_torch/kernels/cim_read/csrc/cim_read.cu``) as it is and with
parts cut out (by text substitution into copies under the git-ignored
``build/k2_stripped/``, one nvcc each, all started together), then times each
on the full-width olmo-1b unembed image (K = 2048, J = 50304, protect none,
n_group 8) at M = 4, static and dynamic (BER 1e-4), with CUDA events. The
variants compute wrong outputs on purpose; only their times mean anything:

* ``full``: the kernel as committed;
* ``no_math``: no weight is rebuilt or multiplied (the mantissa, sign and
  exponent words are still read, and folded into one accumulator);
* ``stream``: no row is read at all and nothing is drawn: what is left is
  the cp.async ring, its barriers, the x slab and the final reduction, the
  design's own floor for the bytes;
* ``no_meta_flips`` / ``no_man_flips`` (dynamic only): the exponent and sign
  draws, or the mantissa draws, left out.

Prints ptxas's registers and spills of each narrow K2 instantiation of the
committed kernel, its SASS census, one line per variant, and the card's name
and power limit.
"""
from __future__ import annotations

import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

from k1_stripped import _build, _sass_census  # noqa: E402

K, J, M, N_GROUP = 2048, 50304, 4, 8
ROWS_LOOP = "    for (int i = 0; i < NR_ROWS; ++i) {\n" \
            "      const int kr = rg * NR_ROWS + i, gk = k0 + kr;\n" \
            "      if (gk >= p.K_log) break;"
MATH_START = "#pragma unroll\n      for (int q = 0; q < NR_COLS; ++q) {\n" \
             "        const uint32_t mword = mv[q >> 1];\n"
MATH_END = "        for (int m = 0; m < MP; ++m) acc[m][q] = fmaf(xv[m], wv, acc[m][q]);\n" \
           "      }\n"
FOLD = "      acc[0][0] += __uint_as_float(mv[0] ^ mv[1] ^ mv[2] ^ mv[3] ^ sg[0] ^ sg[7] " \
       "^ ef[0] ^ ef[7]) * xv[0];\n"
META_FLIP = "      raw_narrow_flip_meta<KIND>(es, ss, k0, c0, p, n_blocks, seed_meta, " \
            "seed_sign, thr_meta,\n                                 useed_meta, useed_sign);\n"
KINDS = {"0": "", "1": " burst", "2": " correlated"}
MAN_FLIP = "const uint32_t fm = flip_mask<0x3FFu>(elem + q, seed_man, mm.thr(q, thr_man));"


def _cut(src: str, what: str, by: str) -> str:
    assert src.count(what) == 1, f"{what!r} is not in the source once"
    return src.replace(what, by)


def _cut_math(src: str) -> str:
    a = src.index(MATH_START)
    b = src.index(MATH_END, a) + len(MATH_END)
    assert src.count(MATH_START) == 1
    return src[:a] + FOLD + src[b:]


def _stream(src: str) -> str:
    src = _cut(src, ROWS_LOOP, ROWS_LOOP.replace("i < NR_ROWS", "i < 0"))
    return _cut(src, META_FLIP, "")


VARIANTS = {
    "full": lambda s: s,
    "no_math": _cut_math,
    "stream": _stream,
    "no_meta_flips": lambda s: _cut(s, META_FLIP, ""),
    "no_man_flips": lambda s: _cut(s, MAN_FLIP, "const uint32_t fm = 0u;"),
}


def _ptxas_lines(log: str) -> None:
    """Registers and spills of each narrow K2 instantiation."""
    current = None
    for ln in log.splitlines():
        if "Compiling entry" in ln:
            m = re.search(r"cim_read_raw_narrow_kernelILi(\d)ELb(\d)ELi(\d)E", ln)
            current = (f"M{m.group(1)} "
                       f"{'dynamic' if m.group(2) == '1' else 'static'}"
                       f"{KINDS[m.group(3)]}") if m else None
            if current:
                print(f"ptxas: cim_read_raw_narrow_kernel {current}")
        elif current and ("registers" in ln or "spill" in ln):
            print(f"ptxas:   {ln.split(':', 1)[-1].strip()}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("k2_stripped: needs a CUDA card", file=sys.stderr)
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
    out_dir = ROOT / "build" / "k2_stripped"
    out_dir.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = dict(zip(srcs, pool.map(lambda kv: _build(*kv, out_dir),
                                        srcs.items())))
    _ptxas_lines(built["full"][1])
    _sass_census(out_dir / "full.so", family="raw")

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    w = torch.randn((K, J), generator=g, device=dev) * 0.02
    w_al, _ = align.align_matrix(w, align.AlignmentConfig(n_group=N_GROUP))
    store = cim.pack(w_al, cim.CIMConfig(n_group=N_GROUP, protect="none"))
    del w, w_al
    x = torch.randn((M, K), generator=g, device=dev)
    thr = ber_to_threshold(1e-4)
    scalars = ops.make_scalars({"man": 7, "meta": 8, "cw": 9}, thr, thr)
    tiles = ops.resolve_tiles(store, M)
    args = dict(k_log=K, n_out=J, n_group=N_GROUP, man_bits=10, exp_bits=5,
                bias=15, x_slab=tiles["x_slab"], smem_bytes=tiles["smem_bytes"],
                store_k=K, store_j=J)

    def timed(lib, dynamic, reps=5, inner=10):
        saved = kernel.LIBRARY._lib
        kernel.LIBRARY._lib = lib
        try:
            def call():
                kernel.cim_read_matmul_raw_narrow(
                    x, store.man, store.exp, store.sign,
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

    nbytes = sum(p.numel() * p.element_size()
                 for p in (store.man, store.exp, store.sign))
    draws = K * J * 10 + store.exp.numel() * 5 + store.sign.numel() * 32
    hash_ms = draws * 10 / 16.75e12 * 1e3
    print(f"k2_stripped: narrow K2 at M = {M}, [{K}, {J}] none, "
          f"{nbytes / 1e6:.1f} MB of planes ({nbytes / 3.35e12 * 1e3:.4f} ms "
          f"at 3.35 TB/s), {draws / 1e9:.3f} G draws ({hash_ms:.4f} ms at 10 "
          f"ALU-pipe ops, 16.75 T op/s); tiles {tiles}; on {card}")
    for name, (lib, _) in built.items():
        static = None if name.endswith("_flips") else timed(lib, False)
        dynamic = timed(lib, True)
        print(f"k2_stripped: {name:13s} static "
              + (f"{static:.4f} ms" if static is not None else "   -     ")
              + f"  dynamic {dynamic:.4f} ms")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
