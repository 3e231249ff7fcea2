#!/usr/bin/env python3
"""Where K3's burst kernel spends its time: stripped variants, timed.

  python3 tools/k3_stripped.py          # from the repository root, one CUDA card

Builds ``fault_inject.cu`` as it is and with parts of
``fault_inject_burst_tile_kernel`` cut out (by text substitution into
copies under the git-ignored ``build/k3_stripped/``, one nvcc each, all
started together), then times each through the C entry on the Fig. 6
unembed mantissa plane ([2048, 50304] uint16, T = 4, BER 1e-3, 10
positions) under burst row / col (rate 0.25, length 4), bank (length 8)
and Fig. 6's rate 0.5 row burst, with CUDA events. The variants compute
wrong outputs on purpose; only their times mean anything:

* ``full``: the kernel as committed;
* ``no_draws``: the position loop left out (no mask is drawn): the tile
  loads, the lists, the decode, the stores and the barriers;
* ``no_store``: the copies are not written (the masks still cleared);
* ``all_live``: every unit live, so every element draws: the draws at the
  i.i.d. kernel's density, through the tile's machinery.

Prints ptxas's registers and spills of each variant's uint16 burst
instantiation, one line per variant and process, and the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from chip_timing import ROOT, card, time_ms

sys.path.insert(0, str(ROOT / "src"))

K, J, T = 2048, 50304, 4
SPECS = ("burst:rate=0.25,length=4,axis=row",
         "burst:rate=0.25,length=4,axis=col",
         "burst:rate=0.25,length=8,axis=bank", "burst:rate=0.5,length=4")
DRAW_LOOP = """  for (int p = lo; p <= hi; ++p) {
    if (!((lanes >> p) & 1u)) continue;
    const uint32_t bit = 1u << p;
#pragma unroll
    for (int u = 0; u < U; ++u)   // ctr32 has its low 5 bits clear: | is +
      if (hash_u32((ctr32[u] | (uint32_t)p) ^ seed_mul) < threshold) mask[u] |= bit;
  }
"""
STORE = "          *reinterpret_cast<Pack<W, VEC>*>(out_t + row * bt.cols + col) = o;\n"
LIVE_ROW = "hash_u32(row_key ^ useed) < bt.m_thr"
LIVE_COL = "hash_u32((row_key + cu_lo + sm.ucol[c]) ^ useed) < bt.m_thr"


def _cut(src: str, what: str, by: str) -> str:
    assert src.count(what) == 1, f"{what!r} is not in the source once"
    return src.replace(what, by)


def variants(src: str) -> dict:
    """name -> the source with that part cut out."""
    keep_mask = "  for (int u = 0; u < U; ++u) mask[u] |= ctr32[u] & 0u;\n"
    return {
        "full": src,
        "no_draws": _cut(src, DRAW_LOOP, keep_mask),
        "no_store": _cut(src, STORE, "          (void)o;\n"),
        "all_live": _cut(_cut(src, LIVE_ROW, "(hash_u32(row_key ^ useed) | 1u)"),
                         LIVE_COL, "(hash_u32((row_key + cu_lo + sm.ucol[c]) "
                                   "^ useed) | 1u)"),
    }


def _build(name: str, src: str, out_dir: Path):
    from repro_torch.kernels import nvcc
    from repro_torch.kernels.fault_inject import kernel
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


def _ptxas(log: str) -> str:
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and "burst_tile_kernelItLi8" in ln:
            return " ".join(x.split(":", 1)[-1].strip()
                            for x in lines[i + 2:i + 4])
    return "not found"


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("k3_stripped: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.core import faultmodels as fm
    from repro_torch.kernels.fault_inject import kernel, ops
    from repro_torch.kernels.nvcc import check_rc, stream_of
    out_dir = ROOT / "build" / "k3_stripped"
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = variants((kernel.CSRC / "fault_inject.cu").read_text())
    with ThreadPoolExecutor(len(srcs)) as pool:
        libs = dict(zip(srcs, pool.map(lambda kv: _build(kv[0], kv[1], out_dir),
                                       srcs.items())))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(29)
    plane = torch.randint(-2 ** 15, 2 ** 15, (K, J), generator=gen,
                          dtype=torch.int64, device=dev).to(torch.int16) \
        .view(torch.uint16)
    seeds = torch.from_numpy(np.asarray([0x1234567, 0xDEADBEEF, 7, 2 ** 31 + 11],
                                        np.uint32).view(np.int32)).to(dev)
    out = torch.empty((T, K, J), dtype=plane.dtype, device=dev)
    thr = ops.ber_to_threshold(1e-3)
    for name, (lib, log) in libs.items():
        print(f"ptxas: {name}: {_ptxas(log)}")
    for spec in SPECS:
        model = fm.parse_fault_model(spec)
        m_thr, m_len = fm.model_scalars(model)
        row = []
        for name, (lib, _) in libs.items():
            def call():
                check_rc(lib.fault_inject_batched(
                    plane.data_ptr(), out.data_ptr(), seeds.data_ptr(), T, K, J,
                    2, 0x3FF, thr, m_thr, m_len, 1,
                    kernel.MODEL_AXES[model.axis], 1, stream_of(plane)), name)
            row.append(f"{name} {time_ms(call):.4f}")
        print(f"k3_stripped: {spec}: " + ", ".join(row) + " ms")
    print(card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
