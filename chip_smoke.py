#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port starts and is right on the card.

  python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failed check raises and exits non-zero; no result is printed):

1. build the hand-written CUDA kernels K1 (cim_read_matmul_one4n) and K2
   (cim_read_matmul_raw) with nvcc for sm_90a;
2. hold each kernel against its plain PyTorch version at the full-width
   olmo-1b unembed shape (K=2048, J=50304, n_group=8): the identity probe
   gives the decoded weights exactly; a dense [4, 2048] input agrees within
   allclose(rtol=1e-4, atol=1e-4) (FMA and summation order); at BER 1e-3
   the identity probe on the plain-injected image gives its plain-decoded
   weights exactly (every SECDED correction checked bit for bit; a column
   that holds an inf or NaN weight comes out all non-finite, as 0 * inf is
   NaN), the dynamic kernel equals the same kernel on that image bit for bit,
   and the plain dynamic version within 1e-4 of |x| @ |W| (the bound of the
   summation-order error; faulted weights reach 2^15), NaN for NaN;
3. serve full-width olmo-1b (16 layers, d_model 2048, vocab 50304, fp32,
   weights from a seeded generator) through the port's lock-step launcher,
   batch 4, prompt 64, gen 32, in five arms; the launch counts are zeroed
   just before each arm and read just after it, and each dynamic arm must
   launch its kernel once per read (gen times); the clean fused and hbm arms must give
   equal greedy tokens; a reduced olmo-1b served through the kernels must
   match the port's plain CPU path;
4. time each kernel at the serving shape beside its plain version, one
   torch.matmul on the pre-decoded weights, and its memory bound.

Prints the card's name and power limit, then one ``{"kernels": [...]}``
line, and as its last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
K, J, N_GROUP = 2048, 50304, 8
BATCH, PROMPT, GEN = 4, 64, 32
TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOPS = 67e12               # H100 SXM, float32 outside the tensor cores
SOURCE = "src/repro_torch/kernels/cim_read/csrc/cim_read.cu"
REPLACES = {"cim_read_matmul_one4n": "src/repro/kernels/cim_read/kernel.py:381",
            "cim_read_matmul_raw": "src/repro/kernels/cim_read/kernel.py:428"}
PROTECT_OF = {"cim_read_matmul_one4n": "one4n", "cim_read_matmul_raw": "none"}


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"chip_smoke: {what}")


def _same_bits(a, b) -> bool:
    import torch
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _close(a, b, scale=None) -> tuple:
    """(close, max |a-b| over finite entries). NaN, +inf and -inf positions
    must match. Without ``scale``: allclose(rtol=TOL, atol=TOL). With
    ``scale`` = |x| @ |W| (the dot products' magnitude before cancellation,
    which bounds their summation-order error; the decoded weights themselves
    are checked exactly by the identity probe): |a-b| <= TOL * scale + TOL."""
    import torch
    fin = torch.isfinite(a)
    same = all(torch.equal(f(a), f(b)) for f in (
        torch.isfinite, torch.isnan, torch.isposinf, torch.isneginf))
    diff = (a[fin] - b[fin]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    if scale is None:
        ok = torch.allclose(a[fin], b[fin], rtol=TOL, atol=TOL)
    else:
        ok = bool((diff <= TOL * scale[fin] + TOL).all())
    return same and ok, err


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 5, inner: int = 10) -> float:
    """Median over ``reps`` of the device time of ``inner`` back-to-back
    calls between two CUDA events, per call (the queue stays full, so host
    overhead between launches does not count while it is shorter than a
    launch)."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    times.sort()
    return times[len(times) // 2]


def phase_build(kernel_lib) -> None:
    secs = kernel_lib.timed_build()
    regs = [ln.strip() for ln in kernel_lib.build_log.splitlines()
            if "registers" in ln or "Compiling entry" in ln]
    print(f"phase 1: built K1+K2 for sm_90a in {secs:.1f} s")
    for ln in regs:
        print(f"  ptxas: {ln}")


def _unembed_store(protect: str, dev):
    import torch
    from repro_torch.core import align, cim
    g = torch.Generator(device=dev).manual_seed(11)
    w = torch.randn((K, J), generator=g, device=dev) * 0.02
    w_al, _ = align.align_matrix(w, align.AlignmentConfig(n_group=N_GROUP))
    return cim.pack(w_al, cim.CIMConfig(n_group=N_GROUP, protect=protect))


def _identity_probe(name, store, w_ref, what) -> int:
    """``eye @ W`` through the kernel gives W exactly. Entries are compared
    by value (the kernel's f32 accumulator turns -0.0 into +0.0); a column
    that holds a non-finite weight must come out non-finite throughout.
    Returns the number of such columns."""
    import torch
    from repro_torch.kernels.cim_read import ops
    eye = torch.eye(store.shape[0], device=w_ref.device)
    out, info = ops.cim_linear_store(eye, store, with_info=True)
    _check(info["used_kernel"], f"{name}: kernel route not taken")
    fin = torch.isfinite(w_ref).all(0)
    _check(torch.equal(out[:, fin], w_ref[:, fin]),
           f"{name}: identity probe != read() on the {what} image")
    _check(not bool(torch.isfinite(out[:, ~fin]).any()),
           f"{name}: finite output in a column with a non-finite weight "
           f"({what} image)")
    return int((~fin).sum())


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version at the full unembed shape."""
    import torch
    from repro_torch.core import cim
    from repro_torch.kernels.cim_read import ops, ref
    from repro_torch.kernels.fault_inject.ops import ber_to_threshold
    results = {}
    seeds = {"man": 0x1234567, "meta": 0x89ABCDE, "cw": 0x2468ACE}
    thr = ber_to_threshold(1e-3)
    scalars = ops.make_scalars(seeds, thr, thr)
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((BATCH, K), generator=g, device=dev)
    for name, protect in PROTECT_OF.items():
        store = _unembed_store(protect, dev)
        w_ref, _ = cim.read(store)
        _check(bool(torch.isfinite(w_ref).all()), f"{name}: clean image "
               "decodes to a non-finite weight")
        _identity_probe(name, store, w_ref, "clean")
        got = ops.cim_linear_store(x, store)
        want, _ = ref.cim_read_ref(x, store)
        ok, err = _close(got, want)
        _check(ok, f"{name}: dense output vs plain (max err {err:.3e})")
        dyn = ops.cim_linear_store(x, store, scalars=scalars)
        injected = cim.inject_with_seeds(store, seeds, thr, thr)
        w_inj, _ = cim.read(injected)
        bad_cols = _identity_probe(name, injected, w_inj, "BER 1e-3")
        stat = ops.cim_linear_store(x, injected)
        _check(_same_bits(dyn, stat),
               f"{name}: dynamic kernel != kernel on the injected image")
        plain_dyn, st = ref.cim_read_ref(x, store, scalars)
        ok_dyn, err_dyn = _close(dyn, plain_dyn, x.abs() @ w_inj.abs())
        _check(ok_dyn, f"{name}: dynamic kernel vs plain (max err {err_dyn:.3e})")
        torch.cuda.synchronize()
        results[name] = {"store": store, "max_abs_err": err,
                         "max_abs_err_dynamic": err_dyn}
        print(f"phase 2: {name} ({protect}) identity exact on the clean and "
              f"the BER 1e-3 image ({bad_cols} columns hold a non-finite "
              f"weight), dense max err {err:.3e}, dynamic==static-injected "
              f"bitwise, dynamic vs plain max err {err_dyn:.3e}; BER 1e-3 "
              f"image corrected={st['corrected']} "
              f"uncorrectable={st['uncorrectable']}")
    return results


ARMS = (  # (label, serve_path, protect, inject, ber)
    ("a fused one4n dynamic", "fused", "one4n", "dynamic", 1e-4),
    ("b fused none dynamic", "fused", "none", "dynamic", 1e-4),
    ("c fused one4n static", "fused", "one4n", "static", 1e-4),
    ("d fused one4n static clean", "fused", "one4n", "static", 0.0),
    ("e hbm clean", "hbm", "one4n", "static", 0.0),
)


def phase_serve(dev, kernel_lib) -> dict:
    """The main path: full-width olmo-1b through the lock-step launcher."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models.lm import LM
    cfg = get_config("olmo-1b")
    model = LM(cfg, generator=torch.Generator(device=dev).manual_seed(0),
               device=dev)
    runs = {}
    for label, path, protect, inject, ber in ARMS:
        kernel_lib.reset_launch_counts()
        res = serve_lib.serve(model, batch=BATCH, prompt_len=PROMPT, gen=GEN,
                              seed=0, cim=True, ber=ber, protect=protect,
                              serve_path=path, inject=inject, verbose=False)
        _check(dict(kernel_lib.launch_counts) == res["launches"],
               f"{label}: launch counts {dict(kernel_lib.launch_counts)} != "
               f"the run's own {res['launches']}")
        runs[label] = res
        logits = res["prefill_logits"]
        _check(tuple(logits.shape) == (BATCH, cfg.vocab_size),
               f"{label}: logits shape {tuple(logits.shape)}")
        _check(res["tokens"].shape == (BATCH, GEN) and
               ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab_size)).all(),
               f"{label}: tokens out of range")
        print(f"phase 3: arm {label}: {res['tok_per_s']:.1f} tok/s, prefill "
              f"{res['prefill_s'] * 1e3:.1f} ms, ECC corrected="
              f"{res['ecc']['corrected']} uncorrectable="
              f"{res['ecc']['uncorrectable']}, launches {res['launches']}")
    # each kernel's launches on its own arm: K1 on arm a, K2 on arm b
    launches = {name: runs[label]["launches"][name] for name, label in
                (("cim_read_matmul_one4n", ARMS[0][0]),
                 ("cim_read_matmul_raw", ARMS[1][0]))}
    _check(all(v == GEN for v in launches.values()),
           f"a dynamic arm did not launch its kernel once per read: {launches}")
    clean, hbm = runs[ARMS[3][0]], runs[ARMS[4][0]]
    for res in (clean, hbm):
        _check(bool(torch.isfinite(res["prefill_logits"]).all()),
               "clean arm: non-finite logits")
    _check((clean["tokens"] == hbm["tokens"]).all(),
           "clean fused and hbm arms disagree on greedy tokens")
    _check(torch.allclose(clean["prefill_logits"], hbm["prefill_logits"],
                          rtol=TOL, atol=TOL), "clean fused vs hbm logits")
    print(f"phase 3: main-path launches {launches}; clean fused == hbm tokens")
    del model
    return launches


def phase_reduced_reference(dev) -> None:
    """A small input against a reference: reduced olmo-1b served on the card
    through the kernels equals the port's plain CPU path."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models.lm import LM
    cfg = get_config("olmo-1b").reduced()
    cpu = LM(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    gpu = LM(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    for protect in ("one4n", "none"):
        kw = dict(batch=2, prompt_len=8, gen=6, seed=1, cim=True, ber=1e-3,
                  protect=protect, inject="dynamic", verbose=False)
        a = serve_lib.serve(cpu, **kw)
        b = serve_lib.serve(gpu, **kw)
        _check(sum(b["launches"].values()) == kw["gen"],
               f"reduced {protect}: kernel not on the path")
        _check(np.array_equal(a["tokens"], b["tokens"]),
               f"reduced {protect}: card tokens != CPU plain tokens")
        ok, err = _close(a["prefill_logits"], b["prefill_logits"].cpu())
        _check(ok, f"reduced {protect}: logits vs CPU plain (max err {err:.3e})")
        print(f"phase 3: reduced olmo-1b {protect} dynamic: card == CPU plain "
              f"(tokens equal, logits max err {err:.3e})")


def phase_times(dev, checks: dict, launches: dict, card: str) -> list:
    import torch
    from repro_torch.core import cim
    from repro_torch.kernels.cim_read import ops, ref
    from repro_torch.kernels.fault_inject.ops import ber_to_threshold
    thr = ber_to_threshold(1e-4)
    scalars = ops.make_scalars({"man": 7, "meta": 8, "cw": 9}, thr, thr)
    x = torch.randn((BATCH, K), device=dev)
    rows = []
    for name, chk in checks.items():
        store = chk["store"]
        w, _ = cim.read(store)
        ms = _time_ms(lambda: ops.cim_linear_store(x, store, scalars=scalars))
        ms_static = _time_ms(lambda: ops.cim_linear_store(x, store))
        plain_ms = _time_ms(lambda: ref.cim_read_ref(x, store, scalars), inner=1)
        library_ms = _time_ms(lambda: torch.matmul(x, w))
        planes = [store.man, store.codewords, store.exp, store.sign]
        nbytes = sum(p.numel() * p.element_size() for p in planes if p is not None)
        nbytes += x.numel() * 4 + BATCH * J * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2.0 * BATCH * K * J / FP32_FLOPS * 1e3
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[name], "launches": launches[name],
                     "max_abs_err": chk["max_abs_err"], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "library_ms": library_ms, "static_ms": ms_static,
                     "bytes": nbytes})
        print(f"phase 4: {name}: {ms:.4f} ms dynamic, {ms_static:.4f} ms "
              f"static, plain {plain_ms:.3f} ms, torch.matmul on decoded "
              f"{library_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
              f"({nbytes / 1e6:.1f} MB) on {card}")
    return rows


def main() -> int:
    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "cim_read" / "csrc").is_dir():
        print("chip_smoke: the repro_torch sources are not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels.cim_read import kernel as kernel_lib
    dev = resolve_device("cuda")
    card = _card()
    t0 = time.perf_counter()
    phase_build(kernel_lib)
    checks = phase_kernels(dev)
    launches = phase_serve(dev, kernel_lib)
    phase_reduced_reference(dev)
    rows = phase_times(dev, checks, launches, card)
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s after the build start")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
