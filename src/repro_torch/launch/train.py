"""Training launcher (port of ``repro/launch/train.py``).

  python -m repro_torch.launch.train --arch olmo-1b --rel-mode align \\
      --n-group 8 --index 2               # full width, on the card
  python -m repro_torch.launch.train --reduced --steps 3 --device cpu
  python -m repro_torch.launch.train --reduced --steps 4 --device cpu \\
      --checkpoint-dir /tmp/ckpt --checkpoint-every 2   # again: resumes
  python -m repro_torch.launch.train --arch musicgen-large --reduced \\
      --steps 3 --device cpu
  python -m repro_torch.launch.train --arch rwkv6-1.6b --reduced \\
      --steps 3 --device cpu --rel-mode cim --ber 1e-3 --inject dynamic

It runs on ``cuda`` unless ``--device cpu`` is given, and raises without a
card. ``--arch`` takes every registered config: olmo-1b, granite-3-8b,
codeqwen1.5-7b, command-r-35b, internvl2-76b, musicgen-large,
tinyvit-paper, rwkv6-1.6b, recurrentgemma-9b, qwen3-moe-235b-a22b and
dbrx-132b (a MoE's aux loss joins the loss). Weights come from
``torch.Generator(device).manual_seed(seed)``; a text arch trains on the
reference's ``MarkovLM`` (numpy, so the batches are the reference's), a
stub modality (internvl2's ``vision_stub``, musicgen's ``audio_stub``) on
``batches_for`` with seed ``seed + step``, as the reference's launcher.
``--rel-mode align`` trains exponent-aligned with frozen (exponent, sign)
projection at BER 0; ``cim`` with ``--inject dynamic`` and a BER corrupts
the weights before every step with the paper's Fig. 7 schedule
(:func:`repro_torch.core.deployment.training_fault_schedule`, drawn
through the CUDA kernel K4 on the card). ``--checkpoint-dir``
saves the state (and the data cursor) every ``--checkpoint-every`` steps
and at the end; a run pointed at a directory that holds a checkpoint
resumes from its latest step and consumes the batches the interrupted run
would have. ``--grad-compression`` compresses the gradient to int8 with
error feedback.

``--mesh DxM`` trains data-parallel over a ``("data", "model")`` mesh of
D x M ranks, one process a rank (``run_training(mesh=)``: replicated
state, the batch split over "data" when D divides it), with the mesh set
as the ambient one, so a MoE's all-to-all runs over "model" where the
reference's conditions hold; rank 0 prints and writes checkpoints::

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --reduced \
      --steps 3 --device cpu --mesh 2x2     # gloo ranks on the CPU
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --mesh 4x1 \
      --rel-mode cim --ber 1e-4 --inject dynamic --batch 32   # four cards

``--mesh 1x1`` runs without torchrun (a world-size-1 group).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs import RunConfig, get_config
from repro_torch.core.deployment import PolicyRule, ReliabilityPolicy
from repro_torch.data.synthetic import (ArchBatches, CheckpointableLoader,
                                        MarkovLM)
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shlib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import lm
from repro_torch.training.loop import run_training


def build_argparser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config of the same family")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--d-model", type=int, default=0, help="override width")
    ap.add_argument("--n-layers", type=int, default=0, help="override depth")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--log-jsonl", default="")
    ap.add_argument("--rel-mode", default="off", choices=["off", "align", "cim"])
    ap.add_argument("--n-group", type=int, default=8)
    ap.add_argument("--index", type=int, default=2)
    ap.add_argument("--ber", type=float, default=0.0)
    ap.add_argument("--protect", default="one4n",
                    choices=["one4n", "per_weight", "none"])
    ap.add_argument("--inject", default="dynamic", choices=["static", "dynamic"])
    ap.add_argument("--grad-compression", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for the plain versions")
    ap.add_argument("--mesh", default="", metavar="DxM",
                    help="data-parallel over a D x M ('data', 'model') mesh "
                         "(under torchrun; the MoE all-to-all over 'model')")
    return ap


def main(argv=None):
    args = build_argparser().parse_args(argv)
    mesh = None
    if args.mesh:
        # the mesh first: under torchrun it binds this process to its card
        mesh = mesh_lib.make_serve_mesh(
            args.mesh, "cuda" if args.device is None
            or torch.device(args.device).type == "cuda" else "cpu")
    dev = resolve_device(args.device)
    lead = mesh is None or torch.distributed.get_rank() == 0
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    overrides = {}
    if args.d_model:
        overrides["d_model"] = args.d_model
    if args.n_layers:
        overrides["n_layers"] = args.n_layers
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)

    # the flags build a uniform single-rule policy; --rel-mode align trains
    # aligned but fault-free (ber 0)
    rel_kw = {}
    if args.rel_mode != "off":
        rel_kw = dict(
            policy=ReliabilityPolicy(default=PolicyRule(
                protect=args.protect, n_group=args.n_group,
                index=args.index)),
            ber=args.ber if args.rel_mode == "cim" else 0.0,
            inject=args.inject)
    run = RunConfig(steps=args.steps, learning_rate=args.lr,
                    seed=args.seed, checkpoint_dir=args.checkpoint_dir,
                    checkpoint_every=args.checkpoint_every,
                    grad_compression=args.grad_compression, remat=False,
                    **rel_kw)
    if cfg.modality == "text":
        source = MarkovLM(cfg.vocab_size, args.seq, args.batch,
                          seed=args.seed)
    else:
        source = ArchBatches(cfg, args.batch, args.seq, seed=args.seed)
    batches = CheckpointableLoader(source)
    logf = open(args.log_jsonl, "a") if args.log_jsonl else None

    def log(step, metrics):
        if lead and (step % 10 == 0 or step == run.steps - 1):
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"acc {metrics['accuracy']:.3f} "
                  f"gnorm {metrics['grad_norm']:.2f} "
                  f"{metrics['step_time']*1e3:.0f} ms")
        if logf and lead:
            logf.write(json.dumps(metrics) + "\n")

    try:
        with shlib.use_mesh(mesh):
            res = run_training(cfg, run, batches, log_fn=log, device=dev,
                               mesh=mesh)
    finally:
        if logf:
            logf.close()
    if not lead:
        return res
    n = lm.param_count(res.state.params)
    print(f"done: {len(res.history)} steps, {n/1e6:.2f}M params, "
          f"resumed_from={res.info['resumed_from']}, "
          f"stragglers={res.info['stragglers_flagged']}")
    if args.rel_mode == "cim":
        stats = res.ecc_stats
        print(f"deployment: {stats['stored_bits']} stored bits "
              f"({stats['overhead']:+.1%} vs raw fp16)")
    return res


if __name__ == "__main__":
    main()
