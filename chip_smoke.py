#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port starts and is right on the card.

  python3 chip_smoke.py            # from the repository root, one CUDA card

Phases (any failed check raises and exits non-zero; no result is printed):

1. build the hand-written CUDA kernels with nvcc for sm_90a, one nvcc per
   source, started together: K1 (cim_read_matmul_one4n) and K2
   (cim_read_matmul_raw) from cim_read.cu, K3 (fault_inject_batched) and K4
   (fault_inject, over a run table) from fault_inject.cu, K5 (bfp_matmul)
   from bfp_matmul.cu; read K3's (i.i.d. and burst) and K4's hash bodies
   from the SASS (cuobjdump) and check every hash multiply is an IMAD, which
   the bound of
   phase 7 counts on the FMA pipe apart from the ALU work; read K5's tile
   instantiations' SASS and fail unless each holds TF32 HMMAs (tensor-core
   MMAs), and print every K5 instantiation's registers, failing on a spill;
2. hold each kernel against its plain PyTorch version at the full-width
   olmo-1b unembed shape (K=2048, J=50304, n_group=8): the identity probe
   at M = K (the tile kernel) gives the decoded weights exactly; a dense
   [4, 2048] input (the narrow kernel) agrees within
   allclose(rtol=1e-4, atol=1e-4) (FMA and summation order); at BER 1e-3
   the identity probe on the plain-injected image gives its plain-decoded
   weights exactly (every SECDED correction checked bit for bit; a column
   that holds an inf or NaN weight comes out all non-finite, as 0 * inf is
   NaN), the dynamic kernel equals the same kernel on that image bit for bit,
   and the plain dynamic version within 1e-4 of |x| @ |W| (the bound of the
   summation-order error; faulted weights reach 2^15), NaN for NaN. K1's
   and K2's narrow kernels (M <= 8) also run the identity probe in 8-row
   slices of eye(K) (256 launches) on both images, exact and equal to the
   tile's probe on every finite column; agree with the tile kernel at M =
   1, 3, 4 and 8 within allclose(1e-4, 1e-4) static and within 1e-4 of
   |x| @ |W| dynamic; and repeat their bits run to run. Then K1 and K2
   under each fault process of MODEL_SPECS (burst on the row, col and bank
   axes, correlated) at BER 1e-4: the dynamic identity probe through the
   tile (M = K) and the narrow kernel (8-row slices) gives the weights of
   the image cim.inject_with_seeds(..., model=) leaves exactly and equals
   the static read of that image bitwise; dense M = 4 within 1e-4 of
   |x| @ |W| of the plain version; narrow against tile at M = 1, 3, 4, 8;
   the image's flips a strict subset of the i.i.d. ones;
3. serve full-width olmo-1b (16 layers, d_model 2048, vocab 50304, fp32,
   weights from a seeded generator) through the port's lock-step launcher,
   batch 4, prompt 64, gen 32, in five arms; the launch counts are zeroed
   just before each arm and read just after it, and each dynamic arm must
   launch its kernel once per read (gen times), arm (a)'s K1 reads and arm
   (b)'s K2 reads through their narrow kernels (each read's
   info['tiles']); the clean fused and hbm arms must give equal greedy
   tokens; arms (a) and (b) again with --fault-model
   burst:rate=0.25,length=4,axis=col and drift:drift_rate=0.02 (counts
   zeroed before each, read after: one narrow launch a read); a reduced
   olmo-1b served through the kernels must match the port's plain CPU
   path;
4. hold K3/K4 against their plain versions on the card, bit for bit: the
   full-width one4n unembed image's mantissa and codeword planes and the
   none image's exponent and sign planes at T = 4 (BER 1e-3), a ragged
   [1000, 777] uint16 plane at thresholds 0 and 0xFFFFFFFF; K4 is driven
   through its entry point fault_inject_fp16 on the full-width unembed
   weights for each field (its main path: counts zeroed just before, read
   just after) at BER 1e-3, where its double threshold is one below the
   sweep's float32 one; K4's fused float32 round trip at threshold 0 on
   all 2^32 float32 bit patterns (16 planes of 2^28, one launch each)
   bitwise fp16_bits_to_f32(to_bits(x)) on the card, and on a plane of
   specials (signed zeros, subnormals, ties, values that round to inf,
   infinities, NaN payloads) at BER 1e-3, in place and not, bitwise its
   plain version; a plane of 2^27 + 1 elements must raise; K3 under
   each fault process of MODEL_SPECS and Fig. 6's burst on the one4n
   unembed's mantissa plane (uint16) and its flattened codeword plane
   (uint32, col_div = S*W), T = 4, bitwise against the plain version, its
   flips a strict subset of the i.i.d. flips at the same seeds; burst at
   rate 1 and 0 on the mantissa plane and on each axis on the ragged plane
   (length 5, col_div 3: units across the burst kernel's tile edges),
   bitwise; each call one K3 launch;
5. Fig. 6 on full-width olmo-1b: characterize_protection with arms none,
   per_weight and one4n (CIMConfig(n_group=8, index=2)), BERs 1e-5..1e-3,
   4 trials; eval is greedy-token agreement with the fault-free deployment
   over a 4x64 MarkovLM batch. Per arm the K3 count is zeroed just before
   and read just after, and must equal stores x planes x BERs; none
   corrects 0, one4n corrects > 0 at 1e-3; the one4n cells at 1e-5 (every
   trial: agreement varies there) and at 1e-3 (trial 0: the most ECC work)
   redone with the plain injection on the card give identical stores, ECC
   counts (their means equal to the row's at 1e-5) and agreement; a
   torch.profiler rerun of the one4n arm prints its top
   device kernels and their share of the arm's wall time; the one4n arm
   again with fault_models=("iid", "burst:rate=0.5,length=4") (K3 count
   checked): its iid arm's rows equal the default plan's value for value;
   the burst arm's 1e-3 draws on the same stores (the embed's and the
   unembed's mantissa and flattened codeword planes, one K3 launch a
   plane) bitwise the plain injection;
6. Fig. 2 on the CNN (seeded init_cnn, GaussianBlobs, 1024 images): all four
   fields, BERs 1e-6..1e-2, 8 trials, on the card (K3 count checked) and on
   the CPU; faulted leaves bitwise equal, accuracies within 1/1024 per cell;
7. time each kernel at its main-path shape beside its plain version and its
   bound: K1/K2 at the serving shape with one torch.matmul on the
   pre-decoded weights, each one's tile kernel at M = 4 beside its narrow
   one, the static read bound by bytes and the dynamic read by the larger of the
   bytes and its draws on the ALU pipe (10 ops a draw); each narrow dynamic
   read again under each fault process of MODEL_SPECS, with the draws it
   performs (a burst read draws only in its hit units) and their bound;
   K3 at the Fig. 6 unembed mantissa plane
   ([2048, 50304] uint16, T = 4, 10 positions; and under each fault
   process and Fig. 6's burst, there and on the flattened codeword plane,
   with its draws and bound) and K4 on the same plane's
   16 positions, and on float32 weights of its shape through the fused
   round trip (bound by the busier of its draws and 8 bytes an element)
   (no single PyTorch call computes their function), bound by
   the busier of the ALU pipe (10 ops a draw), the FMA pipe (2 IMADs a
   draw) and the bytes; K5 on the trained unembed's BFP planes at M = 4
   (decode-shaped, bound by bytes) and M = 1024 (the phase 9 batch, bound
   by its two TF32 products on the tensor cores, the fp32-FMA figure
   beside it), beside torch.matmul over the pre-dequantized matrix (TF32
   off); at M = 1024 K5's max abs error against a float64 product must be
   at most twice torch.matmul's;
8. train full-width olmo-1b (weights from a seeded generator) through
   run_training with a one-rule align policy (n_group 8, index 2) for 4
   steps of MarkovLM(vocab, 128, 8), the launcher's defaults: per-step loss,
   grad norm and ms, the peak device memory; every loss finite, and after
   the last step every aligned leaf's weights carry their block's frozen
   exponent and their frozen sign, bitwise; the result's deployment prints
   its one4n stored bits. Then 3 steps of reduced olmo-1b from one state on
   the card and on the CPU: losses within 1e-4 relative, parameters within
   one fp16 ulp;
9. pack the trained unembed [2048, 50304] with pack_bfp and serve the
   final-normed hidden states of an 8 x 128 batch (M = 1024) through
   cim_linear: K5 must launch (its count zeroed before phase 8, read just
   after this call), agree with the dense product within rtol = atol = 2e-4
   and with its plain version within 1e-5; the identity probe must give the
   trained unembed bitwise; ragged shapes, n_group 4 and 16 and bf16 x
   against the plain version; a plane holding all 256 exponent bytes
   bitwise equal to the plain version, +-inf from byte 143, no NaN;
10. serve full-width olmo-1b through the continuous-batching engine
   (LoadGen of 12 requests, prompts 8-32, generations 4-16, all at t = 0;
   4 slots, chunk 16) in four arms at BER 1e-4 without ECC accounting:
   (a) fused one4n dynamic, (b) fused none dynamic, (c) fused one4n
   static, (d) hbm; the counts are zeroed just before each arm and read
   just after: (a) and (b) must launch K1 / K2 once per prefill chunk plus
   n_slots times per decode step (every slot reads at M = 1, inactive ones
   too), each launch through the narrow kernel, and (c) and (d) neither;
   per arm the decode tok/s, TTFT mean and p95, slot occupancy and decode
   steps. With ECC accounting (its time printed), on arms (a) and (c) and
   a 4-request load: rids 0 and 2 re-served through a fresh engine of the
   same n_slots, and the load in reversed arrival order (other slots),
   equal the co-batched run bitwise (tokens, every logit vector, ECC
   charges); arm (a) over a shared 32-token prefix with a prefix cache
   hits, and a hit equals a cold engine bitwise; reduced olmo-1b served by
   the engine on the card equals the CPU's plain path (tokens and ECC
   equal, logits within allclose(1e-4, 1e-4)) for the dynamic one4n and
   none arms. Phase 7 also times K1's and K2's narrow kernels at M = 1;
11. scrubbing, the fleet and training's resume. (a) A drift-aging soak of
   full-width olmo-1b (one4n, n_group 8, index 2, static at BER 0, the
   unembed's row cache on): LoadGen of 8 requests (prompts 8-32,
   generations 4-16, seed 3) through 4 slots, chunk 16, ECC accounting
   on, DriftAging(ber=1e-3, the default drift process, an integer seed)
   every 4 steps; scrub-off (threshold 10^12, check_finite=False) and
   scrub-on (threshold 8): the arms' aged images equal (plane digests)
   up to the first scrub, scrub-on logs a scrub and strictly fewer
   uncorrectable events, every scrubbed store's store_ecc resets, the
   first scrub's image equals pack(read(image)) bitwise, every request
   completes and every scrub-on request is finite; per arm the decode
   tok/s, events, the ms of an aging tick, of one store's scrub and of a
   charged read, and the hook's share of the wall. (b) The scrub-on soak
   with the row cache off: the counts are zeroed just before and read
   just after, and every unembed read (one a prefill chunk, one a decode
   step) is a narrow K1 launch; after every params swap K1 on the new
   image equals its plain version within 1e-4 of |x| @ |W| (those
   launches taken back out of the counts); tokens and ECC equal soak
   (a)'s scrub-on arm and logits are within 1e-4 of |h| @ |W| (phase 2's
   bound for faulted images: the image keeps weights up to 2^15). (c) Two
   engine replicas on the card behind the router (fused one4n dynamic,
   BER 1e-4, phase 10's load, 4 slots each, no accounting), the params
   spooled once under build/ and restored per replica: every request
   completes, both replicas serve, K1's count (zeroed just before, read
   just after) equals the engines' reads; wall and virtual tok/s,
   requests by replica, TTFT and the spool's bytes and seconds. (d) With
   accounting, over 4 requests: a routed rid equals its replay through a
   one-replica fleet from the same spool bitwise (tokens, logits, ECC),
   and failing replica0 after two ticks re-routes its requests, each
   equal to the routed run bitwise, and recover re-admits it. (e) Reduced
   olmo-1b on the card, 4 aligned steps twice, and interrupted after its
   step-2 checkpoint and resumed: bitwise equal to the uninterrupted run
   where the two uninterrupted runs are (else within their gap, printed);
   one step with int8 gradient compression has a finite loss;
12. the dense variants on full-width granite-3-8b (40 layers, d_model
   4096, 32 query heads over 8 KV heads, rmsnorm with its scales drawn
   nonzero, SwiGLU d_ff 12800, vocab 49155, fp32; 8.37 B parameters from
   a seeded generator on the card, after the olmo-1b model and the
   training state are freed). (a) Lock-step serving, batch 4, prompt 64,
   gen 32, in arms (a) one4n dynamic, (b) none dynamic (BER 1e-4), (c)
   one4n static (row cache) and (e) hbm, the counts zeroed just before
   each arm and read just after: GEN narrow K1 launches in (a), GEN
   narrow K2 launches in (b), none in (c) and (e); tok/s and prefill ms
   per arm. (b) K1 and K2 at granite's unembed shape (K = 4096,
   J = 49155, padded to 49168: the last 128-column strip holds 16 columns,
   3 of them real) on the served weights: the identity probe in 8-row
   narrow slices exact on the clean and the BER 1e-3 image, the last
   strip's columns included; the dynamic read equal to the static read of
   its image bitwise; the final-normed hidden states of a MarkovLM batch
   at M = 4 and 1 within 1e-4 of |h| @ |W| of the plain version, static
   and dynamic; each narrow kernel timed static and dynamic (BER 1e-4) at
   M = 4 and 1 beside torch.matmul and the plain version, with its bytes
   bound (453.1 MB of planes) and its draws bound. (c) Engine arm (a) on
   granite: phase 10's load, 4 slots, chunk 16, the count zeroed just
   before and read just after: one narrow K1 launch a prefill chunk plus
   one a slot a decode step (145); rids 0 and 2 served solo equal the
   co-batched run bitwise. The phase's peak max_memory_allocated. (d)
   Each new family reduced (granite, codeqwen, command-r and tinyvit
   served dynamic one4n and none; musicgen's audio_stub and internvl2's
   vision_stub forward), norms drawn nonzero, card against the port's
   plain CPU path as phase 3's reduced check; the phase's seconds.

13. the other block kinds on full-width rwkv6-1.6b (24 layers, d_model
   2048, 32 heads of 64, RWKV6 time mix and channel mix d_ff 7168,
   layernorm, vocab 65536, fp32; 1.600 B parameters from a seeded
   generator on the card, every constant-initialised leaf drawn, the
   decay base spread past both ends of the decay clamp), after granite is
   freed: (a) phase 12's lock-step arms, decode-step profile, K1/K2 at its
   unembed shape (K = 2048, J = 65536: 512 full strips) and engine arm (a)
   (145 K1 launches, solo == co-batched), and the engine behind a shared
   32-token prefix: every prefix hit (a fold's state snapshot) equal to
   its cold prefill bitwise; the phase's peak. (b) Each block kind reduced
   (local-only at window 16, rwkv6, recurrentgemma at 5 layers, qwen3-moe,
   dbrx), card against the port's plain CPU path as phase 12's (d), and
   the engine on the card: solo == co-batched bitwise. (c)
   ``ExpertDeployment`` on reduced qwen3-moe at static BER 1e-3: its
   ``stats_by_expert`` on the card equal to the CPU's, the served tokens
   equal.
14. training every block kind, then the co-design loop, after rwkv6 is
   freed: (a) full-width rwkv6-1.6b trains 4 aligned steps at 8 x 128
   through run_training with phase 8's one4n rule (at batch 4 if batch 8
   runs out of memory, said so), losses and grad norms finite, aux_loss
   0, each step's ms and the peak; then reduced rwkv6, recurrentgemma (5
   layers), qwen3-moe and a local-window olmo-1b take one aligned step
   from one state (constant leaves drawn) on the card and on the CPU:
   losses, grad norms and aux losses within 1e-4 relative (the MoE's
   nonzero), parameters within one fp16 ulp. (b) Full-width olmo-1b
   through the Finetuner (2 reshape steps with the exponent regularizer, 2
   aligned steps under the Fig. 7 schedule at BER 1e-4): losses finite,
   ``exp_penalty`` in stage 1, ``ecc_stats``; K4's launches, reset just
   before and read just after, equal drawn leaves x fields a step (a
   leaf's counter chunks are runs of one launch); step 0's schedule
   alone, its wall ms beside the predicted bound: each field's flips over the
   whole tree within 5 sigma of the binomial mean (exponent/sign at
   ``residual_exp_ber``), a second draw from the seed equal bitwise, its
   wall time beside the steps' and K4 timed at a full counter chunk; then
   ``PolicySearch.select`` of uniform One4N against One4N on the
   embeddings only at BER 1e-3, 2 trials, greedy accuracy over two
   MarkovLM batches: one K3 launch a store plane, reset before and read
   after; then ``PolicySearch.search`` over two groups on reduced
   olmo-1b: the card's trace equal to the CPU's move for move. The
   phase's wall time and peak by part.
15. the device mesh and the int8 K/V cache, n shards emulated on the one
   card. (a) The sharded image at olmo-1b's full unembed (K = 2048,
   J = 50304), one4n and none, 4-way ``dim='j'`` (12576-column shards, so
   shards 1-3 start mid-bank and mid-strip) and 2-way ``dim='k'``: each
   shard's ``inject_sharded`` planes equal the block of the single-device
   image bitwise at BER 1e-4 i.i.d. and under each MODEL_SPECS process, its
   i.i.d. decode the block of the single-device decode; K1/K2 on every
   shard at its offsets, M = 4 and 1, static and dynamic, within 1e-4 of
   |x| @ |W| of the plain version at the same offsets; the j slices
   gathered equal the unsharded read (bitwise expected; a difference is
   printed with its size), the k partials summed in shard order within
   1e-4 of |x| @ |W|; one launch a shard a read; each shard read timed
   beside the unsharded one with its bounds (its own bytes and draws).
   (b) ``serve(mesh=make_serve_mesh("1x1"), rounds=2)`` over a
   world-size-1 NCCL group on full-width olmo-1b (rebuilt), arms (a) and
   (b): tokens and ECC equal the unsharded run's, GEN narrow launches a
   round (counts zeroed before, read after). (c) Phase 5's one4n arm as two
   trial slices (``trial_shard``), joined: per-trial agreement and ECC
   counts equal the unsharded arm's bitwise; K3 timed on a slice. (d) The
   int8 K/V cache on full-width olmo-1b's slot states (arm (c)'s image;
   the lock-step prefill keeps the compute dtype, as the reference's):
   cache bytes and decode ms a step beside the compute-dtype cache;
   reduced olmo-1b's int8 values and bf16 scales on the card equal the
   CPU's bitwise (tokens equal; ``quant_kv`` bitwise on the same input); the engine's solo ==
   co-batched on the card. The phase's wall time by part.

16. the MoE all-to-all, data-parallel training and the co-design loop on
   meshes, on the one card. (a) qwen3-moe's MoE layer at its published
   widths (d_model 4096, 128 experts, top-8, d_ff_expert 1536; 9.66 GB of
   fp32 experts) over 4 x 256 tokens, its 4 "model" ranks emulated in one
   process (``moe_a2a.apply_moe_a2a_local``), at the config's capacity
   factor 1.25 (local capacity 20 binds) and at 8.0: drop sets bitwise the
   dense dispatch's on each rank's slice, the output and the input, router
   and expert gradients of sum(out * r) + aux within 1e-4 of the largest;
   forward + backward timed with CUDA events beside the per-slice and the
   global dense dispatch. (b) ``run_training`` on a 1x1 NCCL mesh: 2
   aligned steps of full-width olmo-1b at 8 x 128 under the Fig. 7
   schedule at BER 1e-4, metrics and every parameter bitwise the same
   steps without the mesh from one state, K4 launching phase 14's one a
   drawn leaf and field a step. (c) ``Finetuner(mesh=1x1)`` and ``PolicySearch.select`` through a
   one-rank trial mesh (``SweepEngine(plan, mesh=make_trial_mesh())``):
   phase 14's losses and parameters bitwise, its choice, accuracies and
   trace, its K3 launches. The phase's wall time by part.

17. the training state sharded over a mesh (ZeRO-3), on the one card. (a)
   K4 at shard offsets: a uint16 plane of granite-3-8b's stacked w_gate
   shape [40, 4096, 12800] (16 counter chunks) cut into the blocks of its
   spec at 4x1 and 2x2, each block drawn at its offsets in one launch
   over the table of its runs of rows (``fault.draw_block_bits``) and
   held bitwise to its region of the one-device draw, every chunk drawn;
   one 4x1 block timed against its bound (draws x 10 ALU-pipe ops; in
   float32 the larger of that and 8 bytes an element), its plain version
   and the run-by-run route (a launch a run), in uint16 and in float32
   in place (``fault.inject_block``, the fused round trip). (b) the ZeRO-3 step with 4 "data" ranks emulated in
   one process (``zero3.emulate_step``: the program's sharded step, a
   thread a rank, its gathers, reduce-scatters and all-reduces in-process
   exchanges) on full-width olmo-1b at 8 x 128: each rank's init
   blocks (drawn leaf by leaf) bitwise the one-device init's; remat on
   and off bitwise on one device; one clean aligned step held to the
   one-device step at ``tests/test_torch_train_kinds.py``'s tolerances;
   2 aligned steps under the Fig. 7 schedule at BER 1e-4, step 0's faulty
   blocks bitwise the one-device flips, K4's launches at the blocks'
   offsets counted, the deviations from the one-device steps reported;
   the row-split witness: on the same faulty weights, the one-device
   forward of the 8 rows against four forwards of 2 rows (the ranks'
   shapes), whose loss the emulated step 0's must equal; step ms, the
   gathered bytes and the peak.

18. the engine, the fleet and the 2-D sweep on meshes, and K3 at
   column-shard offsets, the ranks emulated on the one card (a thread a
   rank, ``sharding.thread_ranks``). (a) K3 on phase 4's full-width planes
   (the one4n unembed's ``man`` uint16 [2048, 50304] and flattened codeword
   plane, the none store's ``exp`` and ``sign``) in 4 column shards of
   12576 words (3 of them starting mid-bank, mid-unit and mid-tile), T = 4,
   BER 1e-3, under i.i.d., drift, correlated and burst row / col / bank:
   each shard's copies (one launch) bitwise its plain version at the same
   offsets and the block of the unsharded copies; each mantissa shard timed
   beside the unsharded plane with its bound (the draws it performs).
   (b) Fig. 6's one4n arm at BER 1e-3 (phase 5's seeds, 4 trials) on a 1x4
   ("trial", "model") mesh: every rank's cells equal the unmeshed arm's;
   K3's launches (zeroed just before, read just after: one a store plane a
   rank) are the shard row's. (c) Engine arm (a) with ECC accounting over
   phase 10's 4-request load (4 slots, chunk 16), on one device, on a 1x1
   NCCL mesh and with "model" emulated at 4: tokens, logits and ECC
   charges equal the unmeshed run's bitwise, and K1 launches once a shard
   a read. (d) A fleet of 2 replicas on emulated 1x1 blocks over a shared
   32-token prefix: every routed result equals a one-replica probe's
   bitwise, with a prefix hit. The phase's wall time by part.

Phases run in the order 1-3, 10, 11, 4-6, 8, 9, 12, 13, 14, 15, 16, 17,
18, 7.
Prints the card's name and power limit, then one ``{"kernels": [...]}`` line
(each K1/K2 row carries its granite figures under ``"granite"``, its rwkv6
figures under ``"rwkv6"`` and its shard reads under ``"mesh"``; K3's and
K4's rows their co-design path's launches and times under ``"codesign"``
and their mesh path's under ``"mesh_train"``, K3's its trial-slice figures
under ``"trial_slice"``, K4's its shard-offset figures under ``"zero3"``;
the ``fault_inject_batched@col_shard`` row is K3 at column-shard offsets,
its launches those of phase 18 (b), its phase 18 figures under
``"shards"``, ``"sweep"``, ``"engine"`` and ``"fleet"``), and as its last
line ``{"ok": true, "device": {...}}``; the int8 cache's figures come on a
``{"int8_cache": ...}`` line and the all-to-all's on a ``{"moe_a2a": ...}``
line before the card's name.

``python3 chip_smoke.py --phase 15`` builds the kernels and runs phase 15
alone on phase 2's stores (a quick check while working on the mesh); it
prints no contract line. ``python3 chip_smoke.py --phase 16`` builds K3/K4
and runs phase 16 alone, its one-device references run in the phase;
``--phase 17`` does the same for phase 17; ``--phase 18`` builds K1-K4 and
runs phase 18 on phase 2's stores.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
K, J, N_GROUP = 2048, 50304, 8
BATCH, PROMPT, GEN = 4, 64, 32
TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_FLOPS = 67e12               # H100 SXM, float32 outside the tensor cores
TF32_FLOPS = 495e12              # H100 SXM, TF32 tensor cores, dense
# INT32: an SM issues 64 INT32 lanes a clock against 128 FP32 lanes, and the
# float32 rate counts an FMA as 2 operations: 67e12 / 4 INT32 ops/s. That
# rate holds on each of two pipes: logic, shift and compare issue on the ALU
# pipe; integer multiplies (IMAD) on the FMA pipe, alongside.
INT32_OPS = FP32_FLOPS / 4
# One (element, position) draw of hash_u32((e*32 + p) ^ seed*GOLD) < thr,
# or-ed into the flip mask: 12 integer ops, of which the two multiplies go to
# the FMA pipe and these 10 to the ALU pipe: add, xor, three shifts, three
# xors, compare, or. The bound takes the busier pipe; phase 1 reads the
# compiled hash bodies from the SASS and checks the multiplies are IMADs.
ALU_OPS_PER_DRAW, IMAD_OPS_PER_DRAW = 10, 2
HASH_MULS = ("-0x7a143595", "-0x3d4d51cb")     # 0x85EBCA6B, 0xC2B2AE35
ALU_OPCODES = {"LOP3", "SHF", "ISETP", "SEL", "IADD3", "LEA", "PRMT", "PLOP3",
               "FLO", "POPC", "BMSK", "SGXT", "BREV", "IMNMX", "LOP", "SHL",
               "SHR"}
SOURCE = "src/repro_torch/kernels/cim_read/csrc/cim_read.cu"
FI_SOURCE = "src/repro_torch/kernels/fault_inject/csrc/fault_inject.cu"
BFP_SOURCE = "src/repro_torch/kernels/bfp_matmul/csrc/bfp_matmul.cu"
REPLACES = {"cim_read_matmul_one4n": "src/repro/kernels/cim_read/kernel.py:381",
            "cim_read_matmul_raw": "src/repro/kernels/cim_read/kernel.py:428",
            "fault_inject_batched": "src/repro/kernels/fault_inject/kernel.py:172",
            "fault_inject": "src/repro/kernels/fault_inject/kernel.py:86",
            "bfp_matmul": "src/repro/kernels/bfp_matmul/kernel.py:54"}
FIELDS = ("sign", "exponent", "mantissa", "full", "exponent_sign")
FIG6_BERS, FIG6_TRIALS = (1e-5, 1e-4, 1e-3), 4
FIG6_PROTECTS = ("none", "per_weight", "one4n")
FIG6_PLANES = {"none": 3, "per_weight": 2, "one4n": 2}
FIG6_BATCH, FIG6_SEQ = 4, 64
FIG2_BERS, FIG2_TRIALS, FIG2_N = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2), 8, 1024
FIG2_FIELDS = ("sign", "exponent", "mantissa", "full")
PROTECT_OF = {"cim_read_matmul_one4n": "one4n", "cim_read_matmul_raw": "none"}
# fault processes held on the card: each burst axis and the correlated kind
MODEL_SPECS = ("burst:rate=0.25,length=4,axis=row",
               "burst:rate=0.25,length=4,axis=col",
               "burst:rate=0.25,length=8,axis=bank",
               "correlated:strength=0.8,period=4")
MODEL_BER = 1e-4
# float32 words K4's fused round trip is held on in phase 4: signed zeros,
# fp32 and fp16 subnormals and their edges, fp16 ties (even and odd), the
# largest finite fp16 and the values that round to inf, infinities, NaNs
# with payloads (quiet and signalling)
K4_SPECIALS = (0x00000000, 0x80000000, 0x00000001, 0x807FFFFF, 0x00800000,
               0x33000000, 0x33000001, 0x33400000, 0x33800000, 0x33C00000,
               0x387FC000, 0x387FE000, 0x38800000, 0xB8801000, 0x3F800000,
               0x3F801000, 0x3F803000, 0x3F802FFF, 0x3F801001, 0x477FE000,
               0x477FEFFF, 0x477FF000, 0xC77FF000, 0x47800000, 0x7F7FFFFF,
               0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00000, 0x7F800001,
               0x7FA00000, 0xFFBFFFFF, 0x7FC02000, 0x7FFFE000, 0x7F802000)
SERVE_MODELS = ("burst:rate=0.25,length=4,axis=col", "drift:drift_rate=0.02")
FIG6_MODELS = ("iid", "burst:rate=0.5,length=4")
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 4, 8, 128   # the train launcher's defaults
REDUCED_STEPS, REDUCED_LR = 3, 1e-3            # tests/test_torch_train.py's
REDUCED_MIN_TRAVEL = 4                         # fp16 ulps, median
# phase 14: the Fig. 7 schedule's wall ms on full-width olmo-1b predicted
# for K4's one launch a (leaf, field) with the round trip fused
SCHEDULE_MS_PREDICTED = 40.0
LOSS_RTOL = 1e-4
DENSE_TOL = 2e-4        # tests/test_system.py: cim_linear vs x @ w
BFP_TOL = 1e-5          # tests/test_kernels.py: kernel vs its plain version
BFP_RAGGED = ((5, 72, 40, 8, "float32"), (3, 512, 130, 8, "float32"),
              (130, 520, 128, 8, "float32"), (4, 512, 256, 4, "float32"),
              (64, 256, 96, 16, "float32"), (4, 512, 256, 8, "bfloat16"),
              (200, 520, 130, 8, "bfloat16"))


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


def phase_build(libs: dict) -> None:
    """One nvcc per source, all started together (nvcc runs outside the
    GIL, so threads overlap the builds)."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        secs = dict(zip(libs, pool.map(lambda lib: lib.timed_build(),
                                       libs.values())))
    print(f"phase 1: built {', '.join(libs)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items()) + ")")
    for lib in libs.values():
        for ln in lib.build_log.splitlines():
            if "registers" in ln or "Compiling entry" in ln:
                print(f"  ptxas: {ln.strip()}")


def _cuobjdump(lib_path, flag: str) -> str:
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, flag, str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def _sass_hash_bodies(lib_path, mangled: str) -> list:
    """The compiled hash bodies of one kernel: the runs of SASS between two
    branches that hold the hash's first multiply, each as a list of opcodes
    (with their immediates kept for the multiplies)."""
    sass = _cuobjdump(lib_path, "-sass")
    body, bodies, inside = [], [], False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = mangled in ln
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?(\S+)\s*([^;]*);",
                     ln)
        if not inside or not m:
            continue
        op, args = m.groups()
        if op.startswith("BRA") or op == "EXIT":
            if any(HASH_MULS[0] in a for a in body):
                bodies.append(body)
            body = []
        else:
            body.append(f"{op} {args}")
    return bodies


# the instantiations whose hash bodies phase_sass reads: K3's i.i.d. one
# <uint16, 8, MODEL_IID> (the correlated one hashes its column groups
# beside the draws), K3's burst tile kernel <uint16, 8> (its unit hashes
# and its draws of 8, 4, 2 and 1 elements) and K4's <uint16, 8> and
# <float, 8>. Each maps to (mangled name, one draw a body: exactly two
# IMADs a body, else the draws are counted by unsigned compares; print the
# census of the widest body, else of the most common one)
SASS_KERNELS = {
    "K3 (uint16 x 8)": ("fault_inject_batched_kernelItLi8ELi0ELb0EE", True,
                        False),
    "K3 at column offsets (uint16 x 8)": (
        "fault_inject_batched_kernelItLi8ELi0ELb1EE", True, False),
    "K3 burst (uint16 x 8)": ("fault_inject_burst_tile_kernelItLi8ELb0EE",
                              False, True),
    "K3 burst at column offsets (uint16 x 8)": (
        "fault_inject_burst_tile_kernelItLi8ELb1EE", False, True),
    "K4 (uint16 x 8)": ("fault_inject_runs_kernelItLi8EE", False, False),
    "K4 (float32 x 8)": ("fault_inject_runs_kernelIfLi8EE", False, False)}


def phase_sass(lib_path) -> None:
    """Check the premise of K3/K4's bound: in K3's uint16 kernels (the Fig. 6
    timing shape: i.i.d. and burst) and K4's uint16 and float32 kernels
    every hash multiply is an IMAD, i.e. issues on the FMA pipe beside the
    ALU work, two a draw; print the compiled per-draw census (K4 and the
    burst kernel draw up to 8 elements between two branches; the burst
    kernel's line names its body of 8 draws, beside its unit hashes and
    its groups of 4, 2 and 1)."""
    from collections import Counter
    for name, (mangled, one_draw, report_widest) in SASS_KERNELS.items():
        bodies = _sass_hash_bodies(lib_path, mangled)
        _check(len(bodies) > 0, f"{name} SASS: no hash body found")
        census, widest = Counter(), (0, None)
        for body in bodies:
            muls = [b for b in body if any(c in b for c in HASH_MULS)]
            if one_draw:
                draws = 1
                ok = len(muls) == 2 and \
                    all(b.startswith("IMAD ") for b in muls)
            else:
                # K4 and the burst kernel draw up to 8 elements a body and
                # may keep a constant in a register (an IMAD.MOV); their
                # draws are their unsigned compares, and every line
                # holding a constant an IMAD
                draws = sum(b.startswith("ISETP") and ".U32" in b
                            for b in body)
                ok = all(b.startswith("IMAD") for b in muls)
            _check(ok, f"{name} SASS: hash multiplies are not IMADs: {muls}")
            if not draws:
                continue
            ops = [b.split()[0].split(".")[0] for b in body]
            figures = (round(sum(o in ALU_OPCODES for o in ops) / draws, 2),
                       round(sum(o == "IMAD" for o in ops) / draws, 2),
                       round(sum(o not in ALU_OPCODES and o != "IMAD"
                                 for o in ops) / draws, 2))
            census[figures] += 1
            widest = max(widest, (draws, figures))
        _check(bool(census), f"{name} SASS: no hash body found")
        (alu, imad, other), n = census.most_common(1)[0]
        if report_widest:
            (alu, imad, other), n = widest[1], census[widest[1]]
        print(f"phase 1: {name} SASS: {len(bodies)} hash bodies, {n} of "
              f"them with {alu} ALU-pipe, {imad} IMAD and {other} other "
              f"instructions a draw (bound counts {ALU_OPS_PER_DRAW} ALU, "
              f"{IMAD_OPS_PER_DRAW} IMAD); census {dict(census)}")


def _k5_variant(mangled: str) -> str:
    m = re.search(r"bfp_matmul_(tc|narrow)_kernelI(?:Li(\d)E)?(f|t)Lb(\d)E",
                  mangled)
    if not m:
        return ""
    kind, mr, xt, vec = m.groups()
    return (f"{'tile' if kind == 'tc' else 'narrow'}"
            f"{' M' + mr if mr else ''} x {'f32' if xt == 'f' else 'bf16'} "
            f"{'16-byte' if vec == '1' else 'element'}")


def phase_k5_sass(lib_path) -> None:
    """K5's tile variant must run on the tensor cores: every instantiation's
    SASS holds TF32 HMMAs. Registers and spills of every K5 instantiation
    from ``cuobjdump -res-usage`` (which holds for a library built before
    this run too); a tile instantiation with a stack frame or local memory
    (a spill) fails. The narrow variant's are printed: its M = 4
    element-load instantiation, on no main path, keeps an 8-byte frame."""
    usage, name = {}, None
    for ln in _cuobjdump(lib_path, "-res-usage").splitlines():
        m = re.search(r"Function (\S+?):?\s*$", ln)
        if m:
            name = _k5_variant(m.group(1))
            continue
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)", ln)
        if name and m:
            usage[name] = tuple(int(v) for v in m.groups())
            name = None
    _check(len(usage) == 16 + 4, f"K5 res-usage: {len(usage)} instantiations "
           f"found, expected 20: {sorted(usage)}")
    for v, (reg, stack, _, local) in sorted(usage.items()):
        print(f"  ptxas: K5 {v}: {reg} registers, stack {stack} B, local "
              f"{local} B")
    spills = {v: u for v, u in usage.items()
              if v.startswith("tile") and (u[1] or u[3])}
    _check(not spills, f"K5 tile spills (stack or local memory): {spills}")
    hmma, name = {}, None
    for ln in _cuobjdump(lib_path, "-sass").splitlines():
        if "Function :" in ln:
            name = _k5_variant(ln.split("Function :")[1].strip())
            if name.startswith("tile"):
                hmma[name] = 0
            continue
        if name in hmma:
            hmma[name] += bool(re.search(r"\bHMMA\.\S*TF32", ln))
    _check(len(hmma) == 4 and all(hmma.values()),
           f"K5 SASS: tile instantiations without TF32 HMMAs: {hmma}")
    print(f"phase 1: K5 SASS: TF32 HMMA instructions in each tile "
          f"instantiation {hmma}; no tile instantiation spills")


def _unembed_store(protect: str, dev):
    import torch
    from repro_torch.core import align, cim
    g = torch.Generator(device=dev).manual_seed(11)
    w = torch.randn((K, J), generator=g, device=dev) * 0.02
    w_al, _ = align.align_matrix(w, align.AlignmentConfig(n_group=N_GROUP))
    return cim.pack(w_al, cim.CIMConfig(n_group=N_GROUP, protect=protect))


def _identity_probe(name, store, w_ref, what, rows=None, scalars=None,
                    model=None):
    """``eye @ W`` through the kernel gives W exactly: in one call at
    M = K (the tile kernel), or in slices of ``rows`` rows (M <= 8: the
    narrow kernel, K / rows launches). Entries are compared by value (the
    kernel's f32 accumulator turns -0.0 into +0.0); a column that holds a
    non-finite weight must come out non-finite throughout. With dynamic
    ``scalars`` (and a fault ``model``) ``w_ref`` is the image the read's
    flips leave. Returns the probe's output and the number of such
    columns."""
    import torch
    from repro_torch.kernels.cim_read import ops
    k = store.shape[0]
    eye = torch.eye(k, device=w_ref.device)
    want = "tile" if rows is None else "narrow"
    outs, kernels = [], set()
    for i in range(0, k, rows or k):
        out, info = ops.cim_linear_store(eye[i:i + (rows or k)], store,
                                         scalars=scalars, model=model,
                                         with_info=True)
        _check(info["used_kernel"], f"{name}: kernel route not taken")
        kernels.add(info["tiles"]["kernel"])
        outs.append(out)
    out = torch.cat(outs)
    _check(kernels == {want}, f"{name}: identity probe ran {kernels}, "
           f"expected {want}")
    fin = torch.isfinite(w_ref).all(0)
    _check(torch.equal(out[:, fin], w_ref[:, fin]),
           f"{name}: identity probe ({want}) != read() on the {what} image")
    _check(not bool(torch.isfinite(out[:, ~fin]).any()),
           f"{name}: finite output in a column with a non-finite weight "
           f"({what} image, {want})")
    return out, int((~fin).sum())


def _tile(x, store, scalars=None, model=None):
    """The store's 16 x 64 x 64 tile kernel (K1's or K2's) at any M, through
    its binding: the geometry ``resolve_tiles`` gives a tile-sized read."""
    from repro_torch.kernels.cim_read import ops
    if scalars is not None:
        scalars = ops.model_scalars_of(scalars, model)
    return ops._kernel_call(x, store, scalars,
                            ops.resolve_tiles(store, ops.BLOCK_M), model)


def _narrow_gates(name, store, injected, probes: dict, scalars,
                  dev) -> float:
    """``name``'s narrow kernel (M <= 8) against its tile kernel: the
    identity probe in 8-row slices on the clean and the injected image (exact, and
    equal to the tile's M = K probe on every finite column), dense inputs at
    M = 1, 3, 4 and 8 within allclose(TOL, TOL) static and within TOL of
    |x| @ |W| dynamic, and two runs of one call bitwise equal. Returns the
    largest dense difference."""
    import torch
    from repro_torch.core import cim
    from repro_torch.kernels.cim_read import ops
    for what, image in (("clean", store), ("BER 1e-3", injected)):
        w_ref, _ = cim.read(image)
        sliced, _ = _identity_probe(name, image, w_ref, what, rows=8)
        fin = torch.isfinite(w_ref).all(0)
        _check(torch.equal(sliced[:, fin], probes[what][:, fin]),
               f"{name}: narrow identity slices != tile probe ({what})")
        del sliced, w_ref
    g = torch.Generator(device=dev).manual_seed(6)
    w_inj_abs = cim.read(injected)[0].abs()
    worst = 0.0
    for m in (1, 3, 4, 8):
        x = torch.randn((m, K), generator=g, device=dev)
        for sc in (None, scalars):
            got, info = ops.cim_linear_store(x, store, scalars=sc,
                                             with_info=True)
            _check(info["tiles"]["kernel"] == "narrow",
                   f"{name}: M = {m} took {info['tiles']}")
            # the injected image's weights reach 2^15: dynamic outputs are
            # held to |x| @ |W|, as against the plain version
            ok, err = _close(got, _tile(x, store, sc),
                             None if sc is None else x.abs() @ w_inj_abs)
            _check(ok, f"{name}: narrow vs tile at M = {m} "
                   f"({'dynamic' if sc is not None else 'static'}, max err "
                   f"{err:.3e})")
            worst = max(worst, err)
            again = ops.cim_linear_store(x, store, scalars=sc)
            _check(_same_bits(got, again), f"{name}: two runs at M = {m} "
                   "differ")
    return worst


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
        probes = {"clean": _identity_probe(name, store, w_ref, "clean")[0]}
        got, info = ops.cim_linear_store(x, store, with_info=True)
        want, _ = ref.cim_read_ref(x, store)
        ok, err = _close(got, want)
        _check(ok, f"{name}: dense output vs plain (max err {err:.3e})")
        dyn = ops.cim_linear_store(x, store, scalars=scalars)
        injected = cim.inject_with_seeds(store, seeds, thr, thr)
        w_inj, _ = cim.read(injected)
        probes["BER 1e-3"], bad_cols = _identity_probe(name, injected, w_inj,
                                                       "BER 1e-3")
        stat = ops.cim_linear_store(x, injected)
        _check(_same_bits(dyn, stat),
               f"{name}: dynamic kernel != kernel on the injected image")
        plain_dyn, st = ref.cim_read_ref(x, store, scalars)
        ok_dyn, err_dyn = _close(dyn, plain_dyn, x.abs() @ w_inj.abs())
        _check(ok_dyn, f"{name}: dynamic kernel vs plain (max err {err_dyn:.3e})")
        del w_inj, plain_dyn
        err_tile = _narrow_gates(name, store, injected, probes, scalars, dev)
        narrow = (f"; narrow kernel (dense M = {BATCH}, {info['tiles']}): "
                  f"8-row identity slices exact on both images and equal "
                  f"to the tile's M = {K} probe, M = 1/3/4/8 vs tile max "
                  f"err {err_tile:.3e}, repeat calls bitwise")
        del probes, injected
        torch.cuda.synchronize()
        results[name] = {"store": store, "max_abs_err": err,
                         "max_abs_err_dynamic": err_dyn}
        print(f"phase 2: {name} ({protect}) identity exact on the clean and "
              f"the BER 1e-3 image ({bad_cols} columns hold a non-finite "
              f"weight), dense max err {err:.3e}, dynamic==static-injected "
              f"bitwise, dynamic vs plain max err {err_dyn:.3e}; BER 1e-3 "
              f"image corrected={st['corrected']} "
              f"uncorrectable={st['uncorrectable']}{narrow}")
    return results


def _flip_counts(store, a, b) -> tuple:
    """(bits flipped in image ``a``, bits flipped in ``a`` but not in
    ``b``), both against the clean ``store``, over every plane."""
    import torch
    n_a = n_extra = 0
    for name in ("man", "sign", "exp", "codewords"):
        clean = getattr(store, name)
        if clean is None:
            continue
        c = clean.to(torch.int64)
        fa = (getattr(a, name).to(torch.int64) ^ c) & 0xFFFFFFFF
        fb = (getattr(b, name).to(torch.int64) ^ c) & 0xFFFFFFFF
        n_a += _popcount(fa)
        n_extra += _popcount(fa & ~fb)
    return n_a, n_extra


def _popcount(words) -> int:
    import torch
    count = torch.zeros((), dtype=torch.int64, device=words.device)
    for b in range(32):
        count += ((words >> b) & 1).sum()
    return int(count)


def phase_models(dev, checks: dict) -> dict:
    """K1 and K2 under each fault process of MODEL_SPECS at BER 1e-4 on the
    full-width unembed, with the gates the i.i.d. read has: the dynamic
    identity probe through the tile (M = K) and through the narrow kernel
    (8-row slices) gives the weights of ``cim.inject_with_seeds(...,
    model=)``'s image exactly, and equals the static kernel read of that
    image bitwise; dense M = 4 within TOL of |x| @ |W| of the plain version
    and bitwise equal to the static read of the image; the narrow kernel
    against the tile at M = 1, 3, 4 and 8; the image's flips a strict
    subset of the i.i.d. ones at the same seeds. Returns the largest dense
    difference per kernel."""
    import torch
    from repro_torch.core import cim
    from repro_torch.core import faultmodels as fm
    from repro_torch.kernels.cim_read import ops, ref
    from repro_torch.kernels.fault_inject.ops import ber_to_threshold
    seeds = {"man": 0x1234567, "meta": 0x89ABCDE, "cw": 0x2468ACE}
    thr = ber_to_threshold(MODEL_BER)
    g = torch.Generator(device=dev).manual_seed(8)
    xs = {m: torch.randn((m, K), generator=g, device=dev) for m in (1, 3, 4, 8)}
    worst = {}
    for name in PROTECT_OF:
        store = checks[name]["store"]
        iid_img = cim.inject_with_seeds(store, seeds, thr, thr)
        n_iid, _ = _flip_counts(store, iid_img, iid_img)
        worst[name] = 0.0
        for spec in MODEL_SPECS:
            model = fm.parse_fault_model(spec)
            sc = ops.make_scalars(seeds, thr, thr, model=model)
            injected = cim.inject_with_seeds(store, seeds, thr, thr,
                                             model=model)
            n_model, extra = _flip_counts(store, injected, iid_img)
            _check(extra == 0 and 0 < n_model < n_iid,
                   f"{name} {spec}: {n_model} flips ({extra} outside the "
                   f"i.i.d. set of {n_iid})")
            w_inj, _ = cim.read(injected)
            tile, bad = _identity_probe(name, store, w_inj, spec, scalars=sc,
                                        model=model)
            static, _ = _identity_probe(name, injected, w_inj, spec)
            fin = torch.isfinite(w_inj).all(0)
            _check(_same_bits(tile[:, fin], static[:, fin]),
                   f"{name} {spec}: dynamic probe != static read of the "
                   f"injected image")
            del tile, static
            narrow, _ = _identity_probe(name, store, w_inj, spec, rows=8,
                                        scalars=sc, model=model)
            del narrow
            x = xs[BATCH]
            got, info = ops.cim_linear_store(x, store, scalars=sc, model=model,
                                             with_info=True)
            _check(info["tiles"]["kernel"] == "narrow",
                   f"{name} {spec}: M = {BATCH} took {info['tiles']}")
            _check(_same_bits(got, ops.cim_linear_store(x, injected)),
                   f"{name} {spec}: dynamic != static read of the image")
            plain, _ = ref.cim_read_ref(x, store, ops.model_scalars_of(
                sc, model), model)
            scale = x.abs() @ w_inj.abs()
            ok, dense_err = _close(got, plain, scale)
            _check(ok, f"{name} {spec}: dense vs plain max err "
                   f"{dense_err:.3e}")
            worst[name] = max(worst[name], dense_err)
            for m, xm in xs.items():
                a = ops.cim_linear_store(xm, store, scalars=sc, model=model)
                ok, err = _close(a, _tile(xm, store, sc, model),
                                 xm.abs() @ w_inj.abs())
                _check(ok, f"{name} {spec}: narrow vs tile at M = {m} (max "
                       f"err {err:.3e})")
            del w_inj, scale, injected
            torch.cuda.synchronize()
            print(f"phase 2: {name} under {spec} at BER {MODEL_BER:g}: "
                  f"{n_model} of the i.i.d. read's {n_iid} flips (a subset); "
                  f"dynamic identity probe exact through the tile (M = {K}) "
                  f"and the narrow kernel (8-row slices), equal to the static "
                  f"read of the injected image ({bad} non-finite columns); "
                  f"dense M = {BATCH} vs plain max err {dense_err:.3e}; narrow vs "
                  f"tile at M = 1/3/4/8 within tolerance")
    return worst


ARMS = (  # (label, serve_path, protect, inject, ber)
    ("a fused one4n dynamic", "fused", "one4n", "dynamic", 1e-4),
    ("b fused none dynamic", "fused", "none", "dynamic", 1e-4),
    ("c fused one4n static", "fused", "one4n", "static", 1e-4),
    ("d fused one4n static clean", "fused", "one4n", "static", 0.0),
    ("e hbm clean", "hbm", "one4n", "static", 0.0),
)


def _kernels_of(run):
    """Run ``run()`` and list which kernel each fused read launched
    (``info['tiles']['kernel']`` of every ``cim_linear_store`` call on the
    card; the cached and plain routes launch none)."""
    from repro_torch.kernels.cim_read import ops
    real, seen = ops.cim_linear_store, []

    def spy(*args, with_info=False, **kw):
        out, info = real(*args, with_info=True, **kw)
        if info.get("used_kernel"):
            seen.append(info["tiles"]["kernel"])
        return (out, info) if with_info else out
    with mock.patch.object(ops, "cim_linear_store", spy):
        res = run()
    return res, seen


def phase_serve(model, kernel_lib) -> dict:
    """The main path: full-width olmo-1b through the lock-step launcher."""
    import torch
    from repro_torch.launch import serve as serve_lib
    cfg = model.cfg
    runs = {}
    for label, path, protect, inject, ber in ARMS:
        kernel_lib.reset_launch_counts()
        res, kernels = _kernels_of(lambda: serve_lib.serve(
            model, batch=BATCH, prompt_len=PROMPT, gen=GEN, seed=0, cim=True,
            ber=ber, protect=protect, serve_path=path, inject=inject,
            verbose=False))
        res["kernels"] = kernels
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
    variants = {label: sorted(set(runs[label]["kernels"])) for label in
                (ARMS[0][0], ARMS[1][0])}
    _check(runs[ARMS[0][0]]["kernels"] == ["narrow"] * GEN,
           f"arm a: K1's reads went through {runs[ARMS[0][0]]['kernels']}, "
           f"expected the narrow kernel {GEN} times")
    _check(runs[ARMS[1][0]]["kernels"] == ["narrow"] * GEN,
           f"arm b: K2's reads went through {runs[ARMS[1][0]]['kernels']}, "
           f"expected the narrow kernel {GEN} times")
    clean, hbm = runs[ARMS[3][0]], runs[ARMS[4][0]]
    for res in (clean, hbm):
        _check(bool(torch.isfinite(res["prefill_logits"]).all()),
               "clean arm: non-finite logits")
    _check((clean["tokens"] == hbm["tokens"]).all(),
           "clean fused and hbm arms disagree on greedy tokens")
    _check(torch.allclose(clean["prefill_logits"], hbm["prefill_logits"],
                          rtol=TOL, atol=TOL), "clean fused vs hbm logits")
    print(f"phase 3: main-path launches {launches}, through the kernels "
          f"{variants} (info['tiles']); clean fused == hbm tokens")
    for spec in SERVE_MODELS:
        for name, (label, _, protect, inject, ber) in zip(
                ("cim_read_matmul_one4n", "cim_read_matmul_raw"), ARMS[:2]):
            kernel_lib.reset_launch_counts()
            res, kernels = _kernels_of(lambda: serve_lib.serve(
                model, batch=BATCH, prompt_len=PROMPT, gen=GEN, seed=0,
                cim=True, ber=ber, protect=protect, serve_path="fused",
                inject=inject, fault_model=spec, verbose=False))
            counts = dict(kernel_lib.launch_counts)
            _check(counts == res["launches"] and counts[name] == GEN,
                   f"arm {label} under {spec}: launches {counts}")
            _check(kernels == ["narrow"] * GEN, f"arm {label} under {spec}: "
                   f"reads went through {kernels}")
            _check(res["tokens"].shape == (BATCH, GEN) and
                   ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab_size))
                   .all(), f"arm {label} under {spec}: tokens out of range")
            print(f"phase 3: arm {label} --fault-model {spec}: "
                  f"{res['tok_per_s']:.1f} tok/s, prefill "
                  f"{res['prefill_s'] * 1e3:.1f} ms, {counts[name]} reads, "
                  f"all narrow")
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


ENGINE_SLOTS, ENGINE_CHUNK, ENGINE_BER = 4, 16, 1e-4
ENGINE_LOAD = dict(n_requests=12, prompt_lens=(8, 32), gen_lens=(4, 16),
                   seed=0)
ENGINE_ARMS = (  # (label, serve_path, protect, inject, kernel it must launch)
    ("a fused one4n dynamic", "fused", "one4n", "dynamic",
     "cim_read_matmul_one4n"),
    ("b fused none dynamic", "fused", "none", "dynamic",
     "cim_read_matmul_raw"),
    ("c fused one4n static", "fused", "one4n", "static", None),
    ("d hbm one4n", "hbm", "one4n", "static", None),
)


def _engine_params(model, arm):
    from repro_torch.launch import serve as serve_lib
    _, path, protect, inject, _ = arm
    return serve_lib.build_params(model, cim=True, ber=ENGINE_BER,
                                  protect=protect, serve_path=path,
                                  inject=inject, verbose=False)[0]


def _engine_run(model, params, reqs, max_len, **kw):
    """One engine over ``reqs`` -> (results by rid, aggregate)."""
    import torch
    from repro_torch.launch import engine as engine_lib
    eng = engine_lib.Engine(model, params, n_slots=ENGINE_SLOTS,
                            max_len=max_len, chunk=ENGINE_CHUNK, **kw)
    with torch.inference_mode():
        res, agg = eng.run(reqs)
    _check(sorted(res) == sorted(r.rid for r in reqs),
           f"engine: served {sorted(res)} of {[r.rid for r in reqs]}")
    return res, agg


def _same_request(a, b) -> bool:
    """Tokens, every logit vector (bitwise) and the ECC charges equal."""
    import numpy as np
    return (a.tokens == b.tokens and a.ecc == b.ecc
            and a.ecc_window == b.ecc_window
            and a.logits.shape == b.logits.shape
            and np.array_equal(a.logits.view(np.uint32),
                               b.logits.view(np.uint32)))


def phase_engine(model, kernel_lib) -> dict:
    """Phase 10: the continuous-batching engine on full-width olmo-1b.

    Arms (a)-(d) serve LoadGen(12 requests) through 4 slots, chunk 16,
    without ECC accounting; the counts are zeroed just before each arm and
    read just after: (a)/(b) launch K1/K2 once per cold prefill chunk plus
    n_slots per decode step (every slot, inactive ones too, reads at
    M = 1, through the narrow kernel), (c)/(d) launch neither. Then, with
    ECC accounting: solo equals co-batched bitwise on arms (a) and (c)
    (rids 0 and 2, and every request after the arrival order is reversed),
    a prefix-cache hit equals a cold prefill bitwise (arm a), and reduced
    olmo-1b served by the engine on the card equals the CPU's plain path.
    Returns each kernel's launches in its arm."""
    import numpy as np
    import torch
    from repro_torch.launch import engine as engine_lib
    vocab = model.cfg.vocab_size
    t0 = time.perf_counter()
    load = engine_lib.LoadGen(vocab_size=vocab, **ENGINE_LOAD)
    reqs, max_len = load.requests(), load.max_len()
    chunks = sum(-(-r.tokens.size // ENGINE_CHUNK) for r in reqs)
    launches = {}
    for arm in ENGINE_ARMS:
        label, name = arm[0], arm[4]
        params = _engine_params(model, arm)
        kernel_lib.reset_launch_counts()
        (res, agg), kernels = _kernels_of(lambda: _engine_run(
            model, params, reqs, max_len, ecc_accounting=False))
        counts = dict(kernel_lib.launch_counts)
        want = chunks + agg["decode_steps"] * ENGINE_SLOTS if name else 0
        _check(all(v == (want if k == name else 0)
                   for k, v in counts.items()),
               f"engine arm {label}: launches {counts}, expected {want} of "
               f"{name} ({chunks} prefill chunks + {agg['decode_steps']} "
               f"steps x {ENGINE_SLOTS} slots)")
        _check(kernels == ["narrow"] * want, f"engine arm {label}: reads "
               f"went through {sorted(set(kernels))} ({len(kernels)})")
        for r in reqs:
            got = res[r.rid]
            _check(len(got.tokens) == r.max_new and got.finite and
                   all(0 <= t < vocab for t in got.tokens),
                   f"engine arm {label}: request {r.rid} gave {got.tokens}")
        if name:
            launches[name] = counts[name]
        print(f"phase 10: engine arm {label}: decode "
              f"{agg['decode_tok_s']:.1f} tok/s aggregate ("
              f"{agg['decode_wall_s'] / agg['decode_steps'] * 1e3:.1f} ms a "
              f"step), TTFT mean "
              f"{agg['ttft_s_mean'] * 1e3:.1f} ms p95 "
              f"{agg['ttft_s_p95'] * 1e3:.1f} ms, occupancy "
              f"{agg['slot_occupancy']:.3f}, {agg['decode_steps']} decode "
              f"steps, {agg['total_tokens']} tokens, launches {counts}")
        del params
    _embed_read_ms(model)
    _engine_invariance(model, vocab)
    _engine_prefix(model, vocab)
    _engine_reduced(model.embed.device, kernel_lib)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return launches


def _embed_read_ms(model) -> None:
    """Host time of one dynamic one-row embed read (plain torch: the
    flips and the One4N decode of the gathered row), the read a dynamic
    decode step makes once per slot beside its K1 launch."""
    import torch
    from repro_torch.core import cim
    from repro_torch.core import deployment as dep_lib
    params = _engine_params(model, ENGINE_ARMS[0])
    store, rt = params["embed"], params["_cim"]
    idx = torch.tensor([[5]], device=store.device)
    seeds = dep_lib.request_read_seeds(rt["seeds"], dep_lib.leaf_salt("embed"),
                                       dep_lib.request_salt(0), 40)
    thr_man, thr_meta, fm = dep_lib.read_thresholds(rt, 40)

    def read():
        return cim.read_rows(store, idx, seeds=seeds, thr_man=thr_man,
                             thr_meta=thr_meta, model=fm)
    read()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        read()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 20 * 1e3
    print(f"phase 10: one dynamic embed row read (plain torch, host clock "
          f"over 20 synchronized reads): {ms:.2f} ms")


def _timed_charges(eng):
    """Wrap ``eng``'s per-read ECC charge to total its wall time."""
    real, spent = eng._charge_reads, [0.0]

    def timed(*args):
        t0 = time.perf_counter()
        real(*args)
        spent[0] += time.perf_counter() - t0
    eng._charge_reads = timed
    return spent


def _engine_invariance(model, vocab) -> None:
    """Arms (a) and (c) with ECC accounting: rids 0 and 2 re-served through
    a fresh engine of the same n_slots, and the load again in reversed
    arrival order, equal the co-batched run bitwise."""
    import torch
    from repro_torch.launch import engine as engine_lib
    load = engine_lib.LoadGen(n_requests=4, prompt_lens=(8, 32),
                              gen_lens=(3, 6), vocab_size=vocab, seed=0)
    reqs, max_len = load.requests(), load.max_len()
    rev = [engine_lib.Request(rid=r.rid, tokens=r.tokens, max_new=r.max_new,
                              arrival=float(len(reqs) - r.rid)) for r in reqs]
    for arm in (ENGINE_ARMS[0], ENGINE_ARMS[2]):
        params = _engine_params(model, arm)
        eng = engine_lib.Engine(model, params, n_slots=ENGINE_SLOTS,
                                max_len=max_len, chunk=ENGINE_CHUNK,
                                collect_logits=True)
        spent = _timed_charges(eng)
        t0 = time.perf_counter()
        with torch.inference_mode():
            co, agg = eng.run(reqs)
        wall = time.perf_counter() - t0
        for rid in (0, 2):
            solo, _ = _engine_run(model, params, [reqs[rid]], max_len,
                                  collect_logits=True)
            _check(_same_request(co[rid], solo[rid]), f"engine arm "
                   f"{arm[0]}: request {rid} solo != co-batched")
        back, _ = _engine_run(model, params, rev, max_len,
                              collect_logits=True)
        moved = [r.rid for r in reqs if back[r.rid].slot != co[r.rid].slot]
        _check(bool(moved), f"engine arm {arm[0]}: reversal moved no slot")
        for r in reqs:
            _check(_same_request(co[r.rid], back[r.rid]), f"engine arm "
                   f"{arm[0]}: request {r.rid} changed with its slot")
        print(f"phase 10: engine arm {arm[0]} with ECC accounting: solo == "
              f"co-batched bitwise (rids 0, 2: tokens, logits, ECC), reversal "
              f"moved rids {moved} to other slots and changed nothing; "
              f"{agg['ecc']['reads']} charged reads, ECC corrected="
              f"{agg['ecc']['corrected']} uncorrectable="
              f"{agg['ecc']['uncorrectable']}; the accounting took "
              f"{spent[0]:.2f} s of the co-batched run's {wall:.2f} s")
        del params


def _engine_prefix(model, vocab) -> None:
    """Arm (a) over a shared 32-token prefix through a prefix cache: a hit
    equals a cold engine without the cache, bitwise."""
    from repro_torch.launch import engine as engine_lib
    load = engine_lib.LoadGen(n_requests=3, prompt_lens=(8, 32),
                              gen_lens=(3, 4), vocab_size=vocab, seed=1,
                              prefix_len=32)
    reqs, max_len = load.requests(), load.max_len()
    params = _engine_params(model, ENGINE_ARMS[0])
    warm, agg = _engine_run(model, params, reqs, max_len,
                            collect_logits=True, prefix_cache=True)
    hits = [r for r in warm.values() if r.prefix_tokens > 0]
    _check(agg["prefix_hits"] >= 1 and bool(hits),
           f"engine prefix: no hit ({agg['prefix_cache']})")
    rid = hits[0].rid
    cold, _ = _engine_run(model, params, [reqs[rid]], max_len,
                          collect_logits=True)
    _check(cold[rid].prefix_tokens == 0 and
           _same_request(warm[rid], cold[rid]),
           f"engine prefix: request {rid} from the cache != cold prefill")
    print(f"phase 10: engine prefix cache (arm a, 32 shared tokens): "
          f"{agg['prefix_hits']} hits, {agg['prefix_tokens']} tokens reused; "
          f"request {rid} ({hits[0].prefix_tokens} cached tokens) == a cold "
          f"engine bitwise (tokens, logits, ECC)")


def _engine_reduced(dev, kernel_lib) -> None:
    """Reduced olmo-1b served by the engine on the card (K1/K2 at M = 1)
    and on the CPU (plain versions), same weights and seeds: tokens and ECC
    equal, logits within phase 3's allclose."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import engine as engine_lib
    from repro_torch.models.lm import LM
    cfg = get_config("olmo-1b").reduced()
    cpu = LM(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    gpu = LM(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    load = engine_lib.LoadGen(n_requests=6, prompt_lens=(3, 24),
                              gen_lens=(2, 6), vocab_size=cfg.vocab_size,
                              seed=2)
    reqs, max_len = load.requests(), load.max_len()
    chunks = sum(-(-r.tokens.size // ENGINE_CHUNK) for r in reqs)
    for arm in (ENGINE_ARMS[0], ENGINE_ARMS[1]):
        a, _ = _engine_run(cpu, _engine_params(cpu, arm), reqs, max_len,
                           collect_logits=True)
        kernel_lib.reset_launch_counts()
        b, agg = _engine_run(gpu, _engine_params(gpu, arm), reqs, max_len,
                             collect_logits=True)
        want = chunks + agg["decode_steps"] * ENGINE_SLOTS
        _check(kernel_lib.launch_counts[arm[4]] == want,
               f"engine reduced {arm[0]}: {kernel_lib.launch_counts}, "
               f"expected {want}")
        worst = 0.0
        for r in reqs:
            _check(a[r.rid].tokens == b[r.rid].tokens and
                   a[r.rid].ecc == b[r.rid].ecc,
                   f"engine reduced {arm[0]}: request {r.rid} card != CPU")
            ok, err = _close(torch.from_numpy(a[r.rid].logits),
                             torch.from_numpy(b[r.rid].logits))
            _check(ok, f"engine reduced {arm[0]}: request {r.rid} logits "
                   f"max err {err:.3e}")
            worst = max(worst, err)
        print(f"phase 10: engine reduced olmo-1b {arm[0]}: card == CPU plain "
              f"(tokens and ECC equal, logits max err {worst:.3e}), {want} "
              f"kernel launches")


SOAK_LOAD = dict(n_requests=8, prompt_lens=(8, 32), gen_lens=(4, 16), seed=3)
SOAK_AGE_BER, SOAK_AGE_EVERY, SOAK_AGE_SEED = 1e-3, 4, 11
SOAK_THRESHOLD = 8      # the reference bench's SCRUB_THRESHOLD
SOAK_OFF_THRESHOLD = 10 ** 12
FLEET_REPLICAS = 2


def _plane_digest(plane) -> tuple:
    """Two int64 checksums of a packed plane's words (plain and
    position-weighted): equal images give equal digests."""
    import torch
    w = plane.view(torch.int16) if plane.dtype == torch.uint16 else plane
    w = w.reshape(-1).to(torch.int64)
    pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
    return int(w.sum()), int((w * pos).sum())


def _image_digest(dep) -> dict:
    from repro_torch.core import cim
    return {p: {n: _plane_digest(v) for n, v in cim.plane_dict(s).items()}
            for p, _, s in dep.store_leaves()}


def _same_image(a, b) -> bool:
    """Two stores' planes bitwise equal."""
    import torch
    from repro_torch.core import cim
    pa, pb = cim.plane_dict(a), cim.plane_dict(b)
    return pa.keys() == pb.keys() and all(
        pa[n].dtype == pb[n].dtype and torch.equal(
            pa[n].view(torch.int16) if pa[n].dtype == torch.uint16 else pa[n],
            pb[n].view(torch.int16) if pb[n].dtype == torch.uint16 else pb[n])
        for n in pa)


def _soak(model, *, scrub: bool, serving_kw=None, on_swap=None):
    """One drift-aging soak of full-width olmo-1b (static BER-0 one4n image,
    row cache unless ``serving_kw`` turns it off) -> (results, aggregate,
    instrumented record). The hook's parts are timed after a synchronize;
    ``on_swap(engine)`` runs after every params swap, its kernel launches
    taken back out of the counts."""
    import torch
    from repro_torch.launch import engine as engine_lib
    from repro_torch.launch import scrub as scrub_lib
    from repro_torch.launch import serve as serve_lib
    from repro_torch.kernels.cim_read import kernel as kernel_lib
    dep = serve_lib.make_deployment(
        model.cim_leaves(), ber=0.0, protect="one4n", n_group=N_GROUP,
        index=2, seeds={}, inject_mode="static", field="full")
    kw = dict(serving_kw or {})
    aging = scrub_lib.DriftAging(seeds=SOAK_AGE_SEED, ber=SOAK_AGE_BER,
                                 every=SOAK_AGE_EVERY)
    policy = scrub_lib.ScrubPolicy(
        threshold=SOAK_THRESHOLD if scrub else SOAK_OFF_THRESHOLD)
    ctl = scrub_lib.ScrubController(dep, policy, aging=aging, serving_kw=kw)
    rec = {"age_ms": [], "scrub_ms": [], "digests": {}, "hook_s": 0.0,
           "image_checked": 0, "resets_checked": 0, "swaps": 0}
    real_age, real_scrub = aging.age, ctl.scrub

    def age(d, tick):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_age(d, tick)
        torch.cuda.synchronize()
        rec["age_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["digests"][tick] = _image_digest(out)
        return out

    def scrub_(paths):
        from repro_torch.core import cim
        old = dict(ctl.dep.stores)
        torch.cuda.synchronize()
        ev = real_scrub(paths)
        torch.cuda.synchronize()
        rec["scrub_ms"].append(ev["wall_s"] * 1e3 / max(len(ev["paths"]), 1))
        if not rec["image_checked"]:
            for p in ev["paths"]:     # the first scrub: pack(read(image))
                want = cim.pack(cim.read(old[p])[0], old[p].cfg)
                _check(_same_image(ctl.dep.stores[p], want),
                       f"phase 11: scrubbed {p} != pack(read(image))")
                rec["image_checked"] += 1
                del want
        return ev
    aging.age, ctl.scrub = age, scrub_
    load = engine_lib.LoadGen(vocab_size=model.cfg.vocab_size, **SOAK_LOAD)
    reqs, max_len = load.requests(), load.max_len()
    eng = engine_lib.Engine(model, dep.serving_params(**kw),
                            n_slots=ENGINE_SLOTS, max_len=max_len,
                            chunk=ENGINE_CHUNK, collect_logits=True,
                            check_finite=scrub)
    real_record, real_refresh = eng.record_scrub, eng.refresh_params

    def record(event):
        real_record(event)
        for p in event["paths"]:
            _check(eng.store_ecc[p] == {"reads": 0, "corrected": 0,
                                        "uncorrectable": 0},
                   f"phase 11: store_ecc[{p}] not reset by the scrub")
            rec["resets_checked"] += 1

    def refresh(params, force=False):
        real_refresh(params, force=force)
        rec["swaps"] += 1
        if on_swap is not None:
            counts = dict(kernel_lib.launch_counts)
            on_swap(eng)
            kernel_lib.launch_counts.update(counts)
    eng.record_scrub, eng.refresh_params = record, refresh

    def hook(engine, ev):
        t0 = time.perf_counter()
        ctl(engine, ev)
        torch.cuda.synchronize()
        rec["hook_s"] += time.perf_counter() - t0
    spent = _timed_charges(eng)
    t0 = time.perf_counter()
    with torch.inference_mode():
        res, agg = eng.run(reqs, on_step=hook)
    rec["wall_s"] = time.perf_counter() - t0
    rec["charge_s"] = spent[0]
    rec["reqs"], rec["ctl"] = reqs, ctl
    _check(sorted(res) == [r.rid for r in reqs] and all(
        len(res[r.rid].tokens) == r.max_new for r in reqs),
        f"phase 11: soak (scrub {scrub}) left requests unfinished")
    return res, agg, rec


def _soak_line(label, agg, rec, card) -> str:
    sc, ecc = agg["scrub"], agg["ecc"]
    age = rec["age_ms"]
    return (f"phase 11: soak {label}: decode {agg['decode_tok_s']:.1f} tok/s "
            f"({agg['decode_steps']} steps), {sc['events']} scrub events "
            f"({sc['rows_reencoded']} rows re-encoded, corrected cleared "
            f"{sc['corrected_cleared']}, uncorrectable cleared "
            f"{sc['uncorrectable_cleared']}), ECC reads={ecc['reads']} "
            f"corrected={ecc['corrected']} uncorrectable="
            f"{ecc['uncorrectable']}; {len(age)} aging ticks of "
            f"{sum(age) / max(len(age), 1):.1f} ms (min "
            f"{min(age, default=0):.1f}, max {max(age, default=0):.1f}); "
            f"hook {rec['hook_s']:.2f} s of {rec['wall_s']:.2f} s "
            f"({100 * rec['hook_s'] / rec['wall_s']:.1f}%); accounting "
            f"{rec['charge_s'] * 1e3 / max(ecc['reads'], 1):.3f} ms a "
            f"charged read, on {card}")


def _unembed_scales(scales: dict):
    """Wrap the LM's unembed read to record |h| @ |W| for every logit row
    it produces, keyed by the row's bytes: the magnitude of each logit's
    sum before cancellation, which bounds its summation-order error. W is
    the read image's decoded weights, decoded once per image."""
    from repro_torch.core import cim
    from repro_torch.models import lm
    real, absw = lm._unembed_logits, {}

    def record(params, x, pos=0, req_salt=None):
        out = real(params, x, pos=pos, req_salt=req_salt)
        store = params["unembed"]
        if id(store) not in absw:
            absw.clear()
            absw[id(store)] = cim.read(store)[0].abs()
        v = out.shape[-1]
        mag = x.reshape(-1, x.shape[-1]).abs() @ absw[id(store)]
        for row, m in zip(out.reshape(-1, v).cpu().numpy(), mag.cpu()):
            scales[row.tobytes()] = m
        return out
    return mock.patch.object(lm, "_unembed_logits", record)


def phase_scrub(model, kernel_lib, card: str) -> None:
    """Phase 11 (a) and (b): the drift-aging scrub soak on full-width
    olmo-1b, scrub off and on, then on again with the row cache off so every
    unembed read goes through K1's narrow kernel."""
    import numpy as np
    import torch
    from repro_torch.kernels.cim_read import ops, ref
    from repro_torch.core import cim
    kernel_read = ops.cim_linear_store       # unwrapped by _kernels_of below
    off, agg_off, rec_off = _soak(model, scrub=False)
    on, agg_on, rec_on = _soak(model, scrub=True)
    events = rec_on["ctl"].events
    _check(len(events) >= 1, "phase 11: scrub-on soak logged no scrub")
    _check(agg_off["scrub"]["events"] == 0, "phase 11: scrub-off scrubbed")
    first = events[0]["tick"]
    same = [t for t in rec_on["digests"] if t <= first]
    _check(bool(same) and all(rec_on["digests"][t] == rec_off["digests"][t]
                              for t in same),
           f"phase 11: the arms' aged images differ before the first scrub "
           f"(ticks {same})")
    _check(agg_on["ecc"]["uncorrectable"] < agg_off["ecc"]["uncorrectable"],
           f"phase 11: scrub-on {agg_on['ecc']['uncorrectable']} "
           f"uncorrectable events, scrub-off {agg_off['ecc']['uncorrectable']}")
    _check(all(r.finite for r in on.values()),
           "phase 11: a scrub-on request saw non-finite logits")
    _check(rec_on["image_checked"] >= 1 and rec_on["resets_checked"] >= 1,
           "phase 11: no scrubbed image or store_ecc reset was checked")
    for label, agg, rec in (("off", agg_off, rec_off), ("on", agg_on, rec_on)):
        print(_soak_line(label, agg, rec, card))
    print(f"phase 11: scrub-on: {len(events)} scrubs at ticks "
          f"{[e['tick'] for e in events]}, one store's scrub "
          f"{np.mean(rec_on['scrub_ms']):.1f} ms (min "
          f"{min(rec_on['scrub_ms']):.1f}, max {max(rec_on['scrub_ms']):.1f}); "
          f"the arms' images equal at ticks {same} (first scrub at tick "
          f"{first}); {rec_on['image_checked']} scrubbed stores == "
          f"pack(read(image)) bitwise; {rec_on['resets_checked']} store_ecc "
          f"resets; non-finite requests scrub-off "
          f"{sum(not r.finite for r in off.values())}, scrub-on 0")
    del off

    # (b) the row cache off: K1's narrow kernel reads every unembed
    g = torch.Generator(device=model.embed.device).manual_seed(7)
    x = torch.randn((BATCH, K), generator=g, device=model.embed.device)
    swaps = []

    def check_swap(eng):
        store = eng.params["unembed"]
        got = kernel_read(x, store, device=store.device)
        want, _ = ref.cim_read_ref(x, store)
        w, _ = cim.read(store)
        ok, err = _close(got, want, x.abs() @ w.abs())
        _check(ok, f"phase 11 (b): K1 on the swapped image vs plain (max "
               f"err {err:.3e})")
        swaps.append(err)
    scales = {}
    kernel_lib.reset_launch_counts()
    with _unembed_scales(scales):
        (nc, agg_nc, rec_nc), kernels = _kernels_of(lambda: _soak(
            model, scrub=True, serving_kw={"row_cache": False},
            on_swap=check_swap))
    counts = dict(kernel_lib.launch_counts)
    reqs = rec_nc["reqs"]
    chunks = sum(-(-r.tokens.size // ENGINE_CHUNK) for r in reqs)
    want = chunks + agg_nc["decode_steps"]
    _check(counts == {"cim_read_matmul_one4n": want, "cim_read_matmul_raw": 0}
           and kernels == ["narrow"] * want,
           f"phase 11 (b): launches {counts} through {sorted(set(kernels))}, "
           f"expected {want} narrow K1 reads ({chunks} prefill chunks + "
           f"{agg_nc['decode_steps']} steps)")
    _check(len(swaps) == rec_nc["swaps"] >= 1, "phase 11 (b): no swap checked")
    # The scrub-on image keeps the weights its uncorrectable rows decoded
    # to (up to 2^15), so a logit can sum to |h| @ |W| ~ 1e5 and cancel:
    # the row cache's sgemm and K1's fixed-order sums then differ by far
    # more than allclose(1e-4, 1e-4) of the result. Held, as phase 2 holds
    # faulted images, within 1e-4 of |h| @ |W| (its summation-order bound).
    worst, ratio = 0.0, 0.0
    for r in reqs:
        a, b = on[r.rid], nc[r.rid]
        _check(a.tokens == b.tokens and a.ecc == b.ecc,
               f"phase 11 (b): request {r.rid} tokens/ECC != soak (a) on")
        for ra, rb in zip(a.logits, b.logits):
            mag = scales[rb.tobytes()]
            ta, tb = torch.from_numpy(ra), torch.from_numpy(rb)
            ok, err = _close(tb, ta, mag)
            _check(ok, f"phase 11 (b): request {r.rid} logits vs soak (a) "
                   f"beyond 1e-4 of |h| @ |W| (max err {err:.3e})")
            fin = torch.isfinite(ta)
            worst = max(worst, err)
            ratio = max(ratio, float(((ta - tb).abs()[fin]
                                      / (mag[fin] + 1e-30)).max()))
    _check([e["tick"] for e in rec_nc["ctl"].events] == [e["tick"]
                                                         for e in events],
           "phase 11 (b): scrubs at other ticks than soak (a)")
    print(_soak_line("on, row cache off", agg_nc, rec_nc, card))
    print(f"phase 11 (b): {want} unembed reads, every one a narrow K1 launch "
          f"(counts {counts}); after each of {len(swaps)} swaps K1 on the new "
          f"image == plain within 1e-4 of |x| @ |W| (max err "
          f"{max(swaps):.3e}); tokens and ECC == soak (a) on, logits max err "
          f"{worst:.3e}, at most {ratio:.2e} of |h| @ |W|")


def phase_fleet(model, kernel_lib, card: str) -> None:
    """Phase 11 (c) and (d): two engine replicas on the card behind the
    router, then the fleet's invariance with ECC accounting."""
    import shutil
    import torch
    from repro_torch.launch import engine as engine_lib
    from repro_torch.launch import fleet as fleet_lib
    spool = ROOT / "build" / "fleet_spool"
    shutil.rmtree(spool, ignore_errors=True)
    params = _engine_params(model, ENGINE_ARMS[0])
    load = engine_lib.LoadGen(vocab_size=model.cfg.vocab_size, **ENGINE_LOAD)
    reqs, max_len = load.requests(), load.max_len()
    kw = dict(n_slots=ENGINE_SLOTS, max_len=max_len, chunk=ENGINE_CHUNK)
    try:
        fl = fleet_lib.Fleet.from_serving_params(
            model, params, n_replicas=FLEET_REPLICAS,
            spool_dir=str(spool / "c"), ecc_accounting=False, **kw)
        kernel_lib.reset_launch_counts()
        with torch.inference_mode():
            res, agg = fl.run(reqs)
        counts = dict(kernel_lib.launch_counts)
        reads = sum(rep.engine.steps * ENGINE_SLOTS
                    for rep in fl.replicas.values())
        reads += sum(-(-r.prompt_len // ENGINE_CHUNK)
                     - r.prefix_tokens // ENGINE_CHUNK for r in res.values())
        by_rep = agg["requests_by_replica"]
        _check(sorted(res) == [r.rid for r in reqs] and all(
            len(res[r.rid].tokens) == r.max_new for r in reqs),
            f"phase 11 (c): fleet served {sorted(res)}")
        _check(min(by_rep.values()) >= 1, f"phase 11 (c): routing {by_rep}")
        _check(counts["cim_read_matmul_one4n"] == reads,
               f"phase 11 (c): K1 launched {counts}, the engines read "
               f"{reads} times")
        sp = agg["spool"]
        print(f"phase 11 (c): fleet of {FLEET_REPLICAS} (fused one4n dynamic, "
              f"BER {ENGINE_BER:g}, {ENGINE_SLOTS} slots each): "
              f"{agg['tok_s']:.1f} tok/s wall, {agg['tok_s_virtual']:.1f} "
              f"tok/s virtual (busiest replica {agg['busy_wall_s']:.2f} s of "
              f"{agg['wall_s']:.2f} s), routed {by_rep}, TTFT mean "
              f"{agg['ttft_s_mean'] * 1e3:.1f} ms p95 "
              f"{agg['ttft_s_p95'] * 1e3:.1f} ms; K1 launched "
              f"{counts['cim_read_matmul_one4n']} times == the engines' "
              f"{reads} reads; spool {sp['bytes'] / 1e6:.1f} MB, saved in "
              f"{sp['save_s']:.2f} s, restored {FLEET_REPLICAS}x in "
              f"{sp['restore_s']:.2f} s, on {card}")
        del fl, res
        _fleet_invariance(model, params, spool / "d")
    finally:
        shutil.rmtree(spool, ignore_errors=True)


def _fleet_invariance(model, params, spool) -> None:
    """Phase 11 (d): with ECC accounting, a routed rid re-served through a
    one-replica fleet from the same spool, and every request of a replica
    failed after two ticks, equal the routed run bitwise."""
    import torch
    from repro_torch.launch import engine as engine_lib
    from repro_torch.launch import fleet as fleet_lib
    load = engine_lib.LoadGen(n_requests=4, prompt_lens=(8, 32),
                              gen_lens=(3, 6), vocab_size=model.cfg.vocab_size,
                              seed=0)
    reqs, max_len = load.requests(), load.max_len()
    kw = dict(n_slots=ENGINE_SLOTS, max_len=max_len, chunk=ENGINE_CHUNK,
              collect_logits=True, spool_dir=str(spool))

    def fleet(n):
        return fleet_lib.Fleet.from_serving_params(model, params,
                                                   n_replicas=n, **kw)
    with torch.inference_mode():
        routed, _ = fleet(FLEET_REPLICAS).run(reqs)
        rid = 1
        solo, _ = fleet(1).run([reqs[rid]])
        _check(_same_request(routed[rid], solo[rid]),
               f"phase 11 (d): probe rid {rid} routed != one-replica replay")
        fl = fleet(FLEET_REPLICAS)
        fl.start()
        for r in reqs:
            fl.submit(r)
        fl.tick()
        fl.tick()
        fl.fail("replica0")
        moved = fl.requeued
        fl.tick()
        fl.recover("replica0")
        while fl.busy:
            fl.tick()
    _check(moved >= 1 and fl.drains == 1, "phase 11 (d): the drain moved "
           "no request")
    _check("replica0" in fl._admitting, "phase 11 (d): replica0 not "
           "re-admitted")
    for r in reqs:
        _check(_same_request(routed[r.rid], fl.results[r.rid]),
               f"phase 11 (d): request {r.rid} after the drain != routed")
    print(f"phase 11 (d): with ECC accounting, rid {rid} (routed via "
          f"{routed[rid].replica}) == its one-replica replay from the same "
          f"spool bitwise (tokens, {len(routed[rid].logits)} logit vectors, "
          f"ECC {routed[rid].ecc}); fail('replica0') after two ticks "
          f"re-routed {moved} requests, all 4 == the routed run bitwise; "
          f"replica0 re-admitted")


def phase_resume(dev, card: str) -> None:
    """Phase 11 (e): reduced olmo-1b, 4 aligned steps twice uninterrupted,
    and interrupted after its step-2 checkpoint then resumed; one step with
    gradient compression."""
    import math
    import shutil
    import torch
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.data.synthetic import CheckpointableLoader, MarkovLM
    from repro_torch.training import loop
    cfg = get_config("olmo-1b").reduced()
    ckdir = ROOT / "build" / "resume_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    run = _align_rule_run(4, learning_rate=REDUCED_LR, warmup_steps=1)

    def train(r, **kw):
        data = CheckpointableLoader(MarkovLM(cfg.vocab_size, TRAIN_SEQ,
                                             TRAIN_BATCH, seed=0))
        return loop.run_training(cfg, r, data, device=dev, **kw)

    class Stop(Exception):
        pass

    def stop(step, metrics):
        if step == 2:
            raise Stop
    try:
        a, b = train(run), train(run)
        ck = RunConfig(**{**run.__dict__, "checkpoint_dir": str(ckdir),
                          "checkpoint_every": 2})
        try:
            train(ck, log_fn=stop)
            raise AssertionError("phase 11 (e): the interruption did not stop "
                                 "the run")
        except Stop:
            pass
        c = train(ck)
        _check(c.info["resumed_from"] == 2, f"phase 11 (e): resumed from "
               f"{c.info['resumed_from']}")
        comp = train(RunConfig(**{**run.__dict__, "steps": 1,
                                  "grad_compression": True}))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    def gap(x, y):
        return max(float((x.state.params[p] - y.state.params[p]).abs().max())
                   for p in x.state.params)
    ab = gap(a, b)
    bitwise = all(torch.equal(a.state.params[p], b.state.params[p])
                  for p in a.state.params)
    ac = gap(a, c)
    losses = [h["loss"] for h in c.history]
    if bitwise:
        _check(all(torch.equal(a.state.params[p], c.state.params[p])
                   for p in a.state.params) and
               losses == [h["loss"] for h in a.history[2:]],
               f"phase 11 (e): resumed run != uninterrupted (max gap {ac:.3e})")
    else:
        _check(ac <= ab, f"phase 11 (e): resumed run {ac:.3e} from the "
               f"uninterrupted, more than two uninterrupted runs ({ab:.3e})")
    _check(math.isfinite(comp.history[0]["loss"]),
           "phase 11 (e): compressed step loss not finite")
    print(f"phase 11 (e): reduced olmo-1b, 4 aligned steps: two uninterrupted "
          f"runs {'bitwise equal' if bitwise else f'max gap {ab:.3e}'}; "
          f"interrupted after the step-2 checkpoint and resumed: "
          f"{'bitwise equal' if ac == 0 else f'max gap {ac:.3e}'} to the "
          f"uninterrupted run (losses {[round(x, 6) for x in losses]}); one "
          f"step with int8 gradient compression: loss "
          f"{comp.history[0]['loss']:.6f}, on {card}")


def phase_scrub_fleet(model, kernel_lib, card: str) -> None:
    """Phase 11: scrubbing, the fleet and training's resume."""
    t0 = time.perf_counter()
    phase_scrub(model, kernel_lib, card)
    phase_fleet(model, kernel_lib, card)
    phase_resume(model.embed.device, card)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s on {card}")


def _cw2d(store):
    cw = store.codewords
    return cw.reshape(cw.shape[0], -1)


def _fi_planes(checks: dict) -> dict:
    """The K3 planes of the full-width unembed images: name -> (plane,
    positions)."""
    one4n = checks["cim_read_matmul_one4n"]["store"]
    none = checks["cim_read_matmul_raw"]["store"]
    return {"one4n man": (one4n.man, range(10)),
            "one4n codewords": (_cw2d(one4n), range(32)),
            "none exp": (none.exp, range(5)),
            "none sign": (none.sign, range(32))}


def phase_fault_inject(dev, checks: dict, fi_kernel) -> dict:
    """K3/K4 against their plain versions on the card, bit for bit; K4
    driven through its entry point ``fault_inject_fp16``."""
    import numpy as np
    import torch
    from repro_torch.core import bitops
    from repro_torch.kernels.fault_inject import ops, ref
    seeds = np.asarray([0x1234567, 0xDEADBEEF, 7, 2 ** 31 + 11], np.uint32)
    thr = ops.ber_to_threshold(1e-3)
    g = torch.Generator(device=dev).manual_seed(9)
    ragged = torch.randint(0, 2 ** 16, (1000, 777), generator=g, device=dev,
                           dtype=torch.int32).to(torch.uint16)
    cases = [(name, plane, pos, thr) for name, (plane, pos)
             in _fi_planes(checks).items()]
    cases += [(f"ragged [1000, 777] thr {t:#x}", ragged, range(16), t)
              for t in (0, 0xFFFFFFFF)]
    err = {"K3": 0.0, "K4": 0.0}
    for name, plane, pos, t in cases:
        got = ops.fault_inject_bits_batched(plane, seeds, t, positions=pos)
        want = ref.fault_inject_batched_ref(plane, seeds, t, positions=pos)
        torch.cuda.synchronize()
        err["K3"] = max(err["K3"], _word_err(got, want))
        _check(torch.equal(got, want), f"K3 != plain on the {name} plane")
        flips = _flipped_bits(got, plane)
        print(f"phase 4: K3 {name} {tuple(plane.shape)} {plane.dtype} T=4: "
              f"bitwise equal to plain, {flips} bits flipped")
    _check(bool(torch.equal(
        ops.fault_inject_bits_batched(ragged, seeds, 0, positions=range(16)),
        ragged[None].expand(4, -1, -1))), "threshold 0 flipped a bit")

    # K3 under each fault process and Fig. 6's burst: the Fig. 6 unembed
    # mantissa plane and the flattened codeword plane, whose column unit is
    # S*W words; one launch a call
    one4n = checks["cim_read_matmul_one4n"]["store"]
    cw = one4n.codewords

    def k3_once(plane, pos, t, spec, col_div):
        before = fi_kernel.launch_counts[fi_kernel.K3]
        got = ops.fault_inject_bits_batched(plane, seeds, t, positions=pos,
                                            model=spec, col_div=col_div)
        n = fi_kernel.launch_counts[fi_kernel.K3] - before
        _check(n == 1, f"K3 under {spec}: {n} launches for one call")
        return got
    for spec in MODEL_SPECS + FIG6_MODELS[1:]:
        for name, plane, pos, col_div in (
                ("one4n man", one4n.man, range(10), 1),
                ("one4n codewords", _cw2d(one4n), range(32),
                 cw.shape[2] * cw.shape[3])):
            got = k3_once(plane, pos, thr, spec, col_div)
            want = _plain_k3(plane, seeds, thr, pos, spec, col_div)
            torch.cuda.synchronize()
            err["K3"] = max(err["K3"], _word_err(got, want))
            _check(torch.equal(got, want), f"K3 under {spec} != plain on the "
                   f"{name} plane")
            del want
            iid = ops.fault_inject_bits_batched(plane, seeds, thr,
                                                positions=pos)
            f_model = (got.to(torch.int64) ^ plane[None].to(torch.int64)) \
                & 0xFFFFFFFF
            f_iid = (iid.to(torch.int64) ^ plane[None].to(torch.int64)) \
                & 0xFFFFFFFF
            n_model, n_iid = _popcount(f_model), _popcount(f_iid)
            extra = _popcount(f_model & ~f_iid)
            _check(extra == 0 and 0 < n_model < n_iid,
                   f"K3 under {spec} on {name}: {n_model} flips, {extra} "
                   f"outside the i.i.d. set of {n_iid}")
            del got, iid, f_model, f_iid
            print(f"phase 4: K3 under {spec} on the {name} plane "
                  f"{tuple(plane.shape)} (col_div {col_div}) T=4: bitwise "
                  f"equal to plain; {n_model} of the i.i.d. {n_iid} bits "
                  f"flipped, a subset")
    # the burst kernel's edges: every unit live (rate 1), none (rate 0),
    # and the ragged plane, whose units straddle its BURST_ROWS-row tiles
    # (length 5; col_div 3: 15-word column units), on each axis
    edges = [("one4n man", one4n.man, range(10), thr,
              f"burst:rate={rate},length=4,axis={axis}", 1)
             for rate, axis in ((1.0, "col"), (0.0, "bank"))]
    edges += [("ragged [1000, 777]", ragged, range(16), t,
               f"burst:rate=0.5,length=5,axis={axis}", 3)
              for axis in ("row", "col", "bank") for t in (thr, 0xFFFFFFFF)]
    for name, plane, pos, t, spec, col_div in edges:
        got = k3_once(plane, pos, t, spec, col_div)
        want = _plain_k3(plane, seeds, t, pos, spec, col_div)
        torch.cuda.synchronize()
        err["K3"] = max(err["K3"], _word_err(got, want))
        _check(torch.equal(got, want), f"K3 under {spec} != plain on the "
               f"{name} plane (col_div {col_div}, threshold {t:#x})")
        flips = _flipped_bits(got, plane)
        _check(flips > 0 or "rate=0.0" in spec,
               f"K3 under {spec} on {name} flipped nothing")
        _check(flips == 0 or "rate=0.0" not in spec,
               f"K3 under {spec} on {name} flipped {flips} bits")
        print(f"phase 4: K3 under {spec} on the {name} plane (col_div "
              f"{col_div}, threshold {t:#x}) T=4: bitwise equal to plain, "
              f"{flips} bits flipped")
        del got, want

    # K4's main path: the fault_inject_fp16 entry point on the unembed
    w = checks["unembed_weights"]
    fi_kernel.reset_launch_counts()
    outs = {f: ops.fault_inject_fp16(w, seed=5, ber=1e-3, field=f)
            for f in FIELDS}
    k4_launches = fi_kernel.launch_counts[fi_kernel.K4]
    _check(k4_launches == len(FIELDS) and
           fi_kernel.launch_counts[fi_kernel.K3] == 0,
           f"fault_inject_fp16 launched {dict(fi_kernel.launch_counts)}")
    bits = bitops.to_bits(w)
    _check(ref.static_threshold(1e-3) + 1 == thr, "K4 threshold rule")
    for f, out in outs.items():
        want = bitops.bits_to_dtype(ref.fault_inject_ref(
            bits, seed=5, ber=1e-3,
            positions=bitops.FP16.field_bit_positions(f)), torch.float32)
        err["K4"] = max(err["K4"], _word_err(out.view(torch.int32),
                                             want.view(torch.int32)))
        _check(torch.equal(out.view(torch.int32), want.view(torch.int32)),
               f"K4 (fault_inject_fp16 field={f}) != plain")
    print(f"phase 4: K4 fault_inject_fp16 on the [{K}, {J}] unembed, fields "
          f"{', '.join(FIELDS)}: bitwise equal to plain, {k4_launches} "
          f"launches")
    _k4_round_trip_gates(dev, fi_kernel)
    big = torch.zeros((), dtype=torch.uint16, device=dev).expand(
        2 ** 14, 2 ** 13 + 1)
    try:
        ops.fault_inject_bits_batched(big, seeds, thr, positions=(0,))
    except ValueError as refusal:
        print(f"phase 4: 2^27 + 1 elements refused: {refusal}")
    else:
        raise AssertionError("chip_smoke: a 2^27 + 1 element plane was taken")
    return {"k4_launches": k4_launches, "max_abs_err": err}


def _k4_round_trip_gates(dev, fi_kernel, side: int = 2 ** 14,
                         planes: int = None) -> None:
    """K4's fused float32 round trip: every one of the 2^32 float32 bit
    patterns, in 16 planes of 2^28 (two counter chunks each), through
    ``ops.fault_inject_runs`` at threshold 0, bitwise
    ``fp16_bits_to_f32(to_bits(x))`` on the card (torch's own cast, NaNs
    included); then a [4096, 4096] plane of specials and random words at
    BER 1e-3, in place and not, bitwise its plain version. ``side`` and
    ``planes`` shrink it for a rehearsal on the CPU."""
    import numpy as np
    import torch
    from repro_torch.core import bitops, fault
    from repro_torch.kernels.fault_inject import ops, ref
    piece = side * side                  # 2^28 words a plane on the card
    planes = 2 ** 32 // piece if planes is None else planes
    runs = fault.leaf_runs(side, side)
    fi_kernel.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(planes):
        words = torch.arange(i * piece, (i + 1) * piece, dtype=torch.int64,
                             device=dev)
        x = (words - (words >= 2 ** 31).to(torch.int64) * 2 ** 32).to(
            torch.int32).view(torch.float32).view(side, side)
        del words
        got = ops.fault_inject_runs(x, runs, seed=i, ber=0.0,
                                    positions=range(16))
        for r0 in range(0, side, side // 4):     # the reference by quarters
            want = bitops.fp16_bits_to_f32(bitops.to_bits(
                x[r0:r0 + side // 4]))
            _check(torch.equal(got[r0:r0 + side // 4].view(torch.int32),
                               want.view(torch.int32)),
                   f"phase 4: K4's float32 round trip differs from "
                   f"fp16_bits_to_f32(to_bits(x)) in words "
                   f"{i * piece + r0 * side:#x}..")
            del want
        del x, got
    torch.cuda.synchronize()
    n = fi_kernel.launch_counts[fi_kernel.K4]
    _check(n == planes, f"phase 4: {n} K4 launches for {planes} planes")
    secs = time.perf_counter() - t0
    g = torch.Generator(device=dev).manual_seed(13)
    words = torch.randint(-2 ** 31, 2 ** 31, (4096 * 4096,), generator=g,
                          dtype=torch.int64, device=dev).to(torch.int32)
    specials = torch.from_numpy(np.asarray(K4_SPECIALS, np.uint32).view(
        np.int32)).to(dev)
    words[:specials.numel()] = specials
    words[-specials.numel():] = specials
    x = words.view(torch.float32).view(4096, 4096)
    pos = bitops.FP16.field_bit_positions("full")
    kw = dict(seed=0xC0FFEE, ber=1e-3, positions=pos, fold=False)
    want = ref.fault_inject_runs_ref(x, ((0, 0, 0),), **kw)
    got = ops.fault_inject_runs(x, ((0, 0, 0),), **kw)
    y = x.clone()
    ops.fault_inject_runs(y, ((0, 0, 0),), out=y, **kw)
    torch.cuda.synchronize()
    for what, t in (("", got), (" in place", y)):
        _check(torch.equal(t.view(torch.int32), want.view(torch.int32)),
               f"phase 4: K4's float32 draw{what} of the specials plane "
               f"differs from its plain version")
    changed = int((got.view(torch.int32) != bitops.fp16_bits_to_f32(
        bitops.to_bits(x)).view(torch.int32)).sum())
    print(f"phase 4: K4 float32 round trip at threshold 0: "
          f"{planes * piece} float32 bit patterns of 2^32 ({planes} planes "
          f"of {piece}, one launch each) bitwise "
          f"fp16_bits_to_f32(to_bits(x)) on the card, {secs:.1f} s; a "
          f"[4096, 4096] plane of {len(K4_SPECIALS)} specials (twice) and "
          f"random words at BER 1e-3: in place and not bitwise its plain "
          f"version, {changed} words changed by flips")


def _plain_k3(plane, seeds, thr, positions, spec, col_div=1, at=None):
    """K3's plain version under the fault process ``spec`` (drift pre-scaled
    by its static tick, as the entry point does), at the column placement
    ``at`` when given."""
    from repro_torch.core import faultmodels as fm
    from repro_torch.kernels.fault_inject import ref
    model = fm.parse_fault_model(spec)
    m_thr, m_len = fm.model_scalars(model)
    return ref.fault_inject_batched_ref(
        plane, seeds, fm.compiled_threshold(model, thr),
        positions=tuple(positions), m_thr=m_thr, m_len=m_len,
        model_kind=model.kind if model else "iid",
        model_axis=model.axis if model else "row", col_div=col_div, at=at)


def _word_err(a, b) -> float:
    """Largest |a - b| over the words, as unsigned integers."""
    import torch
    a, b = (t.to(torch.int64) & 0xFFFFFFFF for t in (a, b))
    return float((a - b).abs().max())


def _flipped_bits(got, plane) -> int:
    """Bits that differ between ``got`` [T, ...] and ``plane``."""
    import torch
    return _popcount((got.to(torch.int64) ^ plane[None].to(torch.int64))
                     & 0xFFFFFFFF)


def _fig6_setup(dev, model):
    """Fig. 6's inputs on ``model``: (its reference-layout params, the
    agreement eval, the CIM config, the trial seeds [arms, BERs, trials])."""
    import torch
    from repro_torch import convert
    from repro_torch.core import cim
    from repro_torch.core import sweep as sweep_lib
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.models import lm
    cfg = model.cfg
    params = convert.flat_from_lm(model)
    toks = torch.from_numpy(MarkovLM(cfg.vocab_size, FIG6_SEQ, FIG6_BATCH,
                                     seed=0).batch(0)["tokens"]).long().to(dev)
    cim_cfg = cim.CIMConfig(n_group=8, index=2)
    # the clean model is the deployed one without faults: exponent-aligned
    # embed and unembed (alignment does not depend on the protection arm)
    _, aligned = cim.deploy_pytree_impl(params, cim_cfg)
    with torch.no_grad():
        clean = lm.forward(model, aligned, toks).argmax(-1)
    del aligned

    def agreement(p):
        with torch.no_grad():
            return (lm.forward(model, p, toks).argmax(-1) == clean) \
                .to(torch.float32).mean()

    seeds = sweep_lib.default_seeds(6, len(FIG6_PROTECTS), len(FIG6_BERS),
                                    FIG6_TRIALS)
    return params, agreement, cim_cfg, seeds


def phase_fig6(dev, model, fi_kernel) -> dict:
    """Fig. 6 on full-width olmo-1b through characterize_protection."""
    import numpy as np
    import torch
    from repro_torch.core import cim, resilience
    from repro_torch.core import faultmodels as fm
    from repro_torch.core import sweep as sweep_lib
    params, agreement, cim_cfg, seeds = _fig6_setup(dev, model)
    res, launches = {}, {}
    for a, protect in enumerate(FIG6_PROTECTS):
        fi_kernel.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = resilience.characterize_protection(
            seeds[a:a + 1], params, agreement, FIG6_BERS, cim_cfg=cim_cfg,
            n_trials=FIG6_TRIALS, protects=(protect,), device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[protect] = fi_kernel.launch_counts[fi_kernel.K3]
        want = 2 * FIG6_PLANES[protect] * len(FIG6_BERS)
        _check(launches[protect] == want, f"Fig. 6 {protect}: {launches[protect]}"
               f" K3 launches, expected {want} (2 stores x planes x BERs)")
        for r in rows:
            _check(all(0.0 <= x <= 1.0 for x in r.accuracies),
                   f"Fig. 6 {protect}: agreement out of range")
            print(f"phase 5: fig6 {protect} ber {r.ber:.0e}: agreement "
                  f"{r.mean:.4f} +- {r.std:.4f}, corrected {r.corrected:.1f}, "
                  f"uncorrectable {r.uncorrectable:.1f}")
        print(f"phase 5: fig6 {protect}: {secs:.2f} s wall for "
              f"{len(FIG6_BERS)} BERs x {FIG6_TRIALS} trials, "
              f"{launches[protect]} K3 launches")
        res[protect] = {"rows": rows, "seconds": secs}
    _profile_arm(dev, lambda: resilience.characterize_protection(
        seeds[-1:], params, agreement, FIG6_BERS, cim_cfg=cim_cfg,
        n_trials=FIG6_TRIALS, protects=(FIG6_PROTECTS[-1],), device=dev),
        res[FIG6_PROTECTS[-1]]["seconds"],
        f"phase 5: fig6 {FIG6_PROTECTS[-1]} profiled")
    _check(all(r.corrected == 0 for r in res["none"]["rows"]),
           "Fig. 6: the none arm corrected codewords")
    _check(res["one4n"]["rows"][-1].corrected > 0,
           "Fig. 6: one4n corrected nothing at 1e-3")

    # the fault_models axis: one4n under i.i.d. and burst in one plan; its
    # i.i.d. arm takes the default plan's one4n seeds and must give its
    # rows value for value
    a = FIG6_PROTECTS.index("one4n")
    mseeds = np.concatenate([seeds[a:a + 1], sweep_lib.default_seeds(
        7, 1, len(FIG6_BERS), FIG6_TRIALS)])
    fi_kernel.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mrows = resilience.characterize_protection(
        mseeds, params, agreement, FIG6_BERS, cim_cfg=cim_cfg,
        n_trials=FIG6_TRIALS, protects=("one4n",), fault_models=FIG6_MODELS,
        device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    m_launches = fi_kernel.launch_counts[fi_kernel.K3]
    want = len(FIG6_MODELS) * 2 * FIG6_PLANES["one4n"] * len(FIG6_BERS)
    _check(m_launches == want, f"Fig. 6 fault_models: {m_launches} K3 "
           f"launches, expected {want}")
    iid_rows = [r for r in mrows if r.fault_model == "iid"]
    for r, base in zip(iid_rows, res["one4n"]["rows"]):
        _check(r.accuracies == base.accuracies and
               (r.corrected, r.uncorrectable) ==
               (base.corrected, base.uncorrectable),
               f"Fig. 6 fault_models: the iid arm at {r.ber:.0e} gives "
               f"{r.accuracies}, the default plan {base.accuracies}")
    for r in mrows:
        _check(all(0.0 <= x <= 1.0 for x in r.accuracies),
               f"Fig. 6 {r.fault_model}: agreement out of range")
        print(f"phase 5: fig6 one4n {r.fault_model} ber {r.ber:.0e}: "
              f"agreement {r.mean:.4f} +- {r.std:.4f}, corrected "
              f"{r.corrected:.1f}, uncorrectable {r.uncorrectable:.1f}")
    print(f"phase 5: fig6 one4n fault_models {FIG6_MODELS}: {secs:.2f} s, "
          f"{m_launches} K3 launches; the iid arm equals the default plan's "
          f"rows value for value")

    # cells again with the plain injection on the card: every trial at 1e-5,
    # where agreement varies between trials, and trial 0 at 1e-3, where the
    # ECC counts are largest
    a = FIG6_PROTECTS.index("one4n")
    stores, _ = cim.deploy_pytree_impl(params, cim.CIMConfig(
        n_group=8, index=2, protect="one4n"))

    def plain(bits, seeds_, threshold, positions, model=None, col_div=1,
              at=None, plane=None):
        return _plain_k3(bits, seeds_, threshold, positions, model, col_div,
                         at=sweep_lib.fi_ops.placement(at, bits.shape[1],
                                                       plane))
    for b, n_redo in ((0, FIG6_TRIALS), (len(FIG6_BERS) - 1, 1)):
        row = res["one4n"]["rows"][b]
        thr = sweep_lib.fi_ops.ber_to_threshold(FIG6_BERS[b])
        fast = sweep_lib.cim_inject_pytree_batched(stores, seeds[a, b], thr)
        with mock.patch.object(sweep_lib, "_inject", plain):
            slow = sweep_lib.cim_inject_pytree_batched(
                stores, seeds[a, b][:n_redo], thr)
        counts, accs = [], []
        for i in range(n_redo):
            trial = {"kernel": sweep_lib.trial_params(fast, i),
                     "plain": sweep_lib.trial_params(slow, i)}
            for path in ("embed", "unembed"):
                for plane in ("man", "codewords"):
                    _check(torch.equal(getattr(trial["kernel"][path], plane),
                                       getattr(trial["plain"][path], plane)),
                           f"Fig. 6 one4n {FIG6_BERS[b]:.0e} trial {i} "
                           f"{path}.{plane}: K3 != plain injection")
            (wk, sk), (wp, sp) = (cim.read_pytree_impl(trial[n])
                                  for n in ("kernel", "plain"))
            _check(sk == sp, f"Fig. 6 ECC counts: kernel {sk} != plain {sp}")
            acc_k, acc_p = float(agreement(wk)), float(agreement(wp))
            _check(acc_k == acc_p == row.accuracies[i],
                   f"Fig. 6 {FIG6_BERS[b]:.0e} trial {i} agreement: kernel "
                   f"{acc_k}, plain {acc_p}, sweep {row.accuracies[i]}")
            counts.append(sp)
            accs.append(acc_p)
            del wk, wp
        if n_redo == FIG6_TRIALS:
            for key in ("corrected", "uncorrectable"):
                mean = float(np.mean([c[key] for c in counts]))
                _check(mean == getattr(row, key), f"Fig. 6 {FIG6_BERS[b]:.0e}"
                       f" mean {key}: plain {mean}, sweep {getattr(row, key)}")
        print(f"phase 5: fig6 one4n ber {FIG6_BERS[b]:.0e} trials 0..{n_redo - 1}"
              f" redone with the plain injection: stores, ECC counts {counts} "
              f"and agreement {accs} identical")
        del fast, slow

    # the burst arm's draws at 1e-3 on these same stores: the embed's and the
    # unembed's mantissa and flattened codeword planes (col_div S*W) through
    # the sweep's entry, one K3 launch a plane, bitwise the plain injection
    b = len(FIG6_BERS) - 1
    thr = sweep_lib.fi_ops.ber_to_threshold(FIG6_BERS[b])
    burst = fm.parse_fault_model(FIG6_MODELS[1])
    fi_kernel.reset_launch_counts()
    fast = sweep_lib.cim_inject_pytree_batched(stores, mseeds[1, b], thr,
                                               model=burst)
    torch.cuda.synchronize()
    n = fi_kernel.launch_counts[fi_kernel.K3]
    _check(n == 2 * FIG6_PLANES["one4n"], f"Fig. 6 {FIG6_MODELS[1]}: {n} K3 "
           f"launches for 2 stores x {FIG6_PLANES['one4n']} planes")
    with mock.patch.object(sweep_lib, "_inject", plain):
        slow = sweep_lib.cim_inject_pytree_batched(stores, mseeds[1, b], thr,
                                                   model=burst)
    for path in ("embed", "unembed"):
        for name in ("man", "codewords"):
            got = getattr(fast[path], name)
            _check(torch.equal(got, getattr(slow[path], name)),
                   f"Fig. 6 {FIG6_MODELS[1]} {path}.{name}: K3 != plain")
            flips = _flipped_bits(got, getattr(stores[path], name))
            _check(flips > 0, f"Fig. 6 {FIG6_MODELS[1]} {path}.{name}: "
                   f"nothing flipped")
            print(f"phase 5: fig6 one4n {FIG6_MODELS[1]} ber "
                  f"{FIG6_BERS[b]:.0e} {path}.{name} {tuple(got.shape)} "
                  f"{got.dtype}: bitwise equal to the plain injection, "
                  f"{flips} bits flipped")
    print(f"phase 5: fig6 one4n {FIG6_MODELS[1]}: {n} K3 launches, one a "
          f"plane")
    del fast, slow
    return {"launches": sum(launches.values()), "res": res}


def _profile_arm(dev, run, wall: float,
                 label: str = "phase 5: fig6 profile") -> None:
    """Where a run's time goes: ``torch.profiler`` over a rerun of it (a
    Fig. 6 arm, a few decode steps); the device kernels by self time, and
    their sum against the run's unprofiled ``wall`` seconds (the
    device-busy share). A measurement only: if the profiler cannot trace
    the card here, it says so and the run goes on."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    # only the profiler's own failures are tolerated: the rerun of the arm
    # (its K3 launches included) raises like every other check
    try:
        prof = profile(activities=acts)
        prof.start()
    except Exception as err:
        print(f"{label}: not measured ({err!r})")
        return
    stop_err = None
    try:
        run()
        torch.cuda.synchronize()
    finally:
        try:
            prof.stop()
        except Exception as err:
            stop_err = err
    try:
        if stop_err is not None:
            raise stop_err
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0]
    except Exception as err:
        print(f"{label}: not measured ({err!r})")
        return
    if not kernels:
        print(f"{label}: no device time traced (not measured)")
        return
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"{label}: device kernels {busy:.3f} s against {wall:.3f} s of "
          f"unprofiled wall ({100 * busy / wall:.1f}% busy)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:5d}x  "
              f"{e.key[:90]}")


def phase_fig2(dev, fi_kernel) -> int:
    """Fig. 2 on the CNN, on the card and on the CPU."""
    import numpy as np
    import torch
    from repro_torch.core import resilience
    from repro_torch.core import sweep as sweep_lib
    from repro_torch.data.synthetic import GaussianBlobs
    from repro_torch.kernels.fault_inject import ops
    from repro_torch.models import cnn
    cpu_params = cnn.init_cnn(torch.Generator().manual_seed(0), n_classes=16,
                              device="cpu")
    x, y = (torch.from_numpy(a) for a in GaussianBlobs().batch(FIG2_N, 99_999))
    seeds = sweep_lib.default_seeds(2, len(FIG2_FIELDS), len(FIG2_BERS),
                                    FIG2_TRIALS)
    runs, counts = {}, {}
    for d in (dev, torch.device("cpu")):
        params = {k: v.to(d) for k, v in cpu_params.items()}
        xd, yd = x.to(d), y.to(d).long()

        def acc(p, xd=xd, yd=yd):
            return (cnn.apply_cnn(p, xd).argmax(-1) == yd).to(torch.float32).mean()
        fi_kernel.reset_launch_counts()
        t0 = time.perf_counter()
        runs[d.type] = resilience.characterize_fields(
            seeds, params, acc, FIG2_BERS, fields=FIG2_FIELDS,
            n_trials=FIG2_TRIALS, device=d)
        secs = time.perf_counter() - t0
        counts[d.type] = fi_kernel.launch_counts[fi_kernel.K3]
        print(f"phase 6: fig2 cnn on {d.type}: {secs:.2f} s, "
              f"{counts[d.type]} K3 launches")
    launches = counts[dev.type]
    want = len(cpu_params) * len(FIG2_FIELDS) * len(FIG2_BERS)
    _check(launches == want, f"Fig. 2: {launches} K3 launches, expected {want}")
    for rc, rh in zip(runs[dev.type], runs["cpu"]):
        diff = np.abs(np.asarray(rc.accuracies) - np.asarray(rh.accuracies))
        _check(bool((diff <= 1.0 / FIG2_N + 1e-9).all()),
               f"Fig. 2 {rc.field} {rc.ber:.0e}: card {rc.accuracies} vs "
               f"cpu {rh.accuracies}")
        print(f"phase 6: fig2 {rc.field} ber {rc.ber:.0e}: card {rc.mean:.4f} "
              f"+- {rc.std:.4f}, cpu {rh.mean:.4f} (max diff {diff.max():.4g})")
    for a, field in enumerate(FIG2_FIELDS):
        for b, ber in enumerate(FIG2_BERS):
            thr = ops.ber_to_threshold(ber)
            card = sweep_lib.inject_pytree_batched(
                {k: v.to(dev) for k, v in cpu_params.items()}, seeds[a, b],
                thr, field)
            host = sweep_lib.inject_pytree_batched(cpu_params, seeds[a, b], thr,
                                                   field)
            for k in host:
                _check(torch.equal(card[k].cpu().view(torch.int32),
                                   host[k].view(torch.int32)),
                       f"Fig. 2 {field} {ber:.0e} {k}: card leaves != cpu")
    print("phase 6: fig2 faulted leaves bitwise equal card vs cpu for every "
          "(field, BER, trial)")
    return launches


def phase_fi_times(dev, checks: dict, k3_launches: int, fi: dict,
                   card: str) -> list:
    """K3 at the Fig. 6 unembed mantissa plane, K4 on the same plane and
    on float32 weights of its shape."""
    import numpy as np
    from repro_torch.kernels.fault_inject import ops, ref
    man = checks["cim_read_matmul_one4n"]["store"].man
    seeds = np.asarray([1, 2, 3, 4], np.uint32)
    thr = ops.ber_to_threshold(1e-3)
    n = man.numel()
    rows = []
    for name, t, pos, fn, plain in (
            ("fault_inject_batched", 4, range(10),
             lambda: ops.fault_inject_bits_batched(man, seeds, thr,
                                                   positions=range(10)),
             lambda: ref.fault_inject_batched_ref(man, seeds, thr,
                                                  positions=range(10))),
            ("fault_inject", 1, range(16),
             lambda: ops.fault_inject_bits(man, seed=9, ber=1e-3,
                                           positions=range(16)),
             lambda: ref.fault_inject_ref(man, seed=9, ber=1e-3,
                                          positions=range(16)))):
        ms = _time_ms(fn)
        plain_ms = _time_ms(plain, reps=3, inner=1)
        nbytes = n * 2 * (1 + t)
        hashes = n * t * len(pos)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        alu_ms = hashes * ALU_OPS_PER_DRAW / INT32_OPS * 1e3
        imad_ms = hashes * IMAD_OPS_PER_DRAW / INT32_OPS * 1e3
        ops_ms = max(alu_ms, imad_ms)
        rows.append({"name": name, "route": "cuda", "source": FI_SOURCE,
                     "replaces": REPLACES[name],
                     "launches": k3_launches if t > 1 else fi["k4_launches"],
                     "max_abs_err": fi["max_abs_err"]["K3" if t > 1 else "K4"],
                     "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": max(bytes_ms, ops_ms),
                     "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                     "library_ms": None, "bytes": nbytes, "hashes": hashes})
        if t > 1:
            rows[-1]["models"] = _k3_model_times(
                checks["cim_read_matmul_one4n"]["store"], seeds, thr, ms,
                card)
        else:
            rows[-1]["fp32"] = _k4_fp32_times(dev, card)
        print(f"phase 7: {name}: {ms:.4f} ms at [{K}, {J}] uint16, T={t}, "
              f"{len(pos)} positions; plain {plain_ms:.2f} ms; bound "
              f"{max(bytes_ms, ops_ms):.4f} ms (ALU pipe {alu_ms:.4f} ms, "
              f"FMA pipe {imad_ms:.4f} ms for {hashes / 1e9:.3f} G draws, "
              f"bytes {bytes_ms:.4f} ms for "
              f"{nbytes / 1e6:.1f} MB) on {card}")
    return rows


def _k4_fp32_times(dev, card) -> dict:
    """K4's float32 entry (``fault_inject_fp16``: fp16 bits, flips and the
    widening fused) on fp16-grid weights of the unembed's shape [K, J], all
    16 positions at BER 1e-3, beside its plain version (to_bits, K4's plain
    version, fp16_bits_to_f32); bound by the busier of the ALU pipe and 8
    bytes an element (4 read, 4 written)."""
    import torch
    from repro_torch.core import bitops
    from repro_torch.kernels.fault_inject import ops, ref
    g = torch.Generator(device=dev).manual_seed(21)
    w = (torch.randn((K, J), generator=g, device=dev) * 0.02).half().float()
    pos = range(16)

    fig = _fi_figures(
        "K4's float32 entry", lambda: ops.fault_inject_fp16(w, seed=9,
                                                           ber=1e-3),
        lambda: bitops.fp16_bits_to_f32(ref.fault_inject_ref(
            bitops.to_bits(w), seed=9, ber=1e-3, positions=pos)),
        w.numel(), 1, len(pos), nbytes=w.numel() * 8)
    print(f"phase 7: fault_inject (float32, fused round trip): "
          f"{fig['ms']:.4f} ms at [{K}, {J}], 16 positions; plain "
          f"{fig['plain_ms']:.2f} ms; bound {fig['bound_ms']:.4f} ms "
          f"({fig['bound_by']}: {fig['hashes'] / 1e9:.3f} G draws, "
          f"{fig['bytes'] / 1e6:.1f} MB) on {card}")
    del w
    return {"shape": [K, J], **fig, "library_ms": None}


def _k3_model_times(store, seeds, thr, iid_ms, card) -> dict:
    """K3 under each fault process on the unembed mantissa plane, and under
    Fig. 6's burst there and on the flattened codeword plane (32 positions,
    col_div S*W): its time beside the i.i.d. one and its plain version's,
    the draws it performs (burst: only in hit units, counted per trial from
    the plane thresholds) and their bound (the busier of the ALU pipe and
    the bytes)."""
    import torch
    from repro_torch.core import faultmodels as fm
    from repro_torch.kernels.fault_inject import ops
    cw = store.codewords
    cases = [(spec, store.man, range(10), store.man.shape, 1)
             for spec in MODEL_SPECS + FIG6_MODELS[1:]]
    cases.append((f"{FIG6_MODELS[1]} codewords", _cw2d(store), range(32),
                  cw.shape, cw.shape[2] * cw.shape[3]))
    out = {}
    for key, plane, pos, shape, col_div in cases:
        model = fm.parse_fault_model(key.split()[0])
        ms = _time_ms(lambda: ops.fault_inject_bits_batched(
            plane, seeds, thr, positions=pos, model=model, col_div=col_div))
        plain_ms = _time_ms(lambda: _plain_k3(plane, seeds, thr, pos, model,
                                              col_div), reps=1, inner=1)
        hashes = plane.numel() * len(seeds) * len(pos)
        draws = hashes
        if model.kind == "burst":
            elem = torch.arange(plane.numel(), dtype=torch.int64,
                                device=plane.device).reshape(plane.shape)
            draws = sum(int((fm.plane_thresholds(model, thr, elem, int(sd),
                                                 shape) != 0).sum())
                        for sd in seeds) * len(pos)
            del elem
        nbytes = plane.numel() * plane.element_size() * (1 + len(seeds))
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        alu_ms = draws * ALU_OPS_PER_DRAW / INT32_OPS * 1e3
        out[key] = {"ms": ms, "plain_ms": plain_ms, "draws": draws,
                    "shape": list(plane.shape),
                    "bound_ms": max(bytes_ms, alu_ms),
                    "bound_by": "bytes" if bytes_ms >= alu_ms
                    else "operations"}
        print(f"phase 7: fault_inject_batched under {key} "
              f"{tuple(plane.shape)} {plane.dtype}: {ms:.4f} ms "
              f"({ms / iid_ms:.3f}x the i.i.d. call on the mantissa plane), "
              f"plain {plain_ms:.2f} ms, "
              f"{draws / 1e9:.3f} G draws ({draws / hashes:.3f}x), bound "
              f"{max(bytes_ms, alu_ms):.4f} ms "
              f"({max(bytes_ms, alu_ms) / ms:.0%} of it) on {card}")
    return out


def _draws(store, seeds=None, thr=None, model=None) -> int:
    """Counter-PRNG draws of one dynamic read of the whole store: one per
    stored cell the read XORs a flip into (mantissa lanes, codeword lanes,
    or exponent and sign lanes), from the store's own geometry. Under a
    fault ``model`` only the words whose compiled threshold is nonzero draw
    (a burst read draws in its hit units alone): those are counted from the
    plane thresholds of ``seeds`` and ``thr``."""
    import torch
    from repro_torch.core import cim
    from repro_torch.core import faultmodels as fm
    cfg = store.cfg
    k_pad, j_pad = store.man.shape

    def live(plane, seed):
        """Words of ``plane`` that draw under the model."""
        if model is None or model.kind != "burst":
            return torch.ones(plane.shape, dtype=torch.bool,
                              device=plane.device)
        elem = torch.arange(plane.numel(), dtype=torch.int64,
                            device=plane.device).reshape(plane.shape)
        return fm.plane_thresholds(model, thr, elem, seed, plane.shape) != 0
    draws = int(live(store.man, (seeds or {}).get("man")).sum()) \
        * cfg.fmt.man_bits
    if cfg.protect == "one4n":
        lanes = torch.as_tensor([bin(int(w)).count("1") for w in
                                 cim.codeword_valid_masks(cfg)],
                                device=store.man.device)
        cw_live = live(store.codewords, (seeds or {}).get("cw"))
        return draws + int((cw_live * lanes).sum())
    exp_draws = int(live(store.exp, (seeds or {}).get("meta")).sum()) \
        * cfg.fmt.exp_bits
    sign_draws = int(live(store.sign, (seeds or {}).get("cw")).sum()) * 32
    return draws + exp_draws + sign_draws


def phase_times(dev, checks: dict, launches: dict, engine_launches: dict,
                card: str) -> list:
    """K1/K2 at the serving shape (M = BATCH). Each one's narrow kernel is
    the one the main path launches; its tile kernel is timed beside it
    through its binding. The static read is bound by bytes; the dynamic read by the
    larger of the bytes and the ALU pipe's draws (``_draws``). Each narrow
    kernel again at M = 1, the shape every read of the engine has (phase
    10), beside torch.matmul at M = 1."""
    import torch
    from repro_torch.core import cim
    from repro_torch.core import faultmodels as fm
    from repro_torch.kernels.cim_read import ops, ref
    from repro_torch.kernels.fault_inject.ops import ber_to_threshold
    thr = ber_to_threshold(MODEL_BER)
    seeds = {"man": 7, "meta": 8, "cw": 9}
    scalars = ops.make_scalars(seeds, thr, thr)
    x = torch.randn((BATCH, K), device=dev)
    rows = []
    for name, chk in checks.items():
        store = chk["store"]
        w, _ = cim.read(store)
        _, info = ops.cim_linear_store(x, store, with_info=True)
        ms = _time_ms(lambda: ops.cim_linear_store(x, store, scalars=scalars))
        ms_static = _time_ms(lambda: ops.cim_linear_store(x, store))
        plain_ms = _time_ms(lambda: ref.cim_read_ref(x, store, scalars), inner=1)
        library_ms = _time_ms(lambda: torch.matmul(x, w))
        nbytes = _store_bytes(store) + x.numel() * 4 + BATCH * J * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2.0 * BATCH * K * J / FP32_FLOPS * 1e3
        draws = _draws(store)
        hash_ms = draws * ALU_OPS_PER_DRAW / INT32_OPS * 1e3
        row = {"name": name, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[name], "launches": launches[name],
               "max_abs_err": chk["max_abs_err"], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": library_ms, "static_ms": ms_static,
               "max_abs_err_models": chk["max_abs_err_models"],
               "dynamic_bound_ms": max(bytes_ms, hash_ms),
               "dynamic_bound_by": "bytes" if bytes_ms >= hash_ms
               else "operations", "draws": draws, "bytes": nbytes,
               "variant": info["tiles"]["kernel"]}
        x1 = x[:1].contiguous()
        m1 = {"ms": _time_ms(lambda: ops.cim_linear_store(
                  x1, store, scalars=scalars)),
              "static_ms": _time_ms(lambda: ops.cim_linear_store(x1, store)),
              "library_ms": _time_ms(lambda: torch.matmul(x1, w)),
              "plain_ms": _time_ms(lambda: ref.cim_read_ref(x1, store,
                                                            scalars),
                                   reps=3, inner=1),
              "engine_launches": engine_launches[name]}
        m1_bytes = nbytes - (BATCH - 1) * (K + J) * 4
        m1["bound_ms"] = m1_bytes / HBM_BYTES_PER_S * 1e3
        m1["dynamic_bound_ms"] = max(m1["bound_ms"], hash_ms)
        row["m1"] = m1
        print(f"phase 7: {name} narrow at M = 1 (the engine's reads): "
              f"{m1['ms']:.4f} ms dynamic, {m1['static_ms']:.4f} ms static "
              f"(M = {BATCH}: {ms:.4f} / {ms_static:.4f}); plain "
              f"{m1['plain_ms']:.3f} ms, torch.matmul at M = 1 "
              f"{m1['library_ms']:.4f} ms; bound {m1['bound_ms']:.4f} "
              f"ms static (bytes), {m1['dynamic_bound_ms']:.4f} ms dynamic; "
              f"{m1['engine_launches']} launches in its engine arm, on "
              f"{card}")
        row["tile_ms"] = _time_ms(lambda: _tile(x, store, scalars))
        row["tile_static_ms"] = _time_ms(lambda: _tile(x, store))
        tile = (f"; tile kernel at M = {BATCH}: {row['tile_ms']:.4f} ms "
                f"dynamic, {row['tile_static_ms']:.4f} ms static")
        row["models"] = {}
        for spec in MODEL_SPECS:
            model = fm.parse_fault_model(spec)
            sc = ops.make_scalars(seeds, thr, thr, model=model)
            m_ms = _time_ms(lambda: ops.cim_linear_store(
                x, store, scalars=sc, model=model))
            m_draws = _draws(store, seeds, thr, model)
            m_hash_ms = m_draws * ALU_OPS_PER_DRAW / INT32_OPS * 1e3
            row["models"][spec] = {
                "ms": m_ms, "draws": m_draws,
                "bound_ms": max(bytes_ms, m_hash_ms),
                "bound_by": "bytes" if bytes_ms >= m_hash_ms
                else "operations"}
            print(f"phase 7: {name} narrow under {spec}: {m_ms:.4f} ms "
                  f"dynamic ({m_ms / ms:.3f}x the i.i.d. read), "
                  f"{m_draws / 1e9:.3f} G draws ({m_draws / draws:.3f}x), "
                  f"bound {max(bytes_ms, m_hash_ms):.4f} ms on {card}")
        rows.append(row)
        print(f"phase 7: {name} ({row['variant']} kernel): {ms:.4f} ms "
              f"dynamic, {ms_static:.4f} ms static{tile}; plain "
              f"{plain_ms:.3f} ms, torch.matmul on decoded {library_ms:.4f} "
              f"ms; static bound {max(bytes_ms, ops_ms):.4f} ms (bytes, "
              f"{nbytes / 1e6:.1f} MB), dynamic bound "
              f"{row['dynamic_bound_ms']:.4f} ms (ALU pipe {hash_ms:.4f} ms "
              f"for {draws / 1e9:.3f} G draws at {ALU_OPS_PER_DRAW} ops) on "
              f"{card}")
    return rows


def _align_rule_run(steps: int, **kw):
    from repro_torch.configs import RunConfig
    from repro_torch.core.deployment import PolicyRule, ReliabilityPolicy
    return RunConfig(steps=steps, checkpoint_dir="", **kw,
                     policy=ReliabilityPolicy(default=PolicyRule(
                         protect="one4n", n_group=N_GROUP, index=2)))


def _fp16_ulps(a, b):
    """|a - b| in fp16 ulps, per element, for tensors on the fp16 grid."""
    import torch
    return (a.cpu().to(torch.float16).view(torch.int16).to(torch.int32)
            - b.cpu().to(torch.float16).view(torch.int16).to(torch.int32)).abs()


def _check_frozen(state, zero_blocks: bool = False, tag: str = "phase 8"
                  ) -> int:
    """Every aligned leaf's weights carry their block's frozen exponent and
    their frozen sign, bitwise; one leaf at a time. Returns the weights
    checked. With ``zero_blocks``, a block frozen at exponent 0 (a block of
    zeros: the projection clamps it into [0, 2^-14], past exponent 0, in
    the reference too) and a weight frozen at sign 0 are not held to them;
    without it, none may occur."""
    import torch
    from repro_torch.core import align, bitops
    n = 0
    with torch.no_grad():
        for path, w in state.params.items():
            e = state.exps[path]
            if e is None:
                continue
            ew = bitops.biased_exponent(w)
            blocks, _ = align._block_view(ew, N_GROUP, w.ndim - 2)
            frozen = torch.movedim(e, w.ndim - 2, 0).to(torch.int64)
            ok = blocks == frozen[:, None]
            if zero_blocks:
                ok |= frozen[:, None] == 0
            _check(bool(ok.all()),
                   f"{tag}: {path} left its frozen block exponents")
            del ew, blocks, ok
            signs = state.signs[path]
            ok = torch.sign(w).to(torch.int8) == signs
            if zero_blocks:
                ok |= signs == 0
            _check(bool(ok.all()), f"{tag}: {path} left its frozen signs")
            n += w.numel()
    return n


def phase_train(dev):
    """Full-width aligned training through run_training, then reduced
    olmo-1b from one state on the card and on the CPU."""
    import math
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.models import lm
    from repro_torch.training import loop
    cfg = get_config("olmo-1b")
    run = _align_rule_run(TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # as the launcher: run_training builds LM(cfg) from
    # torch.Generator(dev).manual_seed(run.seed), takes its reference-layout
    # tree, aligns it and freezes the exponents and signs
    res = loop.run_training(cfg, run, iter(MarkovLM(
        cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)), device=dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist = res.history
    n_params = lm.param_count(res.state.params)
    print(f"phase 8: full-width olmo-1b, {n_params / 1e9:.3f} B parameters: "
          f"built, aligned (n_group {N_GROUP}, index 2) and frozen in "
          f"{wall - sum(h['step_time'] for h in hist):.1f} s of "
          f"run_training's {wall:.1f} s")
    _check(len(hist) == TRAIN_STEPS and
           all(math.isfinite(h["loss"]) for h in hist),
           f"phase 8: losses {[h['loss'] for h in hist]}")
    for h in hist:
        print(f"phase 8: step {h['step']}: loss {h['loss']:.4f} grad_norm "
              f"{h['grad_norm']:.4f} lr {h['lr']:.3e} {h['step_time'] * 1e3:.1f}"
              f" ms{' (first step)' if h['step'] == 0 else ''}")
    rest = [h["step_time"] * 1e3 for h in hist[1:]]
    print(f"phase 8: step ms: first {hist[0]['step_time'] * 1e3:.1f}, then "
          f"median {float(np.median(rest)):.1f} (min {min(rest):.1f}, max "
          f"{max(rest):.1f}); peak device memory "
          f"{peak / 2 ** 30:.2f} GiB (max_memory_allocated)")
    checked = _check_frozen(res.state)
    print(f"phase 8: after step {TRAIN_STEPS - 1}: {checked / 1e9:.3f} B aligned "
          f"weights carry their frozen block exponents and signs, bitwise")
    stats = res.ecc_stats
    _check(stats.get("stored_bits", 0) > 0, f"phase 8: ecc_stats {stats}")
    print(f"phase 8: deployment (one4n, embed + unembed): "
          f"{stats['stored_bits']} stored bits ({stats['overhead']:+.1%} vs "
          f"raw fp16), corrected {stats['corrected']}, uncorrectable "
          f"{stats['uncorrectable']}")
    res.__dict__.pop("deployment", None)
    trained = {"unembed": res.state.params["unembed"],
               "params": res.state.params, "cfg": cfg,
               "step_ms": rest, "first_ms": hist[0]["step_time"] * 1e3,
               "peak_gib": peak / 2 ** 30}
    del res
    _reduced_train_card_vs_cpu(dev)
    return trained


def _moved_state(state, dev):
    """A training state's copy on ``dev`` (the step count stays on the
    host, where the lr schedule reads it)."""
    from repro_torch.training import steps

    def moved(t):
        return {k: None if v is None else v.to(dev) for k, v in t.items()}
    return steps.TrainState(
        moved(state.params),
        {"m": moved(state.opt["m"]), "v": moved(state.opt["v"]),
         "step": state.opt["step"].clone()},
        moved(state.exps), moved(state.signs))


def _reduced_train_card_vs_cpu(dev) -> None:
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.training import loop, steps
    cfg = get_config("olmo-1b").reduced()
    # the CPU test's learning rate and warmup: the weights move many fp16
    # ulps a step, so a one-ulp bound tells a right update from a wrong one
    run = _align_rule_run(REDUCED_STEPS, learning_rate=REDUCED_LR,
                          warmup_steps=1)
    cpu_state = steps.init_train_state(torch.Generator().manual_seed(1), cfg,
                                       run, device="cpu")
    card_state = _moved_state(cpu_state, dev)
    runs = {}
    for name, state in (("card", card_state), ("cpu", cpu_state)):
        runs[name] = loop.run_training(cfg, run, iter(MarkovLM(
            cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)), state=state)
    for a, b in zip(runs["card"].history, runs["cpu"].history):
        rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        _check(rel <= LOSS_RTOL, f"phase 8 reduced step {a['step']}: loss "
               f"card {a['loss']} cpu {b['loss']}")
        _check(a["lr"] == b["lr"], f"phase 8 reduced step {a['step']}: lr "
               f"card {a['lr']} cpu {b['lr']}")
    worst, differ, total, travel = 0, 0, 0, []
    for path, w in runs["cpu"].state.params.items():
        ulps = _fp16_ulps(w, runs["card"].state.params[path])
        worst = max(worst, int(ulps.max()))
        differ += int((ulps > 0).sum())
        total += ulps.numel()
        if cpu_state.exps[path] is not None:    # aligned: on the fp16 grid
            travel.append(_fp16_ulps(w, cpu_state.params[path]).flatten())
    travel = torch.cat(travel).double()
    _check(worst <= 1, f"phase 8 reduced: parameters {worst} fp16 ulps apart")
    # the bound can see a halved or skipped update only if the updates span
    # many ulps: ask for a median travel of REDUCED_MIN_TRAVEL ulps
    med = float(travel.median())
    _check(med >= REDUCED_MIN_TRAVEL, f"phase 8 reduced: aligned weights "
           f"moved a median {med} fp16 ulps, too few for a one-ulp bound")
    _check_frozen(runs["card"].state)
    for a in runs["card"].history:
        print(f"phase 8: reduced step {a['step']}: lr {a['lr']:.3e} loss "
              f"{a['loss']:.6f} grad_norm {a['grad_norm']:.6f}")
    print(f"phase 8: reduced olmo-1b {REDUCED_STEPS} steps card vs CPU from one "
          f"state: losses within {LOSS_RTOL:g} relative, lr equal; parameters "
          f"within {worst} fp16 ulp, {differ} of {total} "
          f"({100 * differ / total:.4f}%) differ at all; the aligned weights "
          f"moved a median {med:.0f} fp16 ulps from the start (mean "
          f"{float(travel.mean()):.1f}, {100 * float((travel > 1).double().mean()):.2f}"
          f"% more than one ulp)")


def _bfp_case(dev, m, k, n, n_group, dtype):
    import torch
    from repro_torch.core import align
    from repro_torch.kernels.bfp_matmul import ref
    g = torch.Generator(device=dev).manual_seed(m * k + n)
    w = torch.randn((k, n), generator=g, device=dev) * 0.05
    w_al, _ = align.align_matrix(w, align.AlignmentConfig(n_group=n_group))
    man, exp = ref.pack_bfp(w_al, n_group)
    x = torch.randn((m, k), generator=g, device=dev).to(getattr(torch, dtype))
    return x, man, exp


def phase_bfp(dev, trained: dict, bfp_kernel) -> dict:
    """K5 on the trained model: the packed unembed serves the final-normed
    hidden states; the identity probe; ragged shapes against plain."""
    import torch
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels.bfp_matmul import ops, ref
    from repro_torch.models import lm
    cfg, w = trained["cfg"], trained["unembed"]
    man, exp = ref.pack_bfp(w, N_GROUP)
    toks = torch.from_numpy(MarkovLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                     seed=0).batch(10_000)["tokens"]).long().to(dev)
    with torch.no_grad():
        h = lm.forward(lm.shell(cfg), trained["params"], toks, unembed=False)
    h = h.reshape(-1, cfg.d_model).contiguous()
    out, info = ops.cim_linear(h, man, exp, n_group=N_GROUP, with_info=True)
    torch.cuda.synchronize()
    launches = bfp_kernel.launch_counts[bfp_kernel.K5]
    _check(info["used_kernel"] and launches == 1,
           f"phase 9: K5 not on the path (info {info}, launches {launches})")
    _check(bool(torch.isfinite(out).all()) and
           tuple(out.shape) == (TRAIN_BATCH * TRAIN_SEQ, cfg.vocab_size),
           f"phase 9: output {tuple(out.shape)} not finite or misshapen")
    dense = h @ w
    _check(torch.allclose(out, dense, rtol=DENSE_TOL, atol=DENSE_TOL),
           f"phase 9: cim_linear vs h @ unembed, max err "
           f"{float((out - dense).abs().max()):.3e}")
    plain = ref.bfp_matmul_ref(h, man, exp, N_GROUP)
    err = float((out - plain).abs().max())
    _check(torch.allclose(out, plain, rtol=BFP_TOL, atol=BFP_TOL),
           f"phase 9: K5 vs plain max err {err:.3e}")
    print(f"phase 9: cim_linear on the trained unembed [{K}, {J}] at M = "
          f"{h.shape[0]}: used_kernel {info['used_kernel']}, {launches} K5 "
          f"launch on the main path; vs h @ unembed max err "
          f"{float((out - dense).abs().max()):.3e}, vs plain {err:.3e}")
    del dense, plain, out
    eye = torch.eye(K, device=dev)
    probe = ops.cim_linear(eye, man, exp, n_group=N_GROUP)
    _check(_same_bits(probe, w), "phase 9: identity probe != trained unembed")
    del probe, eye
    dec = ops.cim_linear(h[:BATCH], man, exp, n_group=N_GROUP)
    err4 = float((dec - ref.bfp_matmul_ref(h[:BATCH], man, exp, N_GROUP))
                 .abs().max())
    _check(err4 <= BFP_TOL, f"phase 9: M = {BATCH} vs plain max err {err4:.3e}")
    print(f"phase 9: identity probe gives the trained unembed bitwise; M = "
          f"{BATCH} (narrow variant) vs plain max err {err4:.3e}")
    for m, k, n, n_group, dtype in BFP_RAGGED:
        x, mm, ee = _bfp_case(dev, m, k, n, n_group, dtype)
        got = ops.cim_linear(x, mm, ee, n_group=n_group)
        want = ref.bfp_matmul_ref(x, mm, ee, n_group)
        e = float((got - want).abs().max())
        _check(torch.allclose(got, want, rtol=BFP_TOL, atol=BFP_TOL),
               f"phase 9: ({m}, {k}, {n}) n_group {n_group} {dtype}: max err "
               f"{e:.3e}")
        err = max(err, e)
        print(f"phase 9: ragged ({m}, {k}, {n}) n_group {n_group} x {dtype}: "
              f"vs plain max err {e:.3e}")
    # every exponent byte: one block row (K = n_group = 1) whose columns
    # cycle through all 256 bytes, so each output is one product
    g = torch.Generator(device=dev).manual_seed(12)
    n = 4 * 256
    e_all = (torch.arange(n, device=dev) % 256).to(torch.uint8)[None]
    m_all = torch.randint(0, 2 ** 16, (1, n), generator=g, device=dev,
                          dtype=torch.int32)
    m_all[0, :2] = torch.tensor([0, 0x8000], device=dev)
    m_all = m_all.to(torch.uint16)
    # x = +-1: each output is +-W exactly (a larger |x| could overflow a
    # finite weight near 2^128)
    x_all = torch.randint(0, 2, (130, 1), generator=g, device=dev) * 2.0 - 1.0
    sat = (torch.arange(n, device=dev) % 256) >= 143
    for m in (BATCH, 130):
        got = ops.cim_linear(x_all[:m], m_all, e_all, n_group=1)
        want = ref.bfp_matmul_ref(x_all[:m], m_all, e_all, 1)
        _check(_same_bits(got, want), f"phase 9: every exponent byte, M = "
               f"{m}: kernel != plain")
        _check(not bool(got.isnan().any()) and bool(got[:, sat].isinf().all())
               and bool(got[:, ~sat].isfinite().all()),
               f"phase 9: every exponent byte, M = {m}: not +-inf exactly "
               f"from byte 143")
    print(f"phase 9: a plane holding all 256 exponent bytes: kernel == plain "
          f"bitwise at M = {BATCH} and 130, +-inf exactly for bytes >= 143, "
          f"no NaN")
    return {"man": man, "exp": exp, "h": h, "w": w, "launches": launches,
            "max_abs_err": max(err, err4)}


def _f64_errors(x, w, out) -> tuple:
    """Max abs error against the float64 product x @ w of K5's ``out`` and of
    torch.matmul in fp32 (TF32 off) on the same inputs."""
    import torch
    want = x.double() @ w.double()
    k5 = float((out.double() - want).abs().max())
    lib = float((torch.matmul(x, w).double() - want).abs().max())
    return k5, lib


def phase_bfp_times(dev, bfp: dict, card: str) -> dict:
    """K5 at M = 4 (the narrow variant, fp32 FMAs; bound by bytes) and at
    M = 1024 (the tile variant: two TF32 products on the tensor cores; bound
    by the larger of the bytes and those products, with the fp32-FMA figure
    beside it) on the trained unembed's planes. At M = 1024, K5's max abs
    error against a float64 product must be at most twice torch.matmul's."""
    import torch
    from repro_torch.kernels.bfp_matmul import ops, ref
    man, exp, w = bfp["man"], bfp["exp"], bfp["w"]
    _check(not torch.backends.cuda.matmul.allow_tf32,
           "phase 7: torch.matmul would run in TF32")
    row = {"name": "bfp_matmul", "route": "cuda", "source": BFP_SOURCE,
           "replaces": REPLACES["bfp_matmul"], "launches": bfp["launches"],
           "max_abs_err": bfp["max_abs_err"]}
    for m in (BATCH, bfp["h"].shape[0]):
        x = bfp["h"][:m].contiguous()
        ms = _time_ms(lambda: ops.cim_linear(x, man, exp, n_group=N_GROUP))
        plain_ms = _time_ms(lambda: ref.bfp_matmul_ref(x, man, exp, N_GROUP),
                            reps=3, inner=1)
        library_ms = _time_ms(lambda: torch.matmul(x, w))
        nbytes = man.numel() * 2 + exp.numel() + x.numel() * 4 + m * J * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        fma_ms = 2.0 * m * K * J / FP32_FLOPS * 1e3
        # the tile variant (M > 8) does two TF32 products on the tensor cores
        ops_ms = fma_ms if m <= 8 else 2 * 2.0 * m * K * J / TF32_FLOPS * 1e3
        vals = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "bytes": nbytes}
        what = "bytes" if bytes_ms >= ops_ms else (
            "fp32 FMAs" if m <= 8 else "two TF32 products")
        extra = ""
        if m == BATCH:
            row.update({f"{k}_m{m}": v for k, v in vals.items()})
        else:
            out = ops.cim_linear(x, man, exp, n_group=N_GROUP)
            k5_err, lib_err = _f64_errors(x, w, out)
            del out
            _check(k5_err <= 2 * lib_err, f"phase 7: K5 at M = {m}: max err "
                   f"{k5_err:.3e} vs float64, more than twice torch.matmul's "
                   f"{lib_err:.3e}")
            vals.update(fp32_fma_bound_ms=fma_ms, err_vs_f64=k5_err,
                        library_err_vs_f64=lib_err)
            row.update(vals, m=m)
            extra = (f"; fp32-FMA figure {fma_ms:.4f} ms; max err vs float64 "
                     f"{k5_err:.3e} (torch.matmul {lib_err:.3e})")
        print(f"phase 7: bfp_matmul at M = {m}: {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, torch.matmul on dequantized "
              f"{library_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
              f"({what}: {nbytes / 1e6:.1f} MB, {2.0 * m * K * J / 1e9:.1f} "
              f"GFLOP a product){extra} on {card}")
    return row


# ---------------------------------------------------------------- phase 12

GRANITE = "granite-3-8b"
FULL_ARMS = ARMS[:3] + ARMS[4:]              # (a), (b), (c), (e)
FULL_BER = 1e-3                              # the identity probe's faulted image
REDUCED_FAMILIES = ("granite-3-8b", "codeqwen1.5-7b", "command-r-35b",
                    "tinyvit-paper", "musicgen-large", "internvl2-76b")


def _store_bytes(store) -> int:
    """Bytes of every plane a read of ``store`` streams."""
    return sum(p.numel() * p.element_size() for p in
               (store.man, store.codewords, store.exp, store.sign)
               if p is not None)


def _drawn_leaves(model, seed: int) -> None:
    """Every constant-initialised leaf of ``model`` (``CONSTANT_LEAF_DRAWS``)
    redrawn from a seeded generator on its device."""
    import torch
    from repro_torch.models.common import CONSTANT_LEAF_DRAWS
    g = torch.Generator(device=model.embed.device).manual_seed(seed)
    for name, w in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in CONSTANT_LEAF_DRAWS:
            s, m = CONSTANT_LEAF_DRAWS[leaf]
            w.data.copy_(m + s * torch.randn(w.shape, generator=g,
                                             device=w.device))


def _full_serve(model, kernel_lib, tag: str) -> dict:
    """(a) Lock-step serving of a full-width model (granite-3-8b in phase
    12, rwkv6-1.6b in phase 13) in arms (a), (b),
    (c) and (e): the counts zeroed just before each arm, read just after;
    (a) makes GEN narrow K1 launches, (b) GEN narrow K2 launches, (c) and
    (e) none."""
    import torch
    from repro_torch.launch import serve as serve_lib
    cfg = model.cfg
    launches = {}
    for label, path, protect, inject, ber in FULL_ARMS:
        kernel_lib.reset_launch_counts()
        res, kernels = _kernels_of(lambda: serve_lib.serve(
            model, batch=BATCH, prompt_len=PROMPT, gen=GEN, seed=0, cim=True,
            ber=ber, protect=protect, serve_path=path, inject=inject,
            verbose=False))
        counts = dict(kernel_lib.launch_counts)
        name = {"one4n": "cim_read_matmul_one4n",
                "none": "cim_read_matmul_raw"}[protect] \
            if inject == "dynamic" else None
        want = {k: GEN if k == name else 0 for k in counts}
        _check(counts == res["launches"] == want,
               f"{tag} arm {label}: launches {counts}, "
               f"expected {want}")
        _check(kernels == ["narrow"] * (GEN if name else 0),
               f"{tag} arm {label}: reads went through "
               f"{kernels}")
        logits = res["prefill_logits"]
        _check(tuple(logits.shape) == (BATCH, cfg.vocab_size) and
               bool(torch.isfinite(logits).all()),
               f"{tag} arm {label}: logits "
               f"{tuple(logits.shape)}, finite "
               f"{bool(torch.isfinite(logits).all())}")
        _check(res["tokens"].shape == (BATCH, GEN) and
               ((res["tokens"] >= 0) & (res["tokens"] < cfg.vocab_size)).all(),
               f"{tag} arm {label}: tokens out of range")
        if name:
            launches[name] = counts[name]
        print(f"{tag} arm {label}: {res['tok_per_s']:.1f} "
              f"tok/s, prefill {res['prefill_s'] * 1e3:.1f} ms, ECC "
              f"corrected={res['ecc']['corrected']} uncorrectable="
              f"{res['ecc']['uncorrectable']}, launches {counts}"
              + (f", all {GEN} narrow" if name else ""))
    return launches


PROFILE_STEPS = 8


def _full_steps(model, tag: str) -> None:
    """Where a lock-step decode step of the full-width model goes: arms (a)
    and (e) prefilled, then PROFILE_STEPS decode steps timed on the host
    clock (synchronized) and again under ``torch.profiler`` (the device
    kernels' sum against that wall: the device-busy share)."""
    import torch
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.launch import serve as serve_lib
    toks = torch.as_tensor(MarkovLM(model.cfg.vocab_size, PROMPT, BATCH,
                                    seed=0).batch(0)["tokens"],
                           dtype=torch.int64, device=model.embed.device)
    for label, path, protect, inject, ber in (FULL_ARMS[0],
                                              FULL_ARMS[3]):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = serve_lib.build_params(model, cim=True, ber=ber,
                                        protect=protect, serve_path=path,
                                        inject=inject, verbose=False)[0]
        torch.cuda.synchronize()
        print(f"{tag} arm {label}: the deployment (align, "
              f"pack{', read' if path == 'hbm' else ''}) took "
              f"{time.perf_counter() - t0:.2f} s and peaked "
              f"{(torch.cuda.max_memory_allocated() - base) / 2 ** 30:.2f} "
              f"GiB above the {base / 2 ** 30:.2f} GiB it started from")

        def prefill():
            with torch.inference_mode():
                logits, caches = model.prefill(toks, params,
                                               max_len=PROMPT + PROFILE_STEPS)
            return caches, logits.argmax(-1)[:, None]

        def steps(caches, nxt):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                for _ in range(PROFILE_STEPS):
                    logits, caches = model.decode(caches, nxt, params)
                    nxt = logits.argmax(-1)[:, None]
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        wall = steps(*prefill())
        print(f"{tag} arm {label}: {PROFILE_STEPS} decode "
              f"steps in {wall * 1e3:.1f} ms ({wall / PROFILE_STEPS * 1e3:.2f}"
              f" ms a step, host clock)")
        state = prefill()
        _profile_arm(model.embed.device, lambda: steps(*state), wall,
                     f"{tag} arm {label} decode steps "
                     f"profiled")
        del params


def _full_kernels(model, card: str, tag: str) -> dict:
    """(b) K1 and K2 at the model's unembed shape (granite's K = 4096,
    J = 49155: the last 128-column strip holds 16 padded columns, 3 of them
    real; rwkv6's K = 2048, J = 65536: 512 full strips) on the served
    weights: the 8-row identity probe exact on the clean and the
    BER 1e-3 image, the last strip's columns included; the dynamic read
    equal to the static read of the image it flips; the final-normed
    hidden states of a MarkovLM batch (M = 4 and 1) within 1e-4 of
    |h| @ |W| of the plain version, static and dynamic. Each narrow kernel
    timed static and dynamic at M = 4 and 1 beside torch.matmul and its
    plain version, with its bounds."""
    import torch
    from repro_torch.core import align, cim
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.kernels.cim_read import ops, ref
    from repro_torch.kernels.fault_inject.ops import ber_to_threshold
    cfg = model.cfg
    k, j = cfg.d_model, cfg.vocab_size
    seeds = {"man": 0x1234567, "meta": 0x89ABCDE, "cw": 0x2468ACE}
    thr = ber_to_threshold(FULL_BER)
    scalars = ops.make_scalars(seeds, thr, thr)
    t_thr = ber_to_threshold(MODEL_BER)
    t_scalars = ops.make_scalars(seeds, t_thr, t_thr)
    toks = torch.as_tensor(MarkovLM(j, PROMPT, BATCH, seed=5).batch(0)[
        "tokens"], dtype=torch.int64, device=model.embed.device)
    with torch.inference_mode():
        h = model(toks, unembed=False)[:, -1].contiguous()
    w_al, _ = align.align_matrix(model.unembed.detach(), align.AlignmentConfig(
        n_group=N_GROUP, index=2))
    rows = {}
    for name, protect in PROTECT_OF.items():
        store = cim.pack(w_al, cim.CIMConfig(n_group=N_GROUP, protect=protect))
        j_pad = -(-j // 16) * 16                    # 49168 = 384 x 128 + 16
        _check(tuple(store.man.shape) == (k, j_pad), f"{tag}: {name}: "
               f"store {tuple(store.man.shape)}")
        injected = cim.inject_with_seeds(store, seeds, thr, thr)
        last = slice((j_pad - 1) // 128 * 128, j)
        for what, image in (("clean", store), (f"BER {FULL_BER:g}",
                                                injected)):
            w_ref, _ = cim.read(image)
            out, bad = _identity_probe(name, image, w_ref, what, rows=8)
            fin = torch.isfinite(w_ref[:, last]).all(0)
            _check(torch.equal(out[:, last][:, fin], w_ref[:, last][:, fin]),
                   f"{tag}: {name}: last strip's columns ({what})")
            print(f"{tag}: {name} identity probe at ({k}, {j}): exact "
                  f"on the {what} image in {k // 8} narrow launches, the "
                  f"last strip's {j - last.start} real columns included "
                  f"({bad} columns hold a non-finite weight)")
            del out, w_ref
        w_inj_abs = cim.read(injected)[0].abs()
        w_abs = cim.read(store)[0].abs()
        worst = 0.0
        for x in (h, h[:1].contiguous()):
            dyn, info = ops.cim_linear_store(x, store, scalars=scalars,
                                             with_info=True)
            _check(info["tiles"]["kernel"] == "narrow",
                   f"{tag}: {name} at M = {x.shape[0]}: {info['tiles']}")
            _check(_same_bits(dyn, ops.cim_linear_store(x, injected)),
                   f"{tag}: {name}: dynamic != static read of its image "
                   f"(M = {x.shape[0]})")
            for sc, wabs in ((None, w_abs), (scalars, w_inj_abs)):
                got = dyn if sc is not None else ops.cim_linear_store(x, store)
                want, _ = ref.cim_read_ref(x, store, sc)
                ok, err = _close(got, want, x.abs() @ wabs)
                _check(ok, f"{tag}: {name} vs plain at M = {x.shape[0]} "
                       f"({'dynamic' if sc is not None else 'static'}, max "
                       f"err {err:.3e})")
                worst = max(worst, err)
        del injected, w_inj_abs
        w, _ = cim.read(store)
        nbytes = _store_bytes(store)
        draws = _draws(store)
        hash_ms = draws * ALU_OPS_PER_DRAW / INT32_OPS * 1e3
        row = {"shape": [k, j], "j_pad": int(store.man.shape[1]),
               "max_abs_err": worst, "draws": draws, "store_bytes": nbytes}
        for x in (h, h[:1].contiguous()):
            m = x.shape[0]
            bytes_ms = (nbytes + (k + j) * 4 * m) / HBM_BYTES_PER_S * 1e3
            vals = {
                "ms": _time_ms(lambda: ops.cim_linear_store(
                    x, store, scalars=t_scalars)),
                "static_ms": _time_ms(lambda: ops.cim_linear_store(x, store)),
                "library_ms": _time_ms(lambda: torch.matmul(x, w)),
                "plain_ms": _time_ms(lambda: ref.cim_read_ref(
                    x, store, t_scalars), reps=3, inner=1),
                "bound_ms": bytes_ms, "bound_by": "bytes",
                "dynamic_bound_ms": max(bytes_ms, hash_ms),
                "dynamic_bound_by": "bytes" if bytes_ms >= hash_ms
                else "operations"}
            row[f"m{m}"] = vals
            print(f"{tag}: {name} narrow at ({k}, {j}), M = {m}: "
                  f"{vals['ms']:.4f} ms dynamic (BER {MODEL_BER:g}), "
                  f"{vals['static_ms']:.4f} ms static; torch.matmul "
                  f"{vals['library_ms']:.4f} ms, plain {vals['plain_ms']:.2f}"
                  f" ms; bound {bytes_ms:.4f} ms static ({nbytes / 1e6:.1f} "
                  f"MB of planes), {vals['dynamic_bound_ms']:.4f} ms dynamic "
                  f"({draws / 1e9:.3f} G draws) on {card}")
        rows[name] = row
        del store, w
        torch.cuda.empty_cache()
    return rows


def _full_engine(model, kernel_lib, tag: str) -> int:
    """(c) Engine arm (a) on the full-width model: phase 10's load through 4
    slots, chunk 16, timed as phase 10 times it (no accounting, no logits
    kept); the count zeroed just before, read just after: one narrow K1
    launch a prefill chunk plus one a slot a decode step. The load again
    with every logit vector kept gives the same tokens, and rids 0 and 2
    served solo equal it bitwise."""
    from repro_torch.launch import engine as engine_lib
    name = "cim_read_matmul_one4n"
    load = engine_lib.LoadGen(vocab_size=model.cfg.vocab_size, **ENGINE_LOAD)
    reqs, max_len = load.requests(), load.max_len()
    chunks = sum(-(-r.tokens.size // ENGINE_CHUNK) for r in reqs)
    params = _engine_params(model, ENGINE_ARMS[0])
    kernel_lib.reset_launch_counts()
    (res, agg), kernels = _kernels_of(lambda: _engine_run(
        model, params, reqs, max_len, ecc_accounting=False))
    counts = dict(kernel_lib.launch_counts)
    want = chunks + agg["decode_steps"] * ENGINE_SLOTS
    _check(counts == {name: want, "cim_read_matmul_raw": 0},
           f"{tag}: engine: launches {counts}, expected {want} of {name}")
    _check(kernels == ["narrow"] * want, f"{tag}: engine reads went "
           f"through {sorted(set(kernels))}")
    for r in reqs:
        got = res[r.rid]
        _check(len(got.tokens) == r.max_new and got.finite,
               f"{tag}: engine request {r.rid}: {got.tokens}")
    co, _ = _engine_run(model, params, reqs, max_len, ecc_accounting=False,
                        collect_logits=True)
    _check(all(co[r.rid].tokens == res[r.rid].tokens for r in reqs),
           f"{tag}: engine tokens changed when the logits were kept")
    for rid in (0, 2):
        solo, _ = _engine_run(model, params, [reqs[rid]], max_len,
                              ecc_accounting=False, collect_logits=True)
        _check(_same_request(co[rid], solo[rid]),
               f"{tag}: engine request {rid} solo != co-batched")
    print(f"{tag} engine arm {ENGINE_ARMS[0][0]}: decode "
          f"{agg['decode_tok_s']:.1f} tok/s aggregate ("
          f"{agg['decode_wall_s'] / agg['decode_steps'] * 1e3:.1f} ms a "
          f"step), TTFT mean {agg['ttft_s_mean'] * 1e3:.1f} ms p95 "
          f"{agg['ttft_s_p95'] * 1e3:.1f} ms, occupancy "
          f"{agg['slot_occupancy']:.3f}, {agg['decode_steps']} decode steps; "
          f"{counts[name]} K1 launches ({chunks} chunks + "
          f"{agg['decode_steps']} x {ENGINE_SLOTS}), all narrow at M = 1; "
          f"rids 0 and 2 solo == co-batched bitwise (tokens, logits)")
    return counts[name]


def _reduced_families(dev, kernel_lib) -> None:
    """(d) Each new family, reduced, on the card against the port's plain
    CPU path (weights from one seeded generator, norms drawn nonzero): the
    text archs served as phase 3's reduced check serves olmo-1b (dynamic
    one4n and none, BER 1e-3: tokens equal, logits within allclose(1e-4,
    1e-4), one kernel launch a read); the stub modalities' forward on a
    ``batches_for`` batch within the same allclose."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import batches_for
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models.lm import LM
    for arch in REDUCED_FAMILIES:
        cfg = get_config(arch).reduced()
        cpu = LM(cfg, generator=torch.Generator().manual_seed(3),
                 device="cpu")
        _drawn_leaves(cpu, 4)
        gpu = LM(cfg, device=dev)
        gpu.load_state_dict(cpu.state_dict())
        if cfg.modality != "text":
            batch = batches_for(cfg, 2, 16, seed=1)
            b = {k: torch.from_numpy(v) for k, v in batch.items()
                 if k != "labels"}
            with torch.inference_mode():
                a = cpu(b)
                g = gpu({k: v.to(dev) for k, v in b.items()}).cpu()
            ok, err = _close(a, g)
            _check(ok, f"phase 12: reduced {arch} {cfg.modality} forward "
                   f"card vs CPU (max err {err:.3e})")
            print(f"phase 12: reduced {arch} ({cfg.norm_type}, "
                  f"{cfg.mlp_type}, {cfg.modality}): forward card == CPU "
                  f"plain, logits max err {err:.3e}")
            continue
        errs = []
        for protect in ("one4n", "none"):
            kw = dict(batch=2, prompt_len=8, gen=6, seed=1, cim=True,
                      ber=1e-3, protect=protect, inject="dynamic",
                      verbose=False)
            a = serve_lib.serve(cpu, **kw)
            kernel_lib.reset_launch_counts()
            b = serve_lib.serve(gpu, **kw)
            _check(sum(kernel_lib.launch_counts.values()) == kw["gen"],
                   f"phase 12: reduced {arch} {protect}: launches "
                   f"{dict(kernel_lib.launch_counts)}")
            _check((a["tokens"] == b["tokens"]).all(),
                   f"phase 12: reduced {arch} {protect}: card tokens != CPU")
            ok, err = _close(a["prefill_logits"], b["prefill_logits"].cpu())
            _check(ok, f"phase 12: reduced {arch} {protect}: logits vs CPU "
                   f"(max err {err:.3e})")
            errs.append(err)
        print(f"phase 12: reduced {arch} ({cfg.norm_type}, {cfg.mlp_type}, "
              f"{cfg.n_heads} heads over {cfg.n_kv_heads}): served dynamic "
              f"one4n / none, card == CPU plain (tokens equal, logits max err "
              f"{errs[0]:.3e} / {errs[1]:.3e})")


# ---------------------------------------------------------------- phase 13

RWKV = "rwkv6-1.6b"
KIND_FAMILIES = (  # (label, arch, config overrides), reduced
    ("local", "olmo-1b", dict(block_pattern=("local",), local_window=16)),
    ("rwkv", "rwkv6-1.6b", {}),
    ("rec", "recurrentgemma-9b", dict(n_layers=5)),
    ("moe", "qwen3-moe-235b-a22b", {}),
    ("dbrx", "dbrx-132b", {}))
KIND_CHUNK = 8          # a MoE's 4 slots and 8-token chunks stay drop-free


def _state_prefix(model, tag: str) -> None:
    """A prefix hit injects a fold's post-chunk snapshot: 3 requests behind
    a shared 32-token prefix (two full 16-token chunks) through engine arm
    (a) with a prefix cache equal the same requests served cold, bitwise
    (tokens, logits)."""
    from repro_torch.launch import engine as engine_lib
    load = engine_lib.LoadGen(n_requests=3, prompt_lens=(4, 12),
                              gen_lens=(2, 4), vocab_size=model.cfg.vocab_size,
                              seed=1, prefix_len=32)
    reqs, max_len = load.requests(), load.max_len()
    params = _engine_params(model, ENGINE_ARMS[0])
    kw = dict(ecc_accounting=False, collect_logits=True)
    warm, agg = _engine_run(model, params, reqs, max_len, prefix_cache=True,
                            **kw)
    cold, _ = _engine_run(model, params, reqs, max_len, **kw)
    _check(agg["prefix_hits"] >= 2, f"{tag}: prefix hits {agg['prefix_hits']}")
    for r in reqs:
        _check(_same_request(warm[r.rid], cold[r.rid]),
               f"{tag}: prefix-hit request {r.rid} != its cold prefill")
    print(f"{tag}: engine arm {ENGINE_ARMS[0][0]} behind a 32-token shared "
          f"prefix: {agg['prefix_hits']} prefix hits ({agg['prefix_tokens']} "
          f"tokens from state snapshots), each request equal to its cold "
          f"prefill bitwise (tokens, logits)")


def _reduced_kinds(dev, kernel_lib) -> None:
    """(b) Each block kind reduced (local-only at window 16, rwkv6,
    recurrentgemma at 5 layers, qwen3-moe, dbrx), weights from one seeded
    generator with the constant leaves drawn, on the card against the
    port's plain CPU path: lock-step dynamic one4n and none at BER 1e-3,
    prompt 16 (the ring wraps), one kernel launch a read, tokens equal and
    logits within allclose(1e-4, 1e-4); then the engine on the card (fused
    one4n, static from the row cache and dynamic, 4 slots, chunk 8, no
    capacity warning): rids 0 and 2 served solo equal them co-batched
    bitwise in both arms (the attn kind's two arms are phase 10's a and
    c)."""
    import dataclasses
    import warnings
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import engine as engine_lib
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models.lm import LM
    for label, arch, ov in KIND_FAMILIES:
        cfg = dataclasses.replace(get_config(arch).reduced(), **ov)
        cpu = LM(cfg, generator=torch.Generator().manual_seed(3),
                 device="cpu")
        _drawn_leaves(cpu, 4)
        gpu = LM(cfg, device=dev)
        gpu.load_state_dict(cpu.state_dict())
        errs = []
        for protect in ("one4n", "none"):
            kw = dict(batch=2, prompt_len=16, gen=6, seed=1, cim=True,
                      ber=1e-3, protect=protect, inject="dynamic",
                      verbose=False)
            a = serve_lib.serve(cpu, **kw)
            kernel_lib.reset_launch_counts()
            b = serve_lib.serve(gpu, **kw)
            _check(sum(kernel_lib.launch_counts.values()) == kw["gen"],
                   f"phase 13: reduced {label} {protect}: launches "
                   f"{dict(kernel_lib.launch_counts)}")
            _check((a["tokens"] == b["tokens"]).all(),
                   f"phase 13: reduced {label} {protect}: card tokens != CPU")
            ok, err = _close(a["prefill_logits"], b["prefill_logits"].cpu())
            _check(ok, f"phase 13: reduced {label} {protect}: logits vs CPU "
                   f"(max err {err:.3e})")
            errs.append(err)
        reqs = engine_lib.LoadGen(n_requests=3, prompt_lens=(3, 14),
                                  gen_lens=(3, 5), vocab_size=256,
                                  seed=5).requests()

        def run(params, rs):
            with warnings.catch_warnings():
                warnings.simplefilter("error")    # no capacity coupling
                eng = engine_lib.Engine(gpu, params, n_slots=ENGINE_SLOTS,
                                        max_len=24, chunk=KIND_CHUNK,
                                        collect_logits=True)
            with torch.inference_mode():
                return eng.run(rs)[0]
        for inject in ("static", "dynamic"):
            params = serve_lib.build_params(gpu, cim=True, ber=1e-3,
                                            inject=inject, verbose=False)[0]
            co = run(params, reqs)
            for rid in (0, 2):
                _check(_same_request(co[rid],
                                     run(params, [reqs[rid]])[rid]),
                       f"phase 13: reduced {label} engine {inject}: request "
                       f"{rid} solo != co-batched")
        print(f"phase 13: reduced {label} ({arch}, {cfg.n_layers} layers "
              f"{'/'.join(dict.fromkeys(cfg.block_pattern))}): served "
              f"dynamic one4n / none, card == CPU plain (tokens equal, "
              f"logits max err {errs[0]:.3e} / {errs[1]:.3e}); engine on the "
              f"card, static and dynamic: rids 0 and 2 solo == co-batched "
              f"bitwise")


def _expert_card_vs_cpu(dev) -> None:
    """(c) ``ExpertDeployment`` on reduced qwen3-moe, static BER 1e-3 (the
    launcher's ``--expert-cim``): ``stats_by_expert`` on the card equals the
    CPU's, every count; the served tokens (restacked experts, dynamic one4n
    unembed) equal."""
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models.lm import LM
    cfg = get_config("qwen3-moe-235b-a22b").reduced()
    cpu = LM(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    _drawn_leaves(cpu, 4)
    gpu = LM(cfg, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    out = []
    for m in (cpu, gpu):
        edep, extra = serve_lib.expert_deploy(
            convert.expert_leaves(m), ber=1e-3, protect="one4n", n_group=8,
            index=2, seed=0, verbose=False)
        res = serve_lib.serve(m, batch=2, prompt_len=8, gen=6, seed=1,
                              cim=True, ber=1e-3, inject="dynamic",
                              extra=extra, verbose=False)
        out.append((edep.stats_by_expert(), res["tokens"]))
    (cs, ct), (gs, gt) = out
    _check(cs == gs, "phase 13: expert stats on the card != the CPU's")
    _check((ct == gt).all(), "phase 13: expert-served tokens card != CPU")
    print(f"phase 13: ExpertDeployment on reduced qwen3-moe ({len(gs)} "
          f"expert stores, BER 1e-3 static): stats_by_expert card == CPU "
          f"(corrected {sum(v['corrected'] for v in gs.values())}, "
          f"uncorrectable {sum(v['uncorrectable'] for v in gs.values())}), "
          f"served tokens equal")


def phase_kinds(dev, kernel_lib, card: str) -> dict:
    """Phase 13: the other block kinds. Full-width rwkv6-1.6b (24 layers,
    d_model 2048, 32 heads of 64, channel mix d_ff 7168, vocab 65536,
    layernorm; weights from a seeded generator on the card, the constant
    leaves drawn) served lock-step and through the engine over K1/K2's
    narrow kernels, the kernels held at its unembed shape, a prefix hit
    against a cold prefill; then each kind reduced, card against CPU, and
    the expert deployment. Returns each kernel's rwkv6 figures (the
    kernels line carries them)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(RWKV)
    model = LM(cfg, generator=torch.Generator(device=dev).manual_seed(0),
               device=dev)
    _drawn_leaves(model, 1)
    n = sum(p.numel() for p in model.parameters())
    w0 = torch.stack([b.tmix.decay_w0 for b in model.blocks])
    lo, hi = float((w0 < -8).float().mean()), float((w0 > 1).float().mean())
    _check(lo > 0 and hi > 0, f"phase 13: decay bases {lo}, {hi} past the "
           f"clamp")
    print(f"phase 13: {RWKV} full width: {n / 1e9:.3f} B fp32 parameters "
          f"({n * 4 / 1e9:.2f} GB) built on the card in "
          f"{time.perf_counter() - t0:.1f} s; decay bases past the clamp: "
          f"{100 * lo:.2f}% below -8, {100 * hi:.2f}% above 1")
    tag = f"phase 13: {RWKV}"
    peaks, secs = {}, {}

    def part(what, fn):
        t = time.perf_counter()
        out = fn()
        secs[what] = time.perf_counter() - t
        peaks[what] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        return out
    launches = part("lock-step arms", lambda: _full_serve(model, kernel_lib,
                                                          tag))
    part("decode-step profile", lambda: _full_steps(model, tag))
    rows = part("kernels at the unembed shape",
                lambda: _full_kernels(model, card, tag))
    rows["cim_read_matmul_one4n"]["engine_launches"] = part(
        "engine", lambda: _full_engine(model, kernel_lib, tag))
    part("prefix cache", lambda: _state_prefix(model, tag))
    for name, v in launches.items():
        rows[name]["launches"] = v
    del model
    torch.cuda.empty_cache()
    print(f"{tag} peak device memory {max(peaks.values()):.2f} GiB "
          f"(max_memory_allocated over the phase; by part: "
          + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items())
          + f") on {card}")
    t = time.perf_counter()
    _reduced_kinds(dev, kernel_lib)
    secs["reduced kinds"] = time.perf_counter() - t
    t = time.perf_counter()
    _expert_card_vs_cpu(dev)
    secs["expert deployment"] = time.perf_counter() - t
    print(f"phase 13: {time.perf_counter() - t0:.1f} s (by part: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + ")")
    return rows


def phase_granite(dev, kernel_lib, card: str) -> dict:
    """Phase 12: the dense variants. Full-width granite-3-8b (40 layers,
    d_model 4096, 32 heads over 8 KV heads, rmsnorm with its parameters,
    SwiGLU d_ff 12800, vocab 49155; weights from a seeded generator on the
    card, norms drawn nonzero) served lock-step and through the engine
    over K1/K2's narrow kernels, the kernels held at its unembed shape;
    then each new family reduced, card against CPU. Returns each kernel's
    granite figures (the kernels line carries them)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(GRANITE)
    model = LM(cfg, generator=torch.Generator(device=dev).manual_seed(0),
               device=dev)
    _drawn_leaves(model, 1)
    n = sum(p.numel() for p in model.parameters())
    print(f"phase 12: {GRANITE} full width: {n / 1e9:.3f} B fp32 parameters "
          f"({n * 4 / 1e9:.1f} GB) built on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    peaks = {}

    def part(what, fn):
        out = fn()
        peaks[what] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        return out
    tag = f"phase 12: {GRANITE}"
    launches = part("lock-step arms", lambda: _full_serve(model, kernel_lib,
                                                          tag))
    part("decode-step profile", lambda: _full_steps(model, tag))
    rows = part("kernels at the unembed shape",
                lambda: _full_kernels(model, card, tag))
    rows["cim_read_matmul_one4n"]["engine_launches"] = part(
        "engine", lambda: _full_engine(model, kernel_lib, tag))
    for name, v in launches.items():
        rows[name]["launches"] = v
    del model
    torch.cuda.empty_cache()
    print(f"phase 12: {GRANITE} peak device memory "
          f"{max(peaks.values()):.2f} GiB (max_memory_allocated over the "
          f"phase; by part: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                          peaks.items()) + f") on {card}")
    _reduced_families(dev, kernel_lib)
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------- phase 14

CODESIGN_BER, SEARCH_BER = 1e-4, 1e-3     # the Finetuner's, the search's SLO
TRAIN_KIND_FAMILIES = (  # (label, arch, config overrides), reduced
    ("rwkv", "rwkv6-1.6b", {}),
    ("rec", "recurrentgemma-9b", dict(n_layers=5)),
    ("moe", "qwen3-moe-235b-a22b", {}),
    ("local", "olmo-1b", dict(block_pattern=("local",), local_window=16)))
FLIP_SIGMAS = 5
B1 = 0.9                # AdamW's b1 (optim/adamw.py)
GRAD_FLOOR = 1e-6       # 100x AdamW's eps: the first update is lr * sign(g)


def _train_full_kind(dev, card: str) -> dict:
    """(a) Full-width rwkv6-1.6b: TRAIN_STEPS aligned steps through
    run_training (phase 8's one4n align rule) at TRAIN_BATCH x TRAIN_SEQ,
    or at half the batch if that does not fit."""
    import math
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.models import lm
    from repro_torch.training import loop
    cfg = get_config(RWKV)
    run = _align_rule_run(TRAIN_STEPS)
    res, batch = None, TRAIN_BATCH
    while res is None:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            res = loop.run_training(cfg, run, iter(MarkovLM(
                cfg.vocab_size, TRAIN_SEQ, batch, seed=0)), device=dev)
        except torch.cuda.OutOfMemoryError:
            _check(batch > TRAIN_BATCH // 2, f"phase 14: {RWKV} training "
                   f"does not fit at batch {batch} either")
            print(f"phase 14: {RWKV} training at batch {batch} x "
                  f"{TRAIN_SEQ} ran out of device memory; batch "
                  f"{batch // 2}")
            batch //= 2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    hist = res.history
    _check(len(hist) == TRAIN_STEPS and all(
        math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
        for h in hist), f"phase 14: {RWKV} losses "
        f"{[(h['loss'], h['grad_norm']) for h in hist]}")
    _check(all(h["aux_loss"] == 0.0 for h in hist),
           f"phase 14: {RWKV} aux_loss {[h['aux_loss'] for h in hist]}")
    for h in hist:
        print(f"phase 14: {RWKV} step {h['step']}: loss {h['loss']:.4f} "
              f"grad_norm {h['grad_norm']:.4f} lr {h['lr']:.3e} "
              f"{h['step_time'] * 1e3:.1f} ms")
    rest = [h["step_time"] * 1e3 for h in hist[1:]]
    checked = _check_frozen(res.state, zero_blocks=True, tag="phase 14")
    print(f"phase 14: {RWKV} full width ({lm.param_count(res.state.params) / 1e9:.3f}"
          f" B parameters), {TRAIN_STEPS} aligned steps at {batch} x "
          f"{TRAIN_SEQ}: step ms first {hist[0]['step_time'] * 1e3:.1f}, then "
          f"median {float(np.median(rest)):.1f} (after a synchronize); peak "
          f"device memory {peak:.2f} GiB (max_memory_allocated); "
          f"{checked / 1e9:.3f} B aligned weights keep their frozen "
          f"exponents and signs (blocks of zeros aside); on {card}")
    out = {"batch": batch, "step_ms": rest, "peak_gib": peak}
    del res
    torch.cuda.empty_cache()
    return out


def _reduced_kind_steps(dev) -> None:
    """(a) Each kind reduced, one aligned step from one state (the
    constant leaves drawn, aligned on the CPU) on the card and on the CPU:
    loss, grad norm and the MoE aux loss within LOSS_RTOL, the MoE's
    nonzero; every gradient within allclose(TOL) of its leaf's largest;
    every parameter whose gradient exceeds GRAD_FLOOR within one fp16
    ulp."""
    import dataclasses
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.models.lm import LM
    from repro_torch.training import loop, steps
    for label, arch, ov in TRAIN_KIND_FAMILIES:
        cfg = dataclasses.replace(get_config(arch).reduced(), **ov)
        run = _align_rule_run(1, learning_rate=REDUCED_LR, warmup_steps=0)
        model = LM(cfg, generator=torch.Generator().manual_seed(3),
                   device="cpu")
        _drawn_leaves(model, 4)
        # one state, aligned on the CPU (the card's elementwise kernels
        # may contract alignment's rescale into an FMA), then copied
        cpu_state = steps.init_train_state(None, cfg, run,
                                           params=convert.flat_from_lm(model))
        card_state = _moved_state(cpu_state, dev)
        out = {}
        for name, state in (("card", card_state), ("cpu", cpu_state)):
            d = next(iter(state.params.values())).device
            batch = loop._on_device(MarkovLM(cfg.vocab_size, 32, 2,
                                             seed=1).batch(0), d)
            out[name] = steps.make_train_step(cfg, run)(state, batch)
        (cs, cm), (ps, pm) = out["card"], out["cpu"]
        for k in ("loss", "grad_norm", "aux_loss"):
            a, b = float(cm[k]), float(pm[k])
            _check(abs(a - b) <= LOSS_RTOL * abs(b), f"phase 14: reduced "
                   f"{label} {k} card {a} cpu {b}")
        _check((float(pm["aux_loss"]) > 0) == (label == "moe"),
               f"phase 14: reduced {label} aux_loss {float(pm['aux_loss'])}")
        # the gradients (AdamW's first moment after one step is (1 - b1)
        # times the clipped gradient); then the parameters, within one
        # fp16 ulp where the gradient is far above AdamW's eps: below it
        # the first update is lr * g / eps, which carries the gradient's
        # summation-order error whole
        worst, fine, tiny = 0, 0, 0
        for p, w in cs.params.items():
            gc, gp = cs.opt["m"][p].cpu(), ps.opt["m"][p]
            scale = float(gp.abs().max()) or 1.0
            _check(torch.allclose(gc, gp, rtol=TOL, atol=TOL * scale),
                   f"phase 14: reduced {label} {p}: gradient card vs CPU "
                   f"(max err {float((gc - gp).abs().max()):.3e} of "
                   f"{scale:.3e})")
            big = gp.abs() / (1 - B1) > GRAD_FLOOR
            ulps = _fp16_ulps(ps.params[p], w)
            worst = max(worst, int(ulps[big].max()) if big.any() else 0)
            fine += int(big.sum())
            tiny += int((~big).sum())
        _check(worst <= 1, f"phase 14: reduced {label}: parameters {worst} "
               f"fp16 ulps apart where |g| > {GRAD_FLOOR:g}")
        print(f"phase 14: reduced {label} ({arch}) one aligned step card vs "
              f"CPU: loss {float(cm['loss']):.6f} / {float(pm['loss']):.6f}, "
              f"aux {float(cm['aux_loss']):.3e} / {float(pm['aux_loss']):.3e}"
              f", gradients within allclose({TOL:g}), parameters within "
              f"{worst} fp16 ulp where |g| > {GRAD_FLOOR:g} ({fine} "
              f"weights; {tiny} below it)")


def _field_flips(before: dict, after: dict, rates) -> dict:
    """{field: (flipped bits, binomial mean, sd)} over the leaves the
    schedule draws."""
    import torch
    from repro_torch.core import bitops
    out = {}
    for f, field in enumerate(("exponent_sign", "mantissa")):
        pos = [int(p) for p in bitops.FP16.field_bit_positions(field)]
        mask = sum(1 << p for p in pos)
        got, mean, var = 0, 0.0, 0.0
        for path, w in before.items():
            rate = rates(path, w)[f]
            if rate <= 0:
                continue
            x = (bitops.to_bits(w).to(torch.int32)
                 ^ bitops.to_bits(after[path]).to(torch.int32)) & mask
            got += sum(int(((x >> p) & 1).sum()) for p in pos)
            n = w.numel() * len(pos)
            mean += n * rate
            var += n * rate * (1 - rate)
            del x
        out[field] = (got, mean, var ** 0.5)
    return out


def _k4_launches_expected(params: dict, rates) -> int:
    """One K4 launch a (drawn leaf, field): a leaf's counter chunks are
    runs of one table."""
    return sum(1 for path, w in params.items() for r in rates(path, w)
               if r > 0)


def _check_chunked_leaf(params: dict, faulty: dict, seed: int, corrupt,
                        ft) -> str:
    """The first leaf the schedule draws in two or more counter chunks
    (olmo-1b's stacked MLP leaves, 2^28 elements), held bitwise to K4's
    plain version drawn here chunk by chunk with the schedule's seeds:
    field f of leaf i from ``fold_seed(fold_seed(seed, f), i)``, chunk c
    of 2^27 elements from ``fold_seed(that, c)``, exponent/sign (bits
    10-15) at ``residual_exp_ber`` and mantissa (bits 0-9) at the BER. The
    plain version runs on the card: on the host it would take minutes."""
    from repro_torch.core import bitops
    from repro_torch.core.cim import fold_seed
    from repro_torch.kernels.fault_inject import kernel as fi_kernel
    from repro_torch.kernels.fault_inject import ref as fi_ref
    import torch
    rel = ft._run_cfg(ber=CODESIGN_BER, inject="dynamic").rel
    fields = ((range(10, 16), rel.residual_exp_ber), (range(10), rel.ber))
    for i, (path, w) in enumerate(params.items()):
        rows = w.numel() // w.shape[-1]
        per = fi_kernel.MAX_COUNTER_ELEMENTS // w.shape[-1]
        if w.ndim >= 2 and rows > per:
            break
    else:
        _check(False, "phase 14: no leaf takes two counter chunks")
    _check(corrupt.rates(path, w) == tuple(r for _, r in fields),
           f"phase 14: {path}'s rates {corrupt.rates(path, w)}")
    bits = bitops.to_bits(w.reshape(rows, -1)).view(torch.int16)
    for f, (positions, ber) in enumerate(fields):
        leaf_seed = fold_seed(fold_seed(seed, f), i)
        for c, r0 in enumerate(range(0, rows, per)):
            bits[r0:r0 + per] = fi_ref.fault_inject_ref(
                bits[r0:r0 + per].view(torch.uint16),
                seed=fold_seed(leaf_seed, c), ber=ber,
                positions=positions).view(torch.int16)
    got = bitops.to_bits(faulty[path].reshape(rows, -1)).view(torch.int16)
    _check(torch.equal(got, bits), f"phase 14: the schedule's {path} "
           f"differs from K4's plain version drawn chunk by chunk")
    n = len(range(0, rows, per))
    return f"{path} {tuple(w.shape)} ({n} counter chunks x 2 fields)"


def _fi_figures(what: str, fn, plain, n: int, t: int, n_pos: int,
                nbytes: int = None) -> dict:
    """A K3/K4 call held bitwise to its plain version on the same inputs,
    then its device time, the plain version's and its bound (phase 7's
    accounting: each plane read once, T copies written, ``nbytes`` for a
    float32 plane; 10 ALU and 2 IMAD ops a draw)."""
    import torch
    got, want = fn(), plain()
    # uint16 has no CUDA comparison: compare the int16 views
    _check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
           f"{what} differs from its plain version on the same "
           f"inputs")
    del got, want
    ms = _time_ms(fn, reps=3, inner=3)
    plain_ms = _time_ms(plain, reps=3, inner=1)
    nbytes = n * 2 * (1 + t) if nbytes is None else nbytes
    hashes = n * t * n_pos
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(hashes * ALU_OPS_PER_DRAW, hashes * IMAD_OPS_PER_DRAW) \
        / INT32_OPS * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "hashes": hashes}


def _k4_chunk_figures(params: dict, fi_kernel):
    """K4 at one counter chunk of the largest leaf's fp16 plane, 10 bit
    positions at CODESIGN_BER (:func:`_fi_figures`) -> ((path, leaf), rows,
    figures)."""
    from repro_torch.core import bitops
    from repro_torch.kernels.fault_inject import ops as fi_ops
    from repro_torch.kernels.fault_inject import ref as fi_ref
    chunk = max(((p, w) for p, w in params.items() if w.ndim >= 2),
                key=lambda pw: pw[1].numel())
    plane = bitops.to_bits(chunk[1].reshape(-1, chunk[1].shape[-1]))
    rows = min(plane.shape[0], fi_kernel.MAX_COUNTER_ELEMENTS
               // plane.shape[1])
    plane = plane[:rows]
    return chunk, rows, _fi_figures(
        "K4", lambda: fi_ops.fault_inject_bits(plane, seed=7, ber=CODESIGN_BER,
                                         positions=range(10)),
        lambda: fi_ref.fault_inject_ref(plane, seed=7, ber=CODESIGN_BER,
                                        positions=range(10)),
        plane.numel(), 1, 10)


def _k3_embed_figures(params: dict):
    """K3 at the embed's One4N mantissa plane, T = 2 trials, 10 bit
    positions at SEARCH_BER (:func:`_fi_figures`) -> (plane, figures)."""
    from repro_torch.core.cim import field_thresholds
    from repro_torch.core.deployment import CIMDeployment, ReliabilityPolicy
    from repro_torch.kernels.fault_inject import ops as fi_ops
    from repro_torch.kernels.fault_inject import ref as fi_ref
    man = None
    for _, _, s in CIMDeployment.deploy(
            {"embed": params["embed"]}, ReliabilityPolicy()).store_leaves():
        man = s.man
    seeds = [1, 2]
    thr = field_thresholds(SEARCH_BER)[0]
    return man, _fi_figures(
        "K3", lambda: fi_ops.fault_inject_bits_batched(man, seeds, thr,
                                                 positions=range(10)),
        lambda: fi_ref.fault_inject_batched_ref(man, seeds, thr,
                                                positions=range(10)),
        man.numel(), 2, 10)


def _finetune_full(dev, fi_kernel, mesh=None):
    """The Finetuner on full-width olmo-1b (2 reshape steps, 2 aligned
    steps under the Fig. 7 schedule at CODESIGN_BER through K4), on one
    device or ``mesh`` -> (finetuner, result, K4 launches, wall s, peak
    GiB)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.deployment import ReliabilityPolicy
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.training import codesign
    cfg = get_config("olmo-1b")
    data = MarkovLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    ft = codesign.Finetuner(cfg, ReliabilityPolicy(), ber=CODESIGN_BER,
                            reshape_steps=2, aligned_steps=2, device=dev,
                            mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    fi_kernel.reset_launch_counts()
    t0 = time.perf_counter()
    res = ft.run(iter(data))
    wall = time.perf_counter() - t0
    k4 = fi_kernel.launch_counts[fi_kernel.K4]
    _check(fi_kernel.launch_counts[fi_kernel.K3] == 0,
           "the Finetuner launched K3")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return ft, res, k4, wall, peak


def _select_full(cfg, params, data, dev, fi_kernel, engine=None):
    """PolicySearch.select of the smoke's two arms at SEARCH_BER, 2
    trials, on ``params``, scored against their own greedy predictions on
    two MarkovLM batches; ``engine`` (a trial-mesh SweepEngine) or the
    default one -> (result, search, the engine's cells, K3 launches,
    seconds, the embeddings' largest |w| an evaluation, the eval)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.training import codesign
    shell = lm.shell(cfg)
    evals = []
    with torch.no_grad():
        for i in range(2):
            toks = data.batch(9000 + i)["tokens"]
            pred = lm.forward(shell, params, torch.as_tensor(
                toks, dtype=torch.int64, device=dev)).argmax(-1)
            evals.append({"tokens": toks, "labels": pred.cpu().numpy()})
    del shell, pred
    accuracy = codesign.lm_accuracy_eval(cfg, evals)
    largest = []        # the embeddings' largest |w|, an evaluation

    def eval_fn(p):
        largest.append(tuple(float(p[k].abs().max())
                             for k in ("embed", "unembed")))
        return accuracy(p)
    search = codesign.PolicySearch(
        params, eval_fn, codesign.AccuracySLO(ber=SEARCH_BER, max_drop=0.05),
        n_trials=2, device=dev, engine=engine)
    cells = []          # the engine's SweepResults, for their ECC counts
    run_policies = search.engine.run_policies

    def recorded(*args):
        out = run_policies(*args)
        cells.extend(out)
        return out
    search.engine.run_policies = recorded
    fi_kernel.reset_launch_counts()
    t = time.perf_counter()
    sel = search.select(codesign.smoke_candidates())
    select_s = time.perf_counter() - t
    k3 = fi_kernel.launch_counts[fi_kernel.K3]
    _check(fi_kernel.launch_counts[fi_kernel.K4] == 0,
           "the search launched K4")
    return sel, search, cells, k3, select_s, largest, accuracy


def _select_result(sel, search) -> tuple:
    """What a select decides and reports: the choice, its accuracy, bits
    and SLO, and the trace of every arm."""
    return (sel.name, sel.accuracy, sel.stored_bits, sel.slo_met,
            search.trace)


def _codesign_full(dev, fi_kernel, card: str) -> dict:
    """(b) The co-design loop on full-width olmo-1b: the Finetuner (2
    reshape steps, 2 aligned steps under the Fig. 7 schedule at BER 1e-4,
    drawn through K4), the schedule's K4 launches, flip counts and
    determinism, then PolicySearch.select over two arms at BER 1e-3 (K3)."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import bitops
    from repro_torch.core.deployment import CIMDeployment
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.training import codesign, loop
    cfg = get_config("olmo-1b")
    data = MarkovLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    ft, res, k4, wall, peak = _finetune_full(dev, fi_kernel)
    stage1 = res.info["reshape"]["history"]
    losses = [h["loss"] for h in stage1 + res.history]
    _check(len(losses) == 4 and all(math.isfinite(x) for x in losses),
           f"phase 14: Finetuner losses {losses}")
    _check("exp_penalty" in stage1[0], "phase 14: no exp_penalty in stage 1")
    stats = res.ecc_stats
    _check(stats.get("stored_bits", 0) > 0, f"phase 14: ecc_stats {stats}")
    run2 = ft._run_cfg(steps=2, ber=CODESIGN_BER, inject="dynamic")
    corrupt = loop.make_fault_schedule(run2)
    params = res.state.params
    res.state.opt = None                   # the moments: not needed below
    want = _k4_launches_expected(params, corrupt.rates)
    _check(k4 == 2 * want, f"phase 14: K4 launched {k4} times in 2 aligned "
           f"steps, expected {want} a step (drawn leaves x fields)")
    for h in stage1:
        print(f"phase 14: Finetuner reshape step {h['step']}: loss "
              f"{h['loss']:.4f} exp_penalty {h['exp_penalty']:.4f} "
              f"{h['step_time'] * 1e3:.1f} ms")
    for h in res.history:
        print(f"phase 14: Finetuner aligned step {h['step']} (BER "
              f"{CODESIGN_BER:g}, dynamic): loss {h['loss']:.4f} grad_norm "
              f"{h['grad_norm']:.4f} {h['step_time'] * 1e3:.1f} ms")
    # the schedule at step 0's seed, alone: its flips, its determinism and
    # its time inside a step
    seed0 = loop.step_seed(run2, 0)
    torch.cuda.synchronize()
    fi_kernel.reset_launch_counts()
    t = time.perf_counter()
    a = corrupt(params, seed0)
    torch.cuda.synchronize()
    corrupt_ms = (time.perf_counter() - t) * 1e3
    _check(fi_kernel.launch_counts[fi_kernel.K4] == want,
           f"phase 14: one corrupt launched "
           f"{fi_kernel.launch_counts[fi_kernel.K4]} K4, expected {want}")
    flips = _field_flips(params, a, corrupt.rates)
    for field, (got, mean, sd) in flips.items():
        _check(abs(got - mean) <= FLIP_SIGMAS * sd, f"phase 14: {field} "
               f"flips {got}, binomial mean {mean:.1f} sd {sd:.1f}")
    b = corrupt(params, seed0)
    same = all(torch.equal(bitops.to_bits(a[p]), bitops.to_bits(b[p]))
               for p in params)
    _check(same, "phase 14: the schedule drew two trees from one seed")
    del b
    split = _check_chunked_leaf(params, a, seed0, corrupt, ft)
    del a
    torch.cuda.empty_cache()
    _profile_arm(dev, lambda: corrupt(params, seed0), corrupt_ms / 1e3,
                 label="phase 14: the schedule's profile")
    step_ms = [h["step_time"] * 1e3 for h in res.history]
    chunk, rows, k4_fig = _k4_chunk_figures(params, fi_kernel)
    print(f"phase 14: Finetuner on full-width olmo-1b: 4 steps in "
          f"{wall:.1f} s of wall; losses finite; ecc_stats: "
          f"{stats['stored_bits']} stored bits ({stats['overhead']:+.1%}); "
          f"peak device memory {peak:.2f} GiB (max_memory_allocated)")
    print(f"phase 14: K4 launches a step: {want} (= drawn leaves x fields; "
          f"{k4} over the 2 aligned steps); the schedule alone "
          f"{corrupt_ms:.1f} ms of wall (host clock, synchronized; predicted "
          f"under {SCHEDULE_MS_PREDICTED:g} ms) "
          f"against aligned steps of {', '.join(f'{x:.1f}' for x in step_ms)}"
          f" ms; K4 at the {chunk[0]} counter chunk {tuple(chunk[1].shape)} "
          f"-> [{rows}, {chunk[1].shape[-1]}] mantissa: "
          f"{k4_fig['ms']:.4f} ms (plain {k4_fig['plain_ms']:.2f} ms), bound "
          f"{k4_fig['bound_ms']:.4f} ms ({k4_fig['bound_by']}) on {card}")
    print("phase 14: step 0's flips over the whole tree: " + "; ".join(
        f"{f} {got} (binomial mean {mean:.1f}, sd {sd:.1f}, "
        f"{(got - mean) / sd:+.2f} sigma)" for f, (got, mean, sd)
        in flips.items()) + "; a second draw from the same seed equal "
        f"bitwise; {split} == its plain version chunk by chunk, bitwise")
    # PolicySearch.select on the fine-tuned weights (K3), scored against
    # the clean model's own greedy predictions, so that faults can move it
    sel, search, cells, k3, select_s, largest, accuracy = _select_full(
        cfg, params, data, dev, fi_kernel)
    ecc = {r.protect: (r.corrected, r.uncorrectable) for r in cells}
    planes, overhead, read_acc = {}, {}, {}
    for name, policy in codesign.smoke_candidates().items():
        dep = CIMDeployment.deploy(params, policy)
        planes[name] = sum(len([q for q in (s.man, s.codewords, s.exp,
                                            s.sign) if q is not None])
                           for _, _, s in dep.store_leaves())
        overhead[name] = dep.bit_cost()["overhead"]
        read_acc[name] = float(accuracy(dep.read()[0]))
        del dep
    _check(k3 == sum(planes.values()), f"phase 14: K3 launched {k3} times, "
           f"expected one a store plane: {planes}")
    arms = search.trace[-1]["arms"]
    for name, v in arms.items():
        print(f"phase 14: PolicySearch arm {name}: K3 launches "
              f"{planes[name]} (planes x 1), accuracy {v['accuracy']:.4f} "
              f"against the clean greedy predictions ({read_acc[name]:.4f} "
              f"from a fault-free deploy and read), mean codewords "
              f"corrected {ecc[name][0]:.1f} / uncorrectable "
              f"{ecc[name][1]:.1f} a trial, stored_bits {v['stored_bits']} "
              f"(overhead {overhead[name]:+.2%} against raw fp16)")
    print(f"phase 14: the largest |w| of (embed, unembed) an evaluation "
          f"(clean first, then each arm's trials): {largest}")
    print(f"phase 14: PolicySearch.select at BER {SEARCH_BER:g} (n_trials 2): "
          f"selected {sel.name}, accuracy {sel.accuracy:.4f} (clean "
          f"{sel.clean_accuracy:.4f}, floor {sel.floor:.4f}), slo_met "
          f"{sel.slo_met}, stored_bits {sel.stored_bits} (overhead "
          f"{sel.overhead:+.2%}), {sel.evals} evals in {select_s:.1f} s")
    man, k3_fig = _k3_embed_figures(params)
    print(f"phase 14: K3 at the embed's mantissa plane {tuple(man.shape)}, "
          f"T = 2: {k3_fig['ms']:.4f} ms (plain {k3_fig['plain_ms']:.2f} ms)"
          f", bound {k3_fig['bound_ms']:.4f} ms ({k3_fig['bound_by']}) on "
          f"{card}")
    ref = {"losses": losses, "params": {p: w.cpu() for p, w in
                                        params.items()},
           "select": _select_result(sel, search), "k3": k3,
           "k4_a_step": want}
    del res, params, search
    torch.cuda.empty_cache()
    return {"reference": ref,
            "fault_inject": {"launches": want, "launches_2_steps": k4,
                             "shape": [rows, int(chunk[1].shape[-1])],
                             "corrupt_ms": corrupt_ms, "step_ms": step_ms,
                             **k4_fig},
            "fault_inject_batched": {"launches": k3, "by_arm": planes,
                                     "shape": list(man.shape), "trials": 2,
                                     **k3_fig},
            "peak_gib": peak}


def _reduced_search_card_vs_cpu(dev) -> None:
    """(b) PolicySearch.search over two groups on reduced olmo-1b, card
    against CPU: the same trace move for move, accuracies equal (K3 is
    bitwise its plain version, the eval labels are the CPU's clean
    predictions)."""
    import torch
    from repro_torch import convert
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.models import lm
    from repro_torch.models.losses import lm_loss
    from repro_torch.training import codesign
    cfg = get_config("olmo-1b").reduced()
    model = lm.LM(cfg, generator=torch.Generator().manual_seed(5),
                  device="cpu")
    flat = convert.flat_from_lm(model)
    toks = torch.as_tensor(MarkovLM(cfg.vocab_size, 16, 2, seed=0)
                           .batch(0)["tokens"], dtype=torch.int64)
    with torch.no_grad():
        labels = lm.forward(model, flat, toks).argmax(-1)
    space = codesign.SearchSpace(groups=(("embed", "embed"),
                                         ("unembed", "unembed")),
                                 protects=("none", "one4n"),
                                 fields=("exponent_sign",))
    out = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        shell = lm.shell(cfg)
        t, y = toks.to(d), labels.to(d)

        @torch.no_grad()
        def eval_fn(p):
            return lm_loss(lm.forward(shell, p, t), y)[1]["accuracy"]
        out[name] = codesign.PolicySearch(
            {p: w.to(d) for p, w in flat.items()}, eval_fn,
            codesign.AccuracySLO(ber=3e-3, max_drop=0.02), space,
            n_trials=3, seeds=11, device=d).search()
    a, b = out["card"], out["cpu"]
    _check(a.trace == b.trace and a.assignment == b.assignment
           and a.slo_met == b.slo_met, f"phase 14: reduced search card "
           f"trace {a.trace} != CPU {b.trace}")
    print(f"phase 14: reduced olmo-1b PolicySearch.search (2 groups, BER "
          f"3e-3): card trace == CPU move for move ("
          + ", ".join(e["action"] + (f" {e['group']}" if "group" in e else "")
                      for e in a.trace)
          + f"), assignment {a.assignment}, slo_met {a.slo_met}, "
          f"{a.evals} evals")


def phase_codesign(dev, fi_kernel, card: str) -> dict:
    """Phase 14: training every block kind, then the co-design loop.
    Returns K3's and K4's figures on this path (the kernels line carries
    them under ``"codesign"``)."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    secs, peaks = {}, {}

    def part(what, fn):
        t = time.perf_counter()
        out = fn()
        secs[what] = time.perf_counter() - t
        peaks[what] = torch.cuda.max_memory_allocated() / 2 ** 30
        torch.cuda.reset_peak_memory_stats()
        return out
    part(f"{RWKV} training", lambda: _train_full_kind(dev, card))
    part("reduced kinds", lambda: _reduced_kind_steps(dev))
    figs = part("co-design", lambda: _codesign_full(dev, fi_kernel, card))
    part("reduced search", lambda: _reduced_search_card_vs_cpu(dev))
    print(f"phase 14: {time.perf_counter() - t0:.1f} s of wall (by part: "
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
          + f"); peak device memory {max(peaks.values()):.2f} GiB "
          f"(max_memory_allocated; by part: "
          + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items())
          + f") on {card}")
    return figs


# ---------------------------------------------------------------------------
# Phase 15: the int8 K/V cache and the device mesh.
# ---------------------------------------------------------------------------

MESH_SPLITS = ((4, "j"), (2, "k"))   # 12576-column shards, 1024-row slabs
MESH_ROUNDS = 2
MESH_SEEDS = {"man": 0x1234567, "meta": 0x89ABCDE, "cw": 0x2468ACE}


def _same_plane(a, b) -> bool:
    """Bitwise plane equality (uint16 planes through their int16 view: CUDA
    has no uint16 comparison)."""
    import torch
    if a.dtype == torch.uint16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and torch.equal(a, b)


def _mesh_flips(name, store, thr) -> int:
    """(a) Each shard's inject_sharded planes equal the block of the
    single-device image, under i.i.d. and each MODEL_SPECS process, and its
    decode the block of the single-device decode (i.i.d.). Returns the
    planes compared."""
    import torch
    from repro_torch.core import cim
    compared = 0
    for spec in (None,) + MODEL_SPECS:
        full = cim.inject_with_seeds(store, MESH_SEEDS, thr, thr, model=spec)
        planes = cim.plane_dict(full)
        w_full = cim.read(full)[0] if spec is None else None
        for n, dim in MESH_SPLITS:
            sdim = 0 if dim == "k" else 1
            for i in range(n):
                shard = cim.shard_store(store, n, i, dim)
                _check(shard.shard.sharded, f"phase 15: {name} {n}-way "
                       f"{dim} did not split")
                got = cim.inject_sharded(MESH_SEEDS, shard, MODEL_BER,
                                         model=spec)
                for pname, p in cim.plane_dict(got).items():
                    size = planes[pname].shape[sdim] // n
                    want = planes[pname].narrow(sdim, i * size, size)
                    _check(_same_plane(p, want), f"phase 15: {name} "
                           f"{n}-way {dim} shard {i} plane {pname} under "
                           f"{spec or 'iid'} != the single-device block")
                    compared += 1
                if w_full is not None:
                    w = cim.read(got)[0]
                    size = w.shape[sdim]
                    _check(_same_bits(w, w_full.narrow(sdim, i * size, size)),
                           f"phase 15: {name} {n}-way {dim} shard {i} "
                           f"decode != the single-device block")
                del got, shard
        del full, planes, w_full
        torch.cuda.empty_cache()
    return compared


def _mesh_reads(name, store, kernel_lib, card) -> dict:
    """(a) K1/K2 on every shard at its offsets, M = 4 and 1, static and
    dynamic, against the plain version at the same offsets; the j slices
    gathered and the k partials summed against the unsharded kernel; one
    launch a shard a read; each shard read timed beside the unsharded
    one."""
    import torch
    from repro_torch.core import cim
    from repro_torch.kernels.cim_read import ops, ref
    from repro_torch.kernels.fault_inject.ops import ber_to_threshold
    dev = store.device
    thr = ber_to_threshold(MODEL_BER)
    sc = ops.make_scalars(MESH_SEEDS, thr, thr)
    g = torch.Generator(device=dev).manual_seed(15)
    x4 = torch.randn((BATCH, K), generator=g, device=dev)
    injected = cim.inject_with_seeds(store, MESH_SEEDS, thr, thr)
    wabs = {"static": cim.read(store)[0].abs(),
            "dynamic": cim.read(injected)[0].abs()}
    del injected
    out, worst = {}, 0.0
    for x in (x4, x4[:1].contiguous()):
        m = x.shape[0]
        whole = {"static": ops.cim_linear_store(x, store),
                 "dynamic": ops.cim_linear_store(x, store, scalars=sc)}
        for n, dim in MESH_SPLITS:
            shards = [cim.shard_store(store, n, i, dim) for i in range(n)]
            k_loc = K // n if dim == "k" else K
            parts = {"static": [], "dynamic": []}
            for i, shard in enumerate(shards):
                xs = x if dim == "j" else x[:, i * k_loc:(i + 1) * k_loc] \
                    .contiguous()
                cols = slice(None) if dim == "k" else \
                    slice(i * shard.shape[1], (i + 1) * shard.shape[1])
                rows = slice(None) if dim == "j" else \
                    slice(i * k_loc, (i + 1) * k_loc)
                for mode, s in (("static", None), ("dynamic", sc)):
                    got, info = ops.cim_linear_store(xs, shard, scalars=s,
                                                     with_info=True)
                    _check(info["used_kernel"] and info["tiles"]["kernel"]
                           == "narrow", f"phase 15: {name} shard read "
                           f"{info.get('tiles')}")
                    want, _ = ref.cim_read_ref(xs, shard, s)
                    ok, err = _close(got, want,
                                     xs.abs() @ wabs[mode][rows, cols])
                    _check(ok, f"phase 15: {name} {n}-way {dim} shard {i} "
                           f"M = {m} {mode} vs plain at the same offsets "
                           f"(max err {err:.3e})")
                    worst = max(worst, err)
                    parts[mode].append(got)
            for mode in parts:
                if dim == "j":
                    got = torch.cat(parts[mode], dim=-1)[:, :J]
                    bitwise = _same_bits(got, whole[mode])
                    diff = float((got - whole[mode]).abs().nan_to_num()
                                 .max())
                    _check(bitwise or diff <= TOL, f"phase 15: {name} "
                           f"gathered j slices vs unsharded ({mode}, M = {m})"
                           f": max diff {diff:.3e}")
                    if not bitwise:
                        print(f"phase 15: {name} M = {m} {mode}: the gathered "
                              f"j slices differ from the unsharded read by "
                              f"{diff:.3e} (not bitwise: each column's K loop "
                              f"is its shard's, so a difference comes from "
                              f"the narrow kernel's strip state at the shard "
                              f"offset)")
                else:
                    got = parts[mode][0]
                    for p in parts[mode][1:]:
                        got = got + p
                    ok, err = _close(got, whole[mode],
                                     x.abs() @ wabs[mode])
                    _check(ok, f"phase 15: {name} k partials summed vs "
                           f"unsharded ({mode}, M = {m}, max err {err:.3e})")
                out.setdefault(f"{n}{dim}", {})[f"m{m}_{mode}_bitwise"] = \
                    _same_bits(got, whole[mode]) if dim == "j" else None
            kernel_lib.reset_launch_counts()
            for i, shard in enumerate(shards):
                xs = x if dim == "j" else x[:, i * k_loc:(i + 1) * k_loc] \
                    .contiguous()
                ops.cim_linear_store(xs, shard, scalars=sc)
            _check(kernel_lib.launch_counts[name] == n,
                   f"phase 15: {name} {n}-way {dim}: "
                   f"{kernel_lib.launch_counts[name]} launches for one read")
            if m != BATCH:
                continue
            figs = []
            for i, shard in enumerate(shards):
                xs = x if dim == "j" else x[:, i * k_loc:(i + 1) * k_loc] \
                    .contiguous()
                w = cim.read(shard)[0]
                j_loc = shard.shape[1]
                nbytes = _store_bytes(shard) + xs.numel() * 4 + m * j_loc * 4
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = 2.0 * m * xs.shape[1] * j_loc / FP32_FLOPS * 1e3
                draws = _draws(shard)
                hash_ms = draws * ALU_OPS_PER_DRAW / INT32_OPS * 1e3
                figs.append({
                    "shard": i, "shape": list(shard.shape),
                    "offsets": list(shard.shard.offsets),
                    "ms": _time_ms(lambda: ops.cim_linear_store(
                        xs, shard, scalars=sc)),
                    "static_ms": _time_ms(lambda: ops.cim_linear_store(
                        xs, shard)),
                    "plain_ms": _time_ms(lambda: ref.cim_read_ref(
                        xs, shard, sc), reps=3, inner=1),
                    "library_ms": _time_ms(lambda: torch.matmul(xs, w)),
                    "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "bytes" if bytes_ms >= ops_ms
                    else "operations",
                    "dynamic_bound_ms": max(bytes_ms, hash_ms),
                    "dynamic_bound_by": "bytes" if bytes_ms >= hash_ms
                    else "operations", "bytes": nbytes, "draws": draws})
                del w
            row = out[f"{n}{dim}"]
            row.update({"launches": n, "shards": figs,
                        "unsharded_ms": _time_ms(lambda: ops.cim_linear_store(
                            x, store, scalars=sc)),
                        "unsharded_static_ms": _time_ms(
                            lambda: ops.cim_linear_store(x, store))})
            for f in figs:
                print(f"phase 15: {name} {n}-way {dim} shard {f['shard']} "
                      f"{f['shape']} at offsets {f['offsets']}, M = {m}: "
                      f"{f['ms']:.4f} ms dynamic, {f['static_ms']:.4f} ms "
                      f"static (unsharded {row['unsharded_ms']:.4f} / "
                      f"{row['unsharded_static_ms']:.4f}); torch.matmul at "
                      f"the shard's shape {f['library_ms']:.4f} ms, plain "
                      f"{f['plain_ms']:.2f} ms; bound {f['bound_ms']:.4f} ms"
                      f" static, {f['dynamic_bound_ms']:.4f} ms dynamic "
                      f"({f['draws'] / 1e9:.3f} G draws) on {card}")
            del shards
    for row in out.values():
        row["max_abs_err"] = worst
    return out


def _mesh_serve(model, kernel_lib) -> dict:
    """(b) serve --mesh 1x1 --rounds 2 through a world-size-1 NCCL group:
    arms (a) and (b) give the unsharded run's tokens, GEN launches of the
    arm's kernel a round, every read narrow."""
    import numpy as np
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import serve as serve_lib
    mesh = mesh_lib.make_serve_mesh("1x1", "cuda")
    launches = {}
    try:
        for name, (label, path, protect, inject, ber) in zip(
                ("cim_read_matmul_one4n", "cim_read_matmul_raw"), ARMS[:2]):
            kw = dict(batch=BATCH, prompt_len=PROMPT, gen=GEN, seed=0,
                      cim=True, ber=ber, protect=protect, serve_path=path,
                      inject=inject, rounds=MESH_ROUNDS, verbose=False)
            base = serve_lib.serve(model, **kw)
            kernel_lib.reset_launch_counts()
            res, kernels = _kernels_of(lambda: serve_lib.serve(
                model, mesh=mesh, **kw))
            counts = dict(kernel_lib.launch_counts)
            _check(counts[name] == GEN * MESH_ROUNDS == res["launches"][name],
                   f"phase 15: mesh arm {label}: launches {counts}")
            _check(kernels == ["narrow"] * (GEN * MESH_ROUNDS),
                   f"phase 15: mesh arm {label}: reads {kernels}")
            _check(np.array_equal(res["round_tokens"], base["round_tokens"]),
                   f"phase 15: mesh arm {label}: tokens != the unsharded "
                   f"run's")
            _check(res["ecc"] == base["ecc"], f"phase 15: mesh arm {label}: "
                   f"ECC {res['ecc']} != {base['ecc']}")
            print(f"phase 15: serve --mesh 1x1 --rounds {MESH_ROUNDS} arm "
                  f"{label}: tokens == the unsharded run's, {counts[name]} "
                  f"narrow launches ({GEN} a round), "
                  f"{res['tok_per_s']:.1f} tok/s aggregate "
                  f"({res['tok_per_s_device']:.1f} a device; unsharded "
                  f"{base['tok_per_s']:.1f}); model axis "
                  f"{shlib.axis_size('model', mesh)}")
            launches[name] = counts[name]
    finally:
        mesh_lib.destroy_world()
    return launches


def _mesh_trials(dev, model, fi_kernel, card) -> dict:
    """(c) Phase 5's one4n arm, its trials as two ranks' slices one after
    the other: the joined per-trial agreements and ECC counts equal the
    unsharded arm's bitwise; K3 timed on a slice's trials."""
    import numpy as np
    from repro_torch.core import cim
    from repro_torch.core import sweep as sweep_lib
    from repro_torch.kernels.fault_inject import ops, ref
    params, agreement, cim_cfg, seeds = _fig6_setup(dev, model)
    a = FIG6_PROTECTS.index("one4n")
    plan = sweep_lib.SweepPlan(bers=FIG6_BERS, n_trials=FIG6_TRIALS,
                               protects=("one4n",))
    whole = sweep_lib.SweepEngine(plan, device=dev).run_protection(
        seeds[a:a + 1], params, agreement, cim_cfg)
    parts, launches = [], []
    for r in range(2):
        fi_kernel.reset_launch_counts()
        parts.append(sweep_lib.SweepEngine(plan, device=dev,
                                           trial_shard=(2, r)).run_protection(
            seeds[a:a + 1], params, agreement, cim_cfg))
        launches.append(fi_kernel.launch_counts[fi_kernel.K3])
    joined = sweep_lib.merge_trial_shards(parts)
    for w, j in zip(whole, joined):
        _check(w.accuracies == j.accuracies and
               w.trial_corrected == j.trial_corrected and
               w.trial_uncorrectable == j.trial_uncorrectable and
               (w.corrected, w.uncorrectable) == (j.corrected,
                                                  j.uncorrectable),
               f"phase 15: trial slices at {w.ber:.0e}: {j.accuracies} "
               f"{j.trial_corrected} vs {w.accuracies} {w.trial_corrected}")
    want = 2 * FIG6_PLANES["one4n"] * len(FIG6_BERS)
    _check(launches == [want, want], f"phase 15: K3 launches a slice "
           f"{launches}, expected {want}")
    print(f"phase 15: Fig. 6 one4n as two trial slices: per-trial agreement "
          f"and ECC counts equal the unsharded arm's ({[r.accuracies for r in joined]}, "
          f"corrected {[r.trial_corrected for r in joined]}); {launches} K3 "
          f"launches a slice")
    man = cim.deploy_pytree_impl({"unembed": params["unembed"]},
                                 cim_cfg)[0]["unembed"].man
    half = np.asarray(seeds[a, -1, :FIG6_TRIALS // 2], np.uint32)
    thr = ops.ber_to_threshold(FIG6_BERS[-1])
    figs = _fi_figures(
        "phase 15: K3 on a trial slice",
        lambda: ops.fault_inject_bits_batched(man, half, thr,
                                              positions=range(10)),
        lambda: ref.fault_inject_batched_ref(man, half, thr,
                                             positions=range(10)),
        man.numel(), len(half), 10)
    figs["launches"] = launches[0]
    print(f"phase 15: fault_inject_batched on a trial slice (T = {len(half)}"
          f" of {FIG6_TRIALS}) at the unembed mantissa plane: "
          f"{figs['ms']:.4f} ms, plain {figs['plain_ms']:.2f} ms, bound "
          f"{figs['bound_ms']:.4f} ms on {card}")
    return figs


def _slot_run(model, cfg, tokens, steps: int, params=None):
    """The slot-state protocol on ``model``: every slot's prompt prefilled
    as one chunk, then ``steps`` greedy decode steps -> (slot states,
    logits of every step, ms a decode step)."""
    import numpy as np
    import torch
    from repro_torch.models import lm
    dev = model.embed.device
    b, s = tokens.shape
    caches = lm.init_slot_states(cfg, b, s + steps + 1, device=dev)
    logits = []
    with torch.inference_mode():
        first = torch.stack([model.prefill_chunk(caches, tokens[i], i, 0,
                                                 params=params)[0]
                             for i in range(b)])
        logits.append(first)
        cur = first.argmax(-1)[:, None]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            lg, caches = model.decode_slots(caches, cur, np.ones(b, bool),
                                            params=params)
            logits.append(lg)
            cur = lg.argmax(-1)[:, None]
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
    return caches, logits, ms


def _cache_bytes(caches) -> int:
    return sum(t.numel() * t.element_size() for st in caches["layers"]
               for t in st.values())


def _int8_cache(dev, model, card) -> dict:
    """(d) The int8 K/V cache: full-width olmo-1b's slot states, arm (c)'s
    static image, int8 beside the compute dtype (bytes and decode ms a
    step); reduced olmo-1b card == CPU; the engine's solo == co-batched on
    the card."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.launch import serve as serve_lib
    from repro_torch.models import attention
    from repro_torch.models.lm import LM
    cfg = model.cfg
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    _, path, protect, inject, ber = ARMS[2]
    params = serve_lib.build_params(model, cim=True, ber=ber, protect=protect,
                                    serve_path=path, inject=inject,
                                    verbose=False)[0]
    toks = torch.as_tensor(MarkovLM(cfg.vocab_size, PROMPT, BATCH, seed=0)
                           .batch(0)["tokens"], dtype=torch.int64, device=dev)
    figs = {}
    for tag, c in (("compute", cfg), ("int8", cfg8)):
        caches, logits, ms = _slot_run(model, c, toks, GEN - 1, params)
        figs[tag] = {"cache_bytes": _cache_bytes(caches), "ms_step": ms,
                     "tokens": torch.stack([lg.argmax(-1) for lg in logits],
                                           1).cpu().numpy()}
        _check(all(bool(torch.isfinite(lg).all()) for lg in logits),
               f"phase 15: {tag} cache: non-finite logits")
        del caches, logits
    agree = float((figs["int8"]["tokens"] == figs["compute"]["tokens"])
                  .mean())
    print(f"phase 15: full-width olmo-1b slot states, arm {ARMS[2][0]}: int8 "
          f"cache {figs['int8']['cache_bytes'] / 1e6:.1f} MB, "
          f"{figs['int8']['ms_step']:.3f} ms a decode step; compute dtype "
          f"{figs['compute']['cache_bytes'] / 1e6:.1f} MB, "
          f"{figs['compute']['ms_step']:.3f} ms; greedy tokens agree "
          f"{agree:.3f} on {card}")
    del params
    # reduced olmo-1b: the cache on the card against the CPU's
    red8 = dataclasses.replace(get_config("olmo-1b").reduced(),
                               kv_cache_dtype="int8")
    cpu = LM(red8, generator=torch.Generator().manual_seed(4), device="cpu")
    gpu = LM(red8, device=dev)
    gpu.load_state_dict(cpu.state_dict())
    rtoks = torch.as_tensor(MarkovLM(256, 8, 2, seed=1).batch(0)["tokens"],
                            dtype=torch.int64)
    (c_cpu, l_cpu, _), (c_gpu, l_gpu, _) = (
        _slot_run(m, red8, rtoks.to(m.embed.device), 4) for m in (cpu, gpu))
    diffs = {}
    for layer, (a, b) in enumerate(zip(c_cpu["layers"], c_gpu["layers"])):
        for n in ("k", "v", "k_scale", "v_scale"):
            bb = b[n].cpu()
            if n.endswith("scale"):
                d = (a[n].view(torch.int16).to(torch.int32)
                     - bb.view(torch.int16).to(torch.int32)).abs()
            else:
                d = (a[n].to(torch.int32) - bb.to(torch.int32)).abs()
            diffs[f"{layer}/{n}"] = (int((d > 0).sum()), int(d.max()))
    n_diff = sum(v[0] for v in diffs.values())
    _check(n_diff == 0, f"phase 15: reduced int8 cache card vs CPU: "
                        f"(values differing, largest step) {diffs}")
    _check(all(torch.equal(a.argmax(-1).cpu(), b.argmax(-1).cpu())
               for a, b in zip(l_cpu, l_gpu)),
           "phase 15: reduced int8 cache: card tokens != CPU tokens")
    rng = np.random.default_rng(0)
    xq = torch.from_numpy((rng.standard_normal((4, 64, 8, 64)) * 3)
                          .astype(np.float32))
    xq[0, 0, 0] = 0.0
    xq[0, 1, 0] = torch.linspace(-254, 254, 64)
    qc, sc_ = attention.quant_kv(xq)
    qg, sg = attention.quant_kv(xq.to(dev))
    _check(torch.equal(qc, qg.cpu()) and
           torch.equal(sc_.view(torch.int16), sg.cpu().view(torch.int16)),
           "phase 15: quant_kv on the card != the CPU's on the same input")
    print(f"phase 15: reduced olmo-1b int8 cache, card vs CPU: bitwise "
          f"(values and bf16 scales of 2 layers over prefill + 4 decode "
          f"steps), tokens equal; quant_kv bitwise on the same input")
    # the engine on the card: solo == co-batched on the int8 cache
    from repro_torch.launch import engine as engine_lib
    load = engine_lib.LoadGen(n_requests=4, prompt_lens=(8, 32),
                              gen_lens=(3, 6), vocab_size=256, seed=0)
    reqs, max_len = load.requests(), load.max_len()
    eparams = _engine_params(gpu, ENGINE_ARMS[0])
    co, _ = _engine_run(gpu, eparams, reqs, max_len, collect_logits=True)
    for rid in (0, 2):
        solo, _ = _engine_run(gpu, eparams, [reqs[rid]], max_len,
                              collect_logits=True)
        _check(_same_request(co[rid], solo[rid]), f"phase 15: int8 engine "
               f"request {rid} solo != co-batched")
    print("phase 15: engine on the card with the int8 cache, arm "
          f"{ENGINE_ARMS[0][0]}: solo == co-batched bitwise (rids 0, 2)")
    figs["reduced_card_vs_cpu_diffs"] = n_diff
    for tag in ("compute", "int8"):
        figs[tag].pop("tokens")
    figs["token_agreement"] = agree
    return figs


def phase_mesh(dev, checks: dict, kernel_lib, fi_kernel, card: str) -> dict:
    """Phase 15: the sharded image (a), serving on a 1x1 mesh (b), the trial
    slices of Fig. 6 (c) and the int8 K/V cache (d). Returns the K1/K2 shard
    rows by kernel, K3's trial-slice figures and the int8 figures."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.fault_inject.ops import ber_to_threshold
    from repro_torch.models.lm import LM
    t0 = time.perf_counter()
    parts = {}
    thr = ber_to_threshold(MODEL_BER)
    out = {"mesh": {}}
    for name in PROTECT_OF:
        store = checks[name]["store"]
        n = _mesh_flips(name, store, thr)
        print(f"phase 15: {name}: {n} shard planes under i.i.d. and "
              f"{len(MODEL_SPECS)} processes equal the single-device blocks "
              f"bitwise; i.i.d. decodes too")
        out["mesh"][name] = _mesh_reads(name, store, kernel_lib, card)
    parts["a"] = time.perf_counter() - t0
    model = LM(get_config("olmo-1b"),
               generator=torch.Generator(device=dev).manual_seed(0),
               device=dev)
    t1 = time.perf_counter()
    for name, n in _mesh_serve(model, kernel_lib).items():
        out["mesh"][name]["serve_launches"] = n
    parts["b"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["trial_slice"] = _mesh_trials(dev, model, fi_kernel, card)
    parts["c"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["int8"] = _int8_cache(dev, model, card)
    parts["d"] = time.perf_counter() - t1
    del model
    torch.cuda.empty_cache()
    print(f"phase 15: {time.perf_counter() - t0:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    return out


# ---------------------------------------------------------------------------
# Phase 16: the MoE all-to-all, data-parallel training and the co-design
# loop on meshes.
# ---------------------------------------------------------------------------

QWEN = "qwen3-moe-235b-a22b"
A2A_RANKS, A2A_TOKENS = 4, 256       # emulated "model" ranks, tokens a rank
A2A_FACTORS = (None, 8.0)            # the config's 1.25, then never binding
MOE_LEAVES = ("router", "moe_wgate", "moe_win", "moe_wout")


def _rel_err(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max()) / (float(b.abs().max()) or 1.0)


def _a2a_layer(dev, card: str) -> dict:
    """(a) qwen3-moe's MoE layer at its published widths (d_model 4096, 128
    experts, top-8, d_ff_expert 1536, fp32) over 4 x 256 tokens, the 4
    "model" ranks of the all-to-all emulated in this process, against the
    dense dispatch of each rank's slice: drop sets bitwise, outputs and the
    input, router and expert gradients of sum(out * r) + aux within 1e-4
    of the largest, then forward + backward timed with CUDA events beside
    the per-slice and the global dense dispatch."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe, moe_a2a
    base = get_config(QWEN)
    gen = torch.Generator(device=dev).manual_seed(0)
    layer = moe.MoE(base, generator=gen, device=dev)
    weights = tuple(getattr(layer, n) for n in MOE_LEAVES)
    n_tok = A2A_RANKS * A2A_TOKENS
    x = torch.randn(1, n_tok, base.d_model, generator=gen, device=dev)
    x.requires_grad_(True)
    r = torch.randn(x.shape, generator=gen, device=dev)
    gbytes = sum(w.numel() for w in weights) * 4 / 1e9
    out = {"experts_gb": gbytes, "tokens": [A2A_RANKS, A2A_TOKENS]}
    for cf in A2A_FACTORS:
        cfg = base if cf is None else dataclasses.replace(
            base, capacity_factor=cf)

        def a2a():
            o, aux, keeps = moe_a2a.apply_moe_a2a_local(weights, cfg, x, 1,
                                                        A2A_RANKS)
            return o, aux, keeps[0]

        def sliced():
            outs, auxes, keeps = [], [], []
            for m in range(A2A_RANKS):
                o, a, k = moe.dense_dispatch(
                    weights, cfg, x[0, m * A2A_TOKENS:(m + 1) * A2A_TOKENS])
                outs.append(o)
                auxes.append(a)
                keeps.append(k)
            return torch.cat(outs)[None], torch.stack(auxes).mean(), keeps

        def whole():
            o, a, k = moe.dense_dispatch(weights, cfg, x[0])
            return o[None], a, [k]

        def fwd_bwd(fn):
            o, aux, keeps = fn()
            grads = torch.autograd.grad((o * r).sum() + aux,
                                        (x,) + weights)
            return o.detach(), aux.detach(), keeps, grads
        a_out, a_aux, a_keep, a_g = fwd_bwd(a2a)
        d_out, d_aux, d_keep, d_g = fwd_bwd(sliced)
        _check(all(torch.equal(p, q) for p, q in zip(a_keep, d_keep)),
               f"phase 16: the all-to-all's drop set differs from the "
               f"per-slice dense dispatch's (capacity factor "
               f"{cfg.capacity_factor})")
        drops = sum(int((~k).sum()) for k in d_keep)
        errs = {"out": _rel_err(a_out, d_out),
                "aux": _rel_err(a_aux, d_aux)}
        for name, g, h in zip(("x",) + MOE_LEAVES, a_g, d_g):
            errs[name] = _rel_err(g, h)
        del a_g, d_g, a_out, d_out
        bad = {k: v for k, v in errs.items() if not v <= TOL}
        _check(not bad, f"phase 16: all-to-all vs per-slice dense at "
               f"capacity factor {cfg.capacity_factor}: {bad}")
        torch.cuda.synchronize()
        step = {}
        for name, fn in (("a2a", a2a), ("dense_slices", sliced),
                         ("dense_global", whole)):
            step[name] = _time_ms(lambda: fwd_bwd(fn), reps=3, inner=2)
        c = moe.capacity(cfg, A2A_TOKENS)
        out[f"cf{cfg.capacity_factor:g}"] = {
            "capacity": c, "drops": drops, "errors": errs, "ms": step}
        print(f"phase 16: (a) {QWEN} MoE layer at published widths "
              f"({gbytes:.2f} GB of fp32 experts), {A2A_RANKS} ranks x "
              f"{A2A_TOKENS} tokens, capacity factor {cfg.capacity_factor:g}"
              f" (local capacity {c}): {drops} of "
              f"{n_tok * cfg.top_k} assignments dropped, drop sets == the "
              f"per-slice dense dispatch's bitwise; max error over max "
              f"(<= {TOL:g}): " + ", ".join(f"{k} {v:.2e}" for k, v in
                                            errs.items())
              + f"; forward + backward {step['a2a']:.2f} ms all-to-all (4 "
              f"ranks in turn) against {step['dense_slices']:.2f} ms dense "
              f"by slice and {step['dense_global']:.2f} ms dense over all "
              f"{n_tok} tokens (CUDA events) on {card}")
    del layer, weights, x, r
    torch.cuda.empty_cache()
    return out


def _mesh_train(dev, fi_kernel, mesh, ref, card: str) -> dict:
    """(b) run_training on the 1x1 mesh: 2 aligned steps of full-width
    olmo-1b at TRAIN_BATCH x TRAIN_SEQ under the Fig. 7 schedule at
    CODESIGN_BER, bitwise the same steps without the mesh from one state;
    K4's launches a step drawn leaves x fields, and phase 14's (``ref``)
    where it ran."""
    import torch
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.deployment import ReliabilityPolicy
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.training import loop, steps
    cfg = get_config("olmo-1b")
    run = RunConfig(steps=2, checkpoint_dir="", learning_rate=1e-3,
                    warmup_steps=0, policy=ReliabilityPolicy(),
                    ber=CODESIGN_BER, inject="dynamic")

    def train(on):
        gen = torch.Generator(device=dev).manual_seed(0)
        state = steps.init_train_state(gen, cfg, run, device=dev)
        torch.cuda.reset_peak_memory_stats()
        fi_kernel.reset_launch_counts()
        res = loop.run_training(cfg, run, iter(MarkovLM(
            cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)), state=state,
            mesh=on)
        return (res, fi_kernel.launch_counts[fi_kernel.K4],
                torch.cuda.max_memory_allocated() / 2 ** 30)
    base, k4_base, peak_base = train(None)
    want = _k4_launches_expected(base.state.params,
                                 loop.make_fault_schedule(run).rates)
    hist = base.history
    params = {p: w.cpu() for p, w in base.state.params.items()}
    del base
    torch.cuda.empty_cache()
    res, k4, peak = train(mesh)
    for h, g in zip(hist, res.history):
        diff = {k: (h[k], g[k]) for k in h if k != "step_time"
                and h[k] != g[k]}
        _check(not diff, f"phase 16: mesh step {h['step']} metrics {diff}")
    same = all(torch.equal(w, res.state.params[p].cpu())
               for p, w in params.items())
    _check(same, "phase 16: the 1x1 mesh's parameters differ from the "
           "unmeshed run's")
    _check(k4 == k4_base == 2 * want and want == (ref or {}).get(
        "k4_a_step", want), f"phase 16: K4 launched {k4} times on the "
           f"mesh, {k4_base} without, expected {want} a step (phase 14: "
           f"{(ref or {}).get('k4_a_step')})")
    chunk, rows, k4_fig = _k4_chunk_figures(res.state.params, fi_kernel)
    ms = [h["step_time"] * 1e3 for h in res.history]
    base_ms = [h["step_time"] * 1e3 for h in hist]
    del res
    torch.cuda.empty_cache()
    print(f"phase 16: (b) run_training on a 1x1 NCCL mesh, full-width "
          f"olmo-1b {TRAIN_BATCH} x {TRAIN_SEQ}, 2 aligned steps under the "
          f"schedule at BER {CODESIGN_BER:g}: losses "
          + ", ".join(f"{h['loss']:.6f}" for h in hist)
          + f", metrics and every parameter bitwise the unmeshed run's; K4 "
          f"{want} launches a step; steps "
          + ", ".join(f"{x:.1f}" for x in ms) + " ms (unmeshed "
          + ", ".join(f"{x:.1f}" for x in base_ms) + f" ms, host clock, "
          f"synchronized); peak {peak:.2f} GiB (unmeshed {peak_base:.2f}); "
          f"K4 at the {chunk[0]} chunk [{rows}, {chunk[1].shape[-1]}]: "
          f"{k4_fig['ms']:.4f} ms, bound {k4_fig['bound_ms']:.4f} ms on "
          f"{card}")
    return {"launches": k4, "launches_a_step": want, "step_ms": ms,
            "peak_gib": peak, **k4_fig}


def _mesh_codesign(dev, fi_kernel, mesh, ref, card: str) -> dict:
    """(c) the Finetuner on the 1x1 mesh and PolicySearch.select through a
    one-rank trial mesh, each equal to its one-device run (phase 14's, or
    run here first when ``ref`` is None): losses and parameters bitwise,
    the same choice, accuracies and trace, the same K3 launches."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import sweep
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.launch import mesh as mesh_lib
    cfg = get_config("olmo-1b")
    data = MarkovLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)

    def finetune(on):
        _, res, k4, wall, peak = _finetune_full(dev, fi_kernel, mesh=on)
        losses = [h["loss"] for h in res.info["reshape"]["history"]
                  + res.history]
        return res.state.params, losses, k4, wall

    def select(params, engine):
        sel, search, _, k3, secs, _, _ = _select_full(
            cfg, params, data, dev, fi_kernel, engine)
        return _select_result(sel, search), k3, secs
    if ref is None:
        params, losses, _, _ = finetune(None)
        chosen, k3, _ = select(params, None)
        ref = {"losses": losses, "params": {p: w.cpu() for p, w in
                                            params.items()},
               "select": chosen, "k3": k3}
        del params
    params, losses, k4, wall = finetune(mesh)
    _check(losses == ref["losses"], f"phase 16: Finetuner on the mesh: "
           f"losses {losses} != {ref['losses']}")
    _check(all(torch.equal(w, params[p].cpu()) for p, w in
               ref["params"].items()),
           "phase 16: Finetuner on the mesh: parameters differ")
    trial = mesh_lib.make_trial_mesh(1, "cuda")
    engine = sweep.SweepEngine(sweep.SweepPlan(bers=(SEARCH_BER,),
                                               n_trials=2), device=dev,
                               mesh=trial)
    chosen, k3, secs = select(params, engine)
    _check(chosen == ref["select"], f"phase 16: select on the trial mesh "
           f"{chosen[:4]} != {ref['select'][:4]}")
    _check(k3 == ref["k3"], f"phase 16: select on the trial mesh launched "
           f"K3 {k3} times, one device {ref['k3']}")
    man, k3_fig = _k3_embed_figures(params)
    del params
    torch.cuda.empty_cache()
    print(f"phase 16: (c) Finetuner on the 1x1 mesh: losses "
          + ", ".join(f"{x:.6f}" for x in losses) + f" and every parameter"
          f" bitwise the one-device run's, K4 {k4} launches, {wall:.1f} s "
          f"of wall; PolicySearch.select on a one-rank trial mesh: "
          f"{chosen[0]} at accuracy {chosen[1]:.4f}, the one-device choice,"
          f" trace and K3 launches ({k3}), {secs:.1f} s; K3 at the embed's "
          f"mantissa plane {tuple(man.shape)}, T = 2: {k3_fig['ms']:.4f} "
          f"ms, bound {k3_fig['bound_ms']:.4f} ms on {card}")
    return {"finetune_k4": k4, "launches": k3, **k3_fig}


def phase_mesh_train(dev, fi_kernel, card: str, ref=None) -> dict:
    """Phase 16: the MoE all-to-all (a), data-parallel training on a 1x1
    mesh (b) and the co-design loop on one-rank meshes (c). ``ref`` is
    phase 14's one-device Finetuner and select. Returns K3's and K4's
    figures on this path by kernel (the kernels line carries them under
    ``"mesh_train"``) and the all-to-all's."""
    import torch
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    parts = {}
    out = {"a2a": _a2a_layer(dev, card)}
    parts["a"] = time.perf_counter() - t0
    mesh = mesh_lib.make_host_mesh(1, "cuda")
    try:
        t1 = time.perf_counter()
        out["fault_inject"] = _mesh_train(dev, fi_kernel, mesh, ref, card)
        parts["b"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["fault_inject_batched"] = _mesh_codesign(dev, fi_kernel, mesh,
                                                     ref, card)
        out["fault_inject"]["finetune_launches"] = \
            out["fault_inject_batched"].pop("finetune_k4")
        parts["c"] = time.perf_counter() - t1
    finally:
        mesh_lib.destroy_world()
    torch.cuda.empty_cache()
    print(f"phase 16: {time.perf_counter() - t0:.1f} s (" + ", ".join(
        f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    return out


ZERO3_LEAF = (40, 4096, 12800)        # granite-3-8b's stacked w_gate [L, D, F]
ZERO3_SPLITS = ((4, 1), (2, 2))
ZERO3_RANKS = 4                       # (b)'s emulated "data" ranks
F64_RATIO = 2.0     # (b): the emulated gradient's float64 error against one
                    # device's, leaf by leaf


def _k4_offsets(dev, fi_kernel, card: str) -> dict:
    """(a) K4 at shard offsets on a plane of granite-3-8b's stacked MLP
    shape: every block of the leaf's spec at 4x1 and 2x2 drawn at its
    offsets in one launch, bitwise its region of the one-device draw (16
    counter chunks; every block, every chunk); one 4x1 block's draw timed
    against its bound and its plain version in uint16
    (``fault.draw_block_bits``) and in float32 in place
    (``fault.inject_block``, the schedule's call), each beside the run-by-run
    route it replaces (a launch a run of rows in one chunk, each result
    copied into the block; in float32 each run through ``to_bits`` and
    ``fp16_bits_to_f32`` around it)."""
    import torch
    from repro_torch.core import bitops, fault
    from repro_torch.core.cim import fold_seed
    from repro_torch.distributed import sharding as shlib
    from repro_torch.kernels.fault_inject import ops as fi_ops
    from repro_torch.kernels.fault_inject import ref as fi_ref
    from repro_torch.launch import specs
    shape, path = ZERO3_LEAF, "groups/blk0/mlp/w_gate"
    positions, seed, ber = tuple(range(10)), 0x5EED, CODESIGN_BER
    gen = torch.Generator(device=dev).manual_seed(17)
    plane = torch.randint(-2 ** 15, 2 ** 15, shape, generator=gen,
                          dtype=torch.int16, device=dev).view(torch.uint16)
    flat = plane.view(-1, shape[-1])
    n_chunks = len(fault.counter_chunks(*flat.shape))
    fi_kernel.reset_launch_counts()
    whole = fault.draw_bits(flat, seed, ber, positions).view(shape)
    _check(fi_kernel.launch_counts[fi_kernel.K4] == 1, "phase 17: the "
           f"{n_chunks}-chunk leaf took "
           f"{fi_kernel.launch_counts[fi_kernel.K4]} K4 launches")
    meta = torch.empty(shape, device="meta")
    blocks, chunks, timed = 0, set(), None
    for dims in ZERO3_SPLITS:
        for rank in shlib.ranks_of(("data", "model"), dims):
            lay = shlib.layout_of(specs.leaf_spec(rank, path, meta), shape,
                                  rank)
            _check(not lay.whole, f"phase 17: {lay} is not a block")
            blk = lay.cut(plane).contiguous().view(-1, lay.block[-1])
            fi_kernel.reset_launch_counts()
            got = fault.draw_block_bits(blk, lay, seed, ber, positions)
            _check(fi_kernel.launch_counts[fi_kernel.K4] == 1,
                   f"phase 17: the {dims} block at {lay.offsets} took "
                   f"{fi_kernel.launch_counts[fi_kernel.K4]} K4 launches")
            want = lay.cut(whole).contiguous().view(-1, lay.block[-1])
            _check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                   f"phase 17: K4 at the offsets of {dims} block "
                   f"{lay.offsets} differs from the one-device draw")
            runs = fault.block_runs(lay)
            chunks |= {k for _, _, k, _ in runs}
            blocks += 1
            if timed is None and dims == (4, 1) and lay.offsets[1]:
                timed = (blk, lay, runs)
            del got, want
            if timed is None or timed[0] is not blk:
                del blk
    _check(chunks == set(range(n_chunks)), f"phase 17: the blocks drew "
           f"chunks {sorted(chunks)} of {n_chunks}")
    del plane, whole
    blk, lay, runs = timed
    col_off, width = lay.offsets[-1], lay.shape[-1]

    def by_run(x, f32):
        """The run-by-run route: a launch a run, written into the block."""
        out = torch.empty_like(x)
        dst = out if f32 else out.view(torch.int16)
        for r0, r1, k, row_off in runs:
            bits = fi_ops.fault_inject_bits(
                bitops.to_bits(x[r0:r1]) if f32 else x[r0:r1],
                seed=fold_seed(seed, k), ber=ber, positions=positions,
                at=(row_off, col_off, width))
            dst[r0:r1] = bitops.fp16_bits_to_f32(bits) if f32 \
                else bits.view(torch.int16)
        return out

    def plain(x):
        return fi_ref.fault_inject_runs_ref(
            x, fault.layout_runs(lay), seed=seed, ber=ber,
            positions=positions, col_off=col_off, width=width)
    fig = _fi_figures("K4 at offsets", lambda: fault.draw_block_bits(
        blk, lay, seed, ber, positions), lambda: plain(blk), blk.numel(), 1,
        len(positions))
    fig["by_run_ms"] = _time_ms(lambda: by_run(blk, False), reps=3, inner=3)
    # float32: fp16-grid weights, the mantissa drawn in place (the
    # schedule's call on a block)
    n = blk.numel()
    w = (torch.randn(blk.shape, generator=gen, device=dev) * 0.02).half() \
        .float()
    del blk
    torch.cuda.empty_cache()
    y = w.clone()
    fi_kernel.reset_launch_counts()
    got = fault.inject_block(seed, y, lay, ber, "mantissa", in_place=True)
    _check(got.data_ptr() == y.data_ptr() and
           fi_kernel.launch_counts[fi_kernel.K4] == 1 and
           torch.equal(y.view(torch.int32), plain(w).view(torch.int32)),
           "phase 17: the float32 block drawn in place differs from its "
           "plain version (or took more than one launch)")
    _check(torch.equal(by_run(w, True).view(torch.int32),
                       y.view(torch.int32)),
           "phase 17: the float32 block's run-by-run route differs")
    del y, got
    bytes_ms = n * 8 / HBM_BYTES_PER_S * 1e3
    ops_ms = n * len(positions) * ALU_OPS_PER_DRAW / INT32_OPS * 1e3
    f32 = {"ms": _time_ms(lambda: fault.inject_block(
               seed, w, lay, ber, "mantissa", in_place=True), reps=3,
               inner=3),
           "by_run_ms": _time_ms(lambda: by_run(w, True), reps=3, inner=3),
           "plain_ms": _time_ms(lambda: plain(w), reps=3, inner=1),
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "bytes": n * 8, "hashes": n * len(positions)}
    print(f"phase 17: (a) K4 at shard offsets: {blocks} blocks of a "
          f"{list(shape)} plane (granite-3-8b's w_gate) at 4x1 and 2x2, "
          f"{n_chunks} counter chunks, each block one launch and bitwise "
          f"its region of the one-device draw; one 4x1 block "
          f"{list(lay.block)} at offset {lay.offsets[1]} ({len(runs)} runs "
          f"in one table), {fig['hashes'] / 1e9:.3f} G draws: uint16 "
          f"{fig['ms']:.4f} ms (run by run {fig['by_run_ms']:.4f} ms, "
          f"{len(runs)} launches), plain {fig['plain_ms']:.2f} ms, bound "
          f"{fig['bound_ms']:.4f} ms ({fig['bound_by']}); float32 in place "
          f"{f32['ms']:.4f} ms (run by run with the int64 round trip "
          f"{f32['by_run_ms']:.4f} ms), plain {f32['plain_ms']:.2f} ms, "
          f"bound {f32['bound_ms']:.4f} ms ({f32['bound_by']}) on {card}")
    del w
    torch.cuda.empty_cache()
    return {"shape": list(shape), "blocks": blocks, "chunks": n_chunks,
            "block": list(lay.block), "block_launches": 1,
            "block_runs": len(runs), **fig, "fp32": f32}


def _k4_block_launches(states, rates) -> int:
    """One K4 launch a (rank, drawn leaf, field): a block's runs of rows,
    like a whole leaf's counter chunks, are one table."""
    return sum(_k4_launches_expected(s.params, rates) for s in states)


def _held_zero3(got_metrics, want_metrics, leaves) -> dict:
    """The deviations ``tests/test_torch_train_kinds.py``'s tolerances
    bound: metrics relative (within 1e-4 holds); gradients (AdamW's first
    moment / 0.1) as their excess over allclose(1e-4, 1e-5 of the leaf's
    largest) in units of that atol (<= 1 holds); parameters in fp16 ulps
    where the gradient exceeds 1e-6 (<= 1 holds). ``leaves`` yields (path,
    param got, param want, m got, m want). -> the worst of each, where,
    and ``ok``."""
    import torch
    rel = {k: abs(float(got_metrics[k]) - float(want_metrics[k]))
           / (abs(float(want_metrics[k])) or 1.0)
           for k in ("loss", "accuracy", "grad_norm", "tokens")}
    out = {"metrics": max(rel.values()),
           "metric_values": {k: [float(got_metrics[k]),
                                 float(want_metrics[k])] for k in rel},
           "gradient_excess_over_atol": 0.0, "param_fp16_ulps": 0,
           "worst_gradient_leaf": None, "worst_param_leaf": None}
    for path, pg, pw, mg, mw in leaves:
        g, h = mg / 0.1, mw / 0.1
        scale = float(h.abs().max()) or 1.0
        excess = float((((g - h).abs() - LOSS_RTOL * h.abs())
                        / (1e-5 * scale)).max())
        if excess > out["gradient_excess_over_atol"]:
            out.update(gradient_excess_over_atol=excess,
                       worst_gradient_leaf=path)
        ulps = (pg.to(torch.float16).view(torch.int16).to(torch.int32)
                - pw.to(torch.float16).view(torch.int16).to(torch.int32)
                ).abs()[h.abs() > GRAD_FLOOR]
        u = int(ulps.max()) if ulps.numel() else 0
        if u > out["param_fp16_ulps"]:
            out.update(param_fp16_ulps=u, worst_param_leaf=path)
    out["ok"] = out["metrics"] <= LOSS_RTOL and \
        out["gradient_excess_over_atol"] <= 1 and out["param_fp16_ulps"] <= 1
    return out


def _f64_clipped_gradient(cfg, params: dict, batch, dev) -> dict:
    """The clipped gradient of the global batch's loss in float64 (weights,
    activations and the loss; the norms and rotary angles compute in
    float32 inside, as they do in every step): the reference the fp32
    steps' gradients are measured against."""
    import dataclasses
    import torch
    from repro_torch.models import lm
    from repro_torch.models.losses import IGNORE
    c64 = dataclasses.replace(cfg, compute_dtype="float64",
                              param_dtype="float64")
    leaves = {p: w.to(dev, torch.float64).requires_grad_(True)
              for p, w in params.items()}
    with torch.enable_grad():
        logits, _ = lm.forward_blocks(lm.shell(c64), leaves, batch,
                                      remat=True)
        labels = batch["labels"]
        mask = labels != IGNORE
        safe = torch.where(mask, labels, torch.zeros_like(labels))
        m = logits.amax(-1)
        lse = m + torch.log(torch.exp(logits - m[..., None]).sum(-1))
        nll = ((lse - torch.gather(logits, -1, safe[..., None])[..., 0])
               * mask).sum() / mask.sum().clamp(min=1)
        grads = torch.autograd.grad(nll, list(leaves.values()))
    norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
    scale = torch.clamp(1.0 / torch.clamp(norm, min=1e-12), max=1.0)
    return {p: g * scale for p, g in zip(leaves, grads)}


def _f64_error(g64, first) -> float:
    """max |m / 0.1 - g64| / max |g64| of one leaf's first moment after one
    step (0.1 of the clipped gradient)."""
    import torch
    scale = float(g64.abs().max()) or 1.0
    return float((first.to(g64.device, torch.float64) / 0.1 - g64).abs()
                 .max()) / scale


def _row_witness(cfg, run, params: dict, batch, dev, ranks: int) -> dict:
    """The forward of the whole batch on one device against ``ranks``
    forwards of its rows split as the emulated ranks hold them, on the same
    weights (cast and differentiable as in the step): the largest
    difference of a row's logits over the logits' largest, and the loss of
    the batch from each (the NLL sums added in rank order, as the step's
    sum over the batch axes)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models.losses import lm_loss_sums
    model, cdt = lm.shell(cfg), cfg.cdtype()
    leaves = {p: w.to(dev).requires_grad_(w.is_floating_point())
              for p, w in params.items()}
    leaves = {p: w.to(cdt) if w.ndim >= 2 and w.is_floating_point() else w
              for p, w in leaves.items()}

    def forward(rows):
        part = {k: v[rows] for k, v in batch.items()}
        with torch.enable_grad():
            logits, _ = lm.forward_blocks(model, leaves, part,
                                          remat=run.remat)
        logits = logits.detach()
        nll, _, tokens = lm_loss_sums(logits, part["labels"])
        return logits, nll, tokens
    whole, nll, tokens = forward(slice(None))
    per = whole.shape[0] // ranks
    diff, nll_split = 0.0, None
    for r in range(ranks):
        logits, part, _ = forward(slice(r * per, (r + 1) * per))
        diff = max(diff, float((logits - whole[r * per:(r + 1) * per])
                               .abs().max()))
        nll_split = part if nll_split is None else nll_split + part
        del logits
    scale = float(whole.abs().max())
    denom = tokens.clamp(min=1)
    return {"logits_max_abs": scale, "row_split_max_abs_diff": diff,
            "row_split_rel_diff": diff / (scale or 1.0),
            "loss_whole": float(nll / denom),
            "loss_split": float(nll_split / denom)}


def _zero3_run(dev, fi_kernel, ber: float, n_steps: int,
               first: bool) -> dict:
    """Full-width olmo-1b at TRAIN_BATCH x TRAIN_SEQ, ``n_steps`` aligned
    steps (under the Fig. 7 schedule at ``ber`` when it is nonzero) on one
    device, then the same steps with the state sharded over ZERO3_RANKS
    emulated "data" ranks (``zero3.emulate_step``: the program's step, a
    thread a rank, with in-process collectives). The ranks' init blocks and
    step 0's faulty blocks are held bitwise to the one-device state's and
    flips' regions; each step's gathered state is measured against the
    one-device step's (:func:`_held_zero3`); step 0's weights go through
    :func:`_row_witness`. With ``first``, also one step with remat on and
    off, held bitwise on one device."""
    import dataclasses
    import torch
    from repro_torch.configs import RunConfig, get_config
    from repro_torch.core.deployment import ReliabilityPolicy
    from repro_torch.data.synthetic import MarkovLM
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import specs
    from repro_torch.training import loop, steps, zero3
    cfg = get_config("olmo-1b")
    run = RunConfig(steps=n_steps, checkpoint_dir="", learning_rate=1e-3,
                    warmup_steps=0, policy=ReliabilityPolicy(), ber=ber,
                    inject="dynamic")
    corrupt = loop.make_fault_schedule(run)
    data = MarkovLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    batches = [loop._on_device(data.batch(i), dev) for i in range(n_steps)]

    def host(tree):
        return {p: None if t is None else t.cpu() for p, t in tree.items()}
    whole = steps.init_train_state(torch.Generator(device=dev).manual_seed(0),
                                   cfg, run, device=dev)
    init = {f: host(getattr(whole, f)) for f in ("params", "exps", "signs")}
    if first:
        outs = []
        for remat in (True, False):
            r = dataclasses.replace(run, remat=remat)
            new, met = steps.make_train_step(cfg, r)(whole, batches[0])
            outs.append((new.params, met))
            del new
        (pa, ma), (pb, mb) = outs
        _check(all(torch.equal(ma[k], mb[k]) for k in ma) and all(
            torch.equal(pa[p].view(torch.int32), pb[p].view(torch.int32))
            for p in pa), "phase 17: remat on and off differ on one device")
        del outs, pa, pb
        torch.cuda.empty_cache()
    step = steps.make_train_step(cfg, run)
    snaps, one_ms, faulty0 = [], [], None
    for i, batch in enumerate(batches):
        if corrupt is not None:
            whole = dataclasses.replace(whole, params=corrupt(
                whole.params, loop.step_seed(run, i)))
            if i == 0:
                faulty0 = host(whole.params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        whole, met = step(whole, batch)
        torch.cuda.synchronize()
        one_ms.append((time.perf_counter() - t0) * 1e3)
        snaps.append((met, host(whole.params), host(whole.opt["m"])))
    del whole
    torch.cuda.empty_cache()
    # step 0's gradient in float64, from the weights it saw
    w0 = init["params"] if faulty0 is None else faulty0
    witness = _row_witness(cfg, run, w0, batches[0], dev, ZERO3_RANKS)
    g64 = _f64_clipped_gradient(cfg, w0, batches[0], dev)
    del w0
    f64 = {"one_device": {p: _f64_error(g, snaps[0][2][p])
                          for p, g in g64.items()}}
    torch.cuda.empty_cache()
    meshes = shlib.thread_ranks(("data", "model"), (ZERO3_RANKS, 1))
    states = [steps.init_train_state(
        torch.Generator(device=dev).manual_seed(0), cfg, run, device=dev,
        mesh=m) for m in meshes]
    for s in states:
        for f, tree in init.items():
            lay = getattr(s.shards, f)
            for p, t in getattr(s, f).items():
                _check((t is None) == (tree[p] is None) and (
                    t is None or torch.equal(t, lay[p].cut(tree[p]).to(dev))),
                       f"phase 17: the init block of {f} {p} differs from "
                       f"the one-device init's")
    del init
    fi_kernel.reset_launch_counts()
    want_k4 = 0 if corrupt is None else \
        n_steps * _k4_block_launches(states, corrupt.rates)
    emu_ms, held, gathered = [], [], 0
    torch.cuda.reset_peak_memory_stats()
    for i, batch in enumerate(batches):
        if corrupt is not None:
            states = [dataclasses.replace(s, params=corrupt(
                s.params, loop.step_seed(run, i), s.shards.params))
                for s in states]
        if faulty0 is not None:
            for s in states:
                for p, t in s.params.items():
                    _check(torch.equal(t.view(torch.int32), s.shards
                                       .params[p].cut(faulty0[p]).to(dev)
                                       .contiguous().view(torch.int32)),
                           f"phase 17: the faulty block of {p} at "
                           f"{s.shards.params[p].offsets} differs from the "
                           f"one-device flips")
            faulty0 = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        states, met = zero3.emulate_step(cfg, run, states, meshes, batch)
        torch.cuda.synchronize()
        emu_ms.append((time.perf_counter() - t0) * 1e3)
        gathered = float(met["gathered_bytes"])
        if i == 0:
            witness["loss_emulated"] = float(met["loss"])
        want_met, want_p, want_m = snaps[i]

        def leaves():
            for p in want_p:
                lays = [s.shards.params[p] for s in states]
                yield (p, specs.assemble([s.params[p] for s in states],
                                         lays), want_p[p].to(dev),
                       specs.assemble([s.opt["m"][p] for s in states], lays),
                       want_m[p].to(dev))
        held.append(_held_zero3(met, want_met, leaves()))
        if g64 is not None and i == 0:
            f64["emulated"] = {p: _f64_error(g, specs.assemble(
                [s.opt["m"][p] for s in states],
                [s.shards.params[p] for s in states]))
                for p, g in g64.items()}
            del g64
            g64 = None
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    k4 = fi_kernel.launch_counts[fi_kernel.K4]
    _check(k4 == want_k4, f"phase 17: K4 launched {k4} times on the "
           f"emulated ranks' blocks, expected {want_k4}")
    del states
    torch.cuda.empty_cache()
    witness["loss_one_device"] = float(snaps[0][0]["loss"])
    return {"ber": ber, "launches": k4, "step_ms": emu_ms,
            "one_device_step_ms": one_ms, "gathered_bytes": gathered,
            "losses": [float(s[0]["loss"]) for s in snaps], "held": held,
            "f64": f64, "peak_gib": peak, "witness": witness}


def _zero3_step(dev, fi_kernel, card: str) -> dict:
    """(b) the ZeRO-3 step with ZERO3_RANKS "data" ranks emulated in this
    process on full-width olmo-1b at TRAIN_BATCH x TRAIN_SEQ
    (:func:`_zero3_run`): one clean aligned step, its metrics and
    parameters held to the one-device step at ``tests/
    test_torch_train_kinds.py``'s tolerances and its gradient, leaf by
    leaf, to within F64_RATIO times the one-device gradient's distance
    from the float64 gradient (at full width the two fp32 gradients, each
    summed in its own order over 1024 tokens, differ by more than that
    file's atol: PERF.md §6), remat on and off bitwise; then 2
    aligned steps under the Fig. 7 schedule at CODESIGN_BER, the faulty
    blocks bitwise, K4's launches counted, the deviations from the
    one-device steps and both gradients' distance from float64 reported
    (the random model under the schedule trains at losses in the
    thousands: no tolerance of a well-conditioned step applies). In both,
    step 0's loss must equal that of the forward of its rows on one device
    at the same split: the one-device step's the 8-row forward's, the
    emulated step's the four 2-row forwards' (:func:`_row_witness`, whose
    logits' difference shows what the row count alone changes). -> the
    emulated path's K4 figures."""
    clean = _zero3_run(dev, fi_kernel, 0.0, 1, True)
    sched = _zero3_run(dev, fi_kernel, CODESIGN_BER, 2, False)
    h, f64 = clean["held"][0], clean.pop("f64")
    # as close to the float64 gradient as the one-device step, leaf by
    # leaf (or within the tolerance's atol, 1e-5 of the leaf's largest)
    ratio = {p: f64["emulated"][p] / max(e, 1e-12)
             for p, e in f64["one_device"].items()}
    worst = max(ratio, key=ratio.get)
    far = [p for p, e in f64["emulated"].items()
           if e > max(F64_RATIO * f64["one_device"][p], 1e-5)]
    clean["f64"] = {"worst_leaf": worst, "emulated": f64["emulated"][worst],
                    "one_device": f64["one_device"][worst],
                    "max_emulated": max(f64["emulated"].values()),
                    "max_one_device": max(f64["one_device"].values())}
    sf = sched["f64"]
    sched["f64"] = {"max_emulated": max(sf["emulated"].values()),
                    "max_one_device": max(sf["one_device"].values())}
    _check(not far and h["metrics"] <= LOSS_RTOL and
           h["param_fp16_ulps"] <= 1, f"phase 17: the clean sharded step "
           f"against one device: {h}; against float64 {clean['f64']}, "
           f"leaves beyond {F64_RATIO}x the one-device error: {far}")
    print(f"phase 17: (b) the ZeRO-3 step, {ZERO3_RANKS} data ranks "
          f"emulated in one process, full-width olmo-1b {TRAIN_BATCH} x "
          f"{TRAIN_SEQ}: init blocks bitwise the one-device init's; remat on"
          f" and off bitwise on one device; a clean aligned step: metrics "
          f"and parameters within the tolerances of one device, its "
          f"gradients beside one device's {h} and against float64 "
          f"{clean['f64']}, "
          f"{clean['step_ms'][0]:.1f} ms emulated against "
          f"{clean['one_device_step_ms'][0]:.1f} ms on one device (host "
          f"clock, synchronized); 2 aligned steps under the schedule at BER "
          f"{CODESIGN_BER:g}: step 0's faulty blocks bitwise the one-device "
          f"flips, K4 {sched['launches']} launches at the blocks' offsets, "
          f"losses " + ", ".join(f"{x:.6f}" for x in sched["losses"])
          + f" one device, deviations {sched['held']}, step 0's "
          f"gradients against float64 {sched['f64']} (the random model "
          f"under the schedule is ill-conditioned); emulated steps "
          + ", ".join(f"{x:.1f}" for x in sched["step_ms"]) + " ms (one "
          "device " + ", ".join(f"{x:.1f}" for x in
                                sched["one_device_step_ms"])
          + f" ms); {sched['gathered_bytes'] / 1e9:.3f} GB gathered by a "
          f"rank's forward a step; peak {sched['peak_gib']:.2f} GiB on "
          f"{card}")
    for tag, r in (("clean", clean), ("schedule", sched)):
        w = r["witness"]
        print(f"phase 17: (b) row-split witness, {tag} step 0 on one device:"
              f" the 8-row forward's logits against four 2-row forwards' "
              f"differ by {w['row_split_max_abs_diff']:.6g} (of "
              f"{w['logits_max_abs']:.6g}, {w['row_split_rel_diff']:.3g}); "
              f"loss {w['loss_whole']!r} from 8 rows (the one-device step's "
              f"{w['loss_one_device']!r}), {w['loss_split']!r} from the "
              f"2-row forwards (the emulated step's {w['loss_emulated']!r})")
        _check(w["loss_whole"] == w["loss_one_device"] and
               w["loss_split"] == w["loss_emulated"],
               f"phase 17: the {tag} step 0's loss differs from the forward "
               f"of its rows at the same split: {w}")
    return {"launches": sched["launches"], "clean": clean,
            "schedule": sched}


def phase_zero3(dev, fi_kernel, card: str) -> dict:
    """Phase 17: K4 at shard offsets (a) and the ZeRO-3 step with its data
    ranks emulated on the one card (b). Returns K4's figures on this path
    (the kernels line carries them under ``"zero3"``)."""
    import torch
    t0 = time.perf_counter()
    fig = _k4_offsets(dev, fi_kernel, card)
    t1 = time.perf_counter()
    step = _zero3_step(dev, fi_kernel, card)
    torch.cuda.empty_cache()
    print(f"phase 17: {time.perf_counter() - t0:.1f} s (a {t1 - t0:.1f} s, "
          f"b {time.perf_counter() - t1:.1f} s)")
    return {"fault_inject": {**fig, "launches": step.pop("launches"),
                             "max_abs_err": 0.0, "library_ms": None,
                             "step": step}}


# phase 18: K3 at column-shard offsets, the 2-D sweep, the engine and the
# fleet on meshes emulated on the one card
SHARDS18 = 4                                   # 12576-column shards
SPECS18 = ("iid", "drift:drift_rate=0.02,tick=3") + MODEL_SPECS
LOAD18 = dict(n_requests=4, prompt_lens=(8, 32), gen_lens=(3, 6), seed=0)


def _on_ranks(meshes, fn) -> list:
    """``fn(mesh)`` on every rank of an emulated mesh, a thread a rank under
    inference mode and its own ambient settings -> results in rank order
    (the first failure re-raised, the others' waits broken)."""
    import threading
    import torch
    from repro_torch.distributed import sharding as shlib
    out = [None] * len(meshes)

    def go(r):
        try:
            with torch.inference_mode(), shlib.rank_thread():
                out[r] = fn(meshes[r])
        except BaseException as e:       # re-raised below
            out[r] = e
            for m in meshes:
                m.group.abort()
    threads = [threading.Thread(target=go, args=(r,))
               for r in range(len(meshes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    errors = [o for o in out if isinstance(o, BaseException)]
    if errors:
        first = [e for e in errors
                 if not isinstance(e, threading.BrokenBarrierError)]
        raise (first or errors)[0]
    return out


def _k3_shards(dev, checks: dict, fi_kernel, card: str) -> dict:
    """(a) K3 at column-shard offsets on the full-width unembed's planes
    (phase 4's: one4n man and flattened codewords, none exp and sign), 4
    column shards, T = 4, BER 1e-3, each process of SPECS18: every shard's
    copies bitwise its plain version at the same offsets and the block of
    the unsharded copies; each shard timed beside the unsharded plane."""
    import numpy as np
    import torch
    from repro_torch.kernels.fault_inject import ops
    one4n = checks["cim_read_matmul_one4n"]["store"]
    cw = one4n.codewords
    col_div = {"one4n codewords": cw.shape[2] * cw.shape[3]}
    seeds = np.asarray([1, 2, 3, 4], np.uint32)
    thr = ops.ber_to_threshold(1e-3)
    n_checked = 0
    for name, (plane, pos) in _fi_planes(checks).items():
        cd = col_div.get(name, 1)
        c = plane.shape[1]
        w = c // SHARDS18
        _check(w * SHARDS18 == c, f"phase 18: {name} of {c} columns")
        for spec in SPECS18:
            whole = ops.fault_inject_bits_batched(
                plane, seeds, thr, positions=pos, model=spec, col_div=cd)
            for i in range(SHARDS18):
                blk = plane[:, i * w:(i + 1) * w].contiguous()
                before = fi_kernel.launch_counts[fi_kernel.K3]
                got = ops.fault_inject_bits_batched(
                    blk, seeds, thr, positions=pos, model=spec, col_div=cd,
                    at=(i * w, c))
                _check(fi_kernel.launch_counts[fi_kernel.K3] == before + 1,
                       f"phase 18: {name} {spec} shard {i}: not one launch")
                _check(_same_plane(got, whole[:, :, i * w:(i + 1) * w]),
                       f"phase 18: {name} {spec} shard {i} != the block of "
                       f"the unsharded copies")
                plain = _plain_k3(blk, seeds, thr, pos, spec, cd,
                                  at=(i * w, c))
                _check(_same_plane(got, plain), f"phase 18: {name} {spec} "
                       f"shard {i} != its plain version")
                n_checked += 1
            del whole
    torch.cuda.empty_cache()
    # times on the mantissa plane, i.i.d. and under each process
    man = one4n.man
    w = man.shape[1] // SHARDS18
    blocks = [man[:, i * w:(i + 1) * w].contiguous() for i in range(SHARDS18)]
    pos = range(10)
    fig = {"by_process": {}}
    for spec in SPECS18:
        full_ms = _time_ms(lambda: ops.fault_inject_bits_batched(
            man, seeds, thr, positions=pos, model=spec))
        shard_ms = [_time_ms(lambda b=b, i=i: ops.fault_inject_bits_batched(
            b, seeds, thr, positions=pos, model=spec, at=(i * w, J)))
            for i, b in enumerate(blocks)]
        draws = [_draws_at(b, i * w, seeds, thr, spec) for i, b in
                 enumerate(blocks)]
        bound = [d * ALU_OPS_PER_DRAW / INT32_OPS * 1e3 for d in draws]
        fig["by_process"][spec] = {"unsharded_ms": full_ms,
                                   "shard_ms": shard_ms, "draws": draws,
                                   "bound_ms": bound}
        print(f"phase 18: K3 at offsets, {spec}: shards "
              + ", ".join(f"{m:.4f}" for m in shard_ms)
              + f" ms (bounds " + ", ".join(f"{b:.4f}" for b in bound)
              + f" ms) beside {full_ms:.4f} ms unsharded, [{K}, {w}] of "
              f"[{K}, {J}] uint16, T=4, on {card}")
    iid = fig["by_process"]["iid"]
    plain_ms = _time_ms(lambda: _plain_k3(blocks[1], seeds, thr, pos, "iid",
                                          at=(w, J)), reps=3, inner=1)
    i = int(np.argmax(iid["shard_ms"]))
    fig.update(ms=float(np.mean(iid["shard_ms"])), plain_ms=plain_ms,
               bound_ms=float(np.mean(iid["bound_ms"])),
               slowest_shard_ms=iid["shard_ms"][i], checked=n_checked)
    print(f"phase 18: K3 at column offsets: {n_checked} shard draws bitwise "
          f"their plain version and their block of the unsharded copies "
          f"(4 planes x {len(SPECS18)} processes x {SHARDS18} shards); plain "
          f"shard {plain_ms:.2f} ms")
    return fig


def _draws_at(block, col_off: int, seeds, thr, spec) -> int:
    """The draws K3 performs on a mantissa-plane shard: every element's 10
    positions a trial, or (burst) only its live units' elements."""
    import torch
    from repro_torch.core import faultmodels as fm
    model = fm.parse_fault_model(spec)
    n_pos, t = 10, len(seeds)
    if model is None or model.kind != "burst":
        return block.numel() * t * n_pos
    thr_c = fm.compiled_threshold(model, thr)
    m_thr, m_len = fm.model_scalars(model)
    r, c = block.shape
    from repro_torch.core.cim import global_elem
    elem = global_elem((r, c), (r, J), 1, col_off, block.device)
    live = 0
    for s in seeds:
        got = fm.scale_elem_thresholds(elem, thr_c, int(s), kind="burst",
                                       axis=model.axis, m_thr=m_thr,
                                       m_len=m_len, width=J)
        live += int((got != 0).sum())
        del got
    del elem
    torch.cuda.empty_cache()
    return live * n_pos


def _sweep_mesh18(dev, model, fi_kernel) -> dict:
    """(b) Fig. 6's one4n arm at BER 1e-3 (phase 5's seeds, 4 trials) on a
    1x4 (trial, model) mesh emulated on the card: its cells equal the
    unmeshed arm's; K3 launches one a store plane a rank."""
    import torch
    from repro_torch.core import sweep as sweep_lib
    from repro_torch.distributed import sharding as shlib
    params, agreement, cim_cfg, seeds = _fig6_setup(dev, model)
    a, b = FIG6_PROTECTS.index("one4n"), FIG6_BERS.index(1e-3)
    seeds = seeds[a:a + 1, b:b + 1]
    plan = sweep_lib.SweepPlan(bers=(1e-3,), n_trials=FIG6_TRIALS,
                               protects=("one4n",))

    def cells(rows):
        return [(r.accuracies, r.trial_corrected, r.trial_uncorrectable)
                for r in rows]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        want = sweep_lib.SweepEngine(plan, device=dev).run_protection(
            seeds, params, agreement, cim_cfg)
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    meshes = shlib.thread_ranks(("trial", "model"), (1, SHARDS18))
    fi_kernel.reset_launch_counts()
    t0 = time.perf_counter()
    got = _on_ranks(meshes, lambda m: sweep_lib.SweepEngine(
        plan, device=dev, mesh=m).run_protection(seeds, params, agreement,
                                                 cim_cfg))
    torch.cuda.synchronize()
    mesh_s = time.perf_counter() - t0
    launches = fi_kernel.launch_counts[fi_kernel.K3]
    want_launches = SHARDS18 * 2 * FIG6_PLANES["one4n"]
    _check(launches == want_launches, f"phase 18: sweep mesh: {launches} K3 "
           f"launches, expected {want_launches} (ranks x stores x planes)")
    for r, rows in enumerate(got):
        _check(cells(rows) == cells(want), f"phase 18: sweep mesh rank {r}: "
               f"cells {cells(rows)} != the unmeshed arm's {cells(want)}")
    _check(want[0].corrected > 0, "phase 18: the one4n arm corrected nothing")
    print(f"phase 18: Fig. 6 one4n arm at 1e-3 on a 1x{SHARDS18} (trial, "
          f"model) mesh emulated: every rank's cells == the unmeshed arm's "
          f"(agreement {want[0].mean:.4f}, corrected {want[0].corrected:.1f},"
          f" uncorrectable {want[0].uncorrectable:.1f}); {launches} K3 "
          f"launches at shard offsets; wall {mesh_s:.2f} s (unmeshed "
          f"{one_s:.2f} s)")
    return {"launches": launches, "wall_s": mesh_s, "unmeshed_s": one_s}


def _engine_dep18(model):
    """Engine arm (a)'s unplaced deployment and its serving kwargs."""
    from repro_torch.launch import serve as serve_lib
    _, path, protect, inject, _ = ENGINE_ARMS[0]
    static, dynamic = serve_lib.default_seeds(0, model.cim_leaves())
    dep = serve_lib.make_deployment(
        model.cim_leaves(), ber=ENGINE_BER, protect=protect, n_group=8,
        index=2, seeds=static, inject_mode=inject, field="full")
    kw = serve_lib.serving_kw(ber=ENGINE_BER, dynamic_seeds=dynamic,
                              inject_mode=inject, field="full")
    return dep, kw


def _engine_mesh18(model, kernel_lib, dep, kw) -> dict:
    """(c) Engine arm (a) with ECC accounting over phase 10's 4-request
    load: on one device, on a 1x1 NCCL mesh and with "model" emulated at 4:
    tokens, logits and ECC charges equal the unmeshed run's; each read one
    K1 launch a shard."""
    import torch
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import engine as engine_lib
    from repro_torch.launch import mesh as mesh_lib
    load = engine_lib.LoadGen(vocab_size=model.cfg.vocab_size, **LOAD18)
    reqs, max_len = load.requests(), load.max_len()
    name = ENGINE_ARMS[0][4]

    def run(params, mesh=None):
        eng = engine_lib.Engine(model, params, n_slots=ENGINE_SLOTS,
                                max_len=max_len, chunk=ENGINE_CHUNK,
                                collect_logits=True, mesh=mesh)
        t0 = time.perf_counter()
        with torch.inference_mode():
            res, agg = eng.run(reqs)
        torch.cuda.synchronize()
        return res, agg, time.perf_counter() - t0
    kernel_lib.reset_launch_counts()
    want, agg, one_s = run(dep.serving_params(**kw))
    reads = kernel_lib.launch_counts[name]
    out = {"unmeshed": {"s": one_s, "decode_tok_s": agg["decode_tok_s"],
                        "launches": reads}}
    mesh = mesh_lib.make_serve_mesh("1x1", "cuda")
    try:
        kernel_lib.reset_launch_counts()
        got, agg, secs = run(dep.shard(mesh).serving_params(**kw), mesh)
        n = kernel_lib.launch_counts[name]
    finally:
        mesh_lib.destroy_world()
    _check(n == reads, f"phase 18: engine 1x1: {n} K1 launches, {reads} "
           f"unmeshed")
    for r in reqs:
        _check(_same_request(got[r.rid], want[r.rid]), f"phase 18: engine "
               f"on 1x1: request {r.rid} != the unmeshed run")
    out["1x1"] = {"s": secs, "decode_tok_s": agg["decode_tok_s"],
                  "launches": n}
    meshes = shlib.thread_ranks(("data", "model"), (1, SHARDS18))
    kernel_lib.reset_launch_counts()
    t0 = time.perf_counter()
    ranks = _on_ranks(meshes, lambda m: run(dep.shard(m).serving_params(**kw),
                                            m))
    secs = time.perf_counter() - t0
    n = kernel_lib.launch_counts[name]
    _check(n == SHARDS18 * reads, f"phase 18: engine 1x{SHARDS18}: {n} K1 "
           f"launches, expected {SHARDS18} x {reads} (one a shard a read)")
    for k, (got, agg, _) in enumerate(ranks):
        for r in reqs:
            _check(_same_request(got[r.rid], want[r.rid]), f"phase 18: "
                   f"engine rank {k} of 1x{SHARDS18}: request {r.rid} != "
                   f"the unmeshed run")
    out[f"1x{SHARDS18}"] = {"s": secs, "decode_tok_s":
                            ranks[0][1]["decode_tok_s"], "launches": n}
    print(f"phase 18: engine arm (a) with ECC accounting, {len(reqs)} "
          f"requests: 1x1 NCCL mesh and 1x{SHARDS18} emulated == the "
          f"unmeshed run bitwise (tokens, logits, ECC {agg['ecc']}); K1 "
          f"launches {reads} unmeshed, {n} on 1x{SHARDS18}; wall "
          f"{out['unmeshed']['s']:.2f} / {out['1x1']['s']:.2f} / "
          f"{secs:.2f} s, decode tok/s {out['unmeshed']['decode_tok_s']:.1f}"
          f" / {out['1x1']['decode_tok_s']:.1f} / "
          f"{out[f'1x{SHARDS18}']['decode_tok_s']:.1f}")
    return out


def _fleet_mesh18(model, dep, kw) -> dict:
    """(d) A fleet of 2 replicas on emulated 1x1 blocks over a shared
    32-token prefix: every routed result equals a one-replica probe's
    (tokens, logits, ECC), with at least one prefix hit."""
    import shutil
    import torch
    from repro_torch.launch import engine as engine_lib
    from repro_torch.launch import fleet as fleet_lib
    load = engine_lib.LoadGen(vocab_size=model.cfg.vocab_size, prefix_len=32,
                              **LOAD18)
    reqs, max_len = load.requests(), load.max_len()
    ekw = dict(n_slots=ENGINE_SLOTS, max_len=max_len, chunk=ENGINE_CHUNK,
               collect_logits=True)
    spool = ROOT / "build" / "phase18_spool"
    shutil.rmtree(spool, ignore_errors=True)
    ranks = fleet_lib.thread_fleet_meshes("1x1", 2)
    t0 = time.perf_counter()
    out = _on_ranks([fm.fleet for fm in ranks], lambda w: fleet_lib.Fleet
                    .from_serving_params(
                        model, dep.shard(ranks[w.rank][ranks[w.rank].replica])
                        .serving_params(**kw), n_replicas=2,
                        meshes=ranks[w.rank], spool_dir=str(spool), **ekw)
                    .run(reqs))
    secs = time.perf_counter() - t0
    with torch.inference_mode():
        probe, _ = fleet_lib.Fleet.from_serving_params(
            model, dep.serving_params(**kw), n_replicas=1,
            spool_dir=str(spool / "probe"), **ekw).run(reqs)
    shutil.rmtree(spool, ignore_errors=True)
    for k, (got, agg) in enumerate(out):
        for r in reqs:
            _check(_same_request(got[r.rid], probe[r.rid]), f"phase 18: "
                   f"fleet rank {k}: request {r.rid} != the one-replica "
                   f"probe")
        _check(agg["prefix_hits"] >= 1, f"phase 18: fleet rank {k}: no "
               f"prefix hit")
    agg = out[0][1]
    print(f"phase 18: fleet of 2 x 1x1 emulated blocks: every routed result "
          f"== the one-replica probe bitwise; routed "
          f"{agg['requests_by_replica']}, prefix hits {agg['prefix_hits']}; "
          f"wall {secs:.2f} s, {agg['tok_s']:.1f} tok/s wall, "
          f"{agg['tok_s_virtual']:.1f} virtual")
    return {"s": secs, "tok_s": agg["tok_s"],
            "tok_s_virtual": agg["tok_s_virtual"],
            "by_replica": agg["requests_by_replica"],
            "prefix_hits": agg["prefix_hits"]}


def phase_mesh_engine(dev, checks: dict, kernel_lib, fi_kernel,
                      card: str) -> dict:
    """Phase 18: K3 at column-shard offsets (a), Fig. 6's one4n arm on a
    (trial, model) mesh (b), the engine (c) and the fleet (d) on meshes,
    the ranks emulated on the one card. Returns the kernels line's K3 row
    for the shard-offset path (its launches those of (b))."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    t0 = time.perf_counter()
    fig = _k3_shards(dev, checks, fi_kernel, card)
    t1 = time.perf_counter()
    model = LM(get_config("olmo-1b"),
               generator=torch.Generator(device=dev).manual_seed(0),
               device=dev)
    sweep = _sweep_mesh18(dev, model, fi_kernel)
    t2 = time.perf_counter()
    dep, kw = _engine_dep18(model)
    engine = _engine_mesh18(model, kernel_lib, dep, kw)
    t3 = time.perf_counter()
    fleet = _fleet_mesh18(model, dep, kw)
    del model, dep
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    print(f"phase 18: {t4 - t0:.1f} s (a {t1 - t0:.1f} s, b {t2 - t1:.1f} s,"
          f" c {t3 - t2:.1f} s, d {t4 - t3:.1f} s)")
    return {"name": "fault_inject_batched@col_shard", "route": "cuda",
            "source": FI_SOURCE, "replaces": REPLACES["fault_inject_batched"],
            "launches": sweep["launches"], "max_abs_err": 0.0,
            "ms": fig["ms"], "plain_ms": fig["plain_ms"],
            "bound_ms": fig["bound_ms"], "bound_by": "operations",
            "library_ms": None, "shards": fig, "sweep": sweep,
            "engine": engine, "fleet": fleet}


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
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels.bfp_matmul import kernel as bfp_kernel
    from repro_torch.kernels.cim_read import kernel as kernel_lib
    from repro_torch.kernels.fault_inject import kernel as fi_kernel
    from repro_torch.models.lm import LM
    dev = resolve_device("cuda")
    card = _card()
    t0 = time.perf_counter()
    if sys.argv[1:] == ["--phase", "16"]:
        phase_build({"K3+K4": fi_kernel.LIBRARY})
        mesh_train = phase_mesh_train(dev, fi_kernel, card)
        print(card)
        print(json.dumps(mesh_train))
        return 0
    if sys.argv[1:] == ["--phase", "17"]:
        phase_build({"K3+K4": fi_kernel.LIBRARY})
        zero3 = phase_zero3(dev, fi_kernel, card)
        print(card)
        print(json.dumps(zero3))
        return 0
    if sys.argv[1:] == ["--phase", "18"]:
        phase_build({"K1+K2": kernel_lib.LIBRARY, "K3+K4": fi_kernel.LIBRARY})
        checks = {name: {"store": _unembed_store(protect, dev)}
                  for name, protect in PROTECT_OF.items()}
        row = phase_mesh_engine(dev, checks, kernel_lib, fi_kernel, card)
        print(card)
        print(json.dumps(row))
        return 0
    if sys.argv[1:] == ["--phase", "15"]:
        phase_build({"K1+K2": kernel_lib.LIBRARY, "K3+K4": fi_kernel.LIBRARY})
        checks = {name: {"store": _unembed_store(protect, dev)}
                  for name, protect in PROTECT_OF.items()}
        mesh = phase_mesh(dev, checks, kernel_lib, fi_kernel, card)
        print(card)
        print(json.dumps(mesh))
        return 0
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}",
              file=sys.stderr)
        return 2
    phase_build({"K1+K2": kernel_lib.LIBRARY, "K3+K4": fi_kernel.LIBRARY,
                 "K5": bfp_kernel.LIBRARY})
    phase_sass(fi_kernel.LIBRARY.build())
    phase_k5_sass(bfp_kernel.LIBRARY.build())
    checks = phase_kernels(dev)
    for name, err in phase_models(dev, checks).items():
        checks[name]["max_abs_err_models"] = err
    model = LM(get_config("olmo-1b"),
               generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    launches = phase_serve(model, kernel_lib)
    phase_reduced_reference(dev)
    engine_launches = phase_engine(model, kernel_lib)
    phase_scrub_fleet(model, kernel_lib, card)
    checks["unembed_weights"] = model.unembed.detach()
    fi = phase_fault_inject(dev, checks, fi_kernel)
    fig6 = phase_fig6(dev, model, fi_kernel)
    del model
    torch.cuda.empty_cache()
    phase_fig2(dev, fi_kernel)
    checks.pop("unembed_weights")
    # the third path: train -> align -> pack -> serve from the BFP planes
    bfp_kernel.reset_launch_counts()
    trained = phase_train(dev)
    bfp = phase_bfp(dev, trained, bfp_kernel)
    del trained
    torch.cuda.empty_cache()
    granite = phase_granite(dev, kernel_lib, card)
    rwkv = phase_kinds(dev, kernel_lib, card)
    codesign = phase_codesign(dev, fi_kernel, card)
    mesh = phase_mesh(dev, checks, kernel_lib, fi_kernel, card)
    mesh_train = phase_mesh_train(dev, fi_kernel, card,
                                  codesign.pop("reference"))
    zero3 = phase_zero3(dev, fi_kernel, card)
    shard_row = phase_mesh_engine(dev, checks, kernel_lib, fi_kernel, card)
    rows = phase_times(dev, checks, launches, engine_launches, card)
    for row in rows:
        row["granite"] = granite[row["name"]]
        row["rwkv6"] = rwkv[row["name"]]
        row["mesh"] = mesh["mesh"][row["name"]]
    fi_rows = phase_fi_times(dev, checks, fig6["launches"], fi, card)
    for row in fi_rows:
        row["codesign"] = codesign[row["name"]]
        row["mesh_train"] = mesh_train[row["name"]]
        if row["name"] in zero3:
            row["zero3"] = zero3[row["name"]]
    fi_rows[0]["trial_slice"] = mesh["trial_slice"]
    rows += fi_rows
    rows.append(shard_row)
    rows.append(phase_bfp_times(dev, bfp, card))
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s after the build start")
    print(json.dumps({"int8_cache": mesh["int8"]}))
    print(json.dumps({"moe_a2a": mesh_train["a2a"]}))
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
