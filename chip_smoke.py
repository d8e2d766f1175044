#!/usr/bin/env python3
"""Smoke run of daam_tpu_torch on one NVIDIA GPU: build, kernel parity, the
card's pytest cases, the traced SD 2.1-base slice in bf16 and in fp32, the
head-replay transplant, the traced SD 1.x slice (DDIM and PNDM), the traced
SDXL slice, a checkpoint directory on disk with the VAE encoder and the
evaluation, batched generation and the demo server, SD 2.1 at 768² with
v-prediction, the native BPE, data-parallel generation, and the kernels'
times alone.  The speed of the program end to end is ``gpubench/``'s
(``BENCHMARK.json``), not this script's.

    python3 chip_smoke.py                 # from the repository root
    python3 chip_smoke.py --kernel-times  # the build and phase 6b's kernel
                                          # times only
    python3 chip_smoke.py --flash-fp32    # the build, then fp32 flash_attention
                                          # at every head dim (``flash_fp32``)
                                          # only: parity and event times

``--kernel-times`` and ``--flash-fp32`` check nothing beyond the build
(``--flash-fp32`` its own parity cases) and print no result line; a copy of
this script placed in another checkout times that checkout's kernels (the
script's own directory comes first on the import path), which is how two
commits are compared in one call.

Phases, each of which raises (exit code != 0) when a check fails, in the
order they run (1, 1b, 2, 3, 8, 8b, 6b, 4, 5, 9, 10, 7, 11, 12, 13, 14, 15;
phase 6a, the pipelines' step timings, was retired for ``gpubench/``):

1. Build ``daam_tpu_torch/csrc/attention.cu`` (and ``overlay.cu`` and
   ``geglu.cu``) with nvcc for sm_90a; print
   each kernel's registers and spills, and fail if a kernel
   (``flash_attention_wgmma_kernel``, ``cross_attention_mma_kernel``,
   ``flash_attention_tf32x3_wgmma_kernel`` and ``split_kv_tf32x3_kernel``
   at the head dims of ``TF32X3_WGMMA_HEAD_DIMS``,
   ``flash_attention_tf32x3_kernel`` at the others,
   ``cross_attention_tf32x3_kernel``; the cross-attention ones with the acc
   and both P epilogues; ``geglu_kernel`` in bf16 and fp32, 16 bytes or
   one element a step) is missing or spills.
1b. The native BPE (``daam_tpu_torch/native/bpe.cpp``), built with g++
   under ``build/daam_tpu_torch/bpe/``: ``default_tokenizer()`` must be the
   ``NativeBpeTokenizer`` and give the Python BPE's tokens, padded ids and
   masks on the CLI's prompts (``template`` over ``data/vocab-small.tsv``,
   ``cconj``, phase 12's captions and batch); its rate against the Python
   BPE's is printed.
2. Kernel parity at the paths' shapes, kernel against its plain PyTorch
   version on the same inputs, in both layouts (head-major view and the
   (B, L, H·hd) projection output), in bf16 and fp32 at every head dim of
   ``HEAD_DIMS`` (16, 32, 40, 64, 80, 128, 160): ``flash_attention`` at
   every shape of ``K2_SHAPES`` (Lq ∈ {4096, 1024, 256, 64}, Lk = Lq or
   77), ``SDXL_K2_SHAPES``, ``V2L_K2_SHAPES`` (Lq ∈ {9216, 2304, 576,
   144}) and ``V1_K2_SHAPES`` (each at its own hd);
   ``cross_attention_acc`` at every shape of ``K1_SHAPES``,
   ``SDXL_K1_SHAPES``, ``V2L_K1_SHAPES`` and ``V1_K1_SHAPES``, at the
   ragged Lq = 100 and at Lk = 200 (three 80-key chunks), called twice
   into the same accumulator; ``cross_attention_probs`` at every shape of
   ``K5_SHAPES``, ``SDXL_K5_SHAPES``, ``V2L_K5_SHAPES`` and
   ``V1_K5_SHAPES``, at the ragged Lq = 37 and at
   Lk = 200, with and
   without ``cond_only``, P in fp32 and bf16 (P compared on the rows it
   writes).  Every case must have run on its dtype's route (the ``*_wgmma``
   and ``*_mma`` counters for bf16, ``*_tf32x3`` for fp32).  TF32 is off
   for the fp32 plain versions.  Max abs error ≤ 1e-4 (fp32 outputs), ≤ 1e-5
   (fp32 P and the fp32 accumulator, whatever the inputs' type: both are
   built from fp32 P), ≤ 1/128 (bf16 P), ≤ 2e-2 (bf16 outputs); Spearman ≥
   0.999.  Each bf16 output of the three kernels must lie closer (mean abs
   difference) to a reference that rounds P to bf16 before PV where the
   Pallas body does than to the same reference with fp32 P.
3. A small reference: the ``tiny``, ``tiny-v1`` and ``tiny-xl`` presets in
   fp32, kernels
   against the plain path, same weights and latents: images within 1e-3,
   heat maps with per-token Spearman ≥ 0.999; then an fp32 save_heads →
   load_heads pair under each, whose buffers agree within 1e-5 and images
   within 1e-3.
4. The main path at full width: ``v2-1-base`` (random weights from seed 0),
   bf16, 512², 10 traced DDIM steps through ``trace(pipe)``; the image must
   be (512, 512, 3) and finite, the word map for "dog" (64, 64), finite,
   ≥ 0 and not constant, and the launch counters, zeroed just before the
   run, must read 15 × 10 (cross_attention_acc) and 32 × 10
   (flash_attention), every one on the bf16 route.
5. The transplant at full width, the same model: a ``save_heads`` run of the
   prompt (counters: 16 × 10 cross_attention_probs and 16 × 10
   flash_attention, every one on the bf16 route; no cross_attention_acc),
   whose bf16 buffer must hold 16 layers of (10, 2, H, h·w, 77), finite,
   rows summing to 1 within 1e-2; a ``load_heads`` run of the same prompt
   (counters: 16 × 10 flash_attention on the bf16 route, nothing else),
   whose per-token heat maps must match the save run's at Spearman ≥ 0.999;
   and a ``load_heads`` run of a second prompt, whose image must differ
   from a fresh run of that prompt.
6b. Run right after phase 8b: each kernel in bf16 and in fp32 (TF32 off
   for the plain versions and SDPA) at every shape of each path
   (v2-1-base and xl-base-1.0 at hd 64, then v1 at hd 40, 80 and 160, its
   bound on the true hd, then v2-1-large and v2-1-base at a batch of 4 at
   hd 64): its time by CUDA events (back-to-back launches after a
   warm-up), its device time per launch (torch.profiler's self device
   time over 20 launches, so the wrappers' host cost does not stand in for
   kernel time;
   fp32 flash_attention at the head dims of ``TF32X3_WGMMA_HEAD_DIMS`` is
   two device kernels a call, the split of K and V and the attention),
   its plain version's time, its bound, and the bound's share of the device
   time.  The bound is the larger of the bytes the call must move (each
   input read once, each output written once) over the H100's 3.35 TB/s and
   its FLOP (4·B·H·Lq·Lk·hd) over 989 TFLOP/s dense bf16, or for fp32 three
   times the FLOP (3xTF32) over 495 TFLOP/s dense TF32; fp32 rows also
   print the CUDA-core bound, the FLOP over 67 TFLOP/s.  The bytes are q, k,
   v and o in the dtype, plus the fp32 accumulator read and written
   (``cross_attention_acc``) or fp32 P written (``cross_attention_probs``,
   as the save run writes it).  ``flash_attention`` is also timed against
   ``torch.nn.functional.scaled_dot_product_attention`` on the same q, k
   and v, a yardstick the port never calls.  Then K8, ``kernels.geglu``
   (``geglu_times``), at v2-1-base's and xl-base-1.0's feed-forward shapes
   in both dtypes: equal to the former chain bit for bit, one device kernel
   a call, its event and device time, the chain's, and its byte bound.
7. SDXL at full width: ``xl-base-1.0`` (random weights from seed 0; UNet
   320/640/1280, CLIP-L and OpenCLIP-bigG), bf16, 1024², 10 traced DDIM
   steps through ``trace(pipe)``: the image must be (1024, 1024, 3) and
   finite, the "dog" map (64, 64), finite, ≥ 0 and not constant, the VAE
   decoder called once on the 3 × 3 batch of 64² tiles, and the counters,
   zeroed just before the run, 60 × 10 cross_attention_acc and 140 × 10
   flash_attention, every one on the bf16 route, and no
   cross_attention_probs.  Then one traced step through the kernels and one
   with ``set_kernel_mode('torch')``, from the same latents, whose global
   heat maps must agree at per-token Spearman ≥ 0.99.  After it, the
   transplant as in phase 5 at 2 steps (70 × 2 cross_attention_probs and
   70 × 2 flash_attention in the save run, 70 layers of (2, 2, H, h·w, 77)
   bf16, ~0.5 GB a step on the host; 70 × 2 flash_attention in the load
   run; maps Spearman ≥ 0.999; no second prompt).  Then the pipeline is
   rebuilt in fp32 (13.7 GB of weights) and the one-step comparison
   repeated with TF32 off, at Spearman ≥ 0.999, its kernel step's counters
   60 cross_attention_acc and 140 flash_attention, all on the fp32 route,
   and the transplant repeated on the fp32 route.
8. ``tests/test_torch_cuda.py`` (the kernels against their plain versions,
   JAX-free) in a subprocess, ``python -m pytest --noconftest``: exit 0
   and at least one pass.
8b. The heat-map overlays of one v2-1-base fp32 512² experiment drawn on
   the card (``csrc/overlay.cu``) and on the host (``overlay_routes``):
   pixels within one level on at most 0.5% of a PNG's pixels, the card's
   files within 1% of Pillow's size, one ``overlay_resample`` a word and
   one ``png_scanlines`` a PNG on the card, none on the host; on two
   threads two stripes a PNG of the card's (``png.write_png``'s return),
   each file's rows those of the one-stream file and its size at most 0.1%
   over it; the ms a word of both routes, the card's with the one-stream
   and the striped writer.  Phases 11 and 12 count one ``overlay_resample``
   a heat map and one ``png_scanlines`` a PNG the CLI writes on the card.
9. What ``daam-torch`` runs by default: ``v2-1-base`` in fp32, 512², 10
   traced steps, checked as in phase 4, with 15 × 10 cross_attention_acc
   and 32 × 10 flash_attention launches, every one on the 3xTF32 route;
   the transplant as in phase 5 on the 3xTF32 route (what ``--save-heads``
   and ``--load-heads`` run; no second prompt).
10. SD 1.x at full width: ``v1`` (random weights from seed 0; UNet
    320/640/1280/1280 with 8 heads, so hd 40, 80 and 160; CLIP-L's final
    layer), 512², checked as in phase 4: in fp32 with DDIM (what
    ``daam-torch --model v1`` runs), 10 traced steps with 15 × 10
    cross_attention_acc and 32 × 10 flash_attention launches on the 3xTF32
    route (12 × 10 of them, hd 160's, on ``flash_attention_tf32x3_mma``),
    and the transplant as in phase 9 (16 × 10 cross_attention_probs on
    ``cross_attention_probs_tf32x3``; 6 × 10 K2 on the mma route); in bf16
    with PNDM (SD 1.x's published scheduler), 10 steps that are 11 UNet
    evaluations: 15 × 11 and 32 × 11 launches on the bf16 routes, and its
    transplant over 11 evaluations.
11. A checkpoint directory on disk, what ``daam-torch --from-path`` and
    ``daam-torch-evaluate`` run: ``v2-1-base``'s random modules from seed 0,
    the VAE with a random encoder, rounded through fp16 and written in
    diffusers' layout (``unet/`` and ``vae/`` as fp16 ``.safetensors``
    written by this script, the VAE's mid-block attention under the legacy
    ``query/key/value/proj_attn`` names with 1×1 conv weights,
    ``text_encoder/`` as an fp16 ``.bin``, the ``config.json`` files, the
    scheduler's and ``tokenizer/``; ~2.6 GB).  ``from_pretrained(dir)`` must
    resolve the ``v2-1-base`` preset and load every tensor bit for bit equal
    to the rounded modules (its seconds printed); ``daam-torch --from-path``,
    in process, 10 traced fp32 steps with 15 × 10 cross_attention_acc and
    32 × 10 flash_attention launches on the 3xTF32 route, whose image and
    maps must match the in-memory rounded pipeline's at the same seed (±2/255,
    per-token Spearman ≥ 0.999); the VAE encoder on the generated image on
    the card and on the CPU (TF32 off), posterior mean and logvar within 1e-3
    relative max abs, its device time by CUDA events; then truth masks
    (``*.gt.png``, one experiment's at 640 × 480, so the resize runs) and
    predictions from the heat maps (``expand_as(threshold=0.4)``), and
    ``daam-torch-evaluate`` with ``labeled``, ``unlabeled`` and
    ``hungarian`` on ``cuda`` and on ``cpu``: equal reports, ``iou_matrix``
    within 1e-6, the card's seconds printed.
12. Batched generation, what ``daam-torch --batch-size 4`` and
    ``daam-torch-demo --batch-size 4`` run: 4 prompts, CFG batch 8,
    ``v2-1-base`` in fp32, 512², 10 steps.  (a) Phase 2's parity at CFG
    batch 8 and v2-1-base's shapes, bf16 and fp32, both layouts: K2 on
    every self-attention and on the unconditional half of each
    cross-attention, K1 on the conditional half (a view 4 batch strides
    in), K5 on all 8 rows with and without ``cond_only``; phase 2's gates.
    (b) ``daam-torch --action regenerate`` in process over 4 fabricated
    experiment folders (4 prompts, 4 seeds) at ``--batch-size 4`` (one
    traced call: 150 K1 and 320 K2 on ``*_tf32x3``) and at
    ``--batch-size 1`` (4 calls): each prompt's image within 2/255 of its
    batch-1 image and its maps at per-token Spearman ≥ 0.999; ``--action
    coco --word dog --gen-limit 4 --batch-size 4 -n 2`` over a fabricated
    captions file (only prompts with the lemma once, only its map; 30 K1,
    64 K2); the save → load pair at batch 4 (160 K5 at CFG batch 8, the
    buffer's 8 rows, each prompt's replayed maps, peak host RSS).  (c)
    ``daam-torch-demo``: ``make_app(pipe, 0, batch_size=4)`` behind a
    ``ThreadingHTTPServer`` on 127.0.0.1: 4 concurrent POSTs answered by
    one traced call (150 K1, 320 K2), each page's image and map against a
    batch-1 run of its prompt and seed as in (b); a counterfactual POST
    (save run with 160 K5, load run), whose transplanted image differs from
    a fresh run of the new prompt, towards the saved run's; one request
    through a batch-1 server; images/s through both servers.
13. SD 2.1 at 768² with v-prediction, what ``daam-torch --model
    v2-1-large`` runs: ``v2-1-large`` (random weights from seed 0;
    v2-1-base's UNet on a 96² latent, so 9216 queries at the first level),
    in fp32 and in bf16, 10 traced DDIM steps each: a (768, 768, 3) finite
    image, one untiled VAE decode of the (1, 4, 96, 96) latent, finite 96²
    maps for every token, 15 × 10 cross_attention_acc and 32 × 10
    flash_attention on the dtype's route; the save -> load pair as in
    phase 9 (16 × 10 cross_attention_probs and 16 × 10 flash_attention,
    ~125 MB of bf16 P a step to the host; maps Spearman ≥ 0.999); peak
    device memory and host RSS.
14. Data-parallel generation (``daam_tpu_torch.parallel``):
    ``init_distributed('tcp://127.0.0.1:<free port>', world_size=1,
    rank=0)`` joins an NCCL group; ``fetch_global`` of a card tensor goes
    through NCCL's all_gather; ``generate_batch`` of 3 prompts at
    v2-1-base 512² fp32 (10 traced steps, 15 × 10 × 3 K1 and 32 × 10 × 3
    K2 on ``*_tf32x3``) must give each prompt the image and maps of a run
    of it alone, bit for bit; the group is destroyed.
15. The port against ``daam_tpu`` at full width, with no JAX here: for each
    golden ``tests/make_torch_goldens.py`` made with ``daam_tpu`` on a CPU
    (``tests/fixtures/torch_goldens/``: ``v2-1-base`` 512², 10 steps, and
    ``xl-base-1.0`` 1024², 2 steps, fp32 DDIM, traced), the weights are
    made again by ``init_random_params`` (``daam_tpu``'s host init, numpy
    only, bf16 from seed 0) and their per-module sums must equal the
    golden's before anything runs; then the modules are loaded in fp32 on
    the card with TF32 off (matmul and cuDNN; restored afterwards), the
    golden's initial latents injected, and the traced pipeline run: the
    image within 2/255 of the golden's, the maps at per-token Spearman ≥
    0.99 and within rtol 0.05, atol 0.02 (``_assert_close`` of
    ``tests/test_e2e_fidelity_torch.py``), and the launches 15 × 10
    cross_attention_acc and 32 × 10 flash_attention (SDXL: 60 × 2 and
    140 × 2), every one on ``*_tf32x3``.  It prints the latents' max abs
    error step by step, the seconds of the numpy init and the s/step.

Before the card's name and power limit, ``{"v1_kernels": [...]}`` gives
the same keys as the ``kernels`` line for v1's path (launches from phase
10: bf16 from the PNDM runs, per 11 evaluations; fp32 from the DDIM runs;
times per v1 evaluation), and ``{"sdxl_kernels": [...]}`` for SDXL's path:
launches from phase 7
(the bf16 run's; the fp32 step's for the fp32 entries;
cross_attention_probs: the 2-step save run's of each dtype) and times per
SDXL evaluation (cross_attention_probs: per evaluation of an SDXL save
run), then ``{"b4_kernels": [...]}``, the fp32 entries at CFG batch 8
(launches from phase 12's batch-4 regenerate run and its save run, times
per UNet evaluation at batch 4, max abs errors from phase 12a), and
``{"v2l_kernels": [...]}`` for v2-1-large's path (launches from phase 13,
times per 768² evaluation).  The line
before the last is ``{"kernels": [...]}``: per kernel and
dtype (the fp32 entries named by their counters,
``flash_attention_tf32x3``, ``cross_attention_acc_tf32x3`` and
``cross_attention_probs_tf32x3``), its
launches in its path's run (phase 4 or 9, or the phase-5 or phase-9 save
run for cross_attention_probs), the largest max-abs error of phase 2, and,
per UNet evaluation of its path (each shape's number × its launches per
evaluation): ``ms`` (events), ``device_ms`` (profiler), ``plain_ms``,
``bound_ms`` with ``bound_by`` (what bounds most of it), ``core_bound_ms``
(fp32: the CUDA-core bound) and ``library_ms`` (SDPA for
``flash_attention``; null for the others: no PyTorch call adds Pᵀ into an
accumulator or returns P).  The last line is ``{"ok": true, "device":
{...}}``.  The script needs a CUDA device and the daam_tpu_torch package
beside it; it never imports JAX.
"""

import argparse
import contextlib
import gc
import json
import re
import subprocess
import sys
import time

PROMPT = 'A dog runs across the field.'
PROMPT2 = 'A cat sits on the red sofa.'
STEPS = 10
K1_PER_EVAL, K2_PER_EVAL = 15, 32
# Per UNet evaluation of the save run: every attn2 (the mid block's too)
# through cross_attention_probs, every attn1 through flash_attention.
K5_PER_EVAL, K2_PER_EVAL_REPLAY = 16, 16
# xl-base-1.0 at 1024² (128² latent), hd 64: 10 transformer blocks at 4096
# queries × 10 heads (level 1) and 60 at 1024 × 20 (level 2, the mid
# block's 10 included); the trace captures the 60 outside the mid block,
# the save run all 70.
SDXL_K1_PER_EVAL, SDXL_K2_PER_EVAL = 60, 140
SDXL_K5_PER_EVAL, SDXL_K2_PER_EVAL_REPLAY = 70, 70
SDXL_REPLAY_STEPS = 2  # its save and load runs: ~0.5 GB of bf16 P a step
# geglu launches per UNet evaluation, one a transformer block's feed-forward
# in every run: 16 in SD 2.x and SD 1.x, 70 in SDXL
FF_PER_EVAL, SDXL_FF_PER_EVAL = 16, 70
#: (rows, w) of each feed-forward gate of one UNet evaluation (CFG rows, h
#: and gate w wide) with its count, of the paths the GEGLU times cover
GEGLU_SHAPES = {'v2-1-base': [((8192, 1280), 5), ((2048, 2560), 5), ((512, 5120), 5),
                              ((128, 5120), 1)],
                'xl-base-1.0': [((8192, 2560), 10), ((2048, 5120), 60)]}
SDXL_K2_SHAPES = [((2, 10, 4096, 4096), 10), ((2, 20, 1024, 1024), 60),
                  ((1, 10, 4096, 77), 10), ((1, 20, 1024, 77), 50),
                  ((2, 20, 1024, 77), 10)]
SDXL_K1_SHAPES = [((1, 10, 4096, 77), 10), ((1, 20, 1024, 77), 50)]
# per evaluation of an SDXL save run, every attn2 through
# cross_attention_probs
SDXL_K5_SHAPES = [((2, 10, 4096, 77), 10), ((2, 20, 1024, 77), 60)]
SDXL_TILES = (9, 4, 64, 64)  # one decoder call: 3 × 3 tiles of 64² latents
# (B, H, Lq, Lk) of every launch of one UNet evaluation at 512², hd 64,
# with its count per evaluation.
K2_SHAPES = [((2, 5, 4096, 4096), 5), ((2, 10, 1024, 1024), 5),
             ((2, 20, 256, 256), 5), ((2, 20, 64, 64), 1),
             ((1, 5, 4096, 77), 5), ((1, 10, 1024, 77), 5),
             ((1, 20, 256, 77), 5), ((2, 20, 64, 77), 1)]
K1_SHAPES = [((1, 5, 4096, 77), 5), ((1, 10, 1024, 77), 5),
             ((1, 20, 256, 77), 5)]
K5_SHAPES = [((2, 5, 4096, 77), 5), ((2, 10, 1024, 77), 5),
             ((2, 20, 256, 77), 5), ((2, 20, 64, 77), 1)]
# SD 1.x (v1) at 512²: 8 heads at every level, so hd 40, 80 and 160 over
# 320, 640 and 1280 channels; (B, H, Lq, Lk), launches per evaluation, hd.
V1_K2_SHAPES = [((2, 8, 4096, 4096), 5, 40), ((2, 8, 1024, 1024), 5, 80),
                ((2, 8, 256, 256), 5, 160), ((2, 8, 64, 64), 1, 160),
                ((1, 8, 4096, 77), 5, 40), ((1, 8, 1024, 77), 5, 80),
                ((1, 8, 256, 77), 5, 160), ((2, 8, 64, 77), 1, 160)]
V1_K1_SHAPES = [((1, 8, 4096, 77), 5, 40), ((1, 8, 1024, 77), 5, 80),
                ((1, 8, 256, 77), 5, 160)]
V1_K5_SHAPES = [((2, 8, 4096, 77), 5, 40), ((2, 8, 1024, 77), 5, 80),
                ((2, 8, 256, 77), 5, 160), ((2, 8, 64, 77), 1, 160)]
# v2-1-large (SD 2.1, 768², v-prediction): v2-1-base's topology on a 96²
# latent, so 9216/2304/576/144 queries where v2-1-base has 4096/1024/256/64
V2L_K2_SHAPES = [((2, 5, 9216, 9216), 5), ((2, 10, 2304, 2304), 5),
                 ((2, 20, 576, 576), 5), ((2, 20, 144, 144), 1),
                 ((1, 5, 9216, 77), 5), ((1, 10, 2304, 77), 5),
                 ((1, 20, 576, 77), 5), ((2, 20, 144, 77), 1)]
V2L_K1_SHAPES = [((1, 5, 9216, 77), 5), ((1, 10, 2304, 77), 5),
                 ((1, 20, 576, 77), 5)]
V2L_K5_SHAPES = [((2, 5, 9216, 77), 5), ((2, 10, 2304, 77), 5),
                 ((2, 20, 576, 77), 5), ((2, 20, 144, 77), 1)]
# Off the paths: Lq not a multiple of the 64-query block, and Lk past one
# 80-key chunk (the tensor-core kernel's two-pass route).
EXTRA_SHAPES = {'cross_attention_acc': [(1, 5, 100, 77), (1, 5, 128, 200)],
                'cross_attention_probs': [(2, 5, 37, 77), (2, 5, 100, 200)]}
HD = 64
# phase 12: a batch of 4 prompts (CFG batch 8), each with its own seed
BATCH = 4
BATCH_PROMPTS = ['A dog runs across the field', 'A cat sits on the red sofa',
                 'A brown horse eats green grass', 'A small bird flies over the sea']
BATCH_SEEDS = [0, 7, 11, 42]
# phase 12's captions_val2014.json for --action coco --word dog
COCO_CAPTIONS = [{'id': 1, 'caption': 'A dog sleeps on a porch'},
                 {'id': 2, 'caption': 'A red car parked by the road'},
                 {'id': 3, 'caption': 'Two dogs and a dog play in the snow'},
                 {'id': 4, 'caption': 'A brown dog chases a ball'},
                 {'id': 5, 'caption': 'A man walks his dog in the park'},
                 {'id': 6, 'caption': 'A cat watches a bird'},
                 {'id': 7, 'caption': 'A dog swims in a lake'},
                 {'id': 8, 'caption': 'A small dog wears a hat'}]
#: phase 15: the goldens made with daam_tpu (tests/make_torch_goldens.py),
#: and the K1, K2 and geglu launches of each one's traced run
GOLDENS = 'tests/fixtures/torch_goldens'
GOLDEN_LAUNCHES = {'v2-1-base': (K1_PER_EVAL * STEPS, K2_PER_EVAL * STEPS,
                                 FF_PER_EVAL * STEPS),
                   'xl-base-1.0': (SDXL_K1_PER_EVAL * 2, SDXL_K2_PER_EVAL * 2,
                                   SDXL_FF_PER_EVAL * 2)}
DTYPES = ('bf16', 'fp32')
#: The launch counter of each kernel's route, by dtype.
ROUTE = {'bf16': {'flash_attention': 'flash_attention_wgmma',
                  'cross_attention_acc': 'cross_attention_acc_mma',
                  'cross_attention_probs': 'cross_attention_probs_mma'},
         'fp32': {'flash_attention': 'flash_attention_tf32x3',
                  'cross_attention_acc': 'cross_attention_acc_tf32x3',
                  'cross_attention_probs': 'cross_attention_probs_tf32x3'}}
# H100 SXM (NVIDIA's data sheet)
BF16_PEAK_TFLOPS = 989.0  # dense
TF32_PEAK_TFLOPS = 495.0  # dense
FP32_CORE_TFLOPS = 67.0   # the CUDA cores
HBM_TB_S = 3.35
#: phase 2's gates on kernel outputs, by dtype
TOL = {'fp32': 1e-4, 'bf16': 2e-2}


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f'check failed: {msg}')


def expected(kernels, dtype: str, **counts) -> dict:
    """Launch counts of a run in ``dtype``: each named kernel's total and
    its route's counter at the given count (the overlay kernels and
    ``geglu``, one a feed-forward of each UNet evaluation, have no route;
    ``flash_attention_tf32x3_mma``, the fp32 K2 calls of those on
    ``flash_attention_tf32x3_kernel``, as given), every other counter 0."""
    routed = {ROUTE[dtype][name]: n for name, n in counts.items() if name in ROUTE[dtype]}
    return {**dict.fromkeys(kernels.launches, 0), **counts, **routed}


def v1_mma_per_eval(kernels, replay: bool = False) -> int:
    """fp32 K2 launches of one v1 evaluation on mma.sync
    (``flash_attention_tf32x3_kernel``: hd 160, outside
    ``TF32X3_WGMMA_HEAD_DIMS``): 12 traced, 6 (the self-attentions alone) in
    a save or load run (``replay``)."""
    return sum(n for (_, _, _, lk), n, hd in V1_K2_SHAPES
               if hd not in kernels.TF32X3_WGMMA_HEAD_DIMS and not (replay and lk == 77))


def png_launches(out_dir) -> dict:
    """The overlay kernels' launches of a ``daam-torch`` run on the card
    that wrote ``out_dir``: one ``overlay_resample`` a heat map, one
    ``png_scanlines`` a PNG (heat map or ``output.png``)."""
    import os

    maps = images = 0
    for _, _, files in os.walk(out_dir):
        maps += sum(f.endswith('.heat_map.png') for f in files)
        images += files.count('output.png')
    check(maps > 0 and images > 0, f'{out_dir}: no heat map or image written')
    return {'overlay_resample': maps, 'png_scanlines': maps + images}


def check_traced(out, tc, side: int, label: str):
    """A traced run's image must be (side, side, 3) and finite, its "dog"
    map on the trace's grid, finite, ≥ 0 and not constant."""
    import numpy as np
    import torch

    grid = int(tc.latent_hw ** 0.5)
    image = out.images[0]
    word = tc.compute_global_heat_map().compute_word_heat_map('dog').heatmap
    print(f'{label} image {image.shape} range [{image.min():.4f}, {image.max():.4f}]; '
          f'dog map {tuple(word.shape)} range [{word.min().item():.4e}, '
          f'{word.max().item():.4e}]')
    check(image.shape == (side, side, 3) and bool(np.isfinite(image).all()),
          f'{label} image')
    check(tuple(word.shape) == (grid, grid) and bool(torch.isfinite(word).all())
          and bool((word >= 0).all()) and word.max().item() > word.min().item(),
          f'{label} word heat map')


def spearman(a, b) -> float:
    import torch

    def ranks(x):
        x = x.flatten().double()
        r = torch.empty_like(x)
        r[x.argsort()] = torch.arange(x.numel(), dtype=torch.float64,
                                      device=x.device)
        return r - r.mean()

    ra, rb = ranks(a), ranks(b)
    return float((ra * rb).sum() / (ra.norm() * rb.norm()))


def qkv(B, H, Lq, Lk, layout, dtype, gen, hd=HD):
    """(B, L, H, hd) views: of a head-major tensor or of the projection
    layout (B, L, H·hd)."""
    import torch

    def one(L):
        if layout == 'head_major':
            t = torch.randn(B, H, L, hd, generator=gen, device='cuda')
            return t.to(dtype).transpose(1, 2)
        t = torch.randn(B, L, H * hd, generator=gen, device='cuda')
        return t.to(dtype).unflatten(-1, (H, hd))
    return one(Lq), one(Lk), one(Lk)


def flash_reference(q, k, v, round_p: bool, chunk: int = 128):
    """K2's arithmetic in fp32: an online softmax over ``chunk``-key tiles
    (the kernel's), unnormalized P = exp(s - m) rounded to v's dtype before
    PV when ``round_p`` (as the Pallas body does,
    ``daam_tpu/ops/pallas_attention.py:117``), O divided by the row sum at
    the end.  Returns (B, Lq, H·hd) in q's dtype."""
    import torch

    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    scale = q.shape[-1] ** -0.5
    m = torch.full(qf.shape[:-1] + (1,), float('-inf'), device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for j in range(0, kf.shape[2], chunk):
        s = qf @ kf[:, :, j:j + chunk].transpose(-1, -2) * scale
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pv = p.to(v.dtype).float() if round_p else p
        acc = acc * corr + pv @ vf[:, :, j:j + chunk]
        m = m_new
    return (acc / l).transpose(1, 2).flatten(2).to(q.dtype)


def cross_reference(q, k, v, round_p: bool):
    """K1's output arithmetic in fp32: normalized P, rounded to v's dtype
    before PV when ``round_p`` (as the Pallas body does,
    ``daam_tpu/ops/pallas_attention.py:480``)."""
    import torch

    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
    p = (s * q.shape[-1] ** -0.5).softmax(-1)
    p = p.to(v.dtype).float() if round_p else p
    return torch.einsum('bhqk,bkhd->bqhd', p, v.float()).flatten(2).to(q.dtype)


def check_rounding(name, o, rounded, unrounded):
    """The kernel's output must be closer to the reference that rounds P
    where the Pallas body does than to the one that keeps P in fp32."""
    d_r = (o.float() - rounded.float()).abs().mean().item()
    d_u = (o.float() - unrounded.float()).abs().mean().item()
    print(f'  rounding {name}: mean abs diff to rounded-P reference {d_r:.3e}, '
          f'to fp32-P reference {d_u:.3e}')
    check(d_r < d_u, f'{name} rounds P where the Pallas body does')


def parity_flash(kernels, A, q, k, v, tag: str, worst: dict):
    """``flash_attention`` against its plain version on (q, k, v): max abs
    error within its dtype's gate, Spearman ≥ 0.999, and in bf16 closer to
    the reference that rounds P where the Pallas body does."""
    import torch

    dname = 'bf16' if q.dtype == torch.bfloat16 else 'fp32'
    o = kernels.flash_attention(q, k, v)
    r = A.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = (o.float() - r.float()).abs().max().item()
    rho = spearman(o, r)
    print(f'parity flash_attention {tag} max_abs_err={err:.3e} spearman={rho:.6f}')
    check(err <= TOL[dname] and rho >= 0.999, 'flash_attention parity')
    worst['flash_attention', dname] = max(worst['flash_attention', dname], err)
    if dname == 'bf16':
        check_rounding('flash_attention', o, flash_reference(q, k, v, True),
                       flash_reference(q, k, v, False))


def parity_acc(kernels, A, calls, tag: str, worst: dict):
    """``cross_attention_acc`` against its plain version, ``calls`` (q, k,
    v) triples in turn into one accumulator each: the outputs and the fp32
    accumulators as ``parity_flash`` holds outputs, the accumulator within
    1e-5."""
    import torch

    q = calls[0][0]
    dname = 'bf16' if q.dtype == torch.bfloat16 else 'fp32'
    B, Lq, H, _ = q.shape
    acc = torch.zeros(B, H, calls[0][1].shape[1], Lq, device='cuda')
    acc_plain = acc.clone()
    for q, k, v in calls:
        o = kernels.cross_attention_acc(q, k, v, acc)
        r = A.cross_attention_acc_plain(q, k, v, acc_plain)
    torch.cuda.synchronize()
    err = (o.float() - r.float()).abs().max().item()
    acc_err = (acc - acc_plain).abs().max().item()
    rho = min(spearman(o, r), spearman(acc, acc_plain))
    print(f'parity cross_attention_acc {tag} max_abs_err={err:.3e} '
          f'acc_max_abs_err={acc_err:.3e} spearman={rho:.6f}')
    # acc sums fp32 P whatever the inputs' type: a kernel that added
    # bf16-rounded P would miss this by ~1e-3
    check(err <= TOL[dname] and acc_err <= 1e-5 and rho >= 0.999,
          'cross_attention_acc parity')
    worst['cross_attention_acc', dname] = max(worst['cross_attention_acc', dname],
                                              err, acc_err)
    if dname == 'bf16':  # the plain version rounds normalized P before PV
        check_rounding('cross_attention_acc', o, r, cross_reference(q, k, v, False))


def parity_probs(kernels, A, q, k, v, tag: str, worst: dict):
    """``cross_attention_probs`` against its plain version, with and
    without ``cond_only``, P in fp32 and bf16 (P compared on the rows it
    writes; ≤ 1e-5 in fp32, ≤ 1/128 in bf16)."""
    import torch

    dname = 'bf16' if q.dtype == torch.bfloat16 else 'fp32'
    B = q.shape[0]
    for cond_only in (False, True):
        for pdt in (torch.float32, torch.bfloat16):
            o, p = kernels.cross_attention_probs(q, k, v, cond_only, pdt)
            r, rp = A.cross_attention_probs_plain(q, k, v, cond_only, pdt)
            torch.cuda.synchronize()
            rows = slice(B // 2, None) if cond_only else slice(None)
            p, rp = p[rows].float(), rp[rows].float()
            err = (o.float() - r.float()).abs().max().item()
            p_err = (p - rp).abs().max().item()
            rho = min(spearman(o, r), spearman(p, rp))
            print(f'parity cross_attention_probs {tag} cond_only={cond_only!s:5s} '
                  f'P {str(pdt):14s} max_abs_err={err:.3e} p_max_abs_err={p_err:.3e} '
                  f'spearman={rho:.6f}')
            # bf16 P: kernel and plain version may round to neighbours,
            # one ulp (1/256 below 1) apart
            p_tol = 1e-5 if pdt == torch.float32 else 1 / 128
            check(err <= TOL[dname] and p_err <= p_tol and rho >= 0.999,
                  'cross_attention_probs parity')
            worst['cross_attention_probs', dname] = max(
                worst['cross_attention_probs', dname], err, p_err)
            if dname == 'bf16':
                check_rounding('cross_attention_probs', o, r,
                               cross_reference(q, k, v, False))


def new_worst() -> dict:
    return {(name, dtype): 0.0 for dtype in DTYPES for name in (
        'flash_attention', 'cross_attention_acc', 'cross_attention_probs')}


def parity(kernels, A):
    """Phase 2; returns the largest max-abs error per kernel and dtype
    ('bf16', 'fp32')."""
    import torch

    worst = new_worst()
    gen = torch.Generator(device='cuda').manual_seed(0)

    def cases(shapes, dims=kernels.HEAD_DIMS):
        return [(hd, sh) for hd in dims for sh in shapes]

    k1_shapes = [sh for sh, _ in K1_SHAPES] + EXTRA_SHAPES['cross_attention_acc']
    k5_shapes = [sh for sh, _ in K5_SHAPES] + EXTRA_SHAPES['cross_attention_probs']
    # SDXL's and v2-1-large's shapes at their one head dim, 64, and v1's
    # each at its own
    paths = {name: [(HD, sh) for sh, _ in shapes + v2l] + [(hd, sh) for sh, _, hd in v1]
             for name, shapes, v2l, v1 in (
                 ('flash_attention', SDXL_K2_SHAPES, V2L_K2_SHAPES, V1_K2_SHAPES),
                 ('cross_attention_acc', SDXL_K1_SHAPES, V2L_K1_SHAPES, V1_K1_SHAPES),
                 ('cross_attention_probs', SDXL_K5_SHAPES, V2L_K5_SHAPES, V1_K5_SHAPES))}
    for dtype in (torch.float32, torch.bfloat16):
        dname = 'bf16' if dtype == torch.bfloat16 else 'fp32'
        for layout in ('head_major', 'packed'):
            before = dict(kernels.launches)

            def tag(hd, shape):
                return f'{layout:10s} {str(dtype):14s} hd={hd:<3d} B,H,Lq,Lk={shape}'
            flash_cases = cases([sh for sh, _ in K2_SHAPES]) + paths['flash_attention']
            for hd, shape in flash_cases:
                parity_flash(kernels, A, *qkv(*shape, layout, dtype, gen, hd),
                             tag(hd, shape), worst)
            acc_cases = cases(k1_shapes) + paths['cross_attention_acc']
            for hd, shape in acc_cases:
                parity_acc(kernels, A, [qkv(*shape, layout, dtype, gen, hd)
                                        for _ in range(2)], tag(hd, shape), worst)
            probs_cases = cases(k5_shapes) + paths['cross_attention_probs']
            for hd, shape in probs_cases:
                parity_probs(kernels, A, *qkv(*shape, layout, dtype, gen, hd),
                             tag(hd, shape), worst)
            # every launch took its dtype's route: bf16 the wgmma and mma
            # kernels, fp32 the 3xTF32 kernels
            mma = sum(hd not in kernels.TF32X3_WGMMA_HEAD_DIMS for hd, _ in flash_cases)
            want = expected(kernels, dname, flash_attention=len(flash_cases),
                            flash_attention_tf32x3_mma=mma if dname == 'fp32' else 0,
                            cross_attention_acc=2 * len(acc_cases),
                            cross_attention_probs=4 * len(probs_cases))
            got = {name: n - before[name] for name, n in kernels.launches.items()}
            check(got == want, f'{dtype} {layout} launch counts {got}')
    return worst


def ptxas_report(log: str) -> dict:
    """The ``-Xptxas -v`` stack/spill and register lines, by (mangled)
    kernel name."""
    report, name = {}, None
    for line in log.splitlines():
        m = re.search(r'Function properties for (\S+)', line)
        if m:
            name = m.group(1)
        elif name and ('spill' in line or 'registers' in line):
            report.setdefault(name, []).append(line.split(':', 1)[-1].strip())
    return report


def tiny_reference(A, StableDiffusionPipeline, trace, preset):
    """Phase 3: kernels against the plain path on a tiny preset."""
    import torch

    pipe = StableDiffusionPipeline.from_pretrained(preset, device='cuda')
    results = {}
    for mode in ('torch', 'auto'):
        A.set_kernel_mode(mode)
        try:
            with trace(pipe) as tc:
                gen = torch.Generator(device='cuda').manual_seed(0)
                out = pipe(PROMPT, num_inference_steps=3, generator=gen,
                           output_type='np')
                results[mode] = (out.images[0],
                                 tc.compute_global_heat_map().heat_maps)
        finally:
            A.set_kernel_mode('auto')
    (im_p, map_p), (im_k, map_k) = results['torch'], results['auto']
    im_err = float(abs(im_k - im_p).max())
    rho = min(spearman(map_k[t], map_p[t]) for t in range(map_k.shape[0]))
    map_err = (map_k - map_p).abs().max().item() / map_p.abs().max().item()
    print(f'{preset} reference (fp32, kernels vs plain): image max_abs_err={im_err:.3e} '
          f'heat-map min spearman={rho:.6f} max rel err={map_err:.3e}')
    check(im_err <= 1e-3 and rho >= 0.999, f'{preset} kernel path vs plain path')

    # fp32 save -> load of the same prompt, kernels against the plain path
    pipe.heads_dtype = torch.float32
    replay = {}
    for mode in ('torch', 'auto'):
        A.set_kernel_mode(mode)
        try:
            out_s, tc = pipe_call(pipe, True, trace, steps=3, save_heads=True,
                                  persist_heads=False, data_dir=f'{preset}-{mode}')
            out_l, _ = pipe_call(pipe, True, trace, steps=3, load_heads=True,
                                 data_dir=f'{preset}-{mode}')
            replay[mode] = (tc.replay_buffer(3), out_s.images[0], out_l.images[0])
        finally:
            A.set_kernel_mode('auto')
    (buf_p, save_p, load_p), (buf_k, save_k, load_k) = replay['torch'], replay['auto']
    buf_err = max((buf_k[n] - buf_p[n]).abs().max().item() for n in buf_p)
    im_err = max(float(abs(save_k - save_p).max()), float(abs(load_k - load_p).max()))
    print(f'{preset} save/load (fp32 heads, kernels vs plain): {len(buf_k)} layers, '
          f'buffer max_abs_err={buf_err:.3e}, image max_abs_err={im_err:.3e}, '
          f'replayed vs saved image max_abs_err={float(abs(load_k - save_k).max()):.3e}')
    check(sorted(buf_k) == sorted(buf_p) and buf_err <= 1e-5 and im_err <= 1e-3,
          f'{preset} save/load kernel path vs plain path')


def pipe_call(pipe, traced: bool, trace, steps: int = STEPS,
              prompt=PROMPT, seeds=None, **trace_kwargs):
    """One pipeline call of ``prompt`` (a list: a batch, with one generator
    per prompt seeded from ``seeds``; else one generator seeded 0), inside
    ``trace(pipe, **trace_kwargs)`` if ``traced``; returns (output, tracer
    or None)."""
    import torch

    gen = (torch.Generator(device=pipe.device).manual_seed(0) if seeds is None else
           [torch.Generator(device=pipe.device).manual_seed(s) for s in seeds])
    if not traced:
        return pipe(prompt, num_inference_steps=steps, generator=gen, output_type='np'), None
    with trace(pipe, **trace_kwargs) as tc:
        out = pipe(prompt, num_inference_steps=steps, generator=gen, output_type='np')
    return out, tc


def event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_PROFILER_WARM = False


def device_times(calls, iters: int = 20):
    """Device time per call of each ``(label, fn)``, in ms, and the number
    of device kernels a call ran: ``iters`` calls of each under one
    torch.profiler session, each label's calls in a ``record_function``
    range, and every kernel credited to the label whose device-side range
    it starts in.  (One session: on the card, a long series of sessions
    was seen to stop recording kernels.)"""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    global _PROFILER_WARM
    if not _PROFILER_WARM:
        # a throwaway session first: the first launches of a process's
        # first session were seen to go unrecorded (16 of a label's 20)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for _, fn in calls:
                fn()
            torch.cuda.synchronize()
        _PROFILER_WARM = True
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # one unlabeled call of each first: a later session, too, was seen
        # to drop the first label's first launches (16 of 20)
        for _, fn in calls:
            fn()
        for label, fn in calls:
            torch.cuda.synchronize()
            with record_function(label):
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
    labels = {label for label, _ in calls}
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    ranges = {e.name: e.time_range for e in device if e.name in labels}
    check(len(ranges) == len(labels), f'device ranges of {sorted(labels - set(ranges))} '
          f'missing from the profile')
    out = {}
    for label in ranges:
        r = ranges[label]
        ran = [e for e in device if e.name not in labels
               and r.start <= e.time_range.start < r.end]
        check(bool(ran), f'no device kernels profiled for {label}')
        out[label] = (sum(e.time_range.elapsed_us() for e in ran) / iters / 1e3,
                      len(ran) / iters)
    return out


def bound(name, shape, dtype='bf16', hd=HD):
    """(ms, 'bytes' or 'operations'): the least time of one launch on an
    H100 SXM, each input read once and each output written once.  q, k, v
    and o move in ``dtype``; the FLOP (4·B·H·Lq·Lk·hd) run at the dense bf16
    rate, or for fp32 as three TF32 products (3xTF32) at the dense TF32
    rate."""
    B, H, Lq, Lk = shape
    size = 2 if dtype == 'bf16' else 4
    nbytes = size * B * H * (2 * Lq + 2 * Lk) * hd  # q, o, k, v
    if name == 'cross_attention_acc':
        nbytes += 2 * 4 * B * H * Lk * Lq  # the accumulator read and written
    elif name == 'cross_attention_probs':
        nbytes += 4 * B * H * Lq * Lk      # fp32 P, as the save run writes it
    t_bytes = nbytes / (HBM_TB_S * 1e12) * 1e3
    flop = 4 * B * H * Lq * Lk * hd
    t_ops = (flop / (BF16_PEAK_TFLOPS * 1e12) if dtype == 'bf16'
             else 3 * flop / (TF32_PEAK_TFLOPS * 1e12)) * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def padded_work(kernels, name, dtype, hd, shape) -> float:
    """The tensor-core work of a route over the work its bound counts (4 ·
    B·H·Lq·Lk·hd FLOP): bf16 flash_attention (wgmma) runs S = Q Kᵀ on hd
    rounded up to its k16 step and O = P V on whole 64-column panels past
    hd 32; bf16 K1 and K5 (mma.sync m16n8k16) run both products on hd
    rounded up to 16; the fp32 routes (3xTF32, k8 steps) on hd itself, and
    fp32 flash_attention on whole 128-query blocks and whole key tiles
    (wgmma: 64 keys, 32 at hd 80; mma.sync: 64, 32 at hd 128, 16 at 160)."""
    def up(x, step):
        return -(-x // step) * step
    if dtype == 'fp32':
        if name != 'flash_attention':
            return 1.0
        _, _, Lq, Lk = shape
        if hd in getattr(kernels, 'TF32X3_WGMMA_HEAD_DIMS', ()):  # not in older checkouts
            bk = 64 if hd <= 64 else 32
        else:
            bk = 16 if hd > 128 else 32 if hd == 128 else 64
        return up(Lq, 128) * up(Lk, bk) / (Lq * Lk)
    if name == 'flash_attention':
        return (up(hd, 16) + (hd if hd in (16, 32) else up(hd, 64))) / (2 * hd)
    return up(hd, 16) / hd


def core_bound(shape, hd=HD) -> float:
    """ms of one launch's FLOP at the fp32 rate of the CUDA cores."""
    B, H, Lq, Lk = shape
    return 4 * B * H * Lq * Lk * hd / (FP32_CORE_TFLOPS * 1e12) * 1e3


def _at_hd(shapes, hd=HD):
    return [(shape, per_eval, hd) for shape, per_eval in shapes]


#: (B, H, Lq, Lk), launches per UNet evaluation and head dim, by kernel, of
#: each path phase 6b times
PATH_SHAPES = {
    'v2-1-base': (('flash_attention', _at_hd(K2_SHAPES)),
                  ('cross_attention_acc', _at_hd(K1_SHAPES)),
                  ('cross_attention_probs', _at_hd(K5_SHAPES))),
    'xl-base-1.0': (('flash_attention', _at_hd(SDXL_K2_SHAPES)),
                    ('cross_attention_acc', _at_hd(SDXL_K1_SHAPES)),
                    ('cross_attention_probs', _at_hd(SDXL_K5_SHAPES))),
    'v1': (('flash_attention', V1_K2_SHAPES), ('cross_attention_acc', V1_K1_SHAPES),
           ('cross_attention_probs', V1_K5_SHAPES)),
    'v2-1-large': (('flash_attention', _at_hd(V2L_K2_SHAPES)),
                   ('cross_attention_acc', _at_hd(V2L_K1_SHAPES)),
                   ('cross_attention_probs', _at_hd(V2L_K5_SHAPES))),
    # v2-1-base at a batch of 4 prompts (phase 12)
    'v2-1-base b4': tuple((name, [((BATCH * shape[0], *shape[1:]), n, hd)
                                  for shape, n, hd in _at_hd(shapes)])
                          for name, shapes in (('flash_attention', K2_SHAPES),
                                               ('cross_attention_acc', K1_SHAPES),
                                               ('cross_attention_probs', K5_SHAPES)))}


def kernel_times(kernels, A, model, dtype='bf16'):
    """Phase 6b: every kernel at every shape of ``model``'s path in
    ``dtype`` ('bf16' or 'fp32', TF32 off for the plain versions and SDPA)
    against its plain version, its bound and, for flash_attention, SDPA;
    returns the totals per UNet evaluation by kernel."""
    import torch

    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _kernel_times(kernels, A, model, dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _kernel_times(kernels, A, model, dtype):
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device='cuda').manual_seed(1)
    tdtype = torch.bfloat16 if dtype == 'bf16' else torch.float32
    rows, calls = [], []
    for name, shapes in PATH_SHAPES[model]:
        for shape, per_eval, hd in shapes:
            q, k, v = qkv(*shape, 'packed', tdtype, gen, hd)
            lib = None
            if name == 'flash_attention':
                kern = lambda q=q, k=k, v=v: kernels.flash_attention(q, k, v)  # noqa: E731
                plain = lambda q=q, k=k, v=v: A.flash_attention_plain(q, k, v)  # noqa: E731
                lib = lambda q=q, k=k, v=v: F.scaled_dot_product_attention(  # noqa: E731
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
            elif name == 'cross_attention_probs':  # the 'full' capture
                kern = lambda q=q, k=k, v=v: kernels.cross_attention_probs(q, k, v)  # noqa: E731
                plain = lambda q=q, k=k, v=v: A.cross_attention_probs_plain(q, k, v)  # noqa: E731
            else:
                B, H, Lq, Lk = shape
                acc = torch.zeros(B, H, Lk, Lq, device='cuda')
                kern = lambda q=q, k=k, v=v, acc=acc: kernels.cross_attention_acc(  # noqa: E731
                    q, k, v, acc)
                plain = lambda q=q, k=k, v=v, acc=acc: A.cross_attention_acc_plain(  # noqa: E731
                    q, k, v, acc)
            # plain, kernel, kernel, plain: the card's clocks drift in a run
            p1, k1, k2, p2 = (event_ms(f) for f in (plain, kern, kern, plain))
            row = {'name': name, 'shape': shape, 'per_eval': per_eval, 'hd': hd,
                   'ms': (k1 + k2) / 2, 'plain_ms': (p1 + p2) / 2,
                   'bound': bound(name, shape, dtype, hd), 'lib_ms': None}
            calls.append((f'{name} {dtype} {shape}', kern))
            if lib is not None:
                row['lib_ms'] = (event_ms(lib) + event_ms(lib)) / 2
                calls.append((f'sdpa {dtype} {shape}', lib))
            rows.append(row)
    dev = device_times(calls)
    peak = BF16_PEAK_TFLOPS if dtype == 'bf16' else TF32_PEAK_TFLOPS / 3
    totals = {}
    for row in rows:
        name, shape, per_eval, hd = row['name'], row['shape'], row['per_eval'], row['hd']
        d_ms, n_kernels = dev[f'{name} {dtype} {shape}']
        # fp32 flash_attention on wgmma: the split of K and V, then the
        # attention (kernels of older checkouts: one kernel a call)
        want_kernels = 2 if (name == 'flash_attention' and dtype == 'fp32' and hd in getattr(
            kernels, 'TF32X3_WGMMA_HEAD_DIMS', ())) else 1
        check(n_kernels == want_kernels, f'{name} {shape}: {n_kernels} device kernels a call')
        (b_ms, by) = row['bound']
        tot = totals.setdefault(name, {'ms': 0.0, 'device_ms': 0.0, 'plain_ms': 0.0,
                                       'bound_ms': 0.0, 'core_bound_ms': 0.0,
                                       'library_ms': None, 'library_device_ms': None,
                                       'by': {'bytes': 0.0, 'operations': 0.0}})
        for key, val in (('ms', row['ms']), ('device_ms', d_ms),
                         ('plain_ms', row['plain_ms']), ('bound_ms', b_ms),
                         ('core_bound_ms', core_bound(shape, hd))):
            tot[key] += val * per_eval
        tot['by'][by] += b_ms * per_eval
        extra = ''
        if dtype == 'fp32':
            extra = f' CUDA-core bound={core_bound(shape, hd):.5f} ms;'
        if row['lib_ms'] is not None:
            lib_dev = dev[f'sdpa {dtype} {shape}'][0]
            tot['library_ms'] = (tot['library_ms'] or 0.0) + row['lib_ms'] * per_eval
            tot['library_device_ms'] = (tot['library_device_ms'] or 0.0) + lib_dev * per_eval
            B, H, Lq, Lk = shape
            tflops = 4 * B * H * Lq * Lk * hd / d_ms / 1e9
            extra += (f' sdpa={row["lib_ms"]:.4f} ms (device {lib_dev:.4f}); '
                      f'{tflops:.1f} TFLOP/s on the device, '
                      f'{100 * tflops / peak:.1f}% of the {dtype} peak')
        work = padded_work(kernels, name, dtype, hd, shape)
        if work != 1.0:  # the bound counts hd, Lq, Lk; the products run on more
            extra += f' padded products: {work:.2f}x the bound\'s FLOP;'
        print(f'time {model} {name:21s} {dtype} B,H,Lq,Lk={shape} hd={hd} x{per_eval}/eval '
              f'event={row["ms"]:.4f} ms device={d_ms:.4f} ms '
              f'plain={row["plain_ms"]:.4f} ms bound={b_ms:.5f} ms ({by}), '
              f'{100 * b_ms / d_ms:.1f}% of the device time;{extra}')
    for name, tot in totals.items():
        lib = (f' sdpa={tot["library_ms"]:.4f} ms (device '
               f'{tot["library_device_ms"]:.4f})' if tot['library_ms'] else '')
        core = (f' CUDA-core bound={tot["core_bound_ms"]:.5f} ms'
                if dtype == 'fp32' else '')
        print(f'time {model} {name:21s} {dtype} per UNet evaluation: '
              f'event={tot["ms"]:.4f} ms device={tot["device_ms"]:.4f} ms '
              f'plain={tot["plain_ms"]:.4f} ms bound={tot["bound_ms"]:.5f} ms'
              f'{core}{lib}')
    return totals


def geglu_times(kernels, model, dtype='bf16'):
    """Phase 6b's K8: ``kernels.geglu`` at every feed-forward shape of
    ``model``'s path in ``dtype`` against its plain version (the former
    chain ``h * F.gelu(gate.float()).to(h.dtype)``), which it must equal bit
    for bit, in one device kernel a call.  Each side cycles through enough
    copies of its input that every call reads it from device memory, not
    from the 50 MB L2, as the pipeline's first read of a projection output
    larger than L2 does.  Prints the event time, the device time, the plain
    chain's time and the bound (the (rows, 2w) input read once and the (rows,
    w) output written once, over 3.35 TB/s) of each shape and their totals
    per UNet evaluation."""
    import itertools

    import torch
    from daam_tpu_torch.ops.geglu import geglu_plain

    tdtype = torch.bfloat16 if dtype == 'bf16' else torch.float32
    size = 2 if dtype == 'bf16' else 4
    gen = torch.Generator(device='cuda').manual_seed(2)
    rows_out, calls = [], []
    for (rows, w), per_eval in GEGLU_SHAPES[model]:
        copies = max(2, -(-200 * 2 ** 20 // (rows * 2 * w * size)))
        xs = [torch.randn(rows, 2 * w, device='cuda', generator=gen).to(tdtype)
              for _ in range(copies)]
        for x in xs:
            check(torch.equal(kernels.geglu(x), geglu_plain(x)),
                  f'geglu {dtype} {(rows, w)}: the kernel is not the chain bit for bit')
        ring = itertools.cycle(xs)
        kern = lambda ring=ring: kernels.geglu(next(ring))  # noqa: E731
        plain = lambda ring=ring: geglu_plain(next(ring))  # noqa: E731
        # plain, kernel, kernel, plain: the card's clocks drift in a run
        p1, k1, k2, p2 = (event_ms(f) for f in (plain, kern, kern, plain))
        label = f'geglu {dtype} {(rows, w)}'
        calls.append((label, kern))
        bound_ms = 3 * rows * w * size / (HBM_TB_S * 1e12) * 1e3
        rows_out.append((label, (rows, w), per_eval, (k1 + k2) / 2, (p1 + p2) / 2, bound_ms))
    dev = device_times(calls)
    tot = {'ms': 0.0, 'device_ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0}
    for label, shape, per_eval, ms, plain_ms, bound_ms in rows_out:
        d_ms, n_kernels = dev[label]
        check(n_kernels == 1, f'{label}: {n_kernels} device kernels a call')
        for key, val in (('ms', ms), ('device_ms', d_ms), ('plain_ms', plain_ms),
                         ('bound_ms', bound_ms)):
            tot[key] += val * per_eval
        print(f'time {model} geglu {dtype} rows,w={shape} x{per_eval}/eval '
              f'event={ms:.4f} ms device={d_ms:.4f} ms plain={plain_ms:.4f} ms '
              f'bound={bound_ms:.5f} ms (bytes), {100 * bound_ms / d_ms:.1f}% of the '
              f'device time')
    print(f'time {model} geglu {dtype} per UNet evaluation: event={tot["ms"]:.4f} ms '
          f'device={tot["device_ms"]:.4f} ms plain={tot["plain_ms"]:.4f} ms '
          f'bound={tot["bound_ms"]:.5f} ms')


def transplant(pipe, trace, kernels, label: str, dtype: str, steps: int = STEPS,
               k5: int = K5_PER_EVAL, k2: int = K2_PER_EVAL_REPLAY,
               other_prompt: bool = True, prompts=None, seeds=None, mma: int = 0,
               ff: int = FF_PER_EVAL) -> dict:
    """A save_heads -> load_heads pair at full width, ``steps`` steps each
    (phases 5, 7, 9, 10, 12 and 13): the save run's counters (``k5``
    cross_attention_probs and ``k2`` flash_attention launches per UNet
    evaluation on the ``dtype`` route, ``mma`` of those on fp32 K2's
    mma.sync kernel, ``ff`` geglu, nothing else) and its buffer (``k5`` layers of (evaluations, 2b,
    H, h·w, 77) bf16 for a batch of b prompts, finite, rows summing to 1
    within 1e-2; PNDM evaluates ``steps + 1`` times); the load run of the
    same prompts (``k2`` flash_attention and ``ff`` geglu per evaluation and
    nothing else),
    whose per-token heat maps must match the save run's at Spearman ≥ 0.999,
    prompt by prompt; with ``other_prompt``, a load run of a second prompt,
    whose image must differ from a fresh run of it.  ``prompts`` and
    ``seeds``: a batch of prompts, one generator each (else ``PROMPT`` from
    seed 0).  Returns the save run's launch counts."""
    import numpy as np
    import torch
    from daam_tpu_torch.trace import release_heads

    data_dir = f'smoke {label}'
    evals = pipe.scheduler.num_scan_steps(steps)
    batch = list(prompts or [PROMPT])

    def run(prompt, **trace_kwargs):
        kernels.reset_launches()
        out, tc = pipe_call(pipe, True, trace, steps=steps, prompt=prompt,
                            seeds=seeds, data_dir=data_dir, **trace_kwargs)
        launches = dict(kernels.launches)
        print(f'{label} {list(trace_kwargs)[0]} run {prompt!r}: launches {launches}')
        return out.images[0], tc, launches

    prompt = batch if prompts else PROMPT
    image_s, tc_s, save_launches = run(prompt, save_heads=True, persist_heads=False)
    check(save_launches == expected(kernels, dtype, cross_attention_probs=k5 * evals,
                                    flash_attention=k2 * evals,
                                    flash_attention_tf32x3_mma=mma * evals,
                                    geglu=ff * evals),
          f'{label} save run launch counts {save_launches}')
    buf = tc_s.replay_buffer(evals)
    check(len(buf) == k5, f'{label}: {len(buf)} layers in the replay buffer')
    nbytes = 0
    latent = pipe.config.image_size // pipe.vae_scale_factor
    for name, arr in buf.items():
        info = pipe._layout[name]
        hw = (latent // info.downscale) ** 2
        check(tuple(arr.shape) == (evals, 2 * len(batch), info.heads, hw, 77)
              and arr.dtype == torch.bfloat16, f'{name}: {tuple(arr.shape)}')
        a = arr.to(pipe.device).float()
        row_err = (a.sum(-1) - 1).abs().max().item()
        check(bool(torch.isfinite(a).all()) and row_err <= 1e-2,
              f'{name}: finite rows summing to 1 (max err {row_err:.3e})')
        nbytes += arr.numel() * arr.element_size()
    print(f'{label} replay buffer: {len(buf)} layers of {evals} evaluations, '
          f'{nbytes / evals / 1e6:.1f} MB of bf16 per evaluation, rows sum to 1 '
          f'within 1e-2')

    image_l, tc_l, load_launches = run(prompt, load_heads=True)
    check(load_launches == expected(kernels, dtype, flash_attention=k2 * evals,
                                    flash_attention_tf32x3_mma=mma * evals,
                                    geglu=ff * evals),
          f'{label} load run launch counts {load_launches}')
    for i in range(len(batch)):
        map_s = tc_s.compute_global_heat_map(batch_idx=i).heat_maps
        map_l = tc_l.compute_global_heat_map(batch_idx=i).heat_maps
        rhos = [spearman(map_l[t], map_s[t]) for t in range(map_s.shape[0])]
        print(f'{label} load vs save run, same prompt {i}: per-token heat-map '
              f'spearman min {min(rhos):.6f} over {len(rhos)} tokens; first image '
              f'max_abs_err {float(abs(image_l - image_s).max()):.3e}')
        check(min(rhos) >= 0.999, f'{label} replayed heat maps match the saved run')

    if other_prompt:
        image_t, _, _ = run(PROMPT2, load_heads=True)
        fresh, _ = pipe_call(pipe, False, trace, steps=steps, prompt=PROMPT2)
        diff = float(abs(image_t - fresh.images[0]).mean())
        print(f'{label} transplant into {PROMPT2!r} vs a fresh run of it: mean abs '
              f'diff {diff:.4e}')
        check(bool(np.isfinite(image_t).all()) and diff > 1e-3,
              'the transplanted image differs from a fresh run')
    release_heads(data_dir)
    return save_launches


def sdxl_full_width(StableDiffusionPipeline, trace, kernels, A):
    """Phase 7: xl-base-1.0 at full width in bf16, then one step in fp32,
    each with its save -> load transplant; returns the launch counts of the
    bf16 traced run and of the fp32 kernel step, cross_attention_probs's
    from the save run of the same dtype."""
    import torch

    pipe = StableDiffusionPipeline.from_pretrained('xl-base-1.0', device='cuda',
                                                   dtype=torch.bfloat16)
    n_params = sum(p.numel() for m in (pipe.unet, pipe.text_encoder,
                                       pipe.text_encoder_2, pipe.vae)
                   for p in m.parameters())
    print(f'xl-base-1.0 (random weights, bf16): {type(pipe).__name__}, '
          f'{n_params / 1e9:.3f} B parameters, '
          f'{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated')
    check(type(pipe).__name__ == 'StableDiffusionXLPipeline', 'the SDXL class')

    decodes = []  # the input shape of every VAE decoder call
    vae_decode = pipe.vae.decode

    def recording_decode(z):
        decodes.append(tuple(z.shape))
        return vae_decode(z)
    pipe.vae.decode = recording_decode

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    out, tc = pipe_call(pipe, True, trace)
    launches = dict(kernels.launches)
    print(f'xl-base-1.0 main path launches: {launches}')
    print(f'xl-base-1.0 VAE decoder calls {decodes}; peak memory '
          f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB')
    check_traced(out, tc, 1024, 'xl-base-1.0')
    check(decodes == [SDXL_TILES], f'tiled VAE decode: decoder calls {decodes}')
    check(launches == expected(kernels, 'bf16', cross_attention_acc=SDXL_K1_PER_EVAL * STEPS,
                               flash_attention=SDXL_K2_PER_EVAL * STEPS,
                               geglu=SDXL_FF_PER_EVAL * STEPS),
          f'xl-base-1.0 launch counts {launches}')
    one_step_maps(pipe, trace, kernels, A, 'bf16', 0.99)
    launches['cross_attention_probs'] = sdxl_transplant(pipe, trace, kernels, 'bf16')
    del pipe, tc, out
    gc.collect()
    torch.cuda.empty_cache()

    # fp32, with TF32 off: do the bf16 maps' 0.993 come from bf16 rounding?
    pipe = StableDiffusionPipeline.from_pretrained('xl-base-1.0', device='cuda')
    print(f'xl-base-1.0 (random weights, fp32): '
          f'{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated')
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        launches_fp32 = one_step_maps(pipe, trace, kernels, A, 'fp32', 0.999)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    check(launches_fp32 == expected(kernels, 'fp32', cross_attention_acc=SDXL_K1_PER_EVAL,
                                    flash_attention=SDXL_K2_PER_EVAL,
                                    geglu=SDXL_FF_PER_EVAL),
          f'xl-base-1.0 fp32 step launch counts {launches_fp32}')
    launches_fp32['cross_attention_probs'] = sdxl_transplant(pipe, trace, kernels, 'fp32')
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return launches, launches_fp32


def sdxl_transplant(pipe, trace, kernels, dtype: str) -> int:
    """SDXL's save -> load pair, SDXL_REPLAY_STEPS steps each (about 1 GB
    of bf16 P reaches the host); returns the save run's
    cross_attention_probs launches."""
    save = transplant(pipe, trace, kernels, f'xl-base-1.0 {dtype}', dtype,
                      steps=SDXL_REPLAY_STEPS, k5=SDXL_K5_PER_EVAL,
                      k2=SDXL_K2_PER_EVAL_REPLAY, other_prompt=False,
                      ff=SDXL_FF_PER_EVAL)
    return save['cross_attention_probs']


def one_step_maps(pipe, trace, kernels, A, label: str, gate: float) -> dict:
    """One traced step through the kernels and one through the plain
    versions, from the same latents (the same generator seed): their global
    heat maps must agree at per-token Spearman >= ``gate``.  Returns the
    kernel step's launch counts."""
    maps = {}
    for mode in ('auto', 'torch'):
        A.set_kernel_mode(mode)
        kernels.reset_launches()
        try:
            _, tc = pipe_call(pipe, True, trace, steps=1)
        finally:
            A.set_kernel_mode('auto')
        if mode == 'auto':
            launches = dict(kernels.launches)
        maps[mode] = tc.compute_global_heat_map().heat_maps
    rhos = [spearman(maps['auto'][t], maps['torch'][t])
            for t in range(maps['auto'].shape[0])]
    print(f'{pipe.config.name} {label}, one traced step, kernels vs plain: per-token '
          f'heat-map spearman min {min(rhos):.6f} over {len(rhos)} tokens')
    check(min(rhos) >= gate, f'{pipe.config.name} {label} kernel maps vs plain maps')
    return launches


def fp32_main_path(StableDiffusionPipeline, trace, kernels) -> dict:
    """Phase 9: what ``daam-torch "A dog runs across the field."`` runs by
    default, v2-1-base in fp32 at 512²: a traced 10-step run, then the
    save -> load transplant (``--save-heads``, ``--load-heads``), every K1,
    K2 and K5 launch on the 3xTF32 kernels.  Returns the launch counts of
    the traced run, K5's from the save run."""
    import torch

    pipe = StableDiffusionPipeline.from_pretrained('v2-1-base', device='cuda')
    check(pipe.dtype == torch.float32, f'default dtype {pipe.dtype}')
    kernels.reset_launches()
    out, tc = pipe_call(pipe, True, trace)
    launches = dict(kernels.launches)
    print(f'fp32 main path launches: {launches}')
    check_traced(out, tc, 512, 'v2-1-base fp32')
    check(launches == expected(kernels, 'fp32', cross_attention_acc=K1_PER_EVAL * STEPS,
                               flash_attention=K2_PER_EVAL * STEPS,
                               geglu=FF_PER_EVAL * STEPS),
          f'fp32 launch counts {launches}')
    launches['cross_attention_probs'] = transplant(
        pipe, trace, kernels, 'v2-1-base fp32', 'fp32',
        other_prompt=False)['cross_attention_probs']
    del pipe, tc, out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def v1_full_width(StableDiffusionPipeline, trace, kernels):
    """Phase 10: SD 1.x (``v1``, 8 heads at hd 40/80/160) at 512², random
    weights from seed 0.  fp32 with DDIM, what ``daam-torch --model v1``
    runs: a traced 10-step run (15 × 10 K1 and 32 × 10 K2 on the 3xTF32
    route), the fp32 save -> load transplant (16 × 10 K5).  bf16 with PNDM,
    SD 1.x's published scheduler: a traced run of 10 steps, 11 UNet
    evaluations (15 × 11 K1 and 32 × 11 K2 on the bf16 routes), its save ->
    load pair (a buffer of 11 evaluations).  Returns the launch counts of
    the fp32 and the bf16 traced runs, K5's from the save run of the same
    dtype."""
    import torch

    runs = {}
    for dtype, sched in (('fp32', 'ddim'), ('bf16', 'pndm')):
        pipe = StableDiffusionPipeline.from_pretrained(
            'v1', device='cuda', scheduler=sched,
            dtype=torch.bfloat16 if dtype == 'bf16' else torch.float32)
        label = f'v1 512^2 {dtype} {sched}'
        evals = pipe.scheduler.num_scan_steps(STEPS)
        print(f'{label}: {type(pipe.scheduler).__name__}, {evals} UNet evaluations '
              f'for {STEPS} steps')
        kernels.reset_launches()
        out, tc = pipe_call(pipe, True, trace)
        launches = dict(kernels.launches)
        print(f'{label} launches: {launches}')
        check_traced(out, tc, 512, label)
        # hd 160's K2 calls take fp32 K2's mma.sync kernel
        mma = v1_mma_per_eval(kernels) if dtype == 'fp32' else 0
        check(launches == expected(kernels, dtype, cross_attention_acc=K1_PER_EVAL * evals,
                                   flash_attention=K2_PER_EVAL * evals,
                                   flash_attention_tf32x3_mma=mma * evals,
                                   geglu=FF_PER_EVAL * evals),
              f'{label} launch counts {launches}')
        launches['cross_attention_probs'] = transplant(
            pipe, trace, kernels, label, dtype, other_prompt=False,
            mma=v1_mma_per_eval(kernels, replay=True) if dtype == 'fp32' else 0
        )['cross_attention_probs']
        runs[dtype] = launches
        del pipe, tc, out
        gc.collect()
        torch.cuda.empty_cache()
    return runs['fp32'], runs['bf16']


# --------------------------------------------------------------------------
# phase 11: a checkpoint directory on disk, the VAE encoder, the evaluation
# --------------------------------------------------------------------------

_SAFETENSORS_NAMES = {'float16': 'F16', 'bfloat16': 'BF16', 'float32': 'F32'}


def write_safetensors(path, tensors):
    """A ``.safetensors`` file: the 8-byte little-endian header length, the
    JSON header (padded to 8 bytes), then each tensor's raw bytes."""
    import struct

    import torch

    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {'dtype': _SAFETENSORS_NAMES[str(t.dtype).split('.')[-1]],
                        'shape': list(t.shape), 'data_offsets': [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b' ' * (-len(raw) % 8)
    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(raw)) + raw)
        for t in tensors.values():
            f.write(t.detach().contiguous().cpu().view(-1).view(torch.uint8).numpy().data)


def diffusers_configs(config) -> dict:
    """The ``config.json`` of each module of ``config`` in diffusers' keys,
    and the scheduler's (what ``load_diffusers_checkpoint`` reads)."""
    u, v = config.unet, config.vae

    def clip(t):
        return {'architectures': ['CLIPTextModelWithProjection' if t.projection_dim
                                  else 'CLIPTextModel'],
                'vocab_size': t.vocab_size, 'hidden_size': t.hidden_size,
                'intermediate_size': t.intermediate_size,
                'num_hidden_layers': t.num_hidden_layers,
                'num_attention_heads': t.num_attention_heads,
                'max_position_embeddings': t.max_position_embeddings,
                'hidden_act': t.hidden_act, 'layer_norm_eps': t.layer_norm_eps,
                'projection_dim': t.projection_dim}
    return {
        'unet': {'sample_size': u.sample_size, 'in_channels': u.in_channels,
                 'out_channels': u.out_channels,
                 'block_out_channels': list(u.block_out_channels),
                 'down_block_types': ['CrossAttnDownBlock2D' if t == 'cross'
                                      else 'DownBlock2D' for t in u.down_block_types],
                 'up_block_types': ['CrossAttnUpBlock2D' if t == 'cross' else 'UpBlock2D'
                                    for t in reversed(u.up_block_types)],
                 'layers_per_block': u.layers_per_block,
                 'attention_head_dim': list(u.attention_head_dim),
                 'transformer_layers_per_block': list(u.transformer_layers_per_block),
                 'cross_attention_dim': u.cross_attention_dim,
                 'use_linear_projection': u.use_linear_projection,
                 'norm_num_groups': u.norm_num_groups, 'freq_shift': u.freq_shift,
                 'flip_sin_to_cos': u.flip_sin_to_cos,
                 'mid_block_type': ('UNetMidBlock2DCrossAttn' if u.mid_block_attn
                                    else 'UNetMidBlock2D'),
                 'addition_embed_type': u.addition_embed_type,
                 'addition_time_embed_dim': u.addition_time_embed_dim,
                 'projection_class_embeddings_input_dim':
                     u.projection_class_embeddings_input_dim},
        'text_encoder': clip(config.text),
        'vae': {'in_channels': v.in_channels, 'out_channels': v.out_channels,
                'latent_channels': v.latent_channels,
                'block_out_channels': list(v.block_out_channels),
                'layers_per_block': v.layers_per_block,
                'norm_num_groups': v.norm_num_groups, 'sample_size': v.sample_size,
                'scaling_factor': v.scaling_factor},
        'scheduler': {'prediction_type': config.prediction_type}}


def write_checkpoint_dir(root, config, modules):
    """v2-1-base as a diffusers directory: ``unet/`` and ``vae/`` as fp16
    ``.safetensors`` (the VAE with its encoder, its mid-block attention
    under the legacy ``query/key/value/proj_attn`` names with 1×1 conv
    weights), ``text_encoder/`` as an fp16 ``.bin``, each ``config.json``,
    ``scheduler/scheduler_config.json`` and ``tokenizer/``; returns the bytes
    of the weights."""
    import os
    import shutil

    import torch
    from daam_tpu_torch.tokenization import BUNDLED_VOCAB_DIR

    legacy = {'to_q': 'query', 'to_k': 'key', 'to_v': 'value', 'to_out.0': 'proj_attn'}
    vae = {}
    for k, t in modules['vae'].state_dict().items():
        m = re.fullmatch(r'((?:en|de)coder\.mid_block\.attentions\.0\.)'
                         r'(to_q|to_k|to_v|to_out\.0)\.(weight|bias)', k)
        if m:
            k = f'{m.group(1)}{legacy[m.group(2)]}.{m.group(3)}'
            t = t[:, :, None, None] if t.ndim == 2 else t
        vae[k] = t.half()
    for name, payload in diffusers_configs(config).items():
        os.makedirs(os.path.join(root, name))
        fname = 'scheduler_config.json' if name == 'scheduler' else 'config.json'
        with open(os.path.join(root, name, fname), 'w') as f:
            json.dump(payload, f)
    write_safetensors(os.path.join(root, 'unet', 'diffusion_pytorch_model.safetensors'),
                      {k: t.half() for k, t in modules['unet'].state_dict().items()})
    write_safetensors(os.path.join(root, 'vae', 'diffusion_pytorch_model.safetensors'), vae)
    torch.save({k: t.half().cpu() for k, t in modules['text_encoder'].state_dict().items()},
               os.path.join(root, 'text_encoder', 'pytorch_model.bin'))
    os.makedirs(os.path.join(root, 'tokenizer'))
    for fname in ('vocab.json', 'merges.txt'):
        shutil.copy(BUNDLED_VOCAB_DIR / fname, os.path.join(root, 'tokenizer', fname))
    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root)
               for f in fs if f.endswith(('.safetensors', '.bin')))


def run_captured(main, argv) -> str:
    """``main(argv)`` with its standard output captured; returns it."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def checkpoint_and_evaluation(StableDiffusionPipeline, trace, kernels):
    """Phase 11: v2-1-base at full width (512², fp32, DDIM, 10 steps)
    through a checkpoint directory on disk, then its VAE encoder and the
    evaluation (what ``--from-path`` and ``daam-torch-evaluate`` run)."""
    import copy
    import os
    import tempfile

    import numpy as np
    import torch
    from daam_tpu_torch import evaluate as E
    from daam_tpu_torch.experiment import GenerationExperiment, _to_pil
    from daam_tpu_torch.models import weights as W
    from daam_tpu_torch.models.configs import get_pipeline_config
    from daam_tpu_torch.models.vae import AutoencoderKL
    from daam_tpu_torch.run import evaluate as evaluate_cli
    from daam_tpu_torch.run import generate as generate_cli

    config = get_pipeline_config('v2-1-base')
    gen = torch.Generator(device='cuda').manual_seed(0)
    modules = W.init_random(config, gen, device='cuda')
    # the full VAE: init_random's decoder and a random encoder
    with torch.device('meta'):
        vae = AutoencoderKL(config.vae)
    vae = vae.to_empty(device='cuda').eval()
    W.fill_random(vae.encoder, gen)
    W.fill_random(vae.quant_conv, gen)
    vae.decoder.load_state_dict(modules['vae'].decoder.state_dict())
    vae.post_quant_conv.load_state_dict(modules['vae'].post_quant_conv.state_dict())
    modules['vae'] = vae
    with torch.no_grad():  # the in-memory pipeline, rounded through fp16
        for module in modules.values():
            for t in module.state_dict().values():
                t.copy_(t.half().float())

    with tempfile.TemporaryDirectory(prefix='daam-smoke-') as tmp:
        ckpt = os.path.join(tmp, 'v2-1-base')
        t0 = time.perf_counter()
        nbytes = write_checkpoint_dir(ckpt, config, modules)
        print(f'checkpoint directory written: {nbytes / 1e9:.3f} GB of fp16 weights '
              f'in {time.perf_counter() - t0:.2f} s')

        # 2. load, and hold every tensor against the fp16-rounded modules
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = StableDiffusionPipeline.from_pretrained(ckpt, device='cuda',
                                                       dtype=torch.float32)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        print(f'checkpoint load (from_pretrained, {nbytes / 1e9:.3f} GB fp16 -> fp32 '
              f'on the card): {load_s:.3f} s')
        check(pipe.config is config, f'config resolved to {pipe.config.name}')
        n_tensors = 0
        for name, module in modules.items():
            ours, theirs = getattr(pipe, name).state_dict(), module.state_dict()
            check(sorted(ours) == sorted(theirs), f'{name}: the loaded keys')
            for k, t in theirs.items():
                check(ours[k].dtype == torch.float32 and torch.equal(ours[k], t),
                      f'{name}.{k} loads bit for bit')
                n_tensors += 1
        print(f'loaded pipeline: config {pipe.config.name}, {n_tensors} tensors equal '
              f'bit for bit to the in-memory modules rounded through fp16')

        # 3. daam-torch --from-path, in process
        root = os.path.join(tmp, 'eval')
        out_dir = os.path.join(root, 'exp0')
        kernels.reset_launches()
        t0 = time.perf_counter()
        generate_cli.main([PROMPT, '--from-path', ckpt, '-o', out_dir,
                           '-n', str(STEPS)])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        print(f'daam-torch --from-path ({STEPS} steps, load and artifacts included): '
              f'{cli_s:.3f} s; launches {launches}')
        check(launches == expected(kernels, 'fp32', cross_attention_acc=K1_PER_EVAL * STEPS,
                                   flash_attention=K2_PER_EVAL * STEPS,
                                   geglu=FF_PER_EVAL * STEPS, **png_launches(out_dir)),
              f'--from-path launch counts {launches}')
        cli_exp = GenerationExperiment.load(out_dir)
        prompt = PROMPT.replace('.', ' .')
        mem = StableDiffusionPipeline(config, **modules)
        out, tc = pipe_call(mem, True, trace, prompt=prompt)
        image = np.array(_to_pil(out.images[0]))
        mem_map = tc.compute_global_heat_map().heat_maps
        cli_map = torch.as_tensor(cli_exp.global_heat_map, device=mem_map.device)
        im_err = int(np.abs(image.astype(int) - np.array(cli_exp.image).astype(int)).max())
        rhos = [spearman(cli_map[t], mem_map[t]) for t in range(mem_map.shape[0])]
        print(f'--from-path vs the in-memory fp16-rounded pipeline: image max abs diff '
              f'{im_err}/255, per-token heat-map spearman min {min(rhos):.6f} over '
              f'{len(rhos)} tokens')
        check(im_err <= 2 and min(rhos) >= 0.999, '--from-path matches the in-memory run')

        # 4. the VAE encoder on the card and on the CPU, TF32 off
        x = torch.from_numpy(np.array(cli_exp.image)).permute(2, 0, 1)[None]
        x = x.float().div(127.5).sub(1.0)
        tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                post = pipe.vae.encode(x.cuda())
                enc_ms = event_ms(lambda: pipe.vae.encode(x.cuda()), iters=5, warmup=1)
                vae_cpu = copy.deepcopy(pipe.vae).cpu()
                t0 = time.perf_counter()
                post_cpu = vae_cpu.encode(x)
                cpu_s = time.perf_counter() - t0
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        errs = {k: ((getattr(post, k).cpu() - getattr(post_cpu, k)).abs().max()
                    / getattr(post_cpu, k).abs().max()).item() for k in ('mean', 'logvar')}
        print(f'VAE encode 512^2 fp32 (TF32 off): {enc_ms:.3f} ms on the card '
              f'(CUDA events, 5 calls), {cpu_s:.2f} s on the CPU; latent '
              f'{tuple(post.mean.shape)}; card vs CPU relative max abs err '
              f'mean {errs["mean"]:.3e} logvar {errs["logvar"]:.3e}')
        latent = config.image_size // config.vae.scale_factor
        check(tuple(post.mean.shape) == (1, 4, latent, latent) and max(errs.values()) <= 1e-3
              and bool(torch.isfinite(post.mean).all()), 'VAE encoder card vs CPU')
        del pipe, vae_cpu, post, post_cpu
        gc.collect()

        # 5. the evaluation: truth masks, predictions from the heat maps
        tokenizer = mem.tokenizer
        truths = {'exp0': (512, 512), 'exp1': (480, 640)}
        exp1 = tc.to_experiment(root, id='exp1', seed=0)
        exp1.image = _to_pil(out.images[0])
        exp1.save(heat_maps=False)
        rng = np.random.RandomState(0)
        for exp_id, (h, w) in truths.items():
            exp = GenerationExperiment.load(os.path.join(root, exp_id))
            heat = exp.heat_map(tokenizer)
            for word in ('dog', 'field'):
                mask = heat.compute_word_heat_map(word).expand_as(exp.image, threshold=0.4)
                exp.save_prediction_mask(mask, word, 'daam')
            exp.truth_masks = {}
            for word in ('dog', 'field', 'sky'):
                m = exp.truth_masks[word] = np.zeros((h, w), np.float32)
                y, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
                m[y:y + h // 2, x0:x0 + w // 2] = 1
            exp.save(heat_maps=False)
        reports = {}
        t0 = time.perf_counter()
        for device in ('cuda', 'cpu'):
            for kind in ('labeled', 'unlabeled', 'hungarian'):
                reports[device, kind] = run_captured(
                    evaluate_cli.main, ['-i', root, '-e', kind, '--device', device]
                ).strip().splitlines()[-1]
            if device == 'cuda':
                torch.cuda.synchronize()
                eval_s = time.perf_counter() - t0
        for kind in ('labeled', 'unlabeled', 'hungarian'):
            print(f'daam-torch-evaluate -e {kind}: cuda {reports["cuda", kind]!r} '
                  f'cpu {reports["cpu", kind]!r}')
            check(reports['cuda', kind] == reports['cpu', kind], f'{kind} reports')
        iou_err = 0.0
        for exp_id in truths:
            exp = GenerationExperiment.load(os.path.join(root, exp_id))
            preds, gts = list(exp.prediction_masks.values()), list(exp.truth_masks.values())
            a, b = E.iou_matrix(preds, gts, device='cuda'), E.iou_matrix(preds, gts, device='cpu')
            iou_err = max(iou_err, float(np.abs(a - b).max()))
            check(a.shape == (2, 3) and a.max() > 0, f'{exp_id} iou_matrix {a}')
        print(f'evaluation on the card (three scorers, 2 experiments, truth masks at '
              f'512x512 and 480x640): {eval_s:.3f} s; iou_matrix card vs CPU max abs '
              f'diff {iou_err:.3e}')
        check(iou_err <= 1e-6, 'iou_matrix card vs CPU')
    del mem, modules, tc, out
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 12: batched generation and the demo server
# --------------------------------------------------------------------------

def batch_parity(kernels, A) -> dict:
    """Phase 12a: phase 2's parity at CFG batch 8 (4 prompts), v2-1-base's
    shapes at hd 64, both layouts, bf16 and fp32 (TF32 off for the plain
    side): K2 on every self-attention of 8 rows and on the unconditional
    half of each cross-attention (rows 0–3), K1 on the conditional half (a
    view 4 batch strides into the operands), twice into one accumulator,
    K5 on all 8 rows with and without ``cond_only`` (rows 4–7 written).
    Returns the largest max-abs error per kernel and dtype."""
    import torch

    worst = new_worst()
    gen = torch.Generator(device='cuda').manual_seed(12)
    b = BATCH
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for dtype in (torch.float32, torch.bfloat16):
            dname = 'bf16' if dtype == torch.bfloat16 else 'fp32'
            for layout in ('head_major', 'packed'):
                before = dict(kernels.launches)

                def tag(shape, half=''):
                    return (f'{layout:10s} {str(dtype):14s} CFG batch {2 * b} '
                            f'B,H,Lq,Lk={shape}{half}')
                for (B, H, Lq, Lk), _ in K2_SHAPES:
                    q, k, v = qkv(2 * b, H, Lq, Lk, layout, dtype, gen)
                    if B == 1:  # the unconditional half of a cross-attention
                        parity_flash(kernels, A, q[:b], k[:b], v[:b],
                                     tag((b, H, Lq, Lk), ' rows 0-3'), worst)
                    else:
                        parity_flash(kernels, A, q, k, v, tag((2 * b, H, Lq, Lk)), worst)
                for (_, H, Lq, Lk), _ in K1_SHAPES:  # the conditional half
                    calls = [tuple(t[b:] for t in qkv(2 * b, H, Lq, Lk, layout, dtype, gen))
                             for _ in range(2)]
                    check(calls[0][0].storage_offset() == b * calls[0][0].stride(0),
                          'K1 reads the conditional half at a batch offset')
                    parity_acc(kernels, A, calls, tag((b, H, Lq, Lk), ' rows 4-7'), worst)
                for (_, H, Lq, Lk), _ in K5_SHAPES:
                    parity_probs(kernels, A, *qkv(2 * b, H, Lq, Lk, layout, dtype, gen),
                                 tag((2 * b, H, Lq, Lk)), worst)
                want = expected(kernels, dname, flash_attention=len(K2_SHAPES),
                                cross_attention_acc=2 * len(K1_SHAPES),
                                cross_attention_probs=4 * len(K5_SHAPES))
                got = {name: n - before[name] for name, n in kernels.launches.items()}
                check(got == want, f'CFG batch {2 * b} {dtype} {layout} launch counts {got}')
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return worst


class HostPeak:
    """Peak resident set size of this process over a block, in bytes,
    sampled every 5 ms from ``/proc/self/statm`` in a thread."""

    def __enter__(self):
        import os
        import threading

        self._page = os.sysconf('SC_PAGE_SIZE')
        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _rss(self) -> int:
        with open('/proc/self/statm') as f:
            return int(f.read().split()[1]) * self._page

    def _sample(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self._rss())


def write_corpus(root, prompts, seeds):
    """One experiment folder per prompt (``prompt.txt``, ``seed.txt``), what
    ``daam-torch --action regenerate`` reads."""
    import os

    for i, (prompt, seed) in enumerate(zip(prompts, seeds)):
        d = os.path.join(root, f'e{i}')
        os.makedirs(d)
        with open(os.path.join(d, 'prompt.txt'), 'w') as f:
            f.write(prompt)
        with open(os.path.join(d, 'seed.txt'), 'w') as f:
            f.write(str(seed))


def same_generation(a, b, label: str):
    """Two generations of one prompt and seed at different batch sizes:
    8-bit images within 2/255 and per-token heat maps at Spearman ≥ 0.999.
    ``a``, ``b``: (image, (T, x, x) maps); images as uint8 arrays."""
    import numpy as np
    import torch

    im_err = int(np.abs(np.asarray(a[0]).astype(int) - np.asarray(b[0]).astype(int)).max())
    ma, mb = (torch.as_tensor(np.asarray(m.cpu() if torch.is_tensor(m) else m)).cuda()
              for m in (a[1], b[1]))
    check(ma.shape == mb.shape, f'{label}: map shapes {tuple(ma.shape)} {tuple(mb.shape)}')
    rho = min(spearman(ma[t], mb[t]) for t in range(ma.shape[0]))
    print(f'{label}: image max abs diff {im_err}/255, per-token heat-map spearman min '
          f'{rho:.6f} over {ma.shape[0]} tokens')
    check(im_err <= 2 and rho >= 0.999, f'{label}: batched vs batch-1 generation')


def run_regenerate(generate_cli, kernels, corpus, out, batch_size: int,
                   steps: int = STEPS, extra=()) -> tuple:
    """``daam-torch --action regenerate`` in process over ``corpus``;
    returns (seconds, launch counts)."""
    import torch

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_captured(generate_cli.main, ['--action', 'regenerate', '-i', corpus, '-o', out,
                                     '--batch-size', str(batch_size), '-n', str(steps),
                                     *extra])
    torch.cuda.synchronize()
    return time.perf_counter() - t0, dict(kernels.launches)


def post(url: str, **fields) -> str:
    import urllib.parse
    import urllib.request

    data = urllib.parse.urlencode(fields).encode()
    with urllib.request.urlopen(url + '/generate', data=data, timeout=600) as r:
        check(r.status == 200, f'POST /generate: HTTP {r.status}')
        return r.read().decode()


def page_images(html: str) -> list:
    """The PNGs of a results page as uint8 arrays, in page order."""
    import base64
    import io

    import numpy as np
    import PIL.Image

    return [np.asarray(PIL.Image.open(io.BytesIO(base64.b64decode(m))))
            for m in re.findall(r'data:image/png;base64,([A-Za-z0-9+/=]+)', html)]


def serve(make_app, pipe, batch_size: int):
    """``make_app(pipe, 0, batch_size)`` behind a ThreadingHTTPServer on a
    free local port, in a thread; returns (handler, server, thread, url)."""
    import http.server
    import threading

    handler = make_app(pipe, 0, batch_size=batch_size)
    server = http.server.ThreadingHTTPServer(('127.0.0.1', 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return handler, server, thread, f'http://127.0.0.1:{server.server_address[1]}'


def stop(handler, server, thread):
    server.shutdown()
    server.server_close()
    thread.join(60)
    if handler.batcher is not None:
        handler.batcher.close()
    check(not thread.is_alive(), 'the server thread stopped')


def batched_generation(StableDiffusionPipeline, trace, kernels):
    """Phase 12: v2-1-base at a batch of 4 prompts (CFG batch 8), fp32,
    512², 10 steps: ``daam-torch --action regenerate`` at ``--batch-size``
    4 and 1 (images ±2/255, maps Spearman ≥ 0.999, one traced call's
    launches at batch 4), ``--action coco --word dog``, the save → load
    pair at batch 4 (peak host RSS), and ``daam-torch-demo``'s server:
    four concurrent requests in one traced call, each against its batch-1
    run, and the counterfactual's save → load transplant.  Returns the launch counts of
    the batch-4 regenerate run, K5's from the batch-4 save run."""
    import json as json_mod
    import os
    import tempfile
    import threading

    import numpy as np
    import torch
    from daam_tpu_torch.experiment import GenerationExperiment, _to_pil
    from daam_tpu_torch.run import demo
    from daam_tpu_torch.run import generate as generate_cli

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix='daam-smoke-') as tmp:
        # (b) regenerate at --batch-size 4 and 1
        corpus = os.path.join(tmp, 'corpus')
        write_corpus(corpus, BATCH_PROMPTS, BATCH_SEEDS)
        runs = {}
        for b in (BATCH, 1):
            out = os.path.join(tmp, f'b{b}')
            secs, launches = run_regenerate(generate_cli, kernels, corpus, out, b)
            calls = BATCH // b
            print(f'daam-torch --action regenerate --batch-size {b} ({BATCH} prompts, '
                  f'{STEPS} steps, {calls} traced call(s); load and artifacts included): '
                  f'{secs:.3f} s; launches {launches}')
            check(launches == expected(kernels, 'fp32',
                                       cross_attention_acc=K1_PER_EVAL * STEPS * calls,
                                       flash_attention=K2_PER_EVAL * STEPS * calls,
                                       geglu=FF_PER_EVAL * STEPS * calls,
                                       **png_launches(out)),
                  f'regenerate --batch-size {b} launch counts {launches}')
            runs[b] = {f'e{i}': GenerationExperiment.load(os.path.join(out, f'e{i}'))
                       for i in range(BATCH)}
            if b == BATCH:
                b4_launches = launches
        for name, exp in runs[BATCH].items():
            alone = runs[1][name]
            check(exp.prompt == alone.prompt and exp.seed == alone.seed,
                  f'{name}: prompt and seed')
            same_generation((exp.image, exp.global_heat_map),
                            (alone.image, alone.global_heat_map),
                            f'regenerate {name} {exp.prompt!r} seed {exp.seed}, '
                            f'batch {BATCH} vs batch 1')

        # --action coco --word dog: the lemma filter, 4 prompts in one call
        coco_in = os.path.join(tmp, 'coco')
        os.makedirs(coco_in)
        with open(os.path.join(coco_in, 'captions_val2014.json'), 'w') as f:
            json_mod.dump({'annotations': COCO_CAPTIONS}, f)
        coco_out = os.path.join(tmp, 'coco-out')
        kernels.reset_launches()
        run_captured(generate_cli.main, ['--action', 'coco', '-i', coco_in, '-o', coco_out,
                                         '--word', 'dog', '--gen-limit', str(BATCH),
                                         '--batch-size', str(BATCH), '-n', '2'])
        launches = dict(kernels.launches)
        dirs = sorted(os.listdir(coco_out))
        maps = {d: sorted(x for x in os.listdir(os.path.join(coco_out, d))
                          if x.endswith('.heat_map.png')) for d in dirs}
        print(f'daam-torch --action coco --word dog --gen-limit {BATCH} --batch-size '
              f'{BATCH} -n 2: experiments {dirs}, heat maps {maps}; launches {launches}')
        check(len(dirs) == BATCH and set(dirs) <= {'1', '4', '5', '7', '8'}
              and all(m == ['dog.heat_map.png'] for m in maps.values()),
              '--word dog keeps prompts holding the lemma once, and its map alone')
        check(launches == expected(kernels, 'fp32', cross_attention_acc=K1_PER_EVAL * 2,
                                   flash_attention=K2_PER_EVAL * 2, geglu=FF_PER_EVAL * 2,
                                   **png_launches(coco_out)),
              f'--action coco launch counts {launches}')

    # the save -> load pair at batch 4 (K5 at CFG batch 8)
    pipe = StableDiffusionPipeline.from_pretrained('v2-1-base', device='cuda')
    with HostPeak() as host:
        save = transplant(pipe, trace, kernels, f'v2-1-base fp32 batch {BATCH}', 'fp32',
                          other_prompt=False, prompts=BATCH_PROMPTS, seeds=BATCH_SEEDS)
    print(f'batch {BATCH} save -> load pair: peak host RSS {host.peak / 1e9:.3f} GB '
          f'({host.start / 1e9:.3f} GB before it)')
    b4_launches['cross_attention_probs'] = save['cross_attention_probs']

    # (c) the demo server: four concurrent plain requests in one traced call
    handler, server, thread, url = serve(demo.make_app, pipe, BATCH)
    try:
        handler.batcher.window_s = 2.0  # the four arrive inside one window
        served = {}
        submit = handler.batcher.submit

        def recording_submit(prompt, steps, seed):
            image, heat_map = submit(prompt, steps, seed)
            served[prompt] = (image, heat_map)
            return image, heat_map
        handler.batcher.submit = recording_submit
        pages = {}
        barrier = threading.Barrier(BATCH + 1)

        def request(prompt):
            barrier.wait()
            pages[prompt] = post(url, prompt=prompt, steps=str(STEPS))
        clients = [threading.Thread(target=request, args=(p,)) for p in BATCH_PROMPTS]
        for c in clients:
            c.start()
        kernels.reset_launches()
        barrier.wait()
        t0 = time.perf_counter()
        for c in clients:
            c.join(600)
        server_b4 = BATCH / (time.perf_counter() - t0)
        launches = dict(kernels.launches)
        print(f'daam-torch-demo, {BATCH} concurrent requests ({STEPS} steps, seed 0): '
              f'{server_b4:.4f} images/s; traced calls {list(handler.batcher.served)}; '
              f'launches {launches}')
        check(not any(c.is_alive() for c in clients) and sorted(pages) == sorted(BATCH_PROMPTS),
              'every request answered')
        check(list(handler.batcher.served) == [BATCH], 'the requests coalesced into one call')
        check(launches == expected(kernels, 'fp32', cross_attention_acc=K1_PER_EVAL * STEPS,
                                   flash_attention=K2_PER_EVAL * STEPS,
                                   geglu=FF_PER_EVAL * STEPS),
              f'server launch counts {launches}')
        for prompt in BATCH_PROMPTS:
            image, heat_map = served[prompt]
            check(np.array_equal(page_images(pages[prompt])[0], np.asarray(image)),
                  'the page shows the generated image')
            out, tc = pipe_call(pipe, True, trace, prompt=prompt, seeds=[0])
            same_generation((np.asarray(image), heat_map.heat_maps),
                            (np.asarray(_to_pil(out.images[0])),
                             tc.compute_global_heat_map().heat_maps),
                            f'server {prompt!r}, batch {BATCH} vs a batch-1 run')

        # the counterfactual: a save run, then a load run of the new prompt
        prompt, new_prompt = 'A blue car driving through the city', \
            'A red car driving through the city'
        kernels.reset_launches()
        t0 = time.perf_counter()
        html = post(url, prompt=prompt, choice='blue', new_adj='red', steps=str(STEPS))
        cf_s = time.perf_counter() - t0
        launches = dict(kernels.launches)
        print(f'daam-torch-demo counterfactual (save {prompt!r}, load {new_prompt!r}): '
              f'{cf_s:.3f} s; launches {launches}')
        check('transplanted attention' in html, 'the counterfactual page')
        check(launches == expected(kernels, 'fp32',
                                   cross_attention_probs=K5_PER_EVAL * STEPS,
                                   flash_attention=2 * K2_PER_EVAL_REPLAY * STEPS,
                                   geglu=2 * FF_PER_EVAL * STEPS),
              f'counterfactual launch counts {launches}')
        # 8-bit images: the saved run's and the transplant's from the page,
        # a fresh run of the new prompt (the same bits run to run).  With
        # random weights one adjective moves the image little, and the
        # attention less: the transplant lies a few 1e-4 from the fresh run
        # on average, a little nearer the saved run's image than the fresh
        # run lies
        saved, transplanted = (im.astype(float) / 255 for im in page_images(html)[:2])
        fresh, _ = pipe_call(pipe, False, trace, prompt=new_prompt)
        fresh = np.asarray(_to_pil(fresh.images[0])).astype(float) / 255
        d_tf, d_ts, d_fs = (float(np.abs(a - b).mean()) for a, b in (
            (transplanted, fresh), (transplanted, saved), (fresh, saved)))
        print(f'transplanted {new_prompt!r}: mean abs diff to a fresh run of it '
              f'{d_tf:.4e}, to the saved run {d_ts:.4e} (fresh to saved {d_fs:.4e})')
        check(d_tf > 2e-4 and d_ts < d_fs,
              'the transplanted image differs from a fresh run, towards the saved run')
    finally:
        stop(handler, server, thread)

    # one request through a batch-1 server
    handler, server, thread, url = serve(demo.make_app, pipe, 1)
    try:
        kernels.reset_launches()
        t0 = time.perf_counter()
        post(url, prompt=BATCH_PROMPTS[0], steps=str(STEPS))
        server_b1 = 1 / (time.perf_counter() - t0)
        launches = dict(kernels.launches)
        check(launches == expected(kernels, 'fp32', cross_attention_acc=K1_PER_EVAL * STEPS,
                                   flash_attention=K2_PER_EVAL * STEPS,
                                   geglu=FF_PER_EVAL * STEPS),
              f'batch-1 server launch counts {launches}')
    finally:
        stop(handler, server, thread)
    print(f'daam-torch-demo traced images/s ({STEPS} steps, the page rendered): batch 1 '
          f'server {server_b1:.4f}, batch {BATCH} server {server_b4:.4f}')
    print(f'phase 12 peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB')
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return b4_launches


# --------------------------------------------------------------------------
# phase 13: SD 2.1 at 768² with v-prediction
# --------------------------------------------------------------------------

def v2l_full_width(StableDiffusionPipeline, trace, kernels):
    """Phase 13: ``v2-1-large`` (SD 2.1's 768-px checkpoint, v-prediction)
    at 768², random weights from seed 0, in fp32 (the CLI's default) and
    bf16: a traced 10-step DDIM run (a 768² image, one untiled VAE decode
    of the 96² latent, 96² maps for every token, 15 × 10 K1 and 32 × 10 K2
    on the dtype's route), the save -> load pair (16 K5 and 16 K2 per
    evaluation, replayed maps at Spearman ≥ 0.999); peak device memory and
    host RSS.  Returns the launch counts
    of the fp32 and bf16 traced runs, K5's from the save run of the same
    dtype."""
    import torch

    runs = {}
    for dtype in ('fp32', 'bf16'):
        pipe = StableDiffusionPipeline.from_pretrained(
            'v2-1-large', device='cuda',
            dtype=torch.bfloat16 if dtype == 'bf16' else torch.float32)
        label = f'v2-1-large 768^2 {dtype}'
        print(f'{label}: {type(pipe.scheduler).__name__} {pipe.scheduler.prediction_type}')
        check(pipe.config.prediction_type == pipe.scheduler.prediction_type
              == 'v_prediction', f'{label}: v-prediction')

        decodes = []  # the input shape of every VAE decoder call
        vae_decode = pipe.vae.decode

        def recording_decode(z):
            decodes.append(tuple(z.shape))
            return vae_decode(z)
        pipe.vae.decode = recording_decode
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        out, tc = pipe_call(pipe, True, trace)
        launches = dict(kernels.launches)
        pipe.vae.decode = vae_decode
        print(f'{label} launches: {launches}; VAE decoder calls {decodes}; peak device memory '
              f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB')
        check_traced(out, tc, 768, label)
        maps = tc.compute_global_heat_map().heat_maps
        check(tuple(maps.shape[1:]) == (96, 96) and bool(torch.isfinite(maps).all()),
              f'{label}: per-token maps {tuple(maps.shape)}')
        check(decodes == [(1, 4, 96, 96)], f'{label}: untiled VAE decode {decodes}')
        check(launches == expected(kernels, dtype, cross_attention_acc=K1_PER_EVAL * STEPS,
                                   flash_attention=K2_PER_EVAL * STEPS,
                                   geglu=FF_PER_EVAL * STEPS),
              f'{label} launch counts {launches}')
        torch.cuda.reset_peak_memory_stats()
        with HostPeak() as host:
            save = transplant(pipe, trace, kernels, label, dtype, other_prompt=False)
        launches['cross_attention_probs'] = save['cross_attention_probs']
        print(f'{label} save -> load pair: peak device memory '
              f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, peak host RSS '
              f'{host.peak / 1e9:.3f} GB ({host.start / 1e9:.3f} GB before it)')
        runs[dtype] = launches
        del pipe, tc, out, maps
        gc.collect()
        torch.cuda.empty_cache()
    return runs['fp32'], runs['bf16']


# --------------------------------------------------------------------------
# phase 14: the native BPE and data-parallel generation
# --------------------------------------------------------------------------

def native_tokenizer():
    """Phase 1b: ``default_tokenizer()`` is the native (C++) BPE, built
    under the checkout's ``build/``, and gives the Python BPE's tokens and
    padded ids on the CLI's prompts (``template`` over
    ``data/vocab-small.tsv`` and ``cconj``, phase 12's COCO captions and
    batch)."""
    import os
    import random

    import numpy as np
    from daam_tpu_torch.native import NativeBpeTokenizer, library_path
    from daam_tpu_torch.run import generate as generate_cli
    from daam_tpu_torch.tokenization import (BUNDLED_VOCAB_DIR, ClipBpeTokenizer,
                                             default_tokenizer)

    t0 = time.perf_counter()
    native = default_tokenizer()
    build_s = time.perf_counter() - t0
    root = os.path.dirname(os.path.abspath(__file__))
    check(isinstance(native, NativeBpeTokenizer), f'default_tokenizer() is {type(native)}')
    check(library_path().is_relative_to(os.path.join(root, 'build')),
          f'the BPE library at {library_path()}')
    random.seed(0)
    np.random.seed(0)
    corpus = [PROMPT, PROMPT2, *BATCH_PROMPTS, *(c['caption'] for c in COCO_CAPTIONS)]
    for argv in (['--action', 'template', '-tdf', os.path.join(root, 'data', 'vocab-small.tsv'),
                  '--template', 'a {numeral} {noun} and {numeral} {noun}',
                  '--gen-limit', '50'],
                 ['--action', 'cconj', '--gen-limit', '50']):
        args = generate_cli.build_parser().parse_args(argv)
        corpus += [p for _, p in generate_cli.collect_prompts(args)[0]]
    python = ClipBpeTokenizer.from_pretrained(BUNDLED_VOCAB_DIR)
    for text in corpus:
        check(native.tokenize(text) == python.tokenize(text), f'tokens of {text!r}')
    ids = (native(corpus, return_tensors='np'), python(corpus, return_tensors='np'))
    check(all(np.array_equal(ids[0][k], ids[1][k]) for k in ('input_ids', 'attention_mask')),
          'padded ids and masks')
    t0 = time.perf_counter()
    native(corpus * 10)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    python(corpus * 10)
    python_s = time.perf_counter() - t0
    print(f'native BPE: {library_path()} (first default_tokenizer() {build_s:.2f} s, '
          f'the build included); {len(corpus)} CLI prompts, tokens and ids equal to the '
          f'Python BPE; {10 * len(corpus)} prompts encoded in {native_s:.4f} s, Python '
          f'{python_s:.4f} s (host clock)')


def data_parallel(StableDiffusionPipeline, trace, kernels):
    """Phase 14: ``init_distributed`` into a world-size-1 NCCL group on
    127.0.0.1 (a free port), ``fetch_global`` through NCCL's all_gather on
    a card tensor, and ``generate_batch`` of 3 prompts at v2-1-base 512²
    fp32, 10 traced steps (15 K1 and 32 K2 per evaluation on ``*_tf32x3``),
    whose images and maps must equal those of the same prompts run one by
    one (prompt i seeded i); the group is destroyed at the end."""
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    from daam_tpu_torch.parallel import (fetch_global, generate_batch, init_distributed,
                                         is_multi_process)

    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    check(init_distributed(f'tcp://127.0.0.1:{port}', world_size=1, rank=0) is False,
          'a one-process group')
    try:
        check(dist.get_backend() == 'nccl' and dist.get_world_size() == 1
              and not is_multi_process(), f'the group: {dist.get_backend()}')
        x = torch.arange(12.0, device='cuda').reshape(3, 4)
        check(np.array_equal(fetch_global(x), x.cpu().numpy()), 'fetch_global through NCCL')
        pipe = StableDiffusionPipeline.from_pretrained('v2-1-base', device='cuda')
        prompts = BATCH_PROMPTS[:3]
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with trace(pipe) as tc:
            out = generate_batch(pipe, prompts, num_inference_steps=STEPS, seed=0)
            maps = [tc.compute_global_heat_map(batch_idx=i).heat_maps for i in range(3)]
        secs = time.perf_counter() - t0
        launches = dict(kernels.launches)
        print(f'generate_batch, NCCL world size 1, {len(prompts)} prompts ({STEPS} steps): '
              f'{secs:.3f} s; launches {launches}')
        check(launches == expected(kernels, 'fp32',
                                   cross_attention_acc=K1_PER_EVAL * STEPS * len(prompts),
                                   flash_attention=K2_PER_EVAL * STEPS * len(prompts),
                                   geglu=FF_PER_EVAL * STEPS * len(prompts)),
              f'generate_batch launch counts {launches}')
        for i, prompt in enumerate(prompts):
            with trace(pipe) as tc:
                one = pipe(prompt, num_inference_steps=STEPS,
                           generator=torch.Generator('cuda').manual_seed(i))
                one_maps = tc.compute_global_heat_map().heat_maps
            image, ref = np.asarray(out.images[i]), np.asarray(one.images[0])
            print(f'generate_batch {prompt!r} vs a run of it alone: image max abs diff '
                  f'{int(np.abs(image.astype(int) - ref.astype(int)).max())}/255, maps max '
                  f'abs diff {(maps[i] - one_maps).abs().max().item():.3e}')
            check(image.shape == (512, 512, 3) and np.array_equal(image, ref)
                  and torch.equal(maps[i], one_maps), f'generate_batch {prompt!r}')
        del pipe, tc, out, one, maps
    finally:
        dist.destroy_process_group()
    check(not dist.is_initialized(), 'the group is torn down')
    gc.collect()
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 15: the port against daam_tpu's goldens at full width
# --------------------------------------------------------------------------

def maps_close(ours, theirs, label: str):
    """``tests/test_e2e_fidelity_torch.py::_assert_close``: per-token
    Spearman ≥ 0.99 on every map with structure (a flat map's ranks are
    noise), then |ours − theirs| ≤ 0.02 + 0.05·|theirs| everywhere."""
    import numpy as np
    import torch

    check(ours.shape == theirs.shape, f'{label} maps {ours.shape} vs {theirs.shape}')
    rhos = []
    for a, b in zip(ours, theirs):
        if a.max() - a.min() < 1e-4 * max(float(np.abs(a).max()), 1e-9):
            continue
        rhos.append(spearman(torch.from_numpy(a), torch.from_numpy(b)))
    worst = min(rhos) if rhos else 1.0
    excess = float((np.abs(ours - theirs) - (0.02 + 0.05 * np.abs(theirs))).max())
    print(f'{label} maps: min Spearman {worst:.6f} over {len(rhos)} tokens, max abs err '
          f'{float(np.abs(ours - theirs).max()):.3e}, allclose margin {-excess:.3e}')
    check(worst >= 0.99 and excess <= 0, f'{label} maps against the golden')


def golden_parity(trace, kernels) -> dict:
    """Phase 15: each golden of ``GOLDENS`` against the port on the card,
    fp32 with TF32 off; returns the launch counts of each traced run."""
    import os

    import numpy as np
    import torch
    from daam_tpu_torch.models import weights as W
    from daam_tpu_torch.models.configs import get_pipeline_config
    from daam_tpu_torch.pipeline.sd import _pipeline_class

    root = os.path.dirname(os.path.abspath(__file__))
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    counts = {}
    try:
        for preset, (k1, k2, ff) in GOLDEN_LAUNCHES.items():
            with np.load(os.path.join(root, GOLDENS, f'{preset}.npz')) as g:
                golden = {k: g[k] for k in g.files}
            config = get_pipeline_config(preset)
            t0 = time.perf_counter()
            params = W.init_random_params(config, seed=0)
            init_s = time.perf_counter() - t0
            sums = W.param_sums(params)
            print(f'{preset} golden: numpy init {init_s:.2f} s; module sums ' + ', '.join(
                f'{n} {sums[n]!r} (golden {s!r})'
                for n, s in zip(golden['module_names'].tolist(),
                                golden['module_sums'].tolist())))
            check([sums[n] for n in golden['module_names']] == golden['module_sums'].tolist(),
                  f'{preset} weight sums against the golden')
            modules = W.load_modules(config, W.from_jax_params(params), device='cuda',
                                     dtype=torch.float32)
            del params
            pipe = _pipeline_class(config)(config, **modules)
            del modules
            check(np.array_equal(pipe._encode_tokens([PROMPT])[0].cpu().numpy(),
                                 golden['token_ids']), f'{preset} token ids')
            stepped, marks = [], []

            def on_step(i, t, latents):
                stepped.append(latents.float().cpu().numpy())
                marks.append(time.perf_counter())

            kernels.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with trace(pipe) as tc:
                out = pipe(PROMPT, num_inference_steps=len(golden['latents']),
                           latents=golden['latents_init'], output_type='np',
                           callback=on_step, callback_steps=1)
                maps = tc.compute_global_heat_map().heat_maps.float().cpu().numpy()
            launches = counts[preset] = dict(kernels.launches)
            steps_s = [b - a for a, b in zip([t0] + marks, marks)]
            errs = [float(np.abs(a - b).max()) for a, b in zip(stepped, golden['latents'])]
            print(f'{preset} golden: latents max abs err by step '
                  + ', '.join(f'{i + 1}: {e:.3e}' for i, e in enumerate(errs)))
            print(f'{preset} golden (fp32, TF32 off): s/step '
                  + ', '.join(f'{x:.4f}' for x in steps_s) + f'; launches {launches}')
            image = np.clip(out.images[0] * 255 + 0.5, 0, 255).astype(np.uint8)
            diff = np.abs(image.astype(int) - golden['image'].astype(int))
            print(f'{preset} golden: image {image.shape} max abs diff {int(diff.max())}/255, '
                  f'mean {float(diff.mean()):.4f}/255')
            check(image.shape == golden['image'].shape and int(diff.max()) <= 2,
                  f'{preset} image against the golden')
            maps_close(maps, golden['heat_maps'], f'{preset} golden')
            check(launches == expected(kernels, 'fp32', cross_attention_acc=k1,
                                       flash_attention=k2, geglu=ff),
                  f'{preset} golden launch counts {launches}')
            del pipe, tc, out
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return counts


#: ``--flash-fp32``: parity cases (ragged Lq and Lk, Lk below one k8 step)
#: and the timed self-attention shapes, at every head dim
FLASH_FP32_PARITY = [(1, 2, 100, 150), (2, 3, 130, 77), (1, 1, 64, 5)]
FLASH_FP32_TIMES = [(2, 8, 4096, 4096), (2, 8, 1024, 1024)]


def flash_fp32(kernels, A):
    """``--flash-fp32``: fp32 flash_attention at every head dim of
    ``HEAD_DIMS`` against its plain version (TF32 off; max abs error ≤
    1e-4) and its event time (the better of two rounds of 20 launches) at
    ``FLASH_FP32_TIMES``, with TFLOP/s and the share of the 3xTF32 peak."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)
    ok = True
    for hd in kernels.HEAD_DIMS:
        for shape in FLASH_FP32_PARITY:
            q, k, v = qkv(*shape, 'packed', torch.float32, gen, hd)
            err = (kernels.flash_attention(q, k, v)
                   - A.flash_attention_plain(q, k, v)).abs().max().item()
            ok &= err <= TOL['fp32']
            print(f'flash fp32 parity hd={hd} B,H,Lq,Lk={shape} max_abs_err={err:.3e}')
        for shape in FLASH_FP32_TIMES:
            q, k, v = qkv(*shape, 'packed', torch.float32, gen, hd)
            ms = min(event_ms(lambda: kernels.flash_attention(q, k, v)) for _ in range(2))
            B, H, Lq, Lk = shape
            tflops = 4 * B * H * Lq * Lk * hd / ms / 1e9
            print(f'flash fp32 time hd={hd} B,H,Lq,Lk={shape} event={ms:.4f} ms '
                  f'{tflops:.1f} TFLOP/s, {100 * 3 * tflops / TF32_PEAK_TFLOPS:.1f}% '
                  f'of the 3xTF32 peak')
    check(ok, 'flash_attention fp32 parity')


def card_tests():
    """Phase 8: ``tests/test_torch_cuda.py`` on the card, in a subprocess
    and without ``tests/conftest.py`` (which imports JAX); fails on a
    non-zero exit or on no passes."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, '-m', 'pytest', '--noconftest', '-q', '-p', 'no:cacheprovider',
         'tests/test_torch_cuda.py'], cwd=root, capture_output=True, text=True,
        timeout=600)
    lines = proc.stdout.strip().splitlines()
    summary = lines[-1] if lines else ''
    print(f'card tests (tests/test_torch_cuda.py): exit {proc.returncode}, {summary}')
    passed = re.search(r'(\d+) passed', summary)
    if proc.returncode != 0 or not passed:
        print(proc.stdout[-6000:] + proc.stderr[-2000:])
    check(proc.returncode == 0 and passed is not None and int(passed.group(1)) > 0,
          'tests/test_torch_cuda.py on the card')


def overlay_routes(StableDiffusionPipeline, trace, kernels) -> dict:
    """Phase 8b: every word of one v2-1-base fp32 512² experiment (2 traced
    steps) drawn on the card (``csrc/overlay.cu``) and on the host, as a
    machine without matplotlib draws them.  Gates: each word's decoded PNG
    within one level of the host's on at most 0.5% of its pixels,
    ``output.png`` equal, every card file within 1% of Pillow's size for
    the same pixels, one ``overlay_resample`` a word and one
    ``png_scanlines`` a PNG on the card's pass and none on the host's; on
    two PyTorch threads every PNG of the card's deflated in two stripes (as
    ``png.write_png`` returns them), each striped file inflating to the
    one-stream file's rows and no more than 0.1% over its size.  Prints the ms a word
    of each route (the card's with the one-stream and the striped writer)
    and of its three spans, and the two kernels' event time at 512²."""
    import io
    import os
    import struct
    import tempfile
    import zlib

    import numpy as np
    import PIL.Image
    import torch
    from daam_tpu_torch import png, profiling
    from daam_tpu_torch.experiment import GenerationExperiment
    from daam_tpu_torch.heatmap import _JET_LUT

    def pixels(path):
        with PIL.Image.open(path) as im:
            return np.asarray(im.convert('RGB'))

    def idat_rows(path):
        data, pos, idat = path.read_bytes(), 8, b''
        while pos < len(data):
            size, = struct.unpack('>I', data[pos:pos + 4])
            if data[pos + 4:pos + 8] == b'IDAT':
                idat += data[pos + 8:pos + 8 + size]
            pos += 12 + size
        return zlib.decompress(idat)

    @contextlib.contextmanager
    def torch_threads(count):
        saved = torch.get_num_threads()
        torch.set_num_threads(count)
        try:
            yield
        finally:
            torch.set_num_threads(saved)

    hidden = {k: sys.modules.get(k) for k in ('matplotlib', 'matplotlib.pyplot')}
    sys.modules.update(dict.fromkeys(hidden))
    try:
        pipe = StableDiffusionPipeline.from_pretrained('v2-1-base', device='cuda')
        prompt = PROMPT.replace('.', ' .')
        with tempfile.TemporaryDirectory() as tmp:
            with trace(pipe) as tc:
                out = pipe(prompt, num_inference_steps=2,
                           generator=torch.Generator(device='cuda').manual_seed(0))
                card = tc.to_experiment(os.path.join(tmp, 'card'))
            card.image = out.images[0]
            host = GenerationExperiment(card.image, card.global_heat_map, card.prompt,
                                        path=os.path.join(tmp, 'host'),
                                        tokenizer=card.tokenizer)
            with torch_threads(1):  # the one-stream files the striped ones are held to
                card.save(heat_maps=False)
                one_stream = {p: (p.stat().st_size, idat_rows(p))
                              for p in [*card.save_all_heat_maps().values(),
                                        card.path / 'output.png']}
            launched, taken, write_png = dict(kernels.launches), [], png.write_png

            def recording_write_png(*args):
                taken.append(write_png(*args))
                return taken[-1]
            png.write_png = recording_write_png
            try:
                with torch_threads(2):  # the configurations' host threads
                    card.save(heat_maps=False)
                    card_paths = card.save_all_heat_maps()
            finally:
                png.write_png = write_png
            mid = dict(kernels.launches)
            host.save(heat_maps=False)
            host_paths = host.save_all_heat_maps()
            words = sorted(card_paths)
            check(bool(words) and words == sorted(host_paths), f'overlay words {words}')
            n = len(words)
            check(mid['overlay_resample'] - launched['overlay_resample'] == n
                  and mid['png_scanlines'] - launched['png_scanlines'] == n + 1,
                  'one overlay_resample a word, one png_scanlines a PNG on the card')
            check(dict(kernels.launches) == mid, 'the host route launches no kernel')
            check(taken == [2] * (n + 1),
                  f'on two threads every PNG of the card\'s route deflates in stripes: {taken}')
            sizes = []
            for p, (size, rows) in one_stream.items():
                check(idat_rows(p) == rows, f'{p.name}: the stripes inflate to the '
                      'one-stream file\'s rows')
                sizes.append(p.stat().st_size / size)
            check(max(sizes) <= 1.001, f'striped PNGs no more than 0.1% over one stream: '
                  f'{max(sizes)}')
            worst = {'max_level_diff': 0, 'differing_share': 0.0, 'size_ratio': 1.0}
            pairs = [(card_paths[w], host_paths[w]) for w in words]
            pairs.append((card.path / 'output.png', host.path / 'output.png'))
            for ours, theirs in pairs:
                a, b = pixels(ours), pixels(theirs)
                diff = np.abs(a.astype(np.int16) - b).max(-1)
                buf = io.BytesIO()
                PIL.Image.fromarray(a).save(buf, format='PNG')
                ratio = os.path.getsize(ours) / len(buf.getvalue())
                worst['max_level_diff'] = max(worst['max_level_diff'], int(diff.max()))
                worst['differing_share'] = max(worst['differing_share'],
                                               float((diff > 0).mean()))
                worst['size_ratio'] = max(worst['size_ratio'], ratio, 1 / ratio)
                if ours.name == 'output.png':
                    check(not diff.any(), 'output.png written from the card equals PIL\'s')
            check(worst['max_level_diff'] <= 1 and worst['differing_share'] <= 0.005,
                  f'overlays on the card against the host route: {worst}')
            check(worst['size_ratio'] <= 1.01, f'PNG sizes against Pillow\'s: {worst}')

            # ms a word of each route, spans on, three passes a route; the
            # card's with the one-stream writer (one thread) and the striped
            # one (two threads, the configurations' own)
            ms, stages = {}, {}
            routes = (('card_one_stream', card, 1), ('card_striped', card, 2),
                      ('host', host, torch.get_num_threads()))
            for label, exp, threads in routes * 3:
                profiling.clear()
                profiling.enable()
                with torch_threads(threads):
                    t0 = time.perf_counter()
                    exp.save_all_heat_maps()
                    ms.setdefault(label, []).append((time.perf_counter() - t0) * 1e3 / n)
                profiling.disable()
                for r in profiling.spans():
                    if r.name.startswith('overlay.'):
                        stages.setdefault(label, {}).setdefault(r.name, []).append(
                            (r.end_ns - r.start_ns) / 1e6)
            image = torch.from_numpy(np.array(card.image)).cuda()
            heat = torch.rand(64, 64, device='cuda')
            lut = torch.from_numpy(_JET_LUT).cuda()
            device_ms = event_ms(lambda: kernels.png_scanlines(
                image, kernels.overlay_resample(heat, image.shape[:2]), lut))
    finally:
        for k, m in hidden.items():
            if m is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = m
    line = {'words': n, **worst,
            'striped_size_ratio': [min(sizes), max(sizes)],
            'ms_per_word': {k: min(v) for k, v in ms.items()},
            'span_ms_per_word': {k: {name: sum(t) / len(t) for name, t in v.items()}
                                 for k, v in stages.items()},
            'kernels_event_ms_512': device_ms}
    print(json.dumps({'overlays': line}))
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return line


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--kernel-times', action='store_true',
                        help='build and time the kernels (phase 6b) only; no checks '
                             'beyond the build, no result line')
    parser.add_argument('--flash-fp32', action='store_true',
                        help='build, then check and time fp32 flash_attention at every '
                             'head dim only; no result line')
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; this script runs only on an NVIDIA GPU',
              file=sys.stderr)
        sys.exit(1)
    from daam_tpu_torch import StableDiffusionPipeline, trace
    from daam_tpu_torch.ops import attention as A
    from daam_tpu_torch.ops import kernels

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f'python {sys.version.split()[0]} torch {torch.__version__} '
          f'cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}')
    print(f'defaults: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} '
          f'cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}')

    # 1. build
    kernels.load_library()
    print(f'build: {kernels.build_seconds:.2f} s')
    report = ptxas_report(kernels.build_log)
    for name, lines in report.items():
        print(f'  {name}: ' + '; '.join(lines))
    for line in kernels.build_log.splitlines():
        if 'warning' in line.lower() or 'Performance Loss' in line:
            print(f'  build: {line.strip()}')
    if args.kernel_times:
        for model in PATH_SHAPES:
            for dtype in DTYPES:
                kernel_times(kernels, A, model, dtype)
        if hasattr(kernels, 'geglu'):  # not in older checkouts
            for model in GEGLU_SHAPES:
                for dtype in DTYPES:
                    geglu_times(kernels, model, dtype)
        print(smi)
        return
    if args.flash_fp32:
        flash_fp32(kernels, A)
        print(smi)
        return
    # one per head dim, but the cross-attention kernels: acc, and P in fp32
    # and bf16, per head dim; fp32 flash_attention on wgmma at the head dims
    # it serves, on mma.sync at the others
    n_hd, n_wt = len(kernels.HEAD_DIMS), len(kernels.TF32X3_WGMMA_HEAD_DIMS)
    for family, count in (('flash_attention_wgmma_kernel', n_hd),
                          ('cross_attention_mma_kernel', 3 * n_hd),
                          ('flash_attention_tf32x3_wgmma_kernel', n_wt),
                          ('split_kv_tf32x3_kernel', n_wt),
                          ('flash_attention_tf32x3_kernel', n_hd - n_wt),
                          ('cross_attention_tf32x3_kernel', 3 * n_hd),
                          ('geglu_kernel', 4)):
        tensor_core = [n for n in report if family in n]
        check(len(tensor_core) == count,
              f'ptxas reports {len(tensor_core)} kernels {family}, not {count}')
        for name in tensor_core:
            check(any(' 0 bytes spill stores, 0 bytes spill loads' in x
                      for x in report[name]), f'{name} spills registers')

    # 1b. the native BPE: built here, and the tokenizer every pipeline takes
    native_tokenizer()

    # 2-3. parity, with TF32 off for the fp32 checks
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = parity(kernels, A)
    for preset in ('tiny', 'tiny-v1', 'tiny-xl'):
        tiny_reference(A, StableDiffusionPipeline, trace, preset)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # 8. the card's pytest cases
    card_tests()

    # 8b. the overlays on the card against the host route
    overlay_routes(StableDiffusionPipeline, trace, kernels)

    # 6b. the kernels alone at both paths' shapes
    totals = {(model, dtype): kernel_times(kernels, A, model, dtype)
              for model in PATH_SHAPES for dtype in DTYPES}
    for model in GEGLU_SHAPES:
        for dtype in DTYPES:
            geglu_times(kernels, model, dtype)

    # 4. the slice at full width
    pipe = StableDiffusionPipeline.from_pretrained('v2-1-base', device='cuda',
                                                   dtype=torch.bfloat16)
    kernels.reset_launches()
    out, tc = pipe_call(pipe, True, trace)
    launches = dict(kernels.launches)
    print(f'main path launches: {launches}')
    check_traced(out, tc, 512, 'v2-1-base bf16')
    check(launches == expected(kernels, 'bf16', cross_attention_acc=K1_PER_EVAL * STEPS,
                               flash_attention=K2_PER_EVAL * STEPS,
                               geglu=FF_PER_EVAL * STEPS),
          f'launch counts {launches}')

    # 5. the transplant at full width
    launches['cross_attention_probs'] = transplant(
        pipe, trace, kernels, 'v2-1-base bf16', 'bf16')['cross_attention_probs']
    del pipe, tc, out
    gc.collect()
    torch.cuda.empty_cache()

    # 9. the default command's path: v2-1-base in fp32
    launches_fp32 = fp32_main_path(StableDiffusionPipeline, trace, kernels)

    # 10. SD 1.x at full width: fp32 with DDIM, bf16 with PNDM
    v1_launches_fp32, v1_launches = v1_full_width(StableDiffusionPipeline, trace, kernels)

    # 7. SDXL at full width, in bf16, then one step in fp32
    sdxl_launches, sdxl_launches_fp32 = sdxl_full_width(
        StableDiffusionPipeline, trace, kernels, A)

    # 11. v2-1-base through a checkpoint directory, its VAE encoder, the
    # evaluation
    checkpoint_and_evaluation(StableDiffusionPipeline, trace, kernels)

    # 12. a batch of 4 prompts: kernels at CFG batch 8, regenerate, the demo
    worst_b4 = batch_parity(kernels, A)
    b4_launches = batched_generation(StableDiffusionPipeline, trace, kernels)

    # 13. SD 2.1 at 768² with v-prediction, fp32 and bf16
    v2l_launches_fp32, v2l_launches = v2l_full_width(StableDiffusionPipeline, trace, kernels)

    # 14. data-parallel generation in a one-process NCCL group
    data_parallel(StableDiffusionPipeline, trace, kernels)

    # 15. the port against daam_tpu's goldens at full width, fp32, TF32 off
    golden_launches = golden_parity(trace, kernels)
    print(json.dumps({'golden_launches': golden_launches}))

    replaces = {'flash_attention': 'daam_tpu/ops/pallas_attention.py:169',
                'cross_attention_acc': 'daam_tpu/ops/pallas_attention.py:517',
                'cross_attention_probs': 'daam_tpu/ops/pallas_attention.py:405'}

    def kernel_lines(model, launches, launches_fp32, errs=worst):
        lines = []
        for dtype, counts in (('bf16', launches), ('fp32', launches_fp32)):
            if counts is None:  # no run of the path in this dtype
                continue
            for name in ('cross_attention_acc', 'flash_attention', 'cross_attention_probs'):
                t = totals[model, dtype][name]
                # the fp32 routes as entries of their own, named by their
                # launch counter
                lines.append({
                    'name': name if dtype == 'bf16' else ROUTE[dtype][name],
                    'dtype': dtype, 'route': 'cuda',
                    'source': 'daam_tpu_torch/csrc/attention.cu',
                    'replaces': replaces[name], 'launches': counts[name],
                    'max_abs_err': errs[name, dtype], 'ms': t['ms'],
                    'device_ms': t['device_ms'], 'plain_ms': t['plain_ms'],
                    'bound_ms': t['bound_ms'], 'bound_by': max(t['by'], key=t['by'].get),
                    'core_bound_ms': t['core_bound_ms'] if dtype == 'fp32' else None,
                    'library_ms': t['library_ms']})
        return lines
    # per v1 evaluation, launches from phase 10 (bf16: the PNDM runs)
    print(json.dumps({'v1_kernels': kernel_lines('v1', v1_launches, v1_launches_fp32)}))
    # per SDXL evaluation; cross_attention_probs per evaluation of an SDXL
    # save run, its launches from phase 7's save runs
    print(json.dumps({'sdxl_kernels': kernel_lines('xl-base-1.0', sdxl_launches,
                                                   sdxl_launches_fp32)}))
    # per UNet evaluation at CFG batch 8, fp32 (the path phase 12 runs): K1
    # and K2 launches from the batch-4 regenerate run, K5's from its save
    # run, max abs errors from phase 12a
    print(json.dumps({'b4_kernels': kernel_lines('v2-1-base b4', None, b4_launches,
                                                 errs=worst_b4)}))
    # per v2-1-large evaluation (768²), launches from phase 13
    print(json.dumps({'v2l_kernels': kernel_lines('v2-1-large', v2l_launches,
                                                  v2l_launches_fp32)}))
    print(smi)
    print(json.dumps({'kernels': kernel_lines('v2-1-base', launches, launches_fp32)}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
