#!/usr/bin/env python3
"""Smoke run of daam_tpu_torch on one NVIDIA GPU: build, kernel parity, the
traced SD 2.1-base slice, the head-replay transplant, the traced SDXL slice,
timings.

    python3 chip_smoke.py                 # from the repository root
    python3 chip_smoke.py --profile       # also a torch.profiler table of a
                                          # traced call of each full-width model
    python3 chip_smoke.py --kernel-times  # the build and phase 6b's kernel times only

``--kernel-times`` checks nothing beyond the build and prints no result
line; a copy of this script placed in another checkout times that
checkout's kernels (the script's own directory comes first on the import
path), which is how two commits' kernels are compared in one call.

Phases, each of which raises (exit code != 0) when a check fails:

1. Build ``daam_tpu_torch/csrc/attention.cu`` with nvcc for sm_90a; print
   each kernel's registers and spills, and fail if a tensor-core kernel
   (``flash_attention_wgmma_kernel``, ``cross_attention_mma_kernel``) is
   missing or spills.
2. Kernel parity at the paths' shapes, kernel against its plain PyTorch
   version on the same inputs, in both layouts (head-major view and the
   (B, L, H·hd) projection output): fp32 on the CUDA-core kernels at hd 64,
   bf16 on the tensor-core kernels at every head dim of ``HEAD_DIMS``.
   ``flash_attention`` at Lk ∈ {4096, 1024, 77} in fp32 and at every shape
   of ``K2_SHAPES`` (Lq ∈ {4096, 1024, 256, 64}, Lk = Lq or 77) in bf16;
   ``cross_attention_acc`` at every shape of ``K1_SHAPES``, at the ragged
   Lq = 100 and at Lk = 200 (three 80-key chunks), called twice into the
   same accumulator; ``cross_attention_probs`` at every shape of
   ``K5_SHAPES``, at the ragged Lq = 37 and at Lk = 200, with and without
   ``cond_only``, P in fp32 and bf16 (P compared on the rows it writes);
   and in bf16 at hd 64, every shape of SDXL's path (``SDXL_K2_SHAPES``,
   ``SDXL_K1_SHAPES``, ``SDXL_K5_SHAPES``: 4096 queries × 10 heads and 1024
   × 20).  Every bf16 case must have run on the tensor cores (the ``*_wgmma`` and ``*_mma`` counters).  TF32 is off for
   the fp32 checks.  Max abs error ≤ 1e-4 (fp32 outputs), ≤ 1e-5 (fp32 P
   and the fp32 accumulator, whatever the inputs' type: both are built from
   fp32 P), ≤ 1/128 (bf16 P), ≤ 2e-2 (bf16 outputs); Spearman ≥ 0.999.
   Each bf16 output of the three kernels must lie closer (mean abs
   difference) to a reference that rounds P to bf16 before PV where the
   Pallas body does than to the same reference with fp32 P.
3. A small reference: the ``tiny`` and ``tiny-xl`` presets in fp32, kernels
   against the plain path, same weights and latents: images within 1e-3,
   heat maps with per-token Spearman ≥ 0.999; then an fp32 save_heads →
   load_heads pair under each, whose buffers agree within 1e-5 and images
   within 1e-3.
4. The main path at full width: ``v2-1-base`` (random weights from seed 0),
   bf16, 512², 10 traced DDIM steps through ``trace(pipe)``; the image must
   be (512, 512, 3) and finite, the word map for "dog" (64, 64), finite,
   ≥ 0 and not constant, and the launch counters, zeroed just before the
   run, must read 15 × 10 (cross_attention_acc) and 32 × 10
   (flash_attention), every one on the tensor cores.
5. The transplant at full width, the same model: a ``save_heads`` run of the
   prompt (counters: 16 × 10 cross_attention_probs and 16 × 10
   flash_attention, every one on the tensor cores; no cross_attention_acc), whose bf16
   buffer must hold 16 layers of (10, 2, H, h·w, 77), finite, rows summing
   to 1 within 1e-2; a ``load_heads`` run of the same prompt (counters: 16
   × 10 flash_attention on the tensor cores, nothing else), whose per-token
   heat maps must match the save run's at Spearman ≥ 0.999; and a
   ``load_heads`` run of a second prompt, whose image must differ from a
   fresh run of that prompt.
6. (a) Seconds per step of v2-1-base traced and untraced (host clock,
   synchronized per step, warm runs in turns) and of the save and load
   runs.  (b) Run first, right after phase 3, before any pipeline is
   profiled: each bf16 kernel at every shape of each path (hd 64;
   v2-1-base, then xl-base-1.0): its time by CUDA events (back-to-back
   launches after a warm-up), its device time per launch (torch.profiler's
   self device time over 20 launches, so the wrappers' host cost does not
   stand in for kernel time), its plain version's time, its bound, and the
   bound's share of the device time.  The bound is the larger of the bytes
   the call must move (each input read once, each output written once) over
   the H100's 3.35 TB/s and its FLOP (4·B·H·Lq·Lk·hd) over 989 TFLOP/s dense
   bf16.  The bytes are q, k, v and o in bf16, plus the fp32 accumulator
   read and written (``cross_attention_acc``) or fp32 P written
   (``cross_attention_probs``, as the save run writes it).
   ``flash_attention`` is also timed against
   ``torch.nn.functional.scaled_dot_product_attention`` on the same q, k
   and v, a yardstick the port never calls.
7. SDXL at full width: ``xl-base-1.0`` (random weights from seed 0; UNet
   320/640/1280, CLIP-L and OpenCLIP-bigG), bf16, 1024², 10 traced DDIM
   steps through ``trace(pipe)``: the image must be (1024, 1024, 3) and
   finite, the "dog" map (64, 64), finite, ≥ 0 and not constant, the VAE
   decoder called once on the 3 × 3 batch of 64² tiles, and the counters,
   zeroed just before the run, 60 × 10 cross_attention_acc and 140 × 10
   flash_attention, every one on the tensor cores, and no
   cross_attention_probs.  Then one traced step through the kernels and one
   with ``set_kernel_mode('torch')``, from the same latents, whose global
   heat maps must agree at per-token Spearman ≥ 0.99; then its seconds per
   step traced and untraced.  The SDXL save run (~0.5 GB of bf16 P a step)
   is not driven here; phase 5 holds the replay path.

With phase 7 the whole run takes ~60–80 s of command time on one H100;
the earlier phases keep their repeats.

Before the card's name and power limit, ``{"sdxl_kernels": [...]}`` gives
the same keys as the next line for SDXL's path: launches from phase 7
(cross_attention_probs: 0) and times per SDXL evaluation
(cross_attention_probs: per evaluation of an SDXL save run).
The line before the last is ``{"kernels": [...]}``: per kernel, its launches
in its path's run (phase 4, or the phase-5 save run for
cross_attention_probs), the largest bf16 max-abs error of phase 2, and,
per UNet evaluation of its path (each shape's number × its launches per
evaluation): ``ms`` (events), ``device_ms`` (profiler), ``plain_ms``,
``bound_ms`` with ``bound_by`` (what bounds most of it), and ``library_ms``
(SDPA for ``flash_attention``; null for the others: no PyTorch call adds
Pᵀ into an accumulator or returns P).  The last line is
``{"ok": true, "device": {...}}``.  The script needs a CUDA device and the
daam_tpu_torch package beside it; it never imports JAX or PIL.
"""

import argparse
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
N_LAYERS = 16
# xl-base-1.0 at 1024² (128² latent), hd 64: 10 transformer blocks at 4096
# queries × 10 heads (level 1) and 60 at 1024 × 20 (level 2, the mid
# block's 10 included); the trace captures the 60 outside the mid block.
SDXL_K1_PER_EVAL, SDXL_K2_PER_EVAL = 60, 140
SDXL_K2_SHAPES = [((2, 10, 4096, 4096), 10), ((2, 20, 1024, 1024), 60),
                  ((1, 10, 4096, 77), 10), ((1, 20, 1024, 77), 50),
                  ((2, 20, 1024, 77), 10)]
SDXL_K1_SHAPES = [((1, 10, 4096, 77), 10), ((1, 20, 1024, 77), 50)]
# per evaluation of an SDXL save run (not driven here: ~0.5 GB of bf16 P a
# step), every attn2 through cross_attention_probs
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
# Off the paths: Lq not a multiple of the 64-query block, and Lk past one
# 80-key chunk (the tensor-core kernel's two-pass route).
EXTRA_SHAPES = {'cross_attention_acc': [(1, 5, 100, 77), (1, 5, 128, 200)],
                'cross_attention_probs': [(2, 5, 37, 77), (2, 5, 100, 200)]}
HD = 64
# H100 SXM (NVIDIA's data sheet)
BF16_PEAK_TFLOPS = 989.0  # dense
HBM_TB_S = 3.35


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f'check failed: {msg}')


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


def parity(kernels, A):
    """Phase 2; returns the largest bf16 max-abs error per kernel."""
    import torch

    worst = {'flash_attention': 0.0, 'cross_attention_acc': 0.0,
             'cross_attention_probs': 0.0}
    gen = torch.Generator(device='cuda').manual_seed(0)
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

    def cases(dtype, shapes):
        """fp32 runs on the CUDA-core kernels at hd 64; bf16 on the
        tensor-core kernels at every head dim they serve."""
        dims = kernels.HEAD_DIMS if dtype == torch.bfloat16 else (HD,)
        return [(hd, sh) for hd in dims for sh in shapes]

    k1_shapes = [sh for sh, _ in K1_SHAPES] + EXTRA_SHAPES['cross_attention_acc']
    k5_shapes = [sh for sh, _ in K5_SHAPES] + EXTRA_SHAPES['cross_attention_probs']
    # SDXL's shapes at its one head dim, 64, in bf16 (the path's type)
    sdxl = {name: [(HD, sh) for sh, _ in shapes] for name, shapes in (
        ('flash_attention', SDXL_K2_SHAPES), ('cross_attention_acc', SDXL_K1_SHAPES),
        ('cross_attention_probs', SDXL_K5_SHAPES))}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        for layout in ('head_major', 'packed'):
            before = dict(kernels.launches)
            flash_cases = cases(dtype, [sh for sh, _ in K2_SHAPES] if bf16 else
                                [(2, 5, 4096, 4096), (2, 10, 1024, 1024),
                                 (1, 5, 4096, 77)])
            flash_cases += sdxl['flash_attention'] if bf16 else []
            for hd, shape in flash_cases:
                q, k, v = qkv(*shape, layout, dtype, gen, hd)
                o = kernels.flash_attention(q, k, v)
                r = A.flash_attention_plain(q, k, v)
                torch.cuda.synchronize()
                err = (o.float() - r.float()).abs().max().item()
                rho = spearman(o, r)
                print(f'parity flash_attention {layout:10s} {str(dtype):14s} '
                      f'hd={hd:<3d} B,H,Lq,Lk={shape} max_abs_err={err:.3e} '
                      f'spearman={rho:.6f}')
                check(err <= tol[dtype] and rho >= 0.999, 'flash_attention parity')
                if bf16:
                    worst['flash_attention'] = max(worst['flash_attention'], err)
                    check_rounding('flash_attention', o, flash_reference(q, k, v, True),
                                   flash_reference(q, k, v, False))
            acc_cases = cases(dtype, k1_shapes) + (sdxl['cross_attention_acc']
                                                   if bf16 else [])
            for hd, shape in acc_cases:
                B, H, Lq, Lk = shape
                acc = torch.zeros(B, H, Lk, Lq, device='cuda')
                acc_plain = acc.clone()
                for _ in range(2):
                    q, k, v = qkv(*shape, layout, dtype, gen, hd)
                    o = kernels.cross_attention_acc(q, k, v, acc)
                    r = A.cross_attention_acc_plain(q, k, v, acc_plain)
                torch.cuda.synchronize()
                err = (o.float() - r.float()).abs().max().item()
                acc_err = (acc - acc_plain).abs().max().item()
                rho = min(spearman(o, r), spearman(acc, acc_plain))
                print(f'parity cross_attention_acc {layout:10s} {str(dtype):14s} '
                      f'hd={hd:<3d} B,H,Lq,Lk={shape} max_abs_err={err:.3e} '
                      f'acc_max_abs_err={acc_err:.3e} spearman={rho:.6f}')
                # acc sums fp32 P whatever the inputs' type: a kernel that
                # added bf16-rounded P would miss this by ~1e-3
                check(err <= tol[dtype] and acc_err <= 1e-5 and rho >= 0.999,
                      'cross_attention_acc parity')
                if bf16:
                    worst['cross_attention_acc'] = max(
                        worst['cross_attention_acc'], err, acc_err)
                    # the plain version rounds normalized P before PV
                    check_rounding('cross_attention_acc', o, r,
                                   cross_reference(q, k, v, False))
            probs_cases = cases(dtype, k5_shapes) + (sdxl['cross_attention_probs']
                                                     if bf16 else [])
            for hd, shape in probs_cases:
                B = shape[0]
                q, k, v = qkv(*shape, layout, dtype, gen, hd)
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
                        print(f'parity cross_attention_probs {layout:10s} '
                              f'{str(dtype):14s} hd={hd:<3d} B,H,Lq,Lk={shape} '
                              f'cond_only={cond_only!s:5s} P {str(pdt):14s} '
                              f'max_abs_err={err:.3e} p_max_abs_err={p_err:.3e} '
                              f'spearman={rho:.6f}')
                        # bf16 P: kernel and plain version may round to
                        # neighbours, one ulp (1/256 below 1) apart
                        p_tol = 1e-5 if pdt == torch.float32 else 1 / 128
                        check(err <= tol[dtype] and p_err <= p_tol and rho >= 0.999,
                              'cross_attention_probs parity')
                        if torch.bfloat16 in (dtype, pdt):
                            worst['cross_attention_probs'] = max(
                                worst['cross_attention_probs'], err, p_err)
                        if bf16:
                            check_rounding('cross_attention_probs', o, r,
                                           cross_reference(q, k, v, False))
            # every bf16 launch took the tensor cores, and no fp32 one did
            for name, n in (('flash_attention_wgmma', len(flash_cases)),
                            ('cross_attention_acc_mma', 2 * len(acc_cases)),
                            ('cross_attention_probs_mma', 4 * len(probs_cases))):
                got = kernels.launches[name] - before[name]
                check(got == (n if bf16 else 0),
                      f'{got} {dtype} {layout} launches counted by {name}')
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
            out_s, _, tc = timed_call(pipe, True, trace, steps=3, save_heads=True,
                                      persist_heads=False, data_dir=f'{preset}-{mode}')
            out_l, _, _ = timed_call(pipe, True, trace, steps=3, load_heads=True,
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


def timed_call(pipe, traced: bool, trace, steps: int = STEPS,
               prompt: str = PROMPT, **trace_kwargs):
    """One pipeline call; returns (output, per-step seconds, tracer)."""
    import torch

    marks = []

    def on_step(i, t, latents):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    gen = torch.Generator(device=pipe.device).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if traced:
        with trace(pipe, **trace_kwargs) as tc:
            out = pipe(prompt, num_inference_steps=steps, generator=gen,
                       output_type='np', callback=on_step)
        return out, [b - a for a, b in zip([t0] + marks, marks)], tc
    out = pipe(prompt, num_inference_steps=steps, generator=gen,
               output_type='np', callback=on_step)
    return out, [b - a for a, b in zip([t0] + marks, marks)], None


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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def bound(name, shape, hd=HD):
    """(ms, 'bytes' or 'operations'): the least time of one launch on an
    H100 SXM, each input read once and each output written once."""
    B, H, Lq, Lk = shape
    nbytes = 2 * B * H * (2 * Lq + 2 * Lk) * hd  # q, o, k, v in bf16
    if name == 'cross_attention_acc':
        nbytes += 2 * 4 * B * H * Lk * Lq  # the accumulator read and written
    elif name == 'cross_attention_probs':
        nbytes += 4 * B * H * Lq * Lk      # fp32 P, as the save run writes it
    t_bytes = nbytes / (HBM_TB_S * 1e12) * 1e3
    t_ops = 4 * B * H * Lq * Lk * hd / (BF16_PEAK_TFLOPS * 1e12) * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


#: (B, H, Lq, Lk) and launches per UNet evaluation, by kernel, of each
#: path phase 6b times
PATH_SHAPES = {
    'v2-1-base': (('flash_attention', K2_SHAPES), ('cross_attention_acc', K1_SHAPES),
                  ('cross_attention_probs', K5_SHAPES)),
    'xl-base-1.0': (('flash_attention', SDXL_K2_SHAPES),
                    ('cross_attention_acc', SDXL_K1_SHAPES),
                    ('cross_attention_probs', SDXL_K5_SHAPES))}


def kernel_times(kernels, A, model):
    """Phase 6b: every bf16 kernel at every shape of ``model``'s path
    against its plain version, its bound and, for flash_attention, SDPA;
    returns the totals per UNet evaluation by kernel."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device='cuda').manual_seed(1)
    rows, calls = [], []
    for name, shapes in PATH_SHAPES[model]:
        for shape, per_eval in shapes:
            q, k, v = qkv(*shape, 'packed', torch.bfloat16, gen)
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
            row = {'name': name, 'shape': shape, 'per_eval': per_eval,
                   'ms': (k1 + k2) / 2, 'plain_ms': (p1 + p2) / 2,
                   'bound': bound(name, shape), 'lib_ms': None}
            calls.append((f'{name} {shape}', kern))
            if lib is not None:
                row['lib_ms'] = (event_ms(lib) + event_ms(lib)) / 2
                calls.append((f'sdpa {shape}', lib))
            rows.append(row)
    dev = device_times(calls)
    totals = {}
    for row in rows:
        name, shape, per_eval = row['name'], row['shape'], row['per_eval']
        d_ms, n_kernels = dev[f'{name} {shape}']
        check(n_kernels == 1, f'{name} {shape}: {n_kernels} device kernels a call')
        (b_ms, by) = row['bound']
        tot = totals.setdefault(name, {'ms': 0.0, 'device_ms': 0.0, 'plain_ms': 0.0,
                                       'bound_ms': 0.0, 'library_ms': None,
                                       'library_device_ms': None,
                                       'by': {'bytes': 0.0, 'operations': 0.0}})
        for key, val in (('ms', row['ms']), ('device_ms', d_ms),
                         ('plain_ms', row['plain_ms']), ('bound_ms', b_ms)):
            tot[key] += val * per_eval
        tot['by'][by] += b_ms * per_eval
        extra = ''
        if row['lib_ms'] is not None:
            lib_dev = dev[f'sdpa {shape}'][0]
            tot['library_ms'] = (tot['library_ms'] or 0.0) + row['lib_ms'] * per_eval
            tot['library_device_ms'] = (tot['library_device_ms'] or 0.0) + lib_dev * per_eval
            B, H, Lq, Lk = shape
            tflops = 4 * B * H * Lq * Lk * HD / d_ms / 1e9
            extra = (f' sdpa={row["lib_ms"]:.4f} ms (device {lib_dev:.4f}); '
                     f'{tflops:.1f} TFLOP/s on the device, '
                     f'{100 * tflops / BF16_PEAK_TFLOPS:.1f}% of peak')
        print(f'time {model} {name:21s} bf16 B,H,Lq,Lk={shape} x{per_eval}/eval '
              f'event={row["ms"]:.4f} ms device={d_ms:.4f} ms '
              f'plain={row["plain_ms"]:.4f} ms bound={b_ms:.5f} ms ({by}), '
              f'{100 * b_ms / d_ms:.1f}% of the device time{extra}')
    for name, tot in totals.items():
        lib = (f' sdpa={tot["library_ms"]:.4f} ms (device '
               f'{tot["library_device_ms"]:.4f})' if tot['library_ms'] else '')
        print(f'time {model} {name:21s} per UNet evaluation: event={tot["ms"]:.4f} ms '
              f'device={tot["device_ms"]:.4f} ms plain={tot["plain_ms"]:.4f} ms '
              f'bound={tot["bound_ms"]:.5f} ms{lib}')
    return totals


def transplant(pipe, trace, kernels):
    """Phase 5: save_heads -> load_heads at full width; returns the save
    run's launch counts."""
    import numpy as np
    import torch

    def run(prompt, **trace_kwargs):
        kernels.reset_launches()
        out, steps, tc = timed_call(pipe, True, trace, prompt=prompt,
                                    data_dir='smoke', **trace_kwargs)
        launches = dict(kernels.launches)
        print(f'{list(trace_kwargs)[0]} run {prompt!r}: launches {launches}, '
              f'{sum(steps):.3f} s for {STEPS} steps')
        return out.images[0], tc, launches

    image_s, tc_s, save_launches = run(PROMPT, save_heads=True,
                                       persist_heads=False)
    check(save_launches == {'cross_attention_probs': K5_PER_EVAL * STEPS,
                            'cross_attention_probs_mma': K5_PER_EVAL * STEPS,
                            'flash_attention': K2_PER_EVAL_REPLAY * STEPS,
                            'flash_attention_wgmma': K2_PER_EVAL_REPLAY * STEPS,
                            'cross_attention_acc': 0, 'cross_attention_acc_mma': 0},
          f'save run launch counts {save_launches}')
    buf = tc_s.replay_buffer(STEPS)
    check(len(buf) == N_LAYERS, f'{len(buf)} layers in the replay buffer')
    nbytes = 0
    latent = pipe.config.image_size // pipe.vae_scale_factor
    for name, arr in buf.items():
        info = pipe._layout[name]
        hw = (latent // info.downscale) ** 2
        check(tuple(arr.shape) == (STEPS, 2, info.heads, hw, 77)
              and arr.dtype == torch.bfloat16, f'{name}: {tuple(arr.shape)}')
        a = arr.to(pipe.device).float()
        row_err = (a.sum(-1) - 1).abs().max().item()
        check(bool(torch.isfinite(a).all()) and row_err <= 1e-2,
              f'{name}: finite rows summing to 1 (max err {row_err:.3e})')
        nbytes += arr.numel() * arr.element_size()
    print(f'replay buffer: {len(buf)} layers, {nbytes / STEPS / 1e6:.1f} MB of '
          f'bf16 per step, rows sum to 1 within 1e-2')

    image_l, tc_l, load_launches = run(PROMPT, load_heads=True)
    check(load_launches == {'cross_attention_probs': 0, 'cross_attention_probs_mma': 0,
                            'cross_attention_acc': 0, 'cross_attention_acc_mma': 0,
                            'flash_attention': K2_PER_EVAL_REPLAY * STEPS,
                            'flash_attention_wgmma': K2_PER_EVAL_REPLAY * STEPS},
          f'load run launch counts {load_launches}')
    map_s = tc_s.compute_global_heat_map().heat_maps
    map_l = tc_l.compute_global_heat_map().heat_maps
    rhos = [spearman(map_l[t], map_s[t]) for t in range(map_s.shape[0])]
    print(f'load vs save run, same prompt: per-token heat-map spearman min '
          f'{min(rhos):.6f} over {len(rhos)} tokens; image max_abs_err '
          f'{float(abs(image_l - image_s).max()):.3e}')
    check(min(rhos) >= 0.999, 'replayed heat maps match the saved run')

    image_t, _, _ = run(PROMPT2, load_heads=True)
    fresh, _, _ = timed_call(pipe, False, trace, prompt=PROMPT2)
    diff = float(abs(image_t - fresh.images[0]).mean())
    print(f'transplant into {PROMPT2!r} vs a fresh run of it: mean abs diff '
          f'{diff:.4e}')
    check(bool(np.isfinite(image_t).all()) and diff > 1e-3,
          'the transplanted image differs from a fresh run')
    return save_launches


def step_times(pipe, trace, label):
    """Seconds per step traced and untraced: warm runs in turns, each
    without its first step (which includes the text encode)."""
    per_step = {True: [], False: []}
    for traced in (False, True, False, True):
        _, steps, _ = timed_call(pipe, traced, trace)
        per_step[traced] += steps[1:]
    traced_s = sum(per_step[True]) / len(per_step[True])
    untraced_s = sum(per_step[False]) / len(per_step[False])
    print(f's/step {label}: traced={traced_s:.5f} untraced={untraced_s:.5f} '
          f'traced/untraced={traced_s / untraced_s:.4f}')


def v2_step_times(pipe, trace, A):
    """Phase 6a: v2-1-base's seconds per step traced and untraced, traced
    through the plain versions, and of the save and load runs."""
    step_times(pipe, trace, 'v2-1-base 512^2 bf16')
    A.set_kernel_mode('torch')
    try:
        _, steps, _ = timed_call(pipe, True, trace)
    finally:
        A.set_kernel_mode('auto')
    print(f's/step traced, plain attention instead of the kernels: '
          f'{sum(steps[1:]) / len(steps[1:]):.5f}')
    replay_steps = {'save_heads': [], 'load_heads': []}
    for _ in range(2):
        for flag in replay_steps:
            _, steps, _ = timed_call(pipe, True, trace, data_dir='smoke',
                                     persist_heads=False, **{flag: True})
            replay_steps[flag] += steps[1:]
    print('s/step v2-1-base 512^2 bf16, head replay: ' + ' '.join(
        f'{flag}={sum(v) / len(v):.5f} (slowest step {max(v):.5f})'
        for flag, v in replay_steps.items()))


def sdxl_full_width(StableDiffusionPipeline, trace, kernels, A, profile: bool):
    """Phase 7: xl-base-1.0 at full width; returns the launch counts of
    its traced run."""
    import numpy as np
    import torch

    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline.from_pretrained('xl-base-1.0', device='cuda',
                                                   dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (pipe.unet, pipe.text_encoder,
                                       pipe.text_encoder_2, pipe.vae)
                   for p in m.parameters())
    print(f'xl-base-1.0 init (random weights, bf16): '
          f'{time.perf_counter() - t0:.2f} s, {type(pipe).__name__}, '
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
    out, cold_steps, tc = timed_call(pipe, True, trace)
    launches = dict(kernels.launches)
    image = out.images[0]
    word = tc.compute_global_heat_map().compute_word_heat_map('dog').heatmap
    print(f'xl-base-1.0 main path launches: {launches}')
    print(f'xl-base-1.0 image {image.shape} range [{image.min():.4f}, '
          f'{image.max():.4f}]; dog map {tuple(word.shape)} range '
          f'[{word.min().item():.4e}, {word.max().item():.4e}]; VAE decoder '
          f'calls {decodes}; peak memory '
          f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB')
    print(f'xl-base-1.0 first traced call: {sum(cold_steps):.3f} s for {STEPS} steps')
    check(image.shape == (1024, 1024, 3) and bool(np.isfinite(image).all()),
          'xl-base-1.0 image')
    check(tuple(word.shape) == (64, 64) and bool(torch.isfinite(word).all())
          and bool((word >= 0).all()) and word.max().item() > word.min().item(),
          'xl-base-1.0 word heat map')
    check(decodes == [SDXL_TILES], f'tiled VAE decode: decoder calls {decodes}')
    check(launches == {'cross_attention_acc': SDXL_K1_PER_EVAL * STEPS,
                       'cross_attention_acc_mma': SDXL_K1_PER_EVAL * STEPS,
                       'flash_attention': SDXL_K2_PER_EVAL * STEPS,
                       'flash_attention_wgmma': SDXL_K2_PER_EVAL * STEPS,
                       'cross_attention_probs': 0, 'cross_attention_probs_mma': 0},
          f'xl-base-1.0 launch counts {launches}')

    # one traced step through the kernels and one through the plain
    # versions, from the same latents (the same generator seed)
    maps = {}
    for mode in ('auto', 'torch'):
        A.set_kernel_mode(mode)
        try:
            _, _, tc1 = timed_call(pipe, True, trace, steps=1)
        finally:
            A.set_kernel_mode('auto')
        maps[mode] = tc1.compute_global_heat_map().heat_maps
    rhos = [spearman(maps['auto'][t], maps['torch'][t])
            for t in range(maps['auto'].shape[0])]
    print(f'xl-base-1.0 one traced step, kernels vs plain: per-token heat-map '
          f'spearman min {min(rhos):.6f} over {len(rhos)} tokens')
    check(min(rhos) >= 0.99, 'xl-base-1.0 kernel maps vs plain maps')

    step_times(pipe, trace, 'xl-base-1.0 1024^2 bf16')
    latents = torch.randn(1, 4, 128, 128, device=pipe.device)
    for _ in range(2):  # the second call is timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            pipe._decode(latents)
        torch.cuda.synchronize()
    print(f'xl-base-1.0 tiled VAE decode (9 tiles, one batch): '
          f'{time.perf_counter() - t0:.4f} s, peak memory '
          f'{torch.cuda.max_memory_allocated() / 1e9:.2f} GB')
    if profile:
        profile_step(pipe, trace)
    return launches


def profile_step(pipe, trace):
    """A traced 2-step call of ``pipe`` under torch.profiler: the top
    kernels, and the device's busy share of the call's wall time (one
    stream, so the kernel times add up without overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timed_call(pipe, True, trace, steps=2)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    print(events.table(sort_by='self_cuda_time_total', row_limit=25))
    device = [e for e in events if e.device_type != DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in device) / 1e3
    print(f'profiled traced {pipe.config.name} call (2 steps, encode, decode): '
          f'wall {wall_ms:.3f} ms, '
          f'device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%)')
    for e in device:  # the port's own kernels, wherever they rank
        if '_attention' in e.key and e.key.startswith('void (anonymous'):
            print(f'  {e.key.split("::", 1)[1].split("(")[0]}: {e.count} launches, '
                  f'{e.self_device_time_total / 1e3:.3f} ms, '
                  f'{100 * e.self_device_time_total / 1e3 / busy_ms:.1f}% of busy')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--profile', action='store_true',
                        help='print a torch.profiler table of a traced run')
    parser.add_argument('--kernel-times', action='store_true',
                        help='build and time the kernels only (phase 6b); '
                             'no checks beyond the build, no result line')
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
    if args.kernel_times:
        for model in PATH_SHAPES:
            kernel_times(kernels, A, model)
        print(smi)
        return
    # flash_attention: one per head dim; cross_attention_mma_kernel: acc,
    # and P in fp32 and bf16, per head dim
    for family, count in (('flash_attention_wgmma_kernel', len(kernels.HEAD_DIMS)),
                          ('cross_attention_mma_kernel', 3 * len(kernels.HEAD_DIMS))):
        tensor_core = [n for n in report if family in n]
        check(len(tensor_core) == count,
              f'ptxas reports {len(tensor_core)} kernels {family}, not {count}')
        for name in tensor_core:
            check(any(' 0 bytes spill stores, 0 bytes spill loads' in x
                      for x in report[name]), f'{name} spills registers')

    # 2-3. parity, with TF32 off for the fp32 checks
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = parity(kernels, A)
    for preset in ('tiny', 'tiny-xl'):
        tiny_reference(A, StableDiffusionPipeline, trace, preset)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

    # 6b. the kernels alone at both paths' shapes, before any other
    # profiler session (after --profile's, the card's profiler was seen to
    # drop kernels)
    totals = {model: kernel_times(kernels, A, model) for model in PATH_SHAPES}

    # 4. the slice at full width
    t0 = time.perf_counter()
    pipe = StableDiffusionPipeline.from_pretrained('v2-1-base', device='cuda',
                                                   dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f'v2-1-base init (random weights, bf16): {time.perf_counter() - t0:.2f} s')
    kernels.reset_launches()
    out, cold_steps, tc = timed_call(pipe, True, trace)
    launches = dict(kernels.launches)
    image = out.images[0]
    word = tc.compute_global_heat_map().compute_word_heat_map('dog').heatmap
    print(f'main path launches: {launches}')
    print(f'image {image.shape} range [{image.min():.4f}, {image.max():.4f}]; '
          f'dog map {tuple(word.shape)} range [{word.min().item():.4e}, '
          f'{word.max().item():.4e}]')
    print(f'first traced call: {sum(cold_steps):.3f} s for {STEPS} steps')
    import numpy as np
    check(image.shape == (512, 512, 3) and bool(np.isfinite(image).all()), 'image')
    check(tuple(word.shape) == (64, 64) and bool(torch.isfinite(word).all())
          and bool((word >= 0).all()) and word.max().item() > word.min().item(),
          'word heat map')
    check(launches == {'cross_attention_acc': K1_PER_EVAL * STEPS,
                       'cross_attention_acc_mma': K1_PER_EVAL * STEPS,
                       'flash_attention': K2_PER_EVAL * STEPS,
                       'flash_attention_wgmma': K2_PER_EVAL * STEPS,
                       'cross_attention_probs': 0, 'cross_attention_probs_mma': 0},
          f'launch counts {launches}')

    # 5. the transplant at full width
    launches['cross_attention_probs'] = transplant(
        pipe, trace, kernels)['cross_attention_probs']

    # 6a. step timings
    v2_step_times(pipe, trace, A)
    if args.profile:
        profile_step(pipe, trace)
    del pipe, tc
    gc.collect()
    torch.cuda.empty_cache()

    # 7. SDXL at full width
    sdxl_launches = sdxl_full_width(StableDiffusionPipeline, trace, kernels, A,
                                    args.profile)

    route = {'flash_attention': 'daam_tpu/ops/pallas_attention.py:169',
             'cross_attention_acc': 'daam_tpu/ops/pallas_attention.py:517',
             'cross_attention_probs': 'daam_tpu/ops/pallas_attention.py:405'}

    def kernel_lines(totals, launches):
        return [{'name': name, 'route': 'cuda',
                 'source': 'daam_tpu_torch/csrc/attention.cu',
                 'replaces': route[name], 'launches': launches[name],
                 'max_abs_err': worst[name], 'ms': t['ms'],
                 'device_ms': t['device_ms'], 'plain_ms': t['plain_ms'],
                 'bound_ms': t['bound_ms'],
                 'bound_by': max(t['by'], key=t['by'].get),
                 'library_ms': t['library_ms']}
                for name, t in ((n, totals[n]) for n in (
                    'cross_attention_acc', 'flash_attention',
                    'cross_attention_probs'))]
    # per SDXL evaluation; cross_attention_probs per evaluation of an SDXL
    # save run, which phase 7 does not drive (launches 0)
    print(json.dumps({'sdxl_kernels': kernel_lines(totals['xl-base-1.0'],
                                                   sdxl_launches)}))
    print(smi)
    print(json.dumps({'kernels': kernel_lines(totals['v2-1-base'], launches)}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
