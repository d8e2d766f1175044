#!/usr/bin/env python3
"""Smoke run of daam_tpu_torch on one NVIDIA GPU: build, kernel parity, the
traced SD 2.1-base slice, the head-replay transplant, timings.

    python3 chip_smoke.py              # from the repository root
    python3 chip_smoke.py --profile    # also a torch.profiler table of one step

Phases, each of which raises (exit code != 0) when a check fails:

1. Build ``daam_tpu_torch/csrc/attention.cu`` with nvcc for sm_90a; print
   each kernel's registers and spills, and fail if the tensor-core
   ``flash_attention`` spills.
2. Kernel parity at the paths' shapes, kernel against its plain PyTorch
   version on the same inputs: ``flash_attention`` in both layouts
   (head-major view and the (B, L, H·hd) projection output), in fp32 (the
   CUDA-core kernel) at Lk ∈ {4096, 1024, 77}, and in bf16 (the tensor-core
   kernel) at every head dim of ``HEAD_DIMS`` and every shape of
   ``K2_SHAPES``, the main path's (Lq ∈ {4096, 1024, 256, 64}, Lk = Lq or 77);
   ``cross_attention_acc`` in both layouts and both dtypes, called twice
   into the same accumulator; ``cross_attention_probs`` in both layouts and
   both dtypes, with and without ``cond_only``, P in fp32 and bf16, at every
   shape of the save run (P compared on the rows it writes).  TF32 is off
   for the fp32 checks.  Max abs error ≤ 1e-4 (fp32 outputs), ≤ 1e-5 (fp32
   accumulator and fp32 P), ≤ 2e-2 (bf16); Spearman ≥ 0.999.  Each bf16
   ``flash_attention`` and ``cross_attention_acc`` output must lie closer
   (mean abs difference) to a reference that rounds P to bf16 before PV
   where the Pallas body does than to the same reference with fp32 P.
3. A small reference: the ``tiny`` preset in fp32, kernels against the plain
   path, same weights and latents: images within 1e-3, heat maps with
   per-token Spearman ≥ 0.999; then an fp32 save_heads → load_heads pair
   under each, whose buffers agree within 1e-5 and images within 1e-3.
4. The main path at full width: ``v2-1-base`` (random weights from seed 0),
   bf16, 512², 10 traced DDIM steps through ``trace(pipe)``; the image must
   be (512, 512, 3) and finite, the word map for "dog" (64, 64), finite,
   ≥ 0 and not constant, and the launch counters, zeroed just before the
   run, must read 15 × 10 (cross_attention_acc) and 32 × 10
   (flash_attention, every one on the tensor cores).
5. The transplant at full width, the same model: a ``save_heads`` run of the
   prompt (counters: 16 × 10 cross_attention_probs, 16 × 10
   flash_attention on the tensor cores, no cross_attention_acc), whose bf16
   buffer must hold 16 layers of (10, 2, H, h·w, 77), finite, rows summing
   to 1 within 1e-2; a ``load_heads`` run of the same prompt (counters: 16
   × 10 flash_attention on the tensor cores, nothing else), whose per-token
   heat maps must match the save run's at Spearman ≥ 0.999; and a
   ``load_heads`` run of a second prompt, whose image must differ from a
   fresh run of that prompt.
6. Seconds per step traced and untraced (host clock, synchronized per step,
   warm runs in turns) and of the save and load runs, and each kernel's time
   against its plain version at every shape of its path (CUDA events after a
   warm-up), with ``flash_attention``'s TFLOP/s (4·B·H·Lq·Lk·hd FLOP) and
   share of the H100's 989 TFLOP/s dense bf16 peak.

The line before the last is ``{"kernels": [...]}``: per kernel, its launches
in its path's run (phase 4, or the phase-5 save run for
cross_attention_probs), the largest bf16 max-abs error of phase 2, and
``ms`` / ``plain_ms``: the time of one UNet evaluation's worth of its
launches (each shape's time × its launches per evaluation).  The last line
is ``{"ok": true, "device": {...}}``.  The script needs a CUDA device and
the daam_tpu_torch package beside it; it never imports JAX or PIL.
"""

import argparse
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
HD = 64
BF16_PEAK_TFLOPS = 989.0  # H100 SXM, dense (NVIDIA's data sheet)


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
    # fp32 runs on the CUDA-core kernel at hd 64; bf16 on the tensor-core
    # kernel at every head dim it serves and every shape of the main path
    # (the mid block's Lq = 64 fills only half of a 128-query block).
    flash_cases = {
        torch.float32: [(HD, sh) for sh in ((2, 5, 4096, 4096), (2, 10, 1024, 1024),
                                            (1, 5, 4096, 77))],
        torch.bfloat16: [(hd, sh) for hd in kernels.HEAD_DIMS for sh, _ in K2_SHAPES]}
    for dtype in (torch.float32, torch.bfloat16):
        for layout in ('head_major', 'packed'):
            n_tc = kernels.launches['flash_attention_wgmma']
            for hd, shape in flash_cases[dtype]:
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
                if dtype == torch.bfloat16:
                    worst['flash_attention'] = max(worst['flash_attention'], err)
                    check_rounding('flash_attention', o, flash_reference(q, k, v, True),
                                   flash_reference(q, k, v, False))
            n_tc = kernels.launches['flash_attention_wgmma'] - n_tc
            check(n_tc == (len(flash_cases[dtype]) if dtype == torch.bfloat16 else 0),
                  f'{n_tc} {dtype} flash_attention launches on the tensor cores')
            for shape in ((1, 5, 4096, 77), (1, 10, 1024, 77), (1, 20, 256, 77)):
                B, H, Lq, Lk = shape
                acc = torch.zeros(B, H, Lk, Lq, device='cuda')
                acc_plain = acc.clone()
                for _ in range(2):
                    q, k, v = qkv(*shape, layout, dtype, gen)
                    o = kernels.cross_attention_acc(q, k, v, acc)
                    r = A.cross_attention_acc_plain(q, k, v, acc_plain)
                torch.cuda.synchronize()
                err = (o.float() - r.float()).abs().max().item()
                acc_err = (acc - acc_plain).abs().max().item()
                rho = min(spearman(o, r), spearman(acc, acc_plain))
                print(f'parity cross_attention_acc {layout:10s} {str(dtype):14s} '
                      f'B,H,Lq,Lk={shape} max_abs_err={err:.3e} '
                      f'acc_max_abs_err={acc_err:.3e} spearman={rho:.6f}')
                acc_tol = 1e-5 if dtype == torch.float32 else 2e-2
                check(err <= tol[dtype] and acc_err <= acc_tol and rho >= 0.999,
                      'cross_attention_acc parity')
                if dtype == torch.bfloat16:
                    worst['cross_attention_acc'] = max(
                        worst['cross_attention_acc'], err, acc_err)
                    # the plain version rounds normalized P before PV
                    check_rounding('cross_attention_acc', o, r,
                                   cross_reference(q, k, v, False))
            for shape, _ in K5_SHAPES:
                B = shape[0]
                q, k, v = qkv(*shape, layout, dtype, gen)
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
                              f'{str(dtype):14s} B,H,Lq,Lk={shape} '
                              f'cond_only={cond_only!s:5s} P {str(pdt):14s} '
                              f'max_abs_err={err:.3e} p_max_abs_err={p_err:.3e} '
                              f'spearman={rho:.6f}')
                        p_tol = 1e-5 if pdt == torch.float32 else 2e-2
                        check(err <= tol[dtype] and p_err <= p_tol and rho >= 0.999,
                              'cross_attention_probs parity')
                        if torch.bfloat16 in (dtype, pdt):
                            worst['cross_attention_probs'] = max(
                                worst['cross_attention_probs'], err, p_err)
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


def tiny_reference(A, StableDiffusionPipeline, trace):
    """Phase 3: kernels against the plain path on the tiny preset."""
    import torch

    pipe = StableDiffusionPipeline.from_pretrained('tiny', device='cuda')
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
    print(f'tiny reference (fp32, kernels vs plain): image max_abs_err={im_err:.3e} '
          f'heat-map min spearman={rho:.6f} max rel err={map_err:.3e}')
    check(im_err <= 1e-3 and rho >= 0.999, 'tiny kernel path vs plain path')

    # fp32 save -> load of the same prompt, kernels against the plain path
    pipe.heads_dtype = torch.float32
    replay = {}
    for mode in ('torch', 'auto'):
        A.set_kernel_mode(mode)
        try:
            out_s, _, tc = timed_call(pipe, True, trace, steps=3, save_heads=True,
                                      persist_heads=False, data_dir=f'tiny-{mode}')
            out_l, _, _ = timed_call(pipe, True, trace, steps=3, load_heads=True,
                                     data_dir=f'tiny-{mode}')
            replay[mode] = (tc.replay_buffer(3), out_s.images[0], out_l.images[0])
        finally:
            A.set_kernel_mode('auto')
    (buf_p, save_p, load_p), (buf_k, save_k, load_k) = replay['torch'], replay['auto']
    buf_err = max((buf_k[n] - buf_p[n]).abs().max().item() for n in buf_p)
    im_err = max(float(abs(save_k - save_p).max()), float(abs(load_k - load_p).max()))
    print(f'tiny save/load (fp32 heads, kernels vs plain): {len(buf_k)} layers, '
          f'buffer max_abs_err={buf_err:.3e}, image max_abs_err={im_err:.3e}, '
          f'replayed vs saved image max_abs_err={float(abs(load_k - save_k).max()):.3e}')
    check(sorted(buf_k) == sorted(buf_p) and buf_err <= 1e-5 and im_err <= 1e-3,
          'tiny save/load kernel path vs plain path')


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


def kernel_times(kernels, A):
    """Phase 5b: bf16 kernel vs plain at every main-path shape; returns the
    per-UNet-evaluation totals."""
    import torch

    gen = torch.Generator(device='cuda').manual_seed(1)
    totals = {name: [0.0, 0.0] for name in
              ('flash_attention', 'cross_attention_acc', 'cross_attention_probs')}
    for name, shapes in (('flash_attention', K2_SHAPES),
                         ('cross_attention_acc', K1_SHAPES),
                         ('cross_attention_probs', K5_SHAPES)):
        for shape, per_eval in shapes:
            q, k, v = qkv(*shape, 'packed', torch.bfloat16, gen)
            if name == 'flash_attention':
                kern = lambda: kernels.flash_attention(q, k, v)  # noqa: E731
                plain = lambda: A.flash_attention_plain(q, k, v)  # noqa: E731
            elif name == 'cross_attention_probs':  # the 'full' capture
                kern = lambda: kernels.cross_attention_probs(q, k, v)  # noqa: E731
                plain = lambda: A.cross_attention_probs_plain(q, k, v)  # noqa: E731
            else:
                B, H, Lq, Lk = shape
                acc = torch.zeros(B, H, Lk, Lq, device='cuda')
                kern = lambda: kernels.cross_attention_acc(q, k, v, acc)  # noqa: E731
                plain = lambda: A.cross_attention_acc_plain(q, k, v, acc)  # noqa: E731
            # plain, kernel, kernel, plain: the card's clocks drift in a run
            p1, k1, k2, p2 = (event_ms(f) for f in (plain, kern, kern, plain))
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            totals[name][0] += ms * per_eval
            totals[name][1] += plain_ms * per_eval
            rate = ''
            if name == 'flash_attention':
                B, H, Lq, Lk = shape
                tflops = 4 * B * H * Lq * Lk * HD / ms / 1e9
                rate = (f' ({tflops:.1f} TFLOP/s, {100 * tflops / BF16_PEAK_TFLOPS:.1f}% '
                        f'of peak; plain {4 * B * H * Lq * Lk * HD / plain_ms / 1e9:.1f})')
            print(f'time {name:20s} bf16 B,H,Lq,Lk={shape} x{per_eval}/eval '
                  f'kernel={ms:.4f} ms plain={plain_ms:.4f} ms{rate}')
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
                            'flash_attention': K2_PER_EVAL_REPLAY * STEPS,
                            'flash_attention_wgmma': K2_PER_EVAL_REPLAY * STEPS,
                            'cross_attention_acc': 0},
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
    check(load_launches == {'cross_attention_probs': 0, 'cross_attention_acc': 0,
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


def profile_step(pipe, trace):
    """A traced 2-step call under torch.profiler: the top kernels, and the
    device's busy share of the call's wall time (one stream, so the kernel
    times add up without overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timed_call(pipe, True, trace, steps=2)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    print(events.table(sort_by='self_cuda_time_total', row_limit=25))
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type != DeviceType.CPU) / 1e3
    print(f'profiled traced call (2 steps, encode, decode): wall {wall_ms:.3f} ms, '
          f'device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%)')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--profile', action='store_true',
                        help='print a torch.profiler table of a traced run')
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
    tensor_core = [n for n in report if 'flash_attention_wgmma_kernel' in n]
    check(len(tensor_core) == len(kernels.HEAD_DIMS),
          f'ptxas reports {len(tensor_core)} tensor-core flash_attention kernels')
    for name in tensor_core:
        check(any(' 0 bytes spill stores, 0 bytes spill loads' in x for x in report[name]),
              f'{name} spills registers')

    # 2-3. parity, with TF32 off for the fp32 checks
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = parity(kernels, A)
    tiny_reference(A, StableDiffusionPipeline, trace)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32

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
                       'flash_attention': K2_PER_EVAL * STEPS,
                       'flash_attention_wgmma': K2_PER_EVAL * STEPS,
                       'cross_attention_probs': 0},
          f'launch counts {launches}')

    # 5. the transplant at full width
    launches['cross_attention_probs'] = transplant(
        pipe, trace, kernels)['cross_attention_probs']

    # 6. timings: warm runs in turns, then the kernels alone
    per_step = {True: [], False: []}
    for traced in (False, True, False, True):
        _, steps, _ = timed_call(pipe, traced, trace)
        per_step[traced] += steps[1:]  # the first step includes text encode
    traced_s = sum(per_step[True]) / len(per_step[True])
    untraced_s = sum(per_step[False]) / len(per_step[False])
    print(f's/step v2-1-base 512^2 bf16: traced={traced_s:.5f} '
          f'untraced={untraced_s:.5f} traced/untraced={traced_s / untraced_s:.4f}')
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
    totals = kernel_times(kernels, A)
    if args.profile:
        profile_step(pipe, trace)

    route = {'flash_attention': 'daam_tpu/ops/pallas_attention.py:169',
             'cross_attention_acc': 'daam_tpu/ops/pallas_attention.py:517',
             'cross_attention_probs': 'daam_tpu/ops/pallas_attention.py:405'}
    print(smi)
    print(json.dumps({'kernels': [
        {'name': name, 'route': 'cuda',
         'source': 'daam_tpu_torch/csrc/attention.cu', 'replaces': route[name],
         'launches': launches[name], 'max_abs_err': worst[name],
         'ms': totals[name][0], 'plain_ms': totals[name][1]}
        for name in ('cross_attention_acc', 'flash_attention',
                     'cross_attention_probs')]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
