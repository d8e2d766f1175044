"""What the spans of ``daam_tpu_torch.profiling`` cost.

    python scripts/span_cost.py           # per span site, off and on, on the CPU
    python scripts/span_cost.py --card    # and s/step on the card, spans on against off

The first part times ``with span(...)`` in a loop: the off path (no
profiler, no ``enable()``: one flag test and a shared no-op object) and
the on path (a record into the ring).  With ``--card`` it then runs a
traced 30-step call of SD 2.1-base at 512² in float32 (TF32 convolutions,
fp32 matrix products) and of SDXL at 1024² in bfloat16, random weights,
outside any profiler, alternating ``profiling.disable()`` and
``profiling.enable()``; each step is timed by CUDA events recorded in the
step callback without a sync, and the mean of steps 1..29 is printed per
call, with the ratio on ÷ off.  One JSON line per reading.
"""

import argparse
import json
import statistics
import subprocess
import sys
import timeit
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from daam_tpu_torch import profiling  # noqa: E402


def site_cost(n: int = 200_000) -> dict:
    """Microseconds per ``with span(...)`` site, off and on."""
    span = profiling.span

    def bare():
        with span('unet'):
            pass

    def with_attr():
        with span('step', step=3):
            pass

    out = {}
    profiling.disable()
    for name, fn in (('off', bare), ('off_attrs', with_attr)):
        out[name] = min(timeit.repeat(fn, number=n, repeat=5)) / n * 1e6
    profiling.enable()
    out['on'] = min(timeit.repeat(bare, number=n // 4, repeat=5)) / (n // 4) * 1e6
    profiling.disable()
    profiling.clear()
    return out


def card_name() -> str:
    try:
        r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return 'not read'


def step_cost(preset: str, dtype, reps: int, steps: int = 30) -> dict:
    """Mean s/step of traced calls with spans off and on, in turns."""
    import daam_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    pipe = daam_tpu_torch.StableDiffusionPipeline.from_pretrained(
        preset, device='cuda', dtype=dtype)

    def call() -> float:
        events = []

        def on_step(i, t, latents):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        with daam_tpu_torch.trace(pipe):
            pipe('A dog runs across the field .', num_inference_steps=steps,
                 generator=torch.Generator('cuda').manual_seed(0),
                 callback=on_step, callback_steps=1, output_type='np')
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        return sum(ms) / len(ms) / 1e3

    call()  # warm-up: the kernels' build, allocator growth
    call()
    profiling.clear()
    times = {'off': [], 'on': []}
    for k in range(reps):
        for mode in (('off', 'on') if k % 2 == 0 else ('on', 'off')):
            (profiling.enable if mode == 'on' else profiling.disable)()
            times[mode].append(call())
    profiling.disable()
    recorded = len(profiling.spans())
    profiling.clear()
    off, on = statistics.median(times['off']), statistics.median(times['on'])
    del pipe
    torch.cuda.empty_cache()
    return {'preset': preset, 'dtype': str(dtype).replace('torch.', ''),
            's_per_step_off': times['off'], 's_per_step_on': times['on'],
            'median_off': off, 'median_on': on, 'ratio_on_off': on / off,
            'spans_per_step': recorded / reps / steps}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--card', action='store_true', help='also time steps on the card')
    p.add_argument('--reps', type=int, default=8, help='calls per mode on the card')
    args = p.parse_args(argv)
    print(json.dumps({'us_per_site': site_cost(), 'python': sys.version.split()[0],
                      'torch': torch.__version__}), flush=True)
    if args.card:
        print(json.dumps({'card': card_name()}), flush=True)
        for preset, dtype in (('v2-1-base', torch.float32), ('xl-base-1.0', torch.bfloat16)):
            print(json.dumps(step_cost(preset, dtype, args.reps)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
