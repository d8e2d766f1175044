"""The readings that the limits of ``correct`` are set from, in one process.

    python3 -m gpubench.core.readings --workload <name> \
        --program-seeds 1 2 ... --control-seeds 7 8 9 [--control lower|tf32]

For each program seed: the weights drawn from it, the program built as a
run builds it, one request of the cell's flow at the cell's size (the
traffic's first request of that seed, after a warm-up request), then the
comparison of :mod:`gpubench.core.compare`, as a run makes it after its
window.  For each control seed: the same comparison of the control, the
reference put in the program's place and run free in the precision below
the configuration's (``lower``: bfloat16 for a float32 configuration,
float8 operands on bfloat16 for a bfloat16 one; ``tf32``: float32 with its
matrix products and convolutions on TF32, for a float32 configuration whose
linears and attention run float32).  Prints one JSON line per seed and a
summary: the largest program reading and the smallest control reading of
each number.
"""

import argparse
import gc
import json
import sys
from typing import Dict, List

import torch

from . import compare, runner, spec, traffic, weights
from ..reference.pipeline import Reference


def program_reading(cell, cfg, seed: int, device) -> Dict[str, float]:
    tr, steps = cell['traffic'], cfg['run']['steps']
    runner.program_precision(cfg, device)
    import tempfile
    from pathlib import Path

    out_dir = Path(tempfile.gettempdir()) / f"gpubench-readings-{cell['workload']['name']}"
    out_dir.mkdir(parents=True, exist_ok=True)
    pipe = runner.build_program(cfg, seed, device)
    ctx = runner.Ctx(pipe, cfg, out_dir, device)
    flow = cell['flow'].Flow(ctx)
    with runner.host_settings(cfg):
        flow.request(next(traffic.requests(tr, seed, start=-1)), tr['warmup_steps'],
                     ctx.new_clock())
        runs = [compare.retain(r) for r in
                flow.request(next(traffic.requests(tr, seed)), steps, ctx.new_clock())]
    del flow, ctx, pipe
    import daam_tpu_torch
    daam_tpu_torch.release_heads()
    gc.collect()
    compare.reference_precision()
    ref = Reference(cfg, weights.state_dicts(cfg, seed, device), device)
    outs = [compare.program_outputs(r, ref) for r in runs]
    nums = compare.compare(ref, outs, steps, cfg['run']['guidance_scale'])
    del ref, outs, runs
    gc.collect()
    return nums


def control_reading(cell, cfg, seed: int, device, control: str = 'lower') -> Dict[str, float]:
    tr, steps, guidance = cell['traffic'], cfg['run']['steps'], cfg['run']['guidance_scale']
    compare.reference_precision()
    sds = weights.state_dicts(cfg, seed, device)
    ref = Reference(cfg, sds, device)
    low = (dict(tf32=True) if control == 'tf32' else
           dict(dtype=torch.bfloat16, fp8=cfg['dtype'] == 'bfloat16'))
    ctl = Reference(cfg, sds, device, **low)
    req = next(traffic.requests(tr, seed))
    lib = spec.load_module(spec.ROOT / 'flows' / 'lib.py')
    words = None if tr['flow'] == 'cli' else [lib.words(p) for p in req['prompts']]
    if tr['flow'] == 'transplant':
        save = compare.control_outputs(ctl, 'save', req['prompts'], req['seeds'], steps,
                                       guidance, words)
        load = compare.control_outputs(ctl, 'load', req['counterfactuals'], req['seeds'],
                                       steps, guidance,
                                       [lib.words(p) for p in req['counterfactuals']],
                                       replay=save['heads'])
        outs = [save, load]
    else:
        prompts = req['prompts']
        if tr['flow'] == 'cli':
            prompts = [p.replace(',', ' ,').replace('.', ' .').strip() for p in prompts]
        outs = [compare.control_outputs(ctl, 'plain', prompts, req['seeds'], steps,
                                        guidance, words, overlays=tr['flow'] == 'cli')]
    nums = compare.compare(ref, outs, steps, guidance)
    del ref, ctl, sds, outs
    gc.collect()
    return nums


def summary(program: List[Dict[str, float]], control: List[Dict[str, float]]) -> dict:
    names = sorted({k for r in program + control for k in r})
    return {n: {'program_max': max((r[n] for r in program if n in r), default=None),
                'control_min': min((r[n] for r in control if n in r), default=None)}
            for n in names}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--program-seeds', type=int, nargs='*', default=[])
    p.add_argument('--control-seeds', type=int, nargs='*', default=[])
    p.add_argument('--control', choices=('lower', 'tf32'), default='lower')
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('readings: no CUDA device', file=sys.stderr)
        return 3
    cell = spec.cell(args.workload, spec.benchmark())
    cfg = cell['config']
    prog, ctl = [], []
    for s in args.program_seeds:
        prog.append(program_reading(cell, cfg, s, 'cuda'))
        print(json.dumps({'program_seed': s, **prog[-1]}), flush=True)
    for s in args.control_seeds:
        ctl.append(control_reading(cell, cfg, s, 'cuda', args.control))
        print(json.dumps({'control_seed': s, 'control': args.control, **ctl[-1]}), flush=True)
    print(json.dumps({'summary': summary(prog, ctl), 'limits': cell['limits']['limits']}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
