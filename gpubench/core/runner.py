"""One run of one cell: set-up, the measured window, the traced readings,
the comparison with the reference, and the result line.

Set-up (``setup_s``, from the process's start): the weights drawn on the
card from the seed and loaded into the program through
``daam_tpu_torch.models.weights.load_modules``, the pipeline built as the
configuration states, and one warm-up request at the cell's batch and
resolution (2 steps, with its capture, maps and files).  The window: a
closed loop of one client; requests start while the window is open, and
the window closes on the last one's finish.  As each request finishes, a
sample drawn from the seed (:class:`Sample`) decides whether the harness
copies what the comparison needs into memory of its own; of every other
request it keeps the timings alone.  The time of those copies is not the
program's and is left out of the window.  With ``--trace 1`` the run then
measures the capture's cost and profiles one more request.  Then the
program's state is freed, and the reference checks the sampled requests.
"""

import argparse
import gc
import json
import math
import random
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import contextmanager
from pathlib import Path
from statistics import quantiles
from typing import Dict, List

import torch

from . import compare, spec, traffic, weights
from ..reference import schedulers as samplers
from .clock import RequestClock

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'daam_tpu')


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``daam_tpu_torch`` is not ``daam_tpu``)."""
    return sorted({m.split('.')[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description='Run one cell of the benchmark once.')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


class Ctx:
    """What a flow needs: the pipeline, the guidance, the output directory,
    a generator per seed, a fresh clock, and other flows by name."""

    def __init__(self, pipe, cfg, out_dir: Path, device):
        self.pipe, self.cfg, self.out_dir, self.device = pipe, cfg, out_dir, device
        self.guidance = cfg['run']['guidance_scale']

    def generator(self, seed: int):
        return torch.Generator(device=self.pipe.device).manual_seed(seed)

    def new_clock(self):
        return RequestClock(self.device)

    def load_flow(self, name: str):
        return spec.load_module(spec.ROOT / 'flows' / f'{name}.py')


class Sample:
    """``count`` of the window's requests, drawn from the seed as they
    finish (reservoir sampling: when the window closes, each finished
    request has been held with the same chance, whatever their number)."""

    def __init__(self, count: int, seed: int):
        self.count, self.rng, self.seen = count, random.Random(f'{seed}:sample'), 0
        self.held: List = []

    def slot(self):
        """Where the request that just finished goes, or None."""
        n, self.seen = self.seen, self.seen + 1
        if n < self.count:
            self.held.append(None)
            return n
        j = self.rng.randrange(n + 1)
        return j if j < self.count else None


def program_precision(cfg: dict, device):
    """Matrix products and convolutions as the configuration states."""
    torch.backends.cuda.matmul.allow_tf32 = cfg['run']['matmul_tf32']
    torch.set_float32_matmul_precision('high' if cfg['run']['matmul_tf32'] else 'highest')
    if torch.device(device).type == 'cuda':
        torch.backends.cudnn.allow_tf32 = cfg['run']['conv_tf32']


@contextmanager
def host_settings(cfg: dict):
    """The configuration's host, as far as a running process can set it
    (``gpubench/run.py`` sets its CPU threads before PyTorch loads): with
    ``matplotlib`` false, no matplotlib, so that the port draws its overlays
    itself, as on a machine without it."""
    hidden = {} if cfg['host']['matplotlib'] else {
        k: sys.modules.get(k) for k in ('matplotlib', 'matplotlib.pyplot')}
    for k in hidden:
        sys.modules[k] = None
    try:
        yield
    finally:
        for k, m in hidden.items():
            if m is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = m


def program_config_mismatch(cfg: dict, pcfg) -> List[str]:
    """Keys of the configuration file that the program's preset does not
    hold as stated, and the scheduler the pipeline would build from the
    file's name and the preset's prediction type: each of its fields
    against the file's ``scheduler`` group, and a name it lacks."""
    import dataclasses

    from daam_tpu_torch.pipeline.schedulers import SCHEDULERS, get_scheduler

    groups = {'text_encoder': pcfg.text, 'text_encoder_2': pcfg.text_2,
              'unet': pcfg.unet, 'vae': pcfg.vae}
    bad = []
    name = cfg['scheduler']['name']
    if name in SCHEDULERS:
        groups['scheduler'] = get_scheduler(name, pcfg.prediction_type)
    else:
        bad.append(f'scheduler.name: the program has no {name!r} (it has {sorted(SCHEDULERS)})')
    for group, obj in groups.items():
        if group not in cfg:
            continue
        fields = dataclasses.asdict(obj)
        for k, v in fields.items():
            want = cfg[group].get(k)
            if (list(v) if isinstance(v, tuple) else v) != want:
                bad.append(f'{group}.{k}: program {v!r}, file {want!r}')
    if pcfg.image_size != cfg['run']['image_size']:
        bad.append('run.image_size')
    return bad


def build_program(cfg: dict, seed: int, device):
    """The pipeline, holding the state dicts drawn from ``seed``."""
    import daam_tpu_torch
    from daam_tpu_torch.models.configs import get_pipeline_config
    from daam_tpu_torch.models.weights import load_modules
    from daam_tpu_torch.tokenization import default_tokenizer

    pcfg = get_pipeline_config(cfg['program_preset'])
    bad = program_config_mismatch(cfg, pcfg)
    if bad:
        raise SystemExit('the program does not run the configuration as stated: ' + '; '.join(bad))
    bad = samplers.unsupported(cfg)
    if bad:
        raise SystemExit('the reference does not implement ' + '; '.join(bad))
    t0 = time.monotonic()
    sds = weights.state_dicts(cfg, seed, device)
    sync(device)
    t1 = time.monotonic()
    modules = load_modules(pcfg, sds, device=device, dtype=weights.DTYPES[cfg['dtype']])
    del sds
    sync(device)
    t2 = time.monotonic()
    tok = default_tokenizer(pad_id=cfg['text_encoder']['pad_token_id'])
    print(json.dumps({'weights_s': t1 - t0, 'load_modules_s': t2 - t1,
                      'tokenizer_s': time.monotonic() - t2}), file=sys.stderr)
    if pcfg.is_sdxl:
        pipe = daam_tpu_torch.StableDiffusionXLPipeline(
            pcfg, **modules, tokenizer=tok,
            tokenizer_2=default_tokenizer(pad_id=cfg['text_encoder_2']['pad_token_id']),
            scheduler=cfg['scheduler']['name'])
    else:
        pipe = daam_tpu_torch.StableDiffusionPipeline(pcfg, **modules, tokenizer=tok,
                                                      scheduler=cfg['scheduler']['name'])
    pipe.vae_tile_threshold = cfg['run']['vae_tile_threshold']
    pipe.heads_dtype = weights.DTYPES[cfg['run']['heads_dtype']]
    pipe.heads_chunk_steps = cfg['run']['heads_chunk_steps']
    return pipe


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def power_limit() -> str:
    try:
        r = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                            '--format=csv,noheader'], capture_output=True, text=True,
                           timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else 'not read'
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return 'not read'


def measure_capture_cost(flow_ctx, cfg, req, steps) -> float:
    """Traced ÷ untraced seconds per step (steps 1..n−1, CUDA events), the
    same prompts and generator seeds, two calls each, in turns."""
    import daam_tpu_torch

    pipe = flow_ctx.pipe
    prompts = req['prompts'] if len(req['prompts']) > 1 else req['prompts'][0]

    def call(traced):
        clock = flow_ctx.new_clock()
        gens = [flow_ctx.generator(s) for s in req['seeds']]

        def go():
            clock.begin()
            pipe(prompts, num_inference_steps=steps, generator=gens,
                 guidance_scale=flow_ctx.guidance, callback=clock.on_step,
                 callback_steps=1, output_type='np')
        if traced:
            with daam_tpu_torch.trace(pipe):
                go()
        else:
            go()
        sync(flow_ctx.device)
        ms = clock.step_ms()[1:]
        return sum(ms) / len(ms) if ms else math.nan

    call(False)  # the untraced path's first call
    times = {True: [], False: []}
    for traced in (False, True, True, False):
        times[traced].append(call(traced))
    ratio = sum(times[True]) / sum(times[False])
    return ratio if math.isfinite(ratio) else None


def main(argv=None, t_start: float = None, device: str = 'cuda', config: dict = None) -> int:
    """One run; returns the exit code.  ``device`` and ``config`` are for
    the tests, which run a cell on the CPU at a test size."""
    t_start = time.monotonic() if t_start is None else t_start
    args = parse(argv)
    bench = spec.benchmark()
    cell = spec.cell(args.workload, bench)
    chips = cell['workload']['chips']
    if device == 'cuda' and (not torch.cuda.is_available() or torch.cuda.device_count() < chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'gpubench: the cell needs {chips} CUDA device(s); {n} found', file=sys.stderr)
        return 3
    cfg = config or cell['config']
    with host_settings(cfg):
        return _run(args, cell, cfg, chips, t_start, device)


def _run(args, cell, cfg, chips, t_start, device) -> int:
    tr, limits = cell['traffic'], cell['limits']
    steps = cfg['run']['steps']
    print(json.dumps({'workload': args.workload, 'seed': args.seed, 'seconds': args.seconds,
                      'trace': args.trace, 'torch': torch.__version__}), flush=True)
    program_precision(cfg, device)

    import daam_tpu_torch
    from daam_tpu_torch.ops import kernels

    out_dir = Path(tempfile.gettempdir()) / f'gpubench-{args.workload}'
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    marks = {'imports': time.monotonic() - t_start}
    pipe = build_program(cfg, args.seed, device)
    sync(device)
    marks['weights_and_program'] = time.monotonic() - t_start
    ctx = Ctx(pipe, cfg, out_dir, device)
    flow = cell['flow'].Flow(ctx)
    warm = next(traffic.requests(tr, args.seed, start=-1))
    flow.request(warm, tr['warmup_steps'], ctx.new_clock())
    sync(device)
    marks['warm_up'] = time.monotonic() - t_start
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    kernels.reset_launches()
    setup_s = time.monotonic() - t_start

    # ---------------------------------------------------------- window
    if device == 'cuda':
        torch.cuda.reset_peak_memory_stats()
    records, failed, attempted = [], 0, 0
    sampled = Sample(limits['sampled_requests'], args.seed)
    reqs = traffic.requests(tr, args.seed)
    harness_s = 0.0  # the harness's copies of sampled requests, inside the window
    w0 = time.monotonic()
    w1, harness_at_w1 = w0, 0.0
    while time.monotonic() - w0 - harness_s < args.seconds:
        req = next(reqs)
        attempted += len(req['prompts']) * getattr(flow, 'IMAGES_PER_PROMPT', 1)
        try:
            runs = flow.request(req, steps, ctx.new_clock())
        except Exception:  # a request that fails counts and the loop goes on
            traceback.print_exc()
            failed += len(req['prompts']) * getattr(flow, 'IMAGES_PER_PROMPT', 1)
            continue
        w1, harness_at_w1 = time.monotonic(), harness_s
        slot = sampled.slot()
        if slot is not None:
            sampled.held[slot] = (req, [compare.retain(r) for r in runs])
        records.append((req, [timings(r) for r in runs]))
        del runs
        harness_s += time.monotonic() - w1
    window_s = w1 - w0 - harness_at_w1
    images = sum(len(r['prompts']) for _, runs in records for r in runs)
    peak = torch.cuda.max_memory_allocated() if device == 'cuda' else 0
    launches = dict(kernels.launches)
    step_ms = [ms for _, runs in records for r in runs for ms in r['clock'].step_ms()]

    # what the per-layer metrics' readers read
    data = {'records': records, 'window_s': window_s, 'steps': steps, 'peak_bytes': peak,
            'cfg': cfg, 'chunk': cfg['run']['heads_chunk_steps'], 'profile': None,
            'capture_cost': None}
    per_layer_names = {m['name'] for m in cell['per_layer']}
    result_metrics: Dict[str, dict] = {}
    breakdown = None
    dev = {'platform': 'gpu' if device == 'cuda' else device,
           'kind': torch.cuda.get_device_name(0) if device == 'cuda' else 'cpu',
           'count': chips, 'memory_peak_bytes': peak}
    if args.trace:
        if 'trace.capture_cost' in per_layer_names:
            data['capture_cost'] = measure_capture_cost(ctx, cfg, next(reqs), steps)
        if device == 'cuda':
            from .profile import profile_request
            req = next(reqs)
            prof, runs = profile_request(
                lambda: flow.request(req, steps, ctx.new_clock()),
                lambda: flow.request(warm, tr['warmup_steps'], ctx.new_clock()))
            data['profile'] = prof
            data['profile_runs'] = [(r['kind'], len(r['prompts'])) for r in runs]
            breakdown = prof.breakdown()
            dev.update(busy_s=prof.busy_s, window_s=prof.window_s)
        for m in cell['per_layer']:
            v = spec.reader(m).read(data)
            if v is not None:
                result_metrics[m['name']] = {'value': v, 'unit': m['unit']}
    else:
        e2e = {'images_per_s': images / window_s if window_s > 0 else 0.0,
               'step_p95_ms': (quantiles(step_ms, n=20)[-1] if len(step_ms) > 1 else 0.0),
               'setup_s': setup_s}
        for m in cell['end_to_end']:
            result_metrics[m['name']] = {'value': e2e[m['name']], 'unit': m['unit']}
    print(json.dumps({'kernel_launches': launches,
                      'overlays': 'matplotlib' if _has_matplotlib() else 'PIL',
                      'power': power_limit() if device == 'cuda' else 'cpu',
                      'window_s': window_s, 'harness_s': harness_at_w1,
                      'images': images, 'failed': failed,
                      'step_ms_quartiles': (quantiles(step_ms, n=4) if len(step_ms) > 1 else None),
                      'step_ms_p95_p99_max': ([quantiles(step_ms, n=100)[i] for i in (94, 98)]
                                              + [max(step_ms)] if len(step_ms) > 1 else None),
                      'torch_threads': torch.get_num_threads()}), flush=True)

    # ------------------------------------------------- correct, after all
    del data, ctx, flow
    daam_tpu_torch.release_heads()
    pipe_device = pipe.device
    del pipe
    gc.collect()
    if device == 'cuda':
        torch.cuda.empty_cache()
    t_ref = time.monotonic()
    checks = check(sampled.held, cfg, args.seed, pipe_device, steps, limits)
    print(json.dumps({'setup_marks_s': marks, 'reference_s': time.monotonic() - t_ref,
                      'after_window_s': t_ref - w1}), file=sys.stderr)
    shutil.rmtree(out_dir, ignore_errors=True)
    correct = failed == 0 and bool(records) and all(
        math.isfinite(c['value']) and c['value'] <= c['limit'] for c in checks.values())
    for name, c in checks.items():
        print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r})', file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f'gpubench: loaded {", ".join(found)}: the benchmark may not load JAX '
              f'or the JAX package', file=sys.stderr)
        return 4
    line = {'correct': correct, 'attempted': attempted, 'failed': failed,
            'metrics': result_metrics, 'device': dev}
    if breakdown is not None:
        line['breakdown'] = breakdown
    line['checks'] = checks
    print(json.dumps(line), flush=True)
    return 0


def timings(run: dict) -> dict:
    """What the metrics read of one pipeline call: its kind, its prompts and
    its clock, without the clock's copies of the latents."""
    run['clock'].latents = []
    return {'kind': run['kind'], 'prompts': run['prompts'], 'clock': run['clock']}


def check(held, cfg, seed, device, steps, limits) -> Dict[str, dict]:
    """Each number of the sampled requests (``held``: request and retained
    calls) beside its limit."""
    from ..reference.pipeline import Reference

    compare.reference_precision()
    ref = Reference(cfg, weights.state_dicts(cfg, seed, device), device)
    nums: Dict[str, float] = {}
    for req, runs in held:
        outs = [compare.program_outputs(r, ref) for r in runs]
        compare.merge(nums, compare.compare(ref, outs, steps, cfg['run']['guidance_scale']))
    return {k: {'value': nums.get(k, math.inf), 'limit': v}
            for k, v in limits['limits'].items()}


def _has_matplotlib() -> bool:
    import importlib.util
    return importlib.util.find_spec('matplotlib') is not None
