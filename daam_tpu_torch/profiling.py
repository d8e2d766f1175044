"""Profiling utilities on ``torch.profiler`` and the host clock.

Counterpart of ``daam_tpu/profiling.py``.  :func:`profile_trace` records
the host and the card for the enclosed block and writes a Chrome trace
(``chrome://tracing`` or Perfetto opens it); :class:`StepTimer` times
named stages on the host clock, synchronizing the stream of the device it
times so that queued kernels are counted; :func:`time_pipeline` gives the
median wall-clock of a pipeline call, traced or not.
"""

import contextlib
import os
import time
from typing import Callable, Dict, List

import torch

__all__ = ['profile_trace', 'time_pipeline', 'StepTimer']


@contextlib.contextmanager
def profile_trace(logdir: str, with_stack: bool = False):
    """Profile the enclosed block (the CPU, and the card when there is one)
    and write ``logdir/trace.json``; yields the ``torch.profiler.profile``
    object, whose ``key_averages()`` sums time by op and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, with_stack=with_stack) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


class StepTimer:
    """Wall-clock timer for named stages on ``device``.  A stage on a CUDA
    device synchronizes that device's stream before it starts and before it
    stops, so the time covers the kernels it queued."""

    def __init__(self, device='cuda'):
        self.device = torch.device(device)
        self.times: Dict[str, List[float]] = {}

    def _sync(self):
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def stage(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def record(self, name: str, fn: Callable, *args, **kwargs):
        with self.stage(name):
            out = fn(*args, **kwargs)
        return out

    def summary(self) -> Dict[str, float]:
        """The median seconds of each stage."""
        return {name: sorted(ts)[len(ts) // 2] for name, ts in self.times.items()}

    def __str__(self):
        return '  '.join(f'{k}={v * 1e3:.1f}ms' for k, v in self.summary().items())


def time_pipeline(pipe, prompt: str = 'a dog', num_inference_steps: int = 10,
                  reps: int = 3, traced: bool = False) -> Dict[str, float]:
    """Median seconds per pipeline call (after one warm-up call), traced
    or untraced, on the pipeline's device."""
    from .trace import trace as trace_ctx

    timer = StepTimer(pipe.device)
    label = 'traced_call' if traced else 'call'

    def run():
        gen = torch.Generator(device=pipe.device).manual_seed(0)
        return pipe(prompt, num_inference_steps=num_inference_steps,
                    generator=gen, output_type='np')

    with trace_ctx(pipe) if traced else contextlib.nullcontext():
        run()  # warm-up: the kernel library's build, allocator growth
        for _ in range(reps):
            timer.record(label, run)
    return timer.summary()
