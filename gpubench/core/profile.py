"""One profiled request: device busy time, idle gaps and kernel times.

``torch.profiler`` traces one whole request after a throwaway session (a
process's first session was seen to drop the first launches).  From the
raw trace: the request's window (its ``gpubench.request`` range on the
host), the device's busy time (the union of every kernel, copy and set on
the card inside it), the idle gaps labelled by the harness span open on the
host and the longest host operation around them, and the device time by
kernel name.
"""

from bisect import bisect_right
from typing import Dict, List, Tuple

import torch

def short_name(name: str) -> str:
    """A kernel's function name without its return type, namespaces,
    template arguments and parameters (``void at::native::f<...>(...)`` →
    ``f``); a name that is no C++ signature stays, cut at 80 characters."""
    s = name.strip().replace('(anonymous namespace)::', '')
    if s.startswith('void '):
        s = s[5:]
    cut = min([i for i in (s.find('<'), s.find('(')) if i > 0] or [len(s)])
    s = s[:cut].split('::')[-1].strip()
    return s[:80] or name[:80]


def _events(prof):
    """(name, on_device, start_us, end_us) of every event of the trace."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, 'start_ns'):
            start, length = e.start_ns() / 1e3, e.duration_ns() / 1e3
        else:
            start, length = e.start_us(), e.duration_us()
        out.append((e.name(), e.device_type() == DeviceType.CUDA, start, start + length))
    return out


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Profile:
    """The readings of one profiled request."""

    def __init__(self, prof):
        events = _events(prof)
        req = [(s, e) for n, dev, s, e in events if not dev and n == 'gpubench.request']
        if not req:
            raise RuntimeError('the profiled request left no gpubench.request range')
        self.t0, self.t1 = req[0]
        # device-side ranges of record_function spans are no device work
        device = [(n, s, e) for n, dev, s, e in events
                  if dev and self.t0 <= s < self.t1 and not n.startswith('gpubench')]
        self.kernels: Dict[str, Tuple[float, int]] = {}
        for n, s, e in device:
            k = short_name(n)
            t, c = self.kernels.get(k, (0.0, 0))
            self.kernels[k] = (t + (e - s) / 1e6, c + 1)
        busy = _union([(max(s, self.t0), min(e, self.t1)) for _, s, e in device])
        self.window_s = (self.t1 - self.t0) / 1e6
        self.busy_s = sum(e - s for s, e in busy) / 1e6
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        self.gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                     if edges[i + 1] > edges[i]]
        host = [(n, s, e) for n, dev, s, e in events if not dev and self.t0 <= s < self.t1]
        self.spans = sorted((s, e, n[len('gpubench.'):]) for n, s, e in host
                            if n.startswith('gpubench.') and n != 'gpubench.request')
        # long host operations (a copy to host memory, a PNG written) name a gap
        self.long_ops = sorted((s, e, n) for n, s, e in host
                               if not n.startswith(('gpubench.', 'cuda')) and e - s > 500)
        self._starts = [s for s, _, _ in self.long_ops]

    def device_s(self, names) -> Tuple[float, int]:
        """Device seconds and launches of the kernels named."""
        t = sum(self.kernels.get(n, (0.0, 0))[0] for n in names)
        c = sum(self.kernels.get(n, (0.0, 0))[1] for n in names)
        return t, c

    def label(self, t: float) -> str:
        span = [n for s, e, n in self.spans if s <= t < e]
        ops = [(e - s, n) for s, e, n in self.long_ops[:bisect_right(self._starts, t)] if t < e]
        op = min(ops)[1] if ops else 'python'
        return f"{'/'.join(span) or 'request'}|{op}"

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        ops = sorted(((t, k) for k, (t, _) in self.kernels.items()), reverse=True)[:top]
        idle: Dict[str, float] = {}
        for s, e in self.gaps:
            lab = self.label((s + e) / 2)
            idle[lab] = idle.get(lab, 0.0) + (e - s) / 1e6
        gaps = sorted(((v, k) for k, v in idle.items()), reverse=True)[:top]
        return {'device_ops': [[k, t] for t, k in ops],
                'idle_gaps': [[k, v] for v, k in gaps]}


def profile_request(run_request, warm_request) -> Tuple[Profile, list]:
    """Profile ``run_request()`` after a throwaway session around
    ``warm_request()``; returns the readings and the request's runs."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        warm_request()
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        with record_function('gpubench.request'):
            runs = run_request()
            torch.cuda.synchronize()
    return Profile(prof), runs
