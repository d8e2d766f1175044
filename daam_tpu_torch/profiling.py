"""The program's tracing: spans and counters, and a Chrome-trace exporter.

Counterpart of ``daam_tpu/profiling.py``.

**Spans.**  ``with span('unet'):`` marks one stage of the work where it
happens (the pipeline call, the text encode, each denoising step, the UNet
and each of its blocks, the scheduler, the heads copies, the decode, the
heat maps, the overlays).  A span records only while :func:`enable` is in
force or a ``torch.profiler`` session is recording; otherwise ``span()``
returns one shared no-op object after a single flag test, so the sites
cost well under a microsecond each.  A recorded span keeps its name, its
start and end from :func:`time.time_ns` (CLOCK_REALTIME, the base of
``torch.profiler``'s host and device timestamps, so spans and profiler
events lie on one clock), its id, the id of the span open around it on
the same thread (its parent, 0 at the root), a request id and small
numeric attributes (``bytes``, ``step``, ``batch``; the ``call``'s
UNet ``evaluations`` (the sampler's: PNDM's one more than its steps),
``v_prediction`` and heat-map ``grid``, the ``unet``'s ``graph`` (1 where
the evaluation ran from a CUDA graph, 0 eager: a replay records no block
spans inside it), the ``decode``'s ``tiled`` and ``latent`` edge, the card route's ``overlay.encode``'s ``stripes``), given
when the span opens or, known only inside it, by its ``set``.  The request id is
shared by every span of one ``trace(pipe)`` context, and outside one by
every span of one pipeline call.  Records go into a bounded in-memory ring
(:data:`CAPACITY`; :func:`dropped` counts what it pushed out) and are never
written out while the work runs: :func:`spans` returns them, :func:`clear`
empties the ring.  Spans are plain Python records, not
``record_function`` ranges, so they add no event to a profile of the card.

**Counters** are always on: :func:`count` adds to a named integer
(``heads_d2h_bytes`` and ``heads_h2d_bytes``, the bytes of saved attention
probabilities handed to and from host memory), and :func:`counter_group`
gives a dict that its owner increments in place (the kernels' launch
counts, ``ops.kernels.launches``; the UNet evaluations captured, replayed
and run eager, ``pipeline.unet_graph.counts``).  :func:`counters` reads them
all.

:func:`profile_trace` records the host and the card for the enclosed block
and writes a Chrome trace with the spans on a track of their own;
:func:`time_pipeline` gives the median seconds of a pipeline call from its
``call`` span.
"""

import contextlib
import itertools
import json
import os
import statistics
import threading
import time
from collections import deque
from typing import Dict, Iterable, List, NamedTuple

import torch

__all__ = ['span', 'request', 'enable', 'disable', 'recording', 'spans', 'clear',
           'dropped', 'SpanRecord', 'CAPACITY', 'count', 'counter_group', 'counters',
           'profile_trace', 'time_pipeline']

#: Spans the ring keeps; older ones are pushed out (:func:`dropped`).
CAPACITY = 1 << 16

_profiler_enabled = torch.autograd._profiler_enabled
_forced = False
_ring: deque = deque(maxlen=CAPACITY)
_dropped = 0
_ids = itertools.count(1)
_requests = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()  # the counters' read-modify-writes, from any thread


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    request: int
    attrs: Dict[str, float]


def _thread():
    if not hasattr(_local, 'stack'):
        _local.stack, _local.request = [], 0
    return _local


class _Span:
    __slots__ = ('name', 'attrs', 'id', 'parent', 'request', 'start_ns')

    def __init__(self, name: str, attrs: Dict[str, float]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        st = _thread()
        stack = st.stack
        self.parent = stack[-1].id if stack else 0
        self.request = st.request
        self.id = next(_ids)
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def set(self, **attrs) -> None:
        """Add ``attrs`` known only inside the span."""
        self.attrs.update(attrs)

    def __exit__(self, exc_type, exc, tb):
        global _dropped
        end = time.time_ns()
        _local.stack.pop()
        if len(_ring) == CAPACITY:
            with _lock:
                _dropped += 1
        _ring.append(SpanRecord(self.name, self.start_ns, end, self.id, self.parent,
                                self.request, self.attrs))


class _Off:
    """What ``span()`` returns while nothing records: one shared object."""

    __slots__ = ()

    def __enter__(self):
        return self

    def set(self, **attrs) -> None:
        pass

    def __exit__(self, exc_type, exc, tb):
        pass


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager that records ``name`` with ``attrs`` while
    :func:`recording`; a shared no-op otherwise.  What it yields takes
    more attributes with ``set(**attrs)``."""
    if _forced or _profiler_enabled():
        return _Span(name, attrs)
    return _OFF


class request:
    """Open a request for the spans of this thread inside the block: a new
    id with ``fresh=True`` (a ``trace`` context), else a new one only
    where none is open (a pipeline call)."""

    __slots__ = ('fresh', 'prev')

    def __init__(self, fresh: bool = True):
        self.fresh = fresh

    def __enter__(self):
        st = _thread()
        self.prev = st.request
        if self.fresh or not self.prev:
            st.request = next(_requests)
        return st.request

    def __exit__(self, exc_type, exc, tb):
        _local.request = self.prev


def enable() -> None:
    """Record spans from now on, profiler or not."""
    global _forced
    _forced = True


def disable() -> None:
    """Record spans only while a ``torch.profiler`` session records."""
    global _forced
    _forced = False


def recording() -> bool:
    """Whether a span opened now would be recorded."""
    return _forced or _profiler_enabled()


def spans() -> List[SpanRecord]:
    """The recorded spans in the ring, in the order they ended."""
    return list(_ring)


def clear() -> None:
    """Empty the ring and zero :func:`dropped`."""
    global _dropped
    _ring.clear()
    _dropped = 0


def dropped() -> int:
    """Spans pushed out of the full ring since the last :func:`clear`."""
    return _dropped


# ------------------------------------------------------------------ counters

_COUNTERS: Dict[str, int] = {'heads_d2h_bytes': 0, 'heads_h2d_bytes': 0}
_GROUPS: Dict[str, Dict[str, int]] = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counter_group(name: str, keys: Iterable[str]) -> Dict[str, int]:
    """The registry's dict of counters ``name``, made with ``keys`` at zero
    on the first call; its owner increments the entries in place."""
    return _GROUPS.setdefault(name, dict.fromkeys(keys, 0))


def counters() -> Dict[str, int]:
    """Every counter now: the plain ones by name, a group's as
    ``<group>.<key>``."""
    out = dict(_COUNTERS)
    for group, values in _GROUPS.items():
        out.update((f'{group}.{k}', v) for k, v in values.items())
    return out


# ------------------------------------------------------------------ exporters

def _chrome_events(records: List[SpanRecord], base_ns: int) -> List[dict]:
    """The spans as Chrome-trace complete events on a process of their own."""
    pid = 'daam_tpu_torch spans'
    out = [{'ph': 'M', 'name': 'process_name', 'pid': pid, 'tid': 0,
            'args': {'name': pid}}]
    for r in records:
        out.append({'ph': 'X', 'cat': 'span', 'name': r.name, 'pid': pid, 'tid': 0,
                    'ts': (r.start_ns - base_ns) / 1e3, 'dur': (r.end_ns - r.start_ns) / 1e3,
                    'args': {'id': r.id, 'parent': r.parent, 'request': r.request,
                             **r.attrs}})
    return out


@contextlib.contextmanager
def profile_trace(logdir: str, with_stack: bool = False):
    """Profile the enclosed block (the CPU, and the card when there is one)
    and write ``logdir/trace.json`` with the program's spans of the block
    on a track of their own above the host and the card (Perfetto or
    ``chrome://tracing`` opens it); yields the ``torch.profiler.profile``
    object, whose ``key_averages()`` sums time by op and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    t0 = time.time_ns()
    with profile(activities=activities, with_stack=with_stack) as prof:
        yield prof
    t1 = time.time_ns()
    path = os.path.join(logdir, 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    ours = [r for r in spans() if t0 <= r.start_ns and r.end_ns <= t1]
    # the exporter writes microseconds after ``baseTimeNanoseconds`` (0: epoch)
    doc['traceEvents'].extend(_chrome_events(ours, int(doc.get('baseTimeNanoseconds', 0))))
    with open(path, 'w') as f:
        json.dump(doc, f)


def time_pipeline(pipe, prompt: str = 'a dog', num_inference_steps: int = 10,
                  reps: int = 3, traced: bool = False) -> Dict[str, float]:
    """Median seconds per pipeline call (after one warm-up call), traced
    or untraced, on the pipeline's device: the length of each call's
    ``call`` span, which ends once the images are in host memory."""
    from .trace import trace as trace_ctx

    label = 'traced_call' if traced else 'call'

    def run():
        gen = torch.Generator(device=pipe.device).manual_seed(0)
        return pipe(prompt, num_inference_steps=num_inference_steps,
                    generator=gen, output_type='np')

    was = _forced
    enable()
    try:
        with trace_ctx(pipe) if traced else contextlib.nullcontext():
            run()  # warm-up: the kernel library's build, allocator growth
            start = time.time_ns()
            for _ in range(reps):
                run()
    finally:
        if not was:
            disable()
    calls = [(r.end_ns - r.start_ns) / 1e9 for r in spans()
             if r.name == 'call' and r.start_ns >= start]
    return {label: statistics.median(calls[-reps:])}
