"""The denoising loop's UNet evaluations, replayed from CUDA graphs.

One UNet evaluation is some 3,000 small launches (ATen ops and the kernels
of ``csrc/attention.cu``), and at SDXL's sizes the host's dispatch of them,
not the card, sets a step's pace.  :class:`UNetGraphs` captures one
evaluation per input signature as a ``torch.cuda.CUDAGraph`` and replays it
on every later step and request, so the host makes two small copies and one
graph launch a step.  The kernels are the same kernels, in the same order.

**Which requests.**  A request takes the graph route when its pipeline is
on a CUDA device, its capture is ``False`` or ``'acc'`` and it has no replay
rows (:func:`engages`), and it takes the pipeline's lease without waiting.
Otherwise every evaluation of the request runs eager: ``save_heads`` runs
(``'full'``), ``load_heads`` runs (replay rows), and a request made while
another thread holds the lease.

**Key and cache.**  A graph is kept per :func:`signature`: the shapes and
dtypes of the inputs and of the accumulators, the capture, the settings that
choose the kernels, and where the UNet's parameters lie (a graph reads them
where they lay at its capture).  A key's first evaluation runs eager (it
warms cuBLAS, cuDNN and the kernel library), its second is captured and
replayed, and every later one is replayed.  No capture starts while
``torch.profiler`` records; replays are profiled as they run.
:data:`MAX_GRAPHS` keys are kept, the least recently used dropped, each
graph in a memory pool of its own.

**Buffers.**  A graph reads copies of its inputs that it owns, and writes
its output ``eps`` into memory of its own, which the next replay overwrites.
The accumulators of ``'acc'`` are the graph's too: a request that replays a
graph copies its accumulators' values into the graph's and points its
``acc`` dict at them, so the pipeline reads them between steps and at the
end as before.

**Counters.**  ``ops.kernels.launches`` grows on each replay by what the
capture recorded, so it reads what an eager evaluation adds.  The
``unet_graph`` counters count the evaluations captured (each also replayed
once), replayed and run eager.
"""

import itertools
import threading
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, Optional

import torch

from .. import profiling
from ..ops import attention, kernels

__all__ = ['UNetGraphs', 'engages', 'signature', 'MAX_GRAPHS', 'counts']

#: Graphs kept per pipeline.
MAX_GRAPHS = 4

#: UNet evaluations captured (and replayed once), replayed, and run eager:
#: the ``unet_graph`` group of the program's counters.
counts = profiling.counter_group('unet_graph', ('captures', 'replays', 'eager'))
_counts_lock = threading.Lock()  # eager evaluations count from any thread


def _count(key: str) -> None:
    with _counts_lock:
        counts[key] += 1


def engages(device, capture, replay) -> bool:
    """Whether a request's evaluations may come from graphs."""
    return torch.device(device).type == 'cuda' and capture in (False, 'acc') \
        and replay is None


def _sig(t: torch.Tensor):
    return tuple(t.shape), t.dtype


def signature(sample, timesteps, context, added_cond, capture, acc,
              weights=()) -> tuple:
    """The key of an evaluation's graph.  ``weights``: the address and
    dtype of each of the UNet's parameters and buffers."""
    return (_sig(sample), _sig(timesteps), _sig(context),
            tuple((k, _sig(v)) for k, v in sorted((added_cond or {}).items())),
            capture, tuple((n, _sig(a)) for n, a in sorted((acc or {}).items())),
            attention.get_kernel_mode(), torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32, weights)


class _Graph:
    """One captured evaluation and the buffers it reads and writes."""

    def __init__(self, unet, sample, timesteps, context, added_cond, capture, acc):
        self.sample, self.timesteps = sample.clone(), timesteps.clone()
        self.context = context.clone()
        self.added = (None if added_cond is None
                      else {k: v.clone() for k, v in added_cond.items()})
        self.acc = None if acc is None else dict(acc)  # the capturing request's
        self.graph = torch.cuda.CUDAGraph()
        before = dict(kernels.launches)
        try:
            with torch.cuda.graph(self.graph, capture_error_mode='thread_local'):
                self.out = unet(self.sample, self.timesteps, self.context,
                                added_cond=self.added, capture=capture, acc=self.acc)
        finally:
            # the capture recorded these launches without running them
            self.launches = {k: n - before[k] for k, n in kernels.launches.items()
                             if n != before[k]}
            for k, n in self.launches.items():
                kernels.launches[k] -= n

    def load(self, context, added_cond, acc):
        """Take a request's context, added conditioning and accumulators."""
        self.context.copy_(context)
        for k, v in (added_cond or {}).items():
            self.added[k].copy_(v)
        for n, a in (acc or {}).items():
            if a is not self.acc[n]:
                self.acc[n].copy_(a)
                acc[n] = self.acc[n]

    def replay(self, sample, timesteps) -> torch.Tensor:
        self.sample.copy_(sample)
        self.timesteps.copy_(timesteps)
        self.graph.replay()
        for k, n in self.launches.items():
            kernels.launches[k] += n
        return self.out


class _Request:
    """The UNet's evaluations of one request, called as the UNet is;
    ``graph`` is 1 when the last one came from a graph, else 0."""

    def __init__(self, unet, graphs: Optional['UNetGraphs']):
        self.unet, self.graphs, self.graph = unet, graphs, 0
        self._weights = None
        self._loaded = set()  # the graphs that hold this request's inputs

    def __call__(self, sample, timesteps, context, added_cond=None, capture=False,
                 acc: Optional[Dict[str, torch.Tensor]] = None, replay=None):
        g = (None if self.graphs is None
             else self._graph(sample, timesteps, context, added_cond, capture, acc))
        if g is None:
            _count('eager')
            self.graph = 0
            return self.unet(sample, timesteps, context, added_cond=added_cond,
                             capture=capture, acc=acc, replay=replay)
        if g not in self._loaded:
            g.load(context, added_cond, acc)
            self._loaded.add(g)
        self.graph = 1
        return g.replay(sample, timesteps)

    def _graph(self, sample, timesteps, context, added_cond, capture, acc):
        """This evaluation's graph, captured now if its key was seen once
        before; None where it runs eager."""
        if self._weights is None:
            self._weights = tuple((p.data_ptr(), p.dtype) for p in itertools.chain(
                self.unet.parameters(), self.unet.buffers()))
        key = signature(sample, timesteps, context, added_cond, capture, acc,
                        self._weights)
        graphs = self.graphs
        if not graphs.touch(key):
            return None
        g = graphs.entries[key]
        if g is not None:
            _count('replays')
        elif not torch.autograd._profiler_enabled():
            g = graphs.entries[key] = _Graph(self.unet, sample, timesteps, context,
                                             added_cond, capture, acc)
            self._loaded.add(g)
            _count('captures')
        return g


class UNetGraphs:
    """A pipeline's graphs: ``entries`` maps each key, most recently used
    last, to its graph, or to None while it has run once eager."""

    def __init__(self):
        self.entries: 'OrderedDict[tuple, Optional[_Graph]]' = OrderedDict()
        self._lease = threading.Lock()

    def touch(self, key) -> bool:
        """Whether ``key`` was seen before.  Either way it becomes the most
        recently used, and the least recently used key beyond
        :data:`MAX_GRAPHS` is dropped with its graph."""
        if key in self.entries:
            self.entries.move_to_end(key)
            return True
        self.entries[key] = None
        if len(self.entries) > MAX_GRAPHS:
            self.entries.popitem(last=False)
        return False

    @contextmanager
    def request(self, unet, device, capture, replay):
        """The evaluator of one request's UNet evaluations: on the graph
        route where :func:`engages` allows it and the lease is free (held
        until the request ends), else eager."""
        leased = engages(device, capture, replay) and self._lease.acquire(blocking=False)
        try:
            yield _Request(unet, self if leased else None)
        finally:
            if leased:
                self._lease.release()
