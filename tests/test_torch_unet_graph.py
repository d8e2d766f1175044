"""``pipeline/unet_graph.py`` on the CPU: which requests the CUDA-graph route
takes, what its key separates, the cache's bound, and that a pipeline run
through the seam equals the UNet called directly, bit for bit.  The graphs
themselves run only on a card (``tests/test_torch_cuda.py``)."""

import threading
from contextlib import contextmanager

import pytest
import torch

from daam_tpu_torch import StableDiffusionPipeline, profiling, trace
from daam_tpu_torch.ops import attention
from daam_tpu_torch.pipeline import unet_graph
from daam_tpu_torch.pipeline.unet_graph import MAX_GRAPHS, UNetGraphs, signature

STEPS = 3


@contextmanager
def _lease_held_elsewhere(graphs):
    """Another thread holds ``graphs``' lease inside the block."""
    taken, done = threading.Event(), threading.Event()

    def hold():
        with graphs.request(None, 'cuda', 'acc', None):
            taken.set()
            done.wait(10)

    t = threading.Thread(target=hold)
    t.start()
    assert taken.wait(10)
    try:
        yield
    finally:
        done.set()
        t.join()


@pytest.mark.parametrize('device,capture,replay,held,route', [
    ('cpu', 'acc', None, False, 'eager'),
    ('cpu', False, None, False, 'eager'),
    ('cuda', 'full', None, False, 'eager'),
    ('cuda', 'acc', {'down_0_0': torch.zeros(1)}, False, 'eager'),
    ('cuda', 'acc', None, True, 'eager'),
    ('cuda', 'acc', None, False, 'graph'),
    ('cuda', False, None, False, 'graph'),
])
def test_graph_rule(device, capture, replay, held, route):
    """The graph route: a CUDA device, capture ``False`` or ``'acc'``, no
    replay rows, and the lease free; the lease comes back at the end."""
    graphs = UNetGraphs()

    def take():
        with graphs.request(None, device, capture, replay) as req:
            return 'eager' if req.graphs is None else 'graph'

    if held:
        with _lease_held_elsewhere(graphs):
            assert take() == route
    else:
        assert take() == route
    assert not graphs._lease.locked()


def _key(batch=1, edge=64, traced=True, dtype=torch.float32, mode='auto'):
    """An SD 2.1 evaluation's key, on the meta device."""
    meta = dict(device='meta')
    sample = torch.empty(2 * batch, 4, edge, edge, **meta)
    acc = ({'down_0_0': torch.empty(batch, 5, 77, edge * edge, **meta),
            'up_1_2': torch.empty(batch, 10, 77, edge * edge // 4, **meta)}
           if traced else None)
    prev = attention.get_kernel_mode()
    attention.set_kernel_mode(mode)
    try:
        return signature(sample, torch.empty(2 * batch, dtype=torch.long, **meta),
                         torch.empty(2 * batch, 77, 1024, dtype=dtype, **meta), None,
                         'acc' if traced else False, acc)
    finally:
        attention.set_kernel_mode(prev)


@pytest.mark.parametrize('other,same', [
    (dict(), True),
    (dict(traced=False), False),
    (dict(batch=4), False),
    (dict(edge=96), False),
    (dict(dtype=torch.bfloat16), False),
    (dict(mode='torch'), False),
])
def test_key_separates_what_changes_the_graph(other, same):
    """Traced and untraced calls, batch 1 and 4, 64² and 96² grids, the
    context's dtype and the attention dispatch are separate graphs; the same
    shapes are one."""
    assert (_key(**other) == _key()) is same


def test_signature_reads_added_conditioning_and_weights():
    x, t, ctx = torch.zeros(2, 4, 8, 8), torch.zeros(2), torch.zeros(2, 77, 32)
    added = {'text_embeds': torch.zeros(2, 64), 'time_ids': torch.zeros(6).expand(2, 6)}
    base = signature(x, t, ctx, added, False, None, ((1, torch.float32),))
    assert base != signature(x, t, ctx, None, False, None, ((1, torch.float32),))
    assert base != signature(x, t, ctx, {**added, 'text_embeds': torch.zeros(2, 32)},
                             False, None, ((1, torch.float32),))
    assert base != signature(x, t, ctx, added, False, None, ((2, torch.float32),))


def test_cache_keeps_the_four_most_recently_used_keys():
    graphs = UNetGraphs()
    assert MAX_GRAPHS == 4
    assert [graphs.touch(k) for k in 'abcd'] == [False] * 4
    assert graphs.touch('a')  # now the most recently used
    assert not graphs.touch('e')  # drops 'b', the least recently used
    assert list(graphs.entries) == ['c', 'd', 'a', 'e']
    assert not graphs.touch('b')
    assert list(graphs.entries) == ['d', 'a', 'e', 'b']


class _Direct:
    """The UNet called as the pipeline called it before the seam."""

    graph = 0

    def __init__(self, unet):
        self.unet = unet

    def __call__(self, *args, **kwargs):
        return self.unet(*args, **kwargs)


@pytest.fixture(scope='module', params=['tiny', 'tiny-xl'])
def pipe(request):
    return StableDiffusionPipeline.from_pretrained(request.param, device='cpu')


def _request(pipe, **trace_kw):
    with trace(pipe, **trace_kw) as tc:
        out = pipe('a dog runs', num_inference_steps=STEPS, output_type='np',
                   generator=torch.Generator().manual_seed(0))
        return (out.images[0], dict(tc.batch_heat_maps),
                [dict(b) for b in tc.time_blocks])


@pytest.mark.parametrize('time_chunk_steps', [None, 2])
def test_pipeline_through_the_seam_equals_the_direct_call(pipe, time_chunk_steps,
                                                          monkeypatch):
    """On the CPU every evaluation runs eager, counted as such, under a
    ``unet`` span whose ``graph`` is 0, and the images, the blocks and the
    per-chunk snapshots equal those of the UNet called directly."""
    profiling.clear()
    profiling.enable()
    before = dict(unet_graph.counts)
    try:
        seam = _request(pipe, time_chunk_steps=time_chunk_steps)
    finally:
        profiling.disable()
    unets = [r for r in profiling.spans() if r.name == 'unet']
    profiling.clear()
    assert [r.attrs for r in unets] == [{'graph': 0}] * STEPS
    assert {k: n - before[k] for k, n in unet_graph.counts.items()} == \
        {'captures': 0, 'replays': 0, 'eager': STEPS}

    @contextmanager
    def direct(self, unet, device, capture, replay):
        yield _Direct(unet)

    monkeypatch.setattr(UNetGraphs, 'request', direct)
    plain = _request(pipe, time_chunk_steps=time_chunk_steps)
    assert (seam[0] == plain[0]).all()
    assert seam[1].keys() == plain[1].keys()
    for f in seam[1]:
        assert torch.equal(seam[1][f], plain[1][f])
    assert len(seam[2]) == len(plain[2]) == (2 if time_chunk_steps else 0)
    for a, b in zip(seam[2], plain[2]):
        assert a.keys() == b.keys() and all(torch.equal(a[f], b[f]) for f in a)
    assert pipe.unet_graphs.entries == {}


def test_eager_evaluations_from_many_threads_all_count():
    """Requests beside the lease count their eager evaluations from any
    thread; no increment is lost."""
    import sys

    graphs = UNetGraphs()
    before = unet_graph.counts['eager']
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        with graphs.request(lambda *a, **k: None, 'cpu', 'acc', None) as unet:
            for _ in range(200):
                unet(None, None, None)

    threads = [threading.Thread(target=work) for _ in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert unet_graph.counts['eager'] - before == 16 * 200
