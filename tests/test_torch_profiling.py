"""``daam_tpu_torch.profiling`` on ``tiny`` on the CPU: nothing is recorded
while spans are off, though the counters count; a traced call's tree of
spans; the bytes of the heads copies; the overlay's stages; and, under
``torch.profiler`` alone, spans recorded on the profiler's clock."""

import json
from collections import deque
from pathlib import Path

import pytest
import torch

from daam_tpu_torch import StableDiffusionPipeline, profiling, release_heads, trace
from daam_tpu_torch.ops import kernels

STEPS = 2


@pytest.fixture(scope='module')
def pipe():
    return StableDiffusionPipeline.from_pretrained('tiny', device='cpu')


@pytest.fixture
def recording():
    profiling.clear()
    profiling.enable()
    yield
    profiling.disable()
    profiling.clear()


@pytest.fixture
def off():
    profiling.disable()
    profiling.clear()
    yield
    profiling.clear()


def _call(pipe, prompt='a dog runs', **kwargs):
    return pipe(prompt, num_inference_steps=STEPS,
                generator=torch.Generator().manual_seed(0), **kwargs)


def _children(records, parent):
    return sorted((r for r in records if r.parent == parent.id), key=lambda r: r.start_ns)


def _blocks(pipe):
    unet = pipe.unet
    return ([f'unet.down.{k}' for k in range(len(unet.down_blocks))] + ['unet.mid']
            + [f'unet.up.{k}' for k in range(len(unet.up_blocks))])


def _save_load(pipe, tmp_path, monkeypatch):
    """A save → load pair; returns the saved buffer's bytes."""
    monkeypatch.setenv('XDG_CACHE_HOME', str(tmp_path))
    with trace(pipe, save_heads=True, persist_heads=False) as tc:
        _call(pipe, 'a red dog')
        nbytes = sum(a.nbytes for a in tc.replay_buffer(0).values())
    with trace(pipe, load_heads=True):
        _call(pipe, 'a blue dog')
    release_heads()
    return nbytes


def test_off_records_nothing_while_counters_count(pipe, off, tmp_path, monkeypatch):
    assert not profiling.recording()
    # one shared no-op object: no span is made
    assert profiling.span('unet') is profiling.span('step', step=1)
    before = profiling.counters()
    nbytes = _save_load(pipe, tmp_path, monkeypatch)
    after = profiling.counters()
    assert profiling.spans() == [] and profiling.dropped() == 0
    assert after['heads_d2h_bytes'] - before['heads_d2h_bytes'] == nbytes > 0
    assert after['heads_h2d_bytes'] - before['heads_h2d_bytes'] == nbytes


def test_traced_call_tree(pipe, recording):
    with trace(pipe):
        _call(pipe, callback=lambda *a: None, callback_steps=1)
    records = profiling.spans()
    by_id = {r.id: r for r in records}
    roots = [r for r in records if r.parent == 0]
    assert [r.name for r in roots] == ['call']
    call = roots[0]
    # tiny's 16-px images take the 96² grid, as every size but 512 and 1024
    assert call.attrs == {'batch': 1, 'steps': STEPS, 'evaluations': STEPS, 'v_prediction': 0,
                          'grid': 96}
    kids = _children(records, call)
    assert [r.name for r in kids] == (['text_encode'] + ['step'] * STEPS
                                      + ['finalize_acc', 'decode', 'to_host'])
    assert kids[-2].attrs == {'tiled': 0, 'latent': 8}
    steps = [r for r in kids if r.name == 'step']
    assert [r.attrs['step'] for r in steps] == list(range(STEPS))
    for step in steps:
        inside = _children(records, step)
        assert [r.name for r in inside] == ['scheduler', 'unet', 'scheduler', 'callback']
        assert [r.name for r in _children(records, inside[1])] == _blocks(pipe)
    for r in records:
        assert r.start_ns <= r.end_ns
        if r.parent:
            p = by_id[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns, (r.name, p.name)
    assert call.request > 0 and {r.request for r in records} == {call.request}


def test_call_states_prediction_and_grid(pipe, recording):
    """The ``call`` span says whether the UNet predicts v and the edge of
    the heat-map grid that the trace takes."""
    v = StableDiffusionPipeline.from_pretrained('tiny-v', device='cpu')
    assert v.scheduler.prediction_type == 'v_prediction'
    with trace(v) as tc:
        _call(v)
    _call(pipe)
    calls = [r for r in profiling.spans() if r.name == 'call']
    assert [(r.attrs['v_prediction'], r.attrs['grid']) for r in calls] == [(1, 96), (0, 96)]
    assert tc.latent_hw == 96 ** 2


@pytest.mark.parametrize('scheduler,evaluations', [('pndm', 31), ('ddim', 30)])
def test_call_states_its_evaluations(scheduler, evaluations, recording):
    """The ``call`` span states the UNet evaluations of the request's
    sampler: at 30 steps PNDM's 31 (its second timestep evaluated twice),
    DDIM's 30, as many as the ``unet`` spans under it."""
    v1 = StableDiffusionPipeline.from_pretrained('tiny-v1', device='cpu', scheduler=scheduler)
    v1('a dog runs', num_inference_steps=30, generator=torch.Generator().manual_seed(0),
       output_type='np')
    records = profiling.spans()
    calls = [r for r in records if r.name == 'call']
    assert len(calls) == 1
    assert calls[0].attrs['steps'] == 30 and calls[0].attrs['evaluations'] == evaluations
    assert sum(r.name == 'unet' for r in records) == evaluations


GPUBENCH = Path(__file__).resolve().parents[1] / 'gpubench'


def _config(name):
    return json.loads((GPUBENCH / 'configs' / f'{name}.json').read_text())


def _mma_reader():
    from gpubench.core import spec

    return spec.load_module(GPUBENCH / 'metrics' / 'kernels.k2_mma_roofline.py')


@pytest.mark.parametrize('config,roles', [('sd15-512-fp32', {'self': 6, 'uncond': 5, 'cross': 1}),
                                          ('sd21-base-512-fp32', {})])
def test_k2_mma_roofline_counts_the_mma_route(config, roles):
    """``core/counters.py``'s calls of one traced evaluation that take fp32
    K2's mma.sync route, hd outside ``TF32X3_WGMMA_HEAD_DIMS``: SD 1.5's hd
    160 in the self-attention and the captured cross-attention's
    unconditional half of 2 down blocks and 3 up blocks, and both attentions
    of the mid block (whose cross-attention is not captured), 12; none in SD
    2.1 (hd 64 throughout).  These are the calls that
    ``kernels.k2_mma_roofline`` bounds."""
    from gpubench.core import counters

    cfg = _config(config)
    reader = _mma_reader()
    calls = [c for c in counters.attention_calls(cfg, 1, 'acc')
             if c['kernel'] == 'k2' and c['hd'] not in kernels.TF32X3_WGMMA_HEAD_DIMS]
    assert len(calls) == sum(roles.values()) == len(reader.mma_calls(cfg, 1, 'acc'))
    assert len(calls) == (12 if roles else 0)
    assert all(c['hd'] == 160 for c in calls)
    assert {r: sum(c['role'] == r for c in calls) for r in roles} == roles


class _Profile:
    def __init__(self, seconds, launches):
        self.seconds, self.launches = seconds, launches

    def device_s(self, names):
        assert names == ('flash_attention_tf32x3_kernel',)
        return self.seconds, self.launches


def test_k2_mma_roofline_reads_its_kernel_alone():
    """The share is the calls' least time over all of PNDM's 31
    evaluations over the device time of ``flash_attention_tf32x3_kernel``;
    nothing without a profile, and nothing (no error) where no call takes
    the route."""
    from gpubench.core import counters

    reader = _mma_reader()
    cfg = _config('sd15-512-fp32')
    bound = 31 * sum(counters.attention_bound_s(c, 'float32')
                     for c in reader.mma_calls(cfg, 1, 'acc'))
    data = {'cfg': cfg, 'steps': 30, 'profile_runs': [('plain', 1)],
            'profile': _Profile(4 * bound, 31 * 12)}
    assert reader.read(data) == pytest.approx(25.0)
    assert reader.read(dict(data, profile=None)) is None
    sd21 = _config('sd21-base-512-fp32')
    assert reader.read(dict(data, cfg=sd21, profile=_Profile(0.0, 0))) is None


@pytest.mark.parametrize('spans_on', [True, False])
@pytest.mark.parametrize('tiling', ['auto', True])
def test_decode_counts_its_route(pipe, spans_on, tiling, monkeypatch):
    """The ``decode`` span of a decoded batch states the route and the
    latent edge; with spans off nothing is recorded.  tiny's 8² latents
    decode whole unless tiling is forced."""
    monkeypatch.setattr(pipe, 'vae_tiling', tiling)
    profiling.clear()
    if spans_on:
        profiling.enable()
    try:
        _call(pipe, ['a dog runs', 'a cat sits'])
    finally:
        profiling.disable()
    records = profiling.spans()
    profiling.clear()
    tiled = tiling is True
    decodes = [r.attrs for r in records if r.name == 'decode']
    assert decodes == ([{'tiled': int(tiled), 'latent': 8}] if spans_on else [])


def test_request_ids(pipe, recording):
    _call(pipe)
    _call(pipe)
    with trace(pipe) as tc:
        _call(pipe)
        _call(pipe)
        tc.compute_global_heat_map()
    calls = [r for r in profiling.spans() if r.name == 'call']
    ids = [r.request for r in calls]
    assert len(set(ids[:2])) == 2 and ids[2] == ids[3] and ids[2] not in ids[:2]
    maps = [r for r in profiling.spans() if r.name == 'maps.global']
    assert [r.request for r in maps] == [ids[2]]


def test_heads_copies_state_their_bytes(pipe, recording, tmp_path, monkeypatch):
    before = profiling.counters()
    nbytes = _save_load(pipe, tmp_path, monkeypatch)
    after = profiling.counters()
    records = profiling.spans()

    def stated(name):
        return sum(r.attrs['bytes'] for r in records if r.name == name)

    d2h = after['heads_d2h_bytes'] - before['heads_d2h_bytes']
    h2d = after['heads_h2d_bytes'] - before['heads_h2d_bytes']
    assert stated('heads.d2h') == d2h == nbytes
    assert stated('heads.cat') == nbytes
    assert stated('heads.h2d') == h2d == nbytes
    assert len([r for r in records if r.name == 'heads.h2d']) == STEPS
    steps = {r.id: r for r in records if r.name == 'step'}
    assert all(r.parent in steps for r in records if r.name in ('heads.d2h', 'heads.h2d'))


def test_save_heat_map_overlay_stages(pipe, recording, tmp_path):
    with trace(pipe) as tc:
        _call(pipe)
        exp = tc.to_experiment(tmp_path)
    profiling.clear()
    words = ['dog', 'runs']
    for word in words:
        exp.save_heat_map(word)
    names = [r.name for r in profiling.spans()]
    n = len(words)
    # expand_as(plot=True) resamples the map once, for what it returns and
    # for the overlay it draws: one resize a word
    assert names.count('overlay.resize') == n
    assert names.count('overlay.composite') == n and names.count('overlay.encode') == n
    assert names.count('maps.word') == n
    assert all((tmp_path / f'{w}.heat_map.png').exists() for w in words)


def _bounds_ns(e):
    if hasattr(e, 'start_ns'):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return int(e.start_us() * 1e3), int((e.start_us() + e.duration_us()) * 1e3)


def test_profiler_alone_records_on_its_clock(pipe, off, monkeypatch):
    from torch.profiler import ProfilerActivity, profile, record_function

    decode = pipe.vae.decode

    def probed(*args, **kwargs):
        with record_function('vae_probe'):
            return decode(*args, **kwargs)

    monkeypatch.setattr(pipe.vae, 'decode', probed)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _call(pipe)
    assert not profiling.recording()
    records = profiling.spans()
    assert records, 'a profiler session records the spans without enable()'
    span = [r for r in records if r.name == 'decode'][0]
    events = list(prof.profiler.kineto_results.events())
    probe = _bounds_ns([e for e in events if e.name() == 'vae_probe'][0])
    inside = [_bounds_ns(e) for e in events if e.name().startswith('aten::')
              and probe[0] <= _bounds_ns(e)[0] and _bounds_ns(e)[1] <= probe[1]]
    assert inside
    tol = 100_000  # 100 µs
    for s, e in [probe] + inside:
        assert span.start_ns - tol <= s and e <= span.end_ns + tol
    # spans are no profiler ranges
    assert not {r.name for r in records} & {e.name() for e in events}


def test_launches_are_a_counter_group():
    assert kernels.launches is profiling.counter_group('launches', ())
    kernels.reset_launches()
    kernels.launches['flash_attention'] += 2
    kernels.launches['cross_attention_acc_tf32x3'] += 1
    counts = profiling.counters()
    assert counts['launches.flash_attention'] == 2
    assert counts['launches.cross_attention_acc_tf32x3'] == 1
    kernels.reset_launches()
    assert not any(v for k, v in profiling.counters().items() if k.startswith('launches.'))


def test_ring_is_bounded(monkeypatch, recording):
    monkeypatch.setattr(profiling, 'CAPACITY', 3)
    monkeypatch.setattr(profiling, '_ring', deque(maxlen=3))
    for k in range(5):
        with profiling.span(f's{k}', k=k):
            pass
    assert [r.name for r in profiling.spans()] == ['s2', 's3', 's4']
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


@pytest.mark.parametrize('on', [True, False])
def test_span_takes_attributes_known_inside_it(on):
    """``set`` adds to a recorded span's attributes; off, it does nothing."""
    profiling.clear()
    (profiling.enable if on else profiling.disable)()
    try:
        with profiling.span('s', stripes=0) as s:
            s.set(stripes=2, bytes=7)
    finally:
        profiling.disable()
    assert [r.attrs for r in profiling.spans()] == ([{'stripes': 2, 'bytes': 7}] if on else [])
    profiling.clear()


def test_threads_keep_their_own_parents_and_counts(recording):
    import sys
    import threading

    before = profiling.counters().get('stress_test', 0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        for _ in range(200):
            with profiling.span(f'outer{k}'):
                with profiling.span(f'inner{k}'):
                    profiling.count('stress_test')

    threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert profiling.counters()['stress_test'] - before == 16 * 200
    by_id = {r.id: r for r in profiling.spans()}
    inner = [r for r in by_id.values() if r.name.startswith('inner')]
    assert len(inner) == 16 * 200
    assert all(by_id[r.parent].name == 'outer' + r.name[5:] for r in inner)
