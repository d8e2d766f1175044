"""The readers of the program's spans, on a hand-built profiled request:
a stand-in profile (``t0``, ``t1``, idle ``gaps`` in microseconds) and
spans put into the program's registry, with answers worked out by hand.
Spans outside ``[t0, t1]`` are left out; without a profile, or with a
program that records no spans, every reader gives None."""

from collections import deque
from types import SimpleNamespace

import pytest

from daam_tpu_torch import profiling
from gpubench.core import spans, spec

T0_NS = 1_790_000_000_000_000_000  # ns since the epoch, as time.time_ns() reads
T0 = T0_NS / 1e3  # µs, as the profile's times read

# (name, start µs, end µs, attrs), offsets from T0; the window is [0, 1000]
SPANS = [
    ('call', 0, 600, {}),
    ('text_encode', 10, 60, {}),
    ('step', 60, 400, {'step': 0}),
    ('heads.h2d', 62, 68, {'bytes': 3e6}),
    ('unet', 70, 300, {}),
    ('unet.down.0', 80, 150, {}),
    ('scheduler', 300, 320, {}),
    ('heads.d2h', 320, 380, {'bytes': 6e6}),
    ('decode', 400, 500, {}),
    ('heads.cat', 500, 560, {'bytes': 1e6}),
    ('overlay.resize', 620, 660, {}),
    ('overlay.composite', 660, 700, {}),
    ('overlay.encode', 700, 900, {}),
    # outside the profiled request: left out
    ('overlay.encode', -100, -50, {}),
    ('unet', 1100, 1200, {}),
    ('heads.d2h', 990, 1010, {'bytes': 5e9}),
]
GAPS = [(0, 40), (100, 200), (300, 330), (560, 640), (950, 1000)]
# idle µs named by the innermost span: [10,40] text_encode, [100,200] the UNet,
# [300,330] scheduler and heads.d2h, [620,640] overlay.resize: 180 of 300
EXPECTED = {
    'device.idle_named_share': 60.0,
    'pipeline.unet_idle_ms': 0.1,
    'experiment.resize_ms': 0.02,
    'experiment.composite_ms': 0.02,
    'experiment.encode_ms': 0.1,
    'trace.p_copy_ms': 0.063,
    'trace.p_copy_gbps': 1e7 / 126e-6 / 1e9,
}
METRICS = {m['name']: m for m in spec.benchmark()['per_layer']}


def _record(k, name, s, e, attrs):
    return profiling.SpanRecord(name, T0_NS + s * 1000, T0_NS + e * 1000, k + 1, 0, 1, attrs)


@pytest.fixture
def data(monkeypatch):
    ring = deque(_record(k, *sp) for k, sp in enumerate(SPANS))
    monkeypatch.setattr(profiling, '_ring', ring)
    profile = SimpleNamespace(t0=T0, t1=T0 + 1000,
                              gaps=[(T0 + s, T0 + e) for s, e in GAPS])
    return {'profile': profile, 'profile_runs': [('plain', 2)]}


@pytest.mark.parametrize('name', sorted(EXPECTED))
def test_reader_by_hand(name, data):
    value = spec.reader(METRICS[name]).read(data)
    assert value == pytest.approx(EXPECTED[name], rel=1e-6)


@pytest.mark.parametrize('name', sorted(EXPECTED))
def test_reader_without_profile_or_spans(name, data, monkeypatch):
    reader = spec.reader(METRICS[name])
    assert reader.read(dict(data, profile=None)) is None
    monkeypatch.delattr(profiling, 'spans')  # a program that records none
    assert reader.read(data) is None


def test_spans_outside_the_request_are_left_out(data):
    kept = spans.program_spans(data)
    assert len(kept) == len(SPANS) - 3
    assert all(T0 <= s and e <= T0 + 1000 for s, e, _, _ in kept)


def test_readers_with_nothing_of_theirs(monkeypatch, data):
    """A request without overlays or heads copies (the ``lib`` cell)."""
    keep = deque(r for r in profiling.spans()
                 if not r.name.startswith(('overlay.', 'heads.')))
    monkeypatch.setattr(profiling, '_ring', keep)
    for name in ('experiment.resize_ms', 'experiment.encode_ms', 'trace.p_copy_ms',
                 'trace.p_copy_gbps'):
        assert spec.reader(METRICS[name]).read(data) is None


def test_innermost_and_idle_by_name(data):
    pieces = spans.innermost([(0, 10, 'a', {}), (0, 4, 'b', {}), (2, 3, 'c', {}),
                              (12, 14, 'd', {})])
    assert pieces == [(0, 2, 'b'), (2, 3, 'c'), (3, 4, 'b'), (4, 10, 'a'), (12, 14, 'd')]
    idle = spans.idle_by_name(data['profile'], spans.program_spans(data))
    assert idle['call'] == pytest.approx(50) and idle[''] == pytest.approx(70)
    assert sum(idle.values()) == pytest.approx(300)
