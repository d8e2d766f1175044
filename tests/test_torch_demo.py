"""The ``daam-torch-demo`` server and ``profiling.py``, on ``tiny`` on the CPU.

The port counterparts of ``tests/test_demo_batching.py`` and
``tests/test_cli.py:118-185``: concurrent plain requests coalesce into one
traced call of the fixed batch, a lone request goes through, a seed
reproduces and gives the image of a batch-1 call, ``_overlay_b64`` is
``_jet_composite`` without matplotlib, the counterfactual runs save → load,
``get_tokenizing_mapping`` and the dependency SVG equal ``daam_tpu``'s, the
handler answers a POST to ``/generate``, and ``--gradio`` wires a stub
Gradio.  Then the profiler helpers: a Chrome trace with the program's
spans, and ``time_pipeline``.
"""

import base64
import io
import re
import sys
import threading
import types
import urllib.request

import numpy as np
import PIL.Image
import pytest
import torch

from daam_tpu_torch import StableDiffusionPipeline
from daam_tpu_torch.run import demo

IMG_RE = re.compile(r'data:image/png;base64,([A-Za-z0-9+/=]+)')
STEPS = 2


@pytest.fixture(scope='module')
def pipe():
    return StableDiffusionPipeline.from_pretrained('tiny', device='cpu')


def _first_image(html):
    return np.asarray(PIL.Image.open(io.BytesIO(base64.b64decode(
        IMG_RE.search(html).group(1)))))


def _join(threads, timeout=300):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


def test_concurrent_requests_coalesce_into_one_call(pipe):
    """Three requests submitted together to a batch-4 queue: one traced
    call answers all three (padded to 4), each with its own image and map."""
    queue = demo.BatchQueue(pipe, 4, threading.Lock(), window_s=5.0)
    prompts = ['a dog runs', 'a cat sits', 'a red car']
    results = {}
    barrier = threading.Barrier(len(prompts))

    def request(i):
        barrier.wait()
        results[i] = queue.submit(prompts[i], STEPS, 10 + i)

    threads = [threading.Thread(target=request, args=(i,)) for i in range(3)]
    try:
        for t in threads:
            t.start()
        _join(threads)
    finally:
        queue.close()
    assert list(queue.served) == [3]
    assert not queue._thread.is_alive()
    images = [np.asarray(results[i][0]) for i in range(3)]
    assert images[0].shape == (16, 16, 3)
    assert not np.array_equal(images[0], images[1])
    for i, prompt in enumerate(prompts):
        heat = results[i][1]
        assert heat.prompt == prompt
        heat.compute_word_heat_map(prompt.split()[1])


def test_single_request_through_batcher(pipe):
    """A lone request completes, padded to the fixed batch."""
    handler = demo.make_app(pipe, default_seed=0, batch_size=2)
    try:
        prompt, html = handler.generate('a bird flies', '', '', STEPS, False)
        assert list(handler.batcher.served) == [1]
    finally:
        handler.batcher.close()
    assert 'data:image/png;base64' in html and 'DAAM maps' in html


def test_batcher_seed_reproduces_the_batch_1_image(pipe):
    """The same prompt and seed give the same image through the batcher,
    and it is the image of a batch-1 call with that seed (one generator
    per request)."""
    handler = demo.make_app(pipe, default_seed=7, batch_size=2)
    try:
        first = _first_image(handler.generate('a dog runs', '', '', STEPS, False)[1])
        second = _first_image(handler.generate('a dog runs', '', '', STEPS, False)[1])
    finally:
        handler.batcher.close()
    alone = pipe('a dog runs', num_inference_steps=STEPS,
                 generator=torch.Generator().manual_seed(7)).images[0]
    np.testing.assert_array_equal(first, second)
    np.testing.assert_array_equal(first, np.asarray(alone))


def test_failure_reaches_every_waiter(pipe):
    """A call that fails (here, in the safety checker) raises in its
    caller; the worker lives on."""
    def checker(images, prompts):
        if 'boom' in prompts:
            raise ValueError('boom')
        return [False] * len(images)

    queue = demo.BatchQueue(pipe, 2, threading.Lock())
    pipe.safety_checker = checker
    try:
        with pytest.raises(ValueError, match='boom'):
            queue.submit('boom', STEPS, 1)
        image, _ = queue.submit('a dog', STEPS, 1)
    finally:
        pipe.safety_checker = None
        queue.close()
    assert list(queue.served) == [1]
    assert np.asarray(image).shape == (16, 16, 3)


def test_overlay_b64_is_the_jet_composite_without_figures(monkeypatch):
    from daam_tpu_torch.heatmap import WordHeatMap, _jet_composite

    rng = np.random.RandomState(0)
    image = PIL.Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8))
    wm = WordHeatMap(torch.from_numpy(rng.rand(8, 8).astype(np.float32)), word='dog')
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    got = np.asarray(PIL.Image.open(io.BytesIO(base64.b64decode(
        demo._overlay_b64(image, wm)))))
    expect = (_jet_composite(np.asarray(image), wm.expand_as(image),
                             color_normalize=True) * 255).astype(np.uint8)
    assert got.shape == (64, 64, 3)
    np.testing.assert_array_equal(got, expect)


def test_counterfactual_runs_save_then_load(pipe):
    """The adjective swap: a save_heads run of the prompt, a load_heads run
    of the new one, both images on the page, the buffer released after."""
    import importlib

    trace_mod = importlib.import_module('daam_tpu_torch.trace')

    handler = demo.make_app(pipe, default_seed=0, batch_size=2)
    try:
        prompt, html = handler.generate('A blue dog', 'blue', 'red', STEPS, False)
        assert list(handler.batcher.served) == []  # it never went through the queue
    finally:
        handler.batcher.close()
    assert 'transplanted attention' in html and 'A red dog' in html
    assert 'Attention evolution: blue' in html
    assert len(IMG_RE.findall(html)) >= 2 + 3 + STEPS
    assert demo.HEADS_KEY not in trace_mod._HEAD_CACHE


@pytest.mark.parametrize('prompt', ['a blue dog', 'An angry, bald man doing research',
                                    'A brown fox, a white dog, and a blue wolf'])
def test_tokenizing_mapping_and_parse_match_daam_tpu(prompt):
    from daam_tpu.run import demo as theirs
    from daam_tpu.tokenization import HashWordTokenizer
    from daam_tpu.tokenization import default_tokenizer as jax_tokenizer
    from daam_tpu_torch.tokenization import HashWordTokenizer as OurHash
    from daam_tpu_torch.tokenization import default_tokenizer

    for ours_tok, their_tok in ((OurHash(), HashWordTokenizer()),
                                (default_tokenizer(), jax_tokenizer())):
        assert demo.get_tokenizing_mapping(prompt, ours_tok) == \
            theirs.get_tokenizing_mapping(prompt, their_tok)
    assert demo.dependency_html(prompt) == theirs.dependency_html(prompt)
    assert demo.get_tokenizing_mapping('a blue dog', OurHash()) == \
        ([[1], [2], [3]], ['a', 'blue', 'dog'])


def test_handler_answers_post(pipe):
    """A ThreadingHTTPServer on a free local port: GET renders the page, a
    POST to /generate renders the results."""
    import http.server

    handler = demo.make_app(pipe, default_seed=0, batch_size=2)
    server = http.server.ThreadingHTTPServer(('127.0.0.1', 0), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f'http://127.0.0.1:{server.server_address[1]}'
    try:
        with urllib.request.urlopen(url + '/', timeout=60) as r:
            assert r.status == 200 and b'Dependency parse' in r.read()
        data = f'prompt=A+blue+dog&choice=&new_adj=&steps={STEPS}'.encode()
        with urllib.request.urlopen(url + '/generate', data=data, timeout=300) as r:
            body = r.read().decode()
        assert r.status == 200
        assert 'DAAM maps' in body and len(IMG_RE.findall(body)) >= 2
        assert list(handler.batcher.served) == [1]
    finally:
        server.shutdown()
        server.server_close()
        handler.batcher.close()
        thread.join(30)
    assert not thread.is_alive()


def test_gradio_branch_wiring(monkeypatch, pipe):
    calls = {}

    class _Widget:
        def __init__(self, *a, **kw):
            pass

    class _Interface:
        def __init__(self, fn=None, inputs=None, outputs=None, **kw):
            calls['fn'] = fn
            calls['n_inputs'] = len(inputs)

        def launch(self, server_name=None, server_port=None, **kw):
            calls['launch'] = (server_name, server_port)

    stub = types.ModuleType('gradio')
    stub.Interface = _Interface
    stub.Textbox = stub.Slider = stub.Checkbox = stub.HTML = _Widget
    monkeypatch.setitem(sys.modules, 'gradio', stub)

    args = demo.get_args(['--tiny', '--port', '8123', '--device', 'cpu'])
    demo._gradio_main(pipe, args)
    assert calls['launch'] == ('0.0.0.0', 8123)
    assert calls['n_inputs'] == 5
    assert 'data:image/png;base64' in calls['fn']('A blue dog', '', '', STEPS, False)


# ---------------------------------------------------------------------------
# profiling.py
# ---------------------------------------------------------------------------

def test_profile_trace_writes_a_chrome_trace(tmp_path, pipe):
    import json

    from daam_tpu_torch.profiling import profile_trace

    with profile_trace(str(tmp_path / 'prof')) as prof:
        pipe('a dog', num_inference_steps=1)
    doc = json.loads((tmp_path / 'prof' / 'trace.json').read_text())
    events = doc['traceEvents']
    assert any('conv' in str(e.get('name', '')) for e in events)
    assert len(prof.key_averages()) > 0
    # the program's spans, on a track of their own and the profiler's clock
    spans = [e for e in events if e.get('cat') == 'span']
    unet = [e for e in spans if e['name'] == 'unet']
    assert unet and unet[0]['ph'] == 'X' and unet[0]['dur'] > 0
    assert {e['pid'] for e in spans} == {'daam_tpu_torch spans'}
    assert {'request', 'parent', 'id'} <= set(unet[0]['args'])
    ops = [e for e in events if e.get('ph') == 'X' and e.get('cat') != 'span']
    call = [e for e in spans if e['name'] == 'call'][0]
    convs = [e for e in ops if e['name'] == 'aten::conv2d']
    assert convs and all(call['ts'] - 100 <= e['ts'] and e['ts'] + e['dur'] <= call['ts']
                         + call['dur'] + 100 for e in convs)


def test_step_timer_and_time_pipeline(pipe):
    from daam_tpu_torch.profiling import time_pipeline

    for traced in (False, True):
        t = time_pipeline(pipe, num_inference_steps=1, reps=2, traced=traced)
        assert list(t) == ['traced_call' if traced else 'call'] and t[next(iter(t))] > 0
