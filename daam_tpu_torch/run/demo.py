"""``daam-torch-demo`` — web demo with attention-transplant counterfactuals.

Counterpart of ``daam_tpu/run/demo.py`` (reference ``daam/run/demo.py``).
A self-contained ``http.server`` app (the reference uses Gradio, which
``--gradio`` serves where it is installed) with one page:

* a prompt box and an example dropdown;
* a heat-map grid, one overlay per parsed word (``parsed_heat_maps``);
* the adjective-swap counterfactual: a ``save_heads`` run of the prompt,
  then a ``load_heads`` run of the prompt with one adjective replaced, from
  the same seed (the attention transplant, reference ``demo.py:102-114``);
* a displaCy-style dependency parse.

Plain requests that arrive together are coalesced into one traced call
(:class:`BatchQueue`, ``--batch-size``); counterfactual requests run alone,
behind the lock that serializes every generation (reference ``demo.py:69``).
The device defaults to ``cuda`` and raises without a GPU; ``--device cpu``
runs on the CPU.
"""

import argparse
import base64
import html as html_mod
import io
import queue
import time
import urllib.parse
from collections import deque
from threading import Event, Lock, Thread

import numpy as np
import torch

from ..nlp import cached_nlp
from ..trace import release_heads, trace
from ..utils import resolve_device

MODELS = ['v1', 'v2-base', 'v2-large', 'v2-1-base', 'v2-1-large']

EXAMPLES = [
    'An angry, bald man doing research',
    'A bear and a moose',
    'A blue car driving through the city',
    'Monkey walking with hat',
    'A brown cat eating yummy cake for her birthday',
    'A brown fox, a white dog, and a blue wolf in a green field',
]

#: The replay-buffer key of the counterfactual's save → load pair; the
#: buffer stays in memory and is released after the load run.
HEADS_KEY = 'daam-torch-demo'


def get_tokenizing_mapping(prompt, tokenizer):
    """Group subword token indices into words via ``</w>`` markers
    (reference ``demo.py:25-41``)."""
    tokens = tokenizer.tokenize(prompt)
    merge_idxs, words = [], []
    curr_idxs, curr_word = [], ''
    for i, token in enumerate(tokens):
        curr_idxs.append(i + 1)  # +1 for the SOS token
        curr_word += token
        if '</w>' in token:
            merge_idxs.append(curr_idxs)
            curr_idxs = []
            words.append(curr_word[:-4])
            curr_word = ''
    return merge_idxs, words


def dependency_svg(text: str) -> str:
    """Inline displaCy-style dependency-parse SVG: tokens on a baseline with
    POS tags, labeled arcs from head to dependent with arrowheads (the
    reference renders ``spacy.displacy``, ``daam/run/demo.py:18-22``)."""
    from html import escape

    tokens = list(cached_nlp(text))
    if not tokens:
        return '<svg class="dep" width="40" height="40"></svg>'

    spacing = max(70, 18 * max(len(t.text) for t in tokens))
    x0 = 30
    max_level = 1
    for tok in tokens:
        if tok.head.i != tok.i:
            max_level = max(max_level, abs(tok.head.i - tok.i))
    word_y = 40 + 26 * max_level  # arcs stack above the words
    height = word_y + 45
    width = x0 * 2 + spacing * max(len(tokens) - 1, 1)

    words = []
    for i, tok in enumerate(tokens):
        x = x0 + i * spacing
        words.append(
            f'<text text-anchor="middle" x="{x}" y="{word_y}" '
            f'class="dep-word">{escape(tok.text)}'
            f'<tspan x="{x}" dy="18" class="dep-pos">{tok.pos_}</tspan></text>')

    arcs = []
    for tok in tokens:
        i, j = tok.i, tok.head.i
        if i == j:
            continue
        xa = x0 + min(i, j) * spacing + 6
        xb = x0 + max(i, j) * spacing - 6
        top = word_y - 18 - 26 * abs(i - j)
        y = word_y - 16
        xm = (xa + xb) / 2
        xd = xa if i < j else xb  # the arrowhead sits at the dependent's end
        arcs.append(
            f'<path class="dep-arc" d="M{xa},{y} C{xa},{top} {xb},{top} '
            f'{xb},{y}" fill="none"/>'
            f'<polygon class="dep-arrow" points="{xd - 4},{y - 5} '
            f'{xd + 4},{y - 5} {xd},{y + 3}"/>'
            f'<text text-anchor="middle" x="{xm:.0f}" '
            f'y="{(top + y) / 2 + 2:.0f}" class="dep-label">'
            f'{escape(tok.dep_)}</text>')

    return (f'<svg class="dep" width="{width}" height="{height}" '
            f'xmlns="http://www.w3.org/2000/svg">' +
            ''.join(arcs) + ''.join(words) + '</svg>')


def dependency_html(text: str) -> str:
    """Dependency readout embedded in the page (displaCy-style SVG)."""
    return dependency_svg(text)


def _img_to_b64(pil_img) -> str:
    buf = io.BytesIO()
    pil_img.save(buf, format='PNG')
    return base64.b64encode(buf.getvalue()).decode()


def _overlay_b64(image, word_heat_map) -> str:
    """A word's overlay as a base64 PNG: the ``_jet_composite`` that
    ``WordHeatMap.plot_overlay`` draws, encoded with PIL, with no matplotlib
    figure on the request path."""
    import PIL.Image

    from ..heatmap import _jet_composite

    heat = word_heat_map.expand_as(image)
    composite = _jet_composite(np.asarray(image), heat, color_normalize=True)
    return _img_to_b64(PIL.Image.fromarray((composite * 255).astype(np.uint8)))


PAGE = """<!doctype html>
<html><head><title>DAAM: Attention Maps for Stable Diffusion</title>
<style>
body {{ font-family: sans-serif; margin: 2em; max-width: 1100px; }}
.grid {{ display: flex; flex-wrap: wrap; gap: 8px; }}
.cell {{ text-align: center; font-size: 13px; }}
img {{ max-width: 256px; }}
svg.dep {{ overflow: visible; }}
svg.dep .dep-word {{ font-size: 14px; fill: #222; }}
svg.dep .dep-pos {{ font-size: 11px; fill: #999; }}
svg.dep .dep-label {{ font-size: 10px; fill: #7766aa; }}
svg.dep .dep-arc {{ stroke: #7766aa; stroke-width: 1.2px; }}
svg.dep .dep-arrow {{ fill: #7766aa; }}
textarea {{ width: 60%; }}
</style></head>
<body>
<h1>DAAM: Attention Maps for Interpreting Stable Diffusion</h1>
<p>PyTorch and CUDA port of <a href="https://github.com/castorini/daam">DAAM</a>
(paper: <a href="http://arxiv.org/abs/2210.04885">What the DAAM</a>).</p>
<form method="post" action="/generate">
<p><textarea name="prompt" rows="2">{prompt}</textarea></p>
<p>Examples: <select name="example" onchange="this.form.prompt.value=this.value">
{examples}</select></p>
<p>Adjective to replace: <select name="choice">{adjectives}</select>
New adjective: <input name="new_adj" value="{new_adj}"/></p>
<p>Inference steps: <input name="steps" type="number" value="{steps}" min="1" max="50"/>
Random seed: <input name="random_seed" type="checkbox" {random_checked}/></p>
<p><button type="submit">Submit</button></p>
</form>
{results}
<h3>Dependency parse</h3>
{dep}
</body></html>"""


class BatchQueue:
    """Microbatching of concurrent plain demo requests.

    Requests that arrive within ``window_s`` of the first one coalesce into
    one traced pipeline call of ``batch_size`` prompts (the reference runs
    one prompt per call behind a lock, ``daam/run/demo.py:69``):

    * the prompts are padded to the fixed ``batch_size`` by repeating the
      last one, so every call has one shape: a request's numbers do not
      depend on how many others shared its call (no compiled program asks
      for it on the GPU, as one does in ``daam_tpu``);
    * each request gets its own ``torch.Generator`` on the pipeline's
      device, seeded with its seed, so its image is the one a batch-1 call
      with that seed gives;
    * each request's map is ``compute_global_heat_map(batch_idx=i)``.

    Its rate on the card stands in ``PERF.md`` §7 (cell #6).

    ``served`` holds, for each of the last 1000 traced calls, how many
    requests it answered.
    :meth:`close` stops the worker thread.
    """

    #: Backstop so that a waiter never hangs if the worker dies in a way
    #: the per-call guards miss.
    SUBMIT_TIMEOUT_S = 1800.0

    def __init__(self, pipe, batch_size: int, lock, window_s: float = 0.05):
        self.pipe = pipe
        self.batch_size = batch_size
        self.lock = lock
        self.window_s = window_s
        self.served = deque(maxlen=1000)
        self._q = queue.Queue()
        self._thread = Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, prompt: str, steps: int, seed: int):
        """Block until the request's generation completes; returns
        ``(image, GlobalHeatMap)``."""
        item = {'prompt': prompt, 'steps': steps, 'seed': seed, 'ev': Event()}
        self._q.put(item)
        if not item['ev'].wait(timeout=self.SUBMIT_TIMEOUT_S):
            raise TimeoutError('daam-torch-demo batch worker did not respond')
        if 'error' in item:
            raise item['error']
        return item['image'], item['heat_map']

    def close(self, timeout: float = 60.0):
        """Stop the worker after the requests already queued."""
        self._q.put(None)
        self._thread.join(timeout)

    def _loop(self):
        while True:
            first = self._q.get()
            if first is None:
                return
            batch = [first]
            deadline = time.monotonic() + self.window_s
            while len(batch) < self.batch_size:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if item is None:  # close(): serve this batch, then stop
                    self._q.put(None)
                    break
                batch.append(item)
            try:
                by_steps = {}
                for item in batch:  # one call per step count
                    by_steps.setdefault(item['steps'], []).append(item)
                for steps, items in by_steps.items():
                    self._run(steps, items)
            except BaseException as e:  # noqa: BLE001 - keep the worker alive
                # _run guards its own body; this catches anything outside
                # it, so that no waiter is left blocking
                for item in batch:
                    if not item['ev'].is_set():
                        item.setdefault('error', e if isinstance(e, Exception)
                                        else RuntimeError(repr(e)))
                        item['ev'].set()

    def _run(self, steps, items):
        try:
            prompts = [it['prompt'] for it in items]
            seeds = [it['seed'] for it in items]
            while len(prompts) < self.batch_size:  # pad to the fixed batch
                prompts.append(prompts[-1])
                seeds.append(seeds[-1])
            generators = [torch.Generator(device=self.pipe.device).manual_seed(s)
                          for s in seeds]
            with self.lock, trace(self.pipe) as tc:
                out = self.pipe(prompts, num_inference_steps=steps,
                                generator=generators)
                for i, it in enumerate(items):
                    it['image'] = out.images[i]
                    it['heat_map'] = tc.compute_global_heat_map(batch_idx=i)
            self.served.append(len(items))
        except Exception as e:  # deliver the failure to every waiter
            for it in items:
                it['error'] = e
        finally:
            for it in items:
                it['ev'].set()


def make_app(pipe, default_seed: int, batch_size: int = 1):
    """The request handler class bound to a pipeline.  ``batch_size > 1``
    coalesces plain requests (:class:`BatchQueue`); counterfactual
    (transplant) requests always run alone, as in the reference.  On the
    card the kernel library is built here, before any request thread can
    ask for it."""
    import http.server

    if pipe.device.type == 'cuda':
        from ..ops import kernels
        kernels.load_library()
    lock = Lock()
    batcher = BatchQueue(pipe, batch_size, lock) if batch_size > 1 else None

    def render(prompt='An angry, bald man doing research', new_adj='',
               steps=10, random_seed=False, results=''):
        adjectives = [''] + [t.text for t in cached_nlp(prompt) if t.pos_ == 'ADJ']
        return PAGE.format(
            prompt=html_mod.escape(prompt),
            examples=''.join(f'<option value="{e}">{e}</option>' for e in EXAMPLES),
            adjectives=''.join(f'<option value="{a}">{a}</option>' for a in adjectives),
            new_adj=new_adj,
            steps=steps,
            random_checked='checked' if random_seed else '',
            results=results,
            dep=dependency_html(prompt),
        ).encode()

    def generate(prompt, choice, new_adj, steps, random_seed):
        """The reference's ``plot`` flow (``demo.py:77-158``); returns the
        prompt and the results' HTML."""
        prompt = prompt.replace(',', ', ').replace('.', '. ')
        new_prompt = prompt
        if choice:
            if not new_adj:
                new_adj = '.'
            new_prompt = ' '.join(new_adj if tok.text == choice else tok.text
                                  for tok in cached_nlp(prompt))

        seed = int(time.time()) if random_seed else default_seed
        counterfactual = choice and new_prompt != prompt

        image2 = None
        evolution = None
        if batcher is not None and not counterfactual:
            image, heat_map = batcher.submit(prompt, steps, seed)
        else:
            with lock:
                gen = torch.Generator(device=pipe.device).manual_seed(seed)
                with trace(pipe, save_heads=bool(counterfactual),
                           data_dir=HEADS_KEY, persist_heads=False) as tc:
                    out = pipe(prompt, num_inference_steps=steps, generator=gen)
                    heat_map = tc.compute_global_heat_map()
                    image = out.images[0]
                    if counterfactual:
                        # the replay buffer doubles as a per-step series
                        evolution = tc.compute_time_global_heat_maps()
                if counterfactual:
                    gen = torch.Generator(device=pipe.device).manual_seed(seed)
                    try:
                        with trace(pipe, load_heads=True, data_dir=HEADS_KEY):
                            image2 = pipe(new_prompt, num_inference_steps=steps,
                                          generator=gen).images[0]
                    finally:
                        release_heads(HEADS_KEY)

        esc = html_mod.escape
        html = ['<h3>Images</h3><div class="grid">']
        html.append(f'<div class="cell"><img src="data:image/png;base64,'
                    f'{_img_to_b64(image)}"/><br/>{esc(prompt)}</div>')
        if image2 is not None:
            html.append(f'<div class="cell"><img src="data:image/png;base64,'
                        f'{_img_to_b64(image2)}"/><br/>{esc(new_prompt)} '
                        f'(transplanted attention)</div>')
        html.append('</div><h3>DAAM maps</h3><div class="grid">')
        for parsed in heat_map.parsed_heat_maps():
            b64 = _overlay_b64(image, parsed.word_heat_map)
            html.append(f'<div class="cell"><img src="data:image/png;base64,'
                        f'{b64}"/><br/>{esc(parsed.token.text)}</div>')
        html.append('</div>')
        if evolution is not None and choice:
            # up to 8 evenly spaced steps of the replaced word's attention
            n = len(evolution)
            idxs = sorted({round(i * (n - 1) / max(1, min(8, n) - 1))
                           for i in range(min(8, n))})
            html.append(f'<h3>Attention evolution: {esc(choice)}</h3>'
                        f'<div class="grid">')
            for s in idxs:
                wm = evolution[s].compute_word_heat_map(choice)
                b64 = _overlay_b64(image, wm)
                html.append(f'<div class="cell"><img src="data:image/png;'
                            f'base64,{b64}"/><br/>step {s + 1}/{n}</div>')
            html.append('</div>')
        return prompt, ''.join(html)

    class Handler(http.server.BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send(self, body, code=200):
            self.send_response(code)
            self.send_header('Content-Type', 'text/html; charset=utf-8')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            self._send(render())

        def do_POST(self):
            length = int(self.headers.get('Content-Length', 0))
            data = urllib.parse.parse_qs(self.rfile.read(length).decode())
            prompt = data.get('prompt', [''])[0] or EXAMPLES[0]
            choice = data.get('choice', [''])[0]
            new_adj = data.get('new_adj', [''])[0]
            random_seed = 'random_seed' in data
            try:
                steps = int(data.get('steps', ['10'])[0])
                prompt, results = generate(prompt, choice, new_adj, steps,
                                           random_seed)
            except Exception as e:  # the error goes to the page
                steps, results = 10, f'<pre>error: {html_mod.escape(str(e))}</pre>'
            self._send(render(prompt=prompt, new_adj=new_adj, steps=steps,
                              random_seed=random_seed, results=results))

    Handler.generate = staticmethod(generate)  # for direct (headless) calls
    Handler.batcher = batcher
    return Handler


def get_args(argv=None):
    parser = argparse.ArgumentParser(prog='daam-torch-demo')
    parser.add_argument('--model', '-m', type=str, default='v2-1-base',
                        choices=MODELS)
    parser.add_argument('--seed', '-s', type=int, default=0)
    parser.add_argument('--port', '-p', type=int, default=8080)
    parser.add_argument('--tiny', action='store_true',
                        help='tiny random-weight preset')
    parser.add_argument('--from-path', type=str, default=None,
                        help='local diffusers checkpoint directory')
    parser.add_argument('--scheduler', type=str, default='ddim')
    parser.add_argument('--gradio', action='store_true',
                        help='serve via Gradio if installed')
    parser.add_argument('--batch-size', type=int, default=1,
                        help='coalesce concurrent plain requests into one '
                             'traced call of this (fixed, padded) batch size')
    parser.add_argument('--dtype', type=str, default='float32',
                        choices=['float32', 'bfloat16'])
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device (default: cuda; pass cpu to run '
                             'on the CPU)')
    return parser.parse_args(argv)


def main(argv=None):
    import http.server

    from ..pipeline.sd import StableDiffusionPipeline

    args = get_args(argv)
    source = 'tiny' if args.tiny else (args.from_path or args.model)
    dtype = torch.bfloat16 if args.dtype == 'bfloat16' else torch.float32
    pipe = StableDiffusionPipeline.from_pretrained(
        source, device=resolve_device(args.device), dtype=dtype, seed=args.seed,
        scheduler=args.scheduler)

    if args.gradio:
        try:
            return _gradio_main(pipe, args)
        except ImportError:
            print('gradio not installed; serving with http.server')

    handler = make_app(pipe, args.seed, batch_size=args.batch_size)
    server = http.server.ThreadingHTTPServer(('0.0.0.0', args.port), handler)
    print(f'daam-torch-demo listening on http://0.0.0.0:{args.port}')
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        if handler.batcher is not None:
            handler.batcher.close()


def _gradio_main(pipe, args):
    """The Gradio app around :func:`make_app`'s ``generate`` (reference
    ``daam/run/demo.py:163-218``)."""
    import gradio as gr
    handler = make_app(pipe, args.seed, batch_size=args.batch_size)

    def run(prompt, choice, new_adj, steps, random_seed):
        _, html = handler.generate(prompt, choice, new_adj, int(steps),
                                   random_seed)
        return html

    demo = gr.Interface(
        fn=run,
        inputs=[gr.Textbox(label='Prompt', value=EXAMPLES[0]),
                gr.Textbox(label='Adjective to replace'),
                gr.Textbox(label='New adjective'),
                gr.Slider(1, 50, value=10, step=1, label='Inference steps'),
                gr.Checkbox(label='Random seed')],
        outputs=gr.HTML(),
        title='DAAM: Attention Maps for Interpreting Stable Diffusion')
    demo.launch(server_name='0.0.0.0', server_port=args.port)


if __name__ == '__main__':
    main()
