"""The port's own copies of daam_tpu's framework-free code stay equal to it.

``daam_tpu_torch`` cannot import ``daam_tpu`` (that imports JAX and Flax), so
it carries copies of the configs, the cross-attention layout, the BPE
and hash tokenizers, the token-merge arithmetic, the COCO label tables, the
rule-based NLP layer and the bicubic weight matrices of the mask
evaluation.  These tests hold each copy equal to its original, check that
the port never imports JAX, that its public names cover ``daam_tpu``'s, and
that its heat-map collection and hookers behave as ``daam_tpu``'s.
"""

import dataclasses
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch  # noqa: F401  (both frameworks in one process, as the guide asks)

from daam_tpu.models import configs as jax_configs
from daam_tpu.models.unet import cross_attention_layout as jax_layout
from daam_tpu.tokenization import default_tokenizer as jax_tokenizer
from daam_tpu.utils import compute_token_merge_indices as jax_merge
import daam_tpu_torch
from daam_tpu_torch.models import configs
from daam_tpu_torch.tokenization import default_tokenizer
from daam_tpu_torch.utils import compute_token_merge_indices

REPO = Path(__file__).resolve().parents[1]
PROMPTS = [
    'A dog runs across the field.',
    'a photo of an astronaut riding a horse on mars',
    "Two dogs, one cat and a bird's nest under_the tree",
    'A DOG and a dog and a hot-dog',
    'Zürich café at 3 a.m. — 100% résumé',
]


def test_port_never_imports_jax():
    """Import every module of the port in a fresh interpreter."""
    modules = [m.name for m in pkgutil.walk_packages(
        daam_tpu_torch.__path__, prefix='daam_tpu_torch.')]
    assert {'daam_tpu_torch.ops.kernels', 'daam_tpu_torch.pipeline.sdxl',
            'daam_tpu_torch.coco', 'daam_tpu_torch.evaluate',
            'daam_tpu_torch.ops.resize', 'daam_tpu_torch.run.evaluate',
            'daam_tpu_torch.nlp', 'daam_tpu_torch.run.generate',
            'daam_tpu_torch.run.demo', 'daam_tpu_torch.profiling'} <= set(modules)
    code = ('import importlib, sys\n'
            f'for m in {modules!r}: importlib.import_module(m)\n'
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "flax", "daam_tpu"))\n'
            'assert not bad, bad\n')
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize('name', sorted(jax_configs.MODEL_PRESETS))
def test_configs_equal(name):
    ours = configs.get_pipeline_config(name)
    theirs = jax_configs.get_pipeline_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.image_size == theirs.image_size
    assert ours.unet.time_embed_dim == theirs.unet.time_embed_dim
    assert ours.vae.scale_factor == theirs.vae.scale_factor
    assert [tuple(i) for i in configs.cross_attention_layout(ours.unet)] == \
        [tuple(i) for i in jax_layout(theirs.unet)]


def test_tokenizer_and_merge_indices_equal():
    ours, theirs = default_tokenizer(), jax_tokenizer()
    for prompt in PROMPTS:
        assert ours.tokenize(prompt) == theirs.tokenize(prompt)
        ids = ours(prompt, padding='max_length', return_tensors='np')['input_ids']
        jids = theirs(prompt, padding='max_length', return_tensors='np')['input_ids']
        assert ids.tolist() == jids.tolist()
        for word in {w.strip('.,') for w in prompt.split()} - {''}:
            try:
                expect = jax_merge(theirs, prompt, word)
            except ValueError:
                with pytest.raises(ValueError):
                    compute_token_merge_indices(ours, prompt, word)
                continue
            assert compute_token_merge_indices(ours, prompt, word) == expect


@pytest.mark.parametrize('xdg', [None, '/some/cache/root'])
def test_cache_dir_equal(xdg, monkeypatch):
    """One cache directory, so a replay buffer persisted by either package
    is found by the other."""
    from daam_tpu.utils import cache_dir as jax_cache_dir
    from daam_tpu_torch.utils import cache_dir

    if xdg is None:
        monkeypatch.delenv('XDG_CACHE_HOME', raising=False)
    else:
        monkeypatch.setenv('XDG_CACHE_HOME', xdg)
    assert cache_dir() == jax_cache_dir()


def test_coco_tables_equal():
    import daam_tpu.coco as theirs
    import daam_tpu_torch.coco as ours

    assert ours.__all__ == theirs.__all__
    for name in theirs.__all__:
        if name == 'build_word_list_coco80':
            assert ours.build_word_list_coco80() == theirs.build_word_list_coco80()
        else:
            assert getattr(ours, name) == getattr(theirs, name), name


@pytest.mark.parametrize('in_size,out_size', [(64, 512), (512, 480), (512, 640),
                                              (96, 64), (33, 70), (8, 8), (1, 5)])
def test_resize_weight_matrix_equal(in_size, out_size):
    """The mask evaluation's bicubic weights are daam_tpu's, bit for bit."""
    import numpy as np
    from daam_tpu.ops import resize as theirs
    from daam_tpu_torch.ops import resize as ours

    w = ours._weight_matrix_np(in_size, out_size)
    assert w.dtype == np.float32
    np.testing.assert_array_equal(w, theirs._weight_matrix_np(in_size, out_size))
    x = np.linspace(-3, 3, 61)
    np.testing.assert_array_equal(ours._cubic_kernel(x), theirs._cubic_kernel(x))


def _code(path: Path) -> str:
    """A module's source after its docstring."""
    return path.read_text().split('"""', 2)[2]


def test_nlp_code_equal():
    """``nlp.py`` is ``daam_tpu/nlp.py`` but for its docstring."""
    assert _code(REPO / 'daam_tpu_torch' / 'nlp.py') == _code(REPO / 'daam_tpu' / 'nlp.py')


@pytest.mark.parametrize('fixture', ['nlp_goldens.json', 'nlp_goldens_heldout.json'])
def test_nlp_parses_equal(fixture):
    """Every golden caption parses to the same tokens, tags, lemmas and
    dependency arcs in both packages."""
    from daam_tpu.nlp import _fallback_nlp as theirs
    from daam_tpu_torch.nlp import _fallback_nlp as ours

    def arcs(doc):
        return [(t.text, t.pos_, t.lemma_, t.dep_, t.head.i, t.whitespace_)
                for t in doc]
    data = json.loads((REPO / 'tests' / 'fixtures' / fixture).read_text())
    texts = [item['text'] for item in data['captions']] + PROMPTS
    for text in texts:
        assert arcs(ours(text)) == arcs(theirs(text)), text


def test_hash_tokenizer_equal():
    from daam_tpu.tokenization import HashWordTokenizer as Theirs
    from daam_tpu_torch.tokenization import HashWordTokenizer as Ours

    for kwargs in ({}, {'chunk_len': 4, 'pad_id': 0}):
        ours, theirs = Ours(**kwargs), Theirs(**kwargs)
        for prompt in PROMPTS:
            assert ours.tokenize(prompt) == theirs.tokenize(prompt)
            assert ours(prompt, return_tensors='np')['input_ids'].tolist() == \
                theirs(prompt, return_tensors='np')['input_ids'].tolist()


def test_public_names_cover_daam_tpu():
    """Every public name of ``daam_tpu`` (its submodules aside: which of
    them are attributes depends on what was imported), its lazy pipeline
    names too, and the version."""
    import types

    import daam_tpu

    theirs = {n for n in dir(daam_tpu) if not n.startswith('_')
              and not isinstance(getattr(daam_tpu, n), types.ModuleType)}
    theirs |= {'StableDiffusionPipeline', 'StableDiffusionXLPipeline',
               'PipelineOutput', 'DiffusionPipeline', '__version__'}
    assert sorted(n for n in theirs if not hasattr(daam_tpu_torch, n)) == []
    assert daam_tpu_torch.DiffusionPipeline is daam_tpu_torch.StableDiffusionPipeline


@pytest.mark.parametrize('name', ['heatmap.plot_overlay_heat_map',
                                  'heatmap.WordHeatMap.plot_overlay',
                                  'experiment.GenerationExperiment.save_heat_map',
                                  'experiment.GenerationExperiment.save_all_heat_maps'])
def test_overlay_signatures_equal(name):
    """The overlay API takes daam_tpu's parameters, in its order, with its
    defaults."""
    import importlib
    import inspect

    def resolve(package):
        module, *attrs = name.split('.')
        obj = importlib.import_module(f'{package}.{module}')
        for attr in attrs:
            obj = getattr(obj, attr)
        return obj

    def params(fn):
        return [(p.name, p.kind, p.default)
                for p in inspect.signature(fn).parameters.values()]
    assert params(resolve('daam_tpu_torch')) == params(resolve('daam_tpu'))


@pytest.mark.parametrize('name', ['bpe.cpp', 'unicode_ranges.inc'])
def test_native_bpe_sources_equal(name):
    """The native BPE core is ``daam_tpu/native``'s, byte for byte."""
    assert (REPO / 'daam_tpu_torch' / 'native' / name).read_bytes() == \
        (REPO / 'daam_tpu' / 'native' / name).read_bytes()


def test_raw_heat_map_collection_equal():
    """``update``, blocks, iteration, ``len``, ``factors``, ``layers`` and
    ``heads`` as ``daam_tpu``'s collection gives them."""
    import numpy as np
    from daam_tpu.heatmap import RawHeatMapCollection as Theirs
    from daam_tpu_torch.heatmap import RawHeatMapCollection as Ours

    rng = np.random.RandomState(0)
    ops = [('update', (2, 0, 1, rng.rand(5, 4, 4))),
           ('update', (2, 0, 1, rng.rand(5, 4, 4))),
           ('update', (4, 3, 0, rng.rand(5, 2, 2))),
           ('block', (8, rng.rand(2, 3, 5, 8, 8), [5, 7])),
           ('block', (8, rng.rand(2, 3, 5, 8, 8), [5, 7]))]
    ours, theirs = Ours(), Theirs()
    for op, args in ops:
        if op == 'update':
            ours.update(*args)
            theirs.update(*args)
        else:
            ours.update_block(*args)
            theirs.update_block(*args)
    assert len(ours) == len(theirs) == 2 + 2 * 3
    for fn in ('factors', 'layers', 'heads'):
        assert getattr(ours, fn)() == getattr(theirs, fn)(), fn
    pairs = list(zip(ours, theirs))
    assert [k for (k, _), _ in pairs] == [k for _, (k, _) in pairs]
    for (_, a), (_, b) in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    ours.clear()
    assert len(ours) == 0 and list(ours) == []


def test_api_parity_helpers(tmp_path):
    """``auto_device`` moves to the device asked for, ``auto_autocast``
    enters ``torch.autocast``, ``plot_mask_heat_map`` draws the masked
    image, and ``numpy_to_pil`` rounds as the pipeline's images do."""
    import matplotlib
    import numpy as np

    from daam_tpu_torch import StableDiffusionPipeline
    from daam_tpu_torch.utils import auto_autocast, auto_device, plot_mask_heat_map

    assert auto_device(device='cpu') == torch.device('cpu')
    assert auto_device(torch.ones(2), device='cpu').device.type == 'cpu'
    with auto_autocast(device_type='cpu', dtype=torch.bfloat16):
        assert (torch.ones(4, 4) @ torch.ones(4, 4)).dtype == torch.bfloat16
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    plt.clf()
    plot_mask_heat_map(np.full((4, 4, 3), 255, np.uint8), torch.eye(4))
    drawn = plt.gca().get_images()[0].get_array()
    assert drawn.shape == (4, 4, 3) and drawn[0, 0, 0] == 1 and drawn[0, 1, 0] == 0
    pil = StableDiffusionPipeline.numpy_to_pil(None, np.full((1, 2, 2, 3), 0.5))
    assert np.asarray(pil[0])[0, 0, 0] == 128


@pytest.mark.parametrize('package', ['daam_tpu_torch', 'daam_tpu'])
def test_object_hooker_patches_reversibly(package):
    """``monkey_patch`` (strict and not), ``monkey_super``, the restore on
    unhook and ``AggregateHooker.register_hook``, the same in both packages."""
    import importlib

    hook = importlib.import_module(f'{package}.hook')

    class Target:
        def greet(self, name):
            return f'hello {name}'

    class Hooker(hook.ObjectHooker):
        def _hook_impl(self):
            self.monkey_patch('greet', self._greet)
            self.monkey_patch('missing', self._greet, strict=False)

        def _greet(hooker, target, name):  # noqa: N805 - bound to the hooker
            return hooker.monkey_super('greet', name).upper()

    target = Target()
    original = target.greet
    agg = hook.AggregateHooker([])
    agg.register_hook(Hooker(target))
    with agg:
        assert target.greet('dog') == 'HELLO DOG'
        assert not hasattr(target, 'missing')
        with pytest.raises(RuntimeError, match='Already hooked'):
            agg.hook()
    assert target.greet('dog') == 'hello dog' and target.greet == original
    with pytest.raises(AttributeError, match='missing'):
        Hooker(target).monkey_patch('missing', lambda t: None)
