"""The port's own copies of daam_tpu's framework-free code stay equal to it.

``daam_tpu_torch`` cannot import ``daam_tpu`` (that imports JAX and Flax), so
it carries copies of the configs, the cross-attention layout, the BPE
tokenizer, the token-merge arithmetic, the COCO label tables and the
bicubic weight matrices of the mask evaluation.  These tests hold each copy equal
to its original, and check that the port never imports JAX.
"""

import dataclasses
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
            'daam_tpu_torch.ops.resize', 'daam_tpu_torch.run.evaluate'} <= set(modules)
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
