"""The overlay API of daam_tpu_torch against daam_tpu's.

``plot_overlay_heat_map(..., crop=None, color_normalize=True, ax=None)``,
``WordHeatMap.plot_overlay(..., ax=None, **expand_kwargs)``,
``GenerationExperiment.save_heat_map(word, tokenizer, crop, output_prefix,
absolute)`` and ``save_all_heat_maps(tokenizer, crop)``: the same
composite, drawn on the same axes with the same title, from the same
arguments, positional ones included.
"""

import matplotlib

matplotlib.use('Agg')

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import PIL.Image  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from daam_tpu import heatmap as jax_heatmap  # noqa: E402
from daam_tpu.experiment import GenerationExperiment as JaxExperiment  # noqa: E402
from daam_tpu.tokenization import default_tokenizer as jax_tokenizer  # noqa: E402
from daam_tpu_torch import heatmap  # noqa: E402
from daam_tpu_torch.experiment import GenerationExperiment  # noqa: E402
from daam_tpu_torch.tokenization import default_tokenizer  # noqa: E402

PROMPT = 'A dog runs across the field .'


def _inputs():
    rng = np.random.RandomState(0)
    image = rng.randint(0, 255, (48, 40, 3), dtype=np.uint8)
    heat = rng.rand(48, 40).astype(np.float32)
    return image, heat


def _drawn(ax):
    images = ax.get_images()
    assert len(images) == 1
    return np.asarray(images[0].get_array())


@pytest.mark.parametrize('crop', [None, 10])
def test_composite_with_crop_equals_daam_tpu(crop):
    image, heat = _inputs()
    drawn = {}
    for name, mod in (('ours', heatmap), ('theirs', jax_heatmap)):
        plt.close('all')
        mod.plot_overlay_heat_map(image, heat, word='dog', crop=crop)
        drawn[name] = _drawn(plt.gca())
        assert plt.gca().get_title() == 'dog'
    side = (48 - 2 * crop, 40 - 2 * crop) if crop else (48, 40)
    assert drawn['ours'].shape == drawn['theirs'].shape == (*side, 3)
    np.testing.assert_allclose(drawn['ours'], drawn['theirs'], rtol=0, atol=1e-6)


def test_crop_without_matplotlib(tmp_path, monkeypatch):
    """The PIL route writes the cropped composite."""
    import sys

    image, heat = _inputs()
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    heatmap.plot_overlay_heat_map(image, heat, out_file=tmp_path / 'c.png', crop=10)
    written = np.array(PIL.Image.open(tmp_path / 'c.png'))
    expect = heatmap._jet_composite(image[10:-10, 10:-10], heat[10:-10, 10:-10], True)
    np.testing.assert_array_equal(
        written, np.clip(expect * 255 + 0.5, 0, 255).astype(np.uint8))


def test_plot_overlay_draws_on_the_given_axes():
    """``ax`` of a 1×2 grid receives the image and the title; the figure
    keeps both axes and the other one stays empty, as with daam_tpu."""
    image, heat = _inputs()
    word_maps = {'ours': heatmap.WordHeatMap(torch.from_numpy(heat[::4, ::4].copy()),
                                             word='dog'),
                 'theirs': jax_heatmap.WordHeatMap(heat[::4, ::4], word='dog')}
    drawn = {}
    for name, word_map in word_maps.items():
        plt.close('all')
        fig, axes = plt.subplots(1, 2)
        word_map.plot_overlay(image, ax=axes[1])
        assert plt.gcf() is fig and len(fig.axes) == 2
        assert axes[0].get_images() == [] and axes[0].get_title() == ''
        assert axes[1].get_title() == 'dog'
        drawn[name] = _drawn(axes[1])
    assert drawn['ours'].shape == (48, 40, 3)
    np.testing.assert_allclose(drawn['ours'], drawn['theirs'], rtol=0, atol=1e-5)


def _experiments(tmp_path):
    rng = np.random.RandomState(3)
    image = PIL.Image.fromarray(rng.randint(0, 255, (32, 32, 3), dtype=np.uint8))
    maps = rng.rand(9, 8, 8).astype(np.float32)
    return (GenerationExperiment(image, maps, PROMPT, path=tmp_path / 'ours',
                                 tokenizer=default_tokenizer()),
            JaxExperiment(image, maps, PROMPT, path=tmp_path / 'theirs',
                          tokenizer=jax_tokenizer()))


def test_save_heat_map_third_positional_is_crop(tmp_path):
    ours, theirs = _experiments(tmp_path)
    for exp in (ours, theirs):
        exp.path.mkdir(parents=True)
    out, jout = ours.save_heat_map('dog', None, 10), theirs.save_heat_map('dog', None, 10)
    assert out.name == jout.name == 'dog.heat_map.png'
    assert out.exists() and jout.exists()
    prefixed = ours.save_heat_map('dog', None, None, 'p-')
    assert prefixed.name == theirs.save_heat_map('dog', None, None, 'p-').name \
        == 'p-dog.heat_map.png'


def test_save_all_heat_maps_skips_any_failure(tmp_path, monkeypatch):
    """Words whose map fails for any reason are skipped, as in daam_tpu."""
    ours, theirs = _experiments(tmp_path)
    for exp in (ours, theirs):
        exp.path.mkdir(parents=True)
    assert sorted(ours.save_all_heat_maps(None, 10)) == \
        sorted(theirs.save_all_heat_maps(None, 10))
    save = GenerationExperiment.save_heat_map

    def failing(self, word, *args, **kwargs):
        if word == 'dog':
            raise RuntimeError('not a ValueError')
        return save(self, word, *args, **kwargs)
    monkeypatch.setattr(GenerationExperiment, 'save_heat_map', failing)
    saved = ours.save_all_heat_maps(crop=10)
    assert 'dog' not in saved and 'runs' in saved
