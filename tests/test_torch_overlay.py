"""The overlay API of daam_tpu_torch against daam_tpu's.

``plot_overlay_heat_map(..., crop=None, color_normalize=True, ax=None)``,
``WordHeatMap.plot_overlay(..., ax=None, **expand_kwargs)``,
``GenerationExperiment.save_heat_map(word, tokenizer, crop, output_prefix,
absolute)`` and ``save_all_heat_maps(tokenizer, crop)``: the same
composite, drawn on the same axes with the same title, from the same
arguments, positional ones included.  Also the PNG writer of the card's
route (``daam_tpu_torch.png``) against Pillow, the host route's PNGs from
one resample a word equal to those of two, and the route an experiment
made on the CPU takes (the card's own is held to the host's in
``tests/test_torch_kernel_emulation.py`` and ``tests/test_torch_cuda.py``).
"""

import io  # noqa: E402
import struct  # noqa: E402
import sys  # noqa: E402
import zlib  # noqa: E402

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
from daam_tpu_torch import heatmap, png, profiling  # noqa: E402
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


# ------------------------------------------------------------ the PNG writer

def _pillow_png(pixels: np.ndarray) -> bytes:
    buf = io.BytesIO()
    PIL.Image.fromarray(pixels).save(buf, format='PNG')
    return buf.getvalue()


def _scanlines(png_file: bytes, shape) -> np.ndarray:
    """The filtered (H, 1 + 3W) rows of a PNG's IDAT."""
    pos, idat = 8, b''
    while pos < len(png_file):
        n, = struct.unpack('>I', png_file[pos:pos + 4])
        if png_file[pos + 4:pos + 8] == b'IDAT':
            idat += png_file[pos + 8:pos + 8 + n]
        pos += 12 + n
    return np.frombuffer(zlib.decompress(idat), np.uint8).reshape(shape[0], 1 + 3 * shape[1])


def _pixels(kind: str, H: int, W: int) -> np.ndarray:
    rng = np.random.RandomState(H + W)
    if kind == 'noise':  # what random-weight images look like
        return rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
    y, x = np.mgrid[0:H, 0:W]
    if kind == 'smooth':
        return np.stack([(x * 3 + y) % 256, (x + y * 2) % 256, (x * y // 64) % 256],
                        -1).astype(np.uint8)
    return np.full((H, W, 3), 200, np.uint8)  # flat


@pytest.mark.parametrize('kind,H,W', [('noise', 512, 512), ('noise', 37, 21),
                                      ('smooth', 96, 128), ('flat', 16, 16)])
def test_png_writer_reads_back_and_is_pillows_size(tmp_path, kind, H, W):
    pixels = _pixels(kind, H, W)
    unfiltered = np.concatenate([np.zeros((H, 1), np.uint8), pixels.reshape(H, -1)], 1)
    png.write_png(tmp_path / 'raw.png', unfiltered)
    with PIL.Image.open(tmp_path / 'raw.png') as im:
        assert im.mode == 'RGB'
        np.testing.assert_array_equal(np.asarray(im), pixels)
    # Pillow's own filtered rows, deflated by the writer
    theirs = _pillow_png(pixels)
    ours = png.png_bytes(_scanlines(theirs, pixels.shape))
    with PIL.Image.open(io.BytesIO(ours)) as im:
        np.testing.assert_array_equal(np.asarray(im), pixels)
    assert abs(len(ours) - len(theirs)) <= 0.01 * len(theirs), (len(ours), len(theirs))
    from PIL import features
    if features.version('zlib') == zlib.ZLIB_RUNTIME_VERSION:
        assert ours == theirs, 'the same zlib deflates to Pillow\'s very file'


def test_png_writer_refuses_rows_that_are_not_rgb():
    with pytest.raises(ValueError):
        png.png_bytes(np.zeros((4, 9), np.uint8))  # 8 bytes: no whole RGB pixels


# ------------------------------------------------------- the host route

@pytest.mark.parametrize('matplotlib_installed', [True, False])
@pytest.mark.parametrize('absolute', [False, True])
def test_host_route_pngs_equal_those_of_two_resamples(tmp_path, monkeypatch,
                                                      matplotlib_installed, absolute):
    """save_heat_map resamples a word's map once; its PNG is the one it
    wrote when expand_as resampled once for what it returns and again for
    the overlay it draws."""
    ours, _ = _experiments(tmp_path)
    ours.path.mkdir(parents=True)
    if not matplotlib_installed:
        monkeypatch.setitem(sys.modules, 'matplotlib', None)
        monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    plt.close('all')
    new = ours.save_heat_map('dog', absolute=absolute).read_bytes()
    word_map = ours.heat_map().compute_word_heat_map('dog')
    word_map.expand_as(ours.image)
    heatmap.plot_overlay_heat_map(ours.image, word_map.expand_as(ours.image),
                                  word=word_map.word, out_file=tmp_path / 'two.png',
                                  color_normalize=not absolute)
    assert new == (tmp_path / 'two.png').read_bytes()


@pytest.mark.parametrize('kwargs', [{'absolute': True}, {'threshold': 0.5},
                                    {'absolute': True, 'threshold': 0.5}])
def test_expand_as_plot_draws_the_plain_expansion(tmp_path, monkeypatch, kwargs):
    """With absolute or threshold, expand_as(plot=True) returns that map and
    draws the overlay of plain expand_as(image), as the reference does."""
    image, heat = _inputs()
    word_map = heatmap.WordHeatMap(torch.from_numpy(heat[::4, ::4].copy()), word='dog')
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    got = word_map.expand_as(image, plot=True, out_file=tmp_path / 'one.png', **kwargs)
    np.testing.assert_array_equal(got, word_map.expand_as(image, **kwargs))
    heatmap.plot_overlay_heat_map(image, word_map.expand_as(image),
                                  out_file=tmp_path / 'two.png')
    assert (tmp_path / 'one.png').read_bytes() == (tmp_path / 'two.png').read_bytes()


@pytest.fixture(scope='module')
def tiny_pipe():
    from daam_tpu_torch import StableDiffusionPipeline
    return StableDiffusionPipeline.from_pretrained('tiny', device='cpu')


def test_experiment_made_on_the_cpu_draws_on_the_host(tiny_pipe, tmp_path):
    from daam_tpu_torch import trace
    from daam_tpu_torch.ops import kernels

    with trace(tiny_pipe) as tc:
        out = tiny_pipe('a dog runs', num_inference_steps=2,
                        generator=torch.Generator().manual_seed(0))
        exp = tc.to_experiment(tmp_path)
    exp.image = out.images[0]
    before, launched = profiling.counters(), dict(kernels.launches)
    exp.save(heat_maps=False)
    written = [exp.save_heat_map(word) for word in ('dog', 'runs')]
    after = profiling.counters()
    assert after['overlay_host'] - before['overlay_host'] == len(written)
    assert after['overlay_card'] == before['overlay_card']
    assert dict(kernels.launches) == launched
    assert all(p.exists() for p in written) and (tmp_path / 'output.png').exists()


def test_route_is_chosen_by_the_image_and_the_maps_device(tmp_path):
    """No device recorded, a CPU device, or a CUDA device with an image
    that is not an RGB PIL image: the host draws, and nothing touches a
    card."""
    ours, _ = _experiments(tmp_path)
    assert ours._image_on_card() is None
    ours._device = torch.device('cpu')
    assert ours._image_on_card() is None
    ours._device = torch.device('cuda')
    for image in (np.zeros((32, 32, 3), np.float32), ours.image.convert('L')):
        ours.image = image
        assert ours._image_on_card() is None
