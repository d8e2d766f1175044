"""The overlay API of daam_tpu_torch against daam_tpu's.

``plot_overlay_heat_map(..., crop=None, color_normalize=True, ax=None)``,
``WordHeatMap.plot_overlay(..., ax=None, **expand_kwargs)``,
``GenerationExperiment.save_heat_map(word, tokenizer, crop, output_prefix,
absolute)`` and ``save_all_heat_maps(tokenizer, crop)``: the same
composite, drawn on the same axes with the same title, from the same
arguments, positional ones included.  Also the PNG writer of the card's
route (``daam_tpu_torch.png``) against Pillow, one stream or striped on
PyTorch's threads, the host route's PNGs from
one resample a word equal to those of two, and the route an experiment
made on the CPU takes (the card's own is held to the host's in
``tests/test_torch_kernel_emulation.py`` and ``tests/test_torch_cuda.py``).
"""

import contextlib  # noqa: E402
import io  # noqa: E402
import struct  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
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
from daam_tpu_torch.utils import _to_pil  # noqa: E402

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
    if kind == 'jet':  # a word's overlay on a random-weight image
        photo = rng.randint(0, 256, (H, W, 3)).astype(np.uint8)
        bump = np.exp(-((x - W / 3) ** 2 + (y - H / 2) ** 2) / (2 * (H / 5) ** 2))
        composite = heatmap._jet_composite(photo, bump.astype(np.float32), True)
        return np.clip(composite * 255 + 0.5, 0, 255).astype(np.uint8)
    return np.full((H, W, 3), 200, np.uint8)  # flat


@contextlib.contextmanager
def _threads(n: int):
    """PyTorch's intra-op threads set to ``n`` inside the block."""
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


def _chunks(png_file: bytes):
    """(kind, data, crc) of each chunk after the signature."""
    pos, out = 8, []
    while pos < len(png_file):
        n, = struct.unpack('>I', png_file[pos:pos + 4])
        out.append((png_file[pos + 4:pos + 8], png_file[pos + 8:pos + 8 + n],
                    struct.unpack('>I', png_file[pos + 8 + n:pos + 12 + n])[0]))
        pos += 12 + n
    return out


@pytest.mark.parametrize('kind,H,W', [('noise', 512, 512), ('noise', 37, 21),
                                      ('smooth', 96, 128), ('flat', 16, 16)])
def test_png_writer_reads_back_and_is_pillows_size(tmp_path, kind, H, W):
    """On one thread the writer's IDAT is ``compressobj(6, DEFLATED, 15, 9,
    Z_FILTERED)``'s stream of the rows byte for byte (the one stripe under
    the zlib header and the Adler-32), so Pillow's very file where both
    link the same zlib."""
    pixels = _pixels(kind, H, W)
    unfiltered = np.concatenate([np.zeros((H, 1), np.uint8), pixels.reshape(H, -1)], 1)
    with _threads(1):
        png.write_png(tmp_path / 'raw.png', unfiltered)
        with PIL.Image.open(tmp_path / 'raw.png') as im:
            assert im.mode == 'RGB'
            np.testing.assert_array_equal(np.asarray(im), pixels)
        # Pillow's own filtered rows, deflated by the writer
        theirs = _pillow_png(pixels)
        rows = _scanlines(theirs, pixels.shape)
        ours = png.png_bytes(rows)
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    idat = b''.join(data for kind_, data, _ in _chunks(ours) if kind_ == b'IDAT')
    assert idat == z.compress(rows.tobytes()) + z.flush()
    with PIL.Image.open(io.BytesIO(ours)) as im:
        np.testing.assert_array_equal(np.asarray(im), pixels)
    assert abs(len(ours) - len(theirs)) <= 0.01 * len(theirs), (len(ours), len(theirs))
    from PIL import features
    if features.version('zlib') == zlib.ZLIB_RUNTIME_VERSION:
        assert ours == theirs, 'the same zlib deflates to Pillow\'s very file'


@pytest.mark.parametrize('H', [512, 768])
@pytest.mark.parametrize('kind', ['noise', 'smooth', 'jet'])
def test_striped_png_inflates_to_the_rows(kind, H):
    """Two threads deflate 512² and 768² rows in two primed stripes: one
    zlib stream of the very rows, Pillow's pixels, and no more than 0.1%
    over the one-stream file (smooth rows come out smaller: each stripe's
    blocks get Huffman tables of their own)."""
    pixels = _pixels(kind, H, H)
    rows = _scanlines(_pillow_png(pixels), pixels.shape)
    with _threads(1):
        one = png.png_bytes(rows)
    with _threads(2):
        assert png.stripes(rows.nbytes) == 2
        striped = png.png_bytes(rows)
    idat = b''.join(data for kind_, data, _ in _chunks(striped) if kind_ == b'IDAT')
    assert zlib.decompress(idat) == rows.tobytes()
    with PIL.Image.open(io.BytesIO(striped)) as im:
        np.testing.assert_array_equal(np.asarray(im), pixels)
    assert len(striped) <= 1.001 * len(one), (len(striped), len(one))


@pytest.mark.parametrize('nbytes,threads,expected', [
    (png.MIN_STRIPE, 2, 1), (png.MIN_STRIPE, 8, 1), (1000, 4, 1),
    (786_944, 1, 1), (1_770_240, 1, 1),  # 512² and 768² rows, one thread
    (786_944, 2, 2), (1_770_240, 2, 2), (png.MIN_STRIPE + 1, 2, 2),
    (786_944, 4, 4), (786_944, 8, 7), (1_770_240, 8, 8)])
def test_stripe_rule(nbytes, threads, expected):
    """One stripe a thread, each of at least 128 KiB but one."""
    with _threads(threads):
        assert png.stripes(nbytes) == expected


@pytest.mark.parametrize('threads', [1, 2, 3])
def test_png_chunks_and_trailer(threads):
    """The zlib header, the Adler-32 of the whole rows, IDAT chunks of
    64 KiB but the last, and every chunk's CRC-32."""
    pixels = _pixels('noise', 768, 768)
    rows = _scanlines(_pillow_png(pixels), pixels.shape)
    with _threads(threads):
        chunks = _chunks(png.png_bytes(rows))
    for kind, data, crc in chunks:
        assert crc == zlib.crc32(data, zlib.crc32(kind))
    assert [c[0] for c in chunks[:2]] == [b'IHDR', b'IDAT'] and chunks[-1][0] == b'IEND'
    lengths = [len(data) for kind, data, _ in chunks if kind == b'IDAT']
    assert len(lengths) > 1 and set(lengths[:-1]) == {png.IDAT_CHUNK}
    assert 0 < lengths[-1] <= png.IDAT_CHUNK
    idat = b''.join(data for kind, data, _ in chunks if kind == b'IDAT')
    assert idat[:2] == png.ZLIB_HEADER
    assert struct.unpack('>I', idat[-4:])[0] == zlib.adler32(rows.tobytes())


@pytest.mark.parametrize('H,threads,route', [(16, 2, 'png_one_stream'),
                                             (512, 1, 'png_one_stream'),
                                             (512, 2, 'png_striped'),
                                             (768, 4, 'png_striped')])
def test_each_png_counts_its_route(tmp_path, H, threads, route):
    """``write_png`` returns the stripes it deflated in: one stream for
    rows under two stripes' worth or on one thread, else one a thread."""
    rows = _scanlines(_pillow_png(_pixels('noise', H, H)), (H, H))
    with _threads(threads):
        taken = [png.write_png(tmp_path / f'{i}.png', rows) for i in range(2)]
    assert taken == [1 if route == 'png_one_stream' else threads] * 2


@pytest.mark.parametrize('threads', [1, 2])
def test_card_route_encode_states_its_stripes(tmp_path, monkeypatch, threads):
    """``plot_overlay_on_card``'s deflate, its kernels stood in for on the
    CPU: the ``overlay.encode`` span states the stripes, and the file reads
    back."""
    from daam_tpu_torch.ops import kernels

    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    monkeypatch.setattr(kernels, 'overlay_resample', lambda heat, size: heat)
    monkeypatch.setattr(kernels, 'png_scanlines', lambda image, *a, **k: torch.cat(
        [torch.zeros(image.shape[0], 1, dtype=torch.uint8), image.flatten(1)], 1))
    monkeypatch.setattr(heatmap, '_scanlines_to_host', lambda rows: rows.numpy())
    pixels = _pixels('jet', 512, 512)
    profiling.clear()
    profiling.enable()
    try:
        with _threads(threads):
            heatmap.plot_overlay_on_card(torch.from_numpy(pixels), torch.rand(512, 512),
                                         out_file=tmp_path / 'w.png')
            heatmap.plot_overlay_on_card(torch.from_numpy(pixels), torch.rand(512, 512))
    finally:
        profiling.disable()
    encodes = [r.attrs['stripes'] for r in profiling.spans() if r.name == 'overlay.encode']
    assert encodes == [threads, 0]  # no file, nothing deflated
    with PIL.Image.open(tmp_path / 'w.png') as im:
        np.testing.assert_array_equal(np.asarray(im), pixels)


@pytest.mark.parametrize('counts', [(2,), (4,), (4, 2), (3, 3, 5)])
def test_no_more_stripes_deflate_at_once_than_threads(monkeypatch, counts):
    """With the calling thread, ``torch.get_num_threads()`` stripes deflate
    at once, each on a thread of its own, and never more."""
    busy, most, lock = [0], [0], threading.Lock()
    meet, ran = [None], set()
    deflate = png._deflate

    def met(*args):
        with lock:
            busy[0] += 1
            most[0] = max(most[0], busy[0])
            ran.add(threading.get_ident())
        try:
            meet[0].wait(timeout=30)  # every stripe deflating at once
            return deflate(*args)
        finally:
            with lock:
                busy[0] -= 1

    monkeypatch.setattr(png, '_deflate', met)
    rows = _scanlines(_pillow_png(_pixels('noise', 768, 768)), (768, 768))
    for threads in counts:
        most[0] = 0
        ran.clear()
        meet[0] = threading.Barrier(threads)  # 768² rows: one stripe a thread
        with _threads(threads):
            idat = b''.join(d for k, d, _ in _chunks(png.png_bytes(rows)) if k == b'IDAT')
        assert zlib.decompress(idat) == rows.tobytes()
        assert most[0] == threads and len(ran) == threads
        assert threading.get_ident() in ran  # the calling thread deflates one


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


def _card_refused(*args, **kwargs):
    raise AssertionError('the card route was taken')


def test_experiment_made_on_the_cpu_draws_on_the_host(tiny_pipe, tmp_path, monkeypatch):
    from daam_tpu_torch import trace
    from daam_tpu_torch.ops import kernels

    with trace(tiny_pipe) as tc:
        out = tiny_pipe('a dog runs', num_inference_steps=2,
                        generator=torch.Generator().manual_seed(0))
        exp = tc.to_experiment(tmp_path)
    exp.image = out.images[0]
    monkeypatch.setattr(heatmap, 'plot_overlay_on_card', _card_refused)
    launched = dict(kernels.launches)
    exp.save(heat_maps=False)
    written = [exp.save_heat_map(word) for word in ('dog', 'runs')]
    assert dict(kernels.launches) == launched
    assert all(p.exists() for p in written) and (tmp_path / 'output.png').exists()


def test_route_is_chosen_by_the_image_and_the_maps_device(tmp_path, monkeypatch):
    """No device recorded, a CPU device, or a CUDA device with an image
    that is not an RGB PIL image: ``save_image`` and ``save_overlay`` draw
    on the host, and nothing touches a card."""
    ours, _ = _experiments(tmp_path)
    word_map = ours.heat_map().compute_word_heat_map('dog')
    drawn = []
    monkeypatch.setattr(heatmap, 'plot_overlay_on_card', _card_refused)
    monkeypatch.setattr(heatmap.WordHeatMap, 'expand_as',
                        lambda self, image, **kwargs: drawn.append(image))
    cases = [(ours.image, None), (ours.image, torch.device('cpu')),
             *((image, torch.device('cuda')) for image in
               (np.zeros((32, 32, 3), np.float32), ours.image.convert('L')))]
    for i, (image, device) in enumerate(cases):
        heatmap.save_image(image, tmp_path / f'{i}.png', device)
        with PIL.Image.open(tmp_path / f'{i}.png') as im:
            np.testing.assert_array_equal(np.asarray(im), np.asarray(_to_pil(image)))
        heatmap.save_overlay(image, word_map, tmp_path / f'{i}.heat_map.png', device=device)
        assert drawn[-1] is image
    assert len(drawn) == len(cases)
