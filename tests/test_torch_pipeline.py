"""The whole traced slice: daam_tpu_torch against daam_tpu on ``tiny``.

Both pipelines get the same params (through ``from_jax_params``) and the same
initial latents (drawn the way daam_tpu draws them, ``jax.random.normal(key,
shape) * init_noise_sigma``, and injected into the port NCHW), run 3 traced
DDIM steps with CFG, and must give the same images (±2/255) and heat maps
(per token: Spearman ≥ 0.99 and ``_assert_close`` of
``tests/test_e2e_fidelity_torch.py``).  The ``daam-torch`` quickgen CLI must
write the reference's artifact set.
"""

import numpy as np
import pytest
import torch

import jax

from daam_tpu import trace as jax_trace
from daam_tpu.pipeline.sd import StableDiffusionPipeline as JaxPipeline
from daam_tpu_torch import StableDiffusionPipeline, trace
from daam_tpu_torch.models import weights as W
from daam_tpu_torch.models.configs import get_pipeline_config

from test_e2e_fidelity_torch import _assert_close, _spearman
from test_torch_models import jax_params

PROMPT = 'A dog runs across the field .'
STEPS = 3


@pytest.fixture(scope='module')
def runs():
    config = get_pipeline_config('tiny')
    params = jax_params(config, seed=4)
    key = jax.random.PRNGKey(7)

    jpipe = JaxPipeline(config, params)
    with jax_trace(jpipe) as jtc:
        jout = jpipe(PROMPT, num_inference_steps=STEPS, generator=key,
                     output_type='np')
        jmap = np.asarray(jtc.compute_global_heat_map().heat_maps)
        jblocks = {f: np.asarray(b) for f, b in jtc.batch_heat_maps.items()}

    s = config.unet.sample_size
    latents = np.asarray(jax.random.normal(key, (1, s, s, 4))) * \
        jpipe.scheduler.init_noise_sigma
    pipe = StableDiffusionPipeline(config, **W.load_modules(
        config, W.from_jax_params(params), device='cpu'))
    with trace(pipe) as tc:
        out = pipe(PROMPT, num_inference_steps=STEPS,
                   latents=latents.transpose(0, 3, 1, 2), output_type='np')
        heat = tc.compute_global_heat_map()
        word = heat.compute_word_heat_map('dog')
        blocks = {f: b.numpy() for f, b in tc.batch_heat_maps.items()}
    return dict(jimage=jout.images[0], jmap=jmap, jblocks=jblocks,
                image=out.images[0], map=heat.heat_maps.numpy(), word=word,
                blocks=blocks)


def test_images_match(runs):
    assert runs['image'].shape == runs['jimage'].shape == (16, 16, 3)
    assert np.abs(runs['image'] - runs['jimage']).max() <= 2 / 255


def test_finalized_blocks_match(runs):
    """finalize_acc's (B, L, H, T, h, w) blocks, summed over the steps."""
    assert sorted(runs['blocks']) == sorted(runs['jblocks']) == [12]
    for f, block in runs['blocks'].items():
        assert block.shape == runs['jblocks'][f].shape == (1, 3, 2, 77, 8, 8)
        np.testing.assert_allclose(block, runs['jblocks'][f], rtol=1e-4, atol=1e-5)


def test_global_heat_maps_match(runs):
    ours, theirs = runs['map'], runs['jmap']
    assert ours.shape == theirs.shape == (9, 96, 96)  # len(tokens) + 2
    for tok in range(ours.shape[0]):
        assert _spearman(ours[tok], theirs[tok]) >= 0.99, tok
    _assert_close(ours, theirs)


def test_word_heat_map(runs):
    word = runs['word'].heatmap
    assert word.shape == (96, 96)
    assert torch.isfinite(word).all() and (word >= 0).all()
    assert word.max() > word.min()
    expanded = runs['word'].expand_as(runs['image'])
    assert expanded.shape == (16, 16)
    assert expanded.min() >= 0 and expanded.max() <= 1


def test_quickgen_artifact_set(tmp_path):
    from daam_tpu_torch.run.generate import main

    main(['A dog runs.', '--tiny', '-n', '2', '-o', str(tmp_path),
          '--device', 'cpu'])
    names = {p.name for p in tmp_path.iterdir()}
    assert {'output.png', 'generation.pt', 'prompt.txt', 'seed.txt',
            'dog.heat_map.png', 'runs.heat_map.png', 'a.heat_map.png'} <= names
    assert (tmp_path / 'prompt.txt').read_text() == 'A dog runs .'
    assert (tmp_path / 'seed.txt').read_text() == '0'

    # generation.pt is daam_tpu's payload format: daam_tpu reads it back.
    from daam_tpu.experiment import GenerationExperiment
    exp = GenerationExperiment.load(tmp_path)
    assert exp.prompt == 'A dog runs .'
    assert exp.global_heat_map.shape == (6, 96, 96)
    assert np.array(exp.image).shape == (16, 16, 3)


def test_experiment_saves_float_images(runs, tmp_path):
    """output_type='np' images (floats in [0, 1]) save as 8-bit PNGs."""
    import PIL.Image
    from daam_tpu_torch import GenerationExperiment

    exp = GenerationExperiment(runs['image'], runs['map'], PROMPT, seed=7,
                               path=tmp_path)
    exp.save()
    saved = np.asarray(PIL.Image.open(tmp_path / 'output.png'))
    assert saved.dtype == np.uint8 and saved.shape == (16, 16, 3)
    assert np.abs(saved / 255.0 - runs['image']).max() <= 0.5 / 255 + 1e-6


def test_cli_save_then_load_heads(tmp_path, monkeypatch):
    """--save-heads persists the replay buffer; a second run with
    --load-heads replays it and writes the artifact set again."""
    import importlib
    from collections import OrderedDict
    from daam_tpu_torch.run.generate import main

    monkeypatch.setenv('XDG_CACHE_HOME', str(tmp_path / 'cache'))
    monkeypatch.setattr(importlib.import_module('daam_tpu_torch.trace'),
                        '_HEAD_CACHE', OrderedDict())
    for flag in ('--save-heads', '--load-heads'):
        out = tmp_path / flag.strip('-')
        main(['A dog runs.', '--tiny', '-n', '2', '-o', str(out),
              '--device', 'cpu', flag])
        names = {p.name for p in out.iterdir()}
        assert {'output.png', 'generation.pt', 'prompt.txt', 'seed.txt',
                'dog.heat_map.png', 'runs.heat_map.png'} <= names, flag
    assert (tmp_path / 'cache' / 'daam_tpu' / 'heads' / 'default.npz').exists()


def test_cli_time_maps_write_gif(tmp_path):
    import PIL.Image
    from daam_tpu_torch.run.generate import main

    main(['A dog runs', '--tiny', '-n', '2', '-o', str(tmp_path),
          '--device', 'cpu', '--time-maps'])
    for step in (0, 1):
        assert (tmp_path / f'time{step:03d}-dog.heat_map.png').exists()
    with PIL.Image.open(tmp_path / 'dog.time.gif') as im:
        assert getattr(im, 'n_frames', 1) == 2


def test_cli_load_heads_without_saved_heads_raises(tmp_path, monkeypatch):
    import importlib
    from collections import OrderedDict
    from daam_tpu_torch.run.generate import main

    monkeypatch.setenv('XDG_CACHE_HOME', str(tmp_path))
    monkeypatch.setattr(importlib.import_module('daam_tpu_torch.trace'),
                        '_HEAD_CACHE', OrderedDict())
    with pytest.raises(RuntimeError, match='No saved attention heads'):
        main(['A dog runs', '--tiny', '-n', '2', '-o', str(tmp_path),
              '--device', 'cpu', '--load-heads'])


def test_cli_without_gpu_does_not_fall_back_to_cpu(tmp_path, monkeypatch):
    from daam_tpu_torch.run.generate import main

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        main(['A dog runs', '--tiny', '-n', '1', '-o', str(tmp_path)])
    assert not any(tmp_path.iterdir())
