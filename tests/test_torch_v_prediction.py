"""SD 2.x's v-prediction (``v2-large``, ``v2-1-large``): daam_tpu_torch
against daam_tpu.

``tiny`` with ``prediction_type='v_prediction'`` (both packages' presets
through ``dataclasses.replace``) gets the same params (through
``from_jax_params``) and the same initial latents (drawn as daam_tpu draws
them) in both packages, runs 3 traced steps with CFG under DDIM, PNDM,
Euler and DPM++, and must give the same images (±2/255), heat maps (per
token: Spearman ≥ 0.99 and ``_assert_close``) and ``finalize_acc`` blocks.
A DDIM save → load pair must replay the saved maps (Spearman ≥ 0.999); a
checkpoint directory whose ``scheduler_config.json`` says
``v_prediction`` must load as a v-prediction pipeline, as daam_tpu's
loader loads it; and ``v2-1-large``'s geometry (96² latents, 768² images,
the 96² heat-map grid, the untiled decode) is checked without weights.
"""

import dataclasses
import importlib
import json
from collections import OrderedDict

import numpy as np
import pytest
import torch

import jax

from daam_tpu import trace as jax_trace
from daam_tpu.models import weights as JW
from daam_tpu.models.configs import get_pipeline_config as jax_config
from daam_tpu.pipeline.sd import StableDiffusionPipeline as JaxPipeline
from daam_tpu_torch import StableDiffusionPipeline, trace
from daam_tpu_torch.models import weights as W
from daam_tpu_torch.models.configs import get_pipeline_config

from test_checkpoint_dir import write_diffusers_dir
from test_e2e_fidelity_torch import _assert_close, _spearman
from test_torch_checkpoint import _json_dir, _slice
from test_torch_models import jax_params

trace_mod = importlib.import_module('daam_tpu_torch.trace')

PROMPT = 'A dog runs across the field .'
STEPS = 3
SCHEDULERS = ['ddim', 'pndm', 'euler', 'dpm++']


def _v(config):
    return dataclasses.replace(config, prediction_type='v_prediction')


@pytest.fixture(scope='module')
def params():
    return jax_params(_v(jax_config('tiny')), seed=4)


def _pipelines(params, scheduler):
    """daam_tpu's and the port's v-prediction pipeline on the same params,
    and the port's NCHW latents drawn as daam_tpu draws them."""
    config, jconfig = _v(get_pipeline_config('tiny')), _v(jax_config('tiny'))
    key = jax.random.PRNGKey(7)
    jpipe = JaxPipeline(jconfig, params, scheduler=scheduler)
    pipe = StableDiffusionPipeline(config, **W.load_modules(
        config, W.from_jax_params(params), device='cpu'), scheduler=scheduler)
    assert jpipe.scheduler.prediction_type == pipe.scheduler.prediction_type \
        == 'v_prediction'
    s = config.unet.sample_size
    latents = (np.asarray(jax.random.normal(key, (1, s, s, 4))) *
               jpipe.scheduler.init_noise_sigma).transpose(0, 3, 1, 2)
    return jpipe, pipe, key, latents


@pytest.fixture(scope='module', params=SCHEDULERS)
def traced(request, params):
    jpipe, pipe, key, latents = _pipelines(params, request.param)
    with jax_trace(jpipe) as jtc:
        jout = jpipe(PROMPT, num_inference_steps=STEPS, generator=key,
                     output_type='np')
        jmap = np.asarray(jtc.compute_global_heat_map().heat_maps)
        jblocks = {f: np.asarray(b) for f, b in jtc.batch_heat_maps.items()}
    with trace(pipe) as tc:
        out = pipe(PROMPT, num_inference_steps=STEPS, latents=latents,
                   output_type='np')
        heat = tc.compute_global_heat_map()
        blocks = {f: b.numpy() for f, b in tc.batch_heat_maps.items()}
    return dict(jimage=jout.images[0], jmap=jmap, jblocks=jblocks,
                image=out.images[0], map=heat.heat_maps.numpy(), blocks=blocks)


def test_traced_images_match(traced):
    assert traced['image'].shape == traced['jimage'].shape == (16, 16, 3)
    assert np.isfinite(traced['image']).all()
    assert np.abs(traced['image'] - traced['jimage']).max() <= 2 / 255


def test_traced_heat_maps_match(traced):
    ours, theirs = traced['map'], traced['jmap']
    assert ours.shape == theirs.shape == (9, 96, 96)  # len(tokens) + 2
    for tok in range(ours.shape[0]):
        assert _spearman(ours[tok], theirs[tok]) >= 0.99, tok
    _assert_close(ours, theirs)


def test_finalized_blocks_match(traced):
    assert sorted(traced['blocks']) == sorted(traced['jblocks'])
    for f, block in traced['blocks'].items():
        assert block.shape == traced['jblocks'][f].shape
        np.testing.assert_allclose(block, traced['jblocks'][f], rtol=1e-4, atol=1e-5)


def test_ddim_save_load_replays_the_saved_maps(params, monkeypatch):
    monkeypatch.setattr(trace_mod, '_HEAD_CACHE', OrderedDict())
    _, pipe, _, latents = _pipelines(params, 'ddim')
    with trace(pipe, save_heads=True, persist_heads=False, data_dir='v-save') as tc:
        pipe(PROMPT, num_inference_steps=STEPS, latents=latents, output_type='np')
        saved = tc.compute_global_heat_map().heat_maps.numpy()
    with trace(pipe, load_heads=True, data_dir='v-save') as tc:
        pipe(PROMPT, num_inference_steps=STEPS, latents=latents, output_type='np')
        loaded = tc.compute_global_heat_map().heat_maps.numpy()
    assert saved.shape == loaded.shape == (9, 96, 96)
    for tok in range(saved.shape[0]):
        assert _spearman(loaded[tok], saved[tok]) >= 0.999, tok


def test_from_path_selects_v_prediction(tmp_path):
    """A directory whose ``scheduler_config.json`` says v_prediction loads
    as a v-prediction pipeline in both packages, and their traced slices
    agree; the same geometry saying epsilon is the ``tiny`` preset."""
    root = write_diffusers_dir(tmp_path / 'tiny-v', _v(jax_config('tiny')))
    assert json.loads((root / 'scheduler' / 'scheduler_config.json').read_text()) \
        == {'prediction_type': 'v_prediction'}
    jpipe = JaxPipeline.from_pretrained(str(root))
    pipe = StableDiffusionPipeline.from_pretrained(str(root), device='cpu')
    assert pipe.config.name == jpipe.config.name == 'tiny-v'
    assert pipe.config.prediction_type == jpipe.config.prediction_type == 'v_prediction'
    assert pipe.scheduler.prediction_type == jpipe.scheduler.prediction_type \
        == 'v_prediction'
    jimage, jmap, image, heat = _slice(jpipe, pipe, seed=7)
    assert np.abs(image - jimage).max() <= 2 / 255
    _assert_close(heat, jmap)

    eps = _json_dir(tmp_path / 'eps', jax_config('tiny'))
    assert W._config_from_json(eps) is get_pipeline_config('tiny')
    assert W._config_from_json(eps).name == JW._config_from_json(eps).name


@pytest.mark.parametrize('prediction', ['v_prediction', 'epsilon'])
def test_v2_1_large_directory(prediction, tmp_path):
    """v2-1-large's json configs resolve to its preset only when the
    scheduler says v_prediction, in both packages; with epsilon the
    geometry is an off-preset config carrying epsilon."""
    pcfg = dataclasses.replace(jax_config('v2-1-large'), prediction_type=prediction)
    root = _json_dir(tmp_path / 'sd21-768', pcfg)
    ours, theirs = W._config_from_json(root), JW._config_from_json(root)
    assert ours.name == theirs.name
    assert ours.prediction_type == theirs.prediction_type == prediction
    if prediction == 'v_prediction':
        assert ours is get_pipeline_config('v2-1-large')
    else:
        assert ours.name == 'sd21-768'


def test_v2_1_large_geometry():
    """768² images from 96² latents: K2 at 9216 queries, a 96² heat-map
    grid, and a decode that stays untiled (96 is the tiling threshold, and
    only edges above it tile), without any weights."""
    from daam_tpu_torch.models.configs import cross_attention_layout

    for name in ('v2-large', 'v2-1-large'):
        cfg = get_pipeline_config(name)
        assert cfg.prediction_type == jax_config(name).prediction_type == 'v_prediction'
        assert cfg.unet.sample_size == 96 and cfg.image_size == 768
        assert cfg.vae.scale_factor == 8
        layout = cross_attention_layout(cfg.unet)
        grids = sorted({(96 // info.downscale) ** 2 for info in layout})
        assert grids == [144, 576, 2304, 9216]
        assert {info.heads * 64 for info in layout} == set(cfg.unet.block_out_channels)

    cfg = get_pipeline_config('v2-1-large')
    modules = W.build_modules(cfg, device='meta')
    pipe = StableDiffusionPipeline(cfg, **modules)
    tc = trace(pipe)
    assert tc.latent_hw == 9216  # the 96² grid of 768-px models
    assert {f for f, _, _ in tc.capture_spec(pipe)} == {1, 2, 4}
    decoded = []
    pipe.vae.decode = lambda z: decoded.append(tuple(z.shape)) or torch.zeros(
        z.shape[0], 3, 768, 768)

    def tiled(*args):
        raise AssertionError('a 96² latent must decode untiled')
    pipe._tiled_decode = tiled
    images = pipe._decode(torch.zeros(1, 4, 96, 96))
    assert decoded == [(1, 4, 96, 96)] and tuple(images.shape) == (1, 768, 768, 3)
