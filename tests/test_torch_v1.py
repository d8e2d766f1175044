"""SD 1.x and the PNDM, Euler and DPM++ schedulers: daam_tpu_torch against
daam_tpu.

Both pipelines get the same params (through ``from_jax_params``) and the same
initial latents (drawn the way daam_tpu draws them, ``jax.random.normal(key,
shape) * init_noise_sigma``: Euler's is ~14.6), run 3 traced steps with CFG
under the named scheduler, and must give the same images (±2/255) and heat
maps (per token: Spearman ≥ 0.99 and ``_assert_close`` of
``tests/test_e2e_fidelity_torch.py``).  ``tiny`` runs PNDM, Euler and DPM++;
``tiny-v1`` (SD 1.x geometry: 1×1-conv ``proj_in``/``proj_out``, a uniform
head count, the final CLIP layer) runs DDIM and PNDM.  PNDM's 3 steps are 4
UNet evaluations: its ``save_heads`` buffer (fp32 heads, copied to the host
in uneven chunks) must hold 4 evaluations equal to daam_tpu's (atol 1e-4),
its per-step maps (from the buffer and from accumulator snapshots) must
match daam_tpu's, and a load run must replay the saved maps (Spearman ≥
0.999).  The CLI takes ``--model v1`` and every ``--scheduler``.
"""

import importlib
from collections import OrderedDict

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daam_tpu import trace as jax_trace
from daam_tpu.pipeline.sd import StableDiffusionPipeline as JaxPipeline
from daam_tpu_torch import StableDiffusionPipeline, trace
from daam_tpu_torch.models import weights as W
from daam_tpu_torch.models.configs import get_pipeline_config
from daam_tpu_torch.pipeline import schedulers

from test_e2e_fidelity_torch import _assert_close, _spearman
from test_torch_models import jax_params

jax_trace_mod = importlib.import_module('daam_tpu.trace')
trace_mod = importlib.import_module('daam_tpu_torch.trace')

PROMPT = 'A dog runs across the field .'
STEPS = 3
CASES = [('tiny', 'pndm'), ('tiny', 'euler'), ('tiny', 'dpm++'),
         ('tiny-v1', 'ddim'), ('tiny-v1', 'pndm')]


def _pipelines(preset, scheduler, seed=4):
    """daam_tpu's and the port's pipeline on the same params, and the
    port's NCHW latents drawn as daam_tpu draws them."""
    config = get_pipeline_config(preset)
    params = jax_params(config, seed=seed)
    key = jax.random.PRNGKey(7)
    jpipe = JaxPipeline(config, params, scheduler=scheduler)
    pipe = StableDiffusionPipeline(config, **W.load_modules(
        config, W.from_jax_params(params), device='cpu'), scheduler=scheduler)
    s = config.unet.sample_size
    latents = (np.asarray(jax.random.normal(key, (1, s, s, 4))) *
               jpipe.scheduler.init_noise_sigma).transpose(0, 3, 1, 2)
    return jpipe, pipe, key, latents


@pytest.fixture(scope='module', params=CASES, ids=lambda c: '-'.join(c))
def traced(request):
    preset, scheduler = request.param
    jpipe, pipe, key, latents = _pipelines(preset, scheduler)
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
    return dict(pipe=pipe, jimage=jout.images[0], jmap=jmap, jblocks=jblocks,
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
    """finalize_acc's (B, L, H, T, h, w) blocks, summed over every UNet
    evaluation (PNDM's repeated timestep included, as in daam_tpu)."""
    assert sorted(traced['blocks']) == sorted(traced['jblocks'])
    for f, block in traced['blocks'].items():
        assert block.shape == traced['jblocks'][f].shape
        np.testing.assert_allclose(block, traced['jblocks'][f], rtol=1e-4, atol=1e-5)


def test_v1_geometry():
    """tiny-v1 is SD 1.x's topology at test size: 1×1-conv projections and
    one head count at every level, so the head dim doubles with the width
    (v1 itself: 8 heads, hd 40, 80 and 160)."""
    tiny, full = get_pipeline_config('tiny-v1'), get_pipeline_config('v1')
    for cfg in (tiny, full):
        assert not cfg.unet.use_linear_projection
        assert cfg.prediction_type == 'epsilon'
    heads = {info.heads for info in _layout(full)}
    assert heads == {8}
    assert sorted({c // 8 for c in full.unet.block_out_channels}) == [40, 80, 160]


def _layout(config):
    from daam_tpu_torch.models.configs import cross_attention_layout
    return cross_attention_layout(config.unet)


@pytest.fixture(scope='module')
def pndm_replay(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('XDG_CACHE_HOME', str(tmp_path_factory.mktemp('cache')))
        mp.setattr(jax_trace_mod, '_HEAD_CACHE', OrderedDict())
        mp.setattr(trace_mod, '_HEAD_CACHE', OrderedDict())
        return _pndm_replay()


def _np_maps(heat_maps):
    return [np.asarray(h.heat_maps.numpy() if torch.is_tensor(h.heat_maps)
                       else h.heat_maps, dtype=np.float32) for h in heat_maps]


def _pndm_replay():
    jpipe, pipe, key, latents = _pipelines('tiny', 'pndm')
    evals = pipe.scheduler.num_scan_steps(STEPS)
    jpipe.heads_dtype = jnp.float32
    pipe.heads_dtype = torch.float32
    pipe.heads_chunk_steps = 3  # chunks of 3 and 1 evaluations
    r = {'evals': evals}
    with jax_trace(jpipe, save_heads=True, persist_heads=False,
                   data_dir='jax-save') as jtc:
        jpipe(PROMPT, num_inference_steps=STEPS, generator=key, output_type='np')
        r['jbuf'] = {n: np.asarray(a) for n, a in jtc.replay_buffer(evals).items()}
        r['jtime'] = _np_maps(jtc.compute_time_global_heat_maps())
    calls = []
    with trace(pipe, save_heads=True, persist_heads=False, data_dir='save') as tc:
        pipe(PROMPT, num_inference_steps=STEPS, latents=latents, output_type='np',
             callback=lambda i, t, x: calls.append(i), callback_steps=1)
        r['buf'] = tc.replay_buffer(evals)
        r['save_map'] = tc.compute_global_heat_map().heat_maps.numpy()
        r['time'] = _np_maps(tc.compute_time_global_heat_maps())
    r['calls'] = calls
    with trace(pipe, load_heads=True, data_dir='save') as tc:
        pipe(PROMPT, num_inference_steps=STEPS, latents=latents, output_type='np')
        r['load_map'] = tc.compute_global_heat_map().heat_maps.numpy()
    with jax_trace(jpipe, time_chunk_steps=1) as jtc:
        jpipe(PROMPT, num_inference_steps=STEPS, generator=key)
        r['jsnap_time'] = _np_maps(jtc.compute_time_global_heat_maps())
    with trace(pipe, time_chunk_steps=1) as tc:
        pipe(PROMPT, num_inference_steps=STEPS, latents=latents)
        r['snap_time'] = _np_maps(tc.compute_time_global_heat_maps())
    return r


def test_pndm_save_buffer_holds_every_evaluation(pndm_replay):
    """3 PNDM steps are 4 UNet evaluations: the buffer holds 4 per layer,
    each equal to daam_tpu's, though the port copied them to the host in
    chunks of 3 and 1; the callback fired once per evaluation."""
    r = pndm_replay
    assert r['evals'] == STEPS + 1
    assert r['calls'] == list(range(STEPS + 1))
    assert sorted(r['buf']) == sorted(r['jbuf'])
    for name, a in r['buf'].items():
        assert tuple(a.shape) == r['jbuf'][name].shape and a.shape[0] == STEPS + 1
        np.testing.assert_allclose(a.numpy(), r['jbuf'][name], rtol=0, atol=1e-4,
                                   err_msg=name)


def test_pndm_per_step_maps_match_daam_tpu(pndm_replay):
    """One map per UNet evaluation, from the buffer and from accumulator
    snapshots (``time_chunk_steps=1``), each against daam_tpu's from the
    same source."""
    r = pndm_replay
    assert len(r['time']) == len(r['jtime']) == STEPS + 1
    assert len(r['snap_time']) == len(r['jsnap_time']) == STEPS + 1
    for ours, theirs in zip(r['time'], r['jtime']):
        _assert_close(ours, theirs)
    for ours, theirs in zip(r['snap_time'], r['jsnap_time']):
        _assert_close(ours, theirs)


def test_pndm_load_replays_the_saved_maps(pndm_replay):
    save, load = pndm_replay['save_map'], pndm_replay['load_map']
    assert save.shape == load.shape
    for tok in range(save.shape[0]):
        assert _spearman(load[tok], save[tok]) >= 0.999, tok


@pytest.mark.parametrize('scheduler', ['ddim', 'pndm', 'euler', 'dpm++'])
def test_cli_takes_v1_and_every_scheduler(scheduler):
    """--model v1 and --scheduler parse as daam_tpu's flags do; --tiny maps
    v1 to 'tiny', as daam_tpu's --tiny does (an xl model to 'tiny-xl')."""
    from daam_tpu.run.generate import build_parser as jax_parser
    from daam_tpu_torch.run.generate import build_parser, load_pipeline

    argv = ['A dog runs.', '--model', 'v1', '--tiny', '--scheduler', scheduler,
            '--device', 'cpu']
    args = build_parser().parse_args(argv)
    jargs = jax_parser().parse_args(argv[:-2])
    assert (args.model, args.scheduler) == (jargs.model, jargs.scheduler)
    pipe = load_pipeline(args)
    assert pipe.config.name == 'tiny'
    assert type(pipe.scheduler) is schedulers.SCHEDULERS[scheduler]
    assert build_parser().parse_args(['x']).scheduler == jax_parser().parse_args(
        ['x']).scheduler == 'ddim'


def test_cli_v1_pndm_writes_the_quickgen_set(tmp_path):
    from daam_tpu_torch.run.generate import main

    main(['A dog runs.', '--model', 'v1', '--tiny', '--scheduler', 'pndm', '-n', '2',
          '-o', str(tmp_path), '--device', 'cpu'])
    names = {p.name for p in tmp_path.iterdir()}
    assert {'output.png', 'generation.pt', 'prompt.txt', 'seed.txt',
            'dog.heat_map.png', 'runs.heat_map.png', 'a.heat_map.png'} <= names
