"""Batched generation: daam_tpu_torch against daam_tpu at batch 2.

Both packages get the same params (``daam_tpu``'s random init through
``from_jax_params``) and two different prompts.  ``daam_tpu`` draws each
prompt's noise from its own key of a stack (``jax.vmap`` over
``jax.random.normal(k, shape[1:])``, ``daam_tpu/pipeline/sd.py:251-255``);
the same numbers go into the port as ``latents=``.  On ``tiny`` and
``tiny-xl``, 2 traced DDIM steps in fp32:

* each sample's image within ±2/255;
* each sample's global heat maps (``compute_global_heat_map(batch_idx=i)``)
  at per-token Spearman ≥ 0.99 and ``_assert_close`` of
  ``tests/test_e2e_fidelity_torch.py``, and its words found in its own
  prompt;
* an fp32 ``save_heads`` → ``load_heads`` pair at batch 2: the buffers
  within 1e-4, and per ``batch_idx`` the replayed run's image and maps, and
  the per-step maps from the buffer, as above;
* ``parsed_heat_maps`` and ``dependency_relations`` of each sample: the
  same words, relations and heads as ``daam_tpu``'s, the maps as above.

And the port's own batch surface: one generator per prompt (a prompt's
image is its batch-1 image), the safety-checker slot, ``callback_steps``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from daam_tpu import trace as jax_trace
from daam_tpu.heatmap import GlobalHeatMap as JaxGlobalHeatMap
from daam_tpu.pipeline.sd import _pipeline_class as jax_pipeline_class
from daam_tpu.tokenization import default_tokenizer as jax_tokenizer
from daam_tpu_torch import StableDiffusionPipeline, trace
from daam_tpu_torch.heatmap import GlobalHeatMap
from daam_tpu_torch.models import weights as W
from daam_tpu_torch.models.configs import get_pipeline_config
from daam_tpu_torch.pipeline.sd import _pipeline_class
from daam_tpu_torch.utils import randn_tensor

from test_e2e_fidelity_torch import _assert_close, _spearman
from test_torch_models import jax_params

PROMPTS = ['A dog runs across the field .', 'A brown cat sits on the red sofa .']
WORDS = ['dog', 'cat']  # a word of each prompt and of no other
SEEDS = [3, 11]
STEPS = 2
IMAGE_TOL = 2 / 255


def _np(maps):
    return [np.asarray(m.heat_maps) for m in maps]


def _per_sample(tc, fn='compute_global_heat_map'):
    return [getattr(tc, fn)(batch_idx=i) for i in range(len(PROMPTS))]


@pytest.fixture(scope='module', params=['tiny', 'tiny-xl'])
def runs(request):
    config = get_pipeline_config(request.param)
    params = jax_params(config, seed=4)
    jpipe = jax_pipeline_class(config)(config, params)
    pipe = _pipeline_class(config)(config, **W.load_modules(
        config, W.from_jax_params(params), device='cpu'))
    keys = jnp.stack([jax.random.PRNGKey(s) for s in SEEDS])
    side = config.image_size // config.vae.scale_factor
    latents = np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (side, side, 4), dtype=jnp.float32))(keys))
    latents = (latents * jpipe.scheduler.init_noise_sigma).transpose(0, 3, 1, 2)
    r = {'preset': request.param}

    with jax_trace(jpipe) as jtc:
        out = jpipe(PROMPTS, num_inference_steps=STEPS, generator=keys,
                    output_type='np')
        r['jimages'] = [np.asarray(im) for im in out.images]
        r['jmaps'] = _np(_per_sample(jtc))
    with trace(pipe) as tc:
        out = pipe(PROMPTS, num_inference_steps=STEPS, latents=latents,
                   output_type='np')
        r['images'] = out.images
        r['heat'] = _per_sample(tc)
        r['maps'] = _np(r['heat'])

    # an fp32 save -> load pair of the same prompts, both packages
    jpipe.heads_dtype, pipe.heads_dtype = jnp.float32, torch.float32
    evals = pipe.scheduler.num_scan_steps(STEPS)
    with jax_trace(jpipe, save_heads=True, persist_heads=False,
                   data_dir='batch-save') as jtc:
        jpipe(PROMPTS, num_inference_steps=STEPS, generator=keys, output_type='np')
        r['jbuf'] = {n: np.asarray(a) for n, a in jtc.replay_buffer(evals).items()}
        r['jtime'] = [_np(m) for m in _per_sample(jtc, 'compute_time_global_heat_maps')]
    with trace(pipe, save_heads=True, persist_heads=False,
               data_dir='batch-save') as tc:
        pipe(PROMPTS, num_inference_steps=STEPS, latents=latents, output_type='np')
        r['buf'] = {n: a.numpy() for n, a in tc.replay_buffer(evals).items()}
        r['time'] = [_np(m) for m in _per_sample(tc, 'compute_time_global_heat_maps')]
    with jax_trace(jpipe, load_heads=True, data_dir='batch-save') as jtc:
        out = jpipe(PROMPTS, num_inference_steps=STEPS, generator=keys,
                    output_type='np')
        r['jload_images'] = [np.asarray(im) for im in out.images]
        r['jload_maps'] = _np(_per_sample(jtc))
    with trace(pipe, load_heads=True, data_dir='batch-save') as tc:
        out = pipe(PROMPTS, num_inference_steps=STEPS, latents=latents,
                   output_type='np')
        r['load_images'] = out.images
        r['load_maps'] = _np(_per_sample(tc))
    return r


def _maps_close(ours, theirs):
    assert ours.shape == theirs.shape
    for tok in range(ours.shape[0]):
        assert _spearman(ours[tok], theirs[tok]) >= 0.99, tok
    _assert_close(ours, theirs)


def test_batched_images_match_daam_tpu(runs):
    assert len(runs['images']) == len(runs['jimages']) == 2
    for ours, theirs in zip(runs['images'], runs['jimages']):
        assert ours.shape == theirs.shape
        assert np.abs(ours - theirs).max() <= IMAGE_TOL
    # two prompts, two seeds: two different images
    assert np.abs(runs['images'][0] - runs['images'][1]).max() > 0.05


def test_batched_maps_match_daam_tpu(runs):
    for ours, theirs in zip(runs['maps'], runs['jmaps']):
        _maps_close(ours, theirs)


def test_each_sample_maps_its_own_prompt(runs):
    """batch_idx i reads prompt i: its word is found, the other's is not,
    and the maps truncate to its own token count."""
    tok = jax_tokenizer()
    for i, heat in enumerate(runs['heat']):
        assert heat.prompt == PROMPTS[i]
        assert runs['maps'][i].shape[0] == len(tok.tokenize(PROMPTS[i])) + 2
        assert heat.compute_word_heat_map(WORDS[i]).heatmap.shape == (96, 96)
        with pytest.raises(ValueError):
            heat.compute_word_heat_map(WORDS[1 - i])


def test_batched_replay_buffers_match_daam_tpu(runs):
    """(evaluations, 2B, H, h·w, 77) per layer, fp32, every CFG row."""
    assert sorted(runs['buf']) == sorted(runs['jbuf'])
    for name, a in runs['buf'].items():
        assert a.shape == runs['jbuf'][name].shape and a.shape[1] == 4
        np.testing.assert_allclose(a, runs['jbuf'][name], rtol=0, atol=1e-4,
                                   err_msg=name)


def test_replayed_maps_per_batch_idx_match_daam_tpu(runs):
    for ours, theirs in zip(runs['load_images'], runs['jload_images']):
        assert np.abs(ours - theirs).max() <= IMAGE_TOL
    for ours, theirs in zip(runs['load_maps'], runs['jload_maps']):
        _maps_close(ours, theirs)


def test_per_step_maps_per_batch_idx_match_daam_tpu(runs):
    for ours, theirs in zip(runs['time'], runs['jtime']):
        assert len(ours) == len(theirs) == STEPS
        for a, b in zip(ours, theirs):
            _maps_close(a, b)


def test_parsed_heat_maps_match_daam_tpu(runs):
    """The same parsed words in both packages, and their maps as above."""
    for i, prompt in enumerate(PROMPTS):
        ours = list(GlobalHeatMap(runs['heat'][i].tokenizer, prompt,
                                  torch.from_numpy(runs['maps'][i])).parsed_heat_maps())
        theirs = list(JaxGlobalHeatMap(jax_tokenizer(), prompt,
                                       runs['jmaps'][i]).parsed_heat_maps())
        assert [p.token.text for p in ours] == [p.token.text for p in theirs]
        assert [p.token.pos_ for p in ours] == [p.token.pos_ for p in theirs]
        assert WORDS[i] in [p.token.text for p in ours]
        _maps_close(np.stack([p.word_heat_map.heatmap.numpy() for p in ours]),
                    np.stack([np.asarray(p.word_heat_map.heatmap) for p in theirs]))


def test_dependency_relations_match_daam_tpu(runs):
    for i, prompt in enumerate(PROMPTS):
        ours = list(GlobalHeatMap(runs['heat'][i].tokenizer, prompt,
                                  torch.from_numpy(runs['maps'][i])
                                  ).dependency_relations())
        theirs = list(JaxGlobalHeatMap(jax_tokenizer(), prompt, runs['jmaps'][i]
                                       ).dependency_relations())
        assert ours, prompt
        assert [(p.head_text, p.dep_text, p.relation) for p in ours] == \
            [(p.head_text, p.dep_text, p.relation) for p in theirs]
        for side in ('head_heat_map', 'dep_heat_map'):
            _maps_close(
                np.stack([getattr(p, side).heatmap.numpy() for p in ours]),
                np.stack([np.asarray(getattr(p, side).heatmap) for p in theirs]))


# ---------------------------------------------------------------------------
# the port's batch surface
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def tiny():
    return StableDiffusionPipeline.from_pretrained('tiny', device='cpu')


def _gens(seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]


def test_randn_tensor_draws_one_sample_per_generator():
    """A list of generators draws each sample as a batch-1 draw would;
    one generator draws the whole batch at once."""
    shape = (2, 4, 8, 8)
    per_sample = randn_tensor(shape, _gens(SEEDS), 'cpu')
    for i, s in enumerate(SEEDS):
        torch.testing.assert_close(per_sample[i:i + 1], torch.randn(
            1, 4, 8, 8, generator=torch.Generator().manual_seed(s)), rtol=0, atol=0)
    whole = randn_tensor(shape, torch.Generator().manual_seed(3), 'cpu')
    torch.testing.assert_close(whole, torch.randn(
        shape, generator=torch.Generator().manual_seed(3)), rtol=0, atol=0)
    with pytest.raises(ValueError, match='one per sample'):
        randn_tensor(shape, _gens([1, 2, 3]), 'cpu')


def test_prompt_image_does_not_depend_on_its_batch(tiny):
    """Each prompt's image at batch 2 against its batch-1 image from the
    same seed.  The noise is the same to the bit; the float images agree
    within 1e-5 (torch's CPU convolutions may sum a batch of 2 in another
    order than a batch of 1), so their 8-bit PNGs are equal."""
    batched = tiny(PROMPTS, num_inference_steps=STEPS, generator=_gens(SEEDS),
                   output_type='np').images
    for i, (prompt, seed) in enumerate(zip(PROMPTS, SEEDS)):
        alone = tiny(prompt, num_inference_steps=STEPS, generator=_gens([seed]),
                     output_type='np').images[0]
        assert np.abs(batched[i] - alone).max() <= 1e-5
        np.testing.assert_array_equal(tiny.numpy_to_pil(batched[i][None])[0],
                                      tiny.numpy_to_pil(alone[None])[0])


def test_safety_checker_slot_blacks_out_and_flags(tiny):
    """The checker sees uint8 images and the prompts, flagged images come
    back black, and the trace records the checked images
    (``tests/test_pipeline_options.py``'s case, at batch 2)."""
    calls = {}

    def checker(images_u8, prompts):
        calls['dtypes'] = {im.dtype for im in images_u8}
        calls['prompts'] = prompts
        return [False, True]

    tiny.safety_checker = checker
    try:
        with trace(tiny) as tc:
            out = tiny(PROMPTS, num_inference_steps=1, generator=_gens(SEEDS))
            exps = [tc.to_experiment('.', seed=0, batch_idx=i) for i in range(2)]
    finally:
        tiny.safety_checker = None
    assert out.nsfw_content_detected == [False, True]
    assert calls == {'dtypes': {np.dtype(np.uint8)}, 'prompts': PROMPTS}
    assert np.asarray(out.images[0]).sum() > 0
    assert np.asarray(out.images[1]).sum() == 0
    assert [e.nsfw() for e in exps] == [False, True]
    assert tiny('a dog', num_inference_steps=1).nsfw_content_detected is None


def test_callback_steps_live_per_step_callback(tiny):
    """With ``callback_steps`` the callback runs live after every step with
    the step's latents."""
    seen = []

    def cb(i, t, latents):
        assert latents is not None and tuple(latents.shape) == (2, 4, 8, 8)
        seen.append(i)

    tiny(PROMPTS, num_inference_steps=5, callback=cb, callback_steps=2)
    assert seen == [0, 1, 2, 3, 4]


def test_callback_without_steps_still_counts(tiny):
    """Without ``callback_steps`` it runs once per step after sampling,
    ``callback(i, None, None)``, as ``daam_tpu``'s counter-style call."""
    seen = []
    with trace(tiny) as tc:
        tiny('a dog', num_inference_steps=3, callback=tc.time_callback)
        tiny('a dog', num_inference_steps=3,
             callback=lambda i, t, x: seen.append((i, t, x)))
    assert tc.time_idx == 3
    assert seen == [(0, None, None), (1, None, None), (2, None, None)]
