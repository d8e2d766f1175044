"""SD 2.1-768's path at test size: the port's ``tiny-v`` pipeline (``tiny``
with v-prediction under DDIM, the 96² heat-map grid, the untiled decode)
against the benchmark's plain reference, ``gpubench.reference``, on the CPU.

The program is built as the benchmark builds it (``runner.build_program``:
the state dicts drawn from the seed by ``gpubench.core.weights``, the
configuration file ``gpubench/tests/fixtures/tiny-v.json`` checked against
the preset) and makes one traced request of two prompts, one generator
each, as the ``cli`` flow calls it.  The reference, plain float32 ``torch``
that imports nothing of the program, follows the program's latents after
each evaluation (teacher forcing) and is compared on: each evaluation's
guided noise prediction (ε derived from v), the decoded image, the global
map and every word map on the 96² grid, and the ``finalize_acc`` blocks
against its own accumulators.  ``tests/test_torch_v_prediction.py`` holds
the same path against ``daam_tpu``; this file imports neither ``jax`` nor
``daam_tpu``.

Tolerances: both sides run float32 on the CPU, the port's kernels on their
plain versions, so they can differ only in the order of float32 operations.
With torch 2.13 on the CPU the noise predictions, the image and the blocks
come out equal bit for bit and the maps within 7e-8 relative (the bicubic
upsampling); another BLAS or build may reorder sums, to ~1e-6.  Each limit
below is 1e-4 relative (1e-5 of the [0, 1] image): room for such an order,
and four orders below what a wrong parameterisation gives, since a DDIM that
reads v as ε misses the guided noise prediction by about its own norm
(``step_err`` 1.19 here)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from daam_tpu_torch import trace
from gpubench.core import runner, weights
from gpubench.reference import pipeline as ref_pipeline
from gpubench.reference.pipeline import Reference, rel

FIXTURE = Path(__file__).resolve().parents[1] / 'gpubench/tests/fixtures/tiny-v.json'
PROMPTS = ['A giraffe and a dog run across the field .', 'a red bus near a red clock']
SEEDS = [2 ** 31 + 1901, 2 ** 31 + 1902]
WEIGHTS_SEED = 2 ** 31 + 1900

#: float32 rounding in a different order of operations, times a hundred
REL = 1e-4
#: the decoded image, float32 in [0, 1]
IMAGE_ATOL = 1e-5


@pytest.fixture(scope='module')
def cfg():
    with open(FIXTURE) as f:
        return json.load(f)


def traced_request(cfg, prompts, seeds, weights_seed):
    """One traced request of ``prompts`` (a generator each) through the
    program built from ``cfg`` as the benchmark builds it, and the
    reference's run that follows its latents, with the reference's
    accumulators under ``acc``."""
    steps, guidance = cfg['run']['steps'], cfg['run']['guidance_scale']
    runner.program_precision(cfg, 'cpu')
    pipe = runner.build_program(cfg, weights_seed, 'cpu')
    latents = []
    with trace(pipe) as tc:
        out = pipe(prompts, num_inference_steps=steps,
                   generator=[torch.Generator().manual_seed(s) for s in seeds],
                   guidance_scale=guidance, output_type='np', callback_steps=1,
                   callback=lambda i, t, x: latents.append(x.clone()))
        maps = [tc.compute_global_heat_map(batch_idx=b) for b in range(len(prompts))]
        blocks = {f: tc.batch_heat_maps[f].clone() for f in tc.batch_heat_maps}
        spec = tc.capture_spec(pipe)
    prog = {'pipe': pipe, 'latents': latents, 'images': np.stack(out.images),
            'maps': maps, 'blocks': blocks, 'spec': spec}

    ref = Reference(cfg, weights.state_dicts(cfg, weights_seed, 'cpu'), 'cpu')
    accs = []

    class Kept(ref_pipeline.Capture):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            accs.append(self.acc)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_pipeline, 'Capture', Kept)
        r = ref.run(prompts, seeds, steps, guidance, forced=latents)
    return prog, ref, dict(r, acc=accs[-1])


@pytest.fixture(scope='module')
def runs(cfg):
    """The program's traced request and the reference's run that follows it."""
    return traced_request(cfg, PROMPTS, SEEDS, WEIGHTS_SEED)


def test_configuration_is_v_prediction_on_the_96_grid(cfg, runs):
    prog, ref, r = runs
    assert prog['pipe'].config.name == cfg['program_preset'] == 'tiny-v'
    assert prog['pipe'].scheduler.prediction_type == 'v_prediction'
    assert cfg['scheduler']['prediction_type'] == 'v_prediction'
    assert prog['pipe'].heat_map_grid == 96
    assert len(prog['latents']) == len(r['latents']) == cfg['run']['steps']


def test_guided_noise_prediction_of_each_evaluation(runs):
    """``step_err``: per evaluation and prompt, ‖x_prog − x_ref‖ over the
    step's noise term, i.e. the relative error of ε derived from v."""
    _, _, r = runs
    err = r['step_err']
    assert tuple(err.shape) == (len(r['latents']), len(PROMPTS))
    assert float(err.max()) <= REL, err


def test_decoded_image(runs):
    """The reference decodes the program's last latents untiled (96 is the
    threshold; only longer edges tile)."""
    prog, _, r = runs
    want = r['images'].numpy()
    assert prog['images'].shape == want.shape
    np.testing.assert_allclose(prog['images'], want, rtol=0, atol=IMAGE_ATOL)


def test_global_map_on_the_96_grid(runs):
    prog, _, r = runs
    for got, want in zip(prog['maps'], r['maps']):
        assert tuple(got.heat_maps.shape[1:]) == (96, 96)
        assert got.heat_maps.shape == want.shape
        assert rel(got.heat_maps, want) <= REL


def test_every_word_map(runs):
    prog, ref, r = runs
    for prompt, got, want in zip(PROMPTS, prog['maps'], r['maps']):
        words = {w for w in prompt.split() if w != '.'}
        for word in words:
            a = got.compute_word_heat_map(word).heatmap
            b = ref.word_map(want, prompt, word)
            assert tuple(a.shape) == (96, 96)
            assert rel(a, b) <= REL, word


def test_finalize_acc_blocks(runs):
    """Each factor's ``(B, L, H, 77, h, w)`` block holds, layer by layer in
    capture order, the reference's accumulator of that layer."""
    prog, ref, r = runs
    located = {i['name']: i for i in ref.located(False)}
    spec = prog['spec']
    assert {f for f, _, _ in spec} == set(prog['blocks'])
    assert sorted(n for _, names, _ in spec for n in names) == sorted(located)
    for factor, names, _ in spec:
        block = prog['blocks'][factor]
        for li, name in enumerate(names):
            info = located[name]
            assert info['factor'] == factor
            e = info['edge']
            want = r['acc'][name].reshape(len(PROMPTS), info['heads'], 77, e, e)
            assert tuple(block[:, li].shape) == tuple(want.shape)
            assert rel(block[:, li], want) <= REL, name
