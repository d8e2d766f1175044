"""SD 1.5's path at test size: the port's ``tiny-v1`` pipeline (CLIP-L's
``quick_gelu``, 1×1-convolution ``proj_in``/``proj_out``, one head count at
every level) under PNDM with ``skip_prk_steps`` against the benchmark's
plain reference, ``gpubench.reference``, on the CPU.

The program is built as the benchmark builds it (``runner.build_program``:
the state dicts drawn from the seed by ``gpubench.core.weights``, the
configuration file ``gpubench/tests/fixtures/tiny-v1-pndm.json`` checked
against the preset, the scheduler from the file's ``scheduler`` group) and
makes one traced request of two prompts, one generator each, as the ``cli``
flow calls it.  The reference, plain float32 ``torch`` that imports nothing
of the program, follows the program's latents after each of PNDM's
``steps`` + 1 evaluations (teacher forcing; its history holds its own
outputs at those latents) and is compared on: each evaluation's guided
noise prediction, combined over the history as PNDM combines it, the
decoded image, the global map and every word map, and the ``finalize_acc``
blocks against its own accumulators.  This file imports neither ``jax``
nor ``daam_tpu``.

Tolerances: both sides run float32 on the CPU, the port's kernels on their
plain versions, so they can differ only in the order of float32 operations.
With torch 2.13 on the CPU the noise predictions, the image and the blocks
come out equal bit for bit and the maps within 6e-8 relative (the bicubic
upsampling); another BLAS or build may reorder sums, to ~1e-6, and PNDM's
fourth-order combination (55, −59, 37, −9 over 24) can scale an error of
the noise prediction by up to ~3.7 where the errors of successive
evaluations do not correlate.  Each limit below is 1e-4 relative (1e-5 of
the [0, 1] image): room for both, and three orders below what a reference
that drops PNDM's history gives (``step_err`` 0.21-0.29 from the third
evaluation on here; the test asks for ten times the limit)."""

import json
from pathlib import Path

import numpy as np
import pytest

from gpubench.reference import schedulers as ref_schedulers
from gpubench.reference.pipeline import rel
from test_torch_v_prediction_reference import traced_request

FIXTURE = Path(__file__).resolve().parents[1] / 'gpubench/tests/fixtures/tiny-v1-pndm.json'
PROMPTS = ['A giraffe and a dog run across the field .', 'a red bus near a red clock']
SEEDS = [2 ** 31 + 2301, 2 ** 31 + 2302]
WEIGHTS_SEED = 2 ** 31 + 2300

#: float32 rounding in a different order of operations, times a hundred
REL = 1e-4
#: the decoded image, float32 in [0, 1]
IMAGE_ATOL = 1e-5


class NoHistory(ref_schedulers.PNDM):
    """PNDM's timesteps and transfers with the current output alone: each
    evaluation a DDIM step (eq. 11 with ε of this output is DDIM's η = 0
    step), the linear multistep's history dropped."""

    def step(self, i, out, x):
        t, prev_t = self.ts[i], self.ts[i] - self.ratio
        if i == 0:
            self.cur_sample = x
        elif i == 1:  # the same restart from the first latents
            prev_t, t, x = t, t + self.ratio, self.cur_sample
        return self.transfer(x, t, prev_t, out)


@pytest.fixture(scope='module')
def cfg():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.fixture(scope='module')
def runs(cfg):
    """The program's traced request and the reference's run that follows it."""
    return traced_request(cfg, PROMPTS, SEEDS, WEIGHTS_SEED)


def test_configuration_is_sd15_under_pndm(cfg, runs):
    prog, ref, r = runs
    pipe = prog['pipe']
    assert pipe.config.name == cfg['program_preset'] == 'tiny-v1'
    assert type(pipe.scheduler).__name__ == 'PNDMScheduler'
    assert cfg['scheduler']['name'] == 'pndm' and cfg['scheduler']['skip_prk_steps'] is True
    assert pipe.config.text.hidden_act == cfg['text_encoder']['hidden_act'] == 'quick_gelu'
    assert pipe.config.unet.use_linear_projection is False
    steps = cfg['run']['steps']
    assert pipe.scheduler.num_scan_steps(steps) == steps + 1
    assert len(prog['latents']) == len(r['latents']) == steps + 1


def test_guided_noise_prediction_of_each_evaluation(cfg, runs):
    """``step_err``: per evaluation (all steps + 1) and prompt, ‖x_prog −
    x_ref‖ over the step's noise term, i.e. the relative error of the
    guided noise prediction as PNDM combines it with the history."""
    _, _, r = runs
    err = r['step_err']
    assert tuple(err.shape) == (cfg['run']['steps'] + 1, len(PROMPTS))
    assert float(err.max()) <= REL, err


def test_reference_without_pndm_history_fails_step_err(cfg, runs):
    """A reference that drops PNDM's history (each evaluation a DDIM step on
    the same timesteps) misses the program's latents by ten times the limit
    or more, so ``step_err`` sees the history."""
    prog, ref, _ = runs
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ref_schedulers.SAMPLERS, 'pndm', NoHistory)
        r = ref.run(PROMPTS, SEEDS, cfg['run']['steps'], cfg['run']['guidance_scale'],
                    forced=prog['latents'])
    assert float(r['step_err'].max()) >= 10 * REL, r['step_err']


def test_decoded_image(runs):
    prog, _, r = runs
    want = r['images'].numpy()
    assert prog['images'].shape == want.shape
    np.testing.assert_allclose(prog['images'], want, rtol=0, atol=IMAGE_ATOL)


def test_global_map(runs):
    prog, _, r = runs
    for got, want in zip(prog['maps'], r['maps']):
        assert got.heat_maps.shape == want.shape
        assert rel(got.heat_maps, want) <= REL


def test_every_word_map(runs):
    prog, ref, r = runs
    for prompt, got, want in zip(PROMPTS, prog['maps'], r['maps']):
        words = {w for w in prompt.split() if w != '.'}
        for word in words:
            a = got.compute_word_heat_map(word).heatmap
            b = ref.word_map(want, prompt, word)
            assert a.shape == b.shape
            assert rel(a, b) <= REL, word


def test_finalize_acc_blocks(runs):
    """Each factor's ``(B, L, H, 77, h, w)`` block holds, layer by layer in
    capture order, the reference's accumulator of that layer over all
    steps + 1 evaluations."""
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
