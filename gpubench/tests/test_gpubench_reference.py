"""The plain reference against the program on the CPU at the test sizes:
module by module on one set of state dicts, and whole runs of every cell's
flow through the harness (the program's kernels run their plain versions
on the CPU), and of every sampler the reference follows; a configuration
that the program or the reference does not run as stated stops at set-up."""

import json

import pytest
import torch

from gpubench.core import readings, spec, weights
from gpubench.reference.models import Capture
from gpubench.reference.pipeline import Reference
from gpubench.reference.tokenizer import Tokenizer
from gpubench.tests.drive import FIXTURES, fixture, program_preset, run_cell

#: Configurations (at their test sizes) that no cell runs yet, one for each
#: sampler and parameterisation the reference follows beyond epsilon DDIM.
SAMPLER_CONFIGS = ['sd21-768-fp32', 'sd15-512-fp32']


def cfg_of(name):
    return json.loads((FIXTURES / f'{name}.json').read_text())


@pytest.mark.parametrize('name', ['tiny', 'tiny-xl'])
def test_modules_match_the_program(name):
    from daam_tpu_torch.models.configs import get_pipeline_config
    from daam_tpu_torch.models.weights import load_modules

    cfg = cfg_of(name)
    sds = weights.state_dicts(cfg, 5, 'cpu')
    prog = load_modules(get_pipeline_config(name), sds, device='cpu')
    ref = Reference(cfg, sds, 'cpu')
    ids = torch.tensor(ref.tok.batch_ids(['', 'a red dog runs.']))
    for n in [m for m in cfg['modules'] if m.startswith('text_encoder')]:
        a, pa = prog[n](ids, penultimate=True)
        b, pb = ref.modules[n](ids, penultimate=True)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(pa, pb, rtol=1e-5, atol=1e-5)
    context, added = ref.encode(['a red dog runs.'])
    lat = torch.randn(2, 4, 8, 8, generator=torch.Generator().manual_seed(0))
    acc_p = {i['name']: torch.zeros(1, i['heads'], 77, i['edge'] ** 2)
             for i in ref.located(False)}
    acc_r = {k: v.clone() for k, v in acc_p.items()}
    eps_p = prog['unet'](lat, torch.tensor(500).expand(2), context, added_cond=added,
                         capture='acc', acc=acc_p)
    eps_r = ref.modules['unet'](lat, torch.tensor(500), context, added, Capture(acc=acc_r))
    torch.testing.assert_close(eps_p, eps_r, rtol=1e-5, atol=1e-5)
    for k in acc_p:
        torch.testing.assert_close(acc_p[k], acc_r[k], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(prog['vae'].decode(lat), ref.modules['vae'](lat),
                               rtol=1e-5, atol=1e-5)


def test_tokenizer_matches_the_program():
    from daam_tpu_torch.tokenization import ClipBpeTokenizer, BUNDLED_VOCAB_DIR
    from daam_tpu_torch.utils import compute_token_merge_indices

    prog = ClipBpeTokenizer.from_pretrained(BUNDLED_VOCAB_DIR, pad_id=0)
    ref = Tokenizer(pad_id=0)
    for p in ['A red hot dog leans next to a teddy bear .', "It's a tennis racket, isn't it?",
              'A fluffy giraffe rests on the street quietly.']:
        assert ref.ids(p) == prog(p)['input_ids']
        for w in p.split():
            try:
                want = compute_token_merge_indices(prog, p, w)[0]
            except ValueError:
                with pytest.raises(ValueError):
                    ref.merge_indices(p, w)
                continue
            assert ref.merge_indices(p, w) == want


def _sound(line):
    assert line['correct'], line['checks']
    assert line['attempted'] >= 1 and line['failed'] == 0
    assert list(line)[-1] == 'checks'
    for name, c in line['checks'].items():
        assert c['value'] <= min(c['limit'], 1e-3) or name == 'png_missing', (name, c)


@pytest.mark.parametrize('workload', [w['name'] for w in spec.benchmark()['workloads']])
def test_sound_run_is_correct(workload):
    _sound(run_cell(workload))


@pytest.mark.parametrize('config', SAMPLER_CONFIGS)
def test_sound_run_is_correct_under_each_sampler(config):
    """v-prediction DDIM and PNDM (one more UNet evaluation than steps),
    through the ``cli`` flow, over a window of one request: at the test
    size one channel of a 16² overlay a level off reads 1/768 ≈ 0.0013 in
    ``overlay_err``, above 1e-3, and the request that the sample holds
    from a longer window depends on the CPU's speed."""
    cfg = fixture(config)
    assert (cfg['scheduler']['name'], cfg['scheduler']['prediction_type']) in (
        ('ddim', 'v_prediction'), ('pndm', 'epsilon'))
    _sound(run_cell('sd21-512-fp32.cli-b1', seconds=1e-3, config=cfg))


def test_v_prediction_held_against_epsilon_fails():
    """A sound v-prediction program, held against a reference told that the
    UNet predicts ε, fails ``step_err``."""
    cell = spec.cell('sd21-512-fp32.cli-b1', spec.benchmark())
    cfg = fixture('sd21-768-fp32')
    told = dict(cfg, scheduler=dict(cfg['scheduler'], prediction_type='epsilon'))
    with program_preset(cfg):
        sound = readings.program_reading(cell, cfg, 7, 'cpu')
        wrong = readings.program_reading(cell, cfg, 7, 'cpu', ref_cfg=told)
    limit = cell['limits']['limits']['step_err']
    assert sound['step_err'] <= min(limit, 1e-3)
    assert wrong['step_err'] > 10 * limit, wrong


@pytest.mark.parametrize('change,message', [
    (dict(prediction_type='v_prediction'), 'scheduler.prediction_type: program'),
    (dict(name='lms'), "scheduler.name: the program has no 'lms'"),
    (dict(name='euler'), "the reference does not implement scheduler.name 'euler'"),
    (dict(name='pndm'), 'the reference does not implement scheduler.skip_prk_steps'),
])
def test_config_not_run_as_stated_exits_at_setup(change, message):
    """The ``tiny`` preset predicts ε under any scheduler the program has:
    a file that states v-prediction over it, a scheduler the program lacks,
    or one the reference does not implement stops before any weight is
    drawn."""
    cfg = fixture('sd21-base-512-fp32')
    cfg = dict(cfg, scheduler=dict(cfg['scheduler'], **change))
    with pytest.raises(SystemExit, match=message):
        run_cell('sd21-512-fp32.cli-b1', config=cfg)
