"""The plain reference against the program on the CPU at the test sizes:
module by module on one set of state dicts, and whole runs of every cell's
flow through the harness (the program's kernels run their plain versions
on the CPU)."""

import json

import pytest
import torch

from gpubench.core import spec, weights
from gpubench.reference.models import Capture
from gpubench.reference.pipeline import Reference
from gpubench.reference.tokenizer import Tokenizer
from gpubench.tests.drive import FIXTURES, run_cell


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


@pytest.mark.parametrize('workload', [w['name'] for w in spec.benchmark()['workloads']])
def test_sound_run_is_correct(workload):
    line = run_cell(workload)
    assert line['correct'], line['checks']
    assert line['attempted'] >= 1 and line['failed'] == 0
    assert list(line)[-1] == 'checks'
    for name, c in line['checks'].items():
        assert c['value'] <= min(c['limit'], 1e-3) or name == 'png_missing', (name, c)
