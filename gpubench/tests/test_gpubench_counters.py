"""The FLOP and byte counters against hand counts and against PyTorch's
own operation counter, on the ``tiny`` and ``tiny-xl`` configurations."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.core import counters, weights
from gpubench.reference.models import Capture, cross_attention_layers

FIXTURES = Path(__file__).with_name('fixtures')


def config(name):
    return json.loads((FIXTURES / f'{name}.json').read_text())


def test_bound_by_hand():
    call = {'kernel': 'k1', 'B': 1, 'H': 2, 'Lq': 64, 'Lk': 77, 'hd': 16}
    flop = 4 * 1 * 2 * 64 * 77 * 16
    nbytes = 4 * 2 * (2 * 64 + 2 * 77) * 16 + 8 * 2 * 77 * 64
    assert counters.attention_bound_s(call, 'float32') == pytest.approx(
        max(flop / 495e12, nbytes / 3.35e12))
    k2 = dict(call, kernel='k2', Lk=64)
    assert counters.attention_bound_s(k2, 'bfloat16') == pytest.approx(
        max(4 * 2 * 64 * 64 * 16 / 989e12, 2 * 2 * 256 * 16 / 3.35e12))
    k5 = dict(call, kernel='k5')
    assert counters.attention_bound_s(k5, 'float32') == pytest.approx(
        max(flop / 495e12, (4 * 2 * 282 * 16 + 4 * 2 * 64 * 77) / 3.35e12))


@pytest.mark.parametrize('name,k1', [('tiny', 3), ('tiny-xl', 6)])
def test_attention_calls_by_hand(name, k1):
    """tiny: cross layers at level 0 (down 1, up 2) captured, the mid
    block's not; tiny-xl: two-deep transformers at level 1 (down 1, up 2)
    captured, the mid block's two not."""
    cfg = config(name)
    calls = counters.attention_calls(cfg, 1, 'acc')
    assert sum(c['kernel'] == 'k1' for c in calls) == k1
    assert sum(c['kernel'] == 'k2' for c in calls) == 2 * k1 + (1 if name == 'tiny' else 2) * 2
    layers = cross_attention_layers(cfg['unet'])
    assert sum(c['role'] == 'self' for c in calls) == len(layers)
    save = counters.attention_calls(cfg, 2, 'save')
    assert sum(c['kernel'] == 'k5' for c in save) == len(layers)
    assert all(c['B'] == 4 for c in save)
    assert not any(c['kernel'] for c in counters.attention_calls(cfg, 1, 'load')
                   if c['role'] == 'replay')


@pytest.mark.parametrize('name', ['tiny', 'tiny-xl'])
@pytest.mark.parametrize('batch', [1, 2])
def test_model_flop_against_torch_counter(name, batch):
    """The meta-device count equals PyTorch's FlopCounterMode over a real
    forward of the reference modules (convolutions, linears, attention
    products)."""
    cfg = config(name)
    ours = counters.model_flop(cfg, batch, 'acc')
    sds = weights.state_dicts(cfg, 0, 'cpu')
    mods = {n: weights.BUILDERS[n](cfg) for n in cfg['modules']}
    for n, m in mods.items():
        m.load_state_dict(sds[n])
    latent = cfg['run']['image_size'] // cfg['vae_scale_factor']
    B = 2 * batch
    ids = torch.zeros(B, 77, dtype=torch.long)
    with FlopCounterMode(display=False) as fc:
        for n in cfg['modules']:
            if n.startswith('text_encoder'):
                mods[n](ids, penultimate=True)
    assert ours['text'] == fc.get_total_flops()
    added = None
    if 'text_encoder_2' in cfg:
        added = {'text_embeds': torch.zeros(B, cfg['text_encoder_2']['projection_dim']),
                 'time_ids': torch.zeros(B, 6)}
    with FlopCounterMode(display=False) as fc:
        mods['unet'](torch.zeros(B, 4, latent, latent), torch.tensor(10),
                     torch.zeros(B, 77, cfg['unet']['cross_attention_dim']), added, Capture())
    assert ours['unet'] == fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        mods['vae'](torch.zeros(batch, 4, latent, latent))
    assert ours['vae'] == fc.get_total_flops()
    assert ours['total'] == ours['text'] + cfg['run']['steps'] * ours['unet'] + ours['vae']


def test_replay_counts_pv_alone():
    cfg = config('tiny')
    acc, load = counters.model_flop(cfg, 1, 'acc'), counters.model_flop(cfg, 1, 'load')
    qk = sum(2 * c['B'] * c['H'] * c['Lq'] * c['Lk'] * c['hd']
             for c in counters.attention_calls(cfg, 1, 'load') if c['role'] == 'replay')
    assert acc['unet'] - load['unet'] == qk


def test_tiles():
    cfg = config('tiny')
    assert counters.vae_tiles(cfg) == 0
    big = json.loads((Path(__file__).parents[1] / 'configs' / 'sdxl-base-1024-bf16.json').read_text())
    assert counters.vae_tiles(big) == 9   # 128² latents: tiles at 0, 48, 64
