"""Operations and bytes of the work, from the configuration's shapes.

* :func:`attention_calls`: every attention call of one UNet evaluation,
  with the kernel that the program's dispatch gives it (K1
  ``cross_attention_acc``, K2 ``flash_attention``, K5
  ``cross_attention_probs``; a replayed P is no kernel's), and its shape.
* :func:`attention_bound_s`: a call's least time on the card: the larger of
  4·B·H·Lq·Lk·hd FLOP once at the dtype's dense tensor-core peak, and its
  bytes (inputs read once, outputs written once, K1's float32 accumulator
  read and written, K5's float32 P written) at the memory's bandwidth.
* :func:`model_flop`: the FLOP of one request's model work, counted by
  running the reference modules on the ``meta`` device: every convolution
  and linear (2 per multiply-add) and every attention product (QKᵀ and
  PV; PV alone where P is replayed), for the text encoders on the CFG
  batch, the UNet per evaluation and the VAE decode (per tile, where the
  configuration tiles it).
"""

import json
from pathlib import Path
from typing import Dict, List

import torch
import torch.nn as nn

from ..reference.models import Capture, cross_attention_layers
from .weights import BUILDERS

PEAKS = json.loads((Path(__file__).resolve().parents[1] / 'peaks.json').read_text())
ESIZE = {'float32': 4, 'bfloat16': 2}


def peak_flops(dtype: str) -> float:
    """Dense tensor-core FLOP/s for the configuration's dtype: float32 runs
    its convolutions and attention on the tensor cores in TF32."""
    return PEAKS['tf32_dense_flops'] if dtype == 'float32' else PEAKS['bf16_dense_flops']


def _located(cfg: dict, transplant: bool) -> set:
    size = cfg['run']['image_size']
    x = 64 if size in (512, 1024) else 96
    latent = size // cfg['vae_scale_factor']
    names = set()
    for info in cross_attention_layers(cfg['unet']):
        if info['position'] == 'mid' and not transplant:
            continue
        edge = latent // info['downscale']
        factor = max(x // edge, 1) if edge <= x else x // edge
        if factor != 8:
            names.add(info['name'])
    return names


def attention_calls(cfg: dict, batch: int, mode: str) -> List[Dict]:
    """One UNet evaluation's attention calls for ``batch`` prompts (CFG
    batch 2·batch).  ``mode``: 'acc' (traced), 'save', 'load' or 'off'
    (untraced)."""
    u = cfg['unet']
    latent = cfg['run']['image_size'] // cfg['vae_scale_factor']
    located = _located(cfg, mode in ('save', 'load'))
    calls = []
    for info in cross_attention_layers(u):
        lvl = info['level']
        heads = u['attention_head_dim'][lvl]
        hd = u['block_out_channels'][lvl] // heads
        L = (latent // info['downscale']) ** 2
        common = {'H': heads, 'Lq': L, 'hd': hd, 'layer': info['name']}
        calls.append(dict(common, kernel='k2', B=2 * batch, Lk=L, role='self'))
        if mode == 'acc' and info['name'] in located:
            calls.append(dict(common, kernel='k2', B=batch, Lk=77, role='uncond'))
            calls.append(dict(common, kernel='k1', B=batch, Lk=77, role='capture'))
        elif mode == 'save':
            calls.append(dict(common, kernel='k5', B=2 * batch, Lk=77, role='save'))
        elif mode == 'load':
            calls.append(dict(common, kernel=None, B=2 * batch, Lk=77, role='replay'))
        else:
            calls.append(dict(common, kernel='k2', B=2 * batch, Lk=77, role='cross'))
    return calls


def attention_bound_s(call: Dict, dtype: str) -> float:
    B, H, Lq, Lk, hd = call['B'], call['H'], call['Lq'], call['Lk'], call['hd']
    flop = 4 * B * H * Lq * Lk * hd
    nbytes = ESIZE[dtype] * B * H * (2 * Lq + 2 * Lk) * hd
    if call['kernel'] == 'k1':
        nbytes += 2 * 4 * B * H * Lk * Lq
    elif call['kernel'] == 'k5':
        nbytes += 4 * B * H * Lq * Lk
    return max(flop / peak_flops(dtype), nbytes / PEAKS['hbm_bytes_per_s'])


class _Count:
    def __init__(self):
        self.flop = 0

    def __call__(self, n):
        self.flop += n


def _hooked(module: nn.Module, count: _Count):
    def hook(m, args, out):
        if isinstance(m, nn.Conv2d):
            k = m.weight.shape[1] * m.weight.shape[2] * m.weight.shape[3]
        else:
            k = m.in_features
        count(2 * out.numel() * k)

    def conv_out(m, args, out):  # the last convolution, run as F.conv2d in float32
        w = m.conv_out.weight if hasattr(m, 'conv_out') else m.decoder.conv_out.weight
        count(2 * out.numel() * w.shape[1] * w.shape[2] * w.shape[3])

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, (nn.Conv2d, nn.Linear))]
    if hasattr(module, 'conv_out') or hasattr(module, 'decoder'):
        handles.append(module.register_forward_hook(conv_out))
    for m in module.modules():
        if hasattr(m, 'counter'):
            m.counter = count
    return handles


def vae_tiles(cfg: dict) -> int:
    latent = cfg['run']['image_size'] // cfg['vae_scale_factor']
    if latent <= cfg['run']['vae_tile_threshold']:
        return 0
    tile, overlap = 64, 16
    pos = list(range(0, max(latent - tile, 0) + 1, tile - overlap))
    if not pos or pos[-1] + tile < latent:
        pos.append(latent - tile)
    return len(set(pos)) ** 2


@torch.no_grad()
def model_flop(cfg: dict, batch: int, mode: str) -> Dict[str, int]:
    """FLOP of one request of ``batch`` prompts: ``text``, ``unet`` (one
    evaluation), ``vae`` and ``total`` (text + steps × unet + vae)."""
    out = {}
    latent = cfg['run']['image_size'] // cfg['vae_scale_factor']
    with torch.device('meta'):
        count = _Count()
        for name in cfg['modules']:
            if name.startswith('text_encoder'):
                m = BUILDERS[name](cfg)
                _hooked(m, count)
                m(torch.zeros(2 * batch, 77, dtype=torch.long), penultimate=True)
        out['text'] = count.flop
        count = _Count()
        unet = BUILDERS['unet'](cfg)
        _hooked(unet, count)
        added = None
        if cfg['unet'].get('addition_embed_type') == 'text_time':
            added = {'text_embeds': torch.zeros(2 * batch, cfg['text_encoder_2']['projection_dim']),
                     'time_ids': torch.zeros(2 * batch, 6)}
        ctx_dim = cfg['unet']['cross_attention_dim']
        replay = ({i['name']: True for i in cross_attention_layers(cfg['unet'])}
                  if mode == 'load' else None)
        unet(torch.zeros(2 * batch, cfg['unet']['in_channels'], latent, latent),
             torch.zeros(()), torch.zeros(2 * batch, 77, ctx_dim), added,
             Capture(replay=replay))
        out['unet'] = count.flop
        count = _Count()
        vae = BUILDERS['vae'](cfg)
        _hooked(vae, count)
        tiles = vae_tiles(cfg)
        edge = 64 if tiles else latent
        vae(torch.zeros(batch * max(tiles, 1), cfg['vae']['latent_channels'], edge, edge))
        out['vae'] = count.flop
    out['total'] = out['text'] + cfg['run']['steps'] * out['unet'] + out['vae']
    return out


MODE = {'plain': 'acc', 'save': 'save', 'load': 'load'}


def roofline_share(data: dict, kernel: str, names, launches_per_call) -> float:
    """``kernel``'s share of its roofline in the profiled request, in %:
    the least time of its calls that the request's shapes imply over the
    device time of the kernels ``names``.  None without a profile or a
    call."""
    import sys

    p = data['profile']
    if p is None:
        return None
    cfg, dtype = data['cfg'], data['cfg']['dtype']
    bound, launches = 0.0, 0
    for kind, batch in data['profile_runs']:
        for call in attention_calls(cfg, batch, MODE[kind]):
            if call['kernel'] == kernel:
                bound += attention_bound_s(call, dtype) * data['steps']
                launches += launches_per_call(dtype, call['hd']) * data['steps']
    seconds, seen = p.device_s(names)
    if seen != launches:
        print(f'{kernel}: {seen} launches profiled, {launches} expected', file=sys.stderr)
    return 100.0 * bound / seconds if seconds > 0 and bound > 0 else None
