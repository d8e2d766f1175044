"""The weights of a run, made on the device from the seed.

For each module of the configuration, one normal draw of all its matrices
and tables at once, by a generator on the device seeded from ``--seed``:
each weight scaled by fan_in^-1/2 (``in·kh·kw`` for linears and
convolutions, the table size for embeddings), biases 0, norm scales 1, then
cast to the configuration's dtype in one call.  The state dicts are views
of that buffer, named as diffusers names them.  The same seed gives the
same numbers, so the reference draws them again after the window instead of
holding a second copy through it.
"""

from typing import Dict

import torch
import torch.nn as nn

from ..reference.models import CLIPTextModel, UNet, VAEDecoder

BUILDERS = {'text_encoder': lambda c: CLIPTextModel(c['text_encoder']),
            'text_encoder_2': lambda c: CLIPTextModel(c['text_encoder_2']),
            'unet': lambda c: UNet(c['unet']),
            'vae': lambda c: VAEDecoder(c['vae'])}

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _plan(module: nn.Module):
    """(parameter name, shape, scale): scale None for a bias (0) and 0 for
    a norm's scale (1)."""
    owner = {}
    for mname, m in module.named_modules():
        for pname, _ in m.named_parameters(recurse=False):
            owner[f'{mname}.{pname}' if mname else pname] = (m, pname)
    plan = []
    for name, p in module.named_parameters():
        m, pname = owner[name]
        if isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            scale = 0.0 if pname == 'weight' else None
        elif isinstance(m, nn.Embedding):
            scale = p.shape[0] ** -0.5
        elif pname == 'weight':
            scale = float(p[0].numel()) ** -0.5
        else:
            scale = None
        plan.append((name, tuple(p.shape), scale))
    return plan


@torch.no_grad()
def state_dicts(config: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Module name -> state dict on ``device`` in the configuration's dtype."""
    dtype = DTYPES[config['dtype']]
    gen = torch.Generator(device).manual_seed(seed)
    out = {}
    for name in config['modules']:
        with torch.device('meta'):
            plan = _plan(BUILDERS[name](config))
        total = sum(int(torch.Size(s).numel()) for _, s, _ in plan)
        flat = torch.randn(total, generator=gen, device=device)
        views, offset = {}, 0
        for key, shape, scale in plan:
            n = int(torch.Size(shape).numel())
            v = flat[offset:offset + n]
            if scale is None:
                v.zero_()
            elif scale == 0.0:
                v.fill_(1.0)
            else:
                v.mul_(scale)
            views[key] = (offset, n, shape)
            offset += n
        flat = flat.to(dtype)
        out[name] = {k: flat[o:o + n].view(s) for k, (o, n, s) in views.items()}
    return out
