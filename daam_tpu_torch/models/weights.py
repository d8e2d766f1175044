"""Parameters: random init at full width, and ``daam_tpu`` params carried across.

* :func:`init_random` builds the pipeline's modules directly on the target
  device with a ``torch.Generator``, following the scale rule of
  ``daam_tpu``'s ``_init_random_params_host`` (``models/weights.py:118-143``):
  weights ~ N(0, fan_in^-½), biases 0, norm scales 1.  It does not reproduce
  JAX's values (the two generators never agree).
* :func:`from_jax_params` turns a ``daam_tpu`` parameter pytree (the one
  ``daam_tpu.models.weights.init_random_params`` returns, as numpy arrays)
  into diffusers-named state dicts: the inverse of ``_convert_clip`` (``:250``,
  both of SDXL's encoders), ``_convert_unet`` (``:343``, SDXL's
  ``add_embedding`` included) and ``_convert_vae`` (``:420``).  Dense kernels
  are transposed and conv kernels go from ``(kh, kw, in, out)`` back to
  ``(out, in, kh, kw)``.
* :func:`load_modules` builds the modules from such state dicts
  (``strict=True``).
"""

import re
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from .clip import CLIPTextModel
from .configs import PipelineConfig
from .unet import UNet2DConditionModel
from .vae import AutoencoderKL

__all__ = ['init_random', 'from_jax_params', 'load_modules', 'build_modules',
           'VAE_SKIPPED_PREFIXES']

#: diffusers VAE keys the port does not load (the encoder is not ported):
#: :func:`from_jax_params` skips ``daam_tpu``'s ``vae/encoder`` subtree, and
#: a diffusers ``vae/`` state dict drops these prefixes before loading.
VAE_SKIPPED_PREFIXES = ('encoder.', 'quant_conv.')


def build_modules(config: PipelineConfig, device='cuda') -> Dict[str, nn.Module]:
    """Uninitialized modules of the pipeline (storage allocated, not filled)
    on ``device``: the card unless the caller names another; without one
    this raises.  SDXL adds ``text_encoder_2`` (OpenCLIP-bigG with its
    ``text_projection``)."""
    with torch.device('meta'):
        modules = {'text_encoder': CLIPTextModel(config.text),
                   'unet': UNet2DConditionModel(config.unet),
                   'vae': AutoencoderKL(config.vae)}
        if config.is_sdxl:
            modules['text_encoder_2'] = CLIPTextModel(config.text_2)
    return {k: m.to_empty(device=device).eval() for k, m in modules.items()}


@torch.no_grad()
def init_random(config: PipelineConfig, generator: torch.Generator,
                device='cuda', dtype=torch.float32) -> Dict[str, nn.Module]:
    """Random full-width modules on ``device`` in ``dtype``.

    Normals are drawn on ``generator``'s device in fp32, scaled by
    fan_in^-½ (fan_in as in ``daam_tpu``: the product of the JAX kernel's
    input axes, i.e. ``in·kh·kw``, and the table size for embeddings), and
    cast to ``dtype``.
    """
    modules = build_modules(config, device)

    def normal(t: torch.Tensor, fan_in: int):
        x = torch.randn(t.shape, generator=generator, device=generator.device)
        t.copy_(x * fan_in ** -0.5)

    for module in modules.values():
        for m in module.modules():
            if isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                normal(m.weight, m.weight.shape[0])
            elif isinstance(m, (nn.Linear, nn.Conv2d)):
                normal(m.weight, int(np.prod(m.weight.shape[1:])))
                if m.bias is not None:
                    m.bias.zero_()
    return {k: m.to(dtype) for k, m in modules.items()}


def load_modules(config: PipelineConfig, state_dicts: Dict[str, Dict[str, Any]],
                 device='cuda', dtype=torch.float32) -> Dict[str, nn.Module]:
    """Modules holding the given diffusers-named state dicts (numpy arrays or
    tensors), loaded with ``strict=True``."""
    modules = build_modules(config, device)
    for name, module in modules.items():
        sd = {k: torch.tensor(np.asarray(v)) for k, v in
              state_dicts[name].items()
              if not (name == 'vae' and k.startswith(VAE_SKIPPED_PREFIXES))}
        module.load_state_dict(sd, strict=True)
    return {k: m.to(dtype) for k, m in modules.items()}


# --------------------------------------------------------------------------
# daam_tpu pytree -> diffusers state dicts
# --------------------------------------------------------------------------

def _dense(k) -> np.ndarray:
    """flax (in, out) -> torch (out, in)."""
    return np.ascontiguousarray(np.asarray(k).T)


def _conv(k) -> np.ndarray:
    """flax HWIO -> torch OIHW (inverse of ``daam_tpu`` ``_conv_kernel``)."""
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _kernel(k) -> np.ndarray:
    return _conv(k) if np.ndim(k) == 4 else _dense(k)


def _put_linear(out, prefix: str, p: Dict):
    """A flax Dense or Conv subtree (``kernel``/``bias``) -> ``weight``/``bias``."""
    out[prefix + 'weight'] = _kernel(p['kernel'])
    if 'bias' in p:
        out[prefix + 'bias'] = np.asarray(p['bias'])


def _put_norm(out, prefix: str, p: Dict):
    out[prefix + 'weight'] = np.asarray(p['scale'])
    out[prefix + 'bias'] = np.asarray(p['bias'])


def _put_resnet(out, prefix: str, p: Dict):
    _put_norm(out, prefix + 'norm1.', p['norm1'])
    _put_linear(out, prefix + 'conv1.', p['conv1'])
    if 'time_emb_proj' in p:
        _put_linear(out, prefix + 'time_emb_proj.', p['time_emb_proj'])
    _put_norm(out, prefix + 'norm2.', p['norm2'])
    _put_linear(out, prefix + 'conv2.', p['conv2'])
    if 'conv_shortcut' in p:
        _put_linear(out, prefix + 'conv_shortcut.', p['conv_shortcut'])


def _put_transformer(out, prefix: str, p: Dict):
    _put_norm(out, prefix + 'norm.', p['norm'])
    _put_linear(out, prefix + 'proj_in.', p['proj_in'])
    blocks = sorted((k for k in p if k.startswith('transformer_blocks_')),
                    key=lambda k: int(k.rsplit('_', 1)[1]))
    for d, key in enumerate(blocks):
        bp, b = f'{prefix}transformer_blocks.{d}.', p[key]
        for norm in ('norm1', 'norm2', 'norm3'):
            _put_norm(out, f'{bp}{norm}.', b[norm])
        for attn in ('attn1', 'attn2'):
            for proj in ('to_q', 'to_k', 'to_v'):
                _put_linear(out, f'{bp}{attn}.{proj}.', b[attn][proj])
            _put_linear(out, f'{bp}{attn}.to_out.0.', b[attn]['to_out'])
        _put_linear(out, bp + 'ff.net.0.proj.', b['ff']['proj_in'])
        _put_linear(out, bp + 'ff.net.2.', b['ff']['proj_out'])
    _put_linear(out, prefix + 'proj_out.', p['proj_out'])


def _count(p: Dict, pattern: str) -> int:
    return sum(1 for k in p if re.fullmatch(pattern, k))


def _unet_state_dict(p: Dict) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    n = _count(p, r'down_\d+_resnet_0')
    lpb = _count(p, r'down_0_resnet_\d+')
    _put_linear(out, 'conv_in.', p['conv_in'])
    for emb in ('time_embedding', 'add_embedding'):
        if emb in p:  # add_embedding: SDXL's text_time conditioning
            for lin in ('linear_1', 'linear_2'):
                _put_linear(out, f'{emb}.{lin}.', p[emb][lin])
    for level in range(n):
        for i in range(lpb):
            _put_resnet(out, f'down_blocks.{level}.resnets.{i}.',
                        p[f'down_{level}_resnet_{i}'])
            if f'down_{level}_attn_{i}' in p:
                _put_transformer(out, f'down_blocks.{level}.attentions.{i}.',
                                 p[f'down_{level}_attn_{i}'])
        if f'down_{level}_downsample' in p:
            _put_linear(out, f'down_blocks.{level}.downsamplers.0.conv.',
                        p[f'down_{level}_downsample']['conv'])
    _put_resnet(out, 'mid_block.resnets.0.', p['mid_resnet_0'])
    if 'mid_attn_0' in p:
        _put_transformer(out, 'mid_block.attentions.0.', p['mid_attn_0'])
    _put_resnet(out, 'mid_block.resnets.1.', p['mid_resnet_1'])
    for j in range(n):
        level = n - 1 - j
        for i in range(lpb + 1):
            _put_resnet(out, f'up_blocks.{j}.resnets.{i}.',
                        p[f'up_{level}_resnet_{i}'])
            if f'up_{level}_attn_{i}' in p:
                _put_transformer(out, f'up_blocks.{j}.attentions.{i}.',
                                 p[f'up_{level}_attn_{i}'])
        if f'up_{level}_upsample' in p:
            _put_linear(out, f'up_blocks.{j}.upsamplers.0.conv.',
                        p[f'up_{level}_upsample']['conv'])
    _put_norm(out, 'conv_norm_out.', p['conv_norm_out'])
    _put_linear(out, 'conv_out.', p['conv_out'])
    return out


def _clip_state_dict(p: Dict) -> Dict[str, np.ndarray]:
    pre = 'text_model.'
    out = {pre + 'embeddings.token_embedding.weight':
           np.asarray(p['token_embedding']['embedding']),
           pre + 'embeddings.position_embedding.weight':
           np.asarray(p['position_embedding'])}
    for i in range(_count(p, r'layers_\d+')):
        lp, layer = f'{pre}encoder.layers.{i}.', p[f'layers_{i}']
        _put_norm(out, lp + 'layer_norm1.', layer['layer_norm1'])
        _put_norm(out, lp + 'layer_norm2.', layer['layer_norm2'])
        for proj in ('q_proj', 'k_proj', 'v_proj', 'out_proj'):
            _put_linear(out, f'{lp}self_attn.{proj}.', layer['self_attn'][proj])
        for fc in ('fc1', 'fc2'):
            _put_linear(out, f'{lp}mlp.{fc}.', layer[fc])
    _put_norm(out, pre + 'final_layer_norm.', p['final_layer_norm'])
    if 'text_projection' in p:
        _put_linear(out, 'text_projection.', p['text_projection'])
    return out


def _vae_state_dict(p: Dict) -> Dict[str, np.ndarray]:
    """Decoder keys only: ``daam_tpu``'s ``encoder`` subtree (when present)
    is skipped, see :data:`VAE_SKIPPED_PREFIXES`."""
    d = p['decoder']
    n = _count(d, r'up_\d+_resnet_0')
    lpb1 = _count(d, r'up_0_resnet_\d+')
    out: Dict[str, np.ndarray] = {}
    _put_linear(out, 'post_quant_conv.', d['post_quant_conv'])
    _put_linear(out, 'decoder.conv_in.', d['conv_in'])
    _put_resnet(out, 'decoder.mid_block.resnets.0.', d['mid_resnet_0'])
    ap, a = 'decoder.mid_block.attentions.0.', d['mid_attn']
    _put_norm(out, ap + 'group_norm.', a['group_norm'])
    for proj in ('to_q', 'to_k', 'to_v'):
        _put_linear(out, f'{ap}{proj}.', a[proj])
    _put_linear(out, ap + 'to_out.0.', a['to_out'])
    _put_resnet(out, 'decoder.mid_block.resnets.1.', d['mid_resnet_1'])
    for j in range(n):
        level = n - 1 - j
        for i in range(lpb1):
            _put_resnet(out, f'decoder.up_blocks.{j}.resnets.{i}.',
                        d[f'up_{level}_resnet_{i}'])
        if f'up_{level}_upsample' in d:
            _put_linear(out, f'decoder.up_blocks.{j}.upsamplers.0.conv.',
                        d[f'up_{level}_upsample'])
    _put_norm(out, 'decoder.conv_norm_out.', d['conv_norm_out'])
    _put_linear(out, 'decoder.conv_out.', d['conv_out'])
    return out


_CONVERTERS = {'text_encoder': _clip_state_dict,
               'text_encoder_2': _clip_state_dict, 'unet': _unet_state_dict,
               'vae': _vae_state_dict}


def from_jax_params(params: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """``daam_tpu`` params ``{'text_encoder', 'unet', 'vae'}`` (and SDXL's
    ``'text_encoder_2'``) → diffusers-named state dicts for the modules
    present (numpy arrays; anything array-like is accepted as a leaf).
    Another entry raises."""
    unknown = set(params) - set(_CONVERTERS)
    if unknown:
        raise ValueError(f'cannot convert {sorted(unknown)}')
    return {name: _CONVERTERS[name](tree) for name, tree in params.items()}
