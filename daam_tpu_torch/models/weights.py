"""Parameters: random init at full width, ``daam_tpu`` params carried across,
and diffusers checkpoint directories read from disk.

* :func:`init_random` builds the pipeline's modules directly on the target
  device with a ``torch.Generator``, following the scale rule of
  ``daam_tpu``'s ``_init_random_params_host`` (``models/weights.py:118-143``):
  weights ~ N(0, fan_in^-½), biases 0, norm scales 1.  It does not reproduce
  JAX's values (the two generators never agree).
* :func:`from_jax_params` turns a ``daam_tpu`` parameter pytree (the one
  ``daam_tpu.models.weights.init_random_params`` returns, as numpy arrays)
  into diffusers-named state dicts: the inverse of ``_convert_clip`` (``:250``,
  both of SDXL's encoders), ``_convert_unet`` (``:343``, SDXL's
  ``add_embedding`` included) and ``_convert_vae`` (``:420``, the encoder
  included when the tree has one).  Dense kernels are transposed and conv
  kernels go from ``(kh, kw, in, out)`` back to ``(out, in, kh, kw)``.
* :func:`to_jax_params` is its exact inverse: diffusers-named state dicts
  (the port's modules' own) back into ``daam_tpu``'s parameter tree, and
  :func:`save_params`/:func:`load_params` read and write that tree as
  ``daam_tpu``'s ``.npz`` (``models/weights.py:152-183``).
* :func:`init_random_params` rebuilds ``daam_tpu``'s host init
  (``_init_random_params_host``, ``:77-145``) bit for bit with numpy alone,
  so weights made where JAX runs can be made again on the card.
* :func:`load_modules` builds the modules from such state dicts
  (``strict=True``).
* :func:`load_diffusers_checkpoint` reads a local diffusers directory
  (``text_encoder/``, ``unet/``, ``vae/``, SDXL's ``text_encoder_2/``;
  ``*.safetensors`` through the port's own reader, else ``*.bin``), derives
  the config from its ``config.json`` files as ``daam_tpu`` does
  (``:498-631``), and loads one module at a time straight onto the device.
  Keys are normalized first, to accept what ``daam_tpu``'s converters
  accept, then loaded strictly.
"""

import json
import math
import mmap
import re
import struct
from dataclasses import replace
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from .clip import CLIPTextModel
from .configs import (MODEL_PRESETS, CLIPTextConfig, PipelineConfig, UNetConfig,
                      VAEConfig, get_pipeline_config)
from .unet import UNet2DConditionModel
from .vae import AutoencoderKL

__all__ = ['init_random', 'fill_random', 'from_jax_params', 'to_jax_params',
           'init_random_params', 'save_params', 'load_params', 'param_sums',
           'load_modules', 'build_modules', 'load_diffusers_checkpoint',
           'read_safetensors']


def _build(name: str, config: PipelineConfig, with_encoder: bool = False
           ) -> nn.Module:
    if name == 'unet':
        return UNet2DConditionModel(config.unet)
    if name == 'vae':
        return AutoencoderKL(config.vae, with_encoder=with_encoder)
    return CLIPTextModel(config.text if name == 'text_encoder' else config.text_2)


def _module_names(config: PipelineConfig):
    names = ['text_encoder', 'unet', 'vae']
    return names + ['text_encoder_2'] if config.is_sdxl else names


def build_modules(config: PipelineConfig, device='cuda') -> Dict[str, nn.Module]:
    """Uninitialized modules of the pipeline (storage allocated, not filled)
    on ``device``: the card unless the caller names another; without one
    this raises.  SDXL adds ``text_encoder_2`` (OpenCLIP-bigG with its
    ``text_projection``).  The VAE is the decode half, as ``daam_tpu``'s
    random init builds it (``:68-72``)."""
    with torch.device('meta'):
        modules = {name: _build(name, config) for name in _module_names(config)}
    return {k: m.to_empty(device=device).eval() for k, m in modules.items()}


def init_random(config: PipelineConfig, generator: torch.Generator,
                device='cuda', dtype=torch.float32) -> Dict[str, nn.Module]:
    """Random full-width modules on ``device`` in ``dtype``, filled by
    :func:`fill_random`."""
    modules = build_modules(config, device)
    for module in modules.values():
        fill_random(module, generator)
    return {k: m.to(dtype) for k, m in modules.items()}


@torch.no_grad()
def fill_random(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Fill ``module``'s weights by ``daam_tpu``'s scale rule: normals drawn
    on ``generator``'s device in fp32, scaled by fan_in^-½ (fan_in as in
    ``daam_tpu``: the product of the JAX kernel's input axes, i.e.
    ``in·kh·kw``, and the table size for embeddings), biases 0, norm scales
    1."""
    def normal(t: torch.Tensor, fan_in: int):
        x = torch.randn(t.shape, generator=generator, device=generator.device)
        t.copy_(x * fan_in ** -0.5)

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
    return module


@torch.no_grad()
def _load_module(name: str, config: PipelineConfig, sd: Dict[str, Any],
                 device, dtype) -> nn.Module:
    """Module ``name`` holding ``sd`` (tensors or arrays, diffusers names),
    built on ``device`` in ``dtype``; the keys must match exactly, as under
    ``strict=True``.  A VAE without ``encoder.`` keys is built without its
    encoder.  ``sd`` is emptied as it is copied: each tensor moves to the
    device in its own dtype and is cast there."""
    with_encoder = name != 'vae' or any(k.startswith('encoder.') for k in sd)
    with torch.device('meta'):
        module = _build(name, config, with_encoder).to(dtype)
    module = module.to_empty(device=device).eval()
    target = module.state_dict()
    missing, unexpected = sorted(set(target) - set(sd)), sorted(set(sd) - set(target))
    if missing or unexpected:
        raise RuntimeError(f'{name}: missing keys {missing[:8]}, unexpected '
                           f'keys {unexpected[:8]}')
    for key, dst in target.items():
        src = sd.pop(key)
        if not isinstance(src, torch.Tensor):
            src = torch.tensor(np.asarray(src))
        if tuple(src.shape) != tuple(dst.shape):
            raise RuntimeError(f'{name}.{key}: shape {tuple(src.shape)} in the '
                               f'checkpoint, {tuple(dst.shape)} in the module')
        dst.copy_(src.to(device))
    return module


def load_modules(config: PipelineConfig, state_dicts: Dict[str, Dict[str, Any]],
                 device='cuda', dtype=torch.float32) -> Dict[str, nn.Module]:
    """Modules holding the given diffusers-named state dicts (numpy arrays or
    tensors), loaded with ``strict=True``; a VAE state dict without encoder
    keys gives the decode-only VAE."""
    return {name: _load_module(name, config, dict(state_dicts[name]), device, dtype)
            for name in _module_names(config)}


# --------------------------------------------------------------------------
# daam_tpu pytree -> diffusers state dicts
# --------------------------------------------------------------------------

def _host(x):
    """A leaf as it is held on the host: a tensor stays a tensor (numpy has
    no bfloat16), anything else array-like becomes a numpy array."""
    return x if isinstance(x, torch.Tensor) else np.asarray(x)


def _permute(x, axes):
    x = _host(x)
    if isinstance(x, torch.Tensor):
        return x.permute(axes).contiguous()
    return np.ascontiguousarray(np.transpose(x, axes))


def _dense(k):
    """flax (in, out) -> torch (out, in), and back."""
    return _permute(k, (1, 0))


def _conv(k):
    """flax HWIO -> torch OIHW (inverse of ``daam_tpu`` ``_conv_kernel``)."""
    return _permute(k, (3, 2, 0, 1))


def _kernel(k):
    k = _host(k)
    return _conv(k) if k.ndim == 4 else _dense(k)


def _put_linear(out, prefix: str, p: Dict):
    """A flax Dense or Conv subtree (``kernel``/``bias``) -> ``weight``/``bias``."""
    out[prefix + 'weight'] = _kernel(p['kernel'])
    if 'bias' in p:
        out[prefix + 'bias'] = _host(p['bias'])


def _put_norm(out, prefix: str, p: Dict):
    out[prefix + 'weight'] = _host(p['scale'])
    out[prefix + 'bias'] = _host(p['bias'])


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
           _host(p['token_embedding']['embedding']),
           pre + 'embeddings.position_embedding.weight':
           _host(p['position_embedding'])}
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


def _put_vae_attention(out, prefix: str, a: Dict):
    _put_norm(out, prefix + 'group_norm.', a['group_norm'])
    for proj in ('to_q', 'to_k', 'to_v'):
        _put_linear(out, f'{prefix}{proj}.', a[proj])
    _put_linear(out, prefix + 'to_out.0.', a['to_out'])


def _vae_state_dict(p: Dict) -> Dict[str, np.ndarray]:
    """The decoder's keys, and the encoder's (``encoder.…``,
    ``quant_conv.…``) when ``daam_tpu``'s tree has its ``encoder``
    subtree (the inverse of ``_convert_vae``, ``:441-466``)."""
    d = p['decoder']
    n = _count(d, r'up_\d+_resnet_0')
    lpb1 = _count(d, r'up_0_resnet_\d+')
    out: Dict[str, np.ndarray] = {}
    _put_linear(out, 'post_quant_conv.', d['post_quant_conv'])
    _put_linear(out, 'decoder.conv_in.', d['conv_in'])
    _put_resnet(out, 'decoder.mid_block.resnets.0.', d['mid_resnet_0'])
    _put_vae_attention(out, 'decoder.mid_block.attentions.0.', d['mid_attn'])
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
    if 'encoder' not in p:
        return out
    e = p['encoder']
    lpb = _count(e, r'down_0_resnet_\d+')
    _put_linear(out, 'encoder.conv_in.', e['conv_in'])
    for level in range(_count(e, r'down_\d+_resnet_0')):
        for i in range(lpb):
            _put_resnet(out, f'encoder.down_blocks.{level}.resnets.{i}.',
                        e[f'down_{level}_resnet_{i}'])
        if f'down_{level}_downsample' in e:
            _put_linear(out, f'encoder.down_blocks.{level}.downsamplers.0.conv.',
                        e[f'down_{level}_downsample'])
    _put_resnet(out, 'encoder.mid_block.resnets.0.', e['mid_resnet_0'])
    _put_vae_attention(out, 'encoder.mid_block.attentions.0.', e['mid_attn'])
    _put_resnet(out, 'encoder.mid_block.resnets.1.', e['mid_resnet_1'])
    _put_norm(out, 'encoder.conv_norm_out.', e['conv_norm_out'])
    _put_linear(out, 'encoder.conv_out.', e['conv_out'])
    _put_linear(out, 'quant_conv.', e['quant_conv'])
    return out


_CONVERTERS = {'text_encoder': _clip_state_dict,
               'text_encoder_2': _clip_state_dict, 'unet': _unet_state_dict,
               'vae': _vae_state_dict}


def from_jax_params(params: Dict[str, Any]) -> Dict[str, Dict[str, np.ndarray]]:
    """``daam_tpu`` params ``{'text_encoder', 'unet', 'vae'}`` (and SDXL's
    ``'text_encoder_2'``) → diffusers-named state dicts for the modules
    present: host tensors stay tensors (bfloat16 included), anything else
    array-like becomes numpy.  Another entry raises."""
    unknown = set(params) - set(_CONVERTERS)
    if unknown:
        raise ValueError(f'cannot convert {sorted(unknown)}')
    return {name: _CONVERTERS[name](tree) for name, tree in params.items()}


# --------------------------------------------------------------------------
# diffusers state dicts -> daam_tpu pytree, the .npz format, the host init
# --------------------------------------------------------------------------

#: How a diffusers key's module path becomes ``daam_tpu``'s, rule by rule in
#: order (each the inverse of a ``_put_*`` above); what is left of the dotted
#: path then names the flax subtree.  ``'vae'`` moves the quant convs into
#: their half, whose keys then take ``'vae_half'``.
_BLOCK_RULES = [
    (r'^(down|up)_blocks\.(\d+)\.resnets\.(\d+)\.', r'\1_\2_resnet_\3.'),
    (r'^(down|up)_blocks\.(\d+)\.attentions\.(\d+)\.', r'\1_\2_attn_\3.'),
    (r'^mid_block\.resnets\.(\d+)\.', r'mid_resnet_\1.'),
    (r'\.transformer_blocks\.(\d+)\.', r'.transformer_blocks_\1.'),
    (r'\.to_out\.0\.', '.to_out.'),
    (r'\.ff\.net\.0\.proj\.', '.ff.proj_in.'),
    (r'\.ff\.net\.2\.', '.ff.proj_out.'),
]
_PATH_RULES = {
    'unet': _BLOCK_RULES + [
        (r'^mid_block\.attentions\.0\.', 'mid_attn_0.'),
        (r'^down_blocks\.(\d+)\.downsamplers\.0\.conv\.', r'down_\1_downsample.conv.'),
        (r'^up_blocks\.(\d+)\.upsamplers\.0\.conv\.', r'up_\1_upsample.conv.')],
    'vae': [(r'^post_quant_conv\.', 'decoder.post_quant_conv.'),
            (r'^quant_conv\.', 'encoder.quant_conv.')],
    'vae_half': _BLOCK_RULES + [
        (r'^mid_block\.attentions\.0\.', 'mid_attn.'),
        (r'^down_blocks\.(\d+)\.downsamplers\.0\.conv\.', r'down_\1_downsample.'),
        (r'^up_blocks\.(\d+)\.upsamplers\.0\.conv\.', r'up_\1_upsample.')],
    'text_encoder': [(r'^text_model\.embeddings\.', ''),
                     (r'^text_model\.encoder\.layers\.(\d+)\.', r'layers_\1.'),
                     (r'^text_model\.', ''), (r'\.mlp\.', '.')],
}


def _levels(keys, prefix: str) -> int:
    return 1 + max(int(m[1]) for k in keys
                   for m in [re.match(prefix + r'(\d+)\.', k)] if m)


def _jax_path(rules: str, key: str, levels: Optional[int] = None) -> Tuple[str, ...]:
    """``key`` rewritten by ``_PATH_RULES[rules]`` and split; ``levels``
    renumbers ``up_blocks.j`` (diffusers counts from the deepest level) to
    its resolution level ``levels - 1 - j``."""
    for pattern, repl in _PATH_RULES[rules]:
        key = re.sub(pattern, repl, key)
    if levels is not None:
        key = re.sub(r'^up_(\d+)_', lambda m: f'up_{levels - 1 - int(m[1])}_', key)
    return tuple(key.split('.'))


def _to_jax_leaf(path: Tuple[str, ...], value):
    """(flax path, leaf) of a diffusers ``weight``: embeddings as they are
    (the position embedding is a bare parameter), norms' 1-D weight as
    ``scale``, Dense kernels (in, out), convolutions HWIO."""
    x = _host(value)
    if path[-1] == 'bias':
        return path, x
    owner = path[:-1]
    if owner[-1] == 'token_embedding':
        return owner + ('embedding',), x
    if owner[-1] == 'position_embedding':
        return owner, x
    if x.ndim == 1:
        return owner + ('scale',), x
    return owner + ('kernel',), _permute(x, (2, 3, 1, 0) if x.ndim == 4 else (1, 0))


def _module_to_jax(name: str, sd: Dict[str, Any]) -> Dict[str, Any]:
    def path_of(key):
        if name == 'unet':
            return _jax_path('unet', key, unet_levels)
        if name == 'vae':
            half, *rest = _jax_path('vae', key)
            return (half,) + _jax_path('vae_half', '.'.join(rest),
                                       decoder_levels if half == 'decoder' else None)
        return _jax_path('text_encoder', key)

    unet_levels = _levels(sd, r'down_blocks\.') if name == 'unet' else None
    decoder_levels = _levels(sd, r'decoder\.up_blocks\.') if name == 'vae' else None
    tree: Dict[str, Any] = {}
    for key, value in sd.items():
        path, leaf = _to_jax_leaf(path_of(key), value)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree


def to_jax_params(state_dicts: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Diffusers-named state dicts (the port's modules', as numpy arrays or
    host tensors) → ``daam_tpu``'s parameter tree: the exact inverse of
    :func:`from_jax_params`, so ``to_jax_params(from_jax_params(p)) == p``
    leaf for leaf, and the reverse.  Dense kernels come out (in, out),
    convolutions HWIO, norms as ``scale``/``bias``; SDXL's
    ``text_encoder_2`` and ``add_embedding`` convert like the rest, and the
    VAE with or without its encoder.  Leaves keep their kind (tensor or
    array) and dtype.  Another entry raises."""
    unknown = set(state_dicts) - set(_CONVERTERS)
    if unknown:
        raise ValueError(f'cannot convert {sorted(unknown)}')
    return {name: _module_to_jax(name, sd) for name, sd in state_dicts.items()}


#: ``daam_tpu``'s order of the modules in its host init (``:87-116``)
_INIT_ORDER = ('text_encoder', 'text_encoder_2', 'unet', 'vae')


def init_random_params(config: PipelineConfig, seed: int = 0,
                       dtype=torch.bfloat16) -> Dict[str, Any]:
    """``daam_tpu``'s random parameters, made again with numpy alone: the
    counterpart of ``daam_tpu.models.weights._init_random_params_host``
    (``:77-145``), equal to it bit for bit.  The key tree is
    :func:`to_jax_params` over :func:`build_modules`' shapes on the ``meta``
    device (the VAE's decode half, as ``vae.init(..., method=decode)``
    gives), walked as ``daam_tpu`` walks ``jax.eval_shape``'s tree: the
    modules in the order text encoder, SDXL's second text encoder, UNet,
    VAE, and every dict below them key-sorted.  One
    ``np.random.RandomState(seed & 0xFFFFFFFF)`` fills them: ``scale``
    leaves 1, other leaves of at most one dimension 0, and the rest
    N(0, fan_in^-½) with fan_in the product of all but the last axis of the
    flax shape, drawn in float64 and rounded to fp32, then cast to
    ``dtype``.  Leaves are CPU tensors; one leaf's draw at a time is held
    beside them (v2-1-base draws about 1.27 B normals, SDXL about 3.5 B).

    ``daam_tpu.init_random_params(dtype=float32)`` draws through
    ``jax.random`` instead, which this cannot match: equal fp32 weights on
    both sides are made by drawing in bfloat16 and casting up, here and
    there.  ``load_modules(config, from_jax_params(params), device=...)``
    builds the modules."""
    shapes = to_jax_params({name: module.state_dict() for name, module in
                            build_modules(config, device='meta').items()})
    rng = np.random.RandomState(seed & 0xFFFFFFFF)

    def fill(tree):
        out = {}
        for key in sorted(tree):
            leaf = tree[key]
            if isinstance(leaf, dict):
                out[key] = fill(leaf)
            elif key == 'scale':
                out[key] = torch.ones(leaf.shape, dtype=dtype)
            elif leaf.dim() <= 1:
                out[key] = torch.zeros(leaf.shape, dtype=dtype)
            else:
                fan_in = int(np.prod(leaf.shape[:-1])) or 1
                draw = rng.normal(0.0, (1.0 / fan_in) ** 0.5,
                                  size=tuple(leaf.shape)).astype(np.float32)
                out[key] = torch.from_numpy(draw).to(dtype)
                del draw
        return out

    return {name: fill(shapes[name]) for name in _INIT_ORDER if name in shapes}


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield '/'.join(prefix + (key,)), value


def param_sums(params: Dict[str, Any]) -> Dict[str, float]:
    """The float64 sum of each module's weights taken in fp32: each leaf
    summed by numpy in float64 (its pairwise order is fixed by the shape),
    the leaves' sums added exactly (``math.fsum``), so equal weights give
    equal sums on any machine and in any leaf order."""
    sums = {}
    for name, tree in params.items():
        leaf_sums = []
        for _, leaf in _flatten(tree):
            leaf = _host(leaf)
            if isinstance(leaf, torch.Tensor):
                leaf = leaf.float().numpy()
            leaf_sums.append(np.asarray(leaf, np.float32).astype(np.float64).sum())
        sums[name] = math.fsum(leaf_sums)
    return sums


#: numpy has no bfloat16: ``daam_tpu``'s ``save_params`` writes a bf16 leaf
#: as its raw 2-byte pattern (dtype ``V2``), and so does the port.
_BF16_NPZ = np.dtype('V2')


def save_params(params: Dict[str, Any], path) -> None:
    """Save a ``daam_tpu`` parameter tree (numpy arrays or host tensors) as
    one ``.npz`` of flat slash-joined keys, ``daam_tpu``'s format
    (``models/weights.py:160-166``).  A bfloat16 leaf is stored as
    ``daam_tpu.save_params`` stores one: its raw 16-bit patterns under the
    2-byte void dtype ``V2`` (numpy has no bfloat16); :func:`load_params`
    reads them back as bfloat16."""
    arrays = {}
    for key, leaf in _flatten(params):
        leaf = _host(leaf)
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            leaf = (leaf.view(torch.int16).numpy().view(_BF16_NPZ)
                    if leaf.dtype == torch.bfloat16 else leaf.numpy())
        arrays[key] = leaf
    np.savez(path, **arrays)


def load_params(path, dtype=None) -> Dict[str, Any]:
    """Load a tree saved by :func:`save_params` or ``daam_tpu``'s
    ``save_params``, as CPU tensors: ``V2`` leaves are bfloat16 bit
    patterns, the rest keep their numpy dtype.  ``dtype`` (a torch dtype)
    casts the floating leaves only, as ``daam_tpu``'s does (``:169-183``)."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for flat_key in data.files:
            arr = data[flat_key]
            if arr.dtype == _BF16_NPZ:
                leaf = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                leaf = torch.from_numpy(arr)
            if dtype is not None and leaf.is_floating_point():
                leaf = leaf.to(dtype)
            node = tree
            *parts, last = flat_key.split('/')
            for part in parts:
                node = node.setdefault(part, {})
            node[last] = leaf
    return tree


# --------------------------------------------------------------------------
# diffusers checkpoint directories
# --------------------------------------------------------------------------

#: safetensors dtype names → torch dtypes (little-endian data)
_SAFETENSORS_DTYPES = {
    'F64': torch.float64, 'F32': torch.float32, 'F16': torch.float16,
    'BF16': torch.bfloat16, 'I64': torch.int64, 'I32': torch.int32,
    'I16': torch.int16, 'I8': torch.int8, 'U8': torch.uint8, 'BOOL': torch.bool}


def read_safetensors(path) -> Dict[str, torch.Tensor]:
    """Every tensor of a ``.safetensors`` file, as CPU tensors over a
    copy-on-write memory map of it (no copy is made until a tensor is
    written or moved).  The format: an 8-byte little-endian header length,
    a JSON header of ``dtype``/``shape``/``data_offsets`` per tensor
    (``__metadata__`` skipped), then the raw little-endian data."""
    with open(path, 'rb') as f:
        (n,) = struct.unpack('<Q', f.read(8))
        header = json.loads(f.read(n))
        size = f.seek(0, 2)
        buf = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
               if size > 8 + n else None)
    tensors = {}
    for name, info in header.items():
        if name == '__metadata__':
            continue
        dtype = _SAFETENSORS_DTYPES[info['dtype']]
        shape = tuple(info['shape'])
        begin, end = (8 + n + o for o in info['data_offsets'])
        numel = int(np.prod(shape))
        if end - begin != numel * dtype.itemsize or end > size:
            raise ValueError(f'{path}: {name} has {end - begin} bytes at '
                             f'[{begin}, {end}) for {info["dtype"]} {list(shape)}')
        tensors[name] = (torch.frombuffer(buf, dtype=dtype, count=numel,
                                          offset=begin).reshape(shape)
                         if numel else torch.empty(shape, dtype=dtype))
    return tensors


def _read_state_dict(module_dir: Path) -> Dict[str, torch.Tensor]:
    """All tensors of one diffusers submodule directory: every
    ``*.safetensors`` in sorted order, else every ``*.bin`` (``torch.load``,
    ``weights_only=True``), else ``FileNotFoundError``
    (``daam_tpu/models/weights.py:189-208``)."""
    tensors: Dict[str, torch.Tensor] = {}
    files = sorted(module_dir.glob('*.safetensors'))
    for f in files:
        tensors.update(read_safetensors(f))
    if not files:
        files = sorted(module_dir.glob('*.bin'))
        for f in files:
            tensors.update(torch.load(str(f), map_location='cpu',
                                      weights_only=True))
    if not files:
        raise FileNotFoundError(f'no safetensors/bin weights in {module_dir}')
    return tensors


#: The CLIP keys ``daam_tpu``'s ``_convert_clip`` reads (``:250-285``);
#: it ignores any other (e.g. ``text_model.embeddings.position_ids``).
_CLIP_READ = re.compile(
    r'text_model\.(embeddings\.(token|position)_embedding\.weight'
    r'|encoder\.layers\.\d+\.(layer_norm[12]|self_attn\.[qkv]_proj'
    r'|self_attn\.out_proj|mlp\.fc[12])\.(weight|bias)'
    r'|final_layer_norm\.(weight|bias))|text_projection\.weight')
#: legacy names of the VAE mid-block attention (``:429-433``)
_VAE_LEGACY = {'query': 'to_q', 'key': 'to_k', 'value': 'to_v',
               'proj_attn': 'to_out.0'}
_VAE_ATTENTION = re.compile(
    r'((?:en|de)coder\.mid_block\.attentions\.0\.)'
    r'(query|key|value|proj_attn|to_q|to_k|to_v|to_out\.0)\.(weight|bias)')


def _normalize_keys(name: str, sd: Dict[str, torch.Tensor],
                    config: PipelineConfig) -> Dict[str, torch.Tensor]:
    """The checkpoint variants ``daam_tpu``'s converters accept, in the
    port's names: ``nin_shortcut`` for ``conv_shortcut`` (``:301-306``);
    the VAE attention's ``query/key/value/proj_attn`` and 1×1 conv weights
    (``:424-439``); a VAE without encoder keys, whose ``quant_conv`` is then
    unused (``:442-466``); CLIP keys ``_convert_clip`` never reads, and
    ``text_projection`` for an encoder without one.  Any other key is
    kept, so the strict load rejects it."""
    out: Dict[str, torch.Tensor] = {}
    if name.startswith('text_encoder'):
        text = config.text if name == 'text_encoder' else config.text_2
        for k in list(sd):
            v = sd.pop(k)
            if _CLIP_READ.fullmatch(k) and not (
                    k == 'text_projection.weight' and not text.projection_dim):
                out[k] = v
        return out
    has_encoder = any(k.startswith('encoder.') for k in sd)
    for k in list(sd):
        v = sd.pop(k)
        k = k.replace('.nin_shortcut.', '.conv_shortcut.')
        if name == 'vae':
            if k.startswith('quant_conv.') and not has_encoder:
                continue
            m = _VAE_ATTENTION.fullmatch(k)
            if m:
                prefix, proj, kind = m.groups()
                k = f'{prefix}{_VAE_LEGACY.get(proj, proj)}.{kind}'
                if v.ndim == 4:
                    v = v[:, :, 0, 0]
        out[k] = v
    return out


def _clip_config_from_json(cfg: dict) -> CLIPTextConfig:
    with_proj = any('WithProjection' in a
                    for a in (cfg.get('architectures') or []))
    return CLIPTextConfig(
        vocab_size=cfg.get('vocab_size', 49408),
        hidden_size=cfg.get('hidden_size', 768),
        intermediate_size=cfg.get('intermediate_size', 3072),
        num_hidden_layers=cfg.get('num_hidden_layers', 12),
        num_attention_heads=cfg.get('num_attention_heads', 12),
        max_position_embeddings=cfg.get('max_position_embeddings', 77),
        hidden_act=cfg.get('hidden_act', 'quick_gelu'),
        layer_norm_eps=cfg.get('layer_norm_eps', 1e-5),
        projection_dim=cfg.get('projection_dim') if with_proj else None)


def _norm(ucfg: UNetConfig) -> UNetConfig:
    """Transformer depth on plain (non-cross) levels is unused by the
    model; zero it so preset comparison ignores the convention difference
    (presets write 1, diffusers json may write either)."""
    return replace(ucfg, transformer_layers_per_block=tuple(
        t if d == 'cross' else 0
        for t, d in zip(ucfg.transformer_layers_per_block, ucfg.down_block_types)))


def _config_from_json(path: Path) -> PipelineConfig:
    """A :class:`PipelineConfig` from the checkpoint's own ``config.json``
    files (``daam_tpu/models/weights.py:514-608``).  Checkpoints matching a
    known preset return the preset object itself (its name and generation
    defaults); SD 2.1 is preferred over 2.0, which has its geometry."""
    u = json.loads((path / 'unet' / 'config.json').read_text())
    n = len(u['block_out_channels'])
    down = tuple('cross' if 'CrossAttn' in t else 'plain'
                 for t in u['down_block_types'])
    # diffusers up_block_types is in traversal order (deepest level first);
    # ours is per resolution level (finest first)
    up = tuple('cross' if 'CrossAttn' in t else 'plain'
               for t in reversed(u['up_block_types']))
    heads = u.get('attention_head_dim', 8)
    heads = tuple(heads) if isinstance(heads, list) else (heads,) * n
    tl = u.get('transformer_layers_per_block', 1)
    tl = tuple(tl) if isinstance(tl, list) else (tl,) * n
    tl = tuple(t if d == 'cross' else 0 for t, d in zip(tl, down))
    unet = UNetConfig(
        sample_size=u.get('sample_size', 64),
        in_channels=u.get('in_channels', 4),
        out_channels=u.get('out_channels', 4),
        block_out_channels=tuple(u['block_out_channels']),
        down_block_types=down,
        up_block_types=up,
        layers_per_block=u.get('layers_per_block', 2),
        attention_head_dim=heads,
        transformer_layers_per_block=tl,
        cross_attention_dim=u.get('cross_attention_dim', 768),
        use_linear_projection=u.get('use_linear_projection', False),
        norm_num_groups=u.get('norm_num_groups', 32),
        freq_shift=u.get('freq_shift', 0),
        flip_sin_to_cos=u.get('flip_sin_to_cos', True),
        mid_block_attn='CrossAttn' in (u.get('mid_block_type')
                                       or 'UNetMidBlock2DCrossAttn'),
        addition_embed_type=u.get('addition_embed_type'),
        addition_time_embed_dim=u.get('addition_time_embed_dim', 256),
        projection_class_embeddings_input_dim=u.get(
            'projection_class_embeddings_input_dim'))

    text = _clip_config_from_json(
        json.loads((path / 'text_encoder' / 'config.json').read_text()))
    text_2 = None
    if (path / 'text_encoder_2').exists():
        text_2 = _clip_config_from_json(json.loads(
            (path / 'text_encoder_2' / 'config.json').read_text()))

    v = json.loads((path / 'vae' / 'config.json').read_text())
    vae = VAEConfig(
        in_channels=v.get('in_channels', 3),
        out_channels=v.get('out_channels', 3),
        latent_channels=v.get('latent_channels', 4),
        block_out_channels=tuple(v.get('block_out_channels',
                                       (128, 256, 512, 512))),
        layers_per_block=v.get('layers_per_block', 2),
        norm_num_groups=v.get('norm_num_groups', 32),
        sample_size=v.get('sample_size', 512),
        scaling_factor=v.get('scaling_factor', 0.18215))

    prediction_type = 'epsilon'
    sched = path / 'scheduler' / 'scheduler_config.json'
    if sched.exists():
        prediction_type = json.loads(sched.read_text()).get(
            'prediction_type', 'epsilon')

    preferred = ('v2-1-base', 'v2-1-large')
    for preset_name in [*preferred, *(nm for nm in MODEL_PRESETS
                                      if nm not in preferred)]:
        preset = get_pipeline_config(preset_name)
        if (_norm(preset.unet) == _norm(unet) and preset.text == text
                and preset.text_2 == text_2 and preset.vae == vae
                and preset.prediction_type == prediction_type):
            return preset
    return PipelineConfig(name=path.name, text=text, text_2=text_2,
                          unet=unet, vae=vae, prediction_type=prediction_type,
                          is_sdxl=text_2 is not None)


def _detect_config(path: Path) -> PipelineConfig:
    """The config of a local diffusers directory: from its json configs
    when they are all present and well formed, else the geometry heuristic
    on the UNet's config alone (``daam_tpu/models/weights.py:611-631``)."""
    try:
        return _config_from_json(path)
    except (OSError, KeyError, ValueError, TypeError):
        pass  # missing or malformed config.json (JSONDecodeError: ValueError)
    unet_cfg = json.loads((path / 'unet' / 'config.json').read_text())
    if (path / 'text_encoder_2').exists():
        return get_pipeline_config('xl-base-1.0')
    if unet_cfg.get('cross_attention_dim', 768) == 768:
        return get_pipeline_config('v1')
    if unet_cfg.get('sample_size', 64) == 96:
        return get_pipeline_config('v2-1-large')
    return get_pipeline_config('v2-1-base')


def load_diffusers_checkpoint(path, device='cuda', dtype=torch.float32
                              ) -> Tuple[PipelineConfig, Dict[str, nn.Module], Any]:
    """A local diffusers directory → ``(config, modules, tokenizer)``, the
    modules on ``device`` (the card unless the caller names another;
    without one this raises) in ``dtype``.  One submodule is read at a time
    and its state dict released before the next is read; the tokenizer is
    the directory's own ``tokenizer/`` when it has one, else the bundled
    vocabulary."""
    from ..tokenization import default_tokenizer
    from ..utils import resolve_device

    device = resolve_device(device)
    path = Path(path)
    config = _detect_config(path)
    modules = {}
    for name in _module_names(config):
        sd = _normalize_keys(name, _read_state_dict(path / name), config)
        modules[name] = _load_module(name, config, sd, device, dtype)
        del sd
    return config, modules, default_tokenizer(path)
