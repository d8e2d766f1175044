"""UNet2DConditionModel — the denoiser, in PyTorch.

Counterpart of ``daam_tpu/models/unet.py``, grown from the torch modules that
``tests/test_weights_conversion.py`` strict-loads (``_TResnet``,
``_TAttention``, ``_TFeedForward``, ``_TTransformer2D``, ``_TTinyUNet``):

* NCHW feature maps and diffusers parameter names, so a diffusers
  ``unet/`` state dict loads with ``load_state_dict(strict=True)``.
* Every ``attn1`` and ``attn2`` runs through :mod:`daam_tpu_torch.ops.attention`
  on ``(B, L, H, hd)`` views of the projection outputs (no relayout copy);
  on a CUDA tensor that is the hand-written kernels of ``csrc/attention.cu``.
  Every feed-forward's gate runs through :mod:`daam_tpu_torch.ops.geglu`: on
  a CUDA tensor one pass of ``csrc/geglu.cu``.
* Tracing is an argument, as in ``daam_tpu``: with ``capture='acc'`` each
  cross-attention layer named in ``acc`` adds the conditional CFG half's Pᵀ
  into its fp32 accumulator ``(B, H, 77, h·w)``, in place; with
  ``capture='full'``/``'cond'`` every cross-attention layer, the mid
  block's included, hands back its probabilities ``(B, H, h·w, 77)``; a
  ``replay`` dict of such probabilities replaces the computed ones (the
  ``load_heads`` transplant).

* SDXL's ``text_time`` conditioning (``addition_embed_type='text_time'``):
  ``add_embedding`` maps the pooled text embedding and the sinusoids of the
  six size/crop ids into the time embedding (``daam_tpu`` ``:402-411``).

Numerics copied from ``daam_tpu``: exact-erf GEGLU in fp32, GroupNorm eps
1e-5 in resnets and 1e-6 in ``Transformer2DModel``, LayerNorm eps 1e-6 in the
transformer blocks (flax's default; diffusers uses 1e-5), ``conv_out`` in
fp32, the sinusoidal embeddings in fp32 with ``flip_sin_to_cos``, nearest-2×
upsample.
"""

import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import cross_attention, flash_attention
from ..ops.geglu import geglu
from ..profiling import span
from .configs import UNetConfig

# the blocks' span names, made once rather than at every evaluation
_DOWN_SPANS = tuple(f'unet.down.{k}' for k in range(8))
_UP_SPANS = tuple(f'unet.up.{k}' for k in range(8))

__all__ = ['UNet2DConditionModel', 'ResnetBlock2D', 'timestep_embedding']


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True, freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, fp32 (``daam_tpu`` ``:38-51``)."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        out = F.pad(out, (0, 1))
    return out


class TimestepEmbedding(nn.Module):
    def __init__(self, cin: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock2D(nn.Module):
    """diffusers ResnetBlock2D (GroupNorm eps per caller; optional time
    embedding — the VAE's blocks have none)."""

    def __init__(self, cin: int, cout: int, groups: int,
                 temb_channels: Optional[int] = None, eps: float = 1e-5):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, cin, eps=eps)
        self.conv1 = nn.Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = (nn.Linear(temb_channels, cout)
                              if temb_channels is not None else None)
        self.norm2 = nn.GroupNorm(groups, cout, eps=eps)
        self.conv2 = nn.Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = nn.Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, temb=None):
        h = self.conv1(F.silu(self.norm1(x)))
        if self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        sc = x if self.conv_shortcut is None else self.conv_shortcut(x)
        return sc + h


class Attention(nn.Module):
    """Multi-head attention over flattened spatial tokens; ``is_cross``
    selects the text cross-attention with the capture and replay contract
    of :func:`~daam_tpu_torch.ops.attention.cross_attention`."""

    def __init__(self, dim: int, kdim: int, heads: int, is_cross: bool):
        super().__init__()
        self.heads = heads
        self.is_cross = is_cross
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(kdim, dim, bias=False)
        self.to_v = nn.Linear(kdim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])

    def forward(self, x, context=None, capture=False,
                acc: Optional[torch.Tensor] = None,
                replay_probs: Optional[torch.Tensor] = None):
        """Returns ``(out, probs)``; ``probs`` is None unless the capture
        is ``'cond'``/``'full'``."""
        context = x if context is None else context
        # (B, L, H·hd) projections viewed as (B, L, H, hd): the kernels take
        # them through their strides and write (B, L, H·hd) for to_out.
        q = self.to_q(x).unflatten(-1, (self.heads, -1))
        k = self.to_k(context).unflatten(-1, (self.heads, -1))
        v = self.to_v(context).unflatten(-1, (self.heads, -1))
        probs = None
        if not self.is_cross:
            out = flash_attention(q, k, v)
        elif capture in ('cond', 'full', True):
            out, probs = cross_attention(q, k, v, capture=capture,
                                         replay_probs=replay_probs)
        else:
            out = cross_attention(q, k, v, capture=capture,
                                  replay_probs=replay_probs, acc=acc)
        return self.to_out[0](out), probs


class FeedForward(nn.Module):
    """diffusers GEGLU feed-forward (``ff.net.0.proj`` / ``ff.net.2``); the
    gate's gelu is the exact erf form, evaluated in fp32
    (:func:`~daam_tpu_torch.ops.geglu.geglu`)."""

    def __init__(self, dim: int):
        super().__init__()
        geglu = nn.Module()
        geglu.proj = nn.Linear(dim, 8 * dim)
        self.net = nn.ModuleList([geglu, nn.Identity(),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](geglu(self.net[0].proj(x)))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, kdim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(dim, dim, heads, is_cross=False)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = Attention(dim, kdim, heads, is_cross=True)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x, context, capture=False, acc=None, replay_probs=None):
        x = x + self.attn1(self.norm1(x))[0]
        h, probs = self.attn2(self.norm2(x), context, capture=capture, acc=acc,
                              replay_probs=replay_probs)
        x = x + h
        return x + self.ff(self.norm3(x)), probs


class Transformer2DModel(nn.Module):
    """Spatial transformer: flatten HW, run the text-conditioned blocks,
    unflatten.  ``layer_names`` are the capture keys of its blocks
    (``daam_tpu``'s ``name_prefix`` scheme)."""

    def __init__(self, dim: int, kdim: int, heads: int, depth: int,
                 groups: int, use_linear: bool, name: str):
        super().__init__()
        self.use_linear = use_linear
        self.layer_names = ([f'{name}.{d}' for d in range(depth)]
                            if depth > 1 else [name])
        self.norm = nn.GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = (nn.Linear(dim, dim) if use_linear
                        else nn.Conv2d(dim, dim, 1))
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, kdim, heads) for _ in range(depth)])
        self.proj_out = (nn.Linear(dim, dim) if use_linear
                         else nn.Conv2d(dim, dim, 1))

    def forward(self, x, context, capture=False,
                acc: Optional[Dict[str, torch.Tensor]] = None,
                replay: Optional[Dict[str, torch.Tensor]] = None,
                probs_out: Optional[Dict[str, torch.Tensor]] = None):
        """``probs_out`` receives each block's probabilities under
        ``capture='cond'``/``'full'``."""
        B, C, H, W = x.shape
        residual = x
        h = self.norm(x)
        if self.use_linear:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, H * W, C))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(B, H * W, C)
        for name, blk in zip(self.layer_names, self.transformer_blocks):
            layer_acc = acc.get(name) if acc else None
            # Under 'acc', layers outside the capture plan (no accumulator)
            # run uncaptured but still take their replay rows, as daam_tpu's
            # do (models/unet.py:265-276).
            layer_capture = capture
            if capture == 'acc' and layer_acc is None:
                layer_capture = False
            h, probs = blk(h, context, capture=layer_capture, acc=layer_acc,
                           replay_probs=replay.get(name) if replay else None)
            if probs is not None and probs_out is not None:
                probs_out[name] = probs
        if self.use_linear:
            h = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(B, H, W, C).permute(0, 3, 1, 2))
        return h + residual


class UNet2DConditionModel(nn.Module):
    """SD 1.x/2.x and SDXL conditional UNet."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        if config.addition_embed_type not in (None, 'text_time'):
            raise ValueError(
                f'addition_embed_type={config.addition_embed_type!r} is not '
                f'supported')
        self.config = config
        cfg = config
        ch = cfg.block_out_channels
        g = cfg.norm_num_groups
        ted = cfg.time_embed_dim
        ctx = cfg.cross_attention_dim
        n = len(ch)

        def transformer(level, name, depth):
            return Transformer2DModel(ch[level], ctx, cfg.attention_head_dim[level],
                                      depth, g, cfg.use_linear_projection, name)

        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], ted)
        if cfg.addition_embed_type == 'text_time':
            self.add_embedding = TimestepEmbedding(
                cfg.projection_class_embeddings_input_dim, ted)

        self.down_blocks = nn.ModuleList()
        for level in range(n):
            blk = nn.Module()
            cin = ch[level - 1] if level else ch[0]
            blk.resnets = nn.ModuleList(
                [ResnetBlock2D(cin if i == 0 else ch[level], ch[level], g, ted)
                 for i in range(cfg.layers_per_block)])
            depth = cfg.transformer_layers_per_block[level]
            if cfg.down_block_types[level] == 'cross' and depth > 0:
                blk.attentions = nn.ModuleList(
                    [transformer(level, f'down_{level}_{i}', depth)
                     for i in range(cfg.layers_per_block)])
            if level < n - 1:
                ds = nn.Module()
                ds.conv = nn.Conv2d(ch[level], ch[level], 3, stride=2, padding=1)
                blk.downsamplers = nn.ModuleList([ds])
            self.down_blocks.append(blk)

        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock2D(ch[-1], ch[-1], g, ted),
             ResnetBlock2D(ch[-1], ch[-1], g, ted)])
        if cfg.mid_block_attn:
            self.mid_block.attentions = nn.ModuleList(
                [transformer(n - 1, 'mid_0',
                             max(cfg.transformer_layers_per_block[-1], 1))])

        skip_chs = [ch[0]]
        for level in range(n):
            skip_chs += [ch[level]] * cfg.layers_per_block
            if level < n - 1:
                skip_chs.append(ch[level])
        self.up_blocks = nn.ModuleList()
        prev = ch[-1]
        for j in range(n):
            level = n - 1 - j  # diffusers up_blocks run deepest level first
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            depth = cfg.transformer_layers_per_block[level]
            cross = cfg.up_block_types[level] == 'cross' and depth > 0
            attns = []
            for i in range(cfg.layers_per_block + 1):
                blk.resnets.append(
                    ResnetBlock2D(prev + skip_chs.pop(), ch[level], g, ted))
                prev = ch[level]
                if cross:
                    attns.append(transformer(level, f'up_{level}_{i}', depth))
            if attns:
                blk.attentions = nn.ModuleList(attns)
            if level > 0:
                us = nn.Module()
                us.conv = nn.Conv2d(ch[level], ch[level], 3, padding=1)
                blk.upsamplers = nn.ModuleList([us])
            self.up_blocks.append(blk)

        self.conv_norm_out = nn.GroupNorm(g, ch[0], eps=1e-5)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def layer_names(self) -> List[str]:
        """Capture keys of every cross-attention layer, in module order."""
        return [name for m in self.modules() if isinstance(m, Transformer2DModel)
                for name in m.layer_names]

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor,
                added_cond: Optional[Dict[str, torch.Tensor]] = None,
                capture=False, acc: Optional[Dict[str, torch.Tensor]] = None,
                replay: Optional[Dict[str, torch.Tensor]] = None):
        """Denoise ``sample`` (B, C, h, w); returns the fp32 prediction.

        The batch is the CFG layout ``[uncond; cond]``.  SDXL's UNet needs
        ``added_cond``: ``{'text_embeds': (B, pooled), 'time_ids': (B, 6)}``.
        With ``capture='acc'``, ``acc`` maps layer names to fp32 accumulators
        ``(B/2, H, 77, h·w)`` that are updated in place.  With
        ``capture='full'`` (or ``'cond'``) it returns ``(eps, probs)``:
        ``probs`` maps every cross-attention layer's name to its
        probabilities ``(B, H, h·w, 77)`` (fp32; bf16 and defined for the
        conditional half only under ``'cond'``).  ``replay`` maps layer
        names to such probabilities, which replace the computed ones.
        """
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        B = sample.shape[0]
        if timesteps.dim() == 0:
            timesteps = timesteps[None]
        temb = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                  cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(temb.expand(B, -1).to(dtype))
        if cfg.addition_embed_type == 'text_time':
            if added_cond is None:
                raise ValueError('SDXL needs added_cond (text_embeds, time_ids)')
            tid = timestep_embedding(added_cond['time_ids'].flatten(),
                                     cfg.addition_time_embed_dim,
                                     cfg.flip_sin_to_cos, cfg.freq_shift)
            add = torch.cat([added_cond['text_embeds'].float(),
                             tid.reshape(B, -1)], dim=-1)
            temb = temb + self.add_embedding(add.to(dtype))
        context = encoder_hidden_states.to(dtype)
        probs_out: Dict[str, torch.Tensor] = {}

        def attend(blk, i, h):
            if hasattr(blk, 'attentions'):
                h = blk.attentions[i](h, context, capture=capture, acc=acc,
                                      replay=replay, probs_out=probs_out)
            return h

        h = self.conv_in(sample.to(dtype))
        skips = [h]
        for k, blk in enumerate(self.down_blocks):
            with span(_DOWN_SPANS[k]):
                for i, res in enumerate(blk.resnets):
                    h = attend(blk, i, res(h, temb))
                    skips.append(h)
                if hasattr(blk, 'downsamplers'):
                    h = blk.downsamplers[0].conv(h)
                    skips.append(h)

        with span('unet.mid'):
            h = self.mid_block.resnets[0](h, temb)
            h = attend(self.mid_block, 0, h)
            h = self.mid_block.resnets[1](h, temb)

        for k, blk in enumerate(self.up_blocks):
            with span(_UP_SPANS[k]):
                for i, res in enumerate(blk.resnets):
                    h = attend(blk, i, res(torch.cat([h, skips.pop()], dim=1), temb))
                if hasattr(blk, 'upsamplers'):
                    h = F.interpolate(h, scale_factor=2, mode='nearest')
                    h = blk.upsamplers[0].conv(h)

        h = F.silu(self.conv_norm_out(h))
        w = self.conv_out
        eps = F.conv2d(h.float(), w.weight.float(), w.bias.float(), padding=1)
        return (eps, probs_out) if capture in ('cond', 'full', True) else eps
