"""AutoencoderKL — pixels to latents and back, in PyTorch (NCHW).

Counterpart of ``daam_tpu/models/vae.py`` with diffusers parameter names:
the encoder (``encoder.…``, ``quant_conv.…``) and the decoder
(``post_quant_conv.…``, ``decoder.…``).  Downsampling pads the bottom and
right edges by one and runs a stride-2 unpadded conv (``:79-83``); the
encoder's ``conv_out`` gives ``2·latent_channels`` channels, the mean and
log-variance of :class:`DiagonalGaussian`.  The mid-block attention of both
halves is single-head plain torch, as ``daam_tpu`` computes it with
``einsum`` (``:59-61``).  The decoder's ``conv_out`` runs in fp32 like
``daam_tpu``'s.  ``AutoencoderKL(config, with_encoder=False)`` is the
decode half alone: what a checkpoint whose ``vae/`` holds no encoder
weights loads into.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .configs import VAEConfig
from .unet import ResnetBlock2D

__all__ = ['AutoencoderKL', 'DiagonalGaussian']


class VAEAttentionBlock(nn.Module):
    """Single-head spatial self-attention (SD VAE mid block)."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, c, eps=1e-6)
        self.to_q = nn.Linear(c, c)
        self.to_k = nn.Linear(c, c)
        self.to_v = nn.Linear(c, c)
        self.to_out = nn.ModuleList([nn.Linear(c, c)])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = self.to_q(h), self.to_k(h), self.to_v(h)
        scores = (q @ k.transpose(-1, -2)) * C ** -0.5
        probs = scores.float().softmax(dim=-1).to(x.dtype)
        h = self.to_out[0](probs @ v)
        return x + h.reshape(B, H, W, C).permute(0, 3, 1, 2)


def _mid_block(c: int, groups: int) -> nn.Module:
    mid = nn.Module()
    mid.resnets = nn.ModuleList([ResnetBlock2D(c, c, groups, eps=1e-6),
                                 ResnetBlock2D(c, c, groups, eps=1e-6)])
    mid.attentions = nn.ModuleList([VAEAttentionBlock(c, groups)])
    return mid


def _run_mid_block(mid: nn.Module, h):
    h = mid.resnets[0](h)
    h = mid.attentions[0](h)
    return mid.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        g = cfg.norm_num_groups
        self.conv_in = nn.Conv2d(cfg.in_channels, ch[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = ch[0]
        for level, c in enumerate(ch):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block):
                blk.resnets.append(ResnetBlock2D(prev, c, g, eps=1e-6))
                prev = c
            if level < len(ch) - 1:
                ds = nn.Module()
                ds.conv = nn.Conv2d(c, c, 3, stride=2)
                blk.downsamplers = nn.ModuleList([ds])
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(ch[-1], g)
        self.conv_norm_out = nn.GroupNorm(g, ch[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, 'downsamplers'):
                # asymmetric (0, 1) padding, then the stride-2 unpadded conv
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = _run_mid_block(self.mid_block, h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        ch = cfg.block_out_channels
        g = cfg.norm_num_groups
        n = len(ch)
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch[-1], 3, padding=1)
        self.mid_block = _mid_block(ch[-1], g)
        self.up_blocks = nn.ModuleList()
        prev = ch[-1]
        for j in range(n):
            level = n - 1 - j  # diffusers decoder up_blocks: deepest first
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg.layers_per_block + 1):
                blk.resnets.append(ResnetBlock2D(prev, ch[level], g, eps=1e-6))
                prev = ch[level]
            if level > 0:
                us = nn.Module()
                us.conv = nn.Conv2d(ch[level], ch[level], 3, padding=1)
                blk.upsamplers = nn.ModuleList([us])
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(g, ch[0], eps=1e-6)
        self.conv_out = nn.Conv2d(ch[0], cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = _run_mid_block(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, 'upsamplers'):
                h = F.interpolate(h, scale_factor=2, mode='nearest')
                h = blk.upsamplers[0].conv(h)
        h = F.silu(self.conv_norm_out(h))
        w = self.conv_out
        return F.conv2d(h.float(), w.weight.float(), w.bias.float(), padding=1)


class DiagonalGaussian:
    """Posterior q(z|x) from the encoder's (mean, logvar) channels, logvar
    clamped to [-30, 20] (``daam_tpu/models/vae.py:135-147``)."""

    def __init__(self, params: torch.Tensor):
        self.mean, logvar = params.chunk(2, dim=1)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """``mean + std·ε``, ε drawn from ``generator`` on its device."""
        noise = torch.randn(self.mean.shape, generator=generator,
                            device=generator.device, dtype=self.mean.dtype)
        return self.mean + self.std * noise.to(self.mean.device)

    def mode(self) -> torch.Tensor:
        return self.mean


class AutoencoderKL(nn.Module):
    """The SD VAE; ``with_encoder=False`` builds the decode half alone."""

    def __init__(self, config: VAEConfig, with_encoder: bool = True):
        super().__init__()
        self.config = config
        self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                         config.latent_channels, 1)
        self.decoder = Decoder(config)
        # registered after the decoder: init_random draws the decoder's
        # weights first, with or without an encoder
        self.encoder: Optional[Encoder] = None
        self.quant_conv: Optional[nn.Conv2d] = None
        if with_encoder:
            self.encoder = Encoder(config)
            self.quant_conv = nn.Conv2d(2 * config.latent_channels,
                                        2 * config.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        """Pixels (B, 3, H, W) in about [-1, 1] → the posterior over latents
        (B, 4, H/8, W/8), unscaled (multiply by ``scaling_factor`` for the
        UNet)."""
        if self.encoder is None:
            raise RuntimeError('this VAE has no encoder: its checkpoint held '
                               'no encoder weights')
        dtype = self.quant_conv.weight.dtype
        return DiagonalGaussian(self.quant_conv(self.encoder(x.to(dtype))))

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents (B, 4, h, w) → fp32 pixels (B, 3, H, W) in about [-1, 1]."""
        dtype = self.post_quant_conv.weight.dtype
        return self.decoder(self.post_quant_conv(z.to(dtype)))

    def forward(self, x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        """Encode, sample the posterior with ``generator``, decode."""
        return self.decode(self.encode(x).sample(generator))
