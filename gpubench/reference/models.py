"""The plain reference models: CLIP text encoder, SD/SDXL UNet, VAE decoder.

Frozen copies of the published architectures in plain PyTorch, with the
diffusers parameter names (so one state dict loads into the program and
here), written from the configuration file's sizes.  Attention
materializes P = softmax(q kᵀ/√hd) in float32, a block of queries at a time,
so that it fits; no fused kernel is used.  The text cross-attention takes a
:class:`Capture` that says what to do with P: add the conditional half's
Pᵀ into a per-layer accumulator (DAAM's capture), hand every row of P out
(the save run of the attention transplant), or replace P by given rows
(the load run).  Imports nothing of the program.
"""

import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

#: Queries per block of the materialized attention.
QUERY_BLOCK = 1024


class Capture:
    """What the cross-attention layers do with their probabilities in one
    UNet evaluation.  ``acc``: layer name -> fp32 accumulator (B/2, H, 77,
    h·w) that receives the conditional half's Pᵀ; ``probs``: filled with
    every layer's P (B, H, h·w, 77) when ``save`` is set; ``replay``: layer
    name -> P that replaces the computed one."""

    def __init__(self, acc=None, save: bool = False, replay=None):
        self.acc = acc or {}
        self.save = save
        self.replay = replay
        self.probs: Dict[str, torch.Tensor] = {}


def attention(q, k, v, capture: Optional[Capture] = None,
              name: Optional[str] = None, counter=None):
    """softmax(q kᵀ/√hd) v over (B, L, H, hd) tensors → (B, Lq, H·hd), with
    P in float32 materialized a block of queries at a time."""
    B, Lq, H, hd = q.shape
    Lk = k.shape[1]
    replay = capture.replay.get(name) if capture and capture.replay else None
    if counter is not None:  # QKᵀ and PV; PV alone where P is replayed
        counter((2 if replay is not None else 4) * B * H * Lq * Lk * hd)
    if q.device.type == 'meta':  # shape-only pass of the counters
        return q.new_empty(B, Lq, H * hd)
    acc = capture.acc.get(name) if capture else None
    save = capture is not None and capture.save and name is not None
    out = q.new_empty(B, Lq, H, hd)
    saved = (torch.empty(B, H, Lq, Lk, dtype=torch.float32, device=q.device)
             if save else None)
    kf = k.float()
    for s in range(0, Lq, QUERY_BLOCK):
        e = min(Lq, s + QUERY_BLOCK)
        if replay is not None:
            p = replay[:, :, s:e].to(device=q.device, dtype=torch.float32)
        else:
            scores = torch.einsum('bqhd,bkhd->bhqk', q[:, s:e].float(), kf)
            p = (scores * hd ** -0.5).softmax(dim=-1)
        out[:, s:e] = torch.einsum('bhqk,bkhd->bqhd', p.to(v.dtype), v)
        if acc is not None:
            acc[:, :, :, s:e] += p[B // 2:].transpose(2, 3)
        if save:
            saved[:, :, s:e] = p
    if save:
        capture.probs[name] = saved
    return out.flatten(2)


class ResnetBlock2D(nn.Module):
    def __init__(self, cin, cout, groups, temb_channels=None, eps=1e-5):
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
        return (x if self.conv_shortcut is None else self.conv_shortcut(x)) + h


class Attention(nn.Module):
    def __init__(self, dim, kdim, heads, name=None):
        super().__init__()
        self.heads, self.name = heads, name
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(kdim, dim, bias=False)
        self.to_v = nn.Linear(kdim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim)])
        self.counter = None
        #: rounds q, k and v before the products (the control's float8)
        self.round_operands = None

    def forward(self, x, context=None, capture=None):
        context = x if context is None else context
        q = self.to_q(x).unflatten(-1, (self.heads, -1))
        k = self.to_k(context).unflatten(-1, (self.heads, -1))
        v = self.to_v(context).unflatten(-1, (self.heads, -1))
        if self.round_operands is not None:
            q, k, v = (self.round_operands(t) for t in (q, k, v))
        return self.to_out[0](attention(q, k, v, capture, self.name, self.counter))


class FeedForward(nn.Module):
    """GEGLU with the exact erf gelu in float32."""

    def __init__(self, dim):
        super().__init__()
        geglu = nn.Module()
        geglu.proj = nn.Linear(dim, 8 * dim)
        self.net = nn.ModuleList([geglu, nn.Identity(), nn.Linear(4 * dim, dim)])

    def forward(self, x):
        h, gate = self.net[0].proj(x).chunk(2, dim=-1)
        return self.net[2](h * F.gelu(gate.float()).to(h.dtype))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim, kdim, heads, name):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(dim, dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = Attention(dim, kdim, heads, name)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x, context, capture):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context, capture)
        return x + self.ff(self.norm3(x))


class Transformer2DModel(nn.Module):
    def __init__(self, dim, kdim, heads, depth, groups, use_linear, name):
        super().__init__()
        self.use_linear = use_linear
        names = [f'{name}.{d}' for d in range(depth)] if depth > 1 else [name]
        self.norm = nn.GroupNorm(groups, dim, eps=1e-6)
        self.proj_in = nn.Linear(dim, dim) if use_linear else nn.Conv2d(dim, dim, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(dim, kdim, heads, n) for n in names])
        self.proj_out = nn.Linear(dim, dim) if use_linear else nn.Conv2d(dim, dim, 1)

    def forward(self, x, context, capture):
        B, C, H, W = x.shape
        h = self.norm(x)
        if self.use_linear:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, H * W, C))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(B, H * W, C)
        for blk in self.transformer_blocks:
            h = blk(h, context, capture)
        if self.use_linear:
            h = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(B, H, W, C).permute(0, 3, 1, 2))
        return h + x


def timestep_embedding(t, dim, flip_sin_to_cos=True, freq_shift=0.0):
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                 device=t.device) / (half - freq_shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    out = torch.cat([emb.cos(), emb.sin()] if flip_sin_to_cos
                    else [emb.sin(), emb.cos()], dim=-1)
    return F.pad(out, (0, 1)) if dim % 2 else out


class TimestepEmbedding(nn.Module):
    def __init__(self, cin, dim):
        super().__init__()
        self.linear_1 = nn.Linear(cin, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class UNet(nn.Module):
    """The conditional UNet of SD 1.x/2.x and SDXL, from the ``unet`` group
    of a configuration file.  ``attention_head_dim`` holds the heads per
    level, as the SD 2.x and SDXL configs do."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        ch = cfg['block_out_channels']
        g = cfg['norm_num_groups']
        ted = ch[0] * 4
        ctx = cfg['cross_attention_dim']
        n = len(ch)
        depth = cfg['transformer_layers_per_block']

        def transformer(level, name, d):
            return Transformer2DModel(ch[level], ctx, cfg['attention_head_dim'][level],
                                      d, g, cfg['use_linear_projection'], name)

        self.conv_in = nn.Conv2d(cfg['in_channels'], ch[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch[0], ted)
        if cfg.get('addition_embed_type') == 'text_time':
            self.add_embedding = TimestepEmbedding(
                cfg['projection_class_embeddings_input_dim'], ted)
        self.down_blocks = nn.ModuleList()
        for level in range(n):
            blk = nn.Module()
            cin = ch[level - 1] if level else ch[0]
            blk.resnets = nn.ModuleList(
                [ResnetBlock2D(cin if i == 0 else ch[level], ch[level], g, ted)
                 for i in range(cfg['layers_per_block'])])
            if cfg['down_block_types'][level] == 'cross' and depth[level] > 0:
                blk.attentions = nn.ModuleList(
                    [transformer(level, f'down_{level}_{i}', depth[level])
                     for i in range(cfg['layers_per_block'])])
            if level < n - 1:
                ds = nn.Module()
                ds.conv = nn.Conv2d(ch[level], ch[level], 3, stride=2, padding=1)
                blk.downsamplers = nn.ModuleList([ds])
            self.down_blocks.append(blk)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock2D(ch[-1], ch[-1], g, ted), ResnetBlock2D(ch[-1], ch[-1], g, ted)])
        self.mid_block.attentions = nn.ModuleList(
            [transformer(n - 1, 'mid_0', max(depth[-1], 1))])
        skip = [ch[0]]
        for level in range(n):
            skip += [ch[level]] * cfg['layers_per_block']
            if level < n - 1:
                skip.append(ch[level])
        self.up_blocks = nn.ModuleList()
        prev = ch[-1]
        for level in reversed(range(n)):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            cross = cfg['up_block_types'][level] == 'cross' and depth[level] > 0
            attns = []
            for i in range(cfg['layers_per_block'] + 1):
                blk.resnets.append(ResnetBlock2D(prev + skip.pop(), ch[level], g, ted))
                prev = ch[level]
                if cross:
                    attns.append(transformer(level, f'up_{level}_{i}', depth[level]))
            if attns:
                blk.attentions = nn.ModuleList(attns)
            if level > 0:
                us = nn.Module()
                us.conv = nn.Conv2d(ch[level], ch[level], 3, padding=1)
                blk.upsamplers = nn.ModuleList([us])
            self.up_blocks.append(blk)
        self.conv_norm_out = nn.GroupNorm(g, ch[0], eps=1e-5)
        self.conv_out = nn.Conv2d(ch[0], cfg['out_channels'], 3, padding=1)

    def forward(self, sample, t, context, added=None, capture=None):
        """Noise prediction (float32) of the CFG batch ``[uncond; cond]``."""
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        B = sample.shape[0]
        temb = timestep_embedding(t.expand(B), cfg['block_out_channels'][0])
        temb = self.time_embedding(temb.to(dtype))
        if cfg.get('addition_embed_type') == 'text_time':
            tid = timestep_embedding(added['time_ids'].flatten(),
                                     cfg['addition_time_embed_dim'])
            add = torch.cat([added['text_embeds'].float(), tid.reshape(B, -1)], dim=-1)
            temb = temb + self.add_embedding(add.to(dtype))
        context = context.to(dtype)

        def attend(blk, i, h):
            return blk.attentions[i](h, context, capture) if hasattr(blk, 'attentions') else h

        h = self.conv_in(sample.to(dtype))
        skips = [h]
        for blk in self.down_blocks:
            for i, res in enumerate(blk.resnets):
                h = attend(blk, i, res(h, temb))
                skips.append(h)
            if hasattr(blk, 'downsamplers'):
                h = blk.downsamplers[0].conv(h)
                skips.append(h)
        h = self.mid_block.resnets[0](h, temb)
        h = attend(self.mid_block, 0, h)
        h = self.mid_block.resnets[1](h, temb)
        for blk in self.up_blocks:
            for i, res in enumerate(blk.resnets):
                h = attend(blk, i, res(torch.cat([h, skips.pop()], dim=1), temb))
            if hasattr(blk, 'upsamplers'):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2, mode='nearest'))
        h = F.silu(self.conv_norm_out(h))
        w = self.conv_out
        return F.conv2d(h.float(), w.weight.float(), w.bias.float(), padding=1)


def _activation(name):
    if name == 'quick_gelu':
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name == 'gelu':
        return F.gelu
    raise ValueError(f'unknown hidden_act {name!r}')


class CLIPTextModel(nn.Module):
    """Pre-LN text transformer with a causal mask; ``forward`` gives
    (final-LN states or the penultimate layer's input, pooled output at the
    end-of-text token, projected where the config has a projection)."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        d, eps = cfg['hidden_size'], cfg['layer_norm_eps']
        self.act = _activation(cfg['hidden_act'])
        tm = self.text_model = nn.Module()
        tm.embeddings = nn.Module()
        tm.embeddings.token_embedding = nn.Embedding(cfg['vocab_size'], d)
        tm.embeddings.position_embedding = nn.Embedding(cfg['max_position_embeddings'], d)
        tm.encoder = nn.Module()
        tm.encoder.layers = nn.ModuleList()
        for _ in range(cfg['num_hidden_layers']):
            layer = nn.Module()
            layer.self_attn = nn.Module()
            for p in ('q_proj', 'k_proj', 'v_proj', 'out_proj'):
                setattr(layer.self_attn, p, nn.Linear(d, d))
            layer.layer_norm1 = nn.LayerNorm(d, eps=eps)
            layer.mlp = nn.Module()
            layer.mlp.fc1 = nn.Linear(d, cfg['intermediate_size'])
            layer.mlp.fc2 = nn.Linear(cfg['intermediate_size'], d)
            layer.layer_norm2 = nn.LayerNorm(d, eps=eps)
            tm.encoder.layers.append(layer)
        tm.final_layer_norm = nn.LayerNorm(d, eps=eps)
        self.text_projection = (nn.Linear(d, cfg['projection_dim'], bias=False)
                                if cfg.get('projection_dim') else None)
        self.counter = None

    def _attend(self, a, x, mask):
        B, T, d = x.shape
        heads = self.cfg['num_attention_heads']
        hd = d // heads

        def split(t):
            return t.view(B, T, heads, hd).transpose(1, 2)

        q, k, v = split(a.q_proj(x)), split(a.k_proj(x)), split(a.v_proj(x))
        if self.counter is not None:
            self.counter(4 * B * heads * T * T * hd)
        scores = ((q @ k.transpose(-1, -2)) * hd ** -0.5).float()
        probs = scores.masked_fill(mask, float('-inf')).softmax(dim=-1).to(x.dtype)
        return a.out_proj((probs @ v).transpose(1, 2).reshape(B, T, d))

    def forward(self, ids, penultimate=False):
        tm = self.text_model
        B, T = ids.shape
        x = tm.embeddings.token_embedding(ids) + tm.embeddings.position_embedding.weight[:T]
        mask = torch.ones(T, T, dtype=torch.bool, device=ids.device).triu(1)
        states = []
        for layer in tm.encoder.layers:
            states.append(x)
            x = x + self._attend(layer.self_attn, layer.layer_norm1(x), mask)
            x = x + layer.mlp.fc2(self.act(layer.mlp.fc1(layer.layer_norm2(x))))
        final = tm.final_layer_norm(x)
        eos = (ids == 49407).int().argmax(dim=-1)
        pooled = final[torch.arange(B, device=ids.device), eos]
        if self.text_projection is not None:
            pooled = self.text_projection(pooled)
        return (states[-1] if penultimate else final), pooled


class VAEDecoder(nn.Module):
    """The decode half of the SD VAE: ``post_quant_conv`` and ``decoder``;
    latents (B, 4, h, w) → pixels (B, 3, 8h, 8w) in about [-1, 1], float32."""

    def __init__(self, cfg: dict):
        super().__init__()
        ch, g, n = cfg['block_out_channels'], cfg['norm_num_groups'], len(cfg['block_out_channels'])
        lat = cfg['latent_channels']
        self.post_quant_conv = nn.Conv2d(lat, lat, 1)
        dec = self.decoder = nn.Module()
        dec.conv_in = nn.Conv2d(lat, ch[-1], 3, padding=1)
        dec.mid_block = nn.Module()
        dec.mid_block.resnets = nn.ModuleList(
            [ResnetBlock2D(ch[-1], ch[-1], g, eps=1e-6) for _ in range(2)])
        att = nn.Module()
        att.group_norm = nn.GroupNorm(g, ch[-1], eps=1e-6)
        for p in ('to_q', 'to_k', 'to_v'):
            setattr(att, p, nn.Linear(ch[-1], ch[-1]))
        att.to_out = nn.ModuleList([nn.Linear(ch[-1], ch[-1])])
        dec.mid_block.attentions = nn.ModuleList([att])
        dec.up_blocks = nn.ModuleList()
        prev = ch[-1]
        for level in reversed(range(n)):
            blk = nn.Module()
            blk.resnets = nn.ModuleList()
            for _ in range(cfg['layers_per_block'] + 1):
                blk.resnets.append(ResnetBlock2D(prev, ch[level], g, eps=1e-6))
                prev = ch[level]
            if level > 0:
                us = nn.Module()
                us.conv = nn.Conv2d(ch[level], ch[level], 3, padding=1)
                blk.upsamplers = nn.ModuleList([us])
            dec.up_blocks.append(blk)
        dec.conv_norm_out = nn.GroupNorm(g, ch[0], eps=1e-6)
        dec.conv_out = nn.Conv2d(ch[0], cfg['out_channels'], 3, padding=1)
        self.counter = None

    def _mid_attention(self, a, x):
        B, C, H, W = x.shape
        h = a.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q, k, v = a.to_q(h), a.to_k(h), a.to_v(h)
        if self.counter is not None:
            self.counter(4 * B * (H * W) ** 2 * C)
        if q.device.type == 'meta':
            out = q
        else:
            out = torch.empty_like(q)
            for s in range(0, H * W, QUERY_BLOCK):
                e = min(H * W, s + QUERY_BLOCK)
                p = ((q[:, s:e] @ k.transpose(-1, -2)) * C ** -0.5).float().softmax(-1)
                out[:, s:e] = p.to(v.dtype) @ v
        return x + a.to_out[0](out).reshape(B, H, W, C).permute(0, 3, 1, 2)

    def forward(self, z):
        dec = self.decoder
        z = self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype))
        h = dec.mid_block.resnets[0](dec.conv_in(z))
        h = self._mid_attention(dec.mid_block.attentions[0], h)
        h = dec.mid_block.resnets[1](h)
        for blk in dec.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, 'upsamplers'):
                h = blk.upsamplers[0].conv(F.interpolate(h, scale_factor=2, mode='nearest'))
        h = F.silu(dec.conv_norm_out(h))
        w = dec.conv_out
        return F.conv2d(h.float(), w.weight.float(), w.bias.float(), padding=1)


def cross_attention_layers(cfg: dict) -> List[dict]:
    """Every text cross-attention layer of the UNet in DAAM's locator order
    (up blocks deepest level first, then down blocks, then the mid block):
    name, level, heads and spatial downscale."""
    n = len(cfg['block_out_channels'])
    depth = cfg['transformer_layers_per_block']
    out = []

    def add(position, level, count, d):
        for i in range(count):
            base = f'{position}_{level}_{i}' if position != 'mid' else 'mid_0'
            for name in ([f'{base}.{j}' for j in range(d)] if d > 1 else [base]):
                out.append({'name': name, 'position': position, 'level': level,
                            'heads': cfg['attention_head_dim'][level],
                            'downscale': 2 ** level})

    for level in reversed(range(n)):
        if cfg['up_block_types'][level] == 'cross' and depth[level] > 0:
            add('up', level, cfg['layers_per_block'] + 1, depth[level])
    for level in range(n):
        if cfg['down_block_types'][level] == 'cross' and depth[level] > 0:
            add('down', level, cfg['layers_per_block'], depth[level])
    add('mid', n - 1, 1, max(depth[-1], 1))
    return out
