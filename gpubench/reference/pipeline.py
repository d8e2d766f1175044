"""The plain reference of a traced generation: text encoders, DDIM with
classifier-free guidance, the DAAM accumulators, the VAE decode (tiled as
the configuration says) and the heat-map aggregation.

It is built from a configuration file's sizes and a set of state dicts
that the benchmark made, and works out again what the program derives:
token ids, the initial noise from each prompt's generator seed, the DDIM
tables, the accumulators and the maps.  :meth:`Reference.run` either runs
free (the control, in a lower precision) or follows a program's per-step
latents (teacher forcing: step i starts from the program's latents after
step i-1, step 0 from the reference's own noise), so that one step's
rounding does not compound over thirty.  Imports nothing of the program.
"""

from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .models import CLIPTextModel, Capture, UNet, VAEDecoder, cross_attention_layers
from .tokenizer import Tokenizer

FP8_MAX = 448.0


def ddim_tables(cfg: dict, steps: int, device):
    """(timesteps, alpha_t, alpha_prev): DDIM with eta 0, the scaled-linear
    betas, ``steps_offset`` 1 and ``set_alpha_to_one`` False, built in
    float64 and cast to float32."""
    s = cfg['scheduler']
    n = s['num_train_timesteps']
    betas = np.linspace(s['beta_start'] ** 0.5, s['beta_end'] ** 0.5, n,
                        dtype=np.float64) ** 2
    ac = np.cumprod(1.0 - betas)
    ratio = n // steps
    ts = np.clip((np.arange(steps) * ratio).round().astype(np.int64)
                 + s['steps_offset'], 0, n - 1)[::-1].copy()
    prev = ts - ratio
    a_prev = np.where(prev >= 0, ac[np.clip(prev, 0, None)], ac[0])
    f32 = lambda a: torch.as_tensor(a.astype(np.float32), device=device)  # noqa: E731
    return torch.as_tensor(ts, device=device), f32(ac[ts]), f32(a_prev)


def _fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor."""
    scale = x.detach().abs().amax().float().clamp_min(1e-12) / FP8_MAX
    return ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)


def quantize_fp8(module: torch.nn.Module):
    """Run every linear and convolution of ``module``, and the UNet's
    attention products, on float8 e4m3 operands (weights, inputs, q, k and
    v; one scale per tensor): the fp8 path a program might offer for a
    bf16 configuration."""
    for m in module.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv2d)):
            m.weight.data = _fake_fp8(m.weight.data)
            m.register_forward_pre_hook(lambda _m, args: (_fake_fp8(args[0]),) + args[1:])
        if hasattr(m, 'round_operands'):
            m.round_operands = _fake_fp8


@contextmanager
def tf32_products(on: bool):
    """Matrix products and convolutions on TF32 while the block runs."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    if on:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


class Reference:
    """``cfg``: a configuration file's contents; ``state_dicts``: module
    name -> diffusers-named tensors; ``dtype``: float32 (the reference) or
    a lower precision (the control), ``fp8`` on top of bfloat16 for a
    bfloat16 configuration's control; ``tf32``: float32 whose matrix
    products and convolutions run on TF32 (a float32 configuration's other
    control)."""

    def __init__(self, cfg: dict, state_dicts: Dict[str, Dict[str, torch.Tensor]],
                 device, dtype=torch.float32, fp8: bool = False, tf32: bool = False):
        self.cfg, self.device, self.tf32 = cfg, torch.device(device), tf32
        self.sdxl = 'text_encoder_2' in cfg['modules']
        builders = {'text_encoder': lambda: CLIPTextModel(cfg['text_encoder']),
                    'text_encoder_2': lambda: CLIPTextModel(cfg['text_encoder_2']),
                    'unet': lambda: UNet(cfg['unet']),
                    'vae': lambda: VAEDecoder(cfg['vae'])}
        self.modules = {}
        for name in cfg['modules']:
            with torch.device('meta'):
                m = builders[name]()
            m.load_state_dict({k: v.to(dtype) for k, v in state_dicts[name].items()},
                              strict=True, assign=True)
            m = m.to(self.device).eval()
            if fp8:
                quantize_fp8(m)
            self.modules[name] = m
        self.tok = Tokenizer(pad_id=cfg['text_encoder']['pad_token_id'])
        self.tok_2 = Tokenizer(pad_id=cfg['text_encoder_2']['pad_token_id']) if self.sdxl else None
        self.layers = cross_attention_layers(cfg['unet'])
        self.size = cfg['run']['image_size']
        self.latent = self.size // cfg['vae_scale_factor']

    # ------------------------------------------------------------ pieces
    @torch.no_grad()
    def encode(self, prompts: Sequence[str]):
        """The UNet's context for the CFG batch [uncond; cond] (negative
        prompt ''), and SDXL's added conditioning."""
        B = len(prompts)
        texts = [''] * B + list(prompts)
        ids = torch.tensor(self.tok.batch_ids(texts), device=self.device)
        if not self.sdxl:
            return self.modules['text_encoder'](ids)[0], None
        ids_2 = torch.tensor(self.tok_2.batch_ids(texts), device=self.device)
        h1, _ = self.modules['text_encoder'](ids, penultimate=True)
        h2, pooled = self.modules['text_encoder_2'](ids_2, penultimate=True)
        s = self.size
        time_ids = torch.tensor([s, s, 0, 0, s, s], dtype=torch.float32,
                                device=self.device).expand(2 * B, 6)
        return torch.cat([h1, h2], dim=-1), {'text_embeds': pooled, 'time_ids': time_ids}

    def noise(self, seeds: Sequence[int]) -> torch.Tensor:
        """Each prompt's initial latents, drawn from a generator on the
        device seeded with its seed."""
        shape = (1, self.cfg['unet']['in_channels'], self.latent, self.latent)
        return torch.cat([torch.randn(shape, device=self.device,
                                      generator=torch.Generator(self.device).manual_seed(s))
                          for s in seeds])

    def located(self, transplant: bool) -> List[dict]:
        """The layers whose maps are accumulated: every cross-attention
        layer but the mid block's (the transplant's runs take it too),
        less those at spatial factor 8."""
        x = 96 if self.size not in (512, 1024) else 64
        out = []
        for info in self.layers:
            if info['position'] == 'mid' and not transplant:
                continue
            edge = self.latent // info['downscale']
            factor = max(x // edge, 1) if edge <= x else x // edge
            if factor != 8:
                out.append(dict(info, factor=factor, edge=edge))
        return out

    @torch.no_grad()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents → float32 images (B, H, W, 3) in [0, 1]; tiled (64²
        latent tiles, 16 of overlap, linear ramps) above the configuration's
        threshold."""
        vae, sf = self.modules['vae'], self.cfg['vae_scale_factor']
        scale = self.cfg['vae']['scaling_factor']
        B, _, h, w = latents.shape
        if max(h, w) <= self.cfg['run']['vae_tile_threshold']:
            return (vae(latents / scale) / 2 + 0.5).clamp(0, 1).permute(0, 2, 3, 1)
        tile, overlap = 64, 16

        def positions(size):
            pos = list(range(0, max(size - tile, 0) + 1, max(tile - overlap, 1)))
            if not pos or pos[-1] + tile < size:
                pos.append(size - tile)
            return sorted(set(p for p in pos if p >= 0))

        rows, cols = positions(h), positions(w)
        band = min(overlap, tile - 1) * sf
        ramp = (np.arange(band) + 1) / float(band + 1)
        out = torch.zeros(B, h * sf, w * sf, 3, device=latents.device)
        norm = torch.zeros(1, h * sf, w * sf, 1, device=latents.device)
        for r in rows:
            for c in cols:
                im = vae(latents[:, :, r:r + tile, c:c + tile] / scale)
                im = (im / 2 + 0.5).clamp(0, 1).permute(0, 2, 3, 1)
                wy = np.ones(tile * sf, dtype=np.float32)
                wx = np.ones(tile * sf, dtype=np.float32)
                if r != rows[0]:
                    wy[:band] = ramp
                if r != rows[-1]:
                    wy[-band:] = ramp[::-1]
                if c != cols[0]:
                    wx[:band] = ramp
                if c != cols[-1]:
                    wx[-band:] = ramp[::-1]
                wt = torch.from_numpy(wy[:, None] * wx[None, :])[..., None].to(latents.device)
                ys, xs = slice(r * sf, (r + tile) * sf), slice(c * sf, (c + tile) * sf)
                out[:, ys, xs] += im * wt
                norm[:, ys, xs] += wt
        return out / norm.clamp_min(1e-8)

    def global_maps(self, acc: Dict[str, torch.Tensor], prompts: Sequence[str],
                    located: List[dict]) -> List[torch.Tensor]:
        """DAAM's global heat map of each prompt: each located layer's
        accumulated (heads, 77, h, w) maps bicubic-upsampled to the map grid
        and clamped at 0, averaged over (layer, head), cut to the prompt's
        tokens plus the start token and one more."""
        x = 96 if self.size not in (512, 1024) else 64
        out = []
        for b, prompt in enumerate(prompts):
            total, count = 0.0, 0
            for info in located:
                a = acc[info['name']][b]                      # (H, 77, h·w)
                a = a.reshape(1, -1, info['edge'], info['edge']).float()
                up = F.interpolate(a, size=(x, x), mode='bicubic',
                                   align_corners=False).clamp(min=0.0)
                total = total + up.reshape(info['heads'], -1, x, x).sum(0)
                count += info['heads']
            out.append((total / count)[:len(self.tok.tokenize(prompt)) + 2])
        return out

    def word_map(self, global_map: torch.Tensor, prompt: str, word: str) -> torch.Tensor:
        return global_map[self.tok.merge_indices(prompt, word)].mean(0)

    # --------------------------------------------------------------- run
    @torch.no_grad()
    def run(self, prompts: Sequence[str], seeds: Sequence[int], steps: int,
            guidance: float, forced: Optional[List[torch.Tensor]] = None,
            save: bool = False, replay: Optional[Dict[str, torch.Tensor]] = None,
            heads_dtype=torch.bfloat16) -> dict:
        """One traced generation of ``prompts``.  ``forced``: the program's
        latents after each step, which the reference follows; the result's
        ``step_err`` is then, for each step and prompt, the distance from
        the program's latents after the step to the reference's, over the
        length of the step's noise term (the guided noise prediction's
        relative error).  ``save``: return every cross-attention layer's P
        of every step in ``heads_dtype`` (the transplant's save run);
        ``replay``: such a buffer, which replaces the computed P (the load
        run)."""
        with tf32_products(self.tf32):
            return self._run(prompts, seeds, steps, guidance, forced, save, replay, heads_dtype)

    def _run(self, prompts, seeds, steps, guidance, forced, save, replay, heads_dtype) -> dict:
        B = len(prompts)
        context, added = self.encode(prompts)
        ts, a_t, a_prev = ddim_tables(self.cfg, steps, self.device)
        transplant = save or replay is not None
        located = self.located(transplant)
        T = 77
        acc = {i['name']: torch.zeros(B, i['heads'], T, i['edge'] ** 2,
                                      device=self.device) for i in located}
        x = self.noise(seeds)
        latents, errs, saved = [], [], {}
        for i in range(steps):
            rep = None if replay is None else {n: r[i] for n, r in replay.items()}
            cap = Capture(acc=acc, save=save, replay=rep)
            eps = self.modules['unet'](torch.cat([x, x]), ts[i], context, added, cap)
            eps_u, eps_c = eps.chunk(2)
            eps = eps_u + guidance * (eps_c - eps_u)
            x0 = (x - torch.sqrt(1 - a_t[i]) * eps) / torch.sqrt(a_t[i])
            nxt = torch.sqrt(a_prev[i]) * x0 + torch.sqrt(1 - a_prev[i]) * eps
            if save:
                for n, p in cap.probs.items():
                    saved.setdefault(n, []).append(p.to(heads_dtype))
            if forced is not None:
                carry = torch.sqrt(a_prev[i] / a_t[i]) * x
                num = (forced[i].float() - nxt).flatten(1).norm(dim=1)
                den = (nxt - carry).flatten(1).norm(dim=1)
                errs.append((num / den).cpu())
                x = forced[i].float()
            else:
                x = nxt
            latents.append(x)
        images = self.decode(x)
        maps = self.global_maps(acc, prompts, located)
        return {'latents': latents, 'images': images, 'maps': maps,
                'step_err': torch.stack(errs) if errs else None,
                'saved': ({n: torch.stack(ps) for n, ps in saved.items()} if save else None)}


def to_u8(images: torch.Tensor) -> np.ndarray:
    """Float images in [0, 1] → uint8, rounded as the program rounds them."""
    return np.clip(images.float().cpu().numpy() * 255 + 0.5, 0, 255).astype(np.uint8)


def rel(a, b) -> float:
    """‖a − b‖ / ‖b‖ in float64."""
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))
