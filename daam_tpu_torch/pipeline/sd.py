"""Stable Diffusion pipeline (SD 1.x/2.x; SDXL in :mod:`.sdxl`) with DAAM
tracing, in PyTorch.

Counterpart of ``daam_tpu/pipeline/sd.py``: two text encodes
(unconditional, conditional) through the ``_text_forward``/``_merge_added``
seams that SDXL overrides, a DDIM loop with classifier-free guidance on
the ``[uncond; cond]`` batch, the ``'acc'`` capture into one fp32
accumulator ``(B, H, 77, h·w)`` per located cross-attention layer,
``finalize_acc`` into per-factor blocks ``(B, L, H, T, h, w)``, and the VAE
decode, tiled for latent edges above ``vae_tile_threshold`` (SDXL's 128²).
Inside ``trace(pipe, save_heads=True)`` every cross-attention runs the
``'full'`` capture instead: its per-step probabilities are cast to
``heads_dtype`` and copied to the host every ``heads_chunk_steps`` steps (the
replay buffer), and their conditional half is added into the accumulators.
Inside ``trace(pipe, load_heads=True)`` each step's saved probabilities go
back to the device and replace the computed ones (the attention
transplant).  With ``trace(pipe, time_chunk_steps=K)`` the accumulators are
snapshotted every K steps for per-step maps.  PyTorch runs eagerly, so the
``lax.scan`` of ``daam_tpu`` is a Python loop and the accumulators are
updated in place; on the card, outside the ``save_heads`` and
``load_heads`` runs, each step's UNet evaluation is replayed from a CUDA
graph (:mod:`.unet_graph`).  A batch of prompts takes one
``torch.Generator`` per prompt (``daam_tpu``'s stacked keys), so a prompt's
noise does not depend on the batch it rides in; the images pass the
``safety_checker`` slot before the trace records them, as in ``daam_tpu``.
"""

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import profiling
from ..models.configs import PipelineConfig, cross_attention_layout, get_pipeline_config
from ..profiling import span
from ..tokenization import default_tokenizer
from ..utils import randn_tensor
from .schedulers import DDIMScheduler, get_scheduler
from .unet_graph import UNetGraphs

__all__ = ['StableDiffusionPipeline', 'PipelineOutput']


@dataclass
class PipelineOutput:
    images: List[Any]  # PIL images, or (H, W, 3) float arrays in [0, 1]
    nsfw_content_detected: Optional[List[bool]] = None


def _to_pil(images: np.ndarray) -> list:
    import PIL.Image
    if images.dtype != np.uint8:
        images = np.clip(images * 255 + 0.5, 0, 255).astype(np.uint8)
    return [PIL.Image.fromarray(im) for im in images]


class StableDiffusionPipeline:
    """Text-to-image Stable Diffusion.  ``pipe(prompt, num_inference_steps=…,
    generator=…, guidance_scale=…, negative_prompt=…, latents=…,
    callback=…, callback_steps=…)`` mirrors the reference/diffusers call."""

    is_sdxl = False

    def __init__(self, config: PipelineConfig, text_encoder, unet, vae,
                 tokenizer=None, scheduler: Union[str, DDIMScheduler] = 'ddim'):
        self.config = config
        self.text_encoder = text_encoder
        self.unet = unet
        self.vae = vae
        self.tokenizer = tokenizer or default_tokenizer()
        if isinstance(scheduler, str):
            scheduler = get_scheduler(scheduler, config.prediction_type)
        self.scheduler = scheduler
        self.vae_scale_factor = config.vae.scale_factor
        self._layout = {info.name: info
                        for info in cross_attention_layout(config.unet)}
        param = next(unet.parameters())
        self.device, self.dtype = param.device, param.dtype
        # Edge of the traced heat maps' grid: 64 for 512- and 1024-px
        # models, 96 otherwise (reference ``daam/trace.py:32-33``).
        size = unet.config.sample_size * self.vae_scale_factor
        self.heat_map_grid = 64 if size in (512, 1024) else 96
        # Tiled VAE decode (daam_tpu/pipeline/sd.py:95-99): 'auto' tiles
        # latent edges above vae_tile_threshold, True/False force it.
        self.vae_tile_threshold = 96
        self.vae_tiling: Union[str, bool] = 'auto'
        # save_heads copies the replay buffer to the host every this many
        # steps, so device memory holds at most one chunk of probabilities.
        self.heads_chunk_steps = 8
        # Replay-buffer element type: bfloat16 halves the buffer; float32
        # gives exact transplants (reference daam/trace.py:246-250).
        self.heads_dtype = torch.bfloat16
        # Safety-checker slot (daam_tpu/pipeline/sd.py:112-117): a callable
        # (images_u8, prompts) -> List[bool]; flagged images are blacked
        # out.  None (the default) checks nothing, like diffusers with
        # safety_checker=None.
        self.safety_checker: Optional[Callable] = None
        # Trace integration (installed by daam_tpu_torch.trace; None = untraced).
        self._active_trace = None
        # The denoising loop's UNet evaluations, replayed from CUDA graphs on
        # the card (pipeline/unet_graph.py).
        self.unet_graphs = UNetGraphs()

    @classmethod
    def from_pretrained(cls, model_name_or_path, device='cuda',
                        dtype=torch.float32, seed: int = 0,
                        scheduler: str = 'ddim') -> 'StableDiffusionPipeline':
        """A local diffusers checkpoint directory when the path exists
        (config from its ``config.json`` files, tokenizer from its
        ``tokenizer/``; :func:`~daam_tpu_torch.models.weights.load_diffusers_checkpoint`),
        else a preset (``v2-1-base``, ``xl-base-1.0``, ``tiny``, …) with
        random weights drawn on ``device`` from ``seed``
        (``daam_tpu/pipeline/sd.py:123-138``).  An SDXL config gives a
        :class:`~.sdxl.StableDiffusionXLPipeline`.  The card by default:
        without one this raises, and only ``device='cpu'`` runs on the
        CPU."""
        from pathlib import Path

        from ..models.weights import init_random, load_diffusers_checkpoint

        if Path(model_name_or_path).exists():
            config, modules, tokenizer = load_diffusers_checkpoint(
                model_name_or_path, device=device, dtype=dtype)
            return _pipeline_class(config)(config, **modules, tokenizer=tokenizer,
                                           scheduler=scheduler)
        config = get_pipeline_config(model_name_or_path)
        gen = torch.Generator(device=device).manual_seed(seed)
        modules = init_random(config, gen, device=device, dtype=dtype)
        return _pipeline_class(config)(config, **modules, scheduler=scheduler)

    # ---------------------------------------------------------------- encode
    def _encode_tokens(self, prompts: Sequence[str]) -> torch.Tensor:
        enc = self.tokenizer(list(prompts), padding='max_length',
                             truncation=True, return_tensors='np')
        return torch.as_tensor(enc['input_ids'], dtype=torch.long,
                               device=self.device)

    def _text_forward(self, input_ids: torch.Tensor):
        """``(context, added)`` for the UNet.  SD: the final hidden states
        (SD2: no penultimate) and no added conditioning."""
        return self.text_encoder(input_ids)[0], None

    def _merge_added(self, added_uncond, added_cond, height: int, width: int):
        """The UNet's ``added_cond`` for the CFG batch; SD has none."""
        return None

    # -------------------------------------------------------------- capture
    def _layer_grid(self, name: str, latent_h: int, latent_w: int):
        info = self._layout[name]
        return info.heads, latent_h // info.downscale, latent_w // info.downscale

    def make_acc(self, capture_spec, batch_size: int, latent_h: int,
                 latent_w: int) -> Dict[str, torch.Tensor]:
        """One zeroed fp32 accumulator ``(B, H, 77, h·w)`` per captured layer."""
        T = self.tokenizer.model_max_length
        accs = {}
        for _factor, names, _ids in capture_spec:
            for n in names:
                heads, h, w = self._layer_grid(n, latent_h, latent_w)
                accs[n] = torch.zeros(batch_size, heads, T, h * w,
                                      dtype=torch.float32, device=self.device)
        return accs

    def finalize_acc(self, accs: Dict[str, torch.Tensor], capture_spec,
                     batch_size: int, latent_h: int, latent_w: int
                     ) -> Dict[int, torch.Tensor]:
        """Per-layer accumulators → per-factor blocks ``(B, L, H, T, h, w)``
        (``daam_tpu/pipeline/sd.py:212-228``, without the TPU padding)."""
        T = self.tokenizer.model_max_length
        blocks = {}
        with span('finalize_acc'):
            for factor, names, _ids in capture_spec:
                per_layer = []
                for n in names:
                    heads, h, w = self._layer_grid(n, latent_h, latent_w)
                    per_layer.append(accs[n].view(batch_size, heads, T, h, w))
                blocks[factor] = torch.stack(per_layer, dim=1)
        return blocks

    # ------------------------------------------------------------- generate
    @torch.no_grad()
    def _generate(self, input_ids, neg_ids, num_steps: int, height: int,
                  width: int, generator, latents, guidance_scale: float,
                  capture_spec, callback, save_heads: bool = False,
                  replay: Optional[Dict[str, torch.Tensor]] = None,
                  snapshot_steps: Optional[int] = None):
        """The denoising loop and decode.  ``generator``: one
        ``torch.Generator`` for the whole batch, or a list of one per
        prompt.  ``callback(i, t, latents)`` runs after every step.
        Returns ``(images, blocks, saved,
        snapshots)``: the finalized per-factor blocks (or None), the replay
        buffer ``{layer: (steps, 2B, H, h·w, 77)}`` on the host under
        ``save_heads`` (else None), and under ``snapshot_steps`` the fp16
        host blocks of each chunk's accumulator increase (else None)."""
        B = input_ids.shape[0]
        latent_h = height // self.vae_scale_factor
        latent_w = width // self.vae_scale_factor
        shape = (B, self.config.unet.in_channels, latent_h, latent_w)
        scheduler = self.scheduler

        with span('text_encode'):
            context_c, added_c = self._text_forward(input_ids)
            context_u, added_u = self._text_forward(neg_ids)
            context = torch.cat([context_u, context_c], dim=0)  # [uncond; cond]
            added = self._merge_added(added_u, added_c, height, width)
        if latents is None:
            latents = randn_tensor(shape, generator, self.device) \
                * scheduler.init_noise_sigma
        else:
            latents = torch.as_tensor(latents, dtype=torch.float32,
                                      device=self.device)
            if tuple(latents.shape) != shape:
                raise ValueError(f'latents must be NCHW {shape}, '
                                 f'got {tuple(latents.shape)}')
        state = scheduler.init_state(num_steps, shape, device=self.device)
        accs = (self.make_acc(capture_spec, B, latent_h, latent_w)
                if capture_spec else None)
        capture = 'full' if save_heads else 'acc' if accs else False
        n_steps = scheduler.num_scan_steps(num_steps)
        chunk = max(1, int(self.heads_chunk_steps))
        pending: Dict[str, List[torch.Tensor]] = {}
        saved: Dict[str, List[torch.Tensor]] = {}
        snaps = [] if snapshot_steps else None
        prev = {n: a.clone() for n, a in accs.items()} if snaps is not None else None

        with self.unet_graphs.request(self.unet, self.device, capture, replay) as unet:
            for i in range(n_steps):
                with span('step', step=i):
                    with span('scheduler'):
                        latent_in = scheduler.scale_model_input(
                            state, torch.cat([latents, latents], dim=0), i)
                        t = state['timesteps'][i]
                    rep = None
                    if replay is not None:
                        nbytes = sum(r[i].nbytes for r in replay.values())
                        profiling.count('heads_h2d_bytes', nbytes)
                        with span('heads.h2d', bytes=nbytes):
                            rep = {n: r[i].to(self.device) for n, r in replay.items()}
                    with span('unet') as unet_span:
                        eps = unet(latent_in, t.expand(2 * B), context,
                                   added_cond=added, capture=capture,
                                   acc=accs if capture == 'acc' else None, replay=rep)
                        unet_span.set(graph=unet.graph)
                    if save_heads:
                        eps, probs = eps
                        for n, a in (accs or {}).items():
                            a += probs[n][B:].transpose(2, 3)  # CFG conditional half
                        for n, p in probs.items():
                            pending.setdefault(n, []).append(p.to(self.heads_dtype))
                        if (i + 1) % chunk == 0 or i == n_steps - 1:
                            nbytes = sum(len(ps) * ps[0].nbytes for ps in pending.values())
                            profiling.count('heads_d2h_bytes', nbytes)
                            with span('heads.d2h', bytes=nbytes):
                                for n, ps in pending.items():
                                    saved.setdefault(n, []).append(torch.stack(ps).cpu())
                            pending = {}
                    if snaps is not None and ((i + 1) % snapshot_steps == 0
                                              or i == n_steps - 1):
                        diff = {n: a - prev[n] for n, a in accs.items()}
                        snaps.append({f: b.half().cpu() for f, b in self.finalize_acc(
                            diff, capture_spec, B, latent_h, latent_w).items()})
                        prev = {n: a.clone() for n, a in accs.items()}
                    with span('scheduler'):
                        eps_u, eps_c = eps.chunk(2)
                        eps = eps_u + guidance_scale * (eps_c - eps_u)
                        latents, state = scheduler.step(state, i, eps, latents)
                    if callback is not None:
                        with span('callback'):
                            callback(i, t, latents)
            # inside the lease: the accumulators may be a graph's, which the
            # next request on the graph route takes over
            blocks = (self.finalize_acc(accs, capture_spec, B, latent_h, latent_w)
                      if accs else None)
        images = self._decode(latents)
        if save_heads:
            nbytes = sum(c.nbytes for chunks in saved.values() for c in chunks)
            with span('heads.cat', bytes=nbytes):
                saved = {n: torch.cat(chunks) for n, chunks in saved.items()}
        else:
            saved = None
        return images, blocks, saved, snaps

    # --------------------------------------------------------------- decode
    def _decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents (B, 4, h, w) → fp32 images (B, H, W, 3) in [0, 1], tiled
        under ``vae_tiling`` (``daam_tpu/pipeline/sd.py:340-342``)."""
        edge = max(latents.shape[2:])
        tiled = self.vae_tiling is True or (self.vae_tiling == 'auto'
                                            and edge > self.vae_tile_threshold)
        with span('decode', tiled=int(tiled), latent=edge):
            if tiled:
                return self._tiled_decode(latents)
            images = self.vae.decode(latents / self.config.vae.scaling_factor)
            return (images / 2 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)

    def _tiled_decode(self, latents: torch.Tensor, tile: int = 64,
                      overlap: int = 16) -> torch.Tensor:
        """The tiled VAE decode of ``daam_tpu/pipeline/sd.py:429-498``, tile
        for tile: ``tile``² latent tiles at the same positions and in the
        same order, each decoded and clipped to [0, 1], then blended in
        pixel space with linear ramps over the ``overlap``·sf-pixel bands
        where it meets another tile, and divided by the summed weights.
        NCHW latents in, (B, H, W, 3) fp32 images out.

        The tiles go through the decoder as one batch, as in ``daam_tpu``:
        one decoder call issues a ninth of the launches of nine (the host's
        dispatch sets the pace, ``PERF.md`` §5), and at SDXL's nine 64²
        tiles its largest activation, (9, 128, 512, 512) bf16, is 0.6 GB.
        """
        sf = self.vae_scale_factor
        batch_size, _, latent_h, latent_w = latents.shape
        tile_h, tile_w = min(tile, latent_h), min(tile, latent_w)

        def positions(size, t):
            stride = max(t - overlap, 1)
            pos = list(range(0, max(size - t, 0) + 1, stride))
            if not pos or pos[-1] + t < size:
                pos.append(size - t)
            return sorted(set(p for p in pos if p >= 0))

        rows, cols = positions(latent_h, tile_h), positions(latent_w, tile_w)
        grid = [(r, c) for r in rows for c in cols]
        band = min(overlap, tile_h - 1, tile_w - 1) * sf
        ramp = (np.arange(band) + 1) / float(band + 1)

        def tile_weight(r, c):
            wy = np.ones(tile_h * sf, dtype=np.float32)
            wx = np.ones(tile_w * sf, dtype=np.float32)
            if r != rows[0]:
                wy[:band] = ramp
            if r != rows[-1]:
                wy[-band:] = ramp[::-1]
            if c != cols[0]:
                wx[:band] = ramp
            if c != cols[-1]:
                wx[-band:] = ramp[::-1]
            return wy[:, None] * wx[None, :]

        tiles = torch.stack([latents[:, :, r:r + tile_h, c:c + tile_w]
                             for r, c in grid])
        imgs = self.vae.decode(tiles.flatten(0, 1)
                               / self.config.vae.scaling_factor)
        imgs = (imgs / 2 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1)
        imgs = imgs.reshape(len(grid), batch_size, tile_h * sf, tile_w * sf, 3)
        weights = torch.from_numpy(np.stack([tile_weight(r, c) for r, c in grid])
                                   )[..., None].to(imgs.device)
        out = imgs.new_zeros(batch_size, latent_h * sf, latent_w * sf, 3)
        norm = imgs.new_zeros(1, latent_h * sf, latent_w * sf, 1)
        for i, (r, c) in enumerate(grid):
            ys = slice(r * sf, (r + tile_h) * sf)
            xs = slice(c * sf, (c + tile_w) * sf)
            out[:, ys, xs] += imgs[i] * weights[i]
            norm[:, ys, xs] += weights[i]
        return out / norm.clamp_min(1e-8)

    def enable_vae_tiling(self, enabled: Union[str, bool] = True):
        """Force the tiled VAE decode on or off (``'auto'`` tiles latent
        edges above ``vae_tile_threshold``)."""
        self.vae_tiling = enabled

    def __call__(self, prompt: Union[str, List[str]],
                 num_inference_steps: int = 50,
                 generator: Union[torch.Generator, Sequence[torch.Generator],
                                  None] = None,
                 guidance_scale: Optional[float] = None,
                 negative_prompt: Union[str, List[str], None] = None,
                 height: Optional[int] = None, width: Optional[int] = None,
                 latents=None, callback: Optional[Callable] = None,
                 callback_steps: Optional[int] = None,
                 output_type: str = 'pil') -> PipelineOutput:
        """Generate (and, inside ``trace(pipe)``, capture heat maps).

        ``generator``: one ``torch.Generator`` for the batch's noise, or a
        list of one per prompt, each drawing its own prompt's
        ``(1, 4, H/8, W/8)`` noise (``daam_tpu``'s stacked keys).
        ``latents``: the initial noise as NCHW ``(B, 4, H/8, W/8)`` float32
        (a tensor or numpy array), already scaled by the scheduler's
        ``init_noise_sigma``; drawn from ``generator`` when omitted.
        ``callback``: with ``callback_steps`` set, ``callback(i, t,
        latents)`` runs live after every denoising step; without it,
        ``callback(i, None, None)`` runs once per step after sampling, as
        ``daam_tpu``'s counter-style callbacks do
        (``daam_tpu/pipeline/sd.py:601-605``).
        ``output_type``: ``'pil'`` or ``'np'`` ((H, W, 3) floats in [0, 1]).
        The images pass :meth:`run_safety_checker`; the trace records the
        checked ones.
        """
        prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        B = len(prompts)
        with profiling.request(fresh=False), \
                span('call', batch=B, steps=num_inference_steps,
                     evaluations=self.scheduler.num_scan_steps(num_inference_steps),
                     v_prediction=int(self.scheduler.prediction_type == 'v_prediction'),
                     grid=self.heat_map_grid):
            tr = self._active_trace
            if tr is not None:
                tr._on_call_start(prompt)
            if negative_prompt is None:
                negatives = [''] * B
            elif isinstance(negative_prompt, str):
                negatives = [negative_prompt] * B
            else:
                negatives = list(negative_prompt)
            height = height or self.config.image_size
            width = width or self.config.image_size
            if guidance_scale is None:
                guidance_scale = self.config.default_guidance_scale

            capture_spec = tr.capture_spec(self) if tr is not None else None
            save_heads = bool(tr and tr.save_heads)
            load_heads = bool(tr and tr.load_heads)
            # Accumulator snapshots for per-step maps; the save_heads replay
            # buffer supersedes them (exact per-step maps).
            snapshot_steps = (tr.time_chunk_steps
                              if tr is not None and tr.time_chunk_steps
                              and not (save_heads or load_heads) else None)
            replay = None
            if load_heads:
                replay = tr.replay_buffer(
                    self.scheduler.num_scan_steps(num_inference_steps))
                self._validate_replay(replay, B, height, width)
            images, blocks, saved, snaps = self._generate(
                self._encode_tokens(prompts), self._encode_tokens(negatives),
                num_inference_steps, height, width, generator, latents,
                guidance_scale, capture_spec,
                callback if callback_steps is not None else None,
                save_heads=save_heads, replay=replay,
                snapshot_steps=snapshot_steps)

            with span('to_host'):
                images = images.float().cpu().numpy()
                out = _to_pil(images) if output_type == 'pil' else list(images)
            out, nsfw = self.run_safety_checker(out, prompts)
            if tr is not None:
                tr._on_call_end(prompts, out, blocks or {}, saved,
                                num_inference_steps, time_blocks=snaps)
            if callback is not None and callback_steps is None:
                for i in range(num_inference_steps):
                    callback(i, None, None)
            return PipelineOutput(images=out, nsfw_content_detected=nsfw)

    def _validate_replay(self, replay, batch_size: int, height: int,
                         width: int):
        """Fail with a clear message when a saved replay buffer does not fit
        this generation's geometry (batch, spatial grid, context length)
        (``daam_tpu/pipeline/sd.py:618-649``)."""
        latent_h = height // self.vae_scale_factor
        latent_w = width // self.vae_scale_factor
        T_ctx = self.tokenizer.model_max_length
        for name, arr in replay.items():
            info = self._layout.get(name)
            if info is None:
                raise RuntimeError(
                    f'Replay buffer layer {name!r} does not exist in this '
                    f'UNet ({len(self._layout)} cross-attention layers); the '
                    f'heads were saved from a different model.')
            want = (2 * batch_size, info.heads,
                    (latent_h // info.downscale) * (latent_w // info.downscale),
                    T_ctx)
            if tuple(arr.shape[1:]) != want:
                raise RuntimeError(
                    f'Replay buffer layer {name!r} has per-step shape '
                    f'{tuple(arr.shape[1:])} but this generation needs {want} '
                    f'(batch {batch_size}, {height}x{width}); save and load '
                    f'heads must use the same batch size and image size.')
        missing = [n for n in self._layout if n not in replay]
        if missing:
            raise RuntimeError(
                f'Replay buffer is missing layers {missing[:4]}'
                f'{"..." if len(missing) > 4 else ""}; it was saved from a '
                f'different model or an incomplete save_heads run.')

    # ------------------------------------------------- reference-API helpers
    def run_safety_checker(self, images, prompts):
        """Apply the ``safety_checker`` slot: flagged images become black
        (the reference checker's behavior) and the per-image flags come
        back, or ``None`` when no checker is set
        (``daam_tpu/pipeline/sd.py:651-675``)."""
        if self.safety_checker is None:
            return images, None
        import PIL.Image

        def to_u8(im):
            a = np.asarray(im)
            if a.dtype != np.uint8:  # float [0, 1] arrays (output_type='np')
                a = np.clip(a * 255 + 0.5, 0, 255).astype(np.uint8)
            return a

        flags = [bool(f) for f in self.safety_checker(
            [to_u8(im) for im in images], list(prompts))]
        out = []
        for im, flagged in zip(images, flags):
            if not flagged:
                out.append(im)
            elif isinstance(im, PIL.Image.Image):
                out.append(PIL.Image.fromarray(np.zeros_like(np.asarray(im))))
            else:
                out.append(np.zeros_like(im))
        return out, flags

    def check_inputs(self, prompt, *args, **kwargs):
        """Validation hook (patched by the reference's ``PipelineHooker``,
        ``daam/trace.py:171-182``); batches of prompts are allowed."""
        return None

    def numpy_to_pil(self, images):
        """(B, H, W, 3) floats in [0, 1] or uint8 → PIL images."""
        return _to_pil(np.asarray(images))


def _pipeline_class(config: PipelineConfig):
    """The pipeline class of a config (``daam_tpu/pipeline/sd.py:687-691``)."""
    if config.is_sdxl:
        from .sdxl import StableDiffusionXLPipeline
        return StableDiffusionXLPipeline
    return StableDiffusionPipeline
