"""Trace layer: ``with trace(pipe) as tc`` — capture heat maps during generation.

Counterpart of ``daam_tpu/trace.py``.  Hooking installs the trace on the
pipeline object; the pipeline then gives every located cross-attention
layer an fp32 accumulator that the UNet updates in place at each step (on
the card, inside the ``cross_attention_acc`` kernel), and hands the
finalized per-factor blocks ``(B, L, H, T, h, w)`` back here.
``compute_global_heat_map`` follows ``daam_tpu/trace.py:318-429``: filter by
factor/head/layer, bicubic-upsample with the undershoot clamp, mean over the
(factor, layer, head) entries, truncate to ``len(tokens) + 2``, optionally
normalize.

``save_heads``/``load_heads`` is the attention transplant (reference
``daam/trace.py:246-250, 279-282``): a save run captures every
cross-attention's probabilities (the ``cross_attention_probs`` kernel on the
card) into a replay buffer ``{layer: (steps, 2B, H, h·w, 77)}``, kept on the
host as torch tensors in an LRU registry keyed by ``data_dir`` and persisted
on exit to ``cache_dir()/heads/{data_dir}.npz``; a load run feeds it back in
place of the computed probabilities.  The ``.npz`` is ``daam_tpu``'s format
(bf16 stored as fp16, fp32 kept), so either package loads the other's.
``compute_time_global_heat_maps`` gives per-step maps from that buffer, or
from the accumulator snapshots of ``time_chunk_steps``.
"""

import hashlib
import math
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Type, Union

import numpy as np
import torch

from . import profiling
from .experiment import GenerationExperiment
from .heatmap import GlobalHeatMap, RawHeatMapCollection, bicubic_resize
from .hook import AggregateHooker, ObjectHooker, UNetCrossAttentionLocator
from .utils import cache_dir

__all__ = ['trace', 'DiffusionHeatMapHooker', 'GlobalHeatMap', 'release_heads']


# In-process replay registry: data_dir key -> {layer: (steps, 2B, H, hw, T)}
# host tensors.  A bounded LRU, as in daam_tpu: each entry is a whole replay
# buffer, so a long-running process must not accumulate them; evicted
# buffers stay loadable from their persisted cache_dir()/heads/*.npz file.
_HEAD_CACHE_MAX = 4
_HEAD_CACHE: 'OrderedDict[str, Dict[str, torch.Tensor]]' = OrderedDict()


def _head_cache_put(key: str, value: Dict[str, torch.Tensor]):
    _HEAD_CACHE[key] = value
    _HEAD_CACHE.move_to_end(key)
    while len(_HEAD_CACHE) > _HEAD_CACHE_MAX:
        _HEAD_CACHE.popitem(last=False)


def release_heads(data_dir: Union[str, Path, None] = None) -> bool:
    """Drop an in-memory replay buffer (all of them when ``data_dir`` is
    None).  Returns whether anything was released.  A persisted ``.npz`` is
    untouched, so ``load_heads`` still finds it: this frees memory, it does
    not forget the heads."""
    if data_dir is None:
        released = bool(_HEAD_CACHE)
        _HEAD_CACHE.clear()
        return released
    return _HEAD_CACHE.pop(str(data_dir), None) is not None


class PipelineHooker(ObjectHooker):
    """Installs/uninstalls the trace on the pipeline object."""

    def __init__(self, pipeline, parent_trace: 'DiffusionHeatMapHooker'):
        super().__init__(pipeline)
        self.parent_trace = parent_trace

    def _hook_impl(self):
        if getattr(self.module, '_active_trace', None) is not None:
            raise RuntimeError('Pipeline is already being traced')
        self.module._active_trace = self.parent_trace

    def _unhook_impl(self):
        self.module._active_trace = None


class DiffusionHeatMapHooker(AggregateHooker):
    def __init__(self, pipeline, low_memory: bool = False,
                 load_heads: bool = False, save_heads: bool = False,
                 data_dir: Optional[Union[str, Path]] = None,
                 persist_heads: bool = True,
                 time_chunk_steps: Optional[int] = None):
        self.all_heat_maps = RawHeatMapCollection()
        self.latent_hw = pipeline.heat_map_grid ** 2

        self.locator = UNetCrossAttentionLocator(
            restrict={0} if low_memory else None,
            locate_middle_block=load_heads or save_heads)
        self.last_prompt: str = ''
        self.last_image = None
        self.last_prompts: List[str] = []
        self.last_images: List[Any] = []
        self.time_idx = 0
        self._gen_idx = 0

        self.low_memory = low_memory
        self.save_heads = save_heads
        self.load_heads = load_heads
        self.persist_heads = persist_heads
        # Per-chunk heat maps without the replay buffer: the accumulators are
        # snapshotted every time_chunk_steps steps (see pipeline/sd.py).
        self.time_chunk_steps = time_chunk_steps
        self.time_blocks: List[Dict[int, torch.Tensor]] = []
        self.data_dir = str(data_dir) if data_dir is not None else 'default'

        self.pipe = pipeline
        self._located = self.locator.locate(pipeline.unet)
        self.batch_heat_maps: Dict[int, torch.Tensor] = {}
        self._layer_ids_by_factor: Dict[int, Tuple[int, ...]] = {}

        super().__init__([PipelineHooker(pipeline, self)])

    @property
    def layer_names(self):
        return self.locator.layer_names

    @property
    def layer_heads(self):
        """Per-layer attention head counts, aligned with :attr:`layer_names`
        (the reference hardcodes 16, ``daam/run/generate.py:239``)."""
        return [info.heads for info in self._located]

    def time_callback(self, *args, **kwargs):
        self.time_idx += 1

    # ------------------------------------------------------- capture wiring
    def _factor_of(self, info) -> int:
        """Spatial factor of a layer, bug for bug with ``daam_tpu``
        (``trace.py:150-156``; reference ``daam/trace.py:285``)."""
        x = int(math.sqrt(self.latent_hw))
        latent_edge = self.pipe.config.unet.sample_size
        layer_edge = latent_edge // info.downscale
        return max(x // layer_edge, 1) if layer_edge <= x else x // layer_edge

    def capture_spec(self, pipeline) -> Tuple:
        """Per spatial factor: the layer names to accumulate and their
        global layer indices.  Factor-8 maps are skipped like the reference
        (``daam/trace.py:289``)."""
        groups: Dict[int, Tuple[List[str], List[int]]] = {}
        for info in self._located:
            factor = self._factor_of(info)
            if factor == 8:
                continue
            names, ids = groups.setdefault(factor, ([], []))
            names.append(info.name)
            ids.append(info.layer_idx)
        return tuple(sorted((factor, tuple(names), tuple(ids))
                            for factor, (names, ids) in groups.items()))

    def _on_call_start(self, prompt):
        self.all_heat_maps.clear()
        self.batch_heat_maps.clear()
        self.time_blocks = []
        self.last_prompts = [prompt] if isinstance(prompt, str) else list(prompt)
        self.last_prompt = self.last_prompts[0]

    def _on_call_end(self, prompts, images, blocks: Dict[int, torch.Tensor],
                     saved: Optional[Dict[str, torch.Tensor]] = None,
                     num_steps: int = 0, time_blocks=None):
        if time_blocks is not None:
            self.time_blocks = time_blocks
        self.last_prompts = list(prompts)
        self.last_images = images
        self.last_image = images[-1] if len(images) else None
        self._gen_idx += len(prompts) * num_steps
        spec = {factor: ids for factor, _names, ids in self.capture_spec(self.pipe)}
        for factor, block in blocks.items():
            self.batch_heat_maps[factor] = block
            self._layer_ids_by_factor[factor] = tuple(spec[factor])
            self.all_heat_maps.update_block(factor, block[0], list(spec[factor]))
        if self.save_heads and saved is not None:
            _head_cache_put(self.data_dir, saved)

    # ---------------------------------------------------------- head replay
    def heads_path(self) -> Path:
        """Where the replay buffer is persisted: one ``.npz`` per ``data_dir``
        under ``cache_dir()/heads/`` (``daam_tpu/trace.py:209-220``, the same
        name for the same key)."""
        key = self.data_dir
        safe = ''.join(c if c.isalnum() or c in '-_.' else '_' for c in key)
        if safe != key:
            safe = f'{safe[:40]}-{hashlib.md5(key.encode()).hexdigest()[:8]}'
        return Path(cache_dir()) / 'heads' / f'{safe}.npz'

    def _hook_impl(self):
        super()._hook_impl()
        # every span of this context shares one request id
        self._request = profiling.request()
        self._request.__enter__()

    def _unhook_impl(self):
        super()._unhook_impl()
        self._request.__exit__(None, None, None)
        if self.save_heads and self.persist_heads \
                and self.data_dir in _HEAD_CACHE:
            path = self.heads_path()
            path.parent.mkdir(parents=True, exist_ok=True)
            self.dump_heads(path, compress=False)

    def replay_buffer(self, num_steps: int) -> Dict[str, torch.Tensor]:
        """The saved probabilities for ``load_heads``, from the registry or,
        when it is cold (another process saved them), from
        :meth:`heads_path`.  With ``num_steps > 0`` the buffer must cover
        that many sampling steps."""
        if self.data_dir not in _HEAD_CACHE:
            path = self.heads_path()
            if path.exists():
                self.load_heads_from(path)
        if self.data_dir not in _HEAD_CACHE:
            raise RuntimeError(
                f'No saved attention heads under data_dir={self.data_dir!r}; '
                f'run a generation with save_heads=True first.')
        _HEAD_CACHE.move_to_end(self.data_dir)
        saved = _HEAD_CACHE[self.data_dir]
        if num_steps:
            saved_steps = min(a.shape[0] for a in saved.values())
            if saved_steps < num_steps:
                raise RuntimeError(
                    f'Replay buffer under data_dir={self.data_dir!r} covers '
                    f'{saved_steps} sampling steps but this generation needs '
                    f'{num_steps}; regenerate with save_heads=True at '
                    f'num_inference_steps>={num_steps} (or lower this run\'s '
                    f'step count).')
        return saved

    def dump_heads(self, path: Union[str, Path], compress: bool = True):
        """Write the replay buffer to an ``.npz`` as ``daam_tpu`` does: bf16
        buffers as fp16 (numpy has no bf16), fp32 kept.  ``compress=False``
        skips the zlib pass (what the persist on exit uses)."""
        arrays = {name: (arr if arr.dtype == torch.float32
                         else arr.to(torch.float16)).numpy()
                  for name, arr in self.replay_buffer(0).items()}
        (np.savez_compressed if compress else np.savez)(path, **arrays)

    def load_heads_from(self, path: Union[str, Path]):
        """Load an ``.npz`` written by :meth:`dump_heads` (of either
        package) into the registry under this trace's ``data_dir``: fp32
        stays fp32, anything else becomes bf16."""
        with np.load(path) as data:
            _head_cache_put(self.data_dir, {
                name: torch.from_numpy(data[name]).to(
                    torch.float32 if data[name].dtype == np.float32
                    else torch.bfloat16)
                for name in data.files})

    # ------------------------------------------------------------- queries
    def to_experiment(self, path, seed=None, id='.', subtype='.',
                      **compute_kwargs) -> GenerationExperiment:
        """Export the last generation as a serializable experiment
        (reference ``daam/trace.py:68-81``), which draws its PNGs on the
        pipeline's device where that is a CUDA device."""
        batch_idx = compute_kwargs.get('batch_idx', 0)
        image = (self.last_images[batch_idx]
                 if batch_idx < len(self.last_images) else self.last_image)
        prompt = (self.last_prompts[batch_idx]
                  if batch_idx < len(self.last_prompts) else self.last_prompt)
        with profiling.span('experiment.to_experiment'):
            exp = GenerationExperiment(
                image,
                self.compute_global_heat_map(**compute_kwargs).heat_maps.cpu().numpy(),
                prompt, seed=seed, id=id, subtype=subtype, path=path,
                tokenizer=self.pipe.tokenizer)
            exp._device = self.pipe.device
            return exp

    def _aggregate_source(self, source, batch_idx, factors, head_idx,
                          layer_idx) -> torch.Tensor:
        """Per-factor blocks ``{factor: (B, L, H, T, h, w)}`` → ``(T, x, x)``:
        select, bicubic-upsample with the ≥0 clamp, mean over entries
        (reference ``daam/trace.py:112-126``)."""
        x = int(math.sqrt(self.latent_hw))
        total, count = 0.0, 0
        for factor in sorted(source):
            if factors is not None and factor not in factors:
                continue
            sel = source[factor][batch_idx]  # (L, H, T, h, w)
            if layer_idx is not None:
                layer_ids = self._layer_ids_by_factor[factor]
                if layer_idx not in layer_ids:
                    continue
                li = layer_ids.index(layer_idx)
                sel = sel[li:li + 1]
            if head_idx is not None:
                if head_idx >= sel.shape[1]:
                    continue
                sel = sel[:, head_idx:head_idx + 1]
            up = bicubic_resize(sel, (x, x), clamp_min=0.0)
            total = total + up.sum(dim=(0, 1))
            count += sel.shape[0] * sel.shape[1]
        if count == 0:
            if head_idx is not None or layer_idx is not None:
                raise RuntimeError('No heat maps found for the given parameters.')
            raise RuntimeError('No heat maps found. Did you forget to call '
                               '`with trace(...)` during generation?')
        return total / count

    def compute_global_heat_map(self, prompt: Optional[str] = None,
                                factors=None, head_idx: Optional[int] = None,
                                layer_idx: Optional[int] = None,
                                normalize: bool = False,
                                batch_idx: int = 0) -> GlobalHeatMap:
        """Aggregate the captured maps into a ``(tokens, x, x)`` global map
        (reference ``daam/trace.py:83-132``)."""
        if prompt is None:
            prompt = (self.last_prompts[batch_idx]
                      if batch_idx < len(self.last_prompts) else self.last_prompt)
        if factors is not None:
            factors = set(factors)
        with profiling.span('maps.global'):
            maps = self._aggregate_source(self.batch_heat_maps, batch_idx,
                                          factors, head_idx, layer_idx)
            n_tokens = len(self.pipe.tokenizer.tokenize(prompt))
            maps = maps[:n_tokens + 2]  # +1 SOS, +1 padding (ref trace.py:127)
            if normalize:
                maps = maps / (maps[1:-1].sum(0, keepdim=True) + 1e-6)
        return GlobalHeatMap(self.pipe.tokenizer, prompt, maps)

    def compute_time_global_heat_maps(self, prompt: Optional[str] = None,
                                      factors=None,
                                      head_idx: Optional[int] = None,
                                      layer_idx: Optional[int] = None,
                                      normalize: bool = False,
                                      batch_idx: int = 0
                                      ) -> List[GlobalHeatMap]:
        """Per-denoising-step global heat maps (``daam_tpu/trace.py:431-519``).

        One :class:`GlobalHeatMap` per sampling step, each aggregated like
        :meth:`compute_global_heat_map` over that step's attention alone.
        The source is the ``save_heads`` replay buffer (exact, also after
        ``load_heads_from``), or, without it, the accumulator snapshots of
        ``time_chunk_steps=K`` (one map per chunk of K steps)."""
        if self.time_blocks and not (self.save_heads or self.load_heads):
            return self._time_maps_from_blocks(prompt, factors, head_idx,
                                               layer_idx, normalize,
                                               batch_idx)
        try:
            saved = self.replay_buffer(0)
        except RuntimeError as e:
            raise RuntimeError(
                f'{e} (Per-step maps need either save_heads=True or the '
                f'cheap accumulator-snapshot mode: '
                f'trace(pipe, time_chunk_steps=1).)') from None
        if prompt is None:
            prompt = (self.last_prompts[batch_idx]
                      if batch_idx < len(self.last_prompts) else self.last_prompt)
        if factors is not None:
            factors = set(factors)
        x = int(math.sqrt(self.latent_hw))

        total, count = None, 0
        for factor, names, ids in self.capture_spec(self.pipe):
            if factors is not None and factor not in factors:
                continue
            pairs = list(zip(names, ids))
            if layer_idx is not None:
                pairs = [(nm, i) for nm, i in pairs if i == layer_idx]
            for nm, _i in pairs:
                a = saved[nm]                        # (S, 2B, H, hw, T)
                s_steps, two_b, n_heads, hw, _t = a.shape
                if head_idx is not None and head_idx >= n_heads:
                    continue                         # mirrors the sum path
                h = math.isqrt(hw)
                if h * h != hw:
                    raise RuntimeError('per-step heat maps require square '
                                       f'latents (layer {nm}: hw={hw})')
                cond = a[:, two_b // 2 + batch_idx]  # CFG conditional half
                if head_idx is not None:
                    cond = cond[:, head_idx:head_idx + 1]
                # (S, H', hw, T) -> (S, H', T, h, w) -> upsample -> sum heads
                m = cond.to(self.pipe.device, torch.float32).transpose(2, 3)
                m = m.reshape(s_steps, m.shape[1], -1, h, h)
                contrib = bicubic_resize(m, (x, x), clamp_min=0.0).sum(dim=1)
                total = contrib if total is None else total + contrib
                count += m.shape[1]
        if total is None or count == 0:
            raise RuntimeError('No heat maps found for the given parameters.')

        maps = total / count
        n_tokens = len(self.pipe.tokenizer.tokenize(prompt))
        maps = maps[:, :n_tokens + 2]
        if normalize:
            maps = maps / (maps[:, 1:-1].sum(1, keepdim=True) + 1e-6)
        return [GlobalHeatMap(self.pipe.tokenizer, prompt, maps[s])
                for s in range(maps.shape[0])]

    def _time_maps_from_blocks(self, prompt, factors, head_idx, layer_idx,
                               normalize, batch_idx) -> List[GlobalHeatMap]:
        """Per-chunk maps from the accumulator snapshots: each chunk's
        increase aggregates like :meth:`compute_global_heat_map`, so the
        chunk maps add up to the trajectory map."""
        if prompt is None:
            prompt = (self.last_prompts[batch_idx]
                      if batch_idx < len(self.last_prompts) else self.last_prompt)
        if factors is not None:
            factors = set(factors)
        n_tokens = len(self.pipe.tokenizer.tokenize(prompt))
        results = []
        for blk in self.time_blocks:
            maps = self._aggregate_source(blk, batch_idx, factors, head_idx,
                                          layer_idx)[:n_tokens + 2]
            if normalize:
                maps = maps / (maps[1:-1].sum(0, keepdim=True) + 1e-6)
            results.append(GlobalHeatMap(self.pipe.tokenizer, prompt, maps))
        return results


trace: Type[DiffusionHeatMapHooker] = DiffusionHeatMapHooker
