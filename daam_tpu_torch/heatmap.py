"""Heat-map aggregation and word-level queries, in PyTorch.

Counterpart of ``daam_tpu/heatmap.py`` for the traced main path:
:class:`GlobalHeatMap` (a ``(tokens, x, x)`` map queryable by word, with
subword merging), :class:`WordHeatMap` (with ``expand_as``, ``value`` and
``compute_ioa``) and
:class:`RawHeatMapCollection` (whole per-factor blocks registered with
``update_block``, or one map at a time with ``update``), and the parsed
views of a global map (:class:`ParsedHeatMap` per word of the prompt,
:class:`SyntacticHeatMapPair` per dependency relation), from the tokens of
:func:`~daam_tpu_torch.nlp.cached_nlp`.  Bicubic resampling is
``F.interpolate(mode='bicubic', align_corners=False)``, the op
``daam_tpu/ops/resize.py`` reproduces (``tests/test_resize.py`` pins the
two equal).  A word's overlay is drawn on the host
(:func:`plot_overlay_heat_map`) or on the card (:func:`plot_overlay_on_card`);
:func:`save_image` and :func:`save_overlay` write an experiment's PNGs and
are the one place that chooses between the two, from the device its maps
were made on and the image.
"""

import threading
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .evaluate import compute_ioa
from .nlp import cached_nlp
from .profiling import span
from .utils import _to_pil, compute_token_merge_indices

__all__ = ['GlobalHeatMap', 'RawHeatMapCollection', 'WordHeatMap',
           'ParsedHeatMap', 'SyntacticHeatMapPair', 'plot_overlay_heat_map',
           'plot_overlay_on_card', 'save_image', 'save_overlay', 'bicubic_resize']

RawHeatMapKey = Tuple[int, int, int]  # (factor, layer, head)


def bicubic_resize(x: torch.Tensor, size: Tuple[int, int],
                   clamp_min: Optional[float] = None) -> torch.Tensor:
    """Resize the last two dims of ``x`` (any leading dims) in fp32, with
    the reference's optional undershoot clamp (``daam/trace.py:116``)."""
    lead = x.shape[:-2]
    flat = x.float().reshape(1, -1, *x.shape[-2:])
    out = F.interpolate(flat, size=tuple(size), mode='bicubic',
                        align_corners=False)
    if clamp_min is not None:
        out = out.clamp(min=clamp_min)
    return out.reshape(*lead, *size)


#: matplotlib's ``jet`` colormap (its segment data, ``matplotlib/_cm.py``):
#: per channel, breakpoints and values, sampled into 256 entries as
#: matplotlib samples it
_JET_SEGMENTS = (((0.0, 0.35, 0.66, 0.89, 1.0), (0.0, 0.0, 1.0, 1.0, 0.5)),
                 ((0.0, 0.125, 0.375, 0.64, 0.91, 1.0), (0.0, 0.0, 1.0, 1.0, 0.0, 0.0)),
                 ((0.0, 0.11, 0.34, 0.65, 1.0), (0.5, 1.0, 1.0, 0.0, 0.0)))
_JET_LUT = np.stack([np.interp(np.linspace(0.0, 1.0, 256), xs, ys)
                     for xs, ys in _JET_SEGMENTS], axis=-1)


def _jet(levels: np.ndarray) -> np.ndarray:
    """RGB of ``levels`` in [0, 1] through the 256-entry jet table, indexed
    as ``matplotlib.colormaps['jet']`` indexes it."""
    return _JET_LUT[np.clip((levels * 256).astype(np.int64), 0, 255)]


def _jet_composite(image_u8: np.ndarray, heat: np.ndarray,
                   color_normalize: bool) -> np.ndarray:
    """``photo·(1−heat) + jet·heat`` — the reference's two stacked
    ``imshow`` calls in one array (``daam_tpu/heatmap.py:33-54``)."""
    if color_normalize:
        lo, hi = float(heat.min()), float(heat.max())
        levels = (heat - lo) / (hi - lo) if hi > lo else np.zeros_like(heat)
    else:
        levels = np.clip(heat, 0.0, 1.0)
    photo = np.asarray(image_u8, dtype=np.float32) / 255.0
    w = np.clip(heat, 0.0, 1.0)[..., None]
    return np.clip(photo * (1.0 - w) + _jet(levels) * w, 0.0, 1.0)


def _pyplot():
    """matplotlib's ``pyplot``, or None where matplotlib is not installed."""
    try:
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def _draw(plt, composite, word, out_file, ax) -> None:
    """Show ``composite`` on ``ax`` titled with ``ax.set_title`` when an
    axes is given, else on a cleared current figure titled with ``word``;
    ``out_file`` receives the current figure."""
    target = ax
    if target is None:
        plt.clf()
        plt.rcParams.update({'font.size': 24})
        target = plt
    target.imshow(composite)
    if word is not None:
        (plt.title if ax is None else ax.set_title)(word)
    if out_file is not None:
        plt.savefig(out_file)


def plot_overlay_heat_map(im, heat_map, word: Optional[str] = None,
                          out_file=None, crop: Optional[int] = None,
                          color_normalize: bool = True, ax=None):
    """Jet-colormap heat-map overlay (reference ``daam/heatmap.py:20-53``),
    drawn as ``daam_tpu`` draws it (``daam_tpu/heatmap.py:57-80``): image
    and map cropped by ``crop`` pixels on each side, the composite shown on
    ``ax`` and titled with ``ax.set_title`` when an axes is given, else on a
    cleared current figure titled with ``word``; ``out_file`` receives the
    current figure.  Where matplotlib is not installed, ``out_file``
    receives the composite itself, at the (cropped) image's size, without
    title or axes."""
    with span('overlay.composite'):
        im = np.asarray(im)
        heat_map = np.squeeze(np.asarray(heat_map, dtype=np.float32))
        if crop:
            im = im[crop:-crop, crop:-crop]
            heat_map = heat_map[crop:-crop, crop:-crop]
        composite = _jet_composite(im, heat_map, color_normalize)
    with span('overlay.encode'):
        plt = _pyplot()
        if plt is not None:
            _draw(plt, composite, word, out_file, ax)
        elif out_file is not None:
            _to_pil(composite).save(out_file)


_jet_tables: Dict[torch.device, torch.Tensor] = {}
_pinned = threading.local()  # each thread's host buffer for scanlines
_uploaded = threading.local()  # each thread's last image uploaded to a card


def _scanlines_to_host(rows: torch.Tensor) -> np.ndarray:
    """Copy scanlines from the card into this thread's pinned host buffer
    (grown as needed, reused from call to call) and return them as numpy,
    valid until the thread's next call.  The copy synchronizes."""
    n = rows.numel()
    buf = getattr(_pinned, 'buf', None)
    if buf is None or buf.numel() < n:
        buf = _pinned.buf = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    host = buf[:n].view(rows.shape)
    host.copy_(rows)
    return host.numpy()


def _on_card(image, device) -> Optional[torch.Tensor]:
    """``image`` as (H, W, 3) uint8 on ``device`` where that is a CUDA
    device and ``image`` an RGB PIL image, else None: the host draws.  Each
    thread keeps the last image object it uploaded, so the PNGs of one
    image upload it once."""
    if device is None or torch.device(device).type != 'cuda' \
            or getattr(image, 'mode', None) != 'RGB':
        return None
    last = getattr(_uploaded, 'last', None)
    if last is None or last[0] is not image or last[1] != torch.device(device):
        last = _uploaded.last = (image, torch.device(device),
                                 torch.from_numpy(np.array(image)).to(device))
    return last[2]


def save_image(image, out_file, device=None) -> None:
    """Write ``image`` (PIL, or (H, W, 3) floats in [0, 1]) as a PNG, its
    rows filtered on the card and deflated here (:mod:`daam_tpu_torch.png`)
    where ``device``, the device its maps were made on, is a CUDA device and
    ``image`` an RGB PIL image; else by Pillow."""
    on_card = _on_card(image, device)
    if on_card is None:
        _to_pil(image).save(out_file)
        return
    from . import png
    from .ops import kernels
    png.write_png(out_file, _scanlines_to_host(kernels.png_scanlines(on_card)))


def save_overlay(image, word_map: 'WordHeatMap', out_file,
                 color_normalize: bool = True, device=None) -> None:
    """Write ``word_map.plot_overlay(image, out_file, color_normalize)``:
    on the card (:func:`plot_overlay_on_card`) where :func:`save_image`
    would write ``image`` there and the map expands to the image's own
    size, else on the host from one resample."""
    on_card = _on_card(image, device)
    if on_card is not None and \
            WordHeatMap.expanded_size(image) == tuple(on_card.shape[:2]):
        plot_overlay_on_card(on_card, word_map.heatmap, word=word_map.word,
                             out_file=out_file, color_normalize=color_normalize)
    else:
        word_map.expand_as(image, color_normalize=color_normalize,
                           out_file=out_file, plot=True)


def plot_overlay_on_card(image: torch.Tensor, heat_map, word: Optional[str] = None,
                         out_file=None, color_normalize: bool = True) -> None:
    """:func:`plot_overlay_heat_map` of ``WordHeatMap.expand_as``'s map,
    drawn on the card by the kernels of ``csrc/overlay.cu``: ``image`` is
    the (H, W, 3) uint8 image on a CUDA device, ``heat_map`` the word's
    (h, w) map, resampled there to (H, W) and min-max normalized as
    ``expand_as`` does it, composited and rounded to uint8.  Where
    matplotlib is not installed, ``out_file`` receives the PNG from the
    card's filtered scanlines, deflated here (:mod:`daam_tpu_torch.png`;
    the ``overlay.encode`` span states the stripes it took, 0 where none);
    else the composite is drawn as :func:`plot_overlay_heat_map` draws it."""
    from . import png
    from .ops import kernels

    H, W = image.shape[:2]
    with span('overlay.resize'):
        heat = torch.as_tensor(heat_map).to(image.device, torch.float32).contiguous()
        resampled = kernels.overlay_resample(heat, (H, W))
    plt = _pyplot()
    with span('overlay.composite'):
        lut = _jet_tables.get(image.device)
        if lut is None:
            lut = _jet_tables[image.device] = torch.from_numpy(_JET_LUT).to(image.device)
        rows = _scanlines_to_host(kernels.png_scanlines(
            image, resampled, lut, color_normalize=color_normalize, filtered=plt is None))
    with span('overlay.encode', stripes=0) as encode:
        if plt is not None:
            _draw(plt, rows[:, 1:].reshape(H, W, 3).copy(), word, out_file, None)
        elif out_file is not None:
            encode.set(stripes=png.write_png(out_file, rows))


class WordHeatMap:
    """Heat map for one (merged) word (reference ``daam/heatmap.py:56-96``)."""

    def __init__(self, heatmap: torch.Tensor, word: Optional[str] = None,
                 word_idx: Optional[int] = None):
        self.word = word
        self.word_idx = word_idx
        self.heatmap = heatmap  # (h, w)

    @property
    def value(self) -> torch.Tensor:
        return self.heatmap

    def compute_ioa(self, other: 'WordHeatMap') -> float:
        """Intersection over this map's area against ``other``'s grid
        (``daam_tpu/heatmap.py:134``), on this map's device."""
        return compute_ioa(self.heatmap, other.heatmap,
                           device=torch.as_tensor(self.heatmap).device)

    def plot_overlay(self, image, out_file=None, color_normalize: bool = True,
                     ax=None, **expand_kwargs):
        self._plot_expanded(image, self.expand_as(image, **expand_kwargs),
                            out_file, color_normalize, ax)

    def _plot_expanded(self, image, heat, /, out_file=None,
                       color_normalize: bool = True, ax=None, **_):
        """:meth:`plot_overlay` of a map already expanded; the keywords
        that it would hand on to ``expand_as`` are left out, as there."""
        plot_overlay_heat_map(image, heat, word=self.word, out_file=out_file,
                              color_normalize=color_normalize, ax=ax)

    @staticmethod
    def expanded_size(image) -> Tuple[int, int]:
        """The size :meth:`expand_as` resamples to: a PIL image's ``size``
        (w, h) taken as (rows, columns), as the reference takes it, else
        the array's (rows, columns)."""
        if hasattr(image, 'size') and not isinstance(image, np.ndarray):
            return image.size[0], image.size[1]
        arr = np.asarray(image)
        return arr.shape[0], arr.shape[1]

    def expand_as(self, image, absolute: bool = False,
                  threshold: Optional[float] = None, plot: bool = False,
                  **plot_kwargs) -> np.ndarray:
        """Bicubic-expand to the image's size with min-max normalization
        (reference ``daam/heatmap.py:77-93``).  With ``plot`` the overlay
        of the map as ``expand_as(image)`` returns it (normalized, not
        thresholded) is drawn, from this one resample."""
        size = self.expanded_size(image)
        with span('overlay.resize'):
            im = bicubic_resize(torch.as_tensor(self.heatmap), size)
            if not absolute or plot:
                normalized = (im - im.min()) / (im.max() - im.min() + 1e-8)
            if not absolute:
                im = normalized
            if threshold:
                im = (im > threshold).float()
            im = im.cpu().numpy()
            drawn = None
            if plot:
                drawn = im if not (absolute or threshold) else normalized.cpu().numpy()
        if plot:
            self._plot_expanded(image, drawn, **plot_kwargs)
        return im


@dataclass
class SyntacticHeatMapPair:
    head_heat_map: WordHeatMap
    dep_heat_map: WordHeatMap
    head_text: str
    dep_text: str
    relation: str


@dataclass
class ParsedHeatMap:
    word_heat_map: WordHeatMap
    token: Any  # spaCy token or daam_tpu_torch.nlp.Token


class GlobalHeatMap:
    """Token-level global heat map ``(tokens, x, x)``, queryable by word
    (reference ``daam/heatmap.py:114-142``)."""

    def __init__(self, tokenizer: Any, prompt: str, heat_maps):
        self.tokenizer = tokenizer
        self.heat_maps = heat_maps
        self.prompt = prompt
        self.compute_word_heat_map = lru_cache(maxsize=50)(self.compute_word_heat_map)

    def compute_word_heat_map(self, word: str, word_idx: Optional[int] = None,
                              offset_idx: int = 0) -> WordHeatMap:
        with span('maps.word'):
            merge_idxs, word_idx = compute_token_merge_indices(
                self.tokenizer, self.prompt, word, word_idx, offset_idx)
            maps = torch.as_tensor(self.heat_maps)
            return WordHeatMap(maps[merge_idxs].mean(0), word, word_idx)

    def parsed_heat_maps(self) -> Iterable[ParsedHeatMap]:
        """One map per word of the parsed prompt that the tokenizer finds
        (reference ``daam/heatmap.py:125-131``)."""
        for token in cached_nlp(self.prompt):
            try:
                heat_map = self.compute_word_heat_map(token.text)
                yield ParsedHeatMap(heat_map, token)
            except ValueError:
                pass

    def dependency_relations(self) -> Iterable[SyntacticHeatMapPair]:
        """Head and dependent maps of every non-root relation of the parse
        (reference ``daam/heatmap.py:133-142``)."""
        for token in cached_nlp(self.prompt):
            if token.dep_ != 'ROOT':
                try:
                    dep_heat_map = self.compute_word_heat_map(token.text)
                    head_heat_map = self.compute_word_heat_map(token.head.text)
                    yield SyntacticHeatMapPair(head_heat_map, dep_heat_map,
                                               token.head.text, token.text,
                                               token.dep_)
                except ValueError:
                    pass


class RawHeatMapCollection:
    """Per-(factor, layer, head) heat maps summed over timesteps
    (``daam_tpu/heatmap.py:193-262``): whole per-factor blocks ``(layers,
    heads, tokens, h, w)`` tagged with their global layer indices, as the
    traced pipeline registers them, and single maps added with
    :meth:`update` (the reference's per-call path)."""

    def __init__(self):
        self.ids_to_heatmaps: Dict[RawHeatMapKey, torch.Tensor] = {}
        self.blocks: Dict[int, Tuple[torch.Tensor, List[int]]] = {}

    def update(self, factor: int, layer_idx: int, head_idx: int, heatmap):
        """Accumulate one ``(tokens, h, w)`` map."""
        key = (factor, layer_idx, head_idx)
        heatmap = torch.as_tensor(heatmap).float()
        if key in self.ids_to_heatmaps:
            heatmap = self.ids_to_heatmaps[key] + heatmap
        self.ids_to_heatmaps[key] = heatmap

    def update_block(self, factor: int, block: torch.Tensor,
                     layer_ids: List[int]):
        block = torch.as_tensor(block).float()
        if factor in self.blocks:
            old, ids = self.blocks[factor]
            if ids != list(layer_ids):
                raise ValueError('layer ids changed between updates')
            block = old + block
        self.blocks[factor] = (block, list(layer_ids))

    def __iter__(self):
        """The reference's per-key view: ``((factor, layer, head), map)``,
        the single maps first."""
        yield from self.ids_to_heatmaps.items()
        for factor, (block, layer_ids) in self.blocks.items():
            for li, layer in enumerate(layer_ids):
                for head in range(block.shape[1]):
                    yield (factor, layer, head), block[li, head]

    def __len__(self):
        return len(self.ids_to_heatmaps) + sum(
            len(layer_ids) * block.shape[1]
            for block, layer_ids in self.blocks.values())

    def factors(self):
        return {k[0] for k, _ in self}

    def layers(self):
        return {k[1] for k, _ in self}

    def heads(self):
        return {k[2] for k, _ in self}

    def clear(self):
        self.ids_to_heatmaps.clear()
        self.blocks.clear()
