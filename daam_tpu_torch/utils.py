"""Utility layer: seeds, the cache directory and token→word merge arithmetic.

PyTorch counterpart of ``daam_tpu/utils.py``.  :func:`cache_dir` and
:func:`compute_token_merge_indices` are copies (held equal to ``daam_tpu``'s
by ``tests/test_torch_shared.py``); the cache directory is the same one, so
a replay buffer persisted by either package is found by the other.
:func:`compute_token_merge_indices` has the reference semantics (``daam/utils.py:73-91``): lowercase
tokenization, ``</w>`` marker stripping, *all-occurrence* subword-run
matching, and the +1 shift for the SOS token.  :func:`set_seed` returns a
``torch.Generator``, as the reference does (``daam/utils.py:46-55``).
:func:`randn_tensor` draws a batch's initial noise from one generator, or
from one per sample so that a sample's noise does not depend on the batch
it rides in (``daam_tpu`` draws from stacked keys under ``jax.vmap``).
"""

import os
import random
import sys
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .nlp import cached_nlp  # noqa: F401  (re-exported, as the reference does)

__all__ = ['set_seed', 'compute_token_merge_indices', 'plot_mask_heat_map',
           'cached_nlp', 'cache_dir', 'auto_device', 'auto_autocast',
           'resolve_device', 'randn_tensor']


def _to_pil(image):
    """A PIL image of ``image``, which may be (H, W, 3) floats in [0, 1],
    rounded to uint8."""
    import PIL.Image

    if isinstance(image, PIL.Image.Image):
        return image
    u8 = np.clip(np.asarray(image) * 255 + 0.5, 0, 255).astype(np.uint8)
    return PIL.Image.fromarray(u8)


def set_seed(seed: int, device='cuda') -> torch.Generator:
    """Seed Python/NumPy RNGs and return a ``torch.Generator`` on ``device``
    seeded with ``seed`` (pass it to pipeline calls).  The card by default,
    as the reference's is; without one this raises."""
    random.seed(seed)
    np.random.seed(seed & 0xFFFFFFFF)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def resolve_device(device='cuda') -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without one raises
    (the port never falls back to the CPU unless asked to)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f'device {device}: no CUDA device is available; '
                           f'pass cpu to run on the CPU')
    return device


def auto_device(obj=None, device='cuda'):
    """The card as a ``torch.device``, or ``obj`` (a tensor or module)
    moved to it (reference ``daam/utils.py:22-29``); without a card this
    raises, as :func:`resolve_device` does."""
    device = resolve_device(device)
    return device if obj is None else obj.to(device)


class auto_autocast:
    """``torch.autocast`` on the card (reference ``daam/utils.py:32-36``);
    the arguments are ``torch.autocast``'s after the device type."""

    def __init__(self, *args, device_type: str = 'cuda', **kwargs):
        self._autocast = torch.autocast(device_type, *args, **kwargs)

    def __enter__(self):
        self._autocast.__enter__()
        return self

    def __exit__(self, *exc):
        return self._autocast.__exit__(*exc)


def randn_tensor(shape: Sequence[int],
                 generator: Union[torch.Generator, Sequence[torch.Generator], None],
                 device) -> torch.Tensor:
    """Standard normal noise of ``shape`` on ``device``.  One generator
    draws the whole tensor; a list of ``shape[0]`` generators draws one
    ``(1, *shape[1:])`` sample each, on that generator's own device (a CUDA
    generator's numbers differ from a CPU one's), and the samples are
    concatenated."""
    if isinstance(generator, (list, tuple)):
        if len(generator) != shape[0]:
            raise ValueError(f'{len(generator)} generators for a batch of '
                             f'{shape[0]}: pass one per sample')
        return torch.cat([randn_tensor((1, *shape[1:]), g, device)
                          for g in generator])
    draw_on = generator.device if generator is not None else device
    return torch.randn(tuple(shape), generator=generator,
                       device=draw_on).to(device)


def cache_dir() -> Path:
    """Per-OS cache directory (same layout as reference ``daam/utils.py:58-70``)."""
    if os.name == 'posix' and sys.platform != 'darwin':
        xdg = os.environ.get('XDG_CACHE_HOME', os.path.expanduser('~/.cache'))
        return Path(xdg, 'daam_tpu')
    elif sys.platform == 'darwin':
        return Path(os.path.expanduser('~'), 'Library/Caches/daam_tpu')
    else:
        local = os.environ.get('LOCALAPPDATA', None) \
            or os.path.expanduser('~\\AppData\\Local')
        return Path(local, 'daam_tpu')


def compute_token_merge_indices(tokenizer, prompt: str, word: str,
                                word_idx: Optional[int] = None,
                                offset_idx: int = 0) -> Tuple[List[int], Optional[int]]:
    """Map a word to the token indices it occupies in the padded prompt encoding.

    Semantics mirror reference ``daam/utils.py:73-91`` exactly: the prompt and
    word are lowercased and tokenized, ``</w>`` subword markers stripped, every
    occurrence of the word's token run is matched, and all indices are shifted
    by +1 for the SOS token.  Raises ``ValueError`` if the word is absent.
    """
    merge_idxs: List[int] = []
    tokens = tokenizer.tokenize(prompt.lower())
    tokens = [x.replace('</w>', '') for x in tokens]

    if word_idx is None:
        word = word.lower()
        search_tokens = [x.replace('</w>', '') for x in tokenizer.tokenize(word)]
        start_indices = [x + offset_idx for x in range(len(tokens))
                         if tokens[x:x + len(search_tokens)] == search_tokens]
        for start in start_indices:
            merge_idxs += [i + start for i in range(len(search_tokens))]
        if not merge_idxs:
            raise ValueError(f'Search word {word} not found in prompt!')
    else:
        merge_idxs.append(word_idx)

    return [x + 1 for x in merge_idxs], word_idx


def plot_mask_heat_map(im, heat_map, threshold: float = 0.4):
    """Plot the image masked by ``heat_map > threshold``
    (reference ``daam/utils.py:39-43``; needs matplotlib)."""
    import matplotlib.pyplot as plt

    im = np.asarray(im, dtype=np.float32) / 255
    mask = (np.squeeze(np.asarray(torch.as_tensor(heat_map).cpu()))
            > threshold).astype(np.float32)
    plt.imshow(im * mask[..., None])
