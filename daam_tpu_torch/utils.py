"""Utility layer: seeds, the cache directory and token→word merge arithmetic.

PyTorch counterpart of ``daam_tpu/utils.py``.  :func:`cache_dir` and
:func:`compute_token_merge_indices` are copies (held equal to ``daam_tpu``'s
by ``tests/test_torch_shared.py``); the cache directory is the same one, so
a replay buffer persisted by either package is found by the other.
:func:`compute_token_merge_indices` has the reference semantics (``daam/utils.py:73-91``): lowercase
tokenization, ``</w>`` marker stripping, *all-occurrence* subword-run
matching, and the +1 shift for the SOS token.  :func:`set_seed` returns a
``torch.Generator``, as the reference does (``daam/utils.py:46-55``).
"""

import os
import random
import sys
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = ['set_seed', 'cache_dir', 'compute_token_merge_indices',
           'resolve_device']


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
