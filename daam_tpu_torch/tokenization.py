"""CLIP-compatible byte-level BPE tokenizer, pure Python, offline.

A copy of the pure-Python BPE of ``daam_tpu/tokenization.py`` and of its
vocabulary-free ``HashWordTokenizer`` (held equal to them, ids and tokens,
by ``tests/test_torch_shared.py``); :func:`default_tokenizer` prefers the
native C++ BPE of :mod:`daam_tpu_torch.native` where it builds.  The
tokenizer's word/subword behavior is load-bearing for heat-map queries
(reference ``daam/utils.py:73-91``).
The bundled vocabulary is read by file path from ``daam_tpu/data/clip-bpe``
in the checkout; nothing of ``daam_tpu`` is imported.
"""

from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union
import hashlib
import json
import re


__all__ = ['ClipBpeTokenizer', 'HashWordTokenizer', 'default_tokenizer',
           'WORD_PATTERN']


# CLIP's pre-tokenization pattern (contractions, letter runs, single digits,
# punctuation runs).  Python ``re`` lacks \p{L}; [^\W\d_] matches any unicode
# letter and \d any digit, which is equivalent for our purposes.  The
# punctuation class must include '_' (it is \w in Python but not \p{L}\p{N}
# in CLIP's [^\s\p{L}\p{N}]+ — ADVICE r1: dropping it shifts token indices
# vs HF CLIPTokenizer for prompts containing underscores).
WORD_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE,
)

SOT_TOKEN = '<|startoftext|>'
EOT_TOKEN = '<|endoftext|>'
CLIP_VOCAB_SIZE = 49408
SOT_ID = 49406
EOT_ID = 49407
MODEL_MAX_LENGTH = 77


def _whitespace_clean(text: str) -> str:
    return re.sub(r'\s+', ' ', text).strip()


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2/CLIP reversible byte→printable-unicode map (algorithmic, no data files)."""
    bs = list(range(ord('!'), ord('~') + 1)) + list(range(ord('¡'), ord('¬') + 1)) \
        + list(range(ord('®'), ord('ÿ') + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class _TokenizerBase:
    """Shared surface: special ids, encoding with SOS/EOS + padding to 77."""

    sot_token = SOT_TOKEN
    eot_token = EOT_TOKEN
    model_max_length = MODEL_MAX_LENGTH

    def __init__(self, vocab_size: int = CLIP_VOCAB_SIZE, sot_id: int = SOT_ID,
                 eot_id: int = EOT_ID, pad_id: Optional[int] = None):
        self.vocab_size = vocab_size
        self.sot_id = sot_id
        self.eot_id = eot_id
        # SD 1.x CLIP pads with <|endoftext|>; OpenCLIP (SD2) pads with 0 ("!").
        self.pad_id = eot_id if pad_id is None else pad_id

    # -- subclass hooks -----------------------------------------------------
    def tokenize(self, text: str) -> List[str]:
        raise NotImplementedError

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        raise NotImplementedError

    # -- shared API ---------------------------------------------------------
    def encode(self, text: str, add_special_tokens: bool = True,
               truncation: bool = True) -> List[int]:
        ids = self.convert_tokens_to_ids(self.tokenize(text))
        if truncation:
            ids = ids[:self.model_max_length - 2]
        if add_special_tokens:
            ids = [self.sot_id] + ids + [self.eot_id]
        return ids

    def __call__(self, text: Union[str, List[str]], padding: str = 'max_length',
                 truncation: bool = True, max_length: Optional[int] = None,
                 return_tensors: Optional[str] = None):
        if isinstance(text, str):
            texts = [text]
            squeeze = True
        else:
            texts = list(text)
            squeeze = False

        max_length = max_length or self.model_max_length
        all_ids, all_mask = [], []
        for t in texts:
            ids = self.encode(t, truncation=truncation)[:max_length]
            mask = [1] * len(ids)
            if padding in ('max_length', True, 'longest'):
                pad = max_length - len(ids)
                ids = ids + [self.pad_id] * pad
                mask = mask + [0] * pad
            all_ids.append(ids)
            all_mask.append(mask)

        if return_tensors == 'np':
            import numpy as np
            ids_out = np.asarray(all_ids, dtype=np.int32)
            mask_out = np.asarray(all_mask, dtype=np.int32)
        else:
            ids_out = all_ids
            mask_out = all_mask

        if squeeze and return_tensors is None:
            ids_out, mask_out = ids_out[0], mask_out[0]
        return {'input_ids': ids_out, 'attention_mask': mask_out}


class ClipBpeTokenizer(_TokenizerBase):
    """Byte-level BPE tokenizer compatible with CLIP ``vocab.json``/``merges.txt``.

    Reimplementation of the algorithm (lowercase → whitespace clean → word regex
    → byte encode → BPE merges → ``</w>`` end-of-word marker); loads its data
    from local files only.
    """

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 pad_id: Optional[int] = None):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self._bpe_cache: Dict[str, str] = {}
        sot = self.encoder.get(SOT_TOKEN, SOT_ID)
        eot = self.encoder.get(EOT_TOKEN, EOT_ID)
        super().__init__(vocab_size=max(len(self.encoder), max(self.encoder.values()) + 1),
                         sot_id=sot, eot_id=eot, pad_id=pad_id)

    @classmethod
    def from_pretrained(cls, path: Union[str, Path], pad_id: Optional[int] = None
                        ) -> 'ClipBpeTokenizer':
        """Load from a local directory containing ``vocab.json`` and ``merges.txt``
        (the on-disk format of a diffusers/transformers CLIP tokenizer)."""
        path = Path(path)
        if (path / 'tokenizer').is_dir():
            path = path / 'tokenizer'
        with (path / 'vocab.json').open(encoding='utf-8') as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with (path / 'merges.txt').open(encoding='utf-8') as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith('#version'):
                    continue
                a, _, b = line.partition(' ')
                merges.append((a, b))
        return cls(vocab, merges, pad_id=pad_id)

    def _bpe(self, token: str) -> str:
        if token in self._bpe_cache:
            return self._bpe_cache[token]
        word = tuple(token[:-1]) + (token[-1] + '</w>',)
        pairs = _get_pairs(word)
        if not pairs:
            return token + '</w>'
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float('inf')))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = ' '.join(word)
        self._bpe_cache[token] = out
        return out

    def tokenize(self, text: str) -> List[str]:
        text = _whitespace_clean(text).lower()
        tokens: List[str] = []
        for chunk in WORD_PATTERN.findall(text):
            if chunk in (SOT_TOKEN, EOT_TOKEN):
                # special-token literals pass through unsplit (HF treats them
                # as added tokens and never byte-encodes them)
                tokens.append(chunk)
                continue
            chunk = ''.join(self.byte_encoder[b] for b in chunk.encode('utf-8'))
            tokens.extend(self._bpe(chunk).split(' '))
        return tokens

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        return [self.encoder.get(t, self.eot_id) for t in tokens]

    def convert_ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self.decoder.get(i, EOT_TOKEN) for i in ids]

    def decode(self, ids: List[int], skip_special_tokens: bool = True) -> str:
        tokens = self.convert_ids_to_tokens(ids)
        if skip_special_tokens:
            tokens = [t for t in tokens if t not in (SOT_TOKEN, EOT_TOKEN)]
        text = ''.join(tokens).replace('</w>', ' ')
        data = bytearray(self.byte_decoder.get(c, ord(' ')) for c in text)
        return data.decode('utf-8', errors='replace').strip()



class HashWordTokenizer(_TokenizerBase):
    """Deterministic vocab-free tokenizer for offline / random-weight runs.

    Splits text with CLIP's word regex, chunks words longer than ``chunk_len``
    characters into subword pieces (so multi-token words exercise the same
    merge logic as real BPE; cf. reference ``daam/utils.py:76-84``), marks the
    final piece of each word with ``</w>``, and assigns stable ids by hashing
    the token string.  The same string always maps to the same id, across
    processes and machines.

    Caveat: hashing ~49k distinct token strings into a 49k id space WILL
    collide at corpus scale (birthday bound: ~2%% of tokens collide at 1,000
    distinct tokens).  Collisions are detected per-instance and warned about
    once — two colliding words condition the model identically.  This
    tokenizer is the last-resort fallback; the bundled CLIP-format BPE vocab
    is the default and has no collisions.
    """

    def __init__(self, vocab_size: int = CLIP_VOCAB_SIZE, chunk_len: int = 9,
                 pad_id: Optional[int] = None):
        super().__init__(vocab_size=vocab_size, pad_id=pad_id)
        self.chunk_len = chunk_len
        self._id_owner: Dict[int, str] = {}
        self._collision_warned = False

    def tokenize(self, text: str) -> List[str]:
        text = _whitespace_clean(text).lower()
        tokens: List[str] = []
        for chunk in WORD_PATTERN.findall(text):
            if chunk in (SOT_TOKEN, EOT_TOKEN):
                tokens.append(chunk)
                continue
            pieces = [chunk[i:i + self.chunk_len]
                      for i in range(0, len(chunk), self.chunk_len)] or ['']
            tokens.extend(pieces[:-1])
            tokens.append(pieces[-1] + '</w>')
        return tokens

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        ids = []
        span = self.vocab_size - 3  # reserve sot/eot/pad-adjacent top ids
        for t in tokens:
            if t == SOT_TOKEN:
                ids.append(self.sot_id)
            elif t == EOT_TOKEN:
                ids.append(self.eot_id)
            else:
                h = int.from_bytes(hashlib.md5(t.encode('utf-8')).digest()[:8], 'big')
                tid = 1 + h % (span - 1)
                owner = self._id_owner.setdefault(tid, t)
                if owner != t and not self._collision_warned:
                    self._collision_warned = True
                    import warnings
                    warnings.warn(
                        f'HashWordTokenizer id collision: {t!r} and {owner!r} '
                        f'both map to id {tid}; their heat maps are '
                        f'indistinguishable. Use the bundled BPE vocab '
                        f'(default_tokenizer()) for collision-free ids.')
                ids.append(tid)
        return ids


#: Bundled full-size CLIP-format vocabulary (49,408 entries) shipped with
#: ``daam_tpu``; used when no checkpoint supplies its own ``tokenizer/`` files.
BUNDLED_VOCAB_DIR = Path(__file__).resolve().parents[1] / 'daam_tpu' / 'data' / 'clip-bpe'

_DEFAULT_CACHE: Dict[Tuple[str, Optional[int], bool], _TokenizerBase] = {}


def default_tokenizer(model_dir: Optional[Union[str, Path]] = None,
                      pad_id: Optional[int] = None,
                      prefer_native: bool = True) -> _TokenizerBase:
    """The BPE tokenizer of ``model_dir`` (or its ``tokenizer/`` subdir) when
    it holds ``vocab.json``/``merges.txt``, else of the bundled vocabulary
    (``daam_tpu/tokenization.py:322-360``): the native (C++) BPE when
    ``prefer_native`` and it builds here, else the Python BPE, with the
    same ids and tokens.  Instances are cached per (path, pad_id,
    prefer_native)."""
    candidates = []
    if model_dir is not None:
        model_dir = Path(model_dir)
        candidates += [model_dir, model_dir / 'tokenizer']
    candidates.append(BUNDLED_VOCAB_DIR)
    for cand in candidates:
        if (cand / 'vocab.json').exists() and (cand / 'merges.txt').exists():
            key = (str(cand), pad_id, prefer_native)
            if key not in _DEFAULT_CACHE:
                _DEFAULT_CACHE[key] = _load_bpe(cand, pad_id, prefer_native)
            return _DEFAULT_CACHE[key]
    raise FileNotFoundError(f'no vocab.json/merges.txt in {candidates}')


def _load_bpe(path: Path, pad_id: Optional[int], prefer_native: bool) -> _TokenizerBase:
    if prefer_native:
        from .native import NativeBpeTokenizer, native_available

        if native_available():  # warns once, naming the build log, if not
            return NativeBpeTokenizer.from_pretrained(path, pad_id=pad_id)
    return ClipBpeTokenizer.from_pretrained(path, pad_id=pad_id)
