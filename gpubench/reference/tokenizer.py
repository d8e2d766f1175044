"""CLIP byte-level BPE in plain Python: the reference's token ids.

A frozen copy of the algorithm (lowercase, whitespace clean, CLIP's word
pattern, byte encoding, BPE merges, the ``</w>`` end-of-word marker) and of
the DAAM word-to-token merge rule.  It reads the bundled CLIP vocabulary
(``vocab.json``, ``merges.txt``) as raw files; it imports nothing of the
program.
"""

import json
import re
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

#: The bundled CLIP vocabulary in the checkout, read as data.
VOCAB_DIR = Path(__file__).resolve().parents[2] / 'daam_tpu' / 'data' / 'clip-bpe'

WORD_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE,
)
SOT_ID, EOT_ID, MAX_LENGTH = 49406, 49407, 77


@lru_cache(maxsize=1)
def _bytes_to_unicode() -> Dict[int, str]:
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


class Tokenizer:
    """``ids(prompt)``: the 77 padded ids; ``tokenize(text)``: the BPE
    tokens.  ``pad_id``: 49407 for CLIP-L, 0 for the OpenCLIP encoders."""

    def __init__(self, pad_id: int, vocab_dir: Path = VOCAB_DIR):
        with (vocab_dir / 'vocab.json').open(encoding='utf-8') as f:
            self.encoder = json.load(f)
        merges: List[Tuple[str, str]] = []
        with (vocab_dir / 'merges.txt').open(encoding='utf-8') as f:
            for line in f:
                line = line.strip()
                if line and not line.startswith('#version'):
                    a, _, b = line.partition(' ')
                    merges.append((a, b))
        self.ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.pad_id = pad_id
        self._cache: Dict[str, List[str]] = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token[:-1]) + [token[-1] + '</w>']
        while len(word) > 1:
            pairs = [(word[i], word[i + 1]) for i in range(len(word) - 1)]
            best = min(pairs, key=lambda p: self.ranks.get(p, float('inf')))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def tokenize(self, text: str) -> List[str]:
        text = re.sub(r'\s+', ' ', text).strip().lower()
        tokens: List[str] = []
        for chunk in WORD_PATTERN.findall(text):
            if chunk in ('<|startoftext|>', '<|endoftext|>'):
                tokens.append(chunk)
                continue
            chunk = ''.join(self.byte_encoder[b] for b in chunk.encode('utf-8'))
            tokens.extend(self._bpe(chunk))
        return tokens

    def ids(self, prompt: str) -> List[int]:
        body = [self.encoder.get(t, EOT_ID) for t in self.tokenize(prompt)]
        ids = [SOT_ID] + body[:MAX_LENGTH - 2] + [EOT_ID]
        return ids + [self.pad_id] * (MAX_LENGTH - len(ids))

    def batch_ids(self, prompts: Sequence[str]) -> List[List[int]]:
        return [self.ids(p) for p in prompts]

    def merge_indices(self, prompt: str, word: str) -> List[int]:
        """Rows of the global map that ``word`` occupies: every occurrence
        of its token run in the prompt, shifted by one for the start token
        (DAAM's ``compute_token_merge_indices``).  Raises ``ValueError``
        when the word is absent."""
        tokens = [t.replace('</w>', '') for t in self.tokenize(prompt.lower())]
        search = [t.replace('</w>', '') for t in self.tokenize(word.lower())]
        idx = [s + i for s in range(len(tokens))
               if tokens[s:s + len(search)] == search
               for i in range(len(search))]
        if not idx:
            raise ValueError(f'word {word!r} not in {prompt!r}')
        return [i + 1 for i in idx]
