"""The port's native C++ BPE against its Python BPE, and the selector.

Mirrors ``tests/test_native_bpe.py``: on a small vocabulary and on the
bundled CLIP vocabulary over the prompts the CLI tests use, the native
tokenizer gives the Python BPE's tokens and ids, with padding and with
truncation at 77.  ``default_tokenizer`` prefers it and honours
``prefer_native=False``; a core that fails to build warns once, naming its
build log, and the Python BPE takes over.  The library is built under the
checkout's ``build/``, never inside the package.
"""

import json
import pickle
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest

from daam_tpu_torch import tokenization
from daam_tpu_torch.native import NativeBpeTokenizer, bpe_binding, library_path, native_available
from daam_tpu_torch.tokenization import BUNDLED_VOCAB_DIR, ClipBpeTokenizer, default_tokenizer

from test_torch_cli import CAPTIONS, CORPUS
from test_torch_shared import PROMPTS

REPO = Path(__file__).resolve().parents[1]
STRINGS = ['the dog runs', 'A Dog, RUNNING!   fast', "the dog's cat", 'dq zz xx',
           '3 dogs and 42 cats.', '', '   ', 'the the the dog dog']


def _corpus():
    words = [line.split('\t')[0] for line in
             (REPO / 'data' / 'vocab-small.tsv').read_text().splitlines()[1:40]]
    return ([c['caption'] for c in CAPTIONS] + [p for _, p, _ in CORPUS] + PROMPTS
            + [f'a {w} and two {w}s' for w in words]
            + [' '.join(['a very long prompt about dogs and cats'] * 15)])


@pytest.fixture(scope='module')
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp('vocab')
    vocab = {}
    for t in 'abcdefghijklmnopqrstuvwxyz.,!?\'0123456789':
        vocab[t] = len(vocab)
        vocab[t + '</w>'] = len(vocab)
    merges = [('d', 'o'), ('do', 'g</w>'), ('r', 'u'), ('ru', 'n'),
              ('run', 's</w>'), ('run', 'n'), ('runn', 'i'), ('runni', 'n'),
              ('runnin', 'g</w>'), ('t', 'h'), ('th', 'e</w>'), ('a', '</w>'),
              ('c', 'a'), ('ca', 't</w>'), ("'", 's</w>')]
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    vocab['<|startoftext|>'] = len(vocab)
    vocab['<|endoftext|>'] = len(vocab)
    (d / 'vocab.json').write_text(json.dumps(vocab))
    (d / 'merges.txt').write_text('#version: 0.2\n' + '\n'.join(f'{a} {b}' for a, b in merges))
    return d


@pytest.fixture(scope='module')
def small(vocab_dir):
    assert native_available()
    return (ClipBpeTokenizer.from_pretrained(vocab_dir),
            NativeBpeTokenizer.from_pretrained(vocab_dir))


@pytest.fixture(scope='module')
def bundled():
    return (ClipBpeTokenizer.from_pretrained(BUNDLED_VOCAB_DIR, pad_id=0),
            NativeBpeTokenizer.from_pretrained(BUNDLED_VOCAB_DIR, pad_id=0))


@pytest.mark.parametrize('text', STRINGS)
def test_small_vocab_parity(small, text):
    py, cc = small
    assert cc.tokenize(text) == py.tokenize(text)
    assert cc.encode(text) == py.encode(text)
    assert cc.encode(text, add_special_tokens=False) == py.encode(text, add_special_tokens=False)


def test_small_vocab_ids_and_call(small):
    py, cc = small
    toks = py.tokenize('the dog runs') + ['<|startoftext|>', 'zz-not-a-token']
    assert cc.convert_tokens_to_ids(toks) == py.convert_tokens_to_ids(toks)
    a, b = (t(['the dog', 'a cat runs'], return_tensors='np') for t in (py, cc))
    np.testing.assert_array_equal(a['input_ids'], b['input_ids'])
    np.testing.assert_array_equal(a['attention_mask'], b['attention_mask'])
    assert (cc.sot_id, cc.eot_id, cc.pad_id, cc.vocab_size) == \
        (py.sot_id, py.eot_id, py.pad_id, py.vocab_size)


def test_corpus_parity(bundled):
    """Tokens, ids, padded ids and masks equal over the CLI tests' prompts;
    the long prompt truncates to 77 with EOT last."""
    py, cc = bundled
    corpus = _corpus()
    for text in corpus:
        assert cc.tokenize(text) == py.tokenize(text), text
        for kwargs in ({}, {'truncation': False}, {'add_special_tokens': False}):
            assert cc.encode(text, **kwargs) == py.encode(text, **kwargs), (text, kwargs)
    for kwargs in ({'padding': False}, {'max_length': 20}):
        assert cc(corpus, **kwargs) == py(corpus, **kwargs), kwargs
    a, b = (t(corpus, return_tensors='np') for t in (py, cc))
    for key in ('input_ids', 'attention_mask'):
        np.testing.assert_array_equal(b[key], a[key])
    long = cc(corpus[-1])
    assert len(long['input_ids']) == 77 and sum(long['attention_mask']) == 77
    assert long['input_ids'][0] == cc.sot_id and long['input_ids'][-1] == cc.eot_id
    short = cc('a dog')
    assert short['input_ids'][3] == cc.eot_id and short['input_ids'][4:] == [0] * 73
    assert sum(short['attention_mask']) == 4


def test_threads_share_one_tokenizer(bundled):
    """Eight threads tokenize and encode new words at once through one
    native tokenizer, as the demo server's handler threads and its batch
    thread do: every result equals the Python BPE's."""
    py, _ = bundled
    cc = NativeBpeTokenizer.from_pretrained(BUNDLED_VOCAB_DIR, pad_id=0)  # a cold merge cache
    rng = np.random.default_rng(0)
    letters = list('abcdefghijklmnopqrstuvwxyz')
    texts = [[' '.join(''.join(rng.choice(letters, rng.integers(3, 12))) for _ in range(6))
              for _ in range(200)] for _ in range(8)]
    want = [[(py.tokenize(t), py.encode(t)) for t in share] for share in texts]
    got = [None] * len(texts)
    start = threading.Barrier(len(texts))

    def work(k):
        start.wait()
        got[k] = [(cc.tokenize(t), cc.encode(t)) for t in texts[k]]

    threads = [threading.Thread(target=work, args=(k,)) for k in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert got == want


def test_pickles_by_its_vocabulary(bundled):
    _, cc = bundled
    again = pickle.loads(pickle.dumps(cc))
    assert isinstance(again, NativeBpeTokenizer) and again.pad_id == 0
    text = 'A Dog, RUNNING!   fast'
    assert again.tokenize(text) == cc.tokenize(text) and again.encode(text) == cc.encode(text)


def test_default_tokenizer_prefers_native(vocab_dir):
    native, python = default_tokenizer(vocab_dir), default_tokenizer(vocab_dir, prefer_native=False)
    assert isinstance(native, NativeBpeTokenizer)
    assert type(python) is ClipBpeTokenizer
    assert default_tokenizer(vocab_dir) is native
    assert default_tokenizer(vocab_dir, prefer_native=False) is python
    assert native.tokenize('dog') == python.tokenize('dog') == ['dog</w>']
    assert isinstance(default_tokenizer(), NativeBpeTokenizer)


def test_library_builds_under_build_not_the_package():
    assert native_available()
    path = library_path()
    assert path.exists() and (path.parent / 'build.log').exists()
    assert path.is_relative_to(REPO / 'build' / 'daam_tpu_torch')
    package = REPO / 'daam_tpu_torch' / 'native'
    assert sorted(p.name for p in package.iterdir() if p.suffix not in ('.pyc',)
                  and p.name != '__pycache__') == \
        ['__init__.py', 'bpe.cpp', 'bpe_binding.py', 'unicode_ranges.inc']


def test_failed_build_falls_back_with_one_warning(vocab_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(bpe_binding, '_BUILD_ROOT', tmp_path / 'bpe')
    monkeypatch.setattr(bpe_binding, 'CXX_FLAGS', (*bpe_binding.CXX_FLAGS, '--no-such-flag'))
    monkeypatch.setattr(bpe_binding, '_lib', None)
    monkeypatch.setattr(bpe_binding, '_failed', False)
    monkeypatch.setattr(tokenization, '_DEFAULT_CACHE', {})
    log = library_path().parent / 'build.log'
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        tok = default_tokenizer(vocab_dir)
        assert default_tokenizer(vocab_dir, pad_id=0).pad_id == 0
        assert not native_available()
    assert type(tok) is ClipBpeTokenizer and tok.tokenize('the dog') == ['the</w>', 'dog</w>']
    messages = [str(w.message) for w in caught]
    assert len(messages) == 1 and str(log) in messages[0]
    assert 'no-such-flag' in log.read_text()
    assert not library_path().exists()
    with pytest.raises(RuntimeError, match='unavailable'):
        NativeBpeTokenizer.from_pretrained(vocab_dir)
