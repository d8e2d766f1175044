"""ctypes binding for the native CLIP BPE (``bpe.cpp``, a copy of
``daam_tpu/native/bpe.cpp`` held equal to it by ``tests/test_torch_shared.py``).

The core is compiled with ``g++ -O2 -std=c++17 -shared -fPIC`` at first
use, never at import, into
``build/daam_tpu_torch/bpe/<hash of the sources and flags>/libbpe.so`` in
the checkout (``build.log`` beside it holds the compiler's output), and
bound with :mod:`ctypes` as a ``PyDLL``: every call into the core holds
the GIL, because the core's per-handle merge cache (an unlocked
``std::unordered_map``) is read and written by ``tokenize``, and one
tokenizer is shared by every pipeline and by the demo server's threads.
:class:`NativeBpeTokenizer` has the surface of
:class:`~daam_tpu_torch.tokenization.ClipBpeTokenizer` and its ids and
tokens.  When the core does not build or load, :func:`native_available` is
False after one warning that names the build log, and
:func:`~daam_tpu_torch.tokenization.default_tokenizer` returns the Python
BPE: tokenization runs on the host, so it may fall back.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path
from typing import List, Optional, Union

from ..tokenization import _TokenizerBase, _whitespace_clean

__all__ = ['NativeBpeTokenizer', 'native_available', 'library_path']

_HERE = Path(__file__).resolve().parent
_SOURCES = ('bpe.cpp', 'unicode_ranges.inc')
_BUILD_ROOT = Path(__file__).resolve().parents[2] / 'build' / 'daam_tpu_torch' / 'bpe'
CXX_FLAGS = ('-O2', '-std=c++17', '-shared', '-fPIC')
_lock = threading.Lock()
_lib: Optional[ctypes.PyDLL] = None
_failed = False


def library_path() -> Path:
    """Build path keyed by the compiler flags and every source."""
    digest = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    for name in _SOURCES:
        digest.update(name.encode())
        digest.update((_HERE / name).read_bytes())
    return _BUILD_ROOT / digest.hexdigest()[:16] / 'libbpe.so'


def _build(out: Path) -> None:
    """Compile into ``out`` atomically, the compiler's output in
    ``build.log`` beside it; raises on failure."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    try:
        proc = subprocess.run(['g++', *CXX_FLAGS, str(_HERE / 'bpe.cpp'), '-o', str(tmp)],
                              capture_output=True, text=True, timeout=300)
        log = proc.stdout + proc.stderr
    except (OSError, subprocess.TimeoutExpired) as e:
        proc, log = None, f'g++ did not run: {e}\n'
    (out.parent / 'build.log').write_text(log)
    if proc is None or proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'g++ failed; see {out.parent / "build.log"}')
    os.replace(tmp, out)  # a concurrent build never sees half a file


def _load() -> Optional[ctypes.PyDLL]:
    """The bound core, built on first use; None (after one warning) when it
    cannot be built or loaded."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = library_path()
        try:
            if not path.exists():
                _build(path)
            lib = ctypes.PyDLL(str(path))  # holds the GIL: see the module docstring
        except (OSError, RuntimeError) as e:
            _failed = True
            warnings.warn(f'the native BPE is unavailable ({e}; build log '
                          f'{path.parent / "build.log"}): tokenizing with the '
                          f'Python BPE')
            return None
        ptr, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
        for fn, res, args in (
                (lib.daam_bpe_new, ptr, [s, s]),
                (lib.daam_bpe_free, None, [ptr]),
                (lib.daam_bpe_tokenize, i, [ptr, s, s, i]),
                (lib.daam_bpe_encode, i, [ptr, s, ctypes.POINTER(i), i, i]),
                (lib.daam_bpe_token_to_id, i, [ptr, s]),
                (lib.daam_bpe_sot_id, i, [ptr]),
                (lib.daam_bpe_eot_id, i, [ptr]),
                (lib.daam_bpe_vocab_size, i, [ptr])):
            fn.restype, fn.argtypes = res, args
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the native core builds and loads here."""
    return _load() is not None


class NativeBpeTokenizer(_TokenizerBase):
    """CLIP BPE tokenizer on the C++ core: ``tokenize``, ``encode``,
    ``__call__``, ``from_pretrained`` and ``pad_id`` as
    :class:`~daam_tpu_torch.tokenization.ClipBpeTokenizer` has them."""

    def __init__(self, vocab_json: Union[str, Path], merges_txt: Union[str, Path],
                 pad_id: Optional[int] = None):
        lib = _load()
        if lib is None:
            raise RuntimeError('the native BPE library is unavailable')
        self._lib = lib
        self._paths = (str(vocab_json), str(merges_txt))
        self._pad_id_arg = pad_id
        self._handle = lib.daam_bpe_new(str(vocab_json).encode(), str(merges_txt).encode())
        if not self._handle:
            raise RuntimeError(f'failed to load BPE data from {vocab_json}')
        super().__init__(vocab_size=lib.daam_bpe_vocab_size(self._handle),
                         sot_id=lib.daam_bpe_sot_id(self._handle),
                         eot_id=lib.daam_bpe_eot_id(self._handle), pad_id=pad_id)

    def __del__(self):
        if getattr(self, '_handle', None):
            self._lib.daam_bpe_free(self._handle)
            self._handle = None

    def __getstate__(self):
        """Pickled by its vocabulary's paths: an experiment saved with its
        tokenizer pickles it, and a ctypes handle does not pickle."""
        return {'paths': self._paths, 'pad_id': self._pad_id_arg}

    def __setstate__(self, state):
        self.__init__(*state['paths'], pad_id=state['pad_id'])

    @classmethod
    def from_pretrained(cls, path: Union[str, Path], pad_id: Optional[int] = None
                        ) -> 'NativeBpeTokenizer':
        """From a directory holding ``vocab.json`` and ``merges.txt`` (or
        its ``tokenizer/`` subdirectory)."""
        path = Path(path)
        if (path / 'tokenizer').is_dir():
            path = path / 'tokenizer'
        return cls(path / 'vocab.json', path / 'merges.txt', pad_id=pad_id)

    @staticmethod
    def _pretext(text: str) -> bytes:
        """Whitespace clean and unicode lowercase in Python; the core's
        ASCII ``tolower`` is then a no-op."""
        return _whitespace_clean(text).lower().encode('utf-8')

    def tokenize(self, text: str) -> List[str]:
        cap = max(4096, 8 * len(text) + 64)
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.daam_bpe_tokenize(self._handle, self._pretext(text), buf, cap)
        if n < 0:
            raise ValueError('tokenize buffer overflow')
        return buf.value.decode('utf-8').split('\n')[:n] if n else []

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        """Vocabulary lookup; unknown tokens become EOT, as in the Python
        BPE."""
        ids = [self._lib.daam_bpe_token_to_id(self._handle, t.encode('utf-8'))
               for t in tokens]
        return [self.eot_id if i < 0 else i for i in ids]

    def encode(self, text: str, add_special_tokens: bool = True,
               truncation: bool = True) -> List[int]:
        """One call into the core when truncating to 77, else the shared
        path over :meth:`tokenize`."""
        if not truncation:
            return super().encode(text, add_special_tokens, truncation)
        n = self.model_max_length
        out = (ctypes.c_int * n)()
        real = self._lib.daam_bpe_encode(self._handle, self._pretext(text), out, n,
                                         self.pad_id)
        ids = list(out[:real])
        return ids if add_special_tokens else ids[1:-1]
