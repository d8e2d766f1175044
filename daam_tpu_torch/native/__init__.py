"""Native (C++) host code: the CLIP BPE core (``bpe.cpp``), built with g++
at first use and bound with ctypes, with the Python BPE of
:mod:`daam_tpu_torch.tokenization` as its fallback."""

from .bpe_binding import NativeBpeTokenizer, library_path, native_available  # noqa: F401
