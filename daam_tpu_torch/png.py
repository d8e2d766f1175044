"""A PNG writer for scanlines filtered on the card.

:func:`daam_tpu_torch.ops.kernels.png_scanlines` gives an 8-bit RGB image's
(H, 1 + 3W) scanlines, each row's filter type byte followed by its
filtered bytes, as Pillow's encoder filters them.  This module deflates
them as Pillow does (zlib level 6, its default; memory level 9; the
``Z_FILTERED`` strategy) into one zlib stream, and writes the signature,
IHDR, the IDAT in chunks of 64 KiB, as Pillow splits it, and IEND, each
chunk with its CRC-32.

The rows are deflated in :func:`stripes` stripes, on at most
``torch.get_num_threads()`` threads, the calling thread among them: the
intra-op threads the process already grants PyTorch, idle while the host
deflates.  One stripe is Pillow's file, byte for byte where the two link
the same zlib.  More stripes deflate as pigz does: each stripe a raw
deflate primed with the 32 KiB of rows before it, every stripe but the
last ended by a sync flush, all under one zlib header and the Adler-32 of
the whole rows.  That stream inflates to the same rows and is no more
than 0.1% over the one-stream size (under it where each stripe's own
Huffman blocks fit its rows better, as on smooth images).
"""

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Tuple, Union

import numpy as np
import torch

__all__ = ['png_bytes', 'write_png', 'stripes', 'MIN_STRIPE']

SIGNATURE = b'\x89PNG\r\n\x1a\n'
IDAT_CHUNK = 1 << 16
#: The least bytes of rows a stripe deflates: smaller rows are one stream.
MIN_STRIPE = 128 << 10
LEVEL, MEM_LEVEL = 6, 9
WINDOW = 1 << 15  # deflate's window, the dictionary that primes a stripe
ZLIB_HEADER = b'\x78\x9c'  # deflate, 32 KiB window, level 6's FLEVEL


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(data, zlib.crc32(kind))))


def stripes(nbytes: int) -> int:
    """How many stripes :func:`png_bytes` deflates ``nbytes`` of rows in:
    one a thread PyTorch may use (``torch.get_num_threads()``, the calling
    thread counted), each of at least :data:`MIN_STRIPE` bytes but one."""
    return max(1, min(torch.get_num_threads(), -(-nbytes // MIN_STRIPE)))


def _deflate(rows: memoryview, start: int, end: int) -> bytes:
    """Raw deflate of ``rows[start:end]`` primed with the window of rows
    before it; a sync flush ends it unless it ends the rows."""
    primed = {'zdict': rows[max(0, start - WINDOW):start]} if start else {}
    z = zlib.compressobj(LEVEL, zlib.DEFLATED, -15, MEM_LEVEL, zlib.Z_FILTERED, **primed)
    last = end == len(rows)
    return z.compress(rows[start:end]) + z.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)


def _idat(rows: np.ndarray) -> Tuple[bytes, int]:
    """The zlib stream of ``rows`` and the stripes it was deflated in.
    The calling thread deflates the first stripe, a pool of one thread less
    the rest (no thread starts for one stripe)."""
    n = stripes(rows.nbytes)
    flat = memoryview(rows.reshape(-1))
    cuts = [len(flat) * i // n for i in range(n + 1)]
    with ThreadPoolExecutor(max(1, n - 1), thread_name_prefix='png-deflate') as pool:
        rest = [pool.submit(_deflate, flat, cuts[i], cuts[i + 1]) for i in range(1, n)]
        body = [_deflate(flat, 0, cuts[1]), *(f.result() for f in rest)]
    return b''.join([ZLIB_HEADER, *body, struct.pack('>I', zlib.adler32(flat))]), n


def _png(scanlines: np.ndarray) -> Tuple[bytes, int]:
    """:func:`png_bytes` and the stripes its IDAT was deflated in."""
    rows = np.ascontiguousarray(scanlines, dtype=np.uint8)
    if rows.ndim != 2 or (rows.shape[1] - 1) % 3 or rows.shape[1] < 4 or not len(rows):
        raise ValueError(f'scanlines must be (H, 1 + 3W), got {rows.shape}')
    height, width = rows.shape[0], (rows.shape[1] - 1) // 3
    data, n = _idat(rows)
    # width, height, bit depth 8, colour type 2 (RGB), deflate, adaptive
    # filtering, no interlace
    ihdr = struct.pack('>IIBBBBB', width, height, 8, 2, 0, 0, 0)
    return b''.join([SIGNATURE, _chunk(b'IHDR', ihdr),
                     *(_chunk(b'IDAT', data[i:i + IDAT_CHUNK])
                       for i in range(0, len(data), IDAT_CHUNK)),
                     _chunk(b'IEND', b'')]), n


def png_bytes(scanlines: np.ndarray) -> bytes:
    """The PNG file of an 8-bit RGB image from its (H, 1 + 3W) uint8
    scanlines."""
    return _png(scanlines)[0]


def write_png(path: Union[str, Path], scanlines: np.ndarray) -> int:
    """Write :func:`png_bytes` of ``scanlines`` to ``path``; returns the
    stripes its IDAT was deflated in."""
    data, n = _png(scanlines)
    Path(path).write_bytes(data)
    return n
