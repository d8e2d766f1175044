"""A PNG writer for scanlines filtered on the card.

:func:`daam_tpu_torch.ops.kernels.png_scanlines` gives an 8-bit RGB image's
(H, 1 + 3W) scanlines, each row's filter type byte followed by its
filtered bytes, as Pillow's encoder filters them.  This module deflates
them as Pillow does (zlib level 6, its default; memory level 9; the
``Z_FILTERED`` strategy) and writes the signature, IHDR, the IDAT in chunks
of 64 KiB, as Pillow splits it, and IEND, each chunk with its CRC-32.  So
the file is Pillow's, byte for byte where the two link the same zlib, and
within a fraction of a percent of its size where they do not.
"""

import struct
import zlib
from pathlib import Path
from typing import Union

import numpy as np

__all__ = ['png_bytes', 'write_png']

SIGNATURE = b'\x89PNG\r\n\x1a\n'
IDAT_CHUNK = 1 << 16


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack('>I', len(data)) + kind + data
            + struct.pack('>I', zlib.crc32(data, zlib.crc32(kind))))


def png_bytes(scanlines: np.ndarray) -> bytes:
    """The PNG file of an 8-bit RGB image from its (H, 1 + 3W) uint8
    scanlines."""
    rows = np.ascontiguousarray(scanlines, dtype=np.uint8)
    if rows.ndim != 2 or (rows.shape[1] - 1) % 3 or rows.shape[1] < 4 or not len(rows):
        raise ValueError(f'scanlines must be (H, 1 + 3W), got {rows.shape}')
    height, width = rows.shape[0], (rows.shape[1] - 1) // 3
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    data = z.compress(rows) + z.flush()
    # width, height, bit depth 8, colour type 2 (RGB), deflate, adaptive
    # filtering, no interlace
    ihdr = struct.pack('>IIBBBBB', width, height, 8, 2, 0, 0, 0)
    return b''.join([SIGNATURE, _chunk(b'IHDR', ihdr),
                     *(_chunk(b'IDAT', data[i:i + IDAT_CHUNK])
                       for i in range(0, len(data), IDAT_CHUNK)),
                     _chunk(b'IEND', b'')])


def write_png(path: Union[str, Path], scanlines: np.ndarray) -> None:
    """Write :func:`png_bytes` of ``scanlines`` to ``path``."""
    Path(path).write_bytes(png_bytes(scanlines))
