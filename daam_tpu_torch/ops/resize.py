"""The bicubic weight matrices of ``daam_tpu/ops/resize.py``.

A 2-D bicubic resize without antialiasing is a linear map, separable per
axis: ``W_h @ image @ W_wᵀ``.  :func:`_cubic_kernel` and
:func:`_weight_matrix_np` are copies of ``daam_tpu/ops/resize.py:29-57``
(Keys cubic with A = -0.75, half-pixel centers, replicated edges; built in
float64 and cast to float32), held equal by ``tests/test_torch_shared.py``.
The mask evaluation (:mod:`daam_tpu_torch.evaluate`) thresholds the resized
masks at exactly 1.0, where one ulp of a weight decides a pixel, so it uses
these matrices rather than ``F.interpolate``'s per-pixel weights.
"""

from functools import lru_cache

import numpy as np

_A = -0.75  # torch/OpenCV cubic convolution parameter (jax.image uses -0.5)


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    w = np.where(
        x <= 1.0,
        (_A + 2.0) * x3 - (_A + 3.0) * x2 + 1.0,
        np.where(x < 2.0, _A * x3 - 5.0 * _A * x2 + 8.0 * _A * x - 4.0 * _A, 0.0),
    )
    return w


@lru_cache(maxsize=256)
def _weight_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) bicubic resampling matrix, float32."""
    if in_size == out_size:
        return np.eye(in_size, dtype=np.float32)
    scale = in_size / out_size
    # Half-pixel source coordinates (align_corners=False).
    x = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    x0 = np.floor(x).astype(np.int64)
    t = x - x0
    W = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)
    for tap in range(-1, 3):
        idx = np.clip(x0 + tap, 0, in_size - 1)  # replicate edges, like torch
        w = _cubic_kernel(t - tap)
        np.add.at(W, (rows, idx), w)
    return W.astype(np.float32)

