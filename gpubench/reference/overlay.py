"""The plain reference of a word's heat-map overlay, as ``daam-torch``
writes it where matplotlib is absent: the word's map bicubic-resized to
the image and min-max normalized, coloured by matplotlib's ``jet``
colormap, laid over the image with the normalized map as its weight
(``photo·(1 − heat) + jet(heat)·heat``), rounded to uint8.
"""

import numpy as np
import torch
import torch.nn.functional as F

#: matplotlib's ``jet`` (``matplotlib/_cm.py``): per channel, breakpoints
#: and values, sampled at 256 levels as a ``LinearSegmentedColormap`` is
_JET = (((0.0, 0.35, 0.66, 0.89, 1.0), (0.0, 0.0, 1.0, 1.0, 0.5)),
        ((0.0, 0.125, 0.375, 0.64, 0.91, 1.0), (0.0, 0.0, 1.0, 1.0, 0.0, 0.0)),
        ((0.0, 0.11, 0.34, 0.65, 1.0), (0.5, 1.0, 1.0, 0.0, 0.0)))
JET = np.stack([np.interp(np.linspace(0.0, 1.0, 256), xs, ys) for xs, ys in _JET], axis=-1)


def jet(levels: np.ndarray) -> np.ndarray:
    """RGB in [0, 1] of ``levels`` in [0, 1], indexed as a colormap of 256
    entries indexes a float (``floor(level·256)``, the top level clipped)."""
    return JET[np.clip((levels * 256).astype(np.int64), 0, 255)]


def overlay(image_u8: np.ndarray, word_map: torch.Tensor) -> np.ndarray:
    """The (H, W, 3) uint8 overlay of ``word_map`` (h, w) on ``image_u8``."""
    h, w = image_u8.shape[:2]
    up = F.interpolate(word_map.float()[None, None], size=(h, w), mode='bicubic',
                       align_corners=False)[0, 0]
    heat = ((up - up.min()) / (up.max() - up.min() + 1e-8)).cpu().numpy()
    lo, hi = float(heat.min()), float(heat.max())
    levels = (heat - lo) / (hi - lo) if hi > lo else np.zeros_like(heat)
    weight = np.clip(heat, 0.0, 1.0)[..., None]
    rgb = np.clip(image_u8.astype(np.float32) / 255.0 * (1.0 - weight)
                  + jet(levels) * weight, 0.0, 1.0)
    return np.clip(rgb * 255 + 0.5, 0, 255).astype(np.uint8)
