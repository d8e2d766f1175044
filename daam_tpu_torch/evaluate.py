"""Segmentation metrics over mask stacks on the device (IoU/IoA, Hungarian mIoU).

Counterpart of ``daam_tpu/evaluate.py``: the same metric surface as
reference ``daam/evaluate.py`` (bicubic resize + binarize at 1, best-of-preds
IoU, Hungarian-matched unsupervised mIoU, the evaluators' report strings)
with a batched core.  A whole mask stack is resized and binarized at once,
and every pairwise intersection of an experiment comes from one
``P @ Tᵀ`` product on the device.

The resize multiplies by ``daam_tpu``'s own bicubic weight matrices
(:mod:`daam_tpu_torch.ops.resize`), height then width.  An interior pixel
of a mask comes out as a sum of four weights, and the threshold at exactly
1.0 keeps it only if that sum rounds to 1.0, so the order of a float32 sum
decides it: a sequential float32 sum (PyTorch's CPU product) drops 4245 of
the 48461 pixels ``daam_tpu`` keeps at 512² → 480 × 640, and a TF32 product
turns 1.0 into 1 − 2⁻¹¹.  Each pass therefore multiplies in float64 and
rounds once to float32, which keeps what ``daam_tpu`` keeps at 64² → 512²
and 512² → 480 × 640 (``tests/test_torch_evaluate.py``) and gives the same
pixels on the CPU and the card.  The intersections ``P @ Tᵀ`` run in fp32
with TF32 off for the call, whatever the global setting.  Masks of the
truth's size skip the resize, and their IoU is exact.  Functions and
evaluators take ``device=`` (the card unless the caller names another;
without one they raise).
"""

from contextlib import contextmanager
from typing import Dict, List, Tuple

import numpy as np
import torch

from .ops.resize import _weight_matrix_np
from .utils import resolve_device

__all__ = ['compute_iou', 'MeanEvaluator', 'load_mask', 'compute_ioa',
           'UnsupervisedEvaluator', 'iou_matrix', 'ioa_matrix']


# ---------------------------------------------------------------------------
# batched mask math (the device core)
# ---------------------------------------------------------------------------

@contextmanager
def _fp32_products():
    """TF32 off for the products of the block, restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _as_stack(masks, device: torch.device) -> torch.Tensor:
    """(N, h, w) fp32 tensor on ``device`` from a mask or a list of masks
    (arrays or tensors)."""
    def one(m):
        if not isinstance(m, torch.Tensor):
            m = torch.as_tensor(np.asarray(m, dtype=np.float32))
        return m.to(device=device, dtype=torch.float32)
    if isinstance(masks, (list, tuple)):
        return torch.stack([one(m) for m in masks])
    m = one(masks)
    return m[None] if m.ndim == 2 else m


def _binarize_resize(masks: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N, h, w) → (N, H·W): bicubic resize to ``out_hw`` (when the sizes
    differ) and threshold at 1, the reference's size matching
    (``daam/evaluate.py:15-18``) on the whole stack.  Each pass (height,
    then width) multiplies in float64 and rounds once to float32."""
    in_hw = tuple(masks.shape[1:])
    if in_hw != tuple(out_hw):
        for axis, eq in ((0, 'oi,niw->now'), (1, 'oi,nhi->nho')):
            if in_hw[axis] != out_hw[axis]:
                w = torch.from_numpy(_weight_matrix_np(in_hw[axis], out_hw[axis]))
                masks = torch.einsum(eq, w.to(masks.device, torch.float64),
                                     masks.double()).float()
        masks = (masks >= 1.0).float()
    return masks.reshape(masks.shape[0], -1)


def _pair_stats(preds, truths, device) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(intersections (P, T), pred areas (P,), truth areas (T,)) as float32
    host arrays, with preds resized and binarized to the truth grid: two
    stacked flattens and one product, however many masks there are."""
    device = resolve_device(device)
    with _fp32_products():
        t = _as_stack(truths, device)
        p_flat = _binarize_resize(_as_stack(preds, device), tuple(t.shape[1:]))
        t_flat = t.reshape(t.shape[0], -1)
        inter = p_flat @ t_flat.T
        return (inter.cpu().numpy(), p_flat.sum(-1).cpu().numpy(),
                t_flat.sum(-1).cpu().numpy())


def iou_matrix(preds, truths, device='cuda') -> np.ndarray:
    """All-pairs IoU between pred and truth mask stacks."""
    inter, p_area, t_area = _pair_stats(preds, truths, device)
    union = p_area[:, None] + t_area[None, :] - inter
    return inter / (union + 1e-8)


def ioa_matrix(preds, truths, device='cuda') -> np.ndarray:
    """All-pairs intersection over the pred's area."""
    inter, p_area, _ = _pair_stats(preds, truths, device)
    return inter / (p_area[:, None] + 1e-8)


def compute_iou(a, b, device='cuda') -> float:
    """IoU of one pair — same binarization contract as reference
    ``daam/evaluate.py:14-23`` (``a`` resized to ``b``'s grid, threshold 1)."""
    return float(iou_matrix([a], [b], device)[0, 0])


def compute_ioa(a, b, device='cuda') -> float:
    """Intersection over the area of ``a`` (reference ``daam/evaluate.py:26-35``)."""
    return float(ioa_matrix([a], [b], device)[0, 0])


def load_mask(path: str) -> np.ndarray:
    """Binary mask from a PNG's alpha channel (reference ``daam/evaluate.py:38-43``)."""
    import PIL.Image

    mask = np.array(PIL.Image.open(path)).astype(np.float32)[:, :, 3]
    return (mask > 0).astype(np.float32)


# ---------------------------------------------------------------------------
# evaluators (host-side aggregation over device-computed matrices)
# ---------------------------------------------------------------------------

class UnsupervisedEvaluator:
    """Hungarian-matched unsupervised mIoU.

    Accumulates a (gt label, pred label) → summed-best-IoU table and solves
    the assignment at read time; report format matches reference
    ``daam/evaluate.py:79-80``.
    """

    def __init__(self, name: str = 'UnsupervisedEvaluator', device='cuda'):
        self.name = name
        self.device = device
        self._iou_sum: Dict[Tuple[int, int], float] = {}
        self._iou_cnt: Dict[Tuple[int, int], int] = {}
        self.num_samples = 0

    def log_iou(self, preds, truth, gt_idx: int = 0, pred_idx: int = 0):
        best = float(iou_matrix(preds, [truth], self.device).max())
        key = (gt_idx, pred_idx)
        self._iou_sum[key] = self._iou_sum.get(key, 0.0) + best
        self._iou_cnt[key] = self._iou_cnt.get(key, 0) + 1

    @property
    def mean_iou(self) -> float:
        from scipy.optimize import linear_sum_assignment

        n = 1 + max(max(g for g, _ in self._iou_sum),
                    max(p for _, p in self._iou_sum))
        sums = np.zeros((n, n))
        counts = np.zeros((n, n))
        for (g, p), s in self._iou_sum.items():
            sums[g, p] = s
            counts[g, p] = self._iou_cnt[(g, p)]
        rows, cols = linear_sum_assignment(sums, maximize=True)
        return sums[rows, cols].sum() / counts[rows, cols].sum()

    def increment(self):
        self.num_samples += 1

    def __len__(self) -> int:
        return self.num_samples

    def __str__(self):
        return f'{self.name}<{self.mean_iou:.4f} (mIoU) {len(self)} samples>'


class MeanEvaluator:
    """Best-of-preds mean IoU with 95% CI + mean heat intensity; report format
    matches reference ``daam/evaluate.py:115-116``."""

    def __init__(self, name: str = 'MeanEvaluator', device='cuda'):
        self.ious: List[float] = []
        self.intensities: List[float] = []
        self.name = name
        self.device = device

    def log_iou(self, preds, truth):
        self.ious.append(float(iou_matrix(preds, [truth], self.device).max()))
        return self

    def log_intensity(self, pred):
        self.intensities.append(float(np.asarray(pred).mean()))
        return self

    @property
    def mean_iou(self) -> float:
        return float(np.mean(self.ious))

    @property
    def mean_intensity(self) -> float:
        return float(np.mean(self.intensities))

    @property
    def ci95_miou(self) -> float:
        return float(1.96 * np.std(self.ious) / np.sqrt(len(self.ious)))

    def __len__(self) -> int:
        return max(len(self.ious), len(self.intensities))

    def __str__(self):
        return (f'{self.name}<{self.mean_iou:.4f} (±{self.ci95_miou:.3f} mIoU) '
                f'{self.mean_intensity:.4f} (mInt) {len(self)} samples>')
