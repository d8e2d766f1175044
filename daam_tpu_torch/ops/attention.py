"""Attention ops of the traced UNet: kernel dispatch and the plain versions.

PyTorch counterpart of ``daam_tpu/ops/attention.py``.  Every operand is a
``(B, L, H, hd)`` view: the ``(B, L, H·hd)`` projection output unflattened,
or a head-major ``(B, H, L, hd)`` tensor transposed; both reach the kernels
through their strides, with no copy.  Outputs come back as
``(B, Lq, H·hd)``; probabilities as ``(B, H, Lq, Lk)``.

Dispatch: a CPU tensor takes the plain version, a CUDA tensor launches the
hand-written kernel of :mod:`.kernels` (or raises).  ``set_kernel_mode``
overrides that: ``'torch'`` forces the plain version on any device (how the
kernels are compared with it on the card), ``'cuda'`` forces the kernel.
"""

from typing import Optional

import torch

from . import kernels

__all__ = ['flash_attention', 'cross_attention_acc', 'cross_attention_probs',
           'cross_attention', 'flash_attention_plain',
           'cross_attention_acc_plain', 'cross_attention_probs_plain',
           'set_kernel_mode', 'get_kernel_mode']

_MODES = ('auto', 'torch', 'cuda')
_KERNEL_MODE = 'auto'


def set_kernel_mode(mode: str):
    global _KERNEL_MODE
    if mode not in _MODES:
        raise ValueError(f'kernel mode must be one of {_MODES}, got {mode!r}')
    _KERNEL_MODE = mode


def get_kernel_mode() -> str:
    return _KERNEL_MODE


def _use_kernel(t: torch.Tensor) -> bool:
    if _KERNEL_MODE == 'auto':
        return t.is_cuda
    return _KERNEL_MODE == 'cuda'


def _probs(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 softmax(q kᵀ / √hd) as (B, H, Lq, Lk)."""
    scores = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float())
    return (scores * q.shape[-1] ** -0.5).softmax(dim=-1)


def _out(probs: torch.Tensor, v: torch.Tensor, dtype) -> torch.Tensor:
    o = torch.einsum('bhqk,bkhd->bqhd', probs.to(v.dtype), v)
    return o.flatten(2).to(dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``flash_attention`` kernel (materializes the
    scores; ``daam_tpu`` ``_jnp_attention``)."""
    return _out(_probs(q, k), v, q.dtype)


def cross_attention_acc_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              acc: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``cross_attention_acc`` kernel: attention output,
    and ``acc += Pᵀ`` in place (``daam_tpu`` ``_acc_update_jnp``)."""
    probs = _probs(q, k)
    acc += probs.transpose(2, 3)
    return _out(probs, v, q.dtype)


def cross_attention_probs_plain(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, cond_only: bool = False,
                                probs_dtype: torch.dtype = torch.float32):
    """Plain version of the ``cross_attention_probs`` kernel: ``(o, p)`` with
    P in ``probs_dtype`` (``daam_tpu`` ``_jnp_attention``).  It writes every
    row of P; under ``cond_only`` the kernel leaves the first B/2 samples'
    rows unwritten, so only the conditional rows are defined."""
    probs = _probs(q, k)
    return _out(probs, v, q.dtype), probs.to(probs_dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ / √hd) v over (B, L, H, hd) views → (B, Lq, H·hd)."""
    if _use_kernel(q):
        return kernels.flash_attention(q, k, v)
    return flash_attention_plain(q, k, v)


def cross_attention_acc(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        acc: torch.Tensor) -> torch.Tensor:
    """Attention output, with Pᵀ added into the fp32 ``acc`` (B, H, Lk, Lq)
    in place — the DAAM capture."""
    if _use_kernel(q):
        return kernels.cross_attention_acc(q, k, v, acc)
    return cross_attention_acc_plain(q, k, v, acc)


def cross_attention_probs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          cond_only: bool = False,
                          probs_dtype: torch.dtype = torch.float32):
    """Attention output and the probabilities P (B, H, Lq, Lk), in one pass
    — the ``'full'``/``'cond'`` capture."""
    if _use_kernel(q):
        return kernels.cross_attention_probs(q, k, v, cond_only, probs_dtype)
    return cross_attention_probs_plain(q, k, v, cond_only, probs_dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    capture=False, replay_probs: Optional[torch.Tensor] = None,
                    acc: Optional[torch.Tensor] = None):
    """Text cross-attention with the DAAM capture and the head replay.

    ``capture`` ∈ {False, 'acc', 'cond', 'full', True} (``True`` means
    ``'full'``), as in ``daam_tpu``; the batch is the CFG layout
    ``[uncond; cond]``.

    * ``'acc'``: the conditional half's Pᵀ is added into ``acc``
      (B/2, H, Lk, Lq), in place (``daam_tpu`` returns the new accumulator
      instead); returns the output.
    * ``'full'``: returns ``(out, probs)`` with fp32 P for every row — the
      ``save_heads`` capture.  ``'cond'``: bf16 P, defined only for the
      conditional half.
    * ``False``: returns the output.

    ``replay_probs`` (B, H, Lq, Lk) replaces the computed probabilities
    before the value product — the attention transplant of ``load_heads``
    (reference ``daam/trace.py:281-282``).  It is computed in plain PyTorch,
    outside any kernel, as ``daam_tpu`` computes it outside Pallas; under
    ``'cond'``/``'full'`` the fp32 replayed P comes back as ``probs``.
    """
    if capture is True:
        capture = 'full'
    if capture not in (False, 'acc', 'cond', 'full'):
        raise ValueError(f'capture must be False, True, \'acc\', \'cond\' or '
                         f'\'full\', got {capture!r}')
    if capture == 'acc' and acc is None:
        raise ValueError("capture='acc' requires the accumulator")
    bc = q.shape[0] // 2
    if replay_probs is not None:
        probs = replay_probs.to(device=q.device, dtype=torch.float32)
        out = _out(probs, v, q.dtype)
        if capture == 'acc':
            acc += probs[bc:].transpose(2, 3)
            return out
        return (out, probs) if capture else out
    if capture == 'acc':
        out_u = flash_attention(q[:bc], k[:bc], v[:bc])
        out_c = cross_attention_acc(q[bc:], k[bc:], v[bc:], acc)
        return torch.cat([out_u, out_c], dim=0)
    if capture:
        return cross_attention_probs(
            q, k, v, cond_only=capture == 'cond',
            probs_dtype=torch.bfloat16 if capture == 'cond' else torch.float32)
    return flash_attention(q, k, v)
