"""The UNet feed-forward's GEGLU gate: kernel dispatch and the plain version.

``daam_tpu`` writes it as ``h * gelu(gate)`` in jnp, with the exact-erf GELU
evaluated in fp32 and rounded back to the activations' dtype, and leaves the
fusion to XLA.  A CUDA tensor takes the hand-written kernel of
``csrc/geglu.cu`` (:func:`.kernels.geglu`, one pass over the projection's
output), which computes the same expression at the same rounding points; a
CPU tensor takes the plain chain.  The route follows the tensor's device
alone.
"""

import torch
import torch.nn.functional as F

from . import kernels

__all__ = ['geglu', 'geglu_plain']


def geglu_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the ``geglu`` kernel: of a (..., 2w) projection
    output, its first w columns times the exact GELU of its last w, the GELU
    in fp32 and rounded to ``x``'s dtype."""
    h, gate = x.chunk(2, dim=-1)
    return h * F.gelu(gate.float()).to(h.dtype)


def geglu(x: torch.Tensor) -> torch.Tensor:
    """``h * gelu(gate)`` of a (..., 2w) projection output → (..., w)."""
    if x.is_cuda:
        return kernels.geglu(x)
    return geglu_plain(x)
