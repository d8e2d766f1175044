"""daam_tpu_torch — DAAM heat maps for Stable Diffusion in PyTorch and CUDA.

The PyTorch port of ``daam_tpu``: the same module names and public surface
(but for ``daam_tpu``'s JAX-only layers: the mesh's tensor and sequence
parallelism and the persistent compilation cache; ``parallel`` keeps the
data-parallel ``generate_batch`` over ``torch.distributed``), with the
Pallas kernels of the traced path rewritten as hand-written CUDA kernels
for Hopper (``csrc/attention.cu``).  It never imports JAX.
"""

from ._version import __version__  # noqa: F401
from .utils import *  # noqa: F401,F403
from .evaluate import *  # noqa: F401,F403
from .experiment import *  # noqa: F401,F403
from .heatmap import *  # noqa: F401,F403
from .tokenization import *  # noqa: F401,F403
from .hook import *  # noqa: F401,F403
from .trace import *  # noqa: F401,F403
from .pipeline.sd import PipelineOutput, StableDiffusionPipeline  # noqa: F401
from .pipeline.sdxl import StableDiffusionXLPipeline  # noqa: F401


def __getattr__(name):
    """``DiffusionPipeline``, the reference stack's familiar name:
    ``DiffusionPipeline.from_pretrained(...)`` gives the pipeline class of
    the checkpoint or preset."""
    if name == 'DiffusionPipeline':
        return StableDiffusionPipeline
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
