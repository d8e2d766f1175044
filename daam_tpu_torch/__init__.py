"""daam_tpu_torch — DAAM heat maps for Stable Diffusion in PyTorch and CUDA.

The PyTorch port of ``daam_tpu``: the same module names and public surface,
with the Pallas kernels of the traced path rewritten as hand-written CUDA
kernels for Hopper (``csrc/attention.cu``).  It never imports JAX.
"""

from .evaluate import (MeanEvaluator, UnsupervisedEvaluator, compute_ioa,  # noqa: F401
                       compute_iou, ioa_matrix, iou_matrix, load_mask)
from .experiment import GenerationExperiment  # noqa: F401
from .heatmap import GlobalHeatMap, RawHeatMapCollection, WordHeatMap  # noqa: F401
from .pipeline.sd import PipelineOutput, StableDiffusionPipeline  # noqa: F401
from .pipeline.sdxl import StableDiffusionXLPipeline  # noqa: F401
from .tokenization import default_tokenizer  # noqa: F401
from .trace import DiffusionHeatMapHooker, release_heads, trace  # noqa: F401
from .utils import compute_token_merge_indices, set_seed  # noqa: F401
