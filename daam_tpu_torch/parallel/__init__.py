"""Data-parallel generation over ``torch.distributed``: one process per
card, each generating its share of a batch of prompts (counterpart of
``daam_tpu/parallel``'s data axis)."""

from .distributed import init_distributed, is_multi_process  # noqa: F401
from .mesh import fetch_global, generate_batch  # noqa: F401
