"""Process-group set-up for data-parallel generation
(``daam_tpu/parallel/distributed.py:62-104``).

One process per card.  With ``torchrun`` (which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``)::

    torchrun --nproc-per-node 4 script.py

and in ``script.py``, before the pipeline is built::

    from daam_tpu_torch.parallel import init_distributed, generate_batch
    init_distributed()               # False, and nothing done, in one process
    pipe = StableDiffusionPipeline.from_pretrained('v2-1-base')
    out = generate_batch(pipe, prompts, num_inference_steps=50, seed=0)

Without ``torchrun``, pass the group's address, size and rank:
``init_distributed('tcp://10.0.0.1:29500', world_size=4, rank=r)``.
"""

import os
from typing import Optional

import torch

__all__ = ['init_distributed', 'is_multi_process']


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     backend: Optional[str] = None) -> bool:
    """Join the process group: NCCL where a card is present, Gloo on the
    CPU (or ``backend``).  ``init_method`` defaults to ``env://`` when
    ``RANK`` and ``WORLD_SIZE`` are set; without either this is a no-op.
    Under NCCL the process takes card ``LOCAL_RANK`` (else ``rank`` modulo
    the cards), so ``device='cuda'`` is its own card.  A second call
    changes nothing.  Returns whether more than one process is in the
    group."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is None:
        if 'RANK' not in os.environ or 'WORLD_SIZE' not in os.environ:
            return False
        init_method = 'env://'
    if backend is None:
        backend = 'nccl' if torch.cuda.is_available() else 'gloo'
    kwargs = {}
    if world_size is not None:
        kwargs['world_size'] = world_size
    if rank is not None:
        kwargs['rank'] = rank
    if backend == 'nccl':
        local = os.environ.get('LOCAL_RANK')
        index = int(local) if local is not None else \
            (rank if rank is not None else int(os.environ.get('RANK', 0)))
        torch.cuda.set_device(index % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    return dist.get_world_size() > 1


def is_multi_process() -> bool:
    """Whether a process group of more than one process is active."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1
