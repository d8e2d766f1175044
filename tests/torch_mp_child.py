"""One process of ``tests/test_torch_parallel.py``'s two-process group.

Launched twice with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT`` set, as ``torchrun`` sets them: joins the Gloo group
through ``init_distributed()``, runs ``generate_batch`` on ``tiny`` (CPU)
over 4 prompts and then 3 (the padded tail) inside ``trace(pipe)``, and
writes every image and every prompt's heat maps to ``outdir`` as ``.npy``
files tagged with its rank; then gathers a tensor through
``fetch_global``.  It touches ``ok.<rank>`` only after every check
passed.  Imports no JAX.

    python tests/torch_mp_child.py <outdir>
"""

import os
import sys
from pathlib import Path

import numpy as np
import torch

PROMPTS = ['a dog runs', 'a cat sits', 'a bird flies', 'a fish swims']
STEPS = 2


def main(outdir: Path) -> None:
    import torch.distributed as dist

    from daam_tpu_torch import StableDiffusionPipeline, trace
    from daam_tpu_torch.parallel import (fetch_global, generate_batch,
                                         init_distributed, is_multi_process)

    rank, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    assert init_distributed() is True and init_distributed() is True
    assert is_multi_process() and dist.get_backend() == 'gloo'
    assert (dist.get_rank(), dist.get_world_size()) == (rank, world)

    pipe = StableDiffusionPipeline.from_pretrained('tiny', device='cpu')
    for n in (4, 3):
        with trace(pipe) as tc:
            out = generate_batch(pipe, PROMPTS[:n], num_inference_steps=STEPS, seed=0)
            assert len(out.images) == n
            for i in range(n):
                maps = tc.compute_global_heat_map(batch_idx=i).heat_maps.numpy()
                assert np.isfinite(maps).all()
                np.save(outdir / f'maps{n}-{i}.{rank}.npy', maps)
                np.save(outdir / f'img{n}-{i}.{rank}.npy', np.asarray(out.images[i]))

    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    np.testing.assert_array_equal(
        fetch_global(x), np.concatenate([np.arange(6).reshape(2, 3) + 10 * r
                                         for r in range(world)]).astype(np.float32))
    dist.destroy_process_group()
    (outdir / f'ok.{rank}').touch()


if __name__ == '__main__':
    main(Path(sys.argv[1]))
