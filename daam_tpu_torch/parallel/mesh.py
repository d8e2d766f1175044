"""Data-parallel batched generation (``daam_tpu/parallel/mesh.py:98-166``).

``daam_tpu`` shards a batch over the ``data`` axis of a JAX mesh.  Here
each process of a ``torch.distributed`` group (:func:`~.distributed.
init_distributed`) generates a contiguous share of the prompts on its own
card, and :func:`fetch_global` gathers the results to every process.  The
mesh's tensor- and sequence-parallel axes have no counterpart: the largest
model, SDXL, fits one card.
"""

from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..pipeline.sd import PipelineOutput, _to_pil

__all__ = ['generate_batch', 'fetch_global']


def _group():
    """(world size, rank) of the active process group, else (1, 0)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def fetch_global(x) -> np.ndarray:
    """``x`` (a tensor or array whose first axis is this process's share)
    as a host array.  In one process that is ``x.cpu().numpy()``; inside a
    process group every rank's ``x`` (all of one shape) is gathered along
    the first axis, in rank order, so every rank calls it collectively.
    NCCL gathers on the process's card, Gloo on the host."""
    import torch.distributed as dist

    x = torch.as_tensor(x)
    if not (dist.is_available() and dist.is_initialized()):
        return x.cpu().numpy()
    device = (torch.device('cuda', torch.cuda.current_device())
              if dist.get_backend() == 'nccl' else torch.device('cpu'))
    x = x.to(device).contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts).cpu().numpy()


def generate_batch(pipe, prompts: Sequence[str], num_inference_steps: int = 50,
                   seed: int = 0, guidance_scale: Optional[float] = None,
                   negative_prompt: Union[str, Sequence[str], None] = None,
                   **kwargs) -> PipelineOutput:
    """Generate ``prompts`` across the process group, every process
    returning all the images in prompt order.

    Prompt ``i`` runs with its own ``torch.Generator(pipe.device)`` seeded
    ``seed + i``, in a pipeline call of its own, so its image does not
    depend on the world size or on the other prompts: each card runs at
    batch 1.  (``daam_tpu`` runs one batched call over the whole mesh from
    ``PRNGKey(seed)``, so the two packages' images differ for one seed.)
    A batch that does not divide the world size is padded by repeating the
    last prompt (as ``daam_tpu`` pads), so every rank runs the same number
    of calls and the gathers line up; the padding is sliced off.
    ``kwargs`` go to each call.

    Inside ``trace(pipe)`` the per-sample heat maps of every prompt are
    gathered too, so ``compute_global_heat_map(batch_idx=i)`` answers for
    any prompt on any rank; per-step maps stay those of each rank's last
    call.  A trace with ``save_heads`` or ``load_heads`` is refused: its
    replay buffer holds one pipeline call.
    """
    tr = pipe._active_trace
    if tr is not None and (tr.save_heads or tr.load_heads):
        raise ValueError('generate_batch does not run under save_heads or load_heads: '
                         'call the pipeline on the batch instead')
    world, rank = _group()
    prompts = list(prompts)
    B = len(prompts)
    padded = prompts + [prompts[-1]] * ((-B) % world)
    negatives = (None if negative_prompt is None or isinstance(negative_prompt, str)
                 else list(negative_prompt))
    if negatives is not None:
        if len(negatives) != B:
            raise ValueError(f'{len(negatives)} negative prompts for {B} prompts')
        negatives += [negatives[-1]] * (len(padded) - B)
    per = len(padded) // world

    images, flags = [], []
    blocks: Dict[int, List[torch.Tensor]] = {}
    for i in range(rank * per, (rank + 1) * per):
        out = pipe(padded[i], num_inference_steps=num_inference_steps,
                   generator=torch.Generator(pipe.device).manual_seed(seed + i),
                   guidance_scale=guidance_scale,
                   negative_prompt=negative_prompt if negatives is None else negatives[i],
                   **kwargs)
        images.append(np.asarray(out.images[0]))
        flags.append(bool(out.nsfw_content_detected and out.nsfw_content_detected[0]))
        if tr is not None:
            for factor, block in tr.batch_heat_maps.items():
                blocks.setdefault(factor, []).append(block)

    gathered = fetch_global(np.stack(images))[:B]
    out_images = _to_pil(gathered) if kwargs.get('output_type', 'pil') == 'pil' \
        else list(gathered)
    nsfw = None
    if pipe.safety_checker is not None:
        nsfw = [bool(f) for f in fetch_global(np.asarray(flags, dtype=np.uint8))[:B]]
    if tr is not None:
        full = {factor: torch.from_numpy(fetch_global(torch.cat(parts)))[:B].to(pipe.device)
                for factor, parts in blocks.items()}
        tr._on_call_end(prompts, out_images, full)
    return PipelineOutput(images=out_images, nsfw_content_detected=nsfw)
