"""The comparison that decides ``correct``.

For each sampled request, what the timed path produced (each step's
latents, the images, the global heat maps, the word maps, the overlay PNGs
that ``cli`` wrote, and in the transplant the saved heads) is held against
the plain reference (:mod:`gpubench.reference`), run in float32 with TF32
off on the same prompts and generator seeds, on state dicts drawn again
from the seed.  The reference follows the program's latents step by step
(see :meth:`~gpubench.reference.pipeline.Reference.run`); the load run of a
transplant replays the reference's own saved heads, never the program's.

Numbers (each the worst over the sampled requests; limits in
``limits/<workload>.json``):

* ``step_err``: the guided noise prediction's relative error at the worst
  UNet evaluation: ‖x_prog − x_ref‖ / ‖x_ref − √(ᾱ_prev/ᾱ_t)·x‖ after one
  step of the configuration's sampler from the latents x it integrates
  from (:mod:`gpubench.reference.schedulers`; ε derived from v under
  v-prediction).
* ``image_err``: mean |Δ| of the uint8 images against the reference's
  decode of the program's last latents, in 1/255 steps.
* ``map_err`` / ``word_err``: ‖Δ‖/‖ref‖ of the global heat map and of the
  worst word map.
* ``overlay_err``: mean |Δ| of the worst word's overlay PNG, read back from
  the file, against the reference's overlay of its own word map on its own
  image (:mod:`gpubench.reference.overlay`), in 1/255 steps.
* ``heads_err``: ‖Δ‖/‖ref‖ of the worst layer's saved heads (transplant).
* ``png_missing``: heat-map PNGs the ``cli`` flow should have written and
  did not (exact: limit 0).
"""

import math
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from ..reference.overlay import overlay
from ..reference.pipeline import Reference, rel, to_u8


def retain(run: dict) -> dict:
    """What the comparison needs of one pipeline call, in the harness's own
    memory, so that the program may reuse its buffers: the step latents
    (the clock's copies), copies of the arrays the flow fetched and of the
    saved heads, and the directories ``cli`` wrote."""
    copy = lambda a: np.array(a, copy=True)  # noqa: E731
    kept = {'kind': run['kind'], 'prompts': run['prompts'], 'seeds': run['seeds'],
            'latents': run['clock'].latents, 'dirs': run.get('dirs')}
    for key in ('images', 'maps'):
        kept[key] = [copy(a) for a in run[key]] if key in run else None
    kept['words'] = ([{w: copy(m) for w, m in ws.items()} for ws in run['words']]
                     if run.get('words') is not None else None)
    kept['heads'] = ({n: t.clone() for n, t in run['heads'].items()}
                     if run.get('heads') is not None else None)
    return kept


def png_words(ref: Reference, prompt: str) -> List[str]:
    """The words of ``prompt`` that have an overlay file, one a file name
    (``<word lowercased>.heat_map.png``): those the tokenizer finds."""
    out = {}
    for word in prompt.split():
        try:
            ref.tok.merge_indices(prompt, word)
        except ValueError:
            continue
        out[word.lower()] = word
    return list(out.values())


def program_outputs(run: dict, ref: Reference) -> dict:
    """What one retained pipeline call of the window produced, read back as
    the user would: arrays the flow fetched, or the files ``cli`` wrote
    (the image and global map from ``generation.pt``, each word's overlay
    PNG; a missing PNG counts in ``png_missing``)."""
    out = {'kind': run['kind'], 'prompts': run['prompts'], 'seeds': run['seeds'],
           'latents': run['latents'], 'words': run['words'], 'heads': run['heads'],
           'overlays': None, 'png_missing': None}
    if run['dirs'] is not None:
        import PIL.Image

        images, maps, overlays, missing = [], [], [], 0
        for d, prompt in zip(run['dirs'], run['prompts']):
            payload = pickle.loads((d / 'generation.pt').read_bytes())
            images.append(np.asarray(payload['image']))
            maps.append(np.asarray(payload['global_heat_map']))
            found = {}
            for word in png_words(ref, prompt):
                path = d / f'{word.lower()}.heat_map.png'
                if path.exists():
                    with PIL.Image.open(path) as im:
                        found[word] = np.asarray(im.convert('RGB'))
                else:
                    missing += 1
            overlays.append(found)
        out.update(images=images, maps=maps, overlays=overlays, png_missing=missing)
    else:
        out.update(images=run['images'], maps=run['maps'])
    return out


def control_outputs(ctl: Reference, kind: str, prompts, seeds, steps, guidance,
                    words: Optional[List[List[str]]], replay=None,
                    overlays: bool = False) -> dict:
    """The same outputs from a reference run free in a lower precision,
    put in the program's place (with ``overlays``, each word's overlay as
    ``cli`` writes it, drawn from the control's image and word map)."""
    r = ctl.run(prompts, seeds, steps, guidance, save=kind == 'save', replay=replay)
    out = {'kind': kind, 'prompts': list(prompts), 'seeds': list(seeds),
           'latents': r['latents'], 'images': list(to_u8(r['images'])),
           'maps': [m.cpu().numpy() for m in r['maps']], 'heads': r['saved'],
           'png_missing': None, 'words': None, 'overlays': None}
    if overlays:
        out['overlays'] = [{w: overlay(im, ctl.word_map(m, p, w)) for w in png_words(ctl, p)}
                           for im, m, p in zip(out['images'], r['maps'], prompts)]
    if words is not None:
        out['words'] = [{w: ctl.word_map(m, p, w).cpu().numpy() for w in ws}
                        for m, p, ws in zip(r['maps'], prompts, words)]
    return out


def _rel_or_inf(a, b) -> float:
    if tuple(np.shape(a)) != tuple(np.shape(b)):
        return math.inf
    return rel(a, b)


def compare(ref: Reference, outs: List[dict], steps: int, guidance: float) -> Dict[str, float]:
    """Numbers of one request (its pipeline calls in order: a transplant's
    load run replays the reference's heads of the save run before it)."""
    nums: Dict[str, float] = {}

    def worst(name, value):
        v = float(value)
        nums[name] = max(nums.get(name, -math.inf), v if math.isfinite(v) else math.inf)

    replay = None
    for out in outs:
        r = ref.run(out['prompts'], out['seeds'], steps, guidance, forced=out['latents'],
                    save=out['kind'] == 'save', replay=replay if out['kind'] == 'load' else None)
        worst('step_err', r['step_err'].max())
        ref_u8 = to_u8(r['images'])
        for b, image in enumerate(out['images']):
            img = np.asarray(image)
            worst('image_err', np.abs(img.astype(np.int16) - ref_u8[b]).mean()
                  if img.shape == ref_u8[b].shape else math.inf)
            worst('map_err', _rel_or_inf(out['maps'][b], r['maps'][b].cpu()))
            if out['words'] is not None:
                for w, m in out['words'][b].items():
                    worst('word_err', _rel_or_inf(m, ref.word_map(r['maps'][b], out['prompts'][b], w).cpu()))
            if out['overlays'] is not None:
                for w, png in out['overlays'][b].items():
                    want = overlay(ref_u8[b], ref.word_map(r['maps'][b], out['prompts'][b], w))
                    worst('overlay_err', np.abs(png.astype(np.int16) - want).mean()
                          if png.shape == want.shape else math.inf)
        if out['png_missing'] is not None:
            worst('png_missing', out['png_missing'])
        if out['kind'] == 'save':
            for name, p_ref in r['saved'].items():
                p = out['heads'].get(name) if out['heads'] is not None else None
                if p is None or tuple(p.shape) != tuple(p_ref.shape):
                    worst('heads_err', math.inf)
                    continue
                p = p.to(p_ref.device, torch.float32)
                worst('heads_err', float((p - p_ref.float()).norm() / p_ref.float().norm()))
            replay = r['saved']
    return nums


def merge(into: Dict[str, float], nums: Dict[str, float]):
    for k, v in nums.items():
        into[k] = max(into.get(k, -math.inf), v)


def reference_precision():
    """float32 with TF32 off, for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
