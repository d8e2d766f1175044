"""Experiment persistence: serializable generations, masks, annotations.

Counterpart of ``daam_tpu/experiment.py``, with the reference's on-disk
directory contract (``daam/experiment.py:140-167, 303-344``):
``path/id/subtype/`` holds ``generation.pt``, ``output.png``, ``prompt.txt``,
``seed.txt``, ``{word}.gt.png`` truth masks, ``{word}.{name}.pred.png``
prediction masks, ``annotations.json`` and ``{word}.heat_map.png``.
``generation.pt`` is the pickled numpy payload ``daam_tpu`` writes (format
``daam_tpu.v1``), or with ``save(reference_format=True)`` the torch
checkpoint the reference loads; :meth:`GenerationExperiment.load` reads
both, so a directory written by either package loads in the other.  PIL is
imported only where a PNG is read or written.  ``output.png`` and the
heat-map PNGs are written by :func:`~daam_tpu_torch.heatmap.save_image` and
:func:`~daam_tpu_torch.heatmap.save_overlay`, which draw them on the card
where ``trace.to_experiment`` made the experiment on a CUDA device, else on
the host.
"""

import io
import json
import pickle
import sys
import types
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from .coco import (COCO80_LABELS, COCO80_INDICES, UNUSED_LABELS,  # noqa: F401
                   COCOSTUFF27_LABELS, COCO80_ONTOLOGY, COCO80_TO_27,
                   build_word_list_coco80)
from .evaluate import load_mask
from .heatmap import GlobalHeatMap, save_image, save_overlay
from .profiling import span
from .utils import _to_pil

__all__ = ['GenerationExperiment', 'COCO80_LABELS', 'COCOSTUFF27_LABELS',
           'COCO80_INDICES', 'COCO80_ONTOLOGY', 'COCO80_TO_27',
           'UNUSED_LABELS', 'build_word_list_coco80']


# ---------------------------------------------------------------------------
# mask helpers (shared by the truth / prediction paths)
# ---------------------------------------------------------------------------

def _write_mask_png(path: Path, mask: np.ndarray) -> None:
    """Write a {0,1} mask as the RGBA PNG format ``load_mask`` reads back."""
    import PIL.Image

    arr = (np.asarray(mask, dtype=np.float32) * 255).astype(np.uint8)
    PIL.Image.fromarray(np.repeat(arr[..., None], 4, axis=-1)).save(path)


def _merge_masks(pairs: Iterable[Tuple[str, np.ndarray]],
                 simplify80: bool = False) -> Dict[str, np.ndarray]:
    """word→mask dict from (word, mask) pairs; masks for the same word are
    OR-merged (clipped sum).  ``simplify80`` coarsens COCO-80 labels to the
    COCOSTUFF-27 superclass first (reference ``daam/experiment.py:89-99``,
    minus its ``masks[word.lower()]`` latent-KeyError quirk)."""
    masks: Dict[str, np.ndarray] = {}
    for word, mask in pairs:
        if simplify80:
            word = COCO80_TO_27.get(word, word)
        prev = masks.get(word)
        masks[word] = mask if prev is None else np.clip(prev + mask, 0, 1)
    return masks


def _masks_from_dir(directory: Path, suffix: str,
                    simplify80: bool) -> Dict[str, np.ndarray]:
    """Collect ``{word}{suffix}`` PNG masks from a directory."""
    pairs = ((p.name[:-len(suffix)].lower(), load_mask(str(p)))
             for p in directory.glob(f'*{suffix}'))
    return _merge_masks(pairs, simplify80)


def _masks_from_composite(png_path: Path, vocab: List[str],
                          simplify80: bool) -> Dict[str, np.ndarray]:
    """Split one index-image into per-label masks (composite predictions)."""
    import PIL.Image

    if not png_path.exists():
        return {}
    im = np.array(PIL.Image.open(png_path))
    pairs = ((vocab[idx], (im == idx).astype(np.float32))
             for idx in np.unique(im))
    return _merge_masks(pairs, simplify80)


def _experiment_file(path: Union[str, Path], prompt_id: Optional[str],
                     name: str) -> Path:
    base = Path(path) if prompt_id is None else Path(path) / prompt_id
    return base / name


# ---------------------------------------------------------------------------
# generation.pt
# ---------------------------------------------------------------------------

class _RefShim:
    """Stand-in for ``daam.experiment.GenerationExperiment`` when unpickling
    reference-written checkpoints without the reference installed: accepts
    the pickled ``__dict__`` as attributes (the default dataclass BUILD)."""


class _RefCompatUnpickler(pickle.Unpickler):
    """Maps reference classes (and any other unresolvable ``daam.*`` global)
    to inert shims so ``torch.load`` of a reference ``generation.pt`` works
    even when ``daam``/``diffusers``/``spacy`` are not importable."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            if module.startswith('daam'):
                return type(name, (_RefShim,), {})
            raise


class _RefPickleModule:
    Unpickler = _RefCompatUnpickler


def _read_payload(pt_path: Path) -> dict:
    """Read ``generation.pt``: the pickled numpy payload (``daam_tpu.v1``),
    or — when the file is a torch zip checkpoint (reference-written, or
    ``reference_format=True`` output of either package) — through
    ``torch.load`` with the compat unpickler."""
    raw = pt_path.read_bytes()
    if raw[:2] == b'PK':  # torch.save zip container
        exp = torch.load(io.BytesIO(raw), map_location='cpu',
                         weights_only=False, pickle_module=_RefPickleModule)
        return {
            'image': np.array(exp.image),
            'global_heat_map': np.asarray(exp.global_heat_map,
                                          dtype=np.float32),
            'prompt': exp.prompt,
            'seed': getattr(exp, 'seed', None),
            'format': 'daam.reference',
        }
    return pickle.loads(raw)


def _write_reference_payload(pt_path: Path, image, global_heat_map,
                             prompt: str, seed, subtype: str) -> None:
    """Write ``generation.pt`` as a torch checkpoint the *reference* can load:
    ``torch.load`` on the reference side must unpickle a
    ``daam.experiment.GenerationExperiment`` instance
    (``daam/experiment.py:337``).  That class reference comes from pickling
    a class made here whose ``__module__``/``__qualname__`` point at the
    reference path, with stand-in modules registered for the duration of
    the dump (pickle stores classes by reference, so nothing of the port
    ends up in the file — the reference resolves its own class at load
    time)."""
    cls = type('GenerationExperiment', (), {'__module__': 'daam.experiment'})
    obj = cls.__new__(cls)
    obj.__dict__.update(
        image=image,
        global_heat_map=torch.from_numpy(
            np.asarray(global_heat_map, dtype=np.float32)),
        prompt=prompt,
        seed=seed,
        id='.',
        path=None,
        truth_masks=None,
        prediction_masks=None,
        annotations=None,
        subtype=subtype,
        tokenizer=None,
    )

    fake_pkg = types.ModuleType('daam')
    fake_mod = types.ModuleType('daam.experiment')
    fake_mod.GenerationExperiment = cls
    fake_pkg.experiment = fake_mod
    saved = {k: sys.modules.get(k) for k in ('daam', 'daam.experiment')}
    sys.modules['daam'] = fake_pkg
    sys.modules['daam.experiment'] = fake_mod
    try:
        torch.save(obj, pt_path)
    finally:
        for k, v in saved.items():
            if v is None:
                del sys.modules[k]
            else:
                sys.modules[k] = v


@dataclass
class GenerationExperiment:
    """Serializable generation + heat maps (reference ``daam/experiment.py:102-344``)."""

    image: Any  # PIL.Image.Image, or (H, W, 3) floats in [0, 1]
    global_heat_map: Any  # (tokens, x, x) array
    prompt: str

    seed: Optional[int] = None
    id: str = '.'
    path: Optional[Path] = None

    truth_masks: Optional[Dict[str, np.ndarray]] = None
    prediction_masks: Optional[Dict[str, np.ndarray]] = None
    annotations: Optional[Dict[str, Any]] = None
    subtype: Optional[str] = '.'
    tokenizer: Any = None

    # Not a field, so neither the payload nor the comparison sees it: the
    # device the maps were made on, where ``trace.to_experiment`` puts it
    # (None: the PNGs are drawn on the host).
    _device = None

    def __post_init__(self):
        if isinstance(self.path, str):
            self.path = Path(self.path)
        self.path = None if self.path is None else self.path / self.id

    # ----------------------------------------------------------------- state
    def nsfw(self) -> bool:
        """All-black output means the safety checker fired
        (reference ``daam/experiment.py:125-126``)."""
        return bool(np.sum(np.array(self.image)) == 0)

    def heat_map(self, tokenizer: Any = None):
        return GlobalHeatMap(tokenizer or self.tokenizer, self.prompt,
                             self.global_heat_map)

    def annotate(self, key: str, value: Any) -> 'GenerationExperiment':
        if self.annotations is None:
            self.annotations = {}
        self.annotations[key] = value
        return self

    # ------------------------------------------------------------------ save
    def _payload(self) -> dict:
        return {
            'image': np.array(self.image),
            'global_heat_map': np.asarray(self.global_heat_map,
                                          dtype=np.float32),
            'prompt': self.prompt,
            'seed': self.seed,
            'id': self.id,
            'subtype': self.subtype,
            'annotations': self.annotations,
            'format': 'daam_tpu.v1',
        }

    def save(self, path: Optional[str] = None, heat_maps: bool = True,
             tokenizer: Any = None, reference_format: bool = False):
        """Write the reference's artifact set (``daam/experiment.py:140-167``).

        ``reference_format=True`` writes ``generation.pt`` as a torch
        checkpoint that the reference's ``GenerationExperiment.load`` reads
        (``daam/experiment.py:337``); the default is ``daam_tpu``'s pickled
        numpy payload.  :meth:`load` reads both."""
        with span('experiment.save'):
            if path is not None:
                self.path = Path(path) / self.id
            path = self.path
            tokenizer = tokenizer or self.tokenizer

            (path / self.subtype).mkdir(parents=True, exist_ok=True)
            if reference_format:
                _write_reference_payload(
                    path / self.subtype / 'generation.pt', _to_pil(self.image),
                    self.global_heat_map, self.prompt, self.seed, self.subtype)
            else:
                (path / self.subtype / 'generation.pt').write_bytes(
                    pickle.dumps(self._payload()))
            save_image(self.image, path / self.subtype / 'output.png', self._device)
            (path / 'prompt.txt').write_text(self.prompt)
            (path / 'seed.txt').write_text(str(self.seed))

            for name, mask in (self.truth_masks or {}).items():
                _write_mask_png(path / f'{name.lower()}.gt.png', mask)

            if heat_maps and tokenizer is not None:
                self.save_all_heat_maps(tokenizer)
            self.save_annotations()

    def save_annotations(self, path: Optional[Path] = None):
        if self.annotations is not None:
            with ((path or self.path) / 'annotations.json').open('w') as f:
                json.dump(self.annotations, f)

    def save_prediction_mask(self, mask, word: str, name: str):
        _write_mask_png(self.path / self.subtype / f'{word.lower()}.{name}.pred.png',
                        np.asarray(mask))

    def clear_prediction_masks(self, name: str):
        for mask_path in (self.path / self.subtype).glob(f'*.{name}.pred.png'):
            mask_path.unlink()

    def clear_checkpoint(self):
        """Delete ``generation.pt`` (the ``--all-heads`` runs keep only the
        PNGs, ``daam_tpu/experiment.py:287-289``)."""
        (self.path / 'generation.pt').unlink(missing_ok=True)

    def save_heat_map(self, word: str, tokenizer: Any = None,
                      crop: Optional[int] = None, output_prefix: str = '',
                      absolute: bool = False) -> Path:
        """Write ``{output_prefix}{word}.heat_map.png``.  ``crop`` is taken
        for the reference's signature and, as in ``daam_tpu`` and the
        reference, not applied to the saved overlay."""
        out = (self.path / self.subtype /
               f'{output_prefix}{word.lower()}.heat_map.png')
        word_map = self.heat_map(tokenizer).compute_word_heat_map(word)
        save_overlay(self.image, word_map, out, color_normalize=not absolute,
                     device=self._device)
        return out

    def save_all_heat_maps(self, tokenizer: Any = None,
                           crop: Optional[int] = None) -> Dict[str, Path]:
        """One ``{word}.heat_map.png`` per word of the prompt; a word whose
        map fails (not found by the tokenizer, punctuation, truncation) is
        skipped, as ``daam_tpu`` skips it."""
        path_map: Dict[str, Path] = {}
        for word in self.prompt.split(' '):
            try:
                path_map[word] = self.save_heat_map(word, tokenizer, crop=crop)
            except Exception:
                pass
        return path_map

    # -- static probes (reference ``daam/experiment.py:259-287``) ------------
    @staticmethod
    def contains_truth_mask(path: Union[str, Path],
                            prompt_id: Optional[str] = None) -> bool:
        base = Path(path) if prompt_id is None else Path(path) / prompt_id
        return any(base.glob('*.gt.png'))

    @staticmethod
    def read_seed(path: Union[str, Path],
                  prompt_id: Optional[str] = None) -> int:
        return int(_experiment_file(path, prompt_id, 'seed.txt').read_text())

    @staticmethod
    def read_prompt(path: Union[str, Path],
                    prompt_id: Optional[str] = None) -> str:
        return _experiment_file(path, prompt_id or '.',
                                'prompt.txt').read_text().strip()

    @staticmethod
    def has_annotations(path: Union[str, Path]) -> bool:
        return _experiment_file(path, None, 'annotations.json').exists()

    @staticmethod
    def has_experiment(path: Union[str, Path], prompt_id: str) -> bool:
        return _experiment_file(path, prompt_id, 'generation.pt').exists()

    # ------------------------------------------------------------------ load
    @classmethod
    def load(cls, path, pred_prefix: str = 'daam', composite: bool = False,
             simplify80: bool = False, vocab: Optional[List[str]] = None,
             subtype: str = '.', all_subtypes: bool = False):
        """Load an experiment dir (every subtype under ``all_subtypes``);
        reference ``daam/experiment.py:303-344``.  Reads both packages'
        payloads and reference torch checkpoints."""
        import PIL.Image

        if all_subtypes:
            experiments = []
            for directory in Path(path).iterdir():
                if not directory.is_dir():
                    continue
                try:
                    experiments.append(cls.load(
                        path, pred_prefix=pred_prefix, composite=composite,
                        simplify80=simplify80, vocab=vocab,
                        subtype=directory.name))
                except Exception:
                    pass  # non-experiment subdirectory
            return experiments

        path = Path(path)
        payload = _read_payload(path / subtype / 'generation.pt')
        exp = cls(
            image=PIL.Image.fromarray(payload['image']),
            global_heat_map=payload['global_heat_map'],
            prompt=payload['prompt'],
            seed=payload.get('seed'),
            id='.',
            subtype=subtype,
        )
        exp.path = path
        exp.truth_masks = _masks_from_dir(path, '.gt.png', simplify80)
        if composite:
            exp.prediction_masks = _masks_from_composite(
                path / subtype / f'composite.{pred_prefix}.pred.png',
                vocab if vocab is not None else UNUSED_LABELS, simplify80)
        else:
            exp.prediction_masks = _masks_from_dir(
                path / subtype, f'.{pred_prefix}.pred.png', simplify80)
        anns = path / 'annotations.json'
        exp.annotations = json.load(anns.open()) if anns.exists() else None
        return exp
