"""Experiment persistence for the quickgen artifact set.

Counterpart of ``daam_tpu/experiment.py``'s ``GenerationExperiment.save``
(reference ``daam/experiment.py:140-167``): ``path/id/subtype/`` receives
``generation.pt``, ``output.png``, ``prompt.txt``, ``seed.txt`` and one
``{word}.heat_map.png`` per word.  ``generation.pt`` is the same pickled
numpy payload ``daam_tpu`` writes (format ``daam_tpu.v1``), so either
package reads the other's experiment folders.  PIL is imported only where a
PNG is written.  Truth/prediction masks, annotations and loading wait for a
later port.
"""

import pickle
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

__all__ = ['GenerationExperiment']


@dataclass
class GenerationExperiment:
    """Serializable generation + heat maps (reference ``daam/experiment.py:102-344``)."""

    image: Any  # PIL.Image.Image or (H, W, 3) array
    global_heat_map: Any  # (tokens, x, x) array
    prompt: str

    seed: Optional[int] = None
    id: str = '.'
    path: Optional[Path] = None
    subtype: Optional[str] = '.'
    tokenizer: Any = None

    def __post_init__(self):
        if isinstance(self.path, str):
            self.path = Path(self.path)
        self.path = None if self.path is None else self.path / self.id

    def heat_map(self, tokenizer: Any = None):
        from .heatmap import GlobalHeatMap
        return GlobalHeatMap(tokenizer or self.tokenizer, self.prompt,
                             self.global_heat_map)

    def _payload(self) -> dict:
        return {
            'image': np.array(self.image),
            'global_heat_map': np.asarray(self.global_heat_map, dtype=np.float32),
            'prompt': self.prompt,
            'seed': self.seed,
            'id': self.id,
            'subtype': self.subtype,
            'annotations': None,
            'format': 'daam_tpu.v1',
        }

    def save(self, path: Optional[str] = None, heat_maps: bool = True,
             tokenizer: Any = None):
        """Write the reference's artifact set (``daam/experiment.py:140-167``)."""
        import PIL.Image

        if path is not None:
            self.path = Path(path) / self.id
        path = self.path
        tokenizer = tokenizer or self.tokenizer
        (path / self.subtype).mkdir(parents=True, exist_ok=True)
        (path / self.subtype / 'generation.pt').write_bytes(
            pickle.dumps(self._payload()))
        image = self.image
        if not isinstance(image, PIL.Image.Image):  # (H, W, 3) floats in [0, 1]
            u8 = np.clip(np.asarray(image) * 255 + 0.5, 0, 255).astype(np.uint8)
            image = PIL.Image.fromarray(u8)
        image.save(path / self.subtype / 'output.png')
        (path / 'prompt.txt').write_text(self.prompt)
        (path / 'seed.txt').write_text(str(self.seed))
        if heat_maps and tokenizer is not None:
            self.save_all_heat_maps(tokenizer)

    def clear_checkpoint(self):
        """Delete ``generation.pt`` (the ``--all-heads`` runs keep only the
        PNGs, ``daam_tpu/experiment.py:287-289``)."""
        (self.path / 'generation.pt').unlink(missing_ok=True)

    def save_heat_map(self, word: str, tokenizer: Any = None,
                      output_prefix: str = '', absolute: bool = False) -> Path:
        out = (self.path / self.subtype /
               f'{output_prefix}{word.lower()}.heat_map.png')
        self.heat_map(tokenizer).compute_word_heat_map(word).expand_as(
            self.image, color_normalize=not absolute, out_file=out, plot=True)
        return out

    def save_all_heat_maps(self, tokenizer: Any = None) -> Dict[str, Path]:
        """One ``{word}.heat_map.png`` per word of the prompt; words the
        tokenizer cannot find in the prompt are skipped."""
        path_map: Dict[str, Path] = {}
        for word in self.prompt.split(' '):
            try:
                path_map[word] = self.save_heat_map(word, tokenizer)
            except ValueError:
                pass
        return path_map
