"""A run with the timed path broken underneath comes out not correct.

The harness runs on the CPU at the test sizes with one fault planted in
the program, once for each fault that the cells can have: a denoising
step that returns its state unchanged; half of a batch left out of the
decode, the mean of the rest in its place; an answer altered where it is
produced (a heat map, a word's overlay left unwritten or drawn wrong, a
saved head).  The
cells run on one chip, so no exchange between chips can be left out.
"""

import numpy as np
import pytest
import torch

from gpubench.tests.drive import run_cell

CELLS = ['sd21-512-fp32.cli-b1', 'sdxl-1024-bf16.lib-b1', 'sd21-512-fp32.cli-b4',
         'sd21-512-fp32.transplant-b1']


def failed(line):
    return not line['correct'] and any(c['value'] > c['limit'] for c in line['checks'].values())


@pytest.mark.parametrize('workload', CELLS)
def test_step_returns_state_unchanged(workload, monkeypatch):
    from daam_tpu_torch.pipeline import schedulers

    monkeypatch.setattr(schedulers.DDIMScheduler, 'step',
                        lambda self, state, i, out, sample: (sample, state))
    assert failed(run_cell(workload))


def test_half_the_batch_left_out(monkeypatch):
    from daam_tpu_torch.pipeline.sd import StableDiffusionPipeline

    decode = StableDiffusionPipeline._decode

    def half(self, latents):
        images = decode(self, latents[:latents.shape[0] // 2])
        rest = images.mean(0, keepdim=True).expand(latents.shape[0] - images.shape[0], -1, -1, -1)
        return torch.cat([images, rest])

    monkeypatch.setattr(StableDiffusionPipeline, '_decode', half)
    assert failed(run_cell('sd21-512-fp32.cli-b4', seconds=2.0))


@pytest.mark.parametrize('workload', CELLS)
def test_heat_map_altered(workload, monkeypatch):
    from daam_tpu_torch.trace import DiffusionHeatMapHooker

    compute = DiffusionHeatMapHooker.compute_global_heat_map

    def altered(self, *args, **kwargs):
        g = compute(self, *args, **kwargs)
        g.heat_maps = g.heat_maps.clone()
        g.heat_maps[2] *= 1.5    # the first word's row
        return g

    monkeypatch.setattr(DiffusionHeatMapHooker, 'compute_global_heat_map', altered)
    assert failed(run_cell(workload))


def test_overlay_left_unwritten(monkeypatch):
    from daam_tpu_torch.experiment import GenerationExperiment

    save = GenerationExperiment.save_heat_map

    def skip_last(self, word, *args, **kwargs):
        if word == self.prompt.split()[-2]:
            raise ValueError('skipped')
        return save(self, word, *args, **kwargs)

    monkeypatch.setattr(GenerationExperiment, 'save_heat_map', skip_last)
    line = run_cell('sd21-512-fp32.cli-b1')
    assert not line['correct'] and line['checks']['png_missing']['value'] >= 1


def _nearest(x, size, clamp_min=None):
    out = torch.nn.functional.interpolate(x.float().reshape(1, -1, *x.shape[-2:]),
                                          size=tuple(size), mode='nearest')
    return out.reshape(*x.shape[:-2], *size)


@pytest.mark.parametrize('fault', ['nearest_resize', 'another_word', 'no_heat'])
@pytest.mark.parametrize('workload', ['sd21-512-fp32.cli-b1', 'sd21-512-fp32.cli-b4'])
def test_overlay_drawn_wrong(workload, fault, monkeypatch):
    """Each word's PNG is read back and held against the reference's
    overlay: a nearest resize in place of the bicubic one, another word's
    map under this word's name, or the image with no map over it fails."""
    from daam_tpu_torch import heatmap
    from daam_tpu_torch.experiment import GenerationExperiment

    if fault == 'nearest_resize':
        monkeypatch.setattr(heatmap, 'bicubic_resize', _nearest)
    elif fault == 'another_word':
        save = GenerationExperiment.save_heat_map

        def swapped(self, word, *args, **kwargs):
            out = save(self, word, *args, **kwargs)
            other = next(w for w in self.prompt.split() if w.lower() != word.lower())
            self.heat_map().compute_word_heat_map(other).expand_as(
                self.image, color_normalize=True, out_file=out, plot=True)
            return out

        monkeypatch.setattr(GenerationExperiment, 'save_heat_map', swapped)
    else:
        monkeypatch.setattr(heatmap, '_jet_composite',
                            lambda image, heat, normalize: np.asarray(image) / 255.0)
    line = run_cell(workload)
    assert not line['correct']
    assert line['checks']['overlay_err']['value'] > line['checks']['overlay_err']['limit']


def test_image_altered(monkeypatch):
    from daam_tpu_torch.pipeline import sd

    to_pil = sd._to_pil

    def altered(images):
        images = np.array(images)
        images[:, : images.shape[1] // 2] = 1.0 - images[:, : images.shape[1] // 2]
        return to_pil(images)

    monkeypatch.setattr(sd, '_to_pil', altered)
    assert failed(run_cell('sdxl-1024-bf16.lib-b1'))


def test_saved_heads_altered(monkeypatch):
    from daam_tpu_torch.trace import DiffusionHeatMapHooker

    replay = DiffusionHeatMapHooker.replay_buffer

    def altered(self, num_steps):
        saved = replay(self, num_steps)
        if self.save_heads and num_steps == 0:
            return {n: a.flip(-1) for n, a in saved.items()}
        return saved

    monkeypatch.setattr(DiffusionHeatMapHooker, 'replay_buffer', altered)
    line = run_cell('sd21-512-fp32.transplant-b1')
    assert not line['correct'] and line['checks']['heads_err']['value'] > line['checks']['heads_err']['limit']
