"""SDXL pipeline: dual text encoders and the ``text_time`` conditioning.

Counterpart of ``daam_tpu/pipeline/sdxl.py``.  The prompt goes through
CLIP-L and OpenCLIP-bigG, each tokenized by its own tokenizer (CLIP-L pads
with ``<|endoftext|>``, OpenCLIP with 0); the two penultimate hidden states
are concatenated into the UNet's 2048-wide context, and bigG's projected
pooled embedding with the six size/crop ids ``[h, w, 0, 0, h, w]`` feeds
the UNet's ``add_embedding``.  The negative prompt (``''`` by default) goes
through both encoders like the prompt, as in ``daam_tpu``; it is not
replaced by zeros as diffusers' ``force_zeros_for_empty_prompt`` would.
"""

from typing import Sequence

import numpy as np
import torch

from ..models.configs import PipelineConfig
from ..tokenization import default_tokenizer
from .sd import StableDiffusionPipeline

__all__ = ['StableDiffusionXLPipeline']


class StableDiffusionXLPipeline(StableDiffusionPipeline):
    is_sdxl = True

    def __init__(self, config: PipelineConfig, text_encoder, text_encoder_2,
                 unet, vae, tokenizer=None, tokenizer_2=None,
                 scheduler='ddim'):
        if config.text_2 is None:
            raise ValueError(f'{config.name}: SDXL needs a second text '
                             f'encoder config (text_2)')
        super().__init__(config, text_encoder, unet, vae, tokenizer=tokenizer,
                         scheduler=scheduler)
        self.text_encoder_2 = text_encoder_2
        self.tokenizer_2 = tokenizer_2 or default_tokenizer(pad_id=0)

    def _encode_tokens(self, prompts: Sequence[str]) -> torch.Tensor:
        """(B, 2, 77): the ids of each encoder's tokenizer."""
        ids = [tok(list(prompts), padding='max_length', truncation=True,
                   return_tensors='np')['input_ids']
               for tok in (self.tokenizer, self.tokenizer_2)]
        return torch.as_tensor(np.stack(ids, axis=1), dtype=torch.long,
                               device=self.device)

    def _text_forward(self, input_ids: torch.Tensor):
        hidden_1, _ = self.text_encoder(input_ids[:, 0], penultimate=True)
        hidden_2, pooled_2 = self.text_encoder_2(input_ids[:, 1],
                                                 penultimate=True)
        return torch.cat([hidden_1, hidden_2], dim=-1), pooled_2

    def _merge_added(self, added_uncond, added_cond, height: int, width: int):
        """``added_*`` are bigG's pooled embeddings of each CFG half."""
        pooled = torch.cat([added_uncond, added_cond], dim=0)
        time_ids = torch.tensor([height, width, 0, 0, height, width],
                                dtype=torch.float32, device=pooled.device)
        return {'text_embeds': pooled,
                'time_ids': time_ids.expand(pooled.shape[0], 6)}
