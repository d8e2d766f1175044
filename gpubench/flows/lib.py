"""The ``lib`` flow: the README's library use.

Inside ``trace(pipe)``: one pipeline call, then for each image
``compute_global_heat_map`` and ``compute_word_heat_map(word)`` for every
word of the prompt (its punctuation stripped), each map fetched to host
memory as an array.  No file is written.
"""

import daam_tpu_torch


def words(prompt):
    return [w for w in (w.strip('.,') for w in prompt.split()) if w]


def maps(tc, prompts, clock):
    """Each prompt's global map and word maps, on the host."""
    out_g, out_w = [], []
    for b, prompt in enumerate(prompts):
        with clock.span('maps'):
            g = tc.compute_global_heat_map(prompt, batch_idx=b)
            out_w.append({w: g.compute_word_heat_map(w).value.cpu().numpy()
                          for w in words(prompt)})
            out_g.append(g.heat_maps.cpu().numpy())
    return out_g, out_w


def images_u8(out):
    import numpy as np
    return [np.asarray(im) for im in out.images]


class Flow:
    def __init__(self, ctx):
        self.ctx = ctx

    def request(self, req, steps, clock):
        ctx = self.ctx
        pipe = ctx.pipe
        prompts = req['prompts']
        with daam_tpu_torch.trace(pipe) as tc:
            with clock.span('pipeline'):
                clock.begin()
                out = pipe(prompts if len(prompts) > 1 else prompts[0],
                           num_inference_steps=steps,
                           generator=[ctx.generator(s) for s in req['seeds']],
                           guidance_scale=ctx.guidance, callback=clock.on_step,
                           callback_steps=1)
                clock.end_call()
            g, w = maps(tc, prompts, clock)
        return [{'kind': 'plain', 'prompts': prompts, 'seeds': req['seeds'],
                 'clock': clock, 'images': images_u8(out), 'maps': g, 'words': w}]
