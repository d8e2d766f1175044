"""The ``cli`` flow: the loop of ``daam-torch`` (``run/generate.py``).

Inside ``trace(pipe)``: one pipeline call for the request's prompts (one
generator per prompt), then for each image ``to_experiment``,
``save(heat_maps=False)`` and ``save_heat_map(word)`` for every word of the
prompt, as the command writes them.  Prompts are spaced around ``,`` and
``.`` as the command spaces them.  The step callback is live
(``callback_steps=1``) so that the clock can time each step.
"""

import daam_tpu_torch


class Flow:
    def __init__(self, ctx):
        self.ctx = ctx

    def request(self, req, steps, clock):
        ctx = self.ctx
        pipe = ctx.pipe
        prompts = [p.replace(',', ' ,').replace('.', ' .').strip() for p in req['prompts']]
        gens = [ctx.generator(s) for s in req['seeds']]
        dirs = []
        with daam_tpu_torch.trace(pipe) as tc:
            with clock.span('pipeline'):
                clock.begin()
                out = pipe(prompts if len(prompts) > 1 else prompts[0],
                           num_inference_steps=steps, generator=gens,
                           guidance_scale=ctx.guidance, callback=clock.on_step,
                           callback_steps=1)
                clock.end_call()
            for offset, (prompt, seed) in enumerate(zip(prompts, req['seeds'])):
                pid = f"{req['index']}-{offset}"
                with clock.span('experiment'):
                    exp = tc.to_experiment(ctx.out_dir, id=pid, seed=seed, batch_idx=offset)
                    exp.image = out.images[offset]
                    exp.save(ctx.out_dir, heat_maps=False)
                    for word in prompt.split():
                        try:
                            exp.save_heat_map(word)
                        except ValueError:
                            continue
                dirs.append(ctx.out_dir / pid)
        return [{'kind': 'plain', 'prompts': prompts, 'seeds': req['seeds'],
                 'clock': clock, 'dirs': dirs}]
