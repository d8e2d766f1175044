"""The ``transplant`` flow: the attention transplant of ``--save-heads`` /
``--load-heads`` and of the demo's counterfactual.

A ``trace(pipe, save_heads=True, persist_heads=False)`` run of the prompt,
its maps fetched to the host, then a ``trace(pipe, load_heads=True)`` run
of the prompt with its adjective swapped, from the same generator seed,
its maps fetched too; then ``release_heads()``.  The save run hands on the
program's heads buffer (not persisted to disk: at 30 steps it is about
1.7 GB); the runner copies it for a sampled request and drops it for any
other.
"""

import daam_tpu_torch


class Flow:
    IMAGES_PER_PROMPT = 2  # the prompt's and its counterfactual's

    def __init__(self, ctx):
        self.ctx = ctx
        self.lib = ctx.load_flow('lib')

    def _call(self, tc, prompt, seed, steps, clock):
        ctx = self.ctx
        with clock.span('pipeline'):
            clock.begin()
            out = ctx.pipe(prompt, num_inference_steps=steps,
                           generator=[ctx.generator(seed)],
                           guidance_scale=ctx.guidance, callback=clock.on_step,
                           callback_steps=1)
            clock.end_call()
        g, w = self.lib.maps(tc, [prompt], clock)
        return {'prompts': [prompt], 'seeds': [seed], 'clock': clock,
                'images': self.lib.images_u8(out), 'maps': g, 'words': w}

    def request(self, req, steps, clock):
        ctx = self.ctx
        (a,), (b,), (seed,) = req['prompts'], req['counterfactuals'], req['seeds']
        with daam_tpu_torch.trace(ctx.pipe, save_heads=True, persist_heads=False) as tc:
            save = dict(self._call(tc, a, seed, steps, clock), kind='save',
                        heads=tc.replay_buffer(0))
        second = ctx.new_clock()
        with daam_tpu_torch.trace(ctx.pipe, load_heads=True) as tc:
            load = dict(self._call(tc, b, seed, steps, second), kind='load')
        daam_tpu_torch.release_heads()
        return [save, load]
