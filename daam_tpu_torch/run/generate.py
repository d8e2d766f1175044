"""``daam-torch`` CLI — the ``quickgen`` action of ``daam_tpu/run/generate.py``.

Generates one image for a prompt under ``trace(pipe)`` and writes the
reference's artifact set into ``--output-folder`` (``daam_tpu/run/generate.py:
235-333``): ``output.png``, ``generation.pt``, ``prompt.txt``, ``seed.txt``
and one ``{word}.heat_map.png`` per word.  ``--from-path`` loads a local
diffusers checkpoint directory (it takes precedence over ``--model``, as in
``daam_tpu``; ``--tiny`` over both); without it the weights are random,
drawn from ``--seed``.  ``--reference-format`` writes ``generation.pt`` as
the torch checkpoint the reference's tooling loads.
``--save-heads``/``--load-heads`` save and replay the attention
heads (the transplant), ``--time-maps`` adds per-step maps and a
``{word}.time.gif`` per word, ``--all-heads`` one map per (layer, head),
``--scheduler`` picks DDIM (the default), PNDM, Euler or DPM++ as
``daam_tpu``'s flag does.
The other actions (coco, template, cconj, stdin, regenerate, prompt),
``--batch-size`` and ``--word`` are not ported yet.

The device defaults to ``cuda``; without a GPU the CLI stops with an error
rather than running on the CPU, which takes ``--device cpu``.
"""

import argparse
from pathlib import Path

import torch

from ..experiment import GenerationExperiment
from ..pipeline.sd import StableDiffusionPipeline
from ..trace import trace
from ..utils import resolve_device, set_seed

MODELS = ['v1', 'v2-base', 'v2-1-base', 'v2-large', 'v2-1-large', 'xl-base-1.0']
SCHEDULERS = ['ddim', 'pndm', 'euler', 'dpm++']


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog='daam-torch')
    parser.add_argument('prompt', type=str)
    parser.add_argument('--model', type=str, default='v2-1-base', choices=MODELS)
    parser.add_argument('--output-folder', '-o', type=str, default='.')
    parser.add_argument('--seed', '-s', type=int, default=0)
    parser.add_argument('--num-timesteps', '-n', type=int, default=30)
    parser.add_argument('--low-memory', action='store_true')
    parser.add_argument('--all-heads', action='store_true')
    parser.add_argument('--time-maps', action='store_true',
                        help='also save one heat map per denoising step and '
                             'word (files time{S}-{word}.heat_map.png plus '
                             'an animated {word}.time.gif); uses cheap '
                             'accumulator snapshots unless --save-heads')
    parser.add_argument('--time-chunk', type=int, default=1,
                        help='steps per --time-maps frame on the snapshot '
                             'path (1 = every step)')
    parser.add_argument('--save-heads', action='store_true')
    parser.add_argument('--load-heads', action='store_true')
    parser.add_argument('--reference-format', action='store_true',
                        help='write generation.pt as a torch checkpoint the '
                             'reference daam tooling can load')
    parser.add_argument('--tiny', action='store_true',
                        help='tiny random-weight preset (smoke runs): '
                             'tiny-xl for an xl --model, else tiny')
    parser.add_argument('--from-path', type=str, default=None,
                        help='local diffusers checkpoint directory')
    parser.add_argument('--scheduler', type=str, default='ddim',
                        choices=SCHEDULERS)
    parser.add_argument('--dtype', type=str, default='float32',
                        choices=['float32', 'bfloat16'])
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device (default: cuda; pass cpu to run '
                             'on the CPU)')
    return parser


def load_pipeline(args) -> StableDiffusionPipeline:
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == 'bfloat16' else torch.float32
    source = args.from_path or args.model  # daam_tpu/run/generate.py:236-246
    if args.tiny:
        source = 'tiny-xl' if 'xl' in args.model else 'tiny'
    return StableDiffusionPipeline.from_pretrained(source, device=device,
                                                   dtype=dtype, seed=args.seed,
                                                   scheduler=args.scheduler)


def main(argv=None):
    args = build_parser().parse_args(argv)
    pipe = load_pipeline(args)
    prompt = args.prompt.replace(',', ' ,').replace('.', ' .').strip()
    generator = set_seed(args.seed, device=pipe.device)
    # --time-maps without --save-heads rides the accumulator snapshots.
    time_chunk = (args.time_chunk if args.time_maps and
                  not (args.save_heads or args.load_heads) else None)
    with trace(pipe, low_memory=args.low_memory, save_heads=args.save_heads,
               load_heads=args.load_heads, time_chunk_steps=time_chunk) as tc:
        out = pipe(prompt, num_inference_steps=args.num_timesteps,
                   generator=generator, callback=tc.time_callback)
        exp = tc.to_experiment(args.output_folder, seed=args.seed)
        exp.image = out.images[0]
        exp.save(args.output_folder, heat_maps=False,
                 reference_format=args.reference_format)
        words = exp.save_all_heat_maps()
        if args.all_heads:
            exp.clear_checkpoint()
        for word in words:
            if args.all_heads:
                save_all_heads(tc, args, prompt, word, out.images[0])
            if args.time_maps:
                save_time_maps(tc, args, prompt, word, out.images[0])
    print(f'[daam-torch] {prompt!r} -> {args.output_folder}')


def _experiment(tc, args, prompt, heat_maps, image) -> GenerationExperiment:
    return GenerationExperiment(image, heat_maps, prompt, seed=args.seed,
                                path=Path(args.output_folder),
                                tokenizer=tc.pipe.tokenizer)


def save_time_maps(tc, args, prompt, word, image):
    """Per-denoising-step heat maps for one word and their animated GIF
    (``daam_tpu/run/generate.py:337-371``)."""
    import PIL.Image

    try:
        per_step = tc.compute_time_global_heat_maps()
    except RuntimeError as e:
        print(f'[daam-torch] --time-maps skipped: {e}')
        return
    frames = [_experiment(tc, args, prompt, hm.heat_maps.cpu().numpy(), image)
              .save_heat_map(word, output_prefix=f'time{s:03d}-')
              for s, hm in enumerate(per_step)]
    if not frames:
        return
    rgb = []
    for path in frames:
        with PIL.Image.open(path) as im:
            rgb.append(im.convert('RGB'))
    rgb[0].save(frames[0].parent / f'{word.lower()}.time.gif', save_all=True,
                append_images=rgb[1:], duration=150, loop=0)


def save_all_heads(tc, args, prompt, word, image):
    """One heat map per (layer, head), each layer at its real head count
    (``daam_tpu/run/generate.py:374-398``)."""
    for layer_idx, (layer_name, n_heads) in enumerate(
            zip(tc.layer_names, tc.layer_heads)):
        for head_idx in range(n_heads):
            try:
                heat_map = tc.compute_global_heat_map(layer_idx=layer_idx,
                                                      head_idx=head_idx)
            except RuntimeError:
                print(f'Missing ({layer_idx}, {head_idx}, {layer_name})')
                continue
            _experiment(tc, args, prompt, heat_map.heat_maps.cpu().numpy(),
                        image).save_heat_map(
                word, output_prefix=f'l{layer_idx}-{layer_name}-h{head_idx}-')


if __name__ == '__main__':
    main()
