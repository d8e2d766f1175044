"""``daam-torch`` CLI — batch generation with heat-map tracing.

Counterpart of ``daam_tpu/run/generate.py``, with its eight actions
(``quickgen``, ``prompt``, ``coco``, ``coco-unreal``, ``template``,
``cconj``, ``stdin``, ``regenerate``; reference ``generate.py:22``) and the
reference's per-experiment artifact set in ``--output-folder``:
``output.png``, ``generation.pt``, ``prompt.txt``, ``seed.txt`` and one
``{word}.heat_map.png`` per word (only the words whose lemma is ``--word``'s
when it is given, and then only prompts holding that lemma once).

``--batch-size B`` traces B prompts per pipeline call, each with its own
``torch.Generator`` seeded from its own seed, so a prompt's image does not
depend on the batch it rode in; each prompt's maps come from
``compute_global_heat_map(batch_idx=i)``.  ``regenerate`` reads each
experiment folder's ``seed.txt``, ``cconj`` derives a seed from the prompt
id, ``--random-seed`` takes one time-derived base plus the prompt's index.
``--from-path`` loads a local diffusers checkpoint directory (it takes
precedence over ``--model``, as in ``daam_tpu``; ``--tiny`` over both);
without it the weights are random, drawn from ``--seed``.
``--save-heads``/``--load-heads`` save and replay the attention heads (the
transplant), ``--time-maps`` adds per-step maps and a ``{word}.time.gif``
per word, ``--all-heads`` one map per (layer, head), ``--scheduler`` picks
DDIM (the default), PNDM, Euler or DPM++, ``--reference-format`` writes
``generation.pt`` as the torch checkpoint the reference's tooling loads.

The device defaults to ``cuda``; without a GPU the CLI stops with an error
rather than running on the CPU, which takes ``--device cpu``.
"""

import argparse
import copy
import json
import random
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from ..experiment import GenerationExperiment, build_word_list_coco80
from ..nlp import cached_nlp
from ..pipeline.sd import StableDiffusionPipeline
from ..trace import trace
from ..utils import resolve_device, set_seed

try:
    from tqdm import tqdm
except ImportError:  # a minimal environment: a no-op progress bar
    class tqdm:  # noqa: N801 - drop-in stand-in
        def __init__(self, total=None, **kwargs):
            self.total = total

        def update(self, n=1):
            pass

        @staticmethod
        def write(msg):
            print(msg)

        def close(self):
            pass

ACTIONS = ['quickgen', 'prompt', 'coco', 'template', 'cconj', 'coco-unreal',
           'stdin', 'regenerate']
MODELS = ['v1', 'v2-base', 'v2-1-base', 'v2-large', 'v2-1-large', 'xl-base-1.0']
SCHEDULERS = ['ddim', 'pndm', 'euler', 'dpm++']

_PLURAL_NUMERALS = {'0', '2', '3', '4', '5', '6', '7', '8', '9', 'zero', 'two',
                    'three', 'four', 'five', 'six', 'seven', 'eight', 'nine'}


def _pluralize(word: str) -> str:
    """Small built-in pluralizer (the reference shells out to ``inflect``)."""
    if word.endswith(('s', 'sh', 'ch', 'x', 'z')):
        return word + 'es'
    if word.endswith('y') and len(word) > 1 and word[-2] not in 'aeiou':
        return word[:-1] + 'ies'
    if word.endswith('f'):
        return word[:-1] + 'ves'
    if word.endswith('fe'):
        return word[:-2] + 'ves'
    return word + 's'


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog='daam-torch')
    parser.add_argument('prompt', nargs='?', type=str)
    parser.add_argument('--action', '-a', type=str, choices=ACTIONS,
                        default=ACTIONS[0])
    parser.add_argument('--low-memory', action='store_true')
    parser.add_argument('--model', type=str, default='v2-1-base', choices=MODELS)
    parser.add_argument('--output-folder', '-o', type=str)
    parser.add_argument('--input-folder', '-i', type=str, default='input')
    parser.add_argument('--seed', '-s', type=int, default=0)
    parser.add_argument('--gen-limit', type=int, default=1000)
    parser.add_argument('--template', type=str, default='{numeral} {noun}')
    parser.add_argument('--template-data-file', '-tdf', type=str,
                        default='template.tsv')
    parser.add_argument('--seed-offset', type=int, default=0)
    parser.add_argument('--num-timesteps', '-n', type=int, default=30)
    parser.add_argument('--all-heads', action='store_true')
    parser.add_argument('--time-maps', action='store_true',
                        help='also save one heat map per denoising step and '
                             'word (files time{S}-{word}.heat_map.png plus '
                             'an animated {word}.time.gif); uses cheap '
                             'accumulator snapshots unless --save-heads')
    parser.add_argument('--time-chunk', type=int, default=1,
                        help='steps per --time-maps frame on the snapshot '
                             'path (1 = every step)')
    parser.add_argument('--word', type=str)
    parser.add_argument('--random-seed', action='store_true')
    parser.add_argument('--truth-only', action='store_true')
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
    parser.add_argument('--batch-size', type=int, default=1,
                        help='prompts traced per pipeline call, each with '
                             'its own generator')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device (default: cuda; pass cpu to run '
                             'on the CPU)')
    return parser


def read_template_tsv(path: str):
    """word<TAB>pos TSV → {pos: [words]} (the reference reads it with pandas)."""
    sample_dict = defaultdict(list)
    with open(path) as f:
        header = f.readline().strip().split('\t')
        w_idx, p_idx = header.index('word'), header.index('pos')
        for line in f:
            parts = line.rstrip('\n').split('\t')
            if len(parts) > max(w_idx, p_idx):
                sample_dict[parts[p_idx]].append(parts[w_idx])
    return sample_dict


def collect_prompts(args):
    """The action's ``(prompt_id, prompt)`` list and, for ``regenerate``,
    each prompt's seed (``daam_tpu/run/generate.py:125-172``)."""
    seeds = []
    if args.action.startswith('coco'):
        with (Path(args.input_folder) / 'captions_val2014.json').open() as f:
            captions = json.load(f)['annotations']
        random.shuffle(captions)

        if args.action == 'coco-unreal':
            # every ADJ/NOUN is replaced by a random same-POS token drawn
            # from the whole corpus (reference generate.py:65-92)
            pos_map = defaultdict(list)
            for caption in captions:
                for tok in cached_nlp(caption['caption']):
                    if tok.pos_ in ('ADJ', 'NOUN'):
                        pos_map[tok.pos_].append(tok)
            for caption in captions:
                new_tokens = []
                for tok in cached_nlp(caption['caption']):
                    if tok.pos_ in ('ADJ', 'NOUN') and pos_map[tok.pos_]:
                        chosen = random.choice(pos_map[tok.pos_])
                        new_tokens.append(chosen.text + tok.whitespace_)
                    else:
                        new_tokens.append(tok.text_with_ws)
                caption['caption'] = ''.join(new_tokens)

        prompts = [(caption['id'], caption['caption']) for caption in captions]
    elif args.action == 'stdin':
        prompts = [(idx, line.strip()) for idx, line in enumerate(sys.stdin)]
    elif args.action == 'template':
        sample_dict = read_template_tsv(args.template_data_file)
        prompts = []
        template_words = args.template.split()
        for prompt_id in range(args.gen_limit):
            words = []
            pluralize = False
            for word in template_words:
                if word.startswith('{'):
                    pos = word[1:-1]
                    word = random.choice(sample_dict[pos])
                    if pos == 'noun' and pluralize:
                        word = _pluralize(word)
                words.append(word)
                pluralize = word in _PLURAL_NUMERALS
            prompts.append((str(prompt_id), ' '.join(words)))
    elif args.action == 'cconj':
        words_map = build_word_list_coco80()
        prompts = []
        for idx in range(args.gen_limit):
            use_cohyponym = random.random() < 0.5
            if use_cohyponym:
                c = random.choice(list(words_map.keys()))
                w1, w2 = np.random.choice(words_map[c], 2, replace=False)
            else:
                c1, c2 = np.random.choice(list(words_map.keys()), 2, replace=False)
                w1 = random.choice(words_map[c1])
                w2 = random.choice(words_map[c2])
            prompt_id = f'{"cohypo" if use_cohyponym else "diff"}-{idx}'
            a1 = 'an' if w1[0] in 'aeiou' else 'a'
            a2 = 'an' if w2[0] in 'aeiou' else 'a'
            prompts.append((prompt_id, f'{a1} {w1} and {a2} {w2}'))
    elif args.action == 'quickgen':
        if args.output_folder is None:
            args.output_folder = '.'
        prompts = [('.', args.prompt)]
    elif args.action == 'regenerate':
        prompts = []
        for exp_folder in sorted(Path(args.input_folder).iterdir()):
            if not exp_folder.is_dir():
                continue
            if args.truth_only and not GenerationExperiment.contains_truth_mask(exp_folder):
                continue
            prompts.append((exp_folder.name,
                            GenerationExperiment.read_prompt(exp_folder)))
            seeds.append(GenerationExperiment.read_seed(exp_folder))
        if args.output_folder is None:
            args.output_folder = args.input_folder
    else:  # prompt (interactive)
        prompts = [('prompt', input('> '))]

    if args.output_folder is None:
        args.output_folder = 'output'
    return prompts, seeds


def filter_by_lemma(prompts, lemma):
    """Keep prompts holding the target word exactly once, by lemma
    (reference ``generate.py:175-193``)."""
    kept = []
    for prompt_id, prompt in prompts:
        if lemma not in prompt.lower():
            continue
        count = sum(1 for tok in cached_nlp(prompt)
                    if tok.lemma_.lower() == lemma)
        if count == 1:
            kept.append((prompt_id, prompt))
    return kept


def sample_seeds(args, chunk, gen_idx, seeds, random_seed_base):
    """The seed of each prompt of a chunk starting at index ``gen_idx``
    (``daam_tpu/run/generate.py:278-287``)."""
    out = []
    for offset, (prompt_id, _prompt) in enumerate(chunk):
        idx = gen_idx + offset
        seed = random_seed_base + idx if args.random_seed else args.seed
        if seeds and idx < len(seeds):
            seed = seeds[idx]
        if args.action == 'cconj':
            seed = int(str(prompt_id).split('-')[1]) + args.seed_offset
        out.append(seed)
    return out


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
    if args.batch_size < 1:
        raise SystemExit(f'--batch-size must be at least 1, got {args.batch_size}')
    args.lemma = cached_nlp(args.word)[0].lemma_ if args.word else None

    prompts, seeds = collect_prompts(args)
    if args.lemma is not None:
        prompts = filter_by_lemma(prompts, args.lemma)
    prompts = prompts[:args.gen_limit]

    pipe = load_pipeline(args)

    progress = tqdm(total=len(prompts), unit='img', desc='daam-torch generate',
                    disable=len(prompts) <= 1)
    # --random-seed: one time-derived base per run, offset by the prompt's
    # index; a per-sample int(time.time()) (the reference's form,
    # generate.py:160) would give every prompt of a chunk the same noise
    random_seed_base = int(time.time())
    # --time-maps without --save-heads rides the accumulator snapshots.
    time_chunk = (args.time_chunk if args.time_maps and
                  not (args.save_heads or args.load_heads) else None)
    for gen_idx in range(0, len(prompts), args.batch_size):
        chunk = prompts[gen_idx:gen_idx + args.batch_size]
        chunk_seeds = sample_seeds(args, chunk, gen_idx, seeds, random_seed_base)
        batch = [prompt.replace(',', ' ,').replace('.', ' .').strip()
                 for _, prompt in chunk]
        # one generator per prompt, on the pipeline's device
        generators = [set_seed(s, device=pipe.device) for s in chunk_seeds]
        with trace(pipe, low_memory=args.low_memory, save_heads=args.save_heads,
                   load_heads=args.load_heads, time_chunk_steps=time_chunk) as tc:
            out = pipe(batch if len(batch) > 1 else batch[0],
                       num_inference_steps=args.num_timesteps,
                       generator=generators, callback=tc.time_callback)
            for offset, ((prompt_id, _), prompt, seed) in enumerate(
                    zip(chunk, batch, chunk_seeds)):
                exp = tc.to_experiment(args.output_folder, id=str(prompt_id),
                                       seed=seed, batch_idx=offset)
                exp.image = out.images[offset]
                exp.save(args.output_folder, heat_maps=False,
                         reference_format=args.reference_format)
                if args.all_heads:
                    exp.clear_checkpoint()
                for word in prompt.split():
                    if args.lemma is not None and \
                            cached_nlp(word)[0].lemma_.lower() != args.lemma:
                        continue
                    try:
                        exp.save_heat_map(word)
                    except ValueError:
                        continue
                    if args.all_heads:
                        save_all_heads(tc, exp, word, offset)
                    if args.time_maps:
                        save_time_maps(tc, exp, word, offset)
                progress.update(1)
                progress.write(f'[daam-torch] {prompt_id}: {prompt!r} -> '
                               f'{Path(args.output_folder) / str(prompt_id)}')
    progress.close()


def _experiment(exp, heat_maps) -> GenerationExperiment:
    """``exp`` with other maps, its PNGs written to its directory and drawn
    where its own are: a shallow copy, since ``dataclasses.replace`` would
    run ``__post_init__`` and append ``id`` to ``path`` a second time."""
    other = copy.copy(exp)
    other.global_heat_map = heat_maps
    return other


def save_time_maps(tc, exp, word, batch_idx=0):
    """Per-denoising-step heat maps of one word of one prompt of the batch
    and their animated GIF (``daam_tpu/run/generate.py:337-371``)."""
    import PIL.Image

    try:
        per_step = tc.compute_time_global_heat_maps(batch_idx=batch_idx)
    except RuntimeError as e:
        print(f'[daam-torch] --time-maps skipped: {e}')
        return
    frames = [_experiment(exp, hm.heat_maps.cpu().numpy())
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


def save_all_heads(tc, exp, word, batch_idx=0):
    """One heat map per (layer, head) of one prompt of the batch, each layer
    at its real head count (``daam_tpu/run/generate.py:374-398``)."""
    for layer_idx, (layer_name, n_heads) in enumerate(
            zip(tc.layer_names, tc.layer_heads)):
        for head_idx in range(n_heads):
            try:
                heat_map = tc.compute_global_heat_map(
                    layer_idx=layer_idx, head_idx=head_idx, batch_idx=batch_idx)
            except RuntimeError:
                print(f'Missing ({layer_idx}, {head_idx}, {layer_name})')
                continue
            _experiment(exp, heat_map.heat_maps.cpu().numpy()).save_heat_map(
                word, output_prefix=f'l{layer_idx}-{layer_name}-h{head_idx}-')


if __name__ == '__main__':
    main()
