"""The ``daam-torch`` CLI's actions against ``daam_tpu``'s, and end to end.

With ``random`` and ``numpy.random`` seeded alike, each package's
``collect_prompts`` gives the same ``(prompt_id, prompt)`` list and the same
seeds for every action (``template`` over ``data/vocab-small.tsv``,
``coco`` and ``coco-unreal`` over a fabricated ``captions_val2014.json``);
``filter_by_lemma``, ``_pluralize`` and ``read_template_tsv`` agree.  Then
each action runs through ``daam_tpu_torch.run.generate.main`` on ``tiny``
(``--device cpu``) and writes the artifact set; ``regenerate`` gives each
prompt the same image at ``--batch-size`` 1 and 2; ``--random-seed`` gives
two samples of one chunk two seeds; ``--all-heads`` and ``--time-maps``
read each sample of a batch.
"""

import io
import json
import random
from pathlib import Path

import numpy as np
import PIL.Image
import pytest

from daam_tpu.run import generate as theirs
from daam_tpu_torch.run import generate as ours

REPO = Path(__file__).resolve().parents[1]
VOCAB = str(REPO / 'data' / 'vocab-small.tsv')
CAPTIONS = [
    {'id': 101, 'caption': 'A brown dog chases a white cat'},
    {'id': 102, 'caption': 'A red car near a tall tree'},
    {'id': 103, 'caption': 'The small bird sits on a bench'},
    {'id': 104, 'caption': 'Two dogs and a dog run on the beach'},
    {'id': 105, 'caption': 'A dog sleeps next to a large dog'},
]
CORPUS = [('e0', 'a dog runs', 3), ('e1', 'a cat sits', 9), ('e2', 'a red car', 5)]
ARTIFACTS = {'output.png', 'generation.pt', 'prompt.txt', 'seed.txt'}


@pytest.fixture
def inputs(tmp_path):
    """A captions file and a corpus of experiment folders, in one folder."""
    root = tmp_path / 'input'
    root.mkdir()
    (root / 'captions_val2014.json').write_text(json.dumps({'annotations': CAPTIONS}))
    corpus = tmp_path / 'corpus'
    for name, prompt, seed in CORPUS:
        (corpus / name).mkdir(parents=True)
        (corpus / name / 'prompt.txt').write_text(prompt)
        (corpus / name / 'seed.txt').write_text(str(seed))
    (corpus / 'e1' / 'cat.gt.png').write_bytes(b'')  # e1 alone has a truth mask
    return root, corpus


def _argv(action, inputs, gen_limit=7):
    root, corpus = inputs
    limit = ['--gen-limit', str(gen_limit)]
    return {'template': ['--action', 'template', '-tdf', VOCAB, *limit,
                         '--template', 'a {numeral} {noun} and {numeral} {noun}'],
            'cconj': ['--action', 'cconj', *limit, '--seed-offset', '4'],
            'coco': ['--action', 'coco', '-i', str(root), *limit],
            'coco-unreal': ['--action', 'coco-unreal', '-i', str(root), *limit],
            'stdin': ['--action', 'stdin'],
            'regenerate': ['--action', 'regenerate', '-i', str(corpus)],
            'regenerate-truth-only': ['--action', 'regenerate', '-i', str(corpus),
                                      '--truth-only'],
            'prompt': ['--action', 'prompt'],
            'quickgen': ['A dog runs.']}[action]


def _collect(module, argv, monkeypatch):
    monkeypatch.setattr('sys.stdin', io.StringIO('a dog\n a cat sits \nthree birds\n'))
    monkeypatch.setattr('builtins.input', lambda *a: 'a bird flies')
    args = module.build_parser().parse_args(argv)
    random.seed(0)
    np.random.seed(0)
    prompts, seeds = module.collect_prompts(args)
    return prompts, seeds, args.output_folder


@pytest.mark.parametrize('action', ['template', 'cconj', 'coco', 'coco-unreal',
                                    'stdin', 'regenerate', 'regenerate-truth-only',
                                    'prompt', 'quickgen'])
def test_collect_prompts_matches_daam_tpu(action, inputs, monkeypatch):
    argv = _argv(action, inputs)
    got = _collect(ours, argv, monkeypatch)
    want = _collect(theirs, argv, monkeypatch)
    assert got == want
    prompts, seeds, _ = got
    assert prompts
    if action.startswith('regenerate'):
        assert seeds == ([9] if action.endswith('only') else [3, 9, 5])


@pytest.mark.parametrize('lemma', ['dog', 'cat', 'run', 'tree', 'sit'])
def test_filter_by_lemma_matches_daam_tpu(lemma):
    prompts = [(c['id'], c['caption']) for c in CAPTIONS]
    prompts += [('x', 'The cats are running'), ('y', 'a tree and trees')]
    assert ours.filter_by_lemma(prompts, lemma) == theirs.filter_by_lemma(prompts, lemma)


def test_pluralize_and_template_tsv_match_daam_tpu():
    words = ['dog', 'bus', 'box', 'church', 'dish', 'fly', 'boy', 'leaf', 'knife',
             'quiz', 'cat', 'y']
    assert [ours._pluralize(w) for w in words] == [theirs._pluralize(w) for w in words]
    for tsv in ('vocab-small.tsv', 'vocab.tsv'):
        path = str(REPO / 'data' / tsv)
        assert ours.read_template_tsv(path) == theirs.read_template_tsv(path)


def test_sample_seeds():
    """``regenerate``'s seeds from its folders, ``cconj``'s from the prompt
    id plus ``--seed-offset``, ``--random-seed``'s base plus the index,
    else ``--seed`` (``daam_tpu/run/generate.py:278-287``)."""
    parse = ours.build_parser().parse_args
    chunk = [('a', 'p'), ('b', 'q')]
    assert ours.sample_seeds(parse(['-s', '7']), chunk, 4, [], 100) == [7, 7]
    assert ours.sample_seeds(parse(['--random-seed']), chunk, 4, [], 100) == [104, 105]
    assert ours.sample_seeds(parse(['-a', 'regenerate']), chunk, 1, [3, 9, 5], 0) == [9, 5]
    cconj = [('cohypo-12', 'p'), ('diff-13', 'q')]
    assert ours.sample_seeds(parse(['-a', 'cconj', '--seed-offset', '4']), cconj,
                             12, [], 0) == [16, 17]


def _run(argv, out, monkeypatch):
    monkeypatch.setattr('sys.stdin', io.StringIO('a dog\na cat sits\n'))
    monkeypatch.setattr('builtins.input', lambda *a: 'a bird flies')
    ours.main([*argv, '--tiny', '-n', '1', '-o', str(out), '--device', 'cpu'])
    return {d.name: d for d in out.iterdir() if d.is_dir()}


@pytest.mark.parametrize('action,n', [('prompt', 1), ('coco', 3), ('coco-unreal', 2),
                                      ('template', 3), ('cconj', 3), ('stdin', 2),
                                      ('regenerate', 3)])
def test_action_end_to_end(action, n, inputs, tmp_path, monkeypatch):
    """Each action at ``--batch-size 2``, over a chunk of 2 and one of 1
    (a lone prompt for ``prompt``): every experiment holds the artifact
    set, its prompt and its seed, and a heat map for a word of its prompt."""
    dirs = _run([*_argv(action, inputs, gen_limit=n), '--batch-size', '2'],
                tmp_path / 'out', monkeypatch)
    assert len(dirs) == n
    for name, d in dirs.items():
        files = {p.name for p in d.iterdir()}
        assert ARTIFACTS <= files, name
        prompt = (d / 'prompt.txt').read_text()
        assert any(f'{w.lower()}.heat_map.png' in files for w in prompt.split()), name
        seed = int((d / 'seed.txt').read_text())
        if action == 'cconj':
            assert seed == int(name.split('-')[1]) + 4
        elif action == 'regenerate':
            assert seed == dict((e, s) for e, _, s in CORPUS)[name]
        else:
            assert seed == 0


def test_word_filters_prompts_and_maps(inputs, tmp_path, monkeypatch):
    """``--word dog``: only captions holding the lemma once, and only the
    word's map (``dogs`` in caption 104 is a second ``dog``)."""
    dirs = _run(['--action', 'coco', '-i', str(inputs[0]), '--word', 'dog',
                 '--batch-size', '2'], tmp_path / 'out', monkeypatch)
    assert sorted(dirs) == ['101']
    maps = sorted(p.name for p in dirs['101'].glob('*.heat_map.png'))
    assert maps == ['dog.heat_map.png']


def test_regenerate_reproduces_across_batch_sizes(inputs, tmp_path, monkeypatch):
    """A prompt's PNG is the same at ``--batch-size`` 1 and 2 (the port
    against itself, as ``tests/test_cli_batch_repro.py`` holds daam_tpu)."""
    images = {}
    for b in (1, 2):
        dirs = _run(['--action', 'regenerate', '-i', str(inputs[1]),
                     '--batch-size', str(b)], tmp_path / f'b{b}', monkeypatch)
        images[b] = {n: np.array(PIL.Image.open(d / 'output.png')) for n, d in dirs.items()}
    assert sorted(images[1]) == sorted(images[2]) == ['e0', 'e1', 'e2']
    for name in images[1]:
        np.testing.assert_array_equal(images[1][name], images[2][name])


def test_random_seed_batched_distinct(tmp_path, monkeypatch):
    """Two samples of one chunk with ``--random-seed``: one prompt, two
    seeds, two images (``tests/test_cli_seeds_heads.py:71``)."""
    tsv = tmp_path / 'template.tsv'
    tsv.write_text('word\tpos\ndog\tnoun\ntwo\tnumeral\n')
    dirs = _run(['--action', 'template', '-tdf', str(tsv), '--gen-limit', '2',
                 '--batch-size', '2', '--random-seed'], tmp_path / 'out', monkeypatch)
    d = [dirs[k] for k in sorted(dirs)]
    assert [(x / 'prompt.txt').read_text() for x in d] == ['two dogs', 'two dogs']
    s0, s1 = (int((x / 'seed.txt').read_text()) for x in d)
    assert s1 == s0 + 1
    assert not np.array_equal(np.array(PIL.Image.open(d[0] / 'output.png')),
                              np.array(PIL.Image.open(d[1] / 'output.png')))


@pytest.mark.parametrize('flags', [('--all-heads',), ('--time-maps',),
                                   ('--time-maps', '--save-heads')])
def test_per_sample_head_and_time_maps(flags, inputs, tmp_path, monkeypatch):
    """``--all-heads`` and ``--time-maps`` at ``--batch-size 2`` write each
    sample's own maps into its own folder: the same file names, and maps
    of different prompts that differ (``--word a``: the one word every
    prompt holds once, so each writes one word's maps)."""
    dirs = _run(['--action', 'regenerate', '-i', str(inputs[1]), '--batch-size', '2',
                 '--word', 'a', *flags], tmp_path / 'out', monkeypatch)
    pattern = 'l*-h*-a.heat_map.png' if '--all-heads' in flags else 'time*-a.heat_map.png'
    names = {n: sorted(p.name for p in dirs[n].glob(pattern)) for n in ('e0', 'e1')}
    assert names['e0'] and names['e0'] == names['e1']
    if '--time-maps' in flags:
        assert (dirs['e1'] / 'a.time.gif').exists()
    first = names['e0'][0]
    assert not np.array_equal(np.array(PIL.Image.open(dirs['e0'] / first)),
                              np.array(PIL.Image.open(dirs['e1'] / first)))


def test_batch_size_must_be_positive(tmp_path):
    with pytest.raises(SystemExit):
        ours.main(['a dog', '--tiny', '--batch-size', '0', '--device', 'cpu',
                   '-o', str(tmp_path)])
