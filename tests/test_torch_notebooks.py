"""Execute the port's research notebooks (``notebooks/torch/``) end to end.

They are the studies of ``notebooks/*.ipynb`` on ``daam_tpu_torch``: notebook
1 generates 20 traced experiments, saves and reloads them and builds the
dependency-relation and paper tables; notebook 2 runs the blue/green/red
attention transplant, the cohyponym table and the evolution series.  Their
first code cell is ``DEVICE = 'cuda'``; here it is overridden to ``'cpu'``
after that cell, and the cells run by ``exec`` in one namespace, as
``tests/test_notebooks.py`` runs ``daam_tpu``'s.  The assertions are that
file's.  The tables are not compared with the JAX notebooks': those draw
their ``tiny`` weights through ``jax.random``, so the two studies run on
different weights.  This file imports neither JAX nor ``daam_tpu``.
"""

import importlib
import json
from collections import OrderedDict
from pathlib import Path

import pytest
import torch

NB_DIR = Path(__file__).resolve().parent.parent / 'notebooks' / 'torch'


@pytest.fixture(autouse=True)
def _isolated_heads(tmp_path, monkeypatch):
    """save_heads persists under $XDG_CACHE_HOME: keep it in the test's
    directory, with an empty in-process replay registry.  One torch thread:
    the ``tiny`` model's ops are too small to share, and beside other test
    workers a thread per core made notebook 1 15× slower."""
    monkeypatch.setenv('XDG_CACHE_HOME', str(tmp_path / 'cache'))
    monkeypatch.setattr(importlib.import_module('daam_tpu_torch.trace'),
                        '_HEAD_CACHE', OrderedDict())
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run_notebook(name, tmp_path, monkeypatch):
    nb = json.loads((NB_DIR / name).read_text())
    monkeypatch.chdir(tmp_path)   # experiment dirs land in the tmp dir
    ns = {'__name__': '__main__'}
    cells = [c for c in nb['cells'] if c['cell_type'] == 'code']
    assert ''.join(cells[0]['source']).strip() == "DEVICE = 'cuda'"
    for i, cell in enumerate(cells):
        src = ''.join(cell['source'])
        assert 'jax' not in src and 'daam_tpu.' not in src
        exec(compile(src, f'{name}:cell', 'exec'), ns)  # noqa: S102
        if i == 0:
            ns['DEVICE'] = 'cpu'
    return ns


def test_notebook_1_visuosyntactic_corpus_study(tmp_path, monkeypatch):
    """The full generate -> save -> load -> analyze loop: 20 experiments on
    disk and a relation table with the caption-corpus relations present."""
    ns = _run_notebook('1-visuosyntactic-analyses.ipynb', tmp_path,
                       monkeypatch)
    assert str(ns['pipe'].device) == 'cpu'

    out_dir = tmp_path / ns['OUT_DIR']
    exp_dirs = [d for d in out_dir.iterdir() if d.is_dir()]
    assert len(exp_dirs) == 20
    for d in exp_dirs:
        assert (d / 'generation.pt').exists()
        assert (d / 'output.png').exists()
        assert (d / 'prompt.txt').exists()
        assert (d / 'seed.txt').exists()

    table = ns['relation_table']
    rels = {row['relation'] for row in table}
    assert {'amod', 'det'} <= rels      # every caption has det + adjective
    for row in table:
        assert row['n'] > 0
        assert 0.0 <= row['mIoU'] <= 1.0
        assert 0.0 <= row['mIoH'] <= 1.0
        assert 0.0 <= row['mIoD'] <= 1.0
    amod = next(r for r in table if r['relation'] == 'amod')
    assert amod['n'] >= 20              # >=1 adjective per caption

    paper = ns['paper_table']
    assert 0 < len(paper) <= 10
    deltas = [r['delta'] for r in paper]
    assert deltas == sorted(deltas)
    for r in paper:
        assert 0.0 <= r['mIoU'] <= 100.0
        assert abs(r['delta'] - abs(r['mIoH'] - r['mIoD'])) < 0.02


def test_notebook_2_visuosemantic(tmp_path, monkeypatch):
    """Adjectival-entanglement transplant triplet + cohyponym overlap run."""
    ns = _run_notebook('2-visuosemantic-analyses.ipynb', tmp_path,
                       monkeypatch)
    assert set(ns['images']) == {'blue', 'green', 'red'}
    assert callable(ns['pair_overlap'])
    table = ns['cohyponym_table']
    assert {row['group'] for row in table} == {'cohyponyms', 'unrelated'}
    for row in table:
        assert row['n'] == 3
        assert 0.0 <= row['mIoU'] <= 1.0

    # attention-evolution study: one normalized mass value per step per word
    series = ns['evolution_series']
    assert set(series) == {'zebra', 'giraffe', 'field'}
    for ys in series.values():
        assert len(ys) == ns['STEPS']
        assert all(0.0 <= y <= 1.0 for y in ys)


def test_notebook_0_setup(tmp_path, monkeypatch):
    ns = _run_notebook('0-setup.ipynb', tmp_path, monkeypatch)
    assert 'heat_map' in ns
    assert str(ns['pipe'].device) == 'cpu'
