"""The evaluation path of daam_tpu_torch against daam_tpu's, on the CPU.

* ``iou_matrix``/``ioa_matrix`` on seeded numpy mask stacks of 1–5 masks:
  equal to daam_tpu's bit for bit at equal sizes, and within 1e-4 where the
  predictions are resized (64² → 512², 512² → 480 × 640).  There the
  threshold at exactly 1.0 decides a pixel by one ulp of the summed bicubic
  weights; the test counts the pixels whose binarized value differs between
  the packages and requires none.  With the passes summed in float32
  instead of float64, pixels daam_tpu keeps are dropped (4245 of 48461 at
  512² → 480 × 640, ``test_float32_resize_passes_would_flip_pixels``).
* the evaluators' report strings over the same sequence of masks;
* ``GenerationExperiment`` directories written by either package load in
  the other, with ``reference_format=True``, annotations, truth and
  prediction masks, composite predictions, ``simplify80`` and
  ``all_subtypes``;
* ``daam-torch-evaluate``'s three scorers print daam_tpu's report over one
  corpus directory;
* the heat-map overlay's jet table equals matplotlib's, and without
  matplotlib the overlay composite itself is written as the PNG.
"""

import numpy as np
import PIL.Image
import pytest
import torch

import daam_tpu.evaluate as JE
import daam_tpu.experiment as JX
from daam_tpu.heatmap import WordHeatMap as JaxWordHeatMap
from daam_tpu.run import evaluate as jax_cli
import daam_tpu_torch.evaluate as E
import daam_tpu_torch.experiment as X
from daam_tpu_torch.ops.resize import _weight_matrix_np
from daam_tpu_torch.heatmap import WordHeatMap
from daam_tpu_torch.run import evaluate as cli


def _masks(n, h, w, seed):
    """``n`` seeded binary masks of (h, w): a rectangle each, with a few
    scattered pixels flipped."""
    rng = np.random.RandomState(seed)
    out = np.zeros((n, h, w), np.float32)
    for m in out:
        y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
        m[y0:y0 + rng.randint(h // 8, h // 2), x0:x0 + rng.randint(w // 8, w // 2)] = 1
        flip = rng.rand(h, w) < 0.02
        m[flip] = 1 - m[flip]
    return out


def _binarized_flips(p, out_hw):
    """Pixels whose resized-and-binarized value differs between packages."""
    ours = E._binarize_resize(torch.from_numpy(p), out_hw).numpy()
    theirs = np.asarray(JE._binarize_resize_fn(p.shape[1:], out_hw)(p))
    return int((ours != theirs).sum()), int(theirs.sum())


@pytest.mark.parametrize('n_pred,n_truth', [(1, 1), (3, 2), (5, 4)])
@pytest.mark.parametrize('fn', ['iou_matrix', 'ioa_matrix'])
def test_matrices_equal_at_equal_sizes(fn, n_pred, n_truth):
    p = _masks(n_pred, 96, 80, seed=n_pred)
    t = _masks(n_truth, 96, 80, seed=10 + n_truth)
    ours = getattr(E, fn)(p, t, device='cpu')
    theirs = np.asarray(getattr(JE, fn)(p, t))
    assert ours.shape == (n_pred, n_truth) and ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize('pred_hw,truth_hw', [((64, 64), (512, 512)),
                                              ((512, 512), (480, 640))])
@pytest.mark.parametrize('n_pred', [1, 5])
def test_matrices_match_when_resized(pred_hw, truth_hw, n_pred):
    p = _masks(n_pred, *pred_hw, seed=3)
    t = _masks(2, *truth_hw, seed=4)
    flips, kept = _binarized_flips(p, truth_hw)
    assert kept > 0
    assert flips == 0, f'{flips} of {kept} pixels flip at the 1.0 threshold'
    for fn in ('iou_matrix', 'ioa_matrix'):
        ours = getattr(E, fn)(p, t, device='cpu')
        theirs = np.asarray(getattr(JE, fn)(p, t))
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-4)
        assert ours.max() > 0


def test_float32_resize_passes_would_flip_pixels():
    """Why the resize passes run in float64: the same passes summed in
    float32 on the CPU drop pixels daam_tpu keeps at the 1.0 threshold."""
    p = _masks(1, 512, 512, seed=3)
    x = torch.from_numpy(p)
    for axis, eq in ((0, 'oi,niw->now'), (1, 'oi,nhi->nho')):
        w = torch.from_numpy(_weight_matrix_np(512, (480, 640)[axis]))
        x = torch.einsum(eq, w, x)
    f32 = (x >= 1.0).float().reshape(1, -1).numpy()
    theirs = np.asarray(JE._binarize_resize_fn((512, 512), (480, 640))(p))
    flips = int((f32 != theirs).sum())
    print(f'float32 passes: {flips} of {int(theirs.sum())} pixels differ from daam_tpu')
    assert flips > 0
    assert _binarized_flips(p, (480, 640))[0] == 0


def test_pairs_and_list_inputs():
    a, b = _masks(2, 32, 32, seed=5)
    assert E.compute_iou(a, b, device='cpu') == JE.compute_iou(a, b)
    assert E.compute_ioa(a, b, device='cpu') == JE.compute_ioa(a, b)
    assert E.compute_iou(a, a, device='cpu') == pytest.approx(1.0)
    small = _masks(1, 8, 8, seed=6)[0]
    assert E.compute_ioa(small, b, device='cpu') == JE.compute_ioa(small, b)
    # a list of tensors, as the heat maps give them
    ours = E.iou_matrix([torch.from_numpy(a), torch.from_numpy(b)],
                        torch.from_numpy(b), device='cpu')
    np.testing.assert_array_equal(ours, np.asarray(JE.iou_matrix([a, b], b)))


def test_word_heat_map_value_and_ioa():
    rng = np.random.RandomState(7)
    h1, h2 = rng.rand(2, 16, 16).astype(np.float32) * 2
    ours = WordHeatMap(torch.from_numpy(h1), 'dog')
    assert torch.equal(ours.value, ours.heatmap)
    theirs = JaxWordHeatMap(h1, 'dog').compute_ioa(JaxWordHeatMap(h2, 'cat'))
    assert ours.compute_ioa(WordHeatMap(torch.from_numpy(h2), 'cat')) == theirs


def test_load_mask_equal(tmp_path):
    m = _masks(1, 40, 30, seed=8)[0]
    X._write_mask_png(tmp_path / 'a.png', m)
    JX._write_mask_png(tmp_path / 'b.png', m)
    assert (tmp_path / 'a.png').read_bytes() == (tmp_path / 'b.png').read_bytes()
    np.testing.assert_array_equal(E.load_mask(tmp_path / 'a.png'), m)
    np.testing.assert_array_equal(E.load_mask(tmp_path / 'a.png'),
                                  JE.load_mask(tmp_path / 'a.png'))


def test_evaluator_reports_equal():
    mean, jmean = E.MeanEvaluator(device='cpu'), JE.MeanEvaluator()
    hung, jhung = E.UnsupervisedEvaluator(device='cpu'), JE.UnsupervisedEvaluator()
    for i in range(5):
        preds = _masks(1 + i % 3, 48, 48, seed=20 + i)
        truth = _masks(1, 64, 64, seed=30 + i)[0]
        for ev in (mean, jmean):
            ev.log_iou(list(preds), truth).log_intensity(preds[0])
        for g in range(2):
            for ev in (hung, jhung):
                ev.log_iou(list(preds), truth, gt_idx=g, pred_idx=(g + i) % 3)
        hung.increment()
        jhung.increment()
    assert str(mean) == str(jmean)
    assert str(hung) == str(jhung)
    assert str(mean).startswith('MeanEvaluator<') and len(mean) == 5
    assert str(E.MeanEvaluator('X', device='cpu').log_iou(preds[0], preds[0])
               .log_intensity(preds[0])) == str(
        JE.MeanEvaluator('X').log_iou(preds[0], preds[0]).log_intensity(preds[0]))


def test_device_defaults_to_the_card():
    import inspect
    for fn in (E.iou_matrix, E.ioa_matrix, E.compute_iou, E.compute_ioa):
        assert inspect.signature(fn).parameters['device'].default == 'cuda'
    assert cli.build_parser().parse_args(['-i', 'x']).device == 'cuda'
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default call succeeds')
    m = _masks(1, 8, 8, seed=0)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        E.iou_matrix(m, m)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        cli.main(['-i', '.'])


# ---------------------------------------------------------------------------
# experiments across the packages
# ---------------------------------------------------------------------------

def _experiment(module, root, id, subtype='.', image_seed=0):
    rng = np.random.RandomState(image_seed)
    image = PIL.Image.fromarray(rng.randint(0, 255, (64, 64, 3), dtype=np.uint8))
    heat = rng.rand(77, 8, 8).astype(np.float32)
    return module.GenerationExperiment(
        image=image, global_heat_map=heat, prompt='a dog and a cat', seed=3,
        id=id, path=root, subtype=subtype,
        truth_masks={'dog': _masks(1, 64, 64, 1)[0], 'Cat': _masks(1, 64, 64, 2)[0]})


def _assert_same(a, b):
    assert (a.prompt, a.seed, a.subtype) == (b.prompt, b.seed, b.subtype)
    np.testing.assert_array_equal(np.array(a.image), np.array(b.image))
    np.testing.assert_array_equal(np.asarray(a.global_heat_map),
                                  np.asarray(b.global_heat_map))
    assert a.annotations == b.annotations
    for masks in ('truth_masks', 'prediction_masks'):
        ma, mb = getattr(a, masks), getattr(b, masks)
        assert sorted(ma) == sorted(mb), masks
        for k in ma:
            np.testing.assert_array_equal(ma[k], mb[k])


@pytest.mark.parametrize('writer', ['port', 'daam_tpu'])
@pytest.mark.parametrize('reference_format', [False, True])
def test_experiment_round_trip(writer, reference_format, tmp_path):
    """One package writes (masks, annotations, predictions), the other reads,
    and both readers agree; the static probes too."""
    w = X if writer == 'port' else JX
    exp = _experiment(w, tmp_path, 'e1')
    exp.annotate('split', 'val').annotate('n', 2)
    exp.save(heat_maps=False, reference_format=reference_format)
    exp.save_prediction_mask(_masks(1, 64, 64, 5)[0], 'dog', 'daam')
    exp.save_prediction_mask(_masks(1, 32, 32, 6)[0], 'cat', 'daam')
    exp.save_prediction_mask(_masks(1, 32, 32, 7)[0], 'cat', 'other')
    d = tmp_path / 'e1'
    assert (d / 'generation.pt').read_bytes()[:2] == (b'PK' if reference_format
                                                      else b'\x80\x04')
    ours, theirs = X.GenerationExperiment.load(d), JX.GenerationExperiment.load(d)
    _assert_same(ours, theirs)
    assert sorted(ours.truth_masks) == ['cat', 'dog']
    assert sorted(ours.prediction_masks) == ['cat', 'dog']
    if not reference_format:  # the torch checkpoint keeps no annotations
        assert ours.annotations == {'split': 'val', 'n': 2}
    for probe, args in (('contains_truth_mask', (d,)), ('read_seed', (d,)),
                        ('read_prompt', (d,)), ('has_annotations', (d,)),
                        ('has_experiment', (tmp_path, 'e1'))):
        assert getattr(X.GenerationExperiment, probe)(*args) == \
            getattr(JX.GenerationExperiment, probe)(*args), probe
    assert not ours.nsfw() and ours.nsfw() == theirs.nsfw()
    ours.clear_prediction_masks('other')
    assert not list(d.glob('*.other.pred.png'))


@pytest.mark.parametrize('simplify80', [False, True])
def test_composite_and_subtypes(simplify80, tmp_path):
    """Composite index-image predictions split against a vocabulary (COCO
    labels coarsened under ``simplify80``), and every subtype under
    ``all_subtypes``, read alike by both packages."""
    for st, module in (('s1', X), ('s2', JX)):
        exp = _experiment(module, tmp_path, 'multi', subtype=st, image_seed=len(st))
        exp.truth_masks = {'dog': _masks(1, 64, 64, 1)[0], 'cat': _masks(1, 64, 64, 2)[0],
                           'horse': _masks(1, 64, 64, 3)[0]}
        exp.save(heat_maps=False)
        index = np.zeros((64, 64), np.uint8)
        index[:20], index[40:] = 16, 15  # COCO-80 ids: dog, cat
        PIL.Image.fromarray(index).save(tmp_path / 'multi' / st / 'composite.comp.pred.png')
    vocab = list(X.COCO80_LABELS)
    d = tmp_path / 'multi'
    for st in ('s1', 's2'):
        kw = dict(pred_prefix='comp', composite=True, simplify80=simplify80,
                  vocab=vocab, subtype=st)
        ours, theirs = X.GenerationExperiment.load(d, **kw), JX.GenerationExperiment.load(d, **kw)
        _assert_same(ours, theirs)
        assert ('animal' in ours.truth_masks) == simplify80
    ours = X.GenerationExperiment.load(d, all_subtypes=True)
    theirs = JX.GenerationExperiment.load(d, all_subtypes=True)
    assert sorted(e.subtype for e in ours) == sorted(e.subtype for e in theirs) == ['s1', 's2']
    for a in ours:
        _assert_same(a, next(b for b in theirs if b.subtype == a.subtype))


def test_float_image_and_nsfw(tmp_path):
    """The port's pipelines may hand (H, W, 3) floats; they save as the PIL
    image daam_tpu would write, and an all-black image is nsfw."""
    image = np.zeros((16, 16, 3), np.float32)
    exp = X.GenerationExperiment(image=image, global_heat_map=np.zeros((77, 4, 4)),
                                 prompt='p', path=tmp_path, id='black')
    assert exp.nsfw()
    exp.save(heat_maps=False, reference_format=True)
    loaded = JX.GenerationExperiment.load(tmp_path / 'black')
    assert loaded.nsfw() and loaded.image.size == (16, 16)
    exp.clear_checkpoint()
    assert not (tmp_path / 'black' / 'generation.pt').exists()


# ---------------------------------------------------------------------------
# daam-torch-evaluate
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """Three experiments by both writers: truth masks at the image's size
    and, in one, at 96 × 80 (the resize path); word predictions under
    ``daam`` and a composite under ``comp``."""
    root = tmp_path_factory.mktemp('corpus')
    for i, module in enumerate((X, JX, X)):
        exp = _experiment(module, root, f'exp{i}', image_seed=i)
        hw = (96, 80) if i == 1 else (64, 64)
        exp.truth_masks = {w: _masks(1, *hw, seed=10 * i + j)[0]
                           for j, w in enumerate(('dog', 'cat', 'person'))}
        exp.save(heat_maps=False)
        for j, w in enumerate(('dog', 'cat', 'tree')):
            exp.save_prediction_mask(_masks(1, 64, 64, seed=100 + 10 * i + j)[0], w, 'daam')
        index = np.full((64, 64), 2, np.uint8)  # car
        index[8:40, 8:40], index[30:60, 20:50] = 16, 0  # dog, person
        PIL.Image.fromarray(index).save(root / f'exp{i}' / 'composite.comp.pred.png')
    (root / 'no-truth').mkdir()
    return root


@pytest.mark.parametrize('args', [
    ['-e', 'labeled'], ['-e', 'unlabeled'], ['-e', 'hungarian'],
    ['-e', 'labeled', '-r', 'coco80'], ['-e', 'hungarian', '-r', 'coco27'],
    ['-e', 'unlabeled', '-m', 'composite', '-p', 'comp', '-r', 'coco80']])
def test_cli_reports_equal(corpus, args, capsys):
    jax_cli.main(['-i', str(corpus), *args])
    theirs = capsys.readouterr().out.strip().splitlines()[-1]
    ev = cli.main(['-i', str(corpus), *args, '--device', 'cpu'])
    ours = capsys.readouterr().out.strip().splitlines()[-1]
    assert ours == theirs
    assert ours == str(ev) and len(ev) > 0
    assert [p.name for p in cli.iter_experiment_dirs(str(corpus))] == \
        ['exp0', 'exp1', 'exp2']


# ---------------------------------------------------------------------------
# heat-map PNGs without matplotlib (the card's machine has none)
# ---------------------------------------------------------------------------

def test_jet_table_equals_matplotlib():
    import matplotlib

    from daam_tpu_torch.heatmap import _jet

    levels = np.random.RandomState(0).rand(4096).astype(np.float32)
    levels[:3] = 0.0, 1.0, 0.5
    np.testing.assert_allclose(_jet(levels), matplotlib.colormaps['jet'](levels)[..., :3],
                               rtol=0, atol=1e-12)


def test_overlay_png_without_matplotlib(tmp_path, monkeypatch):
    """Without matplotlib the overlay composite itself is the PNG."""
    import sys

    from daam_tpu_torch.heatmap import _jet_composite, plot_overlay_heat_map

    image = np.random.RandomState(1).randint(0, 255, (24, 32, 3), dtype=np.uint8)
    heat = np.random.RandomState(2).rand(24, 32).astype(np.float32)
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    plot_overlay_heat_map(image, heat, word='dog', out_file=tmp_path / 'dog.png')
    written = np.array(PIL.Image.open(tmp_path / 'dog.png'))
    expect = np.clip(_jet_composite(image, heat, True) * 255 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(written, expect)
