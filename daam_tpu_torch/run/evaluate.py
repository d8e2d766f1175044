"""``daam-torch-evaluate`` CLI — segmentation-style evaluation of experiment folders.

Counterpart of ``daam_tpu/run/evaluate.py`` (reference
``daam/run/evaluate.py``): walks the experiment directories under
``--input-folder`` that hold ground-truth masks, loads their prediction
masks by prefix, and prints the labeled, unlabeled or Hungarian mIoU report
in the reference's format.  The masks are scored on ``--device``, the card
unless ``--device cpu`` is given; without one the CLI stops with an error.
"""

import argparse
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterator, List, Optional

from ..evaluate import MeanEvaluator, UnsupervisedEvaluator
from ..experiment import COCO80_LABELS, COCOSTUFF27_LABELS, GenerationExperiment
from ..utils import resolve_device


@dataclass
class EvalConfig:
    input_folder: str
    pred_prefix: str = 'daam'
    mask_type: str = 'word'          # 'word' | 'composite'
    eval_type: str = 'labeled'       # 'labeled' | 'unlabeled' | 'hungarian'
    restrict_set: str = 'none'       # 'none' | 'coco27' | 'coco80'
    subtype: str = '.'
    vocab: List[str] = field(default_factory=list)
    device: str = 'cuda'

    @property
    def simplify80(self) -> bool:
        return self.restrict_set == 'coco27'

    @property
    def composite(self) -> bool:
        return self.mask_type == 'composite'

    @property
    def restricted(self) -> bool:
        return self.restrict_set != 'none'


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog='daam-torch-evaluate')
    parser.add_argument('--input-folder', '-i', type=str, required=True)
    parser.add_argument('--pred-prefix', '-p', type=str, default='daam')
    parser.add_argument('--mask-type', '-m', type=str, default='word',
                        choices=['word', 'composite'])
    parser.add_argument('--eval-type', '-e', type=str, default='labeled',
                        choices=['labeled', 'unlabeled', 'hungarian'])
    parser.add_argument('--restrict-set', '-r', type=str, default='none',
                        choices=['none', 'coco27', 'coco80'])
    parser.add_argument('--subtype', '-st', type=str, default='.')
    parser.add_argument('--device', type=str, default='cuda',
                        help='torch device (default: cuda; pass cpu to run '
                             'on the CPU)')
    return parser


def iter_experiment_dirs(root: str) -> Iterator[Path]:
    """Experiment directories under ``root`` that have ground-truth masks."""
    for path in sorted(Path(root).glob('*')):
        if path.is_dir() and GenerationExperiment.contains_truth_mask(path):
            yield path


def load_experiment(path: Path, cfg: EvalConfig,
                    with_vocab: bool = True) -> GenerationExperiment:
    return GenerationExperiment.load(
        path,
        cfg.pred_prefix,
        composite=cfg.composite,
        simplify80=cfg.simplify80,
        vocab=cfg.vocab if with_vocab else None,
        subtype=cfg.subtype,
    )


def discover_vocab(cfg: EvalConfig) -> List[str]:
    """Union of truth/prediction mask names across the corpus, sorted
    (the reference's auto-vocab scan, ``daam/run/evaluate.py:30-46``)."""
    seen = set()
    for path in iter_experiment_dirs(cfg.input_folder):
        exp = load_experiment(path, cfg, with_vocab=False)
        seen.update(exp.truth_masks)
        seen.update(exp.prediction_masks)
    return sorted(seen)


def resolve_vocab(cfg: EvalConfig) -> None:
    if cfg.restrict_set == 'coco27':
        cfg.vocab = list(COCOSTUFF27_LABELS)
    elif cfg.restrict_set == 'coco80':
        cfg.vocab = list(COCO80_LABELS)
    else:
        cfg.vocab = discover_vocab(cfg)


def score_labeled(exp: GenerationExperiment, cfg: EvalConfig,
                  ev: MeanEvaluator) -> None:
    """Word-matched IoU + mean intensity per ground-truth mask."""
    for word, truth in exp.truth_masks.items():
        if cfg.restricted and word not in cfg.vocab:
            continue
        pred = exp.prediction_masks.get(word)
        if pred is None:
            continue
        ev.log_iou(pred, truth)
        ev.log_intensity(pred)


def score_unlabeled(exp: GenerationExperiment, cfg: EvalConfig,
                    ev: MeanEvaluator) -> None:
    """Best-of-all-predictions IoU against each ground truth."""
    preds = list(exp.prediction_masks.values())
    for truth in exp.truth_masks.values():
        ev.log_iou(preds, truth)


def score_hungarian(exp: GenerationExperiment, cfg: EvalConfig,
                    ev: UnsupervisedEvaluator) -> None:
    """Vocab-indexed IoU matrix entries for Hungarian matching."""
    for gt_word, gt_mask in exp.truth_masks.items():
        if cfg.restricted and gt_word not in cfg.vocab:
            continue
        for pred_word, pred_mask in exp.prediction_masks.items():
            if gt_word not in cfg.vocab or pred_word not in cfg.vocab:
                continue
            ev.log_iou(pred_mask, gt_mask,
                       gt_idx=cfg.vocab.index(gt_word),
                       pred_idx=cfg.vocab.index(pred_word))
        ev.increment()


_SCORERS = {
    'labeled': score_labeled,
    'unlabeled': score_unlabeled,
    'hungarian': score_hungarian,
}


def run_evaluation(cfg: EvalConfig):
    device = resolve_device(cfg.device)
    resolve_vocab(cfg)
    evaluator = (UnsupervisedEvaluator(device=device) if cfg.eval_type == 'hungarian'
                 else MeanEvaluator(device=device))
    scorer = _SCORERS[cfg.eval_type]
    try:  # corpus-scale progress, like the reference (daam/run/evaluate.py:31)
        from tqdm import tqdm
        dirs = tqdm(list(iter_experiment_dirs(cfg.input_folder)),
                    unit='exp', desc='daam evaluate')
    except ImportError:
        dirs = iter_experiment_dirs(cfg.input_folder)
    for path in dirs:
        scorer(load_experiment(path, cfg), cfg, evaluator)
    return evaluator


def main(argv: Optional[list] = None):
    args = build_parser().parse_args(argv)
    cfg = EvalConfig(input_folder=args.input_folder,
                     pred_prefix=args.pred_prefix,
                     mask_type=args.mask_type,
                     eval_type=args.eval_type,
                     restrict_set=args.restrict_set,
                     subtype=args.subtype,
                     device=args.device)
    evaluator = run_evaluation(cfg)
    print(evaluator)
    return evaluator


if __name__ == '__main__':
    main()
