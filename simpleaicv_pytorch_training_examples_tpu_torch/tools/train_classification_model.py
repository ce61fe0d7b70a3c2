"""Classification training entry point.

``python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_classification_model --work-dir D``
loads ``D/train_config.py`` (a ``config`` class holding live objects: model,
datasets, collaters, criterion, optimizer and scheduler settings) and trains
through ``engine.run_training`` with ``classification_evaluator``: each
epoch trains, evaluates top-1 / top-5 on the test set, writes
``latest.pth`` and, on a new best top-1, ``best.pth`` (the EMA weights when
EMA is on); a run resumes from ``D/checkpoints/latest.pth`` when it is
there. Logs to ``D/log/train.log``. One process, one GPU; runs on CUDA
unless ``--device cpu`` (or ``device="cpu"``) asks for the CPU.
"""

import argparse

from ..engine import classification_evaluator, run_training
from ..utils import load_config_from_work_dir


def parse_args(argv=None, description="train classification model"):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--work-dir", type=str, required=True,
                        help="path to experiment dir with train_config.py")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when not given")
    return parser.parse_args(argv)


def epoch_summaries(run):
    """The runner's epoch records with the evaluator's top-1 and top-5."""
    return [{**{k: v for k, v in e.items() if k != "eval"},
             "top1": e["eval"]["top1"], "top5": e["eval"]["top5"]}
            for e in run["epochs"]]


def main(argv=None, device=None):
    """Train the work dir's model; returns {'best_top1', 'resumed_from'
    (epoch or None), 'epochs': [{'epoch', 'loss_avg', 'skipped', 'top1',
    'top5', 'train_images_per_s', 'seconds', 'loader_wait_seconds',
    'loader_start_seconds', 'first_batch_wait_seconds', 'step_seconds'},
    ...]} for the epochs run in this call."""
    args = parse_args(argv)
    config = load_config_from_work_dir(args.work_dir, "train_config")
    run = run_training(config, args.work_dir,
                       build_eval=classification_evaluator,
                       device=device if device is not None else args.device)
    return {"best_top1": run["best_metric"],
            "resumed_from": run["resumed_from"],
            "epochs": epoch_summaries(run)}


if __name__ == "__main__":
    main()
