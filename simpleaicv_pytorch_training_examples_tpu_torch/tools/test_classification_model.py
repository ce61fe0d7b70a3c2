"""Classification eval entry point.

``python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.test_classification_model --work-dir D``
with a ``test_config.py`` in D naming the model, the test dataset, its
collater and the checkpoint to evaluate: ``engine.run_test`` with
``classification_evaluator``. Logs the parameter count and top-1 / top-5
accuracy with images/s. Runs on CUDA unless ``--device cpu`` (or
``device="cpu"``) asks for the CPU.
"""

import argparse

from ..engine import classification_evaluator, run_test


def parse_args(argv=None, description="test classification model"):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--work-dir", type=str, required=True)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device; CUDA when not given")
    return parser.parse_args(argv)


def main(argv=None, device=None):
    """Evaluate the work dir's model; returns {'top1', 'top5',
    'images_per_s', 'images'}."""
    args = parse_args(argv)
    _, _, values = run_test(args.work_dir, classification_evaluator,
                            device if device is not None else args.device)
    return values


if __name__ == "__main__":
    main()
