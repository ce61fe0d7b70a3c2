"""darknettiny ImageNet-1K eval.

The port's counterpart of the JAX experiment
00.classification_training/imagenet/darknettiny (test_config.py over its
train_config.py): this directory's train_config.py's model, val set and
collater. Point ``config.trained_model_path`` at a torch ``.pth`` (a
``best.pth`` of the train CLI, or the reference torch weights) and load
it with ``load_state_dict`` to evaluate it.

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.test_classification_model --work-dir <this dir>
"""

from train_config import config  # noqa: F401
