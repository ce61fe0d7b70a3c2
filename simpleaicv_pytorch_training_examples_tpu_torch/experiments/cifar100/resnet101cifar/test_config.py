"""ResNet-101 (CIFAR stem) CIFAR-100 eval.

The port's counterpart of the JAX experiment
00.classification_training/cifar100/resnet101cifar (test_config.py over its
train_config.py): the same model settings and test transforms as this
directory's train_config.py. Point ``trained_model_path`` at a torch
``.pth`` to evaluate it; the data root is ``$SIMPLEAICV_DATA_ROOT/CIFAR100``.

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.test_classification_model --work-dir <this dir>
"""

import os

import numpy as np
import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification import backbones
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater, Opencv2PIL, TorchMeanStdNormalize, load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.cifar100dataset import (
    CIFAR100Dataset)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose

CIFAR100_path = os.path.join(
    os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"), "CIFAR100")


class config:
    network = "resnet101cifar"
    num_classes = 100
    input_image_size = 32

    model = backbones.__dict__[network](**{
        "num_classes": num_classes,
        "dtype": torch.bfloat16,
    })

    # path to the torch weights to evaluate
    trained_model_path = ""
    load_state_dict(trained_model_path, model)

    test_dataset = CIFAR100Dataset(
        root_dir=CIFAR100_path,
        set_name="test",
        transform=Compose([
            Opencv2PIL(),
            TorchMeanStdNormalize(mean=np.array([125.3, 123.0, 113.9]) / 255.0,
                                  std=np.array([63.0, 62.1, 66.7]) / 255.0),
        ]))
    test_collater = ClassificationCollater()

    seed = 0
    batch_size = 128
    num_workers = 16
