"""ResNet-152 ImageNet-1K eval.

The port's counterpart of the JAX experiment
00.classification_training/imagenet/resnet152 (test_config.py over its
train_config.py): the same model settings and val transforms as this
directory's train_config.py. Point ``trained_model_path`` at a torch
``.pth`` (a ``best.pth`` of the train CLI, or a reference torch ResNet-152)
to evaluate it; the ImageNet root is ``$SIMPLEAICV_DATA_ROOT/ILSVRC2012``.

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.test_classification_model --work-dir <this dir>
"""

import os

import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification import backbones
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater, Opencv2PIL, TorchCenterCrop, TorchMeanStdNormalize,
    TorchResize, load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.ilsvrc2012dataset import (
    ILSVRC2012Dataset)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose

ILSVRC2012_path = os.path.join(
    os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"), "ILSVRC2012")


class config:
    network = "resnet152"
    num_classes = 1000
    input_image_size = 224
    scale = 256 / 224

    model = backbones.__dict__[network](**{
        "num_classes": num_classes,
        "dtype": torch.bfloat16,
    })

    # path to the torch weights to evaluate
    trained_model_path = ""
    load_state_dict(trained_model_path, model)

    test_dataset = ILSVRC2012Dataset(
        root_dir=ILSVRC2012_path,
        set_name="val",
        transform=Compose([
            Opencv2PIL(),
            TorchResize(resize=int(input_image_size * scale)),
            TorchCenterCrop(resize=input_image_size),
            TorchMeanStdNormalize(mean=[0.485, 0.456, 0.406],
                                  std=[0.229, 0.224, 0.225]),
        ]))
    test_collater = ClassificationCollater()

    seed = 0
    batch_size = 256
    num_workers = 20
