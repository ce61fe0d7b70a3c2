"""ResNet-34 (CIFAR stem) on CIFAR-100 from scratch.

The port's counterpart of the JAX experiment
00.classification_training/cifar100/resnet34cifar/train_config.py, with the
same values: reflect pad 4, flip, random 32x32 crop, SGD lr 0.1, momentum
0.9, weight decay 5e-4, MultiStepLR (gamma 0.2 at epochs 60, 120, 160), 200
epochs, batch 128, 16 loader workers. The layers compute in bf16 over fp32
parameters (the JAX config leaves its model's dtype at float32 and rounds
only the input to bf16). The data root is
``$SIMPLEAICV_DATA_ROOT/CIFAR100`` (``cifar-100-python/{train,test}``).

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_classification_model --work-dir <this dir>
"""

import os

import numpy as np
import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification import backbones
from simpleaicv_pytorch_training_examples_tpu_torch.classification import losses
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater, Opencv2PIL, TorchMeanStdNormalize, TorchPad,
    TorchRandomCrop, TorchRandomHorizontalFlip, load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.cifar100dataset import (
    CIFAR100Dataset)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose

CIFAR100_path = os.path.join(
    os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"), "CIFAR100")


class config:
    network = "resnet34cifar"
    num_classes = 100
    input_image_size = 32

    model = backbones.__dict__[network](**{
        "num_classes": num_classes,
        "dtype": torch.bfloat16,
    })

    trained_model_path = ""
    load_state_dict(trained_model_path, model)

    train_criterion = losses.__dict__["CELoss"]()
    test_criterion = losses.__dict__["CELoss"]()

    train_dataset = CIFAR100Dataset(
        root_dir=CIFAR100_path,
        set_name="train",
        transform=Compose([
            Opencv2PIL(),
            TorchPad(padding=4, fill=0, padding_mode="reflect"),
            TorchRandomHorizontalFlip(prob=0.5),
            TorchRandomCrop(resize=input_image_size),
            TorchMeanStdNormalize(mean=np.array([125.3, 123.0, 113.9]) / 255.0,
                                  std=np.array([63.0, 62.1, 66.7]) / 255.0),
        ]))
    test_dataset = CIFAR100Dataset(
        root_dir=CIFAR100_path,
        set_name="test",
        transform=Compose([
            Opencv2PIL(),
            TorchMeanStdNormalize(mean=np.array([125.3, 123.0, 113.9]) / 255.0,
                                  std=np.array([63.0, 62.1, 66.7]) / 255.0),
        ]))
    train_collater = ClassificationCollater()
    test_collater = ClassificationCollater()

    seed = 0
    batch_size = 128
    num_workers = 16
    accumulation_steps = 1

    optimizer = (
        "SGD",
        {
            "lr": 0.1,
            "momentum": 0.9,
            "global_weight_decay": False,
            "weight_decay": 5e-4,
            "no_weight_decay_layer_name_list": [],
        },
    )

    scheduler = (
        "MultiStepLR",
        {
            "warm_up_epochs": 0,
            "gamma": 0.2,
            "milestones": [60, 120, 160],
        },
    )

    epochs = 200
    print_interval = 50

    use_amp = True
    use_ema_model = False
    ema_model_decay = 0.9999
