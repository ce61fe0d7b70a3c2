"""darknet19 on ImageNet-1K.

The port's counterpart of the JAX experiment
00.classification_training/imagenet/darknet19/train_config.py, with the
same values (SGD 0.1, MultiStep [30,60,90], 100ep, bs256, input 256).
The layers compute in bf16 over fp32 parameters (BatchNorm's statistics
and the head in fp32); the JAX config leaves its model's dtype at float32
and rounds only the input to bf16. The ImageNet root is
``$SIMPLEAICV_DATA_ROOT/ILSVRC2012``.

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_classification_model --work-dir <this dir>
"""

import os

import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification import backbones
from simpleaicv_pytorch_training_examples_tpu_torch.classification import losses
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.ilsvrc2012dataset import ILSVRC2012Dataset
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    Opencv2PIL, TorchRandomResizedCrop, TorchRandomHorizontalFlip,
    TorchResize, TorchCenterCrop, TorchMeanStdNormalize,
    ClassificationCollater, load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose

ILSVRC2012_path = os.path.join(
    os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"), "ILSVRC2012")


class config:
    network = "darknet19"
    num_classes = 1000
    input_image_size = 256
    scale = 256 / 224

    model = backbones.__dict__[network](**{
        "num_classes": num_classes,
        # mixed precision: fp32 parameters, bf16 layer compute
        "dtype": torch.bfloat16,
    })

    trained_model_path = ""
    load_state_dict(trained_model_path, model)

    train_criterion = losses.__dict__["CELoss"]()
    test_criterion = losses.__dict__["CELoss"]()

    train_dataset = ILSVRC2012Dataset(
        root_dir=ILSVRC2012_path,
        set_name="train",
        transform=Compose([
            Opencv2PIL(),
            TorchRandomResizedCrop(resize=input_image_size),
            TorchRandomHorizontalFlip(prob=0.5),
            TorchMeanStdNormalize(mean=[0.485, 0.456, 0.406],
                                  std=[0.229, 0.224, 0.225]),
        ]))
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
    train_collater = ClassificationCollater()
    test_collater = ClassificationCollater()

    seed = 0
    batch_size = 256
    num_workers = 30
    accumulation_steps = 1

    optimizer = (
        "SGD",
        {
            "lr": 0.1,
            "momentum": 0.9,
            "global_weight_decay": False,
            "weight_decay": 1e-4,
            "no_weight_decay_layer_name_list": [],
        },
    )

    scheduler = (
        "MultiStepLR",
        {
            "warm_up_epochs": 0,
            "gamma": 0.1,
            "milestones": [30, 60, 90],
        },
    )

    epochs = 100
    print_interval = 100

    use_amp = True
    use_ema_model = False
    ema_model_decay = 0.9999
