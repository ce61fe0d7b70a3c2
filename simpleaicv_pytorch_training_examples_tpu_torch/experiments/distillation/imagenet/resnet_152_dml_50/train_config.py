"""ResNet-152 -> ResNet-50 deep mutual learning on ImageNet-1K, joint
teacher.

The port's counterpart of the JAX experiment
01.distillation_training/imagenet/resnet_152_dml_50/train_config.py, with the
same values: ``CELoss`` on the student and on the teacher plus ``DMLLoss`` at
T = 1, each weighted 1, the teacher trained with the student, random
resized crop and flip, SGD lr 0.1, momentum 0.9, weight decay 1e-4,
MultiStepLR (gamma 0.1 at epochs 30, 60, 90), 100 epochs, batch 256, 16
loader workers. Both networks compute in bf16 over fp32 parameters (the JAX
config leaves its models' dtype at float32 and rounds only the input to
bf16). Point ``trained_model_path`` at a torch ``.pth`` of the whole model
(``teacher.``/``student.`` names) to start from it; the ImageNet root is
``$SIMPLEAICV_DATA_ROOT/ILSVRC2012``.

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_distill_classification_model --work-dir <this dir>
"""

import os

import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater, Opencv2PIL, TorchCenterCrop, TorchMeanStdNormalize,
    TorchRandomHorizontalFlip, TorchRandomResizedCrop, TorchResize,
    load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.ilsvrc2012dataset import (
    ILSVRC2012Dataset)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose
from simpleaicv_pytorch_training_examples_tpu_torch.distillation import losses
from simpleaicv_pytorch_training_examples_tpu_torch.distillation.distillmodel import (
    KDModel)

ILSVRC2012_path = os.path.join(
    os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"), "ILSVRC2012")


class config:
    input_image_size = 224
    scale = 256 / 224

    teacher = "resnet152"
    student = "resnet50"
    teacher_pretrained_model_path = ""
    student_pretrained_model_path = ""
    freeze_teacher = False
    num_classes = 1000

    model = KDModel(teacher_type=teacher, student_type=student,
                    teacher_pretrained_path=teacher_pretrained_model_path,
                    student_pretrained_path=student_pretrained_model_path,
                    freeze_teacher=freeze_teacher,
                    num_classes=num_classes,
                    # mixed precision: fp32 parameters, bf16 layer compute
                    dtype=torch.bfloat16)

    trained_model_path = ""
    load_state_dict(trained_model_path, model)

    loss_list = ["CELoss", "DMLLoss"]
    loss_ratio = {"CELoss": 1.0, "DMLLoss": 1.0}
    T = 1.0
    train_criterion = {}
    for loss_name in loss_list:
        if loss_name in ("KDLoss", "DMLLoss"):
            train_criterion[loss_name] = losses.__dict__[loss_name](T)
        else:
            train_criterion[loss_name] = losses.__dict__[loss_name]()
    test_criterion = losses.CELoss()

    train_dataset = ILSVRC2012Dataset(
        root_dir=ILSVRC2012_path, set_name="train",
        transform=Compose([
            Opencv2PIL(),
            TorchRandomResizedCrop(resize=input_image_size),
            TorchRandomHorizontalFlip(prob=0.5),
            TorchMeanStdNormalize(mean=[0.485, 0.456, 0.406],
                                  std=[0.229, 0.224, 0.225]),
        ]))
    test_dataset = ILSVRC2012Dataset(
        root_dir=ILSVRC2012_path, set_name="val",
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
    num_workers = 16
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
