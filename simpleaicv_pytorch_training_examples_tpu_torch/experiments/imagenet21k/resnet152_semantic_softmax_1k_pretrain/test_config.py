"""ResNet-152 ImageNet-21K eval: flat top-1 / top-5 over the 10,450 classes.

The port's counterpart of the JAX experiment
00.classification_training/imagenet21k/resnet152_semantic_softmax_1k_pretrain
(test_config.py over its train_config.py): the same model settings and val
transforms as this directory's train_config.py. Point
``trained_model_path`` at a torch ``.pth`` to evaluate it; the data root
is ``$SIMPLEAICV_DATA_ROOT/ImageNet21K``.

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.test_imagenet21k_classification_model --work-dir <this dir>
"""

import os

import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification import backbones
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater, Opencv2PIL, TorchCenterCrop, TorchMeanStdNormalize,
    TorchResize, load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.imagenet21kdataset import (
    ImageNet21KSemanticTreeLabelDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.data import Compose

ImageNet21K_path = os.path.join(
    os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets"), "ImageNet21K")


class config:
    network = "resnet152"
    num_classes = 10450
    input_image_size = 224
    scale = 256 / 224

    model = backbones.__dict__[network](**{
        "num_classes": num_classes,
        "dtype": torch.bfloat16,
    })

    # path to the torch weights to evaluate
    trained_model_path = ""
    load_state_dict(trained_model_path, model)

    test_dataset = ImageNet21KSemanticTreeLabelDataset(
        root_dir=ImageNet21K_path, set_name="val",
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
    num_workers = 16
