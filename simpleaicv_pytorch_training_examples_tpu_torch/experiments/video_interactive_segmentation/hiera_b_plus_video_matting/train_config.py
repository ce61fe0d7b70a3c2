"""SAM2-B+ video matting training.

The port's counterpart of the JAX experiment
14.video_interactive_segmentation_training/14.2.sam2video_matting_training/hiera_b_plus_video_matting/train_config.py,
with the same values: SAM2VideoMatting (SAM2-B+ at 1024^2, gradient
checkpointing, the attention kernels), SAM2MattingLoss, clips of 4 frames from the video_matting set, frame-0 points (SAM2VideoMattingCollater),
batch 8, AdamW lr 5e-5 (weight decay 1e-4 off the 1-D parameters), a
cosine schedule with one warm-up epoch to 1e-6, 20 epochs, bf16 compute.
Point ``trained_model_path`` at a checkpoint to start from it; the dataset
roots are under ``$SIMPLEAICV_DATA_ROOT`` (``video_interactive_segmentation``).

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_video_interactive_matting_model --work-dir <this dir>
"""

import os

from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.datasets.sam2_video_matting_dataset import (
    SAM2VideoMattingDataset, SAM2VideoMattingCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.losses_matting import (
    SAM2MattingLoss)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models import (
    sam2_hiera_base_plus_video_matting)

data_root = os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets")
video_interactive_segmentation_dataset_path = os.path.join(
    data_root, "video_interactive_segmentation")


class config:
    network = "sam2_hiera_base_plus_video_matting"
    input_image_size = 1024
    frame_nums = 4

    model = sam2_hiera_base_plus_video_matting(
        image_size=input_image_size, use_gradient_checkpoint=True,
        # hand-written attention kernels: K1 (or K2) in Hiera's windows, K6
        # in its global blocks and the memory attention
        use_flash_attention=True)

    trained_model_path = ""
    load_state_dict(trained_model_path, model)

    train_criterion = SAM2MattingLoss()

    train_dataset = SAM2VideoMattingDataset(
        video_interactive_segmentation_dataset_path,
        set_name_list=["video_matting"],
        set_type="train",
        frame_nums=frame_nums)
    test_dataset = None
    train_collater = SAM2VideoMattingCollater(resize=input_image_size,
                                              frame_nums=frame_nums)

    seed = 0
    batch_size = 8
    num_workers = 32
    accumulation_steps = 1

    optimizer = (
        "AdamW",
        {
            "lr": 5e-5,
            "global_weight_decay": False,
            "weight_decay": 1e-4,
            "no_weight_decay_layer_name_list": [],
        },
    )

    scheduler = (
        "CosineLR",
        {
            "warm_up_epochs": 1,
            "min_lr": 1e-6,
        },
    )

    epochs = 20
    print_interval = 50
    save_interval = 1

    use_amp = True
    use_ema_model = False
