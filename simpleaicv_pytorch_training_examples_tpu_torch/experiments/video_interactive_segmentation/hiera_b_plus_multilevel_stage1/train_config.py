"""SAM2-B+ stage-1 video training (1 frame a clip), every mask output
supervised (SAM2MultiLevelLoss).

The port's counterpart of the JAX experiment
14.video_interactive_segmentation_training/14.1.sam2video_segmentation_training/hiera_b_plus_multilevel_stage1/train_config.py,
with the same values: gradient checkpointing, the high-res skips, Hiera
heads padded to 64, plain attention, SA-V clips of one frame with frame-0
point prompts, batch 64, AdamW lr 5e-5 (weight decay 1e-4 off the 1-D
parameters), a cosine schedule with one warm-up epoch to 1e-6, 20 epochs,
bf16 compute. Point ``trained_model_path`` at a SAM2 ``.pth`` in the
reference torch layout (or the port's own ``best.pth``) to start from it:
it loads through ``SAM2Video.load_pretrained`` (Hiera heads padded to 64) when
the file exists, else training starts from the seeded init. The dataset
roots are under ``$SIMPLEAICV_DATA_ROOT``
(``video_interactive_segmentation``, ``interactive_segmentation``).

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_video_interactive_segmentation_model --work-dir <this dir>
"""

import os

from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation import losses
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.datasets.sam2_video_segmentation_dataset import (
    SAM2VideoCollater, SAM2VideoSegmentationDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models import (
    sam2_hiera_base_plus_video)

data_root = os.environ.get("SIMPLEAICV_DATA_ROOT", "datasets")
video_interactive_segmentation_dataset_path = os.path.join(
    data_root, "video_interactive_segmentation")
interactive_segmentation_dataset_path = os.path.join(
    data_root, "interactive_segmentation")
experiments_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class config:
    network = "sam2_hiera_base_plus_video"
    input_image_size = 1024
    frame_nums = 1

    # use_scan is accepted and runs the frame loop (the JAX package's
    # scan and loop give the same numbers); the stage-1 model keeps the
    # later stages' parameter shapes (Hiera heads 64 wide)
    model = sam2_hiera_base_plus_video(image_size=input_image_size,
                                       use_gradient_checkpoint=True,
                                       use_high_res_features=True,
                                       use_scan=True,
                                       head_dim_padding=64)

    trained_model_path = ""
    load_state_dict(trained_model_path, model)

    train_criterion = losses.SAM2MultiLevelLoss()

    train_dataset = SAM2VideoSegmentationDataset(
        video_interactive_segmentation_dataset_path,
        set_name_list=["sa_v"],
        set_type="train",
        frame_nums=frame_nums)
    test_dataset = None
    train_collater = SAM2VideoCollater(resize=input_image_size,
                                       frame_nums=frame_nums)

    seed = 0
    batch_size = 64
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
