"""SAM2-B+ stage-3 video training (16 frames a clip), every mask output
supervised (SAM2MultiLevelLoss).

The port's counterpart of the JAX experiment
14.video_interactive_segmentation_training/14.1.sam2video_segmentation_training/hiera_b_plus_multilevel_stage3/train_config.py,
with the same values: gradient checkpointing, the high-res skips, Hiera
heads padded to 64, the attention kernels, two condition slots, clips of 16
frames from SA-V, MOSE, DAVIS 2017 and YouTube-VOS 2019 with SA-1B images
mixed in, the condition-frame recipe with 2 point-iteration frames of 2
decoder passes, batch 4, AdamW lr 5e-5 (weight decay 1e-4 off the 1-D
parameters), a cosine schedule with one warm-up epoch to 1e-6, 20 epochs,
bf16 compute; it starts from the stage-2 run's ``best.pth``. Point
``trained_model_path`` at a SAM2 ``.pth`` in the reference torch layout (or
the port's own ``best.pth``) to start from it: it loads through
``SAM2Video.load_pretrained`` (Hiera heads padded to 64) when the file exists,
else training starts from the seeded init. The dataset roots are under
``$SIMPLEAICV_DATA_ROOT`` (``video_interactive_segmentation``,
``interactive_segmentation``).

Run from the repository root:
    python -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_video_interactive_segmentation_model --work-dir <this dir>
"""

import os

from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation import losses
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.datasets.sam2_video_segmentation_dataset import (
    SAM2VideoBatchCollater, SAM2VideoSegmentationDataset)
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
    frame_nums = 16

    # the attention kernels K1 (Hiera's windows) and K6 (Hiera's global
    # blocks and the memory attention), forward and backward; two memory
    # slots for condition frames
    model = sam2_hiera_base_plus_video(image_size=input_image_size,
                                       use_gradient_checkpoint=True,
                                       use_scan=True,
                                       use_high_res_features=True,
                                       use_flash_attention=True,
                                       head_dim_padding=64,
                                       memory_cond_slots=2)

    trained_model_path = os.path.join(
        experiments_dir, "hiera_b_plus_multilevel_stage2", "checkpoints", "best.pth")
    load_state_dict(trained_model_path, model)

    train_criterion = losses.SAM2MultiLevelLoss()

    # SA-V and the other video sets, with SA-1B images mixed in as static
    # clips
    train_dataset = SAM2VideoSegmentationDataset(
        video_root_dir=video_interactive_segmentation_dataset_path,
        video_set_name=["sa_v", "MOSE", "DAVIS2017", "YouTubeVOS2019"],
        video_set_type="train",
        image_root_dir=interactive_segmentation_dataset_path,
        image_set_name=["sa_000020"],
        image_set_type="train",
        image_per_set_image_choose_max_num={"sa_000020": 100000},
        per_video_choose_object_nums=2,
        frame_nums=frame_nums)
    test_dataset = None
    # condition frames (frame 0 and up to 1 random other), 2 point-
    # iteration frames refined by error clicks
    train_collater = SAM2VideoBatchCollater(
        resize=input_image_size, frame_nums=frame_nums, n_points=2,
        prompt_probs=(0.5, 0.25, 0.25), extra_cond_frames=1,
        point_iter_frame_num=2)
    decoder_point_iters = 2

    seed = 0
    batch_size = 4
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
