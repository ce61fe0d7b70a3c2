"""Multi-node SAM2 (Hiera) encoder distillation entry point.

Port of the JAX package's ``tools/train_video_interactive_segmentation_distill_encoder_model_multi_node.py``: ``train_video_interactive_segmentation_distill_encoder_model``'s ``main``,
launched on every node by torchrun, which sets the rendezvous (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
that ``parallel/mesh.distributed_init`` joins (NCCL on
``cuda:LOCAL_RANK``)::

    torchrun --nnodes=2 --node_rank=<0|1> --nproc_per_node=8 \\
        --master_addr=<node 0> --master_port=<port> \\
        -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_video_interactive_segmentation_distill_encoder_model_multi_node \\
        --work-dir <exp_dir>

Logs and checkpoints come from global rank 0 alone (the runner's
``is_main_process``), which is also what the reference's per-node
rank-0 gating gives on a work dir that each node keeps for itself.
"""

from .train_video_interactive_segmentation_distill_encoder_model import main

if __name__ == "__main__":
    main()
