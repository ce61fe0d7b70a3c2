"""Multi-node SAM encoder distillation entry point, shared-NAS log variant.

Port of the JAX package's ``tools/train_interactive_segmentation_distill_encoder_model_multi_node_nas.py``: ``train_interactive_segmentation_distill_encoder_model``'s ``main``,
launched on every node by torchrun, which sets the rendezvous (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
that ``parallel/mesh.distributed_init`` joins (NCCL on
``cuda:LOCAL_RANK``)::

    torchrun --nnodes=2 --node_rank=<0|1> --nproc_per_node=8 \\
        --master_addr=<node 0> --master_port=<port> \\
        -m simpleaicv_pytorch_training_examples_tpu_torch.tools.train_interactive_segmentation_distill_encoder_model_multi_node_nas \\
        --work-dir <exp_dir>

The reference's NAS variant gates its log on global rank 0, because the
work dir lives on a shared network filesystem where every node's log
would interleave; the runner gates on global rank 0 already
(``is_main_process``), so this entry is the multi-node one under its
reference name.
"""

from .train_interactive_segmentation_distill_encoder_model import main

if __name__ == "__main__":
    main()
