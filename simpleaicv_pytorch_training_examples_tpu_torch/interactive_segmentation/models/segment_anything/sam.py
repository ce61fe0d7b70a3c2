"""SAM: ViT image encoder, prompt encoder and mask decoder, with the split
forward of interactive use: ``forward_image_encoder`` once per image,
``forward_prompt_encoder_mask_decoder`` once per prompt set. Mask logits
are upsampled 4x back to the input size.

Counterpart of the JAX package's
``interactive_segmentation/models/segment_anything/sam.py``. Images are
NCHW in [0, 1]; the image embedding is [B, 256, H/16, W/16]; prompts are
the JAX package's fixed-shape dict (``prompt_point`` [B, N, 3],
``prompt_box`` [B, 4], ``prompt_box_valid`` [B], ``prompt_mask`` [B, 1,
H/4, W/4], ``prompt_mask_valid`` [B]). The bilinear upsampling equals
``jax.image.resize(..., "bilinear")``: half-pixel centres, and at the
border both take the edge value.

Parameters are fp32; run under ``torch.autocast`` for bf16 compute.
``use_gradient_checkpoint`` recomputes each encoder block in the backward
(see ``image_encoder.py``). ``image_encoder_type`` "sam_vit" is SAM's ViT;
a DINOv3 backbone's name (``dinov3_vit_base_patch16_backbone`` ...) puts
``dinov3_segment_anything.DINOv3SAMImageEncoder`` in its place, whose
attention stays plain (N = 4096 tokens at 1024^2).
``init_weights_`` draws seeded random weights with the initialisers the
reference torch SAM gets from PyTorch, except that the position embedding
and the rel-pos tables, zero there, get small random values, so that a
smoke run exercises them.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ....models.common import trunc_normal_
from .image_encoder import LayerNorm2d, SAMAttention, ViTImageEncoder
from .mask_decoder import MaskDecoder
from .prompt_encoder import PromptEncoder

__all__ = ["SAM", "sam_b", "sam_l", "sam_h", "build_image_encoder",
           "init_sam_weights_"]


class SAM(nn.Module):
    def __init__(self, image_size=1024, patch_size=16,
                 image_encoder_embedding_planes=768,
                 image_encoder_block_nums=12, image_encoder_head_nums=12,
                 image_encoder_global_attn_indexes=(2, 5, 8, 11),
                 prompt_encoder_embedding_planes=256, sigmoid_out=False,
                 binary_mask_out=False, mask_threshold=0.0,
                 use_gradient_checkpoint=False, remat_policy=None,
                 use_flash_attention=False, image_encoder_type="sam_vit"):
        super().__init__()
        self.image_size = image_size
        self.sigmoid_out = sigmoid_out
        self.binary_mask_out = binary_mask_out
        self.mask_threshold = mask_threshold
        self.image_encoder = build_image_encoder(
            image_encoder_type, image_size, patch_size,
            image_encoder_embedding_planes, image_encoder_block_nums,
            image_encoder_head_nums, image_encoder_global_attn_indexes,
            prompt_encoder_embedding_planes, use_gradient_checkpoint,
            remat_policy, use_flash_attention)
        self.prompt_encoder = PromptEncoder(
            image_size=image_size, patch_size=patch_size,
            embedding_planes=prompt_encoder_embedding_planes)
        self.mask_decoder = MaskDecoder(
            inplanes=prompt_encoder_embedding_planes, num_multimask_outputs=3)

    def set_flash_attention(self, on):
        """Route the encoder's attention through the kernels or the plain
        composition."""
        for m in self.modules():
            if isinstance(m, SAMAttention):
                m.use_flash = on

    @torch.no_grad()
    def init_weights_(self, generator):
        """Seeded random weights, drawn from ``generator``: PyTorch's default
        initialisers for Linear and convolution weights and biases
        (uniform in +-1/sqrt(fan_in)), unit norms, N(0, 1) embeddings and
        tokens, and N(0, 0.02^2) (truncated) position embedding and rel-pos
        tables."""
        init_sam_weights_(self, generator)

    def forward_image_encoder(self, batch_images):
        return self.image_encoder(batch_images)

    def forward_prompt_encoder_mask_decoder(self, batch_image_embeddings,
                                            batch_prompts,
                                            mask_out_idxs=(0, 1, 2, 3)):
        sparse, dense = self.prompt_encoder(
            batch_prompts.get("prompt_point"),
            batch_prompts.get("prompt_box"),
            batch_prompts.get("prompt_mask"),
            boxes_valid=batch_prompts.get("prompt_box_valid"),
            masks_valid=batch_prompts.get("prompt_mask_valid"))
        image_pe = self.prompt_encoder.get_dense_pe_layer()
        mask_preds, iou_preds = self.mask_decoder(
            batch_image_embeddings, image_pe, sparse, dense, mask_out_idxs)
        mask_preds = F.interpolate(mask_preds.float(),
                                   (self.image_size, self.image_size),
                                   mode="bilinear", align_corners=False)
        if self.sigmoid_out:
            mask_preds = torch.sigmoid(mask_preds)
        if self.binary_mask_out:
            mask_preds = (mask_preds > self.mask_threshold).to(
                mask_preds.dtype)
        return mask_preds, iou_preds

    def forward(self, batch_images, batch_prompts,
                mask_out_idxs=(0, 1, 2, 3)):
        embeddings = self.forward_image_encoder(batch_images)
        return self.forward_prompt_encoder_mask_decoder(
            embeddings, batch_prompts, mask_out_idxs)


def build_image_encoder(image_encoder_type, image_size, patch_size, planes,
                        block_nums, head_nums, global_attn_indexes,
                        out_planes, use_gradient_checkpoint=False,
                        remat_policy=None, use_flash_attention=False):
    """SAM's ViT encoder ("sam_vit"), or the DINOv3 encoder of that
    backbone name."""
    if image_encoder_type != "sam_vit":
        from ..dinov3_segment_anything import DINOv3SAMImageEncoder
        return DINOv3SAMImageEncoder(
            image_encoder_type, out_planes,
            use_gradient_checkpoint=use_gradient_checkpoint)
    return ViTImageEncoder(
        image_size=image_size, patch_size=patch_size,
        embedding_planes=planes, block_nums=block_nums, head_nums=head_nums,
        out_planes=out_planes, window_size=14,
        global_attn_indexes=tuple(global_attn_indexes),
        use_gradient_checkpoint=use_gradient_checkpoint,
        remat_policy=remat_policy, use_flash_attention=use_flash_attention)


@torch.no_grad()
def init_sam_weights_(model, generator):
    """``SAM.init_weights_`` for any model of SAM's parts (SAM matting
    too): PyTorch's default initialisers for Linear and convolution layers,
    unit norms, N(0, 1) embeddings, N(0, 0.02^2) (truncated) position
    embedding and rel-pos tables. Modules with an ``init_weights_`` of
    their own (a DINOv3 encoder's, BatchNorm's) set theirs after this."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in, _ = nn.init._calculate_fan_in_and_fan_out(module.weight)
            bound = 1.0 / math.sqrt(fan_in)
            module.weight.uniform_(-bound, bound, generator=generator)
            if module.bias is not None:
                module.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(module, (nn.LayerNorm, LayerNorm2d)):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(module, SAMAttention):
            trunc_normal_(module.rel_pos_h, 0.02, generator)
            trunc_normal_(module.rel_pos_w, 0.02, generator)
    pos_embed = getattr(model.image_encoder, "pos_embed", None)
    if pos_embed is not None:
        trunc_normal_(pos_embed, 0.02, generator)


def _sam(planes, block_nums, head_nums, global_attn_indexes, **kwargs):
    """The published size's encoder; keyword arguments override any setting
    (a smoke run cuts the depth with image_encoder_block_nums and
    image_encoder_global_attn_indexes)."""
    return SAM(**{"image_encoder_embedding_planes": planes,
                  "image_encoder_block_nums": block_nums,
                  "image_encoder_head_nums": head_nums,
                  "image_encoder_global_attn_indexes": global_attn_indexes,
                  **kwargs})


def sam_b(**kwargs):
    return _sam(768, 12, 12, (2, 5, 8, 11), **kwargs)


def sam_l(**kwargs):
    return _sam(1024, 24, 16, (5, 11, 17, 23), **kwargs)


def sam_h(**kwargs):
    return _sam(1280, 32, 16, (7, 15, 23, 31), **kwargs)
