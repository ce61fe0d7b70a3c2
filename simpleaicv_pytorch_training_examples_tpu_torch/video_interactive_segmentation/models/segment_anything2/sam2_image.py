"""SAM2 single-image interactive segmentation, NCHW.

Counterpart of the JAX package's ``video_interactive_segmentation/models/
segment_anything2/sam2_image.py`` (``SAM2Image``, the model of the SAM2
image predict examples): SAM2's encoder (Hiera and its FPN, or DINOv3 with
``image_encoder_type``), SAM's prompt encoder and SAM2's mask decoder
(object-score token; with ``use_high_res_features`` the stride-4 and
stride-8 features skip into the upscaling), with SAM's split forward:
``forward_image_encoder`` once an image, ``forward_prompt_encoder_mask_
decoder`` once a prompt set. Mask logits are upsampled 4x to the input
size (bilinear, half-pixel centres, as ``jax.image.resize``).

As in JAX, ``use_flash_attention`` defaults to False (every attention
plain) and there is no ``head_dim_padding``: with ``use_flash_attention``
the windowed blocks take K2 at Hiera's d = 56 and the global blocks K6.
Parameters are fp32; run under ``torch.autocast`` for bf16 compute.
Returns (mask logits [B, 4, H, W] in fp32, IoU predictions [B, 4], object
score logits [B, 1]).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ....interactive_segmentation.models.segment_anything.prompt_encoder import (
    PromptEncoder)
from .image_encoder import MultiScaleAttention
from .sam2 import SAM2MaskDecoder, build_image_encoder, init_sam2_weights_

__all__ = ["SAM2Image", "sam2_hiera_tiny_image", "sam2_hiera_small_image",
           "sam2_hiera_base_plus_image", "sam2_hiera_large_image"]


class SAM2Image(nn.Module):
    def __init__(self, image_size=1024, embedding_planes=112, head_nums=2,
                 block_nums=(2, 3, 16, 3), window_specification=(8, 4, 14, 7),
                 global_attention_blocks=(12, 16, 20), fpn_planes=256,
                 sigmoid_out=False, binary_mask_out=False,
                 mask_threshold=0.0, use_high_res_features=False,
                 use_gradient_checkpoint=False, use_flash_attention=False,
                 image_encoder_type="hiera", dtype=None):
        super().__init__()
        self.image_size = image_size
        self.fpn_planes = fpn_planes
        self.sigmoid_out = sigmoid_out
        self.binary_mask_out = binary_mask_out
        self.mask_threshold = mask_threshold
        self.use_high_res_features = use_high_res_features
        self.image_encoder = build_image_encoder(
            image_encoder_type, image_size, embedding_planes, head_nums,
            block_nums, window_specification, global_attention_blocks,
            fpn_planes, use_flash_attention, 0, use_gradient_checkpoint)
        self.prompt_encoder = PromptEncoder(image_size, 16, fpn_planes)
        self.mask_decoder = SAM2MaskDecoder(
            fpn_planes, use_high_res_features=use_high_res_features)

    def set_flash_attention(self, on):
        """Route the encoder's attention through the kernels or the plain
        composition."""
        for m in self.modules():
            if isinstance(m, MultiScaleAttention):
                m.use_flash = on

    @torch.no_grad()
    def init_weights_(self, generator):
        """SAM2's seeded random weights (``init_sam2_weights_``)."""
        init_sam2_weights_(self, generator)

    def forward_image_encoder(self, batch_images):
        """-> feat16 [B, C, H/16, W/16], or (feat16, (feat_s4, feat_s8))
        with use_high_res_features."""
        features, _ = self.image_encoder(batch_images)
        if self.use_high_res_features:
            return features[-1], (features[0], features[1])
        return features[-1]

    def forward_prompt_encoder_mask_decoder(self, batch_image_embeddings,
                                            batch_prompts,
                                            high_res_features=None):
        sparse, dense = self.prompt_encoder(
            batch_prompts.get("prompt_point"),
            batch_prompts.get("prompt_box"),
            batch_prompts.get("prompt_mask"),
            boxes_valid=batch_prompts.get("prompt_box_valid"),
            masks_valid=batch_prompts.get("prompt_mask_valid"))
        mask_preds, iou_preds, _, obj_logits = self.mask_decoder(
            batch_image_embeddings, self.prompt_encoder.get_dense_pe_layer(),
            sparse, dense, high_res_features=high_res_features)
        mask_preds = F.interpolate(mask_preds.float(),
                                   (self.image_size, self.image_size),
                                   mode="bilinear", align_corners=False)
        if self.sigmoid_out:
            mask_preds = torch.sigmoid(mask_preds)
        if self.binary_mask_out:
            mask_preds = (mask_preds > self.mask_threshold).to(
                mask_preds.dtype)
        return mask_preds, iou_preds, obj_logits

    def forward(self, batch_images, batch_prompts):
        out = self.forward_image_encoder(batch_images)
        if self.use_high_res_features:
            embeddings, highres = out
            return self.forward_prompt_encoder_mask_decoder(
                embeddings, batch_prompts, high_res_features=highres)
        return self.forward_prompt_encoder_mask_decoder(out, batch_prompts)


_SIZES = {
    "tiny": dict(embedding_planes=96, head_nums=1, block_nums=(1, 2, 7, 2),
                 global_attention_blocks=(5, 7, 9)),
    "small": dict(embedding_planes=96, head_nums=1,
                  block_nums=(1, 2, 11, 2),
                  global_attention_blocks=(7, 10, 13)),
    "base_plus": dict(embedding_planes=112, head_nums=2,
                      block_nums=(2, 3, 16, 3),
                      global_attention_blocks=(12, 16, 20)),
    "large": dict(embedding_planes=144, head_nums=2,
                  block_nums=(2, 6, 36, 4),
                  window_specification=(8, 4, 16, 8),
                  global_attention_blocks=(23, 33, 43)),
}


def sam2_hiera_tiny_image(**kw):
    return SAM2Image(**{**_SIZES["tiny"], **kw})


def sam2_hiera_small_image(**kw):
    return SAM2Image(**{**_SIZES["small"], **kw})


def sam2_hiera_base_plus_image(**kw):
    return SAM2Image(**{**_SIZES["base_plus"], **kw})


def sam2_hiera_large_image(**kw):
    return SAM2Image(**{**_SIZES["large"], **kw})
