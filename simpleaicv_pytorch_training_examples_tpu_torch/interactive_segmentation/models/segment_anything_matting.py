"""SAM interactive matting, NCHW.

Counterpart of the JAX package's ``interactive_segmentation/models/
segment_anything_matting.py``: SAM's mask decoder also returns its
transformer's 1/16 features (``feat3``) and its upscaled 1/4 features
(``feat1``), and a matting head turns (the best mask's logits, feat3,
feat1) into a global 3-channel trimap and a local alpha, through two
decoders of 3x3 / 1x1 ConvBnActs and two 2x2 / 2 transposed convolutions
each, fused as PFAN's ``collaborative_matting``.

``SAMMatting(images [B, 3, H, W], prompts)`` -> (global [B, 3, H, W],
local [B, 1, H, W], fused [B, 1, H, W], IoU predictions [B, T]). Two
reference-side behaviours are copied from the JAX model: its decoder's
GELUs are Flax's default tanh approximation (SAM's own decoder uses the
exact one), and its ``MattingHead`` is called without ``train``, so the
head's BatchNorms normalise by their running statistics (0 and 1, never
moved) in training too: ``MattingHead`` stays in eval mode. The ViT
encoder takes no ``use_flash_attention``: its attention is the plain one,
as in JAX. Module names: SAM's (``image_encoder``, ``prompt_encoder``,
``mask_decoder`` in the reference torch layout) and the JAX head's
(``matting_head.{global,local}_{combine,reduce,up1,up2,up3}``,
``global_feat{1,3}_reduce``, ``{global,local}_pred_conv``).
"""

import torch
import torch.nn.functional as F
from torch import nn

from ...models.common import ConvBnAct
from ...models.pfan import (ConvTransposeBnAct, PredConv,
                            collaborative_matting, resize_bilinear)
from .segment_anything.mask_decoder import MaskDecoder
from .segment_anything.prompt_encoder import PromptEncoder
from .segment_anything.sam import build_image_encoder, init_sam_weights_

__all__ = ["MaskDecoderMatting", "MattingHead", "SAMMatting",
           "sam_b_matting", "sam_l_matting", "sam_h_matting",
           "matting_upscale"]


def matting_upscale(up, src, b, c, h, w):
    """The decoder's 4x upscaling with tanh GELUs: transformer tokens [B,
    hw, C] -> (feat3 [B, C, h, w], feat1 [B, C/8, 4h, 4w])."""
    feat3 = src.transpose(1, 2).reshape(b, c, h, w)
    x = F.gelu(up[1](up[0](feat3)), approximate="tanh")
    return feat3, F.gelu(up[3](x), approximate="tanh")


class MaskDecoderMatting(MaskDecoder):
    """SAM's decoder that also returns feat3 and feat1 (its IoU head's
    hidden width is the embedding's, as in the JAX matting decoder)."""

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, mask_out_idxs=(0, 1, 2, 3)):
        b = sparse_prompt_embeddings.shape[0]
        output_tokens = torch.cat([self.iou_token.weight,
                                   self.mask_tokens.weight], dim=0)
        tokens = torch.cat([output_tokens[None].expand(b, -1, -1),
                            sparse_prompt_embeddings.to(output_tokens.dtype)],
                           dim=1)
        src = image_embeddings
        if src.shape[0] != b:
            src = torch.repeat_interleave(src, b, dim=0)
        src = src + dense_prompt_embeddings.to(src.dtype)
        hs, src = self.transformer(src, image_pe, tokens)
        iou_token_out = hs[:, 0]
        mask_tokens_out = hs[:, 1:1 + self.num_mask_tokens]
        _, c, h, w = image_embeddings.shape
        feat3, feat1 = matting_upscale(self.output_upscaling, src, b, c, h, w)
        hyper_in = torch.stack([mlp(mask_tokens_out[:, i]) for i, mlp in
                                enumerate(self.output_hypernetworks_mlps)],
                               dim=1)
        mask_preds = torch.einsum("btc,bchw->bthw", hyper_in,
                                  feat1.to(hyper_in.dtype))
        iou_preds = self.iou_prediction_head(iou_token_out)
        idxs = list(mask_out_idxs)
        return mask_preds[:, idxs], iou_preds[:, idxs], feat3, feat1


class MattingHead(nn.Module):
    """(best mask logits [B, 1, h4, w4], feat3 [B, C, h16, w16], feat1 [B,
    C/8, h4, w4]) -> (global [B, 3, H, W], local [B, 1, H, W], fused [B, 1,
    H, W]) at 4x feat1's size. Always in eval mode (see the module
    docstring)."""

    def __init__(self, inplanes=256, cpfe_planes=32):
        super().__init__()
        p = cpfe_planes
        self.global_feat3_reduce = ConvBnAct(inplanes, p, 1, 1, 0)
        self.global_feat1_reduce = ConvBnAct(inplanes // 8, p, 1, 1, 0)
        for prefix in ("global", "local"):
            setattr(self, f"{prefix}_combine",
                    ConvBnAct(2 * p + 1, p, 3, 1, 1))
            setattr(self, f"{prefix}_reduce", ConvBnAct(p, p, 1, 1, 0))
            setattr(self, f"{prefix}_up1", ConvTransposeBnAct(p, p))
            setattr(self, f"{prefix}_up2", ConvBnAct(p, p, 3, 1, 1))
            setattr(self, f"{prefix}_up3", ConvTransposeBnAct(p, p))
        self.global_pred_conv = PredConv(p, 3)
        self.local_pred_conv = PredConv(p, 1)
        super().train(False)

    def train(self, mode=True):
        return super().train(False)

    def _decoder(self, prefix, x):
        for part in ("combine", "reduce", "up1", "up2", "up3"):
            x = getattr(self, f"{prefix}_{part}")(x)
        return x

    def forward(self, masks, feat3, feat1):
        f3 = resize_bilinear(self.global_feat3_reduce(feat3),
                             feat1.shape[-2:])
        f1 = self.global_feat1_reduce(feat1)
        x = torch.cat([f1, f3.to(f1.dtype), masks.to(f1.dtype)], dim=1)
        global_pred = torch.sigmoid(self.global_pred_conv(
            self._decoder("global", x)))
        local_pred = torch.sigmoid(self.local_pred_conv(
            self._decoder("local", x)))
        return (global_pred, local_pred,
                collaborative_matting(global_pred, local_pred))


class SAMMatting(nn.Module):
    def __init__(self, image_size=1024, patch_size=16,
                 image_encoder_embedding_planes=768,
                 image_encoder_block_nums=12, image_encoder_head_nums=12,
                 image_encoder_global_attn_indexes=(2, 5, 8, 11),
                 prompt_encoder_embedding_planes=256,
                 use_gradient_checkpoint=False, image_encoder_type="sam_vit"):
        super().__init__()
        self.image_size = image_size
        self.image_encoder = build_image_encoder(
            image_encoder_type, image_size, patch_size,
            image_encoder_embedding_planes, image_encoder_block_nums,
            image_encoder_head_nums, image_encoder_global_attn_indexes,
            prompt_encoder_embedding_planes, use_gradient_checkpoint)
        self.prompt_encoder = PromptEncoder(
            image_size=image_size, patch_size=patch_size,
            embedding_planes=prompt_encoder_embedding_planes)
        self.mask_decoder = MaskDecoderMatting(
            inplanes=prompt_encoder_embedding_planes, num_multimask_outputs=3,
            iou_prediction_head_hidden_planes=prompt_encoder_embedding_planes)
        self.matting_head = MattingHead(prompt_encoder_embedding_planes)

    @torch.no_grad()
    def init_weights_(self, generator):
        """SAM's seeded random weights (``init_sam_weights_``)."""
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
        mask_preds, iou_preds, feat3, feat1 = self.mask_decoder(
            batch_image_embeddings, image_pe, sparse, dense, mask_out_idxs)
        b = mask_preds.shape[0]
        rows = torch.arange(b, device=mask_preds.device)
        best_mask = mask_preds[rows, iou_preds.argmax(dim=-1)][:, None]
        size = (self.image_size, self.image_size)
        g, l, f = (resize_bilinear(p, size) for p in self.matting_head(
            best_mask, feat3, feat1))
        return g, l, f, iou_preds

    def forward(self, batch_images, batch_prompts,
                mask_out_idxs=(0, 1, 2, 3)):
        embeddings = self.forward_image_encoder(batch_images)
        return self.forward_prompt_encoder_mask_decoder(
            embeddings, batch_prompts, mask_out_idxs)


def _sam_matting(planes, block_nums, head_nums, global_attn_indexes,
                 **kwargs):
    return SAMMatting(**{"image_encoder_embedding_planes": planes,
                         "image_encoder_block_nums": block_nums,
                         "image_encoder_head_nums": head_nums,
                         "image_encoder_global_attn_indexes":
                             global_attn_indexes, **kwargs})


def sam_b_matting(**kwargs):
    return _sam_matting(768, 12, 12, (2, 5, 8, 11), **kwargs)


def sam_l_matting(**kwargs):
    return _sam_matting(1024, 24, 16, (5, 11, 17, 23), **kwargs)


def sam_h_matting(**kwargs):
    return _sam_matting(1280, 32, 16, (7, 15, 23, 31), **kwargs)
