"""SAM2 matting models, image and memory-conditioned video, NCHW.

Counterpart of the JAX package's ``video_interactive_segmentation/models/
segment_anything2_matting.py``: SAM2's encoder (Hiera, or DINOv3 with
``image_encoder_type``), SAM's prompt encoder, SAM2's mask decoder that
also returns its 1/16 and 1/4 features (``SAM2MaskDecoderMatting``, tanh
GELUs as in JAX), and SAM matting's ``MattingHead`` (always in eval mode,
as the JAX model calls it without ``train``), fed the best mask's logits.

- ``SAM2ImageMatting(images [B, 3, H, W], prompts)`` -> (global [B, 3, H,
  W], local [B, 1, H, W], fused [B, 1, H, W], IoU predictions [B, 4]).
- ``SAM2VideoMatting(images [B, T, 3, H, W], prompts, is_cond_frame)`` ->
  the same with a T axis, and object score logits [B, T, 1]. It is
  ``SAM2Video``'s tracking loop (a Python loop over the frames, one encoder
  call on the B x T frames, the memory ring of condition and tracked slots
  with ``memory_cond_slots``, the object pointers, K6 in the memory
  attention with ``use_flash_attention``) with the matting triple decoded
  on every frame and the memory encoded from the fused alpha. As in JAX the
  fused alpha, already in [0, 1], goes through the memory encoder's sigmoid
  (a second one). Prompts are frame 0's alone (``prompt_point`` [B, P, 3])
  or per frame ([B, T, ...], the condition-frame recipe); ``is_cond_frame``
  [T] is a host value, as ``SAM2Video`` takes it. It has no mask-prompt
  downsample and no no-memory embedding (the JAX model has neither).

Eight factories: ``sam2_hiera_{tiny,small,base_plus,large}_{image,video}
_matting``.
"""

import torch
from torch import nn

from ...interactive_segmentation.models.segment_anything.prompt_encoder import (
    PromptEncoder)
from ...interactive_segmentation.models.segment_anything_matting import (
    MattingHead, matting_upscale)
from ...models.pfan import resize_bilinear
from .segment_anything2.image_encoder import MultiScaleAttention
from .segment_anything2.memory import RoPEAttention
from .segment_anything2.sam2 import (SAM2MaskDecoder, SAM2Video, _host_flags,
                                     build_image_encoder, init_sam2_weights_)

__all__ = [
    "SAM2MaskDecoderMatting", "SAM2ImageMatting", "SAM2VideoMatting",
    "sam2_hiera_tiny_image_matting", "sam2_hiera_small_image_matting",
    "sam2_hiera_base_plus_image_matting", "sam2_hiera_large_image_matting",
    "sam2_hiera_tiny_video_matting", "sam2_hiera_small_video_matting",
    "sam2_hiera_base_plus_video_matting", "sam2_hiera_large_video_matting",
]


class SAM2MaskDecoderMatting(SAM2MaskDecoder):
    """SAM2's decoder (no high-res skips) that also returns feat3 [B, C, h,
    w] and feat1 [B, C/8, 4h, 4w]."""

    def __init__(self, inplanes=256, num_multimask_outputs=3):
        super().__init__(inplanes, num_multimask_outputs)

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings):
        b, c, h, w = image_embeddings.shape
        output_tokens = torch.cat([self.obj_score_token.weight,
                                   self.iou_token.weight,
                                   self.mask_tokens.weight], dim=0)
        tokens = torch.cat([output_tokens[None].expand(b, -1, -1),
                            sparse_prompt_embeddings.to(output_tokens.dtype)],
                           dim=1)
        src = image_embeddings + dense_prompt_embeddings.to(
            image_embeddings.dtype)
        hs, src = self.transformer(src, image_pe, tokens)
        object_score_logits = self.pred_obj_score_head(hs[:, 0])
        iou_token_out = hs[:, 1]
        mask_tokens_out = hs[:, 2:2 + self.num_mask_tokens]
        feat3, feat1 = matting_upscale(self.output_upscaling, src, b, c, h, w)
        hyper_in = torch.stack([mlp(mask_tokens_out[:, i]) for i, mlp in
                                enumerate(self.output_hypernetworks_mlps)],
                               dim=1)
        mask_preds = torch.einsum("btc,bchw->bthw", hyper_in,
                                  feat1.to(hyper_in.dtype))
        iou_preds = self.iou_prediction_head(iou_token_out)
        return (mask_preds, iou_preds, mask_tokens_out, object_score_logits,
                feat3, feat1)


class _MattingDecode:
    """The prompt encoder, matting decoder and matting head of one frame."""

    def set_flash_attention(self, on):
        """Route the encoder's (and the memory's) attention through the
        kernels or the plain composition."""
        for m in self.modules():
            if isinstance(m, (MultiScaleAttention, RoPEAttention)):
                m.use_flash = on

    def _decode_matting(self, feat, prompts):
        """feat [B, C, s, s]; prompts dict or None -> (global, local, fused
        at the input size, IoU predictions [B, 4], object logits [B, 1],
        the best mask token [B, C])."""
        b = feat.shape[0]
        pe = self.prompt_encoder
        if prompts is None:
            sparse = pe.not_a_point_embed.weight[None].expand(b, 1, -1)
            dense = pe.no_mask_embed.weight.reshape(1, -1, 1, 1).expand(
                b, -1, feat.shape[2], feat.shape[3])
        else:
            sparse, dense = pe(prompts.get("prompt_point"),
                               prompts.get("prompt_box"),
                               prompts.get("prompt_mask"),
                               boxes_valid=prompts.get("prompt_box_valid"),
                               masks_valid=prompts.get("prompt_mask_valid"))
        masks, ious, mask_tokens_out, obj_logits, feat3, feat1 = \
            self.mask_decoder(feat, pe.get_dense_pe_layer(), sparse, dense)
        rows = torch.arange(b, device=feat.device)
        best = ious.argmax(dim=-1)
        size = (self.image_size, self.image_size)
        g, l, f = (resize_bilinear(p, size) for p in self.matting_head(
            masks[rows, best][:, None], feat3, feat1))
        return g, l, f, ious, obj_logits, mask_tokens_out[rows, best]


class SAM2ImageMatting(_MattingDecode, nn.Module):
    def __init__(self, image_size=1024, embedding_planes=112, head_nums=2,
                 block_nums=(2, 3, 16, 3), window_specification=(8, 4, 14, 7),
                 global_attention_blocks=(12, 16, 20), fpn_planes=256,
                 memory_planes=64, memory_mask_nums=7, memory_cond_slots=1,
                 max_object_pointers=16, use_gradient_checkpoint=False,
                 image_encoder_type="hiera", use_flash_attention=False,
                 head_dim_padding=0, dtype=None):
        super().__init__()
        self.image_size = image_size
        self.fpn_planes = fpn_planes
        self.image_encoder = build_image_encoder(
            image_encoder_type, image_size, embedding_planes, head_nums,
            block_nums, window_specification, global_attention_blocks,
            fpn_planes, use_flash_attention, head_dim_padding,
            use_gradient_checkpoint)
        self.prompt_encoder = PromptEncoder(image_size, 16, fpn_planes)
        self.mask_decoder = SAM2MaskDecoderMatting(fpn_planes)
        self.matting_head = MattingHead(fpn_planes)

    @torch.no_grad()
    def init_weights_(self, generator):
        """SAM2's seeded random weights (``init_sam2_weights_``)."""
        init_sam2_weights_(self, generator)

    def forward(self, batch_images, batch_prompts):
        features, _ = self.image_encoder(batch_images)
        g, l, f, ious, _, _ = self._decode_matting(features[-1],
                                                   batch_prompts)
        return g, l, f, ious


class SAM2VideoMatting(_MattingDecode, SAM2Video):
    def __init__(self, image_size=1024, embedding_planes=112, head_nums=2,
                 block_nums=(2, 3, 16, 3), window_specification=(8, 4, 14, 7),
                 global_attention_blocks=(12, 16, 20), fpn_planes=256,
                 memory_planes=64, memory_mask_nums=7, memory_cond_slots=1,
                 max_object_pointers=16, use_gradient_checkpoint=False,
                 image_encoder_type="hiera", use_flash_attention=False,
                 head_dim_padding=0, dtype=None):
        super().__init__(
            image_size=image_size, embedding_planes=embedding_planes,
            head_nums=head_nums, block_nums=block_nums,
            window_specification=window_specification,
            global_attention_blocks=global_attention_blocks,
            fpn_planes=fpn_planes, memory_planes=memory_planes,
            memory_mask_nums=memory_mask_nums,
            memory_cond_slots=memory_cond_slots,
            max_object_pointers=max_object_pointers,
            use_flash_attention=use_flash_attention,
            head_dim_padding=head_dim_padding,
            use_gradient_checkpoint=use_gradient_checkpoint,
            image_encoder_type=image_encoder_type, dtype=dtype)
        self.mask_decoder = SAM2MaskDecoderMatting(fpn_planes)
        self.matting_head = MattingHead(fpn_planes)
        del self.mask_downsample, self.no_memory_embedding

    def _pointer(self, token, obj_logits):
        """The object pointer of a frame's best mask token; the no-object
        pointer where the object score is not positive."""
        pointer = self.object_pointer_projection(token)
        is_obj = (obj_logits[:, 0] > 0).to(pointer.dtype)[:, None]
        return is_obj * pointer + (1.0 - is_obj) * self.no_object_pointer[0]

    def forward(self, images, frame0_prompts, is_cond_frame=None):
        """images [B, T, 3, H, W] -> (global [B, T, 3, H, W], local [B, T,
        1, H, W], fused [B, T, 1, H, W], IoU predictions [B, T, 4], object
        score logits [B, T, 1]) (see the module docstring)."""
        b, t_frames = images.shape[:2]
        feat16, pos16, _, _ = self.encode_frames_batch(images)
        pp = None if frame0_prompts is None else frame0_prompts.get(
            "prompt_point")
        per_frame = pp is not None and pp.dim() == 4
        p0 = self._slice_prompts(frame0_prompts, 0) if per_frame \
            else frame0_prompts
        cond = _host_flags(is_cond_frame, t_frames)
        *out, token = self._decode_matting(feat16[:, 0], p0)
        carry = self._store_memory(self._empty_carry(b, images.device),
                                   feat16[:, 0], out[2],
                                   self._pointer(token, out[4]), True,
                                   obj_logits=out[4])
        outs = [out]
        ratio = self.fpn_planes // self.memory_planes
        for t in range(1, t_frames):
            feat = feat16[:, t]
            c, s = feat.shape[1], feat.shape[2]
            memory, memory_pos, key_bias = self._memory_tokens(carry, b)
            conditioned = self.memory_attention(
                feat.flatten(2).transpose(1, 2), memory,
                pos16[:, t].flatten(2).transpose(1, 2), memory_pos,
                num_obj_ptr_tokens=self.max_object_pointers * ratio,
                key_bias=key_bias)
            conditioned = conditioned.transpose(1, 2).reshape(b, c, s, s)
            *out, token = self._decode_matting(
                conditioned,
                self._slice_prompts(frame0_prompts, t) if per_frame
                else None)
            carry = self._store_memory(carry, feat, out[2],
                                       self._pointer(token, out[4]), cond[t],
                                       obj_logits=out[4])
            outs.append(out)
        return tuple(torch.stack(parts, dim=1) for parts in zip(*outs))


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


def _factory(cls, size, **kwargs):
    return cls(**{**_SIZES[size], **kwargs})


def sam2_hiera_tiny_image_matting(**kw):
    return _factory(SAM2ImageMatting, "tiny", **kw)


def sam2_hiera_small_image_matting(**kw):
    return _factory(SAM2ImageMatting, "small", **kw)


def sam2_hiera_base_plus_image_matting(**kw):
    return _factory(SAM2ImageMatting, "base_plus", **kw)


def sam2_hiera_large_image_matting(**kw):
    return _factory(SAM2ImageMatting, "large", **kw)


def sam2_hiera_tiny_video_matting(**kw):
    return _factory(SAM2VideoMatting, "tiny", **kw)


def sam2_hiera_small_video_matting(**kw):
    return _factory(SAM2VideoMatting, "small", **kw)


def sam2_hiera_base_plus_video_matting(**kw):
    return _factory(SAM2VideoMatting, "base_plus", **kw)


def sam2_hiera_large_video_matting(**kw):
    return _factory(SAM2VideoMatting, "large", **kw)
