"""SAM2 video tracking: the Hiera encoder, SAM's prompt encoder, SAM2's mask
decoder, memory attention and the memory encoder, with the streaming
primitives of test-time tracking.

Counterpart of the JAX package's
``video_interactive_segmentation/models/segment_anything2/sam2.py``
(``SAM2Video``'s inference methods). The tracking state is the JAX
package's fixed-capacity ring buffers, a dict of device tensors (the
carry): ``memory_mask_nums`` mask-memory slots, the first
``memory_cond_slots`` for prompted (condition) frames and the rest a ring
of tracked frames, and ``max_object_pointers`` object-pointer slots, each
with its frame index and a validity flag; empty slots get a -1e9 key bias
in the memory cross-attention. Each step returns a new carry and leaves the
old one as it was. Slots, frame indices and flags stay on the device: a
tracked frame makes no host sync but the read of its outputs.

Images are NCHW in [0, 1]; features are NCHW; prompts are the JAX
package's fixed-shape dict (``prompt_point`` [B, N, 3], ``prompt_box``
[B, 4], ``prompt_box_valid`` [B], ``prompt_mask`` [B, 1, H/4, W/4],
``prompt_mask_valid`` [B]). Module names follow the reference torch layout
(``image_encoder.trunk...``, ``mask_decoder.{obj_score_token,conv_s0,
conv_s1,pred_obj_score_head,transformer.layers.N.mlp.layers.{0,1}}``,
``memory_attention...``, ``memory_encoder...``,
``object_pointer_projection.layers.N``, ``mask_downsample``). The mask
upsampling is bilinear with half-pixel centres, as ``jax.image.resize``;
the 1024 -> 256 downsample of a mask prompt is ``nearest-exact``, which is
jax's "nearest" (torch's "nearest" is not). RoPE, the sine positions, the
key bias and the pointers' time positions are computed in fp32 under
autocast, and the mask-prompt downsample as an fp32 product.

Training (``forward``): ``encode_frames_batch`` encodes the B x T frames in
one encoder call, then ``track_from_features`` prompts frame 0 and tracks
the rest from the memory, in a Python loop (the JAX package's ``nn.scan``
over the frames gives the same numbers as its loop, so ``use_scan`` is
accepted and runs the loop). With per-frame prompts the condition frames
fill the reserved memory slots, and on point-iteration frames
(``_point_iter_refine``) the decoder runs ``point_iters`` more times, each
time with a new click drawn from the error region of the best mask against
the frame's target and that mask's logits as the mask prompt (its gradient
kept). The frames' roles (``is_cond_frame``, ``is_iter_frame``) are host
values: the loop branches on them without waiting for the card. The
clicks' Gumbel noise comes from ``click_noise(shape, generator, device)``
(``error_click.gumbel_noise`` by default), so a test can feed the JAX
package's draws. ``use_gradient_checkpoint`` recomputes each Hiera block in
the backward.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ....interactive_segmentation.error_click import (
    gumbel_noise, sample_error_points_batch)
from ....interactive_segmentation.models.segment_anything.image_encoder import (
    LayerNorm2d)
from ....interactive_segmentation.models.segment_anything.mask_decoder import (
    MLP)
from ....interactive_segmentation.models.segment_anything.prompt_encoder import (
    PromptEncoder)
from ....interactive_segmentation.models.segment_anything.transformer import (
    TwoWayTransformer)
from ....models.common import trunc_normal_
from .image_encoder import ImageEncoder, MultiScaleAttention
from .memory import CXBlock, MemoryAttention, MemoryEncoder, RoPEAttention

__all__ = ["get_1d_sine_pe", "SAM2MaskDecoder", "SAM2Video",
           "build_image_encoder", "init_sam2_weights_",
           "sam2_hiera_tiny_video", "sam2_hiera_small_video",
           "sam2_hiera_base_plus_video", "sam2_hiera_large_video"]

_EMPTY_FRAME = -10 ** 6


def get_1d_sine_pe(pos, dim, temperature=10000):
    """pos [N] -> [N, dim] fp32 sine position embedding."""
    pe_dim = dim // 2
    dim_t = torch.arange(pe_dim, dtype=torch.float32, device=pos.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                            / pe_dim)
    pos = pos.float()[:, None] / dim_t
    return torch.cat([pos.sin(), pos.cos()], dim=1)


class SAM2MaskDecoder(nn.Module):
    """SAM's decoder with an object-score token and head; with
    ``use_high_res_features`` the stride-4 and stride-8 FPN features skip
    into the upscaling (``conv_s0``, ``conv_s1``)."""

    def __init__(self, inplanes=256, num_multimask_outputs=3,
                 use_high_res_features=False):
        super().__init__()
        c = inplanes
        self.num_mask_tokens = num_multimask_outputs + 1
        self.use_high_res_features = use_high_res_features
        self.obj_score_token = nn.Embedding(1, c)
        self.iou_token = nn.Embedding(1, c)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, c)
        self.transformer = TwoWayTransformer(2, c, 8, 2048)
        for layer in self.transformer.layers:  # SAM2 names them layers.{0,1}
            layer.mlp = MLP(c, 2048, c, 2)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(c, c // 4, 2, stride=2), LayerNorm2d(c // 4),
            nn.GELU(), nn.ConvTranspose2d(c // 4, c // 8, 2, stride=2),
            nn.GELU())
        if use_high_res_features:
            self.conv_s0 = nn.Conv2d(c, c // 8, 1)
            self.conv_s1 = nn.Conv2d(c, c // 4, 1)
        self.output_hypernetworks_mlps = nn.ModuleList(
            [MLP(c, c, c // 8, 3) for _ in range(self.num_mask_tokens)])
        self.iou_prediction_head = MLP(c, c, self.num_mask_tokens, 3)
        self.pred_obj_score_head = MLP(c, c, 1, 3)

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, high_res_features=None):
        """image_embeddings [B, C, h, w], image_pe [1, C, h, w], sparse
        [B, n, C], dense [B, C, h, w], high_res_features (stride-4 [B, C,
        4h, 4w], stride-8 [B, C, 2h, 2w]) -> (mask logits [B, 4, 4h, 4w],
        IoU predictions [B, 4], mask tokens [B, 4, C], object score logits
        [B, 1])."""
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

        up = self.output_upscaling
        x = up[0](src.transpose(1, 2).reshape(b, c, h, w))
        if self.use_high_res_features:
            feat_s0, feat_s1 = high_res_features
            x = F.gelu(up[1](x + self.conv_s1(feat_s1)))
            x = F.gelu(up[3](x) + self.conv_s0(feat_s0))
        else:
            x = F.gelu(up[3](F.gelu(up[1](x))))
        hyper_in = torch.stack([mlp(mask_tokens_out[:, i]) for i, mlp in
                                enumerate(self.output_hypernetworks_mlps)],
                               dim=1)                      # [B, T, c / 8]
        mask_preds = torch.einsum("btc,bchw->bthw", hyper_in,
                                  x.to(hyper_in.dtype))
        iou_preds = self.iou_prediction_head(iou_token_out)
        return mask_preds, iou_preds, mask_tokens_out, object_score_logits


class SAM2Video(nn.Module):
    """Memory-conditioned video tracking: the training forward and the
    streaming primitives (see the module docstring). Parameters are fp32;
    run under ``torch.autocast`` for bf16 compute (``dtype`` is accepted for
    the JAX signature: the compute type follows autocast).
    ``image_encoder_type`` "hiera" is the Hiera trunk and FPN; a DINOv3
    backbone's name puts ``dinov3_segment_anything2.DINOv3SAM2ImageEncoder``
    in its place (``build_image_encoder``)."""

    def __init__(self, image_size=1024, embedding_planes=112, head_nums=2,
                 block_nums=(2, 3, 16, 3), window_specification=(8, 4, 14, 7),
                 global_attention_blocks=(12, 16, 20), fpn_planes=256,
                 memory_planes=64, memory_mask_nums=7, memory_cond_slots=1,
                 max_object_pointers=16, use_flash_attention=False,
                 use_high_res_features=False, head_dim_padding=0,
                 use_gradient_checkpoint=False, use_scan=False,
                 image_encoder_type="hiera", dtype=None):
        super().__init__()
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype {dtype}: the compute type follows "
                             "autocast (bfloat16) or is float32")
        self.image_size = image_size
        self.fpn_planes = fpn_planes
        self.memory_planes = memory_planes
        self.memory_mask_nums = memory_mask_nums
        self.memory_cond_slots = memory_cond_slots
        self.max_object_pointers = max_object_pointers
        self.use_high_res_features = use_high_res_features
        self.head_dim_padding = head_dim_padding
        s16 = image_size // 16
        self.image_encoder = build_image_encoder(
            image_encoder_type, image_size, embedding_planes, head_nums,
            block_nums, window_specification, global_attention_blocks,
            fpn_planes, use_flash_attention, head_dim_padding,
            use_gradient_checkpoint)
        self.prompt_encoder = PromptEncoder(image_size, 16, fpn_planes)
        self.mask_decoder = SAM2MaskDecoder(
            fpn_planes, use_high_res_features=use_high_res_features)
        self.memory_attention = MemoryAttention(fpn_planes, 4, (s16, s16),
                                                use_flash_attention,
                                                memory_planes)
        self.memory_encoder = MemoryEncoder(fpn_planes, memory_planes)
        self.mask_memory_time_position_encoder = nn.Parameter(
            torch.zeros(memory_mask_nums, 1, 1, memory_planes))
        self.no_memory_embedding = nn.Parameter(torch.zeros(1, 1, fpn_planes))
        self.no_object_pointer = nn.Parameter(torch.zeros(1, fpn_planes))
        self.no_object_embedding_spatial = nn.Parameter(
            torch.zeros(1, memory_planes))
        self.mask_downsample = nn.Conv2d(1, 1, 4, stride=4)
        self.object_pointer_projection = MLP(fpn_planes, fpn_planes,
                                             fpn_planes, 3)
        self.object_pointer_time_position_projection = nn.Linear(
            fpn_planes, memory_planes)

    def set_flash_attention(self, on):
        """Route the encoder's and the memory's attention through the kernels
        or the plain composition."""
        for m in self.modules():
            if isinstance(m, (MultiScaleAttention, RoPEAttention)):
                m.use_flash = on

    def load_pretrained(self, path, logger=None):
        """The checkpoint that a config recorded with ``load_state_dict``
        (applied by the engine's ``apply_pretrained`` when the file
        exists): a SAM2 ``.pth`` in the reference torch layout or the
        port's own, through ``load_sam2_checkpoint``, which pads Hiera's
        heads to ``head_dim_padding``. Returns (num_loaded, num_total)."""
        from ....utils.checkpoint import load_sam2_checkpoint
        return load_sam2_checkpoint(self, path, logger)

    @torch.no_grad()
    def init_weights_(self, generator):
        """Seeded random weights (``init_sam2_weights_``)."""
        init_sam2_weights_(self, generator)

    # ---- streaming step primitives

    def encode_frame(self, images):
        """images [B, 3, H, W] -> (feat16 [B, C, H/16, W/16], pos16 the
        same); with use_high_res_features also (feat_s4, feat_s8)."""
        features, positions = self.image_encoder(images)
        if self.use_high_res_features:
            return features[-1], positions[-1], (features[0], features[1])
        return features[-1], positions[-1]

    def _decode_frame(self, feat, prompts, highres=None):
        """feat [B, C, s, s]; prompts dict or None -> (masks upsampled
        [B, 4, H, W] fp32, ious [B, 4], object logits [B, 1], pointer
        [B, C], the best mask's logits [B, H/4, W/4])."""
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
        masks, ious, mask_tokens_out, obj_logits = self.mask_decoder(
            feat, pe.get_dense_pe_layer(), sparse, dense,
            high_res_features=highres)
        rows = torch.arange(b, device=feat.device)
        best = ious.argmax(dim=-1)
        best_mask = masks[rows, best]
        pointer = self.object_pointer_projection(mask_tokens_out[rows, best])
        is_obj = (obj_logits[:, 0] > 0).to(pointer.dtype)[:, None]
        pointer = is_obj * pointer + (1.0 - is_obj) * self.no_object_pointer[0]
        masks_up = F.interpolate(masks.float(), (self.image_size,) * 2,
                                 mode="bilinear", align_corners=False)
        return masks_up, ious, obj_logits, pointer, best_mask

    def _empty_carry(self, b, device):
        s16 = self.image_size // 16
        s_mem, p_max = self.memory_mask_nums, self.max_object_pointers
        zeros = lambda *shape: torch.zeros(shape, device=device)
        frames = lambda n: torch.full((n,), _EMPTY_FRAME, dtype=torch.int32,
                                      device=device)
        count = lambda: torch.zeros((), dtype=torch.int32, device=device)
        return {
            "mem_feats": zeros(s_mem, b, s16 * s16, self.memory_planes),
            "mem_pos": zeros(s_mem, b, s16 * s16, self.memory_planes),
            "mem_frame": frames(s_mem),
            "mem_valid": zeros(s_mem),
            "ptr_bank": zeros(p_max, b, self.fpn_planes),
            "ptr_frame": frames(p_max),
            "ptr_valid": zeros(p_max),
            "frame_idx": count(),
            # condition-frame slots used / tracked frames written
            "cond_count": count(),
            "track_count": count(),
        }

    def _write_memory(self, carry, feat, best_mask, pointer, is_cond,
                      obj_logits=None):
        """Encode (feat, the best mask's logits [B, H/4, W/4] upsampled to
        the input size) into memory and return the new carry
        (``_store_memory``)."""
        mask = F.interpolate(best_mask[:, None].float(),
                             (self.image_size,) * 2, mode="bilinear",
                             align_corners=False)
        return self._store_memory(carry, feat, mask, pointer, is_cond,
                                  obj_logits)

    def _store_memory(self, carry, feat, mask, pointer, is_cond,
                      obj_logits=None):
        """Encode (feat, mask [B, 1, H, W], which the memory encoder puts
        through a sigmoid) into memory and return the new carry. Condition
        frames (``is_cond`` True, or a device flag > 0) fill slots [0,
        memory_cond_slots), tracked frames rotate through the rest."""
        s_mem = self.memory_mask_nums
        frame_idx = carry["frame_idx"]
        mem, mem_pos = self.memory_encoder(feat, mask)
        if obj_logits is not None:  # the "object gone" signal
            is_obj = (obj_logits[:, 0] > 0).to(mem.dtype)
            mem = mem + (1.0 - is_obj)[:, None, None, None] * \
                self.no_object_embedding_spatial[0][None, :, None, None]
        cond_slots = max(1, min(self.memory_cond_slots, s_mem - 1))
        ring = s_mem - cond_slots
        cond_slot = carry["cond_count"].clamp(max=cond_slots - 1)
        track_slot = cond_slots + carry["track_count"] % ring
        if isinstance(is_cond, torch.Tensor):
            cond = (is_cond > 0).to(torch.int32)
            slot = torch.where(cond > 0, cond_slot, track_slot)
        else:
            cond = int(bool(is_cond))
            slot = cond_slot if cond else track_slot
        slot = slot.long().view(1)
        pslot = (frame_idx % self.max_object_pointers).long().view(1)
        tokens = lambda t: t.flatten(2).transpose(1, 2)[None].float()
        one = torch.ones(1, device=feat.device)
        return {
            "mem_feats": carry["mem_feats"].index_copy(0, slot, tokens(mem)),
            "mem_pos": carry["mem_pos"].index_copy(0, slot, tokens(mem_pos)),
            "mem_frame": carry["mem_frame"].index_copy(0, slot,
                                                       frame_idx.view(1)),
            "mem_valid": carry["mem_valid"].index_copy(0, slot, one),
            "ptr_bank": carry["ptr_bank"].index_copy(0, pslot,
                                                     pointer[None].float()),
            "ptr_frame": carry["ptr_frame"].index_copy(0, pslot,
                                                       frame_idx.view(1)),
            "ptr_valid": carry["ptr_valid"].index_copy(0, pslot, one),
            "frame_idx": frame_idx + 1,
            "cond_count": carry["cond_count"] + cond,
            "track_count": carry["track_count"] + (1 - cond),
        }

    def start_track(self, feat, prompts, highres=None):
        """Prompted first frame: decode and seed the memory carry."""
        masks, ious, obj, pointer, best_mask = self._decode_frame(
            feat, prompts, highres=highres)
        carry = self._empty_carry(feat.shape[0], feat.device)
        carry = self._write_memory(carry, feat, best_mask, pointer, True,
                                   obj_logits=obj)
        return (masks, ious, obj), carry

    def _memory_tokens(self, carry, b):
        """The memory bank of one step: (memory [B, M, 64], positions
        [B, M, 64], fp32 key bias [B, M]), M = slots x s^2 + pointers x C/64,
        the pointer tokens last."""
        s16 = self.image_size // 16
        n_mem = s16 * s16
        s_mem, p_max = self.memory_mask_nums, self.max_object_pointers
        mem_planes = self.memory_planes
        frame_idx = carry["frame_idx"]
        t_rel = (frame_idx - carry["mem_frame"]).clamp(0, s_mem - 1)
        time_enc = self.mask_memory_time_position_encoder.reshape(s_mem, -1)[
            (s_mem - t_rel - 1).clamp(0, s_mem - 1).long()]
        mem_pos = carry["mem_pos"] + time_enc[:, None, None, :]
        mem_k = carry["mem_feats"].transpose(0, 1).reshape(
            b, s_mem * n_mem, mem_planes)
        mem_p = mem_pos.transpose(0, 1).reshape(b, s_mem * n_mem, mem_planes)
        mem_bias = torch.where(carry["mem_valid"] > 0, 0.0,
                               -1e9).repeat_interleave(n_mem)

        ratio = self.fpn_planes // mem_planes
        t_diff = (frame_idx - carry["ptr_frame"]).clamp(0, p_max - 1)
        tpos = get_1d_sine_pe(t_diff.float() / max(p_max - 1, 1),
                              self.fpn_planes)
        tpos = self.object_pointer_time_position_projection(tpos)
        ptrs = carry["ptr_bank"].reshape(p_max, b, ratio, mem_planes)
        ptrs = ptrs.transpose(0, 1).reshape(b, p_max * ratio, mem_planes)
        ptr_p = tpos.repeat_interleave(ratio, dim=0)[None].expand(
            b, -1, -1).to(mem_p.dtype)
        ptr_bias = torch.where(carry["ptr_valid"] > 0, 0.0,
                               -1e9).repeat_interleave(ratio)
        memory = torch.cat([mem_k, ptrs.to(mem_k.dtype)], dim=1)
        memory_pos = torch.cat([mem_p, ptr_p], dim=1)
        key_bias = torch.cat([mem_bias, ptr_bias])[None].expand(b, -1)
        return memory, memory_pos, key_bias

    def _point_iter_refine(self, conditioned, outs, gt_mask, n_iters,
                           generator, click_noise, highres=None):
        """Point-iteration refinement of a tracked frame, ``n_iters`` times:
        click the error region of the best mask against ``gt_mask`` [B, H,
        W] and decode the same memory-conditioned features again with the
        clicks so far and the best mask's logits as the mask prompt."""
        b = conditioned.shape[0]
        masks_up, ious, obj, pointer, best_mask = outs
        device = conditioned.device
        rows = torch.arange(b, device=device)
        points = torch.full((b, n_iters, 3), -1.0, device=device)
        h, w = gt_mask.shape[-2:]
        for it in range(n_iters):
            pred = (masks_up[rows, ious.argmax(dim=-1)] > 0).float()
            clicks = sample_error_points_batch(
                click_noise((b, h * w), generator, device), pred, gt_mask)
            points = points.clone()
            points[:, it] = clicks
            prompts = {
                "prompt_point": points,
                "prompt_box": torch.zeros(b, 4, device=device),
                "prompt_box_valid": torch.zeros(b, device=device),
                "prompt_mask": best_mask[:, None],
                "prompt_mask_valid": torch.ones(b, device=device),
            }
            masks_up, ious, obj, pointer, best_mask = self._decode_frame(
                conditioned, prompts, highres=highres)
        return masks_up, ious, obj, pointer, best_mask

    def track_frame(self, feat, pos, carry, frame_prompts=None, is_cond=None,
                    highres=None, gt_mask=None, iter_flag=None,
                    generator=None, point_iters=0, click_noise=gumbel_noise):
        """A memory-conditioned frame: attend to the memory, decode, write
        the new memory. frame_prompts: the prompt dict of a prompted frame
        (all-invalid prompts map to the no-prompt embeddings); is_cond: a
        flag (bool or device tensor) that steers the frame into the
        condition slots. Training: with ``point_iters`` > 0 and ``gt_mask``
        [B, H, W], the frame is refined (``_point_iter_refine``) unless the
        host flag ``iter_flag`` is given and false; the clicks' noise is
        ``click_noise(shape, generator, device)``."""
        b, c, s, _ = feat.shape
        memory, memory_pos, key_bias = self._memory_tokens(carry, b)
        ratio = self.fpn_planes // self.memory_planes
        conditioned = self.memory_attention(
            feat.flatten(2).transpose(1, 2), memory,
            pos.flatten(2).transpose(1, 2), memory_pos,
            num_obj_ptr_tokens=self.max_object_pointers * ratio,
            key_bias=key_bias)
        conditioned = conditioned.transpose(1, 2).reshape(b, c, s, s)
        outs = self._decode_frame(conditioned, frame_prompts, highres=highres)
        if point_iters > 0 and gt_mask is not None and (
                iter_flag is None or iter_flag):
            outs = self._point_iter_refine(conditioned, outs, gt_mask,
                                           point_iters, generator,
                                           click_noise, highres=highres)
        masks, ious, obj, pointer, best_mask = outs
        carry = self._write_memory(carry, feat, best_mask, pointer,
                                   False if is_cond is None else is_cond,
                                   obj_logits=obj)
        return (masks, ious, obj), carry

    def add_mask_frame(self, feat, mask, carry, highres=None):
        """Prompt a frame with a full mask [B, H, W] in {0, 1}: the mask is
        the output (logits mask * 20 - 10, IoU 1); the decoder runs on its
        learned 4x4 / stride-4 downsample only for the object pointer and
        score; the memory encodes the given mask."""
        b = feat.shape[0]
        m = mask.float()
        _, hm, wm = m.shape
        patches = m.reshape(b, hm // 4, 4, wm // 4, 4)
        with torch.autocast(m.device.type, enabled=False):
            small = torch.einsum("bhpwq,pq->bhw", patches,
                                 self.mask_downsample.weight[0, 0].float())
            small = (small + self.mask_downsample.bias.float())[:, None]
        prompts = {
            "prompt_point": torch.full((b, 1, 3), -1.0, device=m.device),
            "prompt_box": torch.zeros(b, 4, device=m.device),
            "prompt_box_valid": torch.zeros(b, device=m.device),
            "prompt_mask": small,
            "prompt_mask_valid": torch.ones(b, device=m.device),
        }
        _, _, obj, pointer, _ = self._decode_frame(feat, prompts,
                                                   highres=highres)
        is_obj = (small.reshape(b, -1) > 0).any(dim=1).to(
            pointer.dtype)[:, None]
        pointer = is_obj * pointer + (1.0 - is_obj) * self.no_object_pointer[0]
        s4 = self.image_size // 4
        best_mask = F.interpolate(m[:, None], (s4, s4),
                                  mode="nearest-exact")[:, 0] * 20.0 - 10.0
        carry = self._write_memory(carry, feat, best_mask, pointer, True,
                                   obj_logits=obj)
        n_masks = self.mask_decoder.num_mask_tokens
        masks_up = (m * 20.0 - 10.0)[:, None].expand(b, n_masks, -1, -1)
        return (masks_up, torch.ones(b, n_masks, device=m.device), obj), carry

    def add_prompt_frame(self, feat, prompts, carry, highres=None):
        """A new prompted (condition) frame mid-stream."""
        masks, ious, obj, pointer, best_mask = self._decode_frame(
            feat, prompts, highres=highres)
        carry = self._write_memory(carry, feat, best_mask, pointer, True,
                                   obj_logits=obj)
        return (masks, ious, obj), carry


    # ---- training forward

    @staticmethod
    def _slice_prompts(prompts, t):
        """Frame t of a [B, T, ...] prompt dict (None values pass)."""
        if prompts is None:
            return None
        return {k: (v[:, t] if v is not None else None)
                for k, v in prompts.items()}

    def forward(self, images, frame0_prompts, gt_masks=None,
                is_cond_frame=None, is_iter_frame=None, generator=None,
                point_iters=0, click_noise=gumbel_noise):
        """images [B, T, 3, H, W] -> (mask logits [B, T, 4, H, W], IoU
        predictions [B, T, 4], object score logits [B, T, 1]).

        ``frame0_prompts``: the prompt dict of frame 0 alone (``prompt_point``
        [B, P, 3]: prompts on frame 0, pure tracking after), or per frame
        (``prompt_point`` [B, T, P, 3] and the other prompts with a T axis:
        the condition-frame recipe, where the other frames carry all-invalid
        prompts). With per-frame prompts, ``is_cond_frame`` [T] marks the
        condition frames (frame 0 always is one) and, with ``gt_masks`` [B,
        T, H, W] and ``point_iters`` > 0, ``is_iter_frame`` [T] the frames
        refined by error clicks. Both flags are host values (numpy, a list,
        or a CPU tensor)."""
        feat16, pos16, hr4, hr8 = self.encode_frames_batch(images)
        return self.track_from_features(
            feat16, pos16, hr4, hr8, frame0_prompts, gt_masks=gt_masks,
            is_cond_frame=is_cond_frame, is_iter_frame=is_iter_frame,
            generator=generator, point_iters=point_iters,
            click_noise=click_noise)

    def encode_frames_batch(self, images):
        """images [B, T, 3, H, W] -> (feat16, pos16, hr4, hr8), each with a
        leading [B, T] (hr4, hr8 None without the high-res skips): one
        encoder call on the B * T frames."""
        b, t = images.shape[:2]
        features, positions = self.image_encoder(images.flatten(0, 1))
        split = lambda f: f.unflatten(0, (b, t))
        hr4 = hr8 = None
        if self.use_high_res_features:
            hr4, hr8 = split(features[0]), split(features[1])
        return split(features[-1]), split(positions[-1]), hr4, hr8

    def track_from_features(self, feat16, pos16, hr4, hr8, frame0_prompts,
                            gt_masks=None, is_cond_frame=None,
                            is_iter_frame=None, generator=None,
                            point_iters=0, click_noise=gumbel_noise):
        """The half of ``forward`` after the encoder: prompt frame 0, then
        track the remaining frames from the memory."""
        b, t_frames = feat16.shape[:2]

        def hr_at(t):
            return None if hr4 is None else (hr4[:, t], hr8[:, t])

        pp = None if frame0_prompts is None else frame0_prompts.get(
            "prompt_point")
        per_frame = pp is not None and pp.dim() == 4
        p0 = self._slice_prompts(frame0_prompts, 0) if per_frame \
            else frame0_prompts
        (masks0, ious0, obj0), carry = self.start_track(
            feat16[:, 0], p0, highres=hr_at(0))
        outs = [(masks0, ious0, obj0)]
        refine = point_iters > 0 and gt_masks is not None and per_frame
        cond = _host_flags(is_cond_frame, t_frames)
        iters = _host_flags(is_iter_frame, t_frames)
        for t in range(1, t_frames):
            out, carry = self.track_frame(
                feat16[:, t], pos16[:, t], carry,
                frame_prompts=self._slice_prompts(frame0_prompts, t)
                if per_frame else None,
                is_cond=cond[t], highres=hr_at(t),
                gt_mask=gt_masks[:, t] if refine else None,
                iter_flag=iters[t], generator=generator,
                point_iters=point_iters if refine else 0,
                click_noise=click_noise)
            outs.append(out)
        return tuple(torch.stack(parts, dim=1) for parts in zip(*outs))


def build_image_encoder(image_encoder_type, image_size, embedding_planes,
                        head_nums, block_nums, window_specification,
                        global_attention_blocks, fpn_planes,
                        use_flash_attention=False, head_dim_padding=0,
                        use_gradient_checkpoint=False):
    """Hiera and its FPN ("hiera"), or the DINOv3 encoder of that backbone
    name; either returns ([stride-4, -8, -16 features], their sine
    positions)."""
    if image_encoder_type != "hiera":
        from ..dinov3_segment_anything2 import DINOv3SAM2ImageEncoder
        return DINOv3SAM2ImageEncoder(image_encoder_type, fpn_planes,
                                      use_gradient_checkpoint)
    return ImageEncoder(
        image_size, embedding_planes, head_nums, block_nums, (14, 14),
        window_specification, global_attention_blocks, fpn_planes,
        use_flash_attention, head_dim_padding, use_gradient_checkpoint)


@torch.no_grad()
def init_sam2_weights_(model, generator):
    """Seeded random weights of a model of SAM2's parts (``SAM2Video``,
    ``SAM2Image``, the matting models), drawn from ``generator``: PyTorch's
    default initialisers for Linear and convolution weights and biases
    (uniform in +-1/sqrt(fan_in)), unit norms, N(0, 1) embeddings and
    tokens, N(0, 0.02^2) (truncated) position embeddings and memory
    embeddings, as the JAX model draws them, and CXBlock layer scales of
    0.1 (1e-6 in a fresh reference model) so that a smoke run exercises the
    memory encoder's fuser. Modules with an ``init_weights_`` of their own
    (a DINOv3 encoder's, BatchNorm's) set theirs after this."""
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
        elif isinstance(module, CXBlock):
            module.gamma.fill_(0.1)
    trunk = getattr(model.image_encoder, "trunk", None)
    for owner, name in ((trunk, "pos_embed"), (trunk, "pos_embed_window"),
                        (model, "mask_memory_time_position_encoder"),
                        (model, "no_memory_embedding"),
                        (model, "no_object_pointer"),
                        (model, "no_object_embedding_spatial")):
        p = getattr(owner, name, None)
        if p is not None:
            trunc_normal_(p, 0.02, generator)


def _host_flags(flags, n):
    """[n] host flags (numpy, a list or a CPU tensor; None: all off) -> n
    Python bools. A CUDA tensor is refused: reading it would wait for the
    card."""
    if flags is None:
        return [False] * n
    if isinstance(flags, torch.Tensor):
        if flags.device.type != "cpu":
            raise ValueError("frame flags must be host values, not on "
                             f"{flags.device}")
        flags = flags.tolist()
    return [float(x) > 0 for x in flags]


def sam2_hiera_tiny_video(**kwargs):
    return SAM2Video(**{"embedding_planes": 96, "head_nums": 1,
                        "block_nums": (1, 2, 7, 2),
                        "global_attention_blocks": (5, 7, 9), **kwargs})


def sam2_hiera_small_video(**kwargs):
    return SAM2Video(**{"embedding_planes": 96, "head_nums": 1,
                        "block_nums": (1, 2, 11, 2),
                        "global_attention_blocks": (7, 10, 13), **kwargs})


def sam2_hiera_base_plus_video(**kwargs):
    return SAM2Video(**{"embedding_planes": 112, "head_nums": 2,
                        "block_nums": (2, 3, 16, 3),
                        "global_attention_blocks": (12, 16, 20), **kwargs})


def sam2_hiera_large_video(**kwargs):
    return SAM2Video(**{"embedding_planes": 144, "head_nums": 2,
                        "block_nums": (2, 6, 36, 4),
                        "window_specification": (8, 4, 16, 8),
                        "global_attention_blocks": (23, 33, 43), **kwargs})
