"""SAM2's Hiera image encoder and FPN neck.

Counterpart of the JAX package's
``video_interactive_segmentation/models/segment_anything2/image_encoder.py``:
a 7x7 / stride-4 patch embedding, a global position embedding resized to
the token grid plus a tiled window embedding, four stages of
MultiScaleBlocks (max-pooled queries at each stage change, per-stage
windows, a few global blocks), and an FPN neck giving 256-channel features
and sine positions at strides 4, 8 and 16 (the stride-32 level is dropped).
Module names follow the reference torch layout (``trunk.patch_embed.proj``,
``trunk.pos_embed`` and ``trunk.pos_embed_window`` NCHW,
``trunk.blocks.N.{norm1,attn.{qkv,proj},norm2,mlp.layers.{0,1},proj}``,
``neck.convs.N.conv``), so the JAX weight map and a reference checkpoint
load by name. Images come in NCHW; the blocks work on [B, H, W, C] tokens;
features and positions leave NCHW.

``head_dim_padding`` widens every head's qkv and proj parameters from the
logical width hd = planes / heads (56 at every Hiera stage) to that many
columns, as the JAX model does; the softmax scale stays hd^-0.5. With
``use_flash_attention`` the attention takes a kernel by the JAX package's
rules: non-pooled windows whose padded width is 64 or 128 take K1 over the
packed qkv with that scale; blocks with at least ``_FLASH_MIN_KV`` keys
(the global blocks) take K6; other non-pooled windows take K2, with q
rescaled so that K2's hdp^-0.5 nets hd^-0.5; pooled blocks, and everything
without the flag, run the plain composition (fp32 scores and softmax).

``use_gradient_checkpoint`` runs each block under
``torch.utils.checkpoint`` (non-reentrant) while grad is enabled, so that
the backward recomputes it: the JAX package's plain ``nn.remat`` of the
block, a full recompute.

The position embedding is resized with ``jax.image.resize``'s cubic kernel
(Keys, a = -0.5), whose weights ``utils/checkpoint.py`` builds;
``F.interpolate``'s bicubic uses a = -0.75. The MLP's GELU is the exact erf
form. The resize weights, and the sine positions, are computed in fp32
outside autocast.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ....interactive_segmentation.models.segment_anything.image_encoder import (
    window_partition, window_unpartition)
from ....interactive_segmentation.models.segment_anything.mask_decoder import (
    MLP)
from ....ops.kernels.flash_attention import flash_attention
from ....ops.kernels.fused_attention import (fused_attention,
                                             fused_attention_dense)
from ....utils.checkpoint import _resize_weights

__all__ = ["MultiScaleAttention", "MultiScaleBlock", "Hiera",
           "sine_position_embedding_2d", "ImageEncoder"]

# K6 pays off on long sequences (the global blocks); the windowed blocks
# (<= 196 keys) take K1 or K2. Tests patch it to send a tiny block to K6.
_FLASH_MIN_KV = 1024


def _max_pool(x, stride):
    """[B, H, W, C] -> [B, H / s, W / s, C], as Flax's nn.max_pool."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), stride, stride).permute(
        0, 2, 3, 1)


class MultiScaleAttention(nn.Module):
    """Hiera attention over [B, H, W, C_in] tokens, optionally with padded
    head parameters and pooled queries (see the module docstring)."""

    def __init__(self, inplanes, planes, head_nums, pool_stride=0,
                 use_flash=False, head_dim_padding=0):
        super().__init__()
        self.head_nums = head_nums
        self.pool_stride = pool_stride
        self.use_flash = use_flash
        self.head_dim = planes // head_nums
        self.padded_head_dim = max(head_dim_padding, self.head_dim)
        width = head_nums * self.padded_head_dim
        self.qkv = nn.Linear(inplanes, 3 * width)
        self.proj = nn.Linear(width, planes)

    def forward(self, x):
        b, h, w, _ = x.shape
        nh, hd, hdp = self.head_nums, self.head_dim, self.padded_head_dim
        sm_scale = hd ** -0.5
        qkv = self.qkv(x)
        if self.use_flash and not self.pool_stride and h * w <= 1024 \
                and hdp in (64, 128):
            out = fused_attention_dense(qkv.reshape(b, h * w, 3 * nh * hdp),
                                        nh, sm_scale=sm_scale)
            return self.proj(out.reshape(b, h, w, nh * hdp))

        q, k, v = qkv.reshape(b, h * w, 3, nh, hdp).unbind(2)  # [B, N, nh, hdp]
        if self.pool_stride:
            q = _max_pool(q.reshape(b, h, w, nh * hdp), self.pool_stride)
            h, w = q.shape[1], q.shape[2]
            q = q.reshape(b, h * w, nh, hdp)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))      # [B, nh, N, hdp]
        if self.use_flash and k.shape[2] >= _FLASH_MIN_KV:
            out = flash_attention(q, k, v, sm_scale=sm_scale)
        elif self.use_flash and not self.pool_stride and k.shape[2] <= 1024 \
                and hdp <= 128:
            if hdp != hd:  # K2 scales by hdp^-0.5; q makes up the difference
                q, k, v = ((q * (sm_scale * hdp ** 0.5)).contiguous(),
                           k.contiguous(), v.contiguous())
            out = fused_attention(q, k, v)
        else:
            with torch.autocast(x.device.type, enabled=False):
                attn = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
                attn = torch.softmax(attn * sm_scale, dim=-1).to(v.dtype)
                out = torch.einsum("bhqk,bhkd->bhqd", attn, v)
        out = out.transpose(1, 2).reshape(b, h, w, nh * hdp)
        return self.proj(out)


class MultiScaleBlock(nn.Module):
    def __init__(self, inplanes, planes, head_nums, mlp_ratio=4.0,
                 pool_stride=0, window_size=0, use_flash=False,
                 head_dim_padding=0):
        super().__init__()
        self.pool_stride = pool_stride
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(inplanes, eps=1e-6)
        if inplanes != planes and pool_stride:
            self.proj = nn.Linear(inplanes, planes)
        self.attn = MultiScaleAttention(inplanes, planes, head_nums,
                                        pool_stride, use_flash,
                                        head_dim_padding)
        self.norm2 = nn.LayerNorm(planes, eps=1e-6)
        self.mlp = MLP(planes, int(planes * mlp_ratio), planes, 2,
                       activation=F.gelu)

    def forward(self, x):
        """[B, H, W, C_in] -> [B, H / s, W / s, C_out]."""
        shortcut = x
        x = self.norm1(x)
        if hasattr(self, "proj"):
            shortcut = _max_pool(self.proj(x), self.pool_stride)
        window_size = self.window_size
        if window_size > 0:
            h, w = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, window_size)
        x = self.attn(x)
        if self.pool_stride:
            window_size = self.window_size // self.pool_stride
            h, w = shortcut.shape[1], shortcut.shape[2]
            pad_h = (window_size - h % window_size) % window_size \
                if window_size else 0
            pad_w = (window_size - w % window_size) % window_size \
                if window_size else 0
            pad_hw = (h + pad_h, w + pad_w)
        if self.window_size > 0:
            x = window_unpartition(x, window_size, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class _PatchEmbed(nn.Module):
    def __init__(self, planes):
        super().__init__()
        self.proj = nn.Conv2d(3, planes, 7, stride=4, padding=3)

    def forward(self, x):
        return self.proj(x)


class Hiera(nn.Module):
    def __init__(self, image_size=1024, embedding_planes=112, head_nums=2,
                 block_nums=(2, 3, 16, 3),
                 window_position_embedding_bkg_spatial_size=(14, 14),
                 window_specification=(8, 4, 14, 7),
                 global_attention_blocks=(12, 16, 20),
                 use_flash_attention=False, head_dim_padding=0,
                 use_gradient_checkpoint=False):
        super().__init__()
        self.use_gradient_checkpoint = use_gradient_checkpoint
        c = embedding_planes
        self.patch_embed = _PatchEmbed(c)
        bkg = window_position_embedding_bkg_spatial_size
        ws0 = window_specification[0]
        self.pos_embed = nn.Parameter(torch.zeros(1, c, *bkg))
        self.pos_embed_window = nn.Parameter(torch.zeros(1, c, ws0, ws0))
        grid = image_size // 4
        # jax.image.resize's cubic weights for the 14 -> grid resize, fp32
        self.register_buffer("pos_resize_h", _resize_weights(
            bkg[0], grid).float(), persistent=False)
        self.register_buffer("pos_resize_w", _resize_weights(
            bkg[1], grid).float(), persistent=False)

        stage_ends = [sum(block_nums[:i]) - 1
                      for i in range(1, len(block_nums) + 1)]
        pool_blocks = [i + 1 for i in stage_ends[:-1]]
        self.stage_ends = stage_ends
        blocks = []
        planes, heads, stage = c, head_nums, 1
        for i in range(sum(block_nums)):
            out_planes, block_heads = planes, heads
            window_size = window_specification[stage - 1]
            if i in global_attention_blocks:
                window_size = 0
            if i - 1 in stage_ends:
                out_planes, block_heads = planes * 2, heads * 2
                stage += 1
            blocks.append(MultiScaleBlock(
                planes, out_planes, block_heads, 4.0,
                2 if i in pool_blocks else 0, window_size,
                use_flash_attention, head_dim_padding))
            planes, heads = out_planes, block_heads
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x):
        """[B, 3, H, W] -> four [B, h, w, C] stage outputs, strides 4..32."""
        x = self.patch_embed(x)
        _, c, h, w = x.shape
        ws0 = self.pos_embed_window.shape[-1]
        with torch.autocast(x.device.type, enabled=False):
            pe = torch.einsum("chw,hH,wW->cHW", self.pos_embed[0].float(),
                              self.pos_resize_h, self.pos_resize_w)
            pe = pe + self.pos_embed_window[0].float().repeat(
                1, h // ws0, w // ws0)
        x = (x + pe.to(x.dtype)).permute(0, 2, 3, 1)
        outs = []
        remat = self.use_gradient_checkpoint and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
            if i in self.stage_ends:
                outs.append(x)
        return outs


def sine_position_embedding_2d(h, w, planes, temperature=10000, eps=1e-6,
                               device=None):
    """[H, W, 2 * planes] fp32 sine embedding (y terms, then x terms)."""
    arange = lambda n: torch.arange(n, dtype=torch.float32, device=device)
    scale = 2 * math.pi
    y_embed = ((arange(h) + 1) / (h + eps) * scale)[:, None].expand(h, w)
    x_embed = ((arange(w) + 1) / (w + eps) * scale)[None, :].expand(h, w)
    dim_t = temperature ** (2 * torch.div(arange(planes), 2,
                                          rounding_mode="floor") / planes)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.stack([pos_x[..., 0::2].sin(), pos_x[..., 1::2].cos()],
                        dim=3).reshape(h, w, -1)
    pos_y = torch.stack([pos_y[..., 0::2].sin(), pos_y[..., 1::2].cos()],
                        dim=3).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=2)


def sine_positions_like(f):
    """The sine positions of an NCHW feature map, [B, C, H, W] in its
    dtype (computed in fp32)."""
    b, c, h, w = f.shape
    pe = sine_position_embedding_2d(h, w, c // 2, device=f.device)
    return pe.permute(2, 0, 1)[None].expand(b, c, h, w).to(f.dtype)


class _NeckConv(nn.Module):
    def __init__(self, inplanes, planes):
        super().__init__()
        self.conv = nn.Conv2d(inplanes, planes, 1)

    def forward(self, x):
        return self.conv(x)


class _Neck(nn.Module):
    """The FPN's lateral 1x1 convolutions, deepest level first."""

    def __init__(self, trunk_planes, planes):
        super().__init__()
        self.convs = nn.ModuleList([_NeckConv(c, planes)
                                    for c in reversed(trunk_planes)])


class ImageEncoder(nn.Module):
    """Hiera trunk + FPN neck: [B, 3, H, W] -> ([stride 4, 8, 16 features],
    [their positions]), each [B, fpn_planes, h, w]."""

    def __init__(self, image_size=1024, embedding_planes=112, head_nums=2,
                 block_nums=(2, 3, 16, 3),
                 window_position_embedding_bkg_spatial_size=(14, 14),
                 window_specification=(8, 4, 14, 7),
                 global_attention_blocks=(12, 16, 20), fpn_planes=256,
                 use_flash_attention=False, head_dim_padding=0,
                 use_gradient_checkpoint=False):
        super().__init__()
        self.trunk = Hiera(image_size, embedding_planes, head_nums,
                           block_nums,
                           window_position_embedding_bkg_spatial_size,
                           window_specification, global_attention_blocks,
                           use_flash_attention, head_dim_padding,
                           use_gradient_checkpoint)
        self.neck = _Neck([embedding_planes * 2 ** i for i in range(4)],
                          fpn_planes)

    def forward(self, x):
        x0, x1, x2, x3 = (f.permute(0, 3, 1, 2) for f in self.trunk(x))
        convs = self.neck.convs
        p3 = convs[0](x3)
        p2 = convs[1](x2)
        p2 = p2 + F.interpolate(p3, size=p2.shape[-2:], mode="nearest")
        p1 = convs[2](x1)
        p0 = convs[3](x0)
        features = [p0, p1, p2]
        return features, [sine_positions_like(f) for f in features]
