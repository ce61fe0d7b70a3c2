"""SAM2's memory: axial-RoPE attention, memory attention and the memory
encoder.

Counterpart of the JAX package's
``video_interactive_segmentation/models/segment_anything2/memory.py``:

- ``RoPEAttention``: 2-D axial rotary encoding of q and k on the 64 x 64
  grid, in fp32 as the JAX package computes it (a real pairwise rotation);
  memory keys repeat the grid's angles once a memory slot
  (``rope_k_repeat``) and the trailing object-pointer tokens are not
  rotated (``num_k_exclude_rope``). An additive fp32 key bias [B, Nk]
  masks the empty slots of the tracker's ring buffers. With ``use_flash``
  the attention core is kernel K6, which takes the bias as it is.
- ``MemoryAttentionLayer``/``MemoryAttention``: pre-norm layers of
  self-attention, cross-attention to the memory (``memory_planes`` wide,
  64 in every published size) and a ReLU FFN; 0.1 x the position added on
  entry. Their LayerNorms use Flax's default eps 1e-6 (torch's is 1e-5).
- ``MemoryEncoder``: the mask downsampler (four 3x3 / stride-2
  convolutions, each with a channel LayerNorm and the exact GELU, then a
  1x1), the projected frame features added, two ConvNeXt ``CXBlock``s and
  a 1x1 projection to the 64-channel memory, with its sine positions.

Module names follow the reference torch layout
(``layers.N.{self_attn,cross_attn_image}.{q,k,v,out}_proj``,
``layers.N.{linear1,linear2,norm1,norm2,norm3}``, ``norm``;
``mask_downsampler.encoder.{0,1,3,4,6,7,9,10,12}``, ``pix_feat_proj``,
``fuser.layers.N.{dwconv,norm,pwconv1,pwconv2,gamma}``, ``out_proj``).
Tokens are [B, N, C]; the memory encoder takes and gives NCHW maps.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....interactive_segmentation.models.segment_anything.image_encoder import (
    LayerNorm2d)
from ....ops.kernels.flash_attention import flash_attention
from .image_encoder import sine_positions_like

__all__ = ["axial_rope_cos_sin", "apply_rope", "RoPEAttention",
           "MemoryAttentionLayer", "MemoryAttention", "CXBlock",
           "MemoryEncoder"]


def axial_rope_cos_sin(dim, end_x, end_y, theta=10000.0):
    """fp32 cos and sin tables [end_x * end_y, dim / 2] of axial 2-D RoPE
    (angles in float64 on the host, as the JAX package makes them)."""
    n = dim // 4
    freqs = 1.0 / (theta ** (np.arange(0, dim, 4)[:n].astype(np.float64)
                             / dim))
    t = np.arange(end_x * end_y, dtype=np.float64)
    angles = np.concatenate([np.outer(t % end_x, freqs),
                             np.outer(np.floor(t / end_x), freqs)], axis=-1)
    return (torch.from_numpy(np.cos(angles)).float(),
            torch.from_numpy(np.sin(angles)).float())


def apply_rope(x, cos, sin):
    """x [..., N, D]; cos, sin [N, D / 2]: rotate consecutive pairs."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                       dim=-1).reshape(x.shape)


class RoPEAttention(nn.Module):
    def __init__(self, inplanes=256, head_nums=1, downsample_rate=1,
                 kv_inplanes=None, feat_sizes=(64, 64), rope_theta=10000.0,
                 rope_k_repeat=False, use_flash=False):
        super().__init__()
        inter = inplanes // downsample_rate
        kv_inplanes = inplanes if kv_inplanes is None else kv_inplanes
        self.head_nums = head_nums
        self.rope_k_repeat = rope_k_repeat
        self.use_flash = use_flash
        self.q_proj = nn.Linear(inplanes, inter)
        self.k_proj = nn.Linear(kv_inplanes, inter)
        self.v_proj = nn.Linear(kv_inplanes, inter)
        self.out_proj = nn.Linear(inter, inplanes)
        cos, sin = axial_rope_cos_sin(inter // head_nums, feat_sizes[0],
                                      feat_sizes[1], rope_theta)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    def forward(self, q, k, v, num_k_exclude_rope=0, key_bias=None):
        """q [B, Nq, C]; k, v [B, Nk, C_kv]; key_bias fp32 [B, Nk] or None
        -> [B, Nq, C]. Nq is the RoPE grid; the last ``num_k_exclude_rope``
        keys are not rotated."""
        qp, kp, vp = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, nq, inter = qp.shape
        nk = kp.shape[1]
        nh = self.head_nums
        hd = inter // nh
        qp = qp.reshape(b, nq, nh, hd).transpose(1, 2)
        kp = kp.reshape(b, nk, nh, hd).transpose(1, 2)
        vp = vp.reshape(b, nk, nh, hd).transpose(1, 2)
        dtype = qp.dtype
        cos, sin = self.rope_cos, self.rope_sin
        n_grid = cos.shape[0]
        if nq != n_grid:
            raise ValueError(f"{nq} queries, but the RoPE grid has {n_grid}")
        with torch.autocast(q.device.type, enabled=False):
            qp = apply_rope(qp.float(), cos, sin).to(dtype)
            n_rope = nk - num_k_exclude_rope
            if n_rope > 0:
                if self.rope_k_repeat:
                    repeat = n_rope // n_grid
                    cos, sin = cos.repeat(repeat, 1), sin.repeat(repeat, 1)
                k_rot = apply_rope(kp[:, :, :n_rope].float(), cos, sin)
                kp = torch.cat([k_rot.to(dtype), kp[:, :, n_rope:]], dim=2)
            if self.use_flash:
                out = flash_attention(qp, kp, vp, bias=key_bias)
            else:
                attn = torch.einsum("bhqd,bhkd->bhqk", qp.float(), kp.float())
                attn = attn * hd ** -0.5
                if key_bias is not None:
                    attn = attn + key_bias[:, None, None, :]
                attn = torch.softmax(attn, dim=-1).to(vp.dtype)
                out = torch.einsum("bhqk,bhkd->bhqd", attn, vp)
        return self.out_proj(out.transpose(1, 2).reshape(b, nq, inter))


class MemoryAttentionLayer(nn.Module):
    def __init__(self, inplanes=256, feedforward_planes=2048,
                 feat_sizes=(64, 64), use_flash=False, memory_planes=64):
        super().__init__()
        self.self_attn = RoPEAttention(inplanes, 1, 1, None, feat_sizes,
                                       use_flash=use_flash)
        self.cross_attn_image = RoPEAttention(inplanes, 1, 1, memory_planes,
                                              feat_sizes, rope_k_repeat=True,
                                              use_flash=use_flash)
        self.linear1 = nn.Linear(inplanes, feedforward_planes)
        self.linear2 = nn.Linear(feedforward_planes, inplanes)
        self.norm1 = nn.LayerNorm(inplanes, eps=1e-6)
        self.norm2 = nn.LayerNorm(inplanes, eps=1e-6)
        self.norm3 = nn.LayerNorm(inplanes, eps=1e-6)

    def forward(self, tgt, memory, pos, num_k_exclude_rope=0, key_bias=None):
        t2 = self.norm1(tgt)
        tgt = tgt + self.self_attn(t2, t2, t2)
        t2 = self.norm2(tgt)
        tgt = tgt + self.cross_attn_image(
            t2, memory + pos, memory, num_k_exclude_rope=num_k_exclude_rope,
            key_bias=key_bias)
        t2 = self.norm3(tgt)
        return tgt + self.linear2(F.relu(self.linear1(t2)))


class MemoryAttention(nn.Module):
    def __init__(self, inplanes=256, layer_nums=4, feat_sizes=(64, 64),
                 use_flash=False, memory_planes=64):
        super().__init__()
        self.layers = nn.ModuleList([
            MemoryAttentionLayer(inplanes, 2048, feat_sizes, use_flash,
                                 memory_planes)
            for _ in range(layer_nums)])
        self.norm = nn.LayerNorm(inplanes, eps=1e-6)

    def forward(self, curr, memory, curr_pos, memory_pos,
                num_obj_ptr_tokens=0, key_bias=None):
        """curr, curr_pos [B, N, C]; memory, memory_pos [B, M, 64];
        key_bias fp32 [B, M] -> [B, N, C]."""
        output = curr + 0.1 * curr_pos
        for layer in self.layers:
            output = layer(output, memory, memory_pos,
                           num_k_exclude_rope=num_obj_ptr_tokens,
                           key_bias=key_bias)
        return self.norm(output)


class CXBlock(nn.Module):
    """ConvNeXt block: 7x7 depthwise convolution, channel LayerNorm (eps
    1e-6), Linear 4x, exact GELU, Linear, layer scale ``gamma``; NCHW."""

    def __init__(self, planes):
        super().__init__()
        self.dwconv = nn.Conv2d(planes, planes, 7, padding=3, groups=planes)
        self.norm = nn.LayerNorm(planes, eps=1e-6)
        self.pwconv1 = nn.Linear(planes, 4 * planes)
        self.pwconv2 = nn.Linear(4 * planes, planes)
        self.gamma = nn.Parameter(torch.full((planes,), 1e-6))

    def forward(self, x):
        y = self.norm(self.dwconv(x).permute(0, 2, 3, 1))
        y = self.pwconv2(F.gelu(self.pwconv1(y)))
        return x + (self.gamma * y).permute(0, 3, 1, 2)


class _MaskDownSampler(nn.Module):
    def __init__(self, planes):
        super().__init__()
        layers, ch = [], 1
        for _ in range(4):   # total stride 16: 1 -> 4 -> 16 -> 64 -> 256
            layers += [nn.Conv2d(ch, ch * 4, 3, stride=2, padding=1),
                       LayerNorm2d(ch * 4), nn.GELU()]
            ch *= 4
        layers.append(nn.Conv2d(ch, planes, 1))
        self.encoder = nn.Sequential(*layers)


class _Fuser(nn.Module):
    def __init__(self, planes, layer_nums=2):
        super().__init__()
        self.layers = nn.ModuleList([CXBlock(planes)
                                     for _ in range(layer_nums)])


class MemoryEncoder(nn.Module):
    def __init__(self, inplanes=256, planes=64):
        super().__init__()
        self.mask_downsampler = _MaskDownSampler(inplanes)
        self.pix_feat_proj = nn.Conv2d(inplanes, inplanes, 1)
        self.fuser = _Fuser(inplanes)
        if inplanes != planes:
            self.out_proj = nn.Conv2d(inplanes, planes, 1)

    def forward(self, pix_feat, masks, skip_mask_sigmoid=False):
        """pix_feat [B, C, H, W]; masks [B, 1, 16H, 16W] logits -> (memory
        features [B, planes, H, W], their sine positions, same shape)."""
        if not skip_mask_sigmoid:
            masks = torch.sigmoid(masks)
        x = self.mask_downsampler.encoder(masks)
        feat = self.pix_feat_proj(pix_feat) + x
        for block in self.fuser.layers:
            feat = block(feat)
        if hasattr(self, "out_proj"):
            feat = self.out_proj(feat)
        return feat, sine_positions_like(feat)
