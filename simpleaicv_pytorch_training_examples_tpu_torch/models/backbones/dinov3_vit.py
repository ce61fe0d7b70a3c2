"""DINOv3 ViT backbones (axial RoPE, LayerScale, MLP or SwiGLU), the
ViTDet-style pyramid neck and the multi-scale detection backbone.

Counterpart of the JAX package's ``models/backbones/dinov3_vit.py``: patch
embed, pre-norm blocks with LayerScale residuals (1e-5), LayerNorms of
epsilon 1e-6 (fp32 statistics, output in ``dtype``), exact-erf GELU, a
final LayerNorm; the output is the grid ``[B, C, H/p, W/p]`` (NCHW), or,
with ``extra_tokens`` ``[B, Q, C]`` put in front of the grid tokens before
the last ``extra_token_blocks`` blocks, the ``[B, Q + HW, C]`` tokens after
the final norm.

RoPE. ``rope_sincos`` is the JAX package's table, computed in float64
numpy and cast to fp32. In training (``rope_*_coords``; the factories
rescale by up to 2x) the coordinates are shifted, jittered and rescaled by
draws from the train step's generator (seeded by (seed + 7, iteration,
micro-batch), attached like Dropout's), the tables computed in fp32 as
``rope_sincos_augmented``; ``forward(..., rope_draws=)`` hands the uniform
draws in instead (the CPU tests give both packages one draw). q and k go
to fp32, the trailing H*W tokens rotate (prefix tokens do not) and they go
back to ``dtype``.

Attention. With ``use_fused_attention``, head dim <= 128 and N <= 1024
tokens (ViT-B/16 and L/16 at 512^2: N = 1024, d = 64) the core is K2
(``ops/kernels/fused_attention.fused_attention``) on the rotated q and k;
otherwise the plain path: fp32 scores times ``hd ** -0.5``, an fp32
softmax, the probabilities cast to ``dtype`` before P.V. The detection
backbone (``DINOv3MultiScaleBackbone``) never sets the flag, as in JAX.

Parameter names are the reference torch model's (``patch_embed.proj``,
``blocks.{i}.{norm1,attn.{qkv,proj},ls1.gamma,norm2,mlp.{fc1,fc2} or
mlp.{w1,w2,w3},ls2.gamma}``, ``norm``), so that
``utils/torch_convert.convert_dinov3_vit_state_dict`` maps them onto the
JAX package's. ``VitPyramidNeck``'s ConvTranspose weights are torch's
(``utils/jax_weights`` flips Flax's unflipped kernels).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.kernels.fused_attention import (MAX_HEAD_DIM, MAX_TOKENS,
                                            fused_attention)
from ..common import (FusedLayerNorm, Linear, PatchEmbed, _MaskedDrop,
                      max_pool, remat_call)

__all__ = [
    "DinoVisionTransformer",
    "VitPyramidNeck",
    "DINOv3MultiScaleBackbone",
    "dinov3_vit_small_patch16_backbone",
    "dinov3_vit_small_plus_patch16_backbone",
    "dinov3_vit_base_patch16_backbone",
    "dinov3_vit_large_patch16_backbone",
    "dinov3_vit_large_plus_patch16_backbone",
    "dinov3_vit_huge_plus_patch16_backbone",
]


def rope_sincos(h, w, head_planes, base=100.0):
    """Axial RoPE tables ([HW, head_planes] sin, cos), fp32 from float64."""
    d4 = head_planes // 4
    periods = base ** (2 * np.arange(d4) / (head_planes // 2))
    coords_h = (np.arange(0.5, h) / h) * 2.0 - 1.0
    coords_w = (np.arange(0.5, w) / w) * 2.0 - 1.0
    gh, gw = np.meshgrid(coords_h, coords_w, indexing="ij")
    coords = np.stack([gh, gw], axis=-1).reshape(-1, 2)
    angles = 2 * math.pi * coords[:, :, None] / periods[None, None, :]
    angles = np.tile(angles.reshape(-1, 2 * d4), (1, 2))
    return (torch.from_numpy(np.sin(angles).astype(np.float32)),
            torch.from_numpy(np.cos(angles).astype(np.float32)))


def rope_sincos_augmented(h, w, head_planes, base, draws, shift_coords=None,
                          jitter_coords=None, rescale_coords=None,
                          device=None):
    """Train-time RoPE tables in fp32 from randomised coordinates: a uniform
    shift in [-shift, shift] per axis, a log-uniform jitter per axis and a
    log-uniform isotropic rescale. ``draws`` holds the uniform draws:
    ``shift`` [2] in [-shift, shift], ``jitter`` [2] in [-log jitter, log
    jitter], ``rescale`` [1] in [-log rescale, log rescale]; the ones of the
    options that are None are not used."""
    d4 = head_planes // 4
    periods = torch.tensor(base ** (2 * np.arange(d4) / (head_planes // 2)),
                           dtype=torch.float32, device=device)
    coords_h = torch.arange(0.5, h, dtype=torch.float32, device=device) \
        / h * 2.0 - 1.0
    coords_w = torch.arange(0.5, w, dtype=torch.float32, device=device) \
        / w * 2.0 - 1.0
    gh, gw = torch.meshgrid(coords_h, coords_w, indexing="ij")
    coords = torch.stack([gh, gw], dim=-1).reshape(-1, 2)
    if shift_coords is not None:
        coords = coords + draws["shift"][None]
    if jitter_coords is not None:
        coords = coords * torch.exp(draws["jitter"])[None]
    if rescale_coords is not None:
        coords = coords * torch.exp(draws["rescale"])
    angles = 2 * math.pi * coords[:, :, None] / periods[None, None, :]
    angles = angles.reshape(-1, 2 * d4).repeat(1, 2)
    return torch.sin(angles), torch.cos(angles)


def rope_rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def rope_apply(x, sin, cos):
    return x * cos + rope_rotate_half(x) * sin


class RopeDraw(_MaskedDrop):
    """The uniform draws of the train-time RoPE augmentation, from the
    generator the train step attaches (torch's default without one)."""

    def __init__(self, shift_coords, jitter_coords, rescale_coords):
        super().__init__()
        self.bounds = {"shift": (shift_coords, 2),
                       "jitter": (jitter_coords and math.log(jitter_coords),
                                  2),
                       "rescale": (rescale_coords
                                   and math.log(rescale_coords), 1)}

    def draw(self, device):
        draws = {}
        for name, (bound, n) in self.bounds.items():
            if bound is not None:
                u = torch.empty(n, dtype=torch.float32, device=device)
                draws[name] = u.uniform_(-bound, bound,
                                         generator=self.mask_generator)
        return draws


class LayerScale(nn.Module):

    def __init__(self, planes, init_values=1e-5):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((planes,), init_values))

    def init_weights_(self, generator):
        nn.init.constant_(self.gamma, self.init_values)

    def forward(self, x):
        return x * self.gamma.to(x.dtype)


class SwiGLUFFN(nn.Module):
    """w1, w2 (the JAX package's fused ``w12``), SiLU gate, w3; hidden width
    ``(int(h * 2 / 3) + 7) // 8 * 8``."""

    def __init__(self, planes, hidden_planes, dtype=torch.float32):
        super().__init__()
        h = (int(hidden_planes * 2 / 3) + 7) // 8 * 8
        self.w1 = Linear(planes, h, dtype)
        self.w2 = Linear(planes, h, dtype)
        self.w3 = Linear(h, planes, dtype)

    def forward(self, x):
        return self.w3(F.silu(self.w1(x)) * self.w2(x))


class _Mlp(nn.Module):

    def __init__(self, planes, hidden_planes, dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(planes, hidden_planes, dtype)
        self.fc2 = Linear(hidden_planes, planes, dtype)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class DINOv3SelfAttention(nn.Module):

    def __init__(self, planes, head_nums, dtype=torch.float32,
                 use_fused_attention=False):
        super().__init__()
        self.head_nums = head_nums
        self.compute_dtype = dtype
        self.use_fused_attention = use_fused_attention
        self.qkv = Linear(planes, 3 * planes, dtype)
        self.proj = Linear(planes, planes, dtype)

    def forward(self, x, sin=None, cos=None):
        b, n, c = x.shape
        nh = self.head_nums
        hd = c // nh
        q, k, v = self.qkv(x).reshape(b, n, 3, nh, hd).permute(
            2, 0, 3, 1, 4).unbind(0)          # [B, nh, N, hd]
        if sin is not None:
            prefix = n - sin.shape[0]
            q, k = q.float(), k.float()
            q = torch.cat([q[:, :, :prefix],
                           rope_apply(q[:, :, prefix:], sin, cos)], dim=2)
            k = torch.cat([k[:, :, :prefix],
                           rope_apply(k[:, :, prefix:], sin, cos)], dim=2)
            q, k = q.to(self.compute_dtype), k.to(self.compute_dtype)
        if self.use_fused_attention and hd <= MAX_HEAD_DIM \
                and n <= MAX_TOKENS:
            out = fused_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous())
        else:
            attn = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
                * hd ** -0.5
            attn = torch.softmax(attn, dim=-1).to(self.compute_dtype)
            out = torch.matmul(attn, v)
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class DINOv3Block(nn.Module):

    def __init__(self, planes, head_nums, ffn_ratio=4.0,
                 layerscale_init=1e-5, ffn_layer="mlp", dtype=torch.float32,
                 use_fused_attention=False):
        super().__init__()
        self.norm1 = FusedLayerNorm(planes, 1e-6, dtype)
        self.attn = DINOv3SelfAttention(planes, head_nums, dtype,
                                        use_fused_attention)
        self.ls1 = LayerScale(planes, layerscale_init)
        self.norm2 = FusedLayerNorm(planes, 1e-6, dtype)
        hidden = int(planes * ffn_ratio)
        self.mlp = (_Mlp(planes, hidden, dtype) if ffn_layer == "mlp"
                    else SwiGLUFFN(planes, hidden, dtype))
        self.ls2 = LayerScale(planes, layerscale_init)

    def forward(self, x, sin=None, cos=None):
        x = x + self.ls1(self.attn(self.norm1(x), sin, cos))
        return x + self.ls2(self.mlp(self.norm2(x)))


class DinoVisionTransformer(nn.Module):

    def __init__(self, patch_size=16, embedding_planes=768, block_nums=12,
                 head_nums=12, ffn_ratio=4.0, ffn_layer="mlp",
                 layerscale_init=1e-5, rope_base=100.0,
                 rope_shift_coords=None, rope_jitter_coords=None,
                 rope_rescale_coords=2.0, use_gradient_checkpoint=False,
                 dtype=torch.float32, use_fused_attention=False):
        super().__init__()
        self.embedding_planes = embedding_planes
        self.head_nums = head_nums
        self.rope_base = rope_base
        self.rope_options = (rope_shift_coords, rope_jitter_coords,
                             rope_rescale_coords)
        self.use_gradient_checkpoint = use_gradient_checkpoint
        self.patch_embed = PatchEmbed(3, embedding_planes, patch_size, dtype)
        self.blocks = nn.ModuleList([
            DINOv3Block(embedding_planes, head_nums, ffn_ratio,
                        layerscale_init, ffn_layer, dtype,
                        use_fused_attention) for _ in range(block_nums)])
        self.norm = FusedLayerNorm(embedding_planes, 1e-6, dtype)
        self.rope_draw = RopeDraw(*self.rope_options)

    @property
    def out_channels(self):
        return self.embedding_planes

    def rope(self, h, w, device, rope_draws=None):
        """(sin, cos) of the h x w grid: augmented in training when an
        option is set (``rope_draws`` or the attached generator's draws)."""
        hd = self.embedding_planes // self.head_nums
        if self.training and any(o is not None for o in self.rope_options):
            if rope_draws is None:
                rope_draws = self.rope_draw.draw(device)
            return rope_sincos_augmented(
                h, w, hd, self.rope_base,
                {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                 for k, v in rope_draws.items()},
                *self.rope_options, device=device)
        sin, cos = rope_sincos(h, w, hd, self.rope_base)
        return sin.to(device), cos.to(device)

    def forward(self, x, extra_tokens=None, extra_token_blocks=0,
                rope_draws=None):
        x = self.patch_embed(x)
        b, c, h, w = x.shape
        x = x.flatten(2).transpose(1, 2)          # [B, HW, C]
        sin, cos = self.rope(h, w, x.device, rope_draws)
        inject_at = len(self.blocks) - extra_token_blocks \
            if extra_tokens is not None else -1
        remat = self.use_gradient_checkpoint and torch.is_grad_enabled()
        for i, block in enumerate(self.blocks):
            if i == inject_at:
                x = torch.cat([extra_tokens.to(x.dtype), x], dim=1)
            x = remat_call(block, x, sin, cos) if remat else \
                block(x, sin, cos)
        x = self.norm(x)
        if extra_tokens is not None:
            return x
        return x.transpose(1, 2).reshape(b, c, h, w)


def dinov3_vit_small_patch16_backbone(**kwargs):
    return DinoVisionTransformer(16, 384, 12, 6, ffn_layer="mlp", **kwargs)


def dinov3_vit_small_plus_patch16_backbone(**kwargs):
    return DinoVisionTransformer(16, 384, 12, 6, ffn_layer="swiglu",
                                 **kwargs)


def dinov3_vit_base_patch16_backbone(**kwargs):
    return DinoVisionTransformer(16, 768, 12, 12, ffn_layer="mlp", **kwargs)


def dinov3_vit_large_patch16_backbone(**kwargs):
    return DinoVisionTransformer(16, 1024, 24, 16, ffn_layer="mlp",
                                 **kwargs)


def dinov3_vit_large_plus_patch16_backbone(**kwargs):
    return DinoVisionTransformer(16, 1024, 24, 16, ffn_layer="swiglu",
                                 **kwargs)


def dinov3_vit_huge_plus_patch16_backbone(**kwargs):
    return DinoVisionTransformer(16, 1280, 32, 20, ffn_layer="swiglu",
                                 **kwargs)


class _ConvTranspose2x2(nn.ConvTranspose2d):
    """2x2 / 2 transposed convolution computing in ``dtype``; its kernel
    starts from Flax's ``lecun_normal`` (std 1/sqrt(fan_in))."""

    def __init__(self, inplanes, planes, dtype):
        super().__init__(inplanes, planes, 2, 2)
        self.compute_dtype = dtype

    def init_weights_(self, generator):
        from ..common import trunc_normal_
        trunc_normal_(self.weight, (4 * self.in_channels) ** -0.5, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dtype = self.compute_dtype
        return F.conv_transpose2d(x.to(dtype), self.weight.to(dtype),
                                  self.bias.to(dtype), stride=2)


class VitPyramidNeck(nn.Module):
    """Single-scale /16 grid -> 4-level pyramid (/4, /8, /16, /32) of
    ``planes`` channels; tanh GELU (Flax's default) after each layer."""

    def __init__(self, inplanes, planes=256, dtype=torch.float32):
        from ..common import Conv2d
        super().__init__()
        self.p2_up1 = _ConvTranspose2x2(inplanes, planes, dtype)
        self.p2_up2 = _ConvTranspose2x2(planes, planes, dtype)
        self.p3_up = _ConvTranspose2x2(inplanes, planes, dtype)
        self.p4_conv = Conv2d(inplanes, planes, 1, dtype=dtype,
                              init_std=inplanes ** -0.5)

    def forward(self, x):
        gelu = lambda t: F.gelu(t, approximate="tanh")  # noqa: E731
        p2 = gelu(self.p2_up2(gelu(self.p2_up1(x))))
        p3 = gelu(self.p3_up(x))
        p4 = gelu(self.p4_conv(x))
        return p2, p3, p4, max_pool(p4, 2, 2)


class DINOv3MultiScaleBackbone(nn.Module):
    """DINOv3 ViT (``vit``, never with fused attention, as in JAX) and
    ``VitPyramidNeck`` (``neck``): the CNN-backbone interface, four maps."""

    def __init__(self, embedding_planes=768, block_nums=12, head_nums=12,
                 ffn_layer="mlp", patch_size=16, planes=256,
                 use_gradient_checkpoint=False, dtype=torch.float32):
        super().__init__()
        self.planes = planes
        self.vit = DinoVisionTransformer(
            patch_size=patch_size, embedding_planes=embedding_planes,
            block_nums=block_nums, head_nums=head_nums, ffn_layer=ffn_layer,
            use_gradient_checkpoint=use_gradient_checkpoint, dtype=dtype)
        self.neck = VitPyramidNeck(embedding_planes, planes, dtype)

    @property
    def out_channels(self):
        return [self.planes] * 4

    def forward(self, x, return_features=True):
        feats = self.neck(self.vit(x))
        return list(feats) if return_features else feats[-1]


_DINOV3_DET_SIZES = {
    "dinov3_vit_small_patch16": dict(embedding_planes=384, block_nums=12,
                                     head_nums=6, ffn_layer="mlp"),
    "dinov3_vit_small_plus_patch16": dict(embedding_planes=384,
                                          block_nums=12, head_nums=6,
                                          ffn_layer="swiglu"),
    "dinov3_vit_base_patch16": dict(embedding_planes=768, block_nums=12,
                                    head_nums=12, ffn_layer="mlp"),
    "dinov3_vit_large_patch16": dict(embedding_planes=1024, block_nums=24,
                                     head_nums=16, ffn_layer="mlp"),
    "dinov3_vit_large_plus_patch16": dict(embedding_planes=1024,
                                          block_nums=24, head_nums=16,
                                          ffn_layer="swiglu"),
    "dinov3_vit_huge_plus_patch16": dict(embedding_planes=1280,
                                         block_nums=32, head_nums=20,
                                         ffn_layer="swiglu"),
}

for _name, _cfg in _DINOV3_DET_SIZES.items():
    def _det_factory(_cfg=_cfg, **kwargs):
        return DINOv3MultiScaleBackbone(**{**_cfg, **kwargs})
    globals()[f"{_name}_det_backbone"] = _det_factory
__all__ += [f"{n}_det_backbone" for n in _DINOV3_DET_SIZES]
