"""Vision Transformer (B/16, L/16, H/14): NCHW images in, logits out.

Counterpart of the JAX package's ``models/backbones/vit.py``: conv patch
embed, cls token, learned pos embed over N+1 tokens, pre-norm blocks with a
linear drop-path schedule, cls-token head or global-pool head (MAE finetune
uses ``global_pool=True``).

Attribute names follow the original torch ViT, so its ``.pth`` files load
unchanged: ``patch_embed.proj``, ``cls_token``, ``pos_embed``,
``blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``, ``norm``,
``fc``.

dtype policy (as the JAX package): the patch embed, blocks and their
LayerNorms compute in ``dtype`` over fp32 parameters; the global-pool
LayerNorm and the ``fc`` head run in fp32.
"""

import torch
from torch import nn

from ..common import (Dropout, DropPath, FusedLayerNorm, Linear, Mlp,
                      MultiHeadSelfAttention, PatchEmbed, trunc_normal_)

__all__ = ["vit_base_patch16", "vit_large_patch16", "vit_huge_patch14"]


class TransformerEncoderLayer(nn.Module):

    def __init__(self, planes, head_nums, feedforward_ratio=4,
                 dropout_prob=0.0, drop_path_prob=0.0, dtype=torch.float32,
                 softmax_dtype=torch.float32, use_fused_attention=False,
                 use_fused_norm=False, use_fused_block=False):
        super().__init__()
        if use_fused_block:
            raise NotImplementedError(
                "the fused attention-block kernel (K8) is not ported yet")
        self.norm1 = FusedLayerNorm(planes, 1e-6, dtype, use_fused_norm)
        self.attn = MultiHeadSelfAttention(planes, head_nums, dropout_prob,
                                           dtype, softmax_dtype,
                                           use_fused_attention)
        self.norm2 = FusedLayerNorm(planes, 1e-6, dtype, use_fused_norm)
        self.mlp = Mlp(planes, planes * feedforward_ratio, dropout_prob, dtype)
        self.drop_path = DropPath(drop_path_prob)

    def forward(self, x):
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class ViT(nn.Module):

    def __init__(self, patch_size, embedding_planes, block_nums, head_nums,
                 feedforward_ratio=4, image_size=224, dropout_prob=0.0,
                 drop_path_prob=0.0, global_pool=False, num_classes=1000,
                 dtype=torch.float32, softmax_dtype=torch.float32,
                 use_fused_attention=False, use_fused_norm=False,
                 use_fused_block=False):
        super().__init__()
        n_tokens = (image_size // patch_size) ** 2
        self.global_pool = global_pool
        self.patch_embed = PatchEmbed(3, embedding_planes, patch_size, dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embedding_planes))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, n_tokens + 1, embedding_planes))
        self.pos_drop = Dropout(dropout_prob)
        # linear drop-path schedule: p_i = p * i / (n - 1)
        self.blocks = nn.ModuleList([
            TransformerEncoderLayer(
                embedding_planes, head_nums, feedforward_ratio, dropout_prob,
                drop_path_prob * i / max(block_nums - 1, 1), dtype,
                softmax_dtype, use_fused_attention, use_fused_norm,
                use_fused_block) for i in range(block_nums)
        ])
        self.norm = FusedLayerNorm(embedding_planes, 1e-6,
                                   torch.float32 if global_pool else dtype)
        self.fc = Linear(embedding_planes, num_classes, torch.float32,
                         init_std=2e-5)

    def init_weights_(self, generator):
        trunc_normal_(self.cls_token, 1e-6, generator)
        trunc_normal_(self.pos_embed, 0.02, generator)

    def forward(self, x):
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # [B, N, C]
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        x = self.pos_drop(x)
        for block in self.blocks:
            x = block(x)
        if self.global_pool:
            x = self.norm(x[:, 1:].mean(dim=1).float())
        else:
            x = self.norm(x)[:, 0].float()
        return self.fc(x)


def _vit(patch_size, embedding_planes, block_nums, head_nums,
         feedforward_ratio, **kwargs):
    return ViT(patch_size, embedding_planes, block_nums, head_nums,
               feedforward_ratio, **kwargs)


def vit_base_patch16(**kwargs):
    return _vit(16, 768, 12, 12, 4, **kwargs)


def vit_large_patch16(**kwargs):
    return _vit(16, 1024, 24, 16, 4, **kwargs)


def vit_huge_patch14(**kwargs):
    return _vit(14, 1280, 32, 16, 4, **kwargs)
