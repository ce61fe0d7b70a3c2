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

``use_fused_block`` runs a block's first half (norm1, the attention and its
residual) as one kernel, K8 (``ops/kernels/attn_block.py``), by the JAX
package's rule, decided at each call: head dim 64 or 128, N <= 1024, and no
live dropout or drop path (the block's own drop-path probability: under the
linear schedule block 0 has none and fuses in training). The kernel reads
the block's own parameters, so the parameter names do not change; norm1's
``use_fused_norm`` does not apply on that route.

``use_gradient_checkpoint`` runs each block under ``torch.utils.checkpoint``
(non-reentrant) while grad is enabled, the JAX package's ``nn.remat`` of the
block: the backward computes it again, drawing the same dropout and
drop-path masks (the attached mask generator's state is restored for the
recompute).
"""

import contextlib

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.kernels.attn_block import attn_block, supported
from ..common import (Dropout, DropPath, FusedLayerNorm, Linear, Mlp,
                      MultiHeadSelfAttention, PatchEmbed, trunc_normal_)

__all__ = ["vit_base_patch16", "vit_large_patch16", "vit_huge_patch14"]


class TransformerEncoderLayer(nn.Module):

    def __init__(self, planes, head_nums, feedforward_ratio=4,
                 dropout_prob=0.0, drop_path_prob=0.0, dtype=torch.float32,
                 softmax_dtype=torch.float32, use_fused_attention=False,
                 use_fused_norm=False, use_fused_block=False):
        super().__init__()
        self.use_fused_block = use_fused_block
        self.norm1 = FusedLayerNorm(planes, 1e-6, dtype, use_fused_norm)
        self.attn = MultiHeadSelfAttention(planes, head_nums, dropout_prob,
                                           dtype, softmax_dtype,
                                           use_fused_attention)
        self.norm2 = FusedLayerNorm(planes, 1e-6, dtype, use_fused_norm)
        self.mlp = Mlp(planes, planes * feedforward_ratio, dropout_prob, dtype)
        self.drop_path = DropPath(drop_path_prob)

    def fuses(self, x):
        """Whether this call takes K8 (the JAX package's gate)."""
        live = self.training and (self.attn.dropout_prob > 0.0
                                  or self.drop_path.drop_path_prob > 0.0)
        return (self.use_fused_block and not live
                and supported(x.shape[1], x.shape[2], self.attn.head_nums))

    def forward(self, x):
        if self.fuses(x):
            dtype = self.attn.compute_dtype
            qkv, proj = self.attn.qkv, self.attn.proj
            x = attn_block(x, qkv.weight.to(dtype), qkv.bias.to(dtype),
                           proj.weight.to(dtype), proj.bias.to(dtype),
                           self.norm1.weight, self.norm1.bias,
                           self.attn.head_nums, self.norm1.eps)
        else:
            x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


def _checkpoint_contexts(block):
    """``context_fn`` of a checkpointed block: the recompute starts from the
    states its Dropout and DropPath generators had at the original forward
    (torch restores only its default generators), and leaves them as it
    found them."""
    generators = list({id(g): g for m in block.modules()
                       if (g := getattr(m, "mask_generator", None))
                       is not None}.values())
    states = [g.get_state() for g in generators]

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in generators]
        for g, state in zip(generators, states):
            g.set_state(state)
        try:
            yield
        finally:
            for g, state in zip(generators, now):
                g.set_state(state)
    return contextlib.nullcontext(), recompute()


class ViT(nn.Module):

    def __init__(self, patch_size, embedding_planes, block_nums, head_nums,
                 feedforward_ratio=4, image_size=224, dropout_prob=0.0,
                 drop_path_prob=0.0, global_pool=False, num_classes=1000,
                 dtype=torch.float32, softmax_dtype=torch.float32,
                 use_fused_attention=False, use_fused_norm=False,
                 use_fused_block=False, use_gradient_checkpoint=False):
        super().__init__()
        n_tokens = (image_size // patch_size) ** 2
        self.global_pool = global_pool
        self.use_gradient_checkpoint = use_gradient_checkpoint
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
        remat = self.use_gradient_checkpoint and torch.is_grad_enabled()
        for block in self.blocks:
            if remat:
                x = checkpoint(block, x, use_reentrant=False,
                               context_fn=lambda b=block:
                               _checkpoint_contexts(b))
            else:
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
