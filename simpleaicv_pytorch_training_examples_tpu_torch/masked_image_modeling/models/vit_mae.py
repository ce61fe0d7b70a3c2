"""MAE pretraining model: a ViT encoder over a random quarter of the
patches and a light decoder that predicts every patch's pixels.

Counterpart of the JAX package's ``masked_image_modeling/models/vit_mae.py``:
per-sample random masking by a stable argsort of uniform noise (75% of the
patches masked), fixed 2-D sine-cosine position encodings (a numpy table
with a zero row for the cls token, rounded to the compute dtype), a decoder
that puts mask tokens after the kept tokens and restores the patch order by
the inverse permutation, and a per-patch pixel head. ``forward(x, noise=None)``
returns ``(pred [B, L, p * p * 3], mask [B, L])``, 1 in ``mask`` marking a
masked patch.

The noise: in training it is drawn from the generator that the train step
attaches to the model's Dropout and DropPath layers (``RandomMasking`` is
one of them), seeded per micro-batch from (seed + 7, iteration,
micro-batch); in eval it is ``arange(L) / L``, which keeps the first
patches. A caller may pass its own ``noise`` [B, L].

dtype policy (as the JAX package): the patch embed, the blocks and their
LayerNorms compute in ``dtype`` over fp32 parameters; the decoder's ``fc``
runs in fp32 on an fp32 copy of its input. With ``use_fused_attention`` the
blocks route their attention as the ViT's do: head dim 64 or 128 to K1 (the
ViT-B/16 and ViT-L/16 encoders, 50 tokens), any other to K2 (every decoder
at head dim 32, ViT-H/14's encoder at 80 over 65 tokens).

Parameter names, in torch's idiom: ``encoder.patch_embed.proj``,
``encoder.cls_token``, ``encoder.blocks.{i}``, ``encoder.norm``,
``decoder.embed``, ``decoder.mask_token``, ``decoder.blocks.{i}``,
``decoder.norm``, ``decoder.fc``. The position tables are buffers kept out of
the state dict, as the JAX package keeps them out of its parameters; the
init (``init_weights_``) writes them too, so a model built on the meta
device and materialised with ``to_empty`` gets them from ``init_model``.
"""

import numpy as np
import torch
from torch import nn

from ...models.backbones.vit import TransformerEncoderLayer, run_blocks
from ...models.common import (Dropout, FusedLayerNorm, Linear, PatchEmbed,
                              _MaskedDrop, trunc_normal_)

__all__ = [
    "vit_base_patch16_224_mae_pretrain_model",
    "vit_large_patch16_224_mae_pretrain_model",
    "vit_huge_patch14_224_mae_pretrain_model",
]


def sincos_position_encoding_2d(embedding_planes: int, grid_size: int,
                                cls_token: bool = True) -> np.ndarray:
    """Fixed 2-D sine-cosine position embedding [1, N(+1), C]."""
    assert embedding_planes % 4 == 0
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first
    grid = np.stack(grid, axis=0).reshape(2, -1)  # [2, N]

    def encode_1d(planes, pos):
        omega = np.arange(planes // 2, dtype=np.float32) / (planes / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("n,d->nd", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb = np.concatenate([
        encode_1d(embedding_planes // 2, grid[0]),
        encode_1d(embedding_planes // 2, grid[1]),
    ], axis=1)  # [N, C]
    if cls_token:
        emb = np.concatenate(
            [np.zeros((1, embedding_planes), np.float32), emb], axis=0)
    return emb[None].astype(np.float32)


def _sincos_buffer(planes, grid_size):
    return torch.from_numpy(sincos_position_encoding_2d(planes, grid_size))


def _table_size(pos_embed):
    """(planes, grid size) of a [1, N + 1, C] table."""
    return pos_embed.shape[-1], int(round((pos_embed.shape[1] - 1) ** 0.5))


class RandomMasking(_MaskedDrop):
    """The masking noise [B, L]: uniform draws from the attached generator
    in training, ``arange(L) / L`` in eval."""

    def forward(self, b, n, device):
        if self.training:
            return torch.rand((b, n), generator=self.mask_generator,
                              device=device)
        return (torch.arange(n, dtype=torch.float32, device=device)
                / n).expand(b, n)


def _blocks(planes, block_nums, head_nums, feedforward_ratio, dropout_prob,
            dtype, use_fused_attention):
    return nn.ModuleList([
        TransformerEncoderLayer(planes, head_nums, feedforward_ratio,
                                dropout_prob, 0.0, dtype,
                                use_fused_attention=use_fused_attention)
        for _ in range(block_nums)])


class VITMAEPretrainModelEncoder(nn.Module):

    def __init__(self, patch_size, image_size, embedding_planes, block_nums,
                 head_nums, feedforward_ratio=4, mask_ratio=0.75,
                 dropout_prob=0.0, use_gradient_checkpoint=False,
                 dtype=torch.float32, use_fused_attention=False):
        super().__init__()
        self.mask_ratio = mask_ratio
        self.use_gradient_checkpoint = use_gradient_checkpoint
        self.patch_embed = PatchEmbed(3, embedding_planes, patch_size, dtype,
                                      xavier_uniform=True)
        self.register_buffer("pos_embed", _sincos_buffer(
            embedding_planes, image_size // patch_size), persistent=False)
        self.masking = RandomMasking()
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embedding_planes))
        self.pos_drop = Dropout(dropout_prob)
        self.blocks = _blocks(embedding_planes, block_nums, head_nums,
                              feedforward_ratio, dropout_prob, dtype,
                              use_fused_attention)
        self.norm = FusedLayerNorm(embedding_planes, 1e-6, dtype)

    @torch.no_grad()
    def init_weights_(self, generator):
        trunc_normal_(self.cls_token, 0.02, generator)
        self.pos_embed.copy_(_sincos_buffer(*_table_size(self.pos_embed)))

    def forward(self, x, noise=None):
        b = x.shape[0]
        x = self.patch_embed(x).flatten(2).transpose(1, 2)  # [B, N, C]
        _, n, c = x.shape
        pos_embed = self.pos_embed.to(x.dtype)
        x = x + pos_embed[:, 1:]

        # per-sample random masking by a stable argsort of the noise
        keep_length = int(n * (1.0 - self.mask_ratio))
        if noise is None:
            noise = self.masking(b, n, x.device)
        shuffle_ids = torch.argsort(noise, dim=1, stable=True)
        restore_ids = torch.argsort(shuffle_ids, dim=1, stable=True)
        keep_ids = shuffle_ids[:, :keep_length]
        x = torch.gather(x, 1, keep_ids[:, :, None].expand(-1, -1, c))

        mask = torch.ones((b, n), dtype=x.dtype, device=x.device)
        mask[:, :keep_length] = 0.0
        mask = torch.gather(mask, 1, restore_ids)

        cls = self.cls_token.to(x.dtype) + pos_embed[:, :1]
        x = torch.cat([cls.expand(b, -1, -1), x], dim=1)
        x = run_blocks(self.blocks, self.pos_drop(x),
                       self.use_gradient_checkpoint)
        return self.norm(x), mask, restore_ids


class VITMAEPretrainModelDecoder(nn.Module):

    def __init__(self, patch_size, image_size, inplanes, embedding_planes,
                 block_nums, head_nums, feedforward_ratio=4, dropout_prob=0.0,
                 use_gradient_checkpoint=False, dtype=torch.float32,
                 use_fused_attention=False):
        super().__init__()
        self.use_gradient_checkpoint = use_gradient_checkpoint
        self.embed = Linear(inplanes, embedding_planes, dtype)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embedding_planes))
        self.register_buffer("pos_embed", _sincos_buffer(
            embedding_planes, image_size // patch_size), persistent=False)
        self.blocks = _blocks(embedding_planes, block_nums, head_nums,
                              feedforward_ratio, dropout_prob, dtype,
                              use_fused_attention)
        self.norm = FusedLayerNorm(embedding_planes, 1e-6, dtype)
        self.fc = Linear(embedding_planes, patch_size ** 2 * 3,
                         torch.float32)

    @torch.no_grad()
    def init_weights_(self, generator):
        trunc_normal_(self.mask_token, 0.02, generator)
        self.pos_embed.copy_(_sincos_buffer(*_table_size(self.pos_embed)))

    def forward(self, x, restore_ids):
        b = x.shape[0]
        x = self.embed(x)
        c = x.shape[-1]
        n_masked = restore_ids.shape[1] + 1 - x.shape[1]
        mask_tokens = self.mask_token.to(x.dtype).expand(b, n_masked, c)
        x_ = torch.cat([x[:, 1:], mask_tokens], dim=1)
        x_ = torch.gather(x_, 1, restore_ids[:, :, None].expand(-1, -1, c))
        x = torch.cat([x[:, :1], x_], dim=1)
        x = x + self.pos_embed.to(x.dtype)
        x = run_blocks(self.blocks, x, self.use_gradient_checkpoint)
        x = self.fc(self.norm(x).float())
        return x[:, 1:]  # drop cls


class VITMAEPretrainModel(nn.Module):

    def __init__(self, patch_size=16, image_size=224, mask_ratio=0.75,
                 encoder_embedding_planes=768, encoder_block_nums=12,
                 encoder_head_nums=12, encoder_feedforward_ratio=4,
                 encoder_dropout_prob=0.0, decoder_embedding_planes=512,
                 decoder_block_nums=8, decoder_head_nums=16,
                 decoder_feedforward_ratio=4, decoder_dropout_prob=0.0,
                 use_gradient_checkpoint=False, dtype=torch.float32,
                 use_fused_attention=False):
        super().__init__()
        self.encoder = VITMAEPretrainModelEncoder(
            patch_size, image_size, encoder_embedding_planes,
            encoder_block_nums, encoder_head_nums, encoder_feedforward_ratio,
            mask_ratio, encoder_dropout_prob, use_gradient_checkpoint, dtype,
            use_fused_attention)
        self.decoder = VITMAEPretrainModelDecoder(
            patch_size, image_size, encoder_embedding_planes,
            decoder_embedding_planes, decoder_block_nums, decoder_head_nums,
            decoder_feedforward_ratio, decoder_dropout_prob,
            use_gradient_checkpoint, dtype, use_fused_attention)

    def forward(self, x, noise=None):
        latents, mask, restore_ids = self.encoder(x, noise)
        return self.decoder(latents, restore_ids), mask


def _vitmaepretrainmodel(**kwargs):
    return VITMAEPretrainModel(**kwargs)


def vit_base_patch16_224_mae_pretrain_model(**kwargs):
    return _vitmaepretrainmodel(
        patch_size=16, image_size=224, encoder_embedding_planes=768,
        encoder_block_nums=12, encoder_head_nums=12,
        decoder_embedding_planes=512, decoder_block_nums=8,
        decoder_head_nums=16, **kwargs)


def vit_large_patch16_224_mae_pretrain_model(**kwargs):
    return _vitmaepretrainmodel(
        patch_size=16, image_size=224, encoder_embedding_planes=1024,
        encoder_block_nums=24, encoder_head_nums=16,
        decoder_embedding_planes=512, decoder_block_nums=8,
        decoder_head_nums=16, **kwargs)


def vit_huge_patch14_224_mae_pretrain_model(**kwargs):
    return _vitmaepretrainmodel(
        patch_size=14, image_size=224, encoder_embedding_planes=1280,
        encoder_block_nums=32, encoder_head_nums=16,
        decoder_embedding_planes=512, decoder_block_nums=8,
        decoder_head_nums=16, **kwargs)
