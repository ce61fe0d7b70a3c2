"""SAM mask decoder: an IoU token and four mask tokens in front of the
sparse prompts, the two-way transformer, 4x transposed-convolution
upscaling, one hypernetwork MLP a mask token, and the IoU-prediction MLP.

Counterpart of the JAX package's
``interactive_segmentation/models/segment_anything/mask_decoder.py``; module
names follow the reference torch layout (``iou_token``, ``mask_tokens``,
``transformer``, ``output_upscaling.{0,1,3}``,
``output_hypernetworks_mlps.{i}.layers.{j}``,
``iou_prediction_head.layers.{j}``). The upscaling convolutions are torch
``ConvTranspose2d``s, whose kernel is the spatial flip of Flax's
``ConvTranspose`` kernel (``utils/jax_weights.py`` flips it on the way in).
"""

import torch
import torch.nn.functional as F
from torch import nn

from .image_encoder import LayerNorm2d
from .transformer import TwoWayTransformer

__all__ = ["MLP", "MaskDecoder"]


class MLP(nn.Module):
    """Linears ``layers.{i}`` with ``activation`` (ReLU; SAM2's Hiera uses
    the exact GELU) between them."""

    def __init__(self, inplanes, hidden_planes, planes, layer_nums,
                 activation=F.relu):
        super().__init__()
        dims = [inplanes] + [hidden_planes] * (layer_nums - 1) + [planes]
        self.layers = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:])])
        self.activation = activation

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.activation(x)
        return x


class MaskDecoder(nn.Module):
    def __init__(self, inplanes=256, num_multimask_outputs=3,
                 iou_prediction_head_block_nums=3,
                 iou_prediction_head_hidden_planes=256):
        super().__init__()
        c = inplanes
        self.num_mask_tokens = num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, c)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, c)
        self.transformer = TwoWayTransformer(2, c, 8, 2048)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(c, c // 4, 2, stride=2), LayerNorm2d(c // 4),
            nn.GELU(), nn.ConvTranspose2d(c // 4, c // 8, 2, stride=2),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            [MLP(c, c, c // 8, 3) for _ in range(self.num_mask_tokens)])
        self.iou_prediction_head = MLP(c, iou_prediction_head_hidden_planes,
                                       self.num_mask_tokens,
                                       iou_prediction_head_block_nums)

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, mask_out_idxs=(0, 1, 2, 3)):
        """image_embeddings [Bi, C, h, w] (Bi = 1 is repeated over the
        prompts' batch), image_pe [1, C, h, w], sparse [B, n, C], dense
        [B, C, h, w] -> (mask logits [B, T, 4h, 4w], iou predictions [B, T])
        for the T = len(mask_out_idxs) selected mask tokens."""
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
        x = self.output_upscaling(src.transpose(1, 2).reshape(b, c, h, w))
        hyper_in = torch.stack([mlp(mask_tokens_out[:, i]) for i, mlp in
                                enumerate(self.output_hypernetworks_mlps)],
                               dim=1)                      # [B, T, c / 8]
        mask_preds = torch.einsum("btc,bchw->bthw", hyper_in, x.to(
            hyper_in.dtype))
        iou_preds = self.iou_prediction_head(iou_token_out)
        idxs = list(mask_out_idxs)
        if idxs == list(range(idxs[0], idxs[-1] + 1)):  # a slice: no index
            idxs = slice(idxs[0], idxs[-1] + 1)         # tensor to copy
        return mask_preds[:, idxs], iou_preds[:, idxs]
