"""SAM prompt encoder: random-Fourier position encoding (a fixed Gaussian
matrix, kept as a buffer), four learned point embeddings (negative point,
positive point, box corner 1, box corner 2), not-a-point and no-mask
embeddings, and the convolutional mask downscaler.

Counterpart of the JAX package's
``interactive_segmentation/models/segment_anything/prompt_encoder.py``,
with its fixed-shape prompts: points [B, N, 3] (x, y, label; label -1 pads),
boxes [B, 4] with a [B] validity flag, masks [B, 1, H/4, W/4] with a [B]
validity flag. Module names follow the reference torch layout
(``point_embeddings.{0..3}``, ``not_a_point_embed``, ``no_mask_embed``,
``mask_downscaling.{0,1,3,4,6}``,
``pe_layer.positional_encoding_gaussian_matrix``).
"""

import math

import torch
from torch import nn

from .image_encoder import LayerNorm2d

__all__ = ["PositionEmbeddingRandom", "PromptEncoder"]


class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats=128, seed=2023):
        super().__init__()
        self.register_buffer(
            "positional_encoding_gaussian_matrix",
            torch.randn((2, num_pos_feats),
                        generator=torch.Generator().manual_seed(seed)))

    def pe_encoding(self, coords):
        """coords in [0, 1], [..., 2] (x, y) -> [..., 2 * num_pos_feats],
        in fp32 whatever autocast is on."""
        with torch.autocast(coords.device.type, enabled=False):
            coords = 2 * coords.float() - 1
            coords = coords @ self.positional_encoding_gaussian_matrix.float()
            coords = 2 * math.pi * coords
            return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)

    def grid_pe(self, size):
        """[size, size, C] encoding of the cell centres."""
        device = self.positional_encoding_gaussian_matrix.device
        ys = (torch.arange(size, dtype=torch.float32, device=device)
              + 0.5) / size
        gy, gx = torch.meshgrid(ys, ys, indexing="ij")
        return self.pe_encoding(torch.stack([gx, gy], dim=-1))

    def forward_with_coords(self, coords, image_size):
        return self.pe_encoding(coords / image_size)


class PromptEncoder(nn.Module):
    def __init__(self, image_size=1024, patch_size=16, embedding_planes=256,
                 mask_inter_planes=16):
        super().__init__()
        self.image_size = image_size
        self.image_embedding_size = image_size // patch_size
        self.embedding_planes = embedding_planes
        self.pe_layer = PositionEmbeddingRandom(embedding_planes // 2)
        self.point_embeddings = nn.ModuleList(
            [nn.Embedding(1, embedding_planes) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, embedding_planes)
        self.no_mask_embed = nn.Embedding(1, embedding_planes)
        q = mask_inter_planes
        self.mask_downscaling = nn.Sequential(
            nn.Conv2d(1, q // 4, 2, stride=2), LayerNorm2d(q // 4), nn.GELU(),
            nn.Conv2d(q // 4, q, 2, stride=2), LayerNorm2d(q), nn.GELU(),
            nn.Conv2d(q, embedding_planes, 1))

    def get_dense_pe_layer(self):
        """[1, C, H/P, W/P] position encoding of the embedding grid."""
        return self.pe_layer.grid_pe(self.image_embedding_size).permute(
            2, 0, 1)[None]

    def forward(self, points, boxes, masks, boxes_valid=None,
                masks_valid=None):
        """points [B, N, 3] or None; boxes [B, 4] or None; masks [B, 1, Hm,
        Wm] or None; *_valid [B] flags (1 = use). Returns sparse [B, n, C]
        and dense [B, C, H/P, W/P] embeddings."""
        ref = next(t for t in (points, boxes, masks) if t is not None)
        batch, device = ref.shape[0], ref.device
        embed = [e.weight[0] for e in self.point_embeddings]
        not_a_point = self.not_a_point_embed.weight[0]

        sparse = []
        if points is not None:
            coords = points[..., 0:2].float() + 0.5
            labels = points[..., 2]
            if boxes is None:  # one not-a-point pad token, as the reference
                coords = torch.cat([coords, torch.zeros(batch, 1, 2,
                                                        device=device)], 1)
                labels = torch.cat([labels, -torch.ones(batch, 1,
                                                        device=device)], 1)
            pe = self.pe_layer.forward_with_coords(coords, self.image_size)
            labels = labels[..., None]
            pe = torch.where(labels == -1, not_a_point, pe)
            pe = pe + torch.where(labels == 0, embed[0], 0.0)
            pe = pe + torch.where(labels == 1, embed[1], 0.0)
            sparse.append(pe)
        if boxes is not None:
            corners = boxes.float().reshape(-1, 2, 2) + 0.5
            ce = self.pe_layer.forward_with_coords(corners, self.image_size)
            ce = ce + torch.stack([embed[2], embed[3]])
            if boxes_valid is not None:  # invalid boxes become pad tokens
                ce = torch.where(boxes_valid[:, None, None] > 0, ce,
                                 not_a_point)
            sparse.append(ce)
        sparse = torch.cat(sparse, dim=1) if sparse else torch.zeros(
            batch, 0, self.embedding_planes, device=device)

        s = self.image_embedding_size
        # the downscaler always runs (fixed-shape prompts): no mask is
        # masks_valid = 0, not a skipped branch
        if masks is None:
            masks = torch.zeros(batch, 1, 4 * s, 4 * s, device=device)
            masks_valid = torch.zeros(batch, device=device)
        dense = self.mask_downscaling(masks)
        if masks_valid is not None:
            no_mask = self.no_mask_embed.weight.reshape(1, -1, 1, 1)
            dense = torch.where(masks_valid[:, None, None, None] > 0, dense,
                                no_mask.to(dense.dtype))
        return sparse, dense
