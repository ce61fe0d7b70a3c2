"""SAM two-way transformer: two TwoWayAttentionBlocks (token self-attention,
token->image cross-attention with the heads' width halved, an MLP,
image->token cross-attention) and a final token->image attention, each
followed by a LayerNorm.

Counterpart of the JAX package's
``interactive_segmentation/models/segment_anything/transformer.py``. Plain
attention over at most a few thousand keys with a handful of queries: no
kernel. Its LayerNorms use eps 1e-6 (Flax's default; torch's is 1e-5).
Module names follow the reference torch layout (``layers.{i}.{self_attn,
cross_attn_token_to_image,cross_attn_image_to_token}.{q,k,v,out}_proj``,
``layers.{i}.mlp.{lin1,lin2}``, ``layers.{i}.norm1..4``,
``final_attn_token_to_image``, ``norm_final_attn``).
"""

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["SAMCrossAttention", "TwoWayAttentionBlock", "TwoWayTransformer"]


class SAMCrossAttention(nn.Module):
    def __init__(self, planes, head_nums, downsample_rate=1):
        super().__init__()
        internal = planes // downsample_rate
        self.head_nums = head_nums
        self.q_proj = nn.Linear(planes, internal)
        self.k_proj = nn.Linear(planes, internal)
        self.v_proj = nn.Linear(planes, internal)
        self.out_proj = nn.Linear(internal, planes)

    def forward(self, q, k, v):
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, nq, internal = q.shape
        nh = self.head_nums
        hd = internal // nh
        q = q.reshape(b, nq, nh, hd)
        k = k.reshape(b, -1, nh, hd)
        v = v.reshape(b, -1, nh, hd)
        with torch.autocast(q.device.type, enabled=False):
            # fp32 scores and softmax, probabilities in v's dtype
            attn = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
            attn = torch.softmax(attn * hd ** -0.5, dim=-1).to(v.dtype)
            out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.out_proj(out.reshape(b, nq, internal))


class MLPBlock(nn.Module):
    """lin1 -> ReLU -> lin2 (the reference MLPBlock of the decoder)."""

    def __init__(self, planes, hidden_planes):
        super().__init__()
        self.lin1 = nn.Linear(planes, hidden_planes)
        self.lin2 = nn.Linear(hidden_planes, planes)

    def forward(self, x):
        return self.lin2(F.relu(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, planes=256, head_nums=8, mlp_planes=2048,
                 attention_downsample_rate=2, skip_first_layer_pe=False):
        super().__init__()
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = SAMCrossAttention(planes, head_nums, 1)
        self.norm1 = nn.LayerNorm(planes, eps=1e-6)
        self.cross_attn_token_to_image = SAMCrossAttention(
            planes, head_nums, attention_downsample_rate)
        self.norm2 = nn.LayerNorm(planes, eps=1e-6)
        self.mlp = MLPBlock(planes, mlp_planes)
        self.norm3 = nn.LayerNorm(planes, eps=1e-6)
        self.cross_attn_image_to_token = SAMCrossAttention(
            planes, head_nums, attention_downsample_rate)
        self.norm4 = nn.LayerNorm(planes, eps=1e-6)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q = queries + query_pe
        k = keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(
            q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))

        q = queries + query_pe
        k = keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q,
                                                                queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, block_nums=2, embedding_planes=256, head_nums=8,
                 mlp_planes=2048, attention_downsample_rate=2):
        super().__init__()
        self.layers = nn.ModuleList([
            TwoWayAttentionBlock(embedding_planes, head_nums, mlp_planes,
                                 attention_downsample_rate,
                                 skip_first_layer_pe=(i == 0))
            for i in range(block_nums)])
        self.final_attn_token_to_image = SAMCrossAttention(
            embedding_planes, head_nums, attention_downsample_rate)
        self.norm_final_attn = nn.LayerNorm(embedding_planes, eps=1e-6)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding [B, C, H, W]; image_pe [1 or B, C, H, W];
        point_embedding [B, N, C] -> (queries [B, N, C], keys [B, HW, C])."""
        b, c, h, w = image_embedding.shape
        keys = image_embedding.flatten(2).transpose(1, 2)
        key_pe = image_pe.flatten(2).transpose(1, 2).expand(b, h * w, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q = queries + point_embedding
        k = keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(
            q, k, keys))
        return queries, keys
