"""Shared transformer building blocks (NCHW images, [B, N, C] tokens).

Counterpart of the JAX package's ``models/common.py``, with its dtype
policy: parameters stay fp32 and each layer computes in ``dtype`` (bf16 in
the configs), casting its input and weights on the way in, as flax's
``Dense(dtype=...)`` does.

Parameters are set by ``init_parameters_`` from a ``torch.Generator`` (the
engine's ``init_model`` seeds it from the config), with flax's initialisers:
truncated normals for weights, zeros for biases, ones for norm scales.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.fused_attention import (DENSE_HEAD_DIMS, MAX_HEAD_DIM,
                                           MAX_TOKENS, fused_attention,
                                           fused_attention_dense)

__all__ = ["trunc_normal_", "init_parameters_", "Dropout", "DropPath",
           "PatchEmbed", "FusedLayerNorm", "Linear", "Mlp",
           "MultiHeadSelfAttention"]

# standard deviation of N(0, 1) truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def trunc_normal_(tensor, std, generator=None):
    """flax ``truncated_normal(stddev=std)``: N(0, 1) truncated to [-2, 2],
    scaled so the result has standard deviation ``std`` (inverse-CDF
    sampling, as ``torch.nn.init.trunc_normal_``)."""
    lo = (1.0 + math.erf(-2.0 / math.sqrt(2.0))) / 2.0
    hi = (1.0 + math.erf(2.0 / math.sqrt(2.0))) / 2.0
    tensor.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
    tensor.erfinv_()
    scale = std / _TRUNC_STD
    tensor.mul_(scale * math.sqrt(2.0))
    return tensor.clamp_(-2.0 * scale, 2.0 * scale)


def init_parameters_(model, generator):
    """Initialise every parameter of ``model`` from ``generator``: each
    submodule with an ``init_weights_`` method sets its own parameters, in
    ``model.modules()`` order."""
    for module in model.modules():
        if hasattr(module, "init_weights_"):
            module.init_weights_(generator)
    return model


# The JAX package's train-only Dropout (x * mask / keep) is torch's own.
Dropout = nn.Dropout


class DropPath(nn.Module):
    """Stochastic depth over the batch dim (train only)."""

    def __init__(self, drop_path_prob=0.0, scale_by_keep=True):
        super().__init__()
        self.drop_path_prob = drop_path_prob
        self.scale_by_keep = scale_by_keep

    def forward(self, x):
        if self.drop_path_prob == 0.0 or not self.training:
            return x
        keep = 1.0 - self.drop_path_prob
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = x.new_empty(shape).bernoulli_(keep)
        if self.scale_by_keep and keep > 0.0:
            mask = mask / keep
        return x * mask


class Linear(nn.Linear):
    """``nn.Linear`` over fp32 parameters that computes in ``dtype``."""

    def __init__(self, in_features, out_features, dtype=torch.float32,
                 init_std=0.02):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype
        self.init_std = init_std

    def init_weights_(self, generator):
        trunc_normal_(self.weight, self.init_std, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dtype = self.compute_dtype
        return F.linear(x.to(dtype), self.weight.to(dtype),
                        self.bias.to(dtype))


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding: a strided convolution, NCHW in,
    [B, planes, H/P, W/P] out, computed in ``dtype``."""

    def __init__(self, in_planes, planes, patch_size, dtype=torch.float32):
        super().__init__()
        self.proj = nn.Conv2d(in_planes, planes, patch_size, stride=patch_size)
        self.patch_size = patch_size
        self.compute_dtype = dtype

    def init_weights_(self, generator):
        trunc_normal_(self.proj.weight, 0.02, generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x):
        dtype = self.compute_dtype
        return F.conv2d(x.to(dtype), self.proj.weight.to(dtype),
                        self.proj.bias.to(dtype), stride=self.patch_size)


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 statistics; the input is cast
    to ``dtype`` first and the output is in ``dtype``. The fused kernel
    (``use_fused=True``, kernel K7) is not ported yet."""

    def __init__(self, planes, eps=1e-6, dtype=torch.float32, use_fused=False):
        super().__init__()
        if use_fused:
            raise NotImplementedError(
                "the fused LayerNorm kernel (K7) is not ported yet")
        self.weight = nn.Parameter(torch.ones(planes))
        self.bias = nn.Parameter(torch.zeros(planes))
        self.eps = eps
        self.compute_dtype = dtype

    def init_weights_(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x = x.to(self.compute_dtype)
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class Mlp(nn.Module):
    """Transformer feed-forward: Linear -> GELU (tanh) -> Linear (+dropout).

    flax ``nn.gelu`` defaults to the tanh approximation, so torch's exact
    erf GELU would not match the JAX package."""

    def __init__(self, planes, hidden_planes, dropout_prob=0.0,
                 dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(planes, hidden_planes, dtype)
        self.fc2 = Linear(hidden_planes, planes, dtype)
        self.drop = Dropout(dropout_prob)

    def forward(self, x):
        x = F.gelu(self.fc1(x), approximate="tanh")
        x = self.drop(x)
        return self.drop(self.fc2(x))


class MultiHeadSelfAttention(nn.Module):
    """Multi-head self-attention over [B, N, C] tokens with one fused qkv
    projection (column order [3, H, D]).

    With ``use_fused_attention`` the attention core runs one kernel, by the
    JAX package's shape rules: head dim 64 or 128 with 8 <= N <= 1024 takes
    K1 straight over the [B, N, 3C] qkv output; any other head dim takes K2
    on [B, H, N, D] while D <= 128 and N <= 1024. Larger shapes run the
    eager path with an fp32 softmax, which is the math of the JAX fallback.
    Without fused attention, or in training with attention dropout, the
    eager path computes the softmax in ``softmax_dtype`` and casts the
    probabilities to ``dtype``.
    """

    def __init__(self, planes, head_nums, dropout_prob=0.0,
                 dtype=torch.float32, softmax_dtype=torch.float32,
                 use_fused_attention=False):
        super().__init__()
        self.head_nums = head_nums
        self.dropout_prob = dropout_prob
        self.compute_dtype = dtype
        self.softmax_dtype = softmax_dtype
        self.use_fused_attention = use_fused_attention
        self.qkv = Linear(planes, 3 * planes, dtype)
        self.attn_drop = Dropout(dropout_prob)
        self.proj = Linear(planes, planes, dtype)
        self.proj_drop = Dropout(dropout_prob)

    def forward(self, x):
        b, n, c = x.shape
        h = self.head_nums
        d = c // h
        qkv = self.qkv(x)
        fuse = self.use_fused_attention and not (
            self.training and self.dropout_prob > 0.0)
        if fuse and d in DENSE_HEAD_DIMS and 8 <= n <= MAX_TOKENS:
            out = fused_attention_dense(qkv, h)
        elif fuse and d <= MAX_HEAD_DIM and n <= MAX_TOKENS:
            # [B, H, N, D] views of the qkv output: K2 reads them in place
            q, k, v = qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
            out = fused_attention(q, k, v).transpose(1, 2).reshape(b, n, c)
        else:
            out = self._eager(qkv, torch.float32 if fuse else
                              self.softmax_dtype)
        return self.proj_drop(self.proj(out))

    def _eager(self, qkv, softmax_dtype):
        b, n, c3 = qkv.shape
        d = c3 // (3 * self.head_nums)
        q, k, v = qkv.reshape(b, n, 3, self.head_nums, d).unbind(2)
        attn = torch.einsum("bnhd,bmhd->bhnm", q.to(softmax_dtype),
                            k.to(softmax_dtype)) * d ** -0.5
        attn = torch.softmax(attn, dim=-1).to(self.compute_dtype)
        attn = self.attn_drop(attn)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v)
        return out.reshape(b, n, c3 // 3)
