"""Shared building blocks (NCHW images, [B, N, C] tokens): the transformer
layers, and the convolution, BatchNorm and pooling layers of the ResNets.

Counterpart of the JAX package's ``models/common.py``, with its dtype
policy: parameters stay fp32 and each layer computes in ``dtype`` (bf16 in
the configs), casting its input and weights on the way in, as Flax's
``Dense(dtype=...)`` does.

Parameters are set by ``init_parameters_`` from a ``torch.Generator`` (the
engine's ``init_model`` seeds it from the config), with Flax's initialisers:
truncated normals for weights, zeros for biases, ones for norm scales.

``Dropout`` and ``DropPath`` draw their masks from the generator that
``attach_mask_generator`` hands them (the train step owns one and seeds it
per micro-batch from the config seed and the global iteration), so the
global RNG state is left alone and a resumed run draws what an
uninterrupted one would. Without one they draw from torch's default
generator.
"""

import contextlib
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.kernels.fused_attention import (DENSE_HEAD_DIMS, MAX_HEAD_DIM,
                                           MAX_TOKENS, fused_attention,
                                           fused_attention_dense)
from ..ops.kernels.layer_norm import layer_norm
from ..parallel.mesh import world_size

__all__ = ["trunc_normal_", "init_parameters_", "attach_mask_generator",
           "Dropout", "DropPath", "drop_path_rates", "remat_call",
           "PatchEmbed", "FusedLayerNorm", "Linear", "Mlp",
           "MultiHeadSelfAttention", "Conv2d", "BatchNorm2d", "ConvBnAct",
           "max_pool", "avg_pool_global", "batch_stat_buffers",
           "frozen_batch_stats"]

# standard deviation of N(0, 1) truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def trunc_normal_(tensor, std, generator=None):
    """Flax's ``truncated_normal(stddev=std)``: N(0, 1) truncated to [-2, 2],
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


class _MaskedDrop(nn.Module):
    """Base of the layers that draw from the train step's generator in
    training (a keep mask; DINOv3's RoPE coordinate rescale)."""

    mask_generator = None  # torch's default generator until one is attached

    def keep_mask(self, x, shape, keep):
        """0/1 mask of ``shape`` in x's dtype, 1 with probability ``keep``."""
        mask = torch.empty(shape, dtype=torch.float32, device=x.device)
        return mask.bernoulli_(keep, generator=self.mask_generator).to(x.dtype)


def attach_mask_generator(model, generator):
    """Make every Dropout and DropPath of ``model`` draw from ``generator``
    (a ``torch.Generator`` on the model's device)."""
    for module in model.modules():
        if isinstance(module, _MaskedDrop):
            module.mask_generator = generator


class Dropout(_MaskedDrop):
    """Inverted dropout, x * mask / keep (train only)."""

    def __init__(self, dropout_prob=0.0):
        super().__init__()
        self.dropout_prob = dropout_prob

    def forward(self, x):
        if self.dropout_prob == 0.0 or not self.training:
            return x
        keep = 1.0 - self.dropout_prob
        return x * self.keep_mask(x, x.shape, keep) / keep


class DropPath(_MaskedDrop):
    """Stochastic depth over the batch dim (train only)."""

    def __init__(self, drop_path_prob=0.0, scale_by_keep=True):
        super().__init__()
        self.drop_path_prob = drop_path_prob
        self.scale_by_keep = scale_by_keep

    def forward(self, x):
        if self.drop_path_prob == 0.0 or not self.training:
            return x
        keep = 1.0 - self.drop_path_prob
        mask = self.keep_mask(x, (x.shape[0],) + (1,) * (x.ndim - 1), keep)
        if self.scale_by_keep and keep > 0.0:
            mask = mask / keep
        return x * mask


def drop_path_rates(drop_path_prob, total_blocks):
    """Linear drop-path schedule over all blocks, ``p * i / (n - 1)``."""
    if total_blocks <= 1:
        return [0.0] * total_blocks
    return [drop_path_prob * i / (total_blocks - 1)
            for i in range(total_blocks)]


class Linear(nn.Linear):
    """``nn.Linear`` over fp32 parameters that computes in ``dtype``."""

    def __init__(self, in_features, out_features, dtype=torch.float32,
                 init_std=0.02, bias=True):
        super().__init__(in_features, out_features, bias)
        self.compute_dtype = dtype
        self.init_std = init_std

    def init_weights_(self, generator):
        trunc_normal_(self.weight, self.init_std, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dtype = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class PatchEmbed(nn.Module):
    """Non-overlapping patch embedding: a strided convolution, NCHW in,
    [B, planes, H/P, W/P] out, computed in ``dtype``. The kernel starts
    from a truncated normal of std 0.02, or with ``xavier_uniform`` from
    Flax's ``xavier_uniform()`` (MAE's encoder)."""

    def __init__(self, in_planes, planes, patch_size, dtype=torch.float32,
                 xavier_uniform=False):
        super().__init__()
        self.proj = nn.Conv2d(in_planes, planes, patch_size, stride=patch_size)
        self.patch_size = patch_size
        self.compute_dtype = dtype
        self.xavier_uniform = xavier_uniform

    def init_weights_(self, generator):
        if self.xavier_uniform:
            nn.init.xavier_uniform_(self.proj.weight, generator=generator)
        else:
            trunc_normal_(self.proj.weight, 0.02, generator)
        nn.init.zeros_(self.proj.bias)

    def forward(self, x):
        dtype = self.compute_dtype
        return F.conv2d(x.to(dtype), self.proj.weight.to(dtype),
                        self.proj.bias.to(dtype), stride=self.patch_size)


class FusedLayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 statistics and fp32 scale and
    bias; the input is cast to ``dtype`` first and the output is in
    ``dtype``. With ``use_fused`` it runs the fused kernel K7, which reads
    and writes ``dtype`` and keeps no fp32 copy of the activation; without,
    stock torch ops on an fp32 copy."""

    def __init__(self, planes, eps=1e-6, dtype=torch.float32, use_fused=False):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(planes))
        self.bias = nn.Parameter(torch.zeros(planes))
        self.eps = eps
        self.compute_dtype = dtype
        self.use_fused = use_fused

    def init_weights_(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x = x.to(self.compute_dtype)
        if self.use_fused:
            return layer_norm(x, self.weight, self.bias, self.eps)
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class Mlp(nn.Module):
    """Transformer feed-forward: Linear -> GELU (tanh) -> Linear (+dropout).

    Flax's ``nn.gelu`` defaults to the tanh approximation, so torch's exact
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


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` over fp32 parameters that computes in ``dtype``;
    weights start from Flax's ``variance_scaling(2.0, "fan_out",
    "truncated_normal")`` (the JAX package's ``kaiming_normal_conv``), or
    from a truncated normal of std ``init_std`` where that is given."""

    def __init__(self, inplanes, planes, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, bias=True, dtype=torch.float32,
                 init_std=None):
        super().__init__(inplanes, planes, kernel_size, stride, padding,
                         dilation, groups, bias)
        self.compute_dtype = dtype
        self.init_std = init_std

    def init_weights_(self, generator):
        kh, kw = self.kernel_size
        std = self.init_std if self.init_std is not None else \
            math.sqrt(2.0 / (kh * kw * self.out_channels))
        trunc_normal_(self.weight, std, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dtype = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.conv2d(x.to(dtype), self.weight.to(dtype), bias,
                        self.stride, self.padding, self.dilation, self.groups)


class BatchNorm2d(nn.Module):
    """Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW.

    In training it normalises by the batch's mean and *biased* variance
    (fp32 statistics, fp32 scale and bias, output in ``dtype``) and moves
    the running statistics by ``r = momentum * r + (1 - momentum) * batch``
    with that same biased variance, as Flax does. ``nn.BatchNorm2d`` takes
    the unbiased variance into ``running_var`` and reads ``momentum`` the
    other way round (the share of the new value), so it is not used here.
    In eval it normalises by the running statistics. While
    ``update_stats`` is False (a checkpointed block's recompute,
    ``frozen_batch_stats``), training leaves the running statistics alone.
    The buffers keep torch's names, ``num_batches_tracked`` included, so a
    torch ResNet checkpoint loads as it is.

    The statistics are the global batch's, as under the JAX package's
    ``jit`` over a sharded batch: in a world of more than one process
    (``parallel/mesh.py``) training runs ``_global_batch_norm``, which
    reduces them over the world and whose backward reduces their gradients,
    on any device (NCCL and ``gloo`` run the same code); one process,
    torchrun at world size 1 included, runs ``native_batch_norm``, so that
    run computes what a run without torchrun does, bit for bit."""

    def __init__(self, planes, momentum=0.9, eps=1e-5, dtype=torch.float32):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.compute_dtype = dtype
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(planes))
        self.bias = nn.Parameter(torch.zeros(planes))
        self.register_buffer("running_mean", torch.zeros(planes))
        self.register_buffer("running_var", torch.ones(planes))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    @torch.no_grad()
    def init_weights_(self, generator):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.num_batches_tracked.zero_()

    def forward(self, x):
        x = x.to(self.compute_dtype)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if world_size() > 1:
            y, mean, invstd = _global_batch_norm(x, self.weight, self.bias,
                                                 self.eps)
        else:
            y, mean, invstd = torch.native_batch_norm(
                x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        if self.update_stats:
            with torch.no_grad():
                var = invstd.float().pow(-2) - self.eps
                keep = self.momentum
                self.running_mean.mul_(keep).add_(mean.float(),
                                                  alpha=1.0 - keep)
                self.running_var.mul_(keep).add_(var, alpha=1.0 - keep)
                self.num_batches_tracked.add_(1)
        return y


class _AllReduceSum(torch.autograd.Function):
    """Sum over the world; its gradient is the world's sum of the
    gradients."""

    @staticmethod
    def forward(ctx, x):
        x = x.clone()
        dist.all_reduce(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def _global_batch_norm(x, weight, bias, eps):
    """Training BatchNorm over the global batch, in autograd ops on any
    device: the fp32 sums of x and of its squared deviations are reduced
    over the world by a differentiable ``all_reduce``. Returns (y, mean,
    invstd)."""
    all_reduce = _AllReduceSum.apply
    xf = x.float()
    c = x.shape[1]
    axes = (0, 2, 3)
    packed = torch.cat([xf.sum(axes), xf.new_full((1,), xf.numel() // c)])
    packed = all_reduce(packed)
    mean, count = packed[:c] / packed[c], packed[c]
    centred = xf - mean[None, :, None, None]
    var = all_reduce(centred.square().sum(axes)) / count
    invstd = torch.rsqrt(var + eps)
    scale = (invstd * weight)[None, :, None, None]
    y = centred * scale + bias[None, :, None, None]
    return y.to(x.dtype), mean.detach(), invstd.detach()


def batch_stat_buffers(model):
    """The buffers that a train forward of ``model`` moves: those of its
    ``BatchNorm2d`` layers, in ``model.modules()`` order."""
    return [b for m in model.modules() if isinstance(m, BatchNorm2d)
            for b in m.buffers()]


@contextlib.contextmanager
def frozen_batch_stats(module):
    """Within the block, ``module``'s BatchNorm layers leave their running
    statistics alone: the recompute of a checkpointed block, whose first
    forward already moved them."""
    layers = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    before = [m.update_stats for m in layers]
    for m in layers:
        m.update_stats = False
    try:
        yield
    finally:
        for m, flag in zip(layers, before):
            m.update_stats = flag


def remat_call(block, *args):
    """``block(*args)`` under non-reentrant ``torch.utils.checkpoint`` (the
    JAX package's ``nn.remat``): the recompute draws the Dropout / DropPath
    masks of the original forward (their generators' states put back for it)
    and leaves the BatchNorm running statistics alone."""
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
            with frozen_batch_stats(block):
                yield
        finally:
            for g, state in zip(generators, now):
                g.set_state(state)

    return checkpoint(block, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          recompute()))


class ConvBnAct(nn.Module):
    """Convolution, BatchNorm and activation, the JAX package's
    ``ConvBnAct`` in the reference torch layout: ``layer.0`` the
    convolution (with a bias only without BatchNorm), ``layer.1`` the
    BatchNorm. ``stride`` may be a pair ((2, 1) keeps the width)."""

    def __init__(self, inplanes, planes, kernel_size=3, stride=1, padding=1,
                 groups=1, has_bn=True, has_act=True, act=F.relu,
                 dilation=1, dtype=torch.float32):
        super().__init__()
        layers = [Conv2d(inplanes, planes, kernel_size,
                         tuple(stride) if isinstance(stride, (tuple, list))
                         else stride, padding, dilation, groups,
                         bias=not has_bn, dtype=dtype)]
        if has_bn:
            layers.append(BatchNorm2d(planes, dtype=dtype))
        self.layer = nn.Sequential(*layers)
        self.act = act if has_act else None

    def forward(self, x):
        x = self.layer(x)
        return x if self.act is None else self.act(x)


def max_pool(x, window, stride, padding=0):
    """Max pool over NCHW with -inf padding, as Flax's ``nn.max_pool``."""
    return F.max_pool2d(x, window, stride, padding)


def avg_pool_global(x):
    """Global average pool NCHW -> [B, C]."""
    return x.mean(dim=(2, 3))
