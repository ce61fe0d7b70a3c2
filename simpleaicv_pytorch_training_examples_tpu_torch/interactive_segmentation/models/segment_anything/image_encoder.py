"""SAM ViT image encoder: 16x16 patch embedding, a learned absolute position
embedding over the token grid, transformer blocks with 14x14 windowed
attention except the global-attention blocks, decomposed relative-position
bias (separate H and W tables), and a LayerNorm2d neck to 256 channels.

Counterpart of the JAX package's
``interactive_segmentation/models/segment_anything/image_encoder.py``, with
the module names of the reference torch layout (``patch_embed.proj``,
``pos_embed``, ``blocks.N.{norm1,attn.{qkv,proj,rel_pos_h,rel_pos_w},norm2,
mlp.{lin1,lin2}}``, ``neck.{0,1,2,3}``), so a reference SAM checkpoint
loads by name. Images come in NCHW; the blocks work on [B, H, W, C] tokens;
the embedding leaves as [B, 256, H/16, W/16].

With ``use_flash_attention`` the attention core takes a kernel by the JAX
package's rules: windowed blocks (N <= 1024) whose head dim is 64 or 128
and whose width is a multiple of 128 take K3 straight over the packed qkv
(SAM-B, SAM-L); other windowed shapes take K4 (SAM-H, head dim 80); the
global blocks (N > 1024, N a multiple of 128) take K5. Everything else,
and the CPU, runs the plain composition. The rel terms are computed in
fp32 from the fp32 q, outside autocast, as the JAX package computes them.

With ``use_gradient_checkpoint`` each block runs under
``torch.utils.checkpoint`` (non-reentrant) while autograd records: its
activations are dropped and the backward runs its forward again, kernels
included, which is the JAX package's ``remat_policy=None`` (or
``"nothing_saveable"``). The policies that keep products (``"dots_saveable"``
and the others) are not ported and raise.
"""

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ....models.common import PatchEmbed
from ....ops.kernels.flash_attention import flash_attention_relpos
from ....ops.kernels.fused_attention import (fused_attention_relwin,
                                             fused_attention_relwin_dense,
                                             fused_attention_relwin_reference)

__all__ = ["window_partition", "window_unpartition", "get_rel_pos",
           "SAMAttention", "SAMBlock", "LayerNorm2d", "ViTImageEncoder"]


def window_partition(x, window_size):
    """[B, H, W, C] -> ([B * windows, ws, ws, C], (Hp, Wp)); the grid is
    zero-padded at the bottom and right to a multiple of the window."""
    b, h, w, c = x.shape
    pad_h = (window_size - h % window_size) % window_size
    pad_w = (window_size - w % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window_size, window_size, wp // window_size,
                  window_size, c)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size,
                                                  window_size, c)
    return windows, (hp, wp)


def window_unpartition(windows, window_size, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = windows.shape[0] // (hp * wp // window_size // window_size)
    x = windows.reshape(b, hp // window_size, wp // window_size, window_size,
                        window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def get_rel_pos(q_size, k_size, rel_pos):
    """Rows of the rel-pos table for every (query, key) offset:
    [q_size, k_size, head_dim] (no resize of the table). The index is made
    on the table's device: a copy from the host would wait for the card."""
    arange = lambda n: torch.arange(n, device=rel_pos.device)
    q_coords = arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


class SAMAttention(nn.Module):
    """Multi-head attention over [B, H, W, C] tokens with the decomposed
    relative-position bias (see the module docstring for the kernels)."""

    def __init__(self, planes, head_nums, input_size, use_flash=False):
        super().__init__()
        self.head_nums = head_nums
        self.use_flash = use_flash
        head_dim = planes // head_nums
        self.qkv = nn.Linear(planes, 3 * planes)
        self.proj = nn.Linear(planes, planes)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                  head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1,
                                                  head_dim))

    def forward(self, x):
        b, h, w, c = x.shape
        nh = self.head_nums
        hd = c // nh
        n = h * w
        qkv = self.qkv(x)
        with torch.autocast(x.device.type, enabled=False):
            rh = get_rel_pos(h, h, self.rel_pos_h.float())  # [h, h, hd]
            rw = get_rel_pos(w, w, self.rel_pos_w.float())
            if self.use_flash and n <= 1024 and hd in (64, 128) \
                    and c % 128 == 0:
                # K3 reads q, k, v straight from the packed qkv
                qkv = qkv.reshape(b, n, 3 * c)
                qh = qkv[..., :c].float().reshape(b, h, w, nh, hd)
                rel_h = torch.einsum("bijnd,ikd->bijnk", qh, rh).reshape(
                    b, n, nh, h)
                rel_w = torch.einsum("bijnd,jkd->bijnk", qh, rw).reshape(
                    b, n, nh, w)
                out = fused_attention_relwin_dense(qkv, rel_h, rel_w, nh)
                out = out.reshape(b, h, w, c)
            else:
                q, k, v = qkv.reshape(b, n, 3, nh, hd).permute(
                    2, 0, 3, 1, 4).unbind(0)           # [B, nh, N, hd] views
                rq = q.float().reshape(b, nh, h, w, hd)
                rel_h = torch.einsum("bnhwc,hkc->bnhwk", rq, rh).reshape(
                    b, nh, n, h)
                rel_w = torch.einsum("bnhwc,wkc->bnhwk", rq, rw).reshape(
                    b, nh, n, w)
                if self.use_flash and n > 1024 and n % 128 == 0:
                    out = flash_attention_relpos(q, k, v, rel_h, rel_w)
                elif self.use_flash and n <= 1024:
                    out = fused_attention_relwin(q, k, v, rel_h, rel_w)
                else:
                    out = fused_attention_relwin_reference(q, k, v, rel_h,
                                                           rel_w)
                out = out.transpose(1, 2).reshape(b, h, w, c)
        return self.proj(out)


class MLPBlock(nn.Module):
    """lin1 -> exact (erf) GELU -> lin2, as SAM's weights were trained."""

    def __init__(self, planes, hidden_planes):
        super().__init__()
        self.lin1 = nn.Linear(planes, hidden_planes)
        self.lin2 = nn.Linear(hidden_planes, planes)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class SAMBlock(nn.Module):
    def __init__(self, planes, head_nums, mlp_ratio=4.0, input_size=(64, 64),
                 window_size=0, use_flash=False):
        super().__init__()
        self.window_size = window_size
        self.norm1 = nn.LayerNorm(planes, eps=1e-6)
        attn_size = (window_size, window_size) if window_size > 0 \
            else input_size
        self.attn = SAMAttention(planes, head_nums, attn_size, use_flash)
        self.norm2 = nn.LayerNorm(planes, eps=1e-6)
        self.mlp = MLPBlock(planes, int(planes * mlp_ratio))

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            # padded tokens are zeros after norm1 and are attended to
            # unmasked, as in the reference
            h, w = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class LayerNorm2d(nn.Module):
    """Channel LayerNorm over NCHW, fp32 statistics: (x - mean) /
    sqrt(mean((x - mean)^2) + eps), as the JAX package computes it."""

    def __init__(self, planes, eps=1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(planes))
        self.bias = nn.Parameter(torch.zeros(planes))
        self.eps = eps

    def forward(self, x):
        x = x.float()
        u = x.mean(dim=1, keepdim=True)
        s = ((x - u) ** 2).mean(dim=1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return x * self.weight[:, None, None] + self.bias[:, None, None]


class ViTImageEncoder(nn.Module):
    def __init__(self, image_size=1024, patch_size=16, embedding_planes=768,
                 block_nums=12, head_nums=12, mlp_ratio=4.0, out_planes=256,
                 window_size=14, global_attn_indexes=(),
                 use_gradient_checkpoint=False, remat_policy=None,
                 use_flash_attention=False):
        super().__init__()
        if remat_policy not in (None, "nothing_saveable"):
            raise NotImplementedError(
                f"remat_policy={remat_policy!r}: only full recompute "
                "(None or 'nothing_saveable') is ported")
        self.use_gradient_checkpoint = use_gradient_checkpoint
        grid = image_size // patch_size
        self.patch_embed = PatchEmbed(3, embedding_planes, patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid,
                                                  embedding_planes))
        self.blocks = nn.ModuleList([
            SAMBlock(embedding_planes, head_nums, mlp_ratio, (grid, grid),
                     0 if i in global_attn_indexes else window_size,
                     use_flash_attention)
            for i in range(block_nums)])
        self.neck = nn.Sequential(
            nn.Conv2d(embedding_planes, out_planes, 1, bias=False),
            LayerNorm2d(out_planes),
            nn.Conv2d(out_planes, out_planes, 3, padding=1, bias=False),
            LayerNorm2d(out_planes))

    def forward(self, x):
        """[B, 3, H, W] -> [B, out_planes, H / P, W / P]."""
        x = self.patch_embed(x).permute(0, 2, 3, 1) + self.pos_embed
        remat = self.use_gradient_checkpoint and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return self.neck(x.permute(0, 3, 1, 2))
