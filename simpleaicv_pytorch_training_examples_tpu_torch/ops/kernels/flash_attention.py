"""Streaming attention with SAM's decomposed relative-position bias: kernel
K5, forward.

Counterpart of the JAX package's ``ops/pallas/flash_attention.py::
flash_attention_relpos``: q, k, v ``[B, H, N, D]`` (D <= 256; views of the
packed qkv are read in place through their strides), ``rel_h [B, H, N, KH]``
and ``rel_w [B, H, N, KW]`` fp32 with N = KH * KW. The score of query i and
key j = jh * KW + jw is ``q_i.k_j * D^-0.5 + rel_h[i, jh] + rel_w[i, jw]``.
The kernel (``csrc/flash_attention.cu``) walks the keys once with an online
softmax and never builds the ``[N, N]`` score matrix; it also returns the
fp32 log-sum-exp of every query row, which the backward of SAM training
will read. Forward only: the backward kernel comes with SAM training.

A CPU tensor takes the plain PyTorch version
(``flash_attention_relpos_reference``, the JAX package's off-TPU
composition); a CUDA tensor takes the kernel, or the call raises. The
wrapper counts its launches in ``flash_attention_relpos.launches``.
"""

import ctypes
import functools

import torch

from . import build
from .fused_attention import (check_rel_args, forward_only,
                              fused_attention_relwin_reference)

MAX_HEAD_DIM = 256
_DTYPES = (torch.bfloat16, torch.float32)


def flash_attention_relpos_reference(q, k, v, rel_h, rel_w, return_lse=False):
    """Plain version of K5: fp32 scores plus the expanded bias, fp32
    softmax, probabilities cast to the input dtype, P.V -> [B, H, N, D];
    with ``return_lse`` also the fp32 log-sum-exp of the scores, [B, H, N]."""
    out = fused_attention_relwin_reference(q, k, v, rel_h, rel_w)
    if not return_lse:
        return out
    b, h, n, _ = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * (q.shape[-1] ** -0.5) + (rel_h.float()[..., :, None]
                                     + rel_w.float()[..., None, :]).reshape(
                                         b, h, n, n)
    return out, torch.logsumexp(s, dim=-1)


def check_args(q, k, v, rel_h, rel_w):
    """Shape rule of K5; returns (b, h, n, d, kh, kw) or raises. q, k and v
    share one shape and one set of strides, with the head dim contiguous."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} is not bfloat16 or "
                            "float32")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v must share one [B, H, N, D] shape")
    if q.stride(3) != 1 or k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError("q, k, v must share strides, with the head dim "
                         "contiguous")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("q, k, v must share one dtype")
    if len({t.device for t in (q, k, v, rel_h, rel_w)}) != 1:
        raise ValueError("all tensors must lie on one device")
    b, h, n, d = q.shape
    if d > MAX_HEAD_DIM or n > 1 << 20:
        raise ValueError(f"K5 takes D <= {MAX_HEAD_DIM} and N <= 2^20, got "
                         f"D={d}, N={n}")
    kh, kw = check_rel_args(rel_h, rel_w, (b, h, n), n)
    return b, h, n, d, kh, kw


@functools.lru_cache(maxsize=None)
def _library():
    fn = build.load("flash_attention").saicv_flash_attention_relpos_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 12
                   + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_relpos(q, k, v, rel_h, rel_w, return_lse=False):
    """K5: [B, H, N, D] attention with the decomposed rel-pos bias -> out
    [B, H, N, D] (a view of a [B, N, H, D] tensor, so the attention module's
    transpose back to tokens costs no copy); with ``return_lse`` also the
    fp32 log-sum-exp [B, H, N]."""
    if q.device.type == "cpu":
        return flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                                return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    forward_only("K5 flash_attention_relpos", q, k, v, rel_h, rel_w)
    b, h, n, d, kh, kw = check_args(q, k, v, rel_h, rel_w)
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _library()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
            *q.stride()[:3], n * h * d, d, h * d, *rel_h.stride()[:3],
            *rel_w.stride()[:3], b, h, n, d, kh, kw, d ** -0.5,
            int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash rel-pos attention kernel launch failed: "
                           f"cudaError {err}")
    flash_attention_relpos.launches += 1
    out = out.transpose(1, 2)
    return (out, lse) if return_lse else out


flash_attention_relpos.launches = 0
