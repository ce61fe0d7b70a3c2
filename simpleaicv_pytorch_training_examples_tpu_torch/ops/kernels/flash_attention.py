"""Streaming attention: kernel K5 (SAM's decomposed relative-position bias)
and kernel K6 (a per-key bias), each forward and backward.

Counterpart of the JAX package's ``ops/pallas/flash_attention.py::
flash_attention_relpos``: q, k, v ``[B, H, N, D]`` (D <= 256; views of the
packed qkv are read in place through their strides), ``rel_h [B, H, N, KH]``
and ``rel_w [B, H, N, KW]`` fp32 with N = KH * KW. The score of query i and
key j = jh * KW + jw is ``q_i.k_j * D^-0.5 + rel_h[i, jh] + rel_w[i, jw]``.
The forward kernel (``csrc/flash_attention.cu``) walks the keys once with an
online softmax and never builds the ``[N, N]`` score matrix; it also returns
the fp32 log-sum-exp of every query row. ``FlashAttentionRelpos`` (a
``torch.autograd.Function``) saves the inputs, the output and the
log-sum-exp; its backward computes delta = rowsum(dO * O) with one torch op
(the JAX package computes it outside its kernel as well) and launches two
kernels of the same source, which recompute P from the log-sum-exp and give
dq, dk, dv and the fp32 drel_h, drel_w (the TPU kernel's math: dS0 = P *
(dP - delta) unscaled for drel, rounded to the input dtype for dQ and dK,
which are scaled after their products).

A CPU tensor takes the plain PyTorch versions
(``flash_attention_relpos_reference``, the JAX package's off-TPU
composition, and ``flash_attention_relpos_backward_reference``); a CUDA
tensor takes the kernels, or the call raises. The wrapper counts its
launches in ``flash_attention_relpos.launches`` and
``flash_attention_relpos.backward_launches``.

K6 is the counterpart of the JAX package's ``flash_attention`` (its
forward, ``_flash_forward``): q ``[B, H, Nq, D]``, k and v ``[B, H, Nk,
D]`` (D <= 256, each read through its own strides), an optional fp32 key
bias ``[B, Nk]`` shared by the heads and the queries, and ``sm_scale``
(default D^-0.5). The score of query i and key j is ``q_i.k_j * sm_scale +
bias[j]``; the bias stays finite (-1e9 masks a key), so a row whose keys
are all masked averages V, as on the TPU. The kernel (the forward body of
``csrc/flash_attention.cu`` with the rel-pos flag off) walks the keys once
with an online softmax and also returns the fp32 log-sum-exp. A CPU tensor
takes ``flash_attention_reference``, differentiable through plain ops; a
CUDA tensor takes the kernel, or the call raises. ``FlashAttention`` (a
``torch.autograd.Function``) saves the inputs, the output and the
log-sum-exp. Where the TPU kernel rounds P to bf16 for P.V, a bf16 forward
that a gradient will follow takes P.V at fp32 precision of P (P's bf16
residual is a second product): with P rounded, SAM2's gradient check put
90 parameters, Hiera's among them, off the plain path's floor, with it
none. The bias gets no gradient, as on the TPU (it marks which memory
slots are filled).

K6's bf16 backward is ``csrc/flash_keybias_bwd.cu``: wgmma products on
tiles that TMA loads, in three walks (delta = rowsum(P * dP) / rowsum(P)
from the backward's own P and dP, then dQ, then dK and dV) and split
reductions. The delta and dQ walks split the keys when the query tiles of
all heads are fewer than the SMs, the dK/dV walk the queries likewise,
each split writing fp32 partials that are summed in a fixed order (no
atomics: the same bits every run; ``key_bias_backward_splits``). dS0 = P
* (dP - delta) goes into dQ and dK as its bf16 rounding plus the bf16
residual, so that each row of dS0 sums to 0 at fp32 precision: where
values share a mean, delta from the output, the TPU kernel's choice, leaves
a coherent error in dq and dk
(``test_key_bias_flash_plain_backward_takes_delta_at_fp32``), and the
gradient of a key projection's bias that RoPE rotates (SAM2's memory
attention) is a residue of that sum (the kernel's notes). A pair of a
query tile and a key tile is skipped when every key of the tile is masked
(bias <= -5e8) and every row of the query tile has lse > -2.5e8: its P is
exactly 0, so the pair adds exact zeros (the tests replace masked keys' k
and v and find every other gradient the same bit for bit), and the empty
slots of SAM2's memory cost nothing. The tensor maps read q, k, v and dO
in place where TMA can (``tma_operand``). The fp32 backward launches the
FMA kernels of ``csrc/flash_attention.cu`` (K5's fp32 bodies with the
rel-pos flag off) with delta = rowsum(dO * O) from its fp32 output.
``flash_attention_backward_reference`` is the plain version of the
backward. Launches count in ``flash_attention.launches`` and
``flash_attention.backward_launches`` (one a backward, however many
kernels it takes).
"""

import ctypes
import functools

import torch

from . import build
from .fused_attention import (check_rel_args, fused_attention_relwin_reference,
                              rel_bias)

MAX_HEAD_DIM = 256
_DTYPES = (torch.bfloat16, torch.float32)


def _scores(q, k, rel_h, rel_w):
    """fp32 scores with the expanded bias [B, H, N, N]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    return s * (q.shape[-1] ** -0.5) + rel_bias(rel_h, rel_w)


def flash_attention_relpos_reference(q, k, v, rel_h, rel_w, return_lse=False):
    """Plain version of K5: fp32 scores plus the expanded bias, fp32
    softmax, probabilities cast to the input dtype, P.V -> [B, H, N, D];
    with ``return_lse`` also the fp32 log-sum-exp of the scores, [B, H, N]."""
    out = fused_attention_relwin_reference(q, k, v, rel_h, rel_w)
    if not return_lse:
        return out
    return out, torch.logsumexp(_scores(q, k, rel_h, rel_w), dim=-1)


def flash_attention_relpos_backward_reference(q, k, v, rel_h, rel_w, dout,
                                              out=None):
    """Plain version of K5's backward (the JAX ``_bwd_rel_fused_kernel``):
    P = exp(s - lse) from the fp32 scores, dV = P^T.dO with P in the input
    dtype, dP = dO.V^T, dS0 = P * (dP - delta) with delta = rowsum(dO * O)
    (``out``: the forward's output, recomputed when None), drel_h, drel_w
    the fp32 sums of dS0 by key-grid row and column, dQ = (dS0.K) * scale
    and dK = (dS0^T.Q) * scale with dS0 rounded to the input dtype. Returns
    dq, dk, dv (the input dtype), drel_h, drel_w (fp32)."""
    dtype = q.dtype
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    scale = q.shape[-1] ** -0.5
    if out is None:
        out = flash_attention_relpos_reference(q, k, v, rel_h, rel_w)
    dof = dout.to(dtype).float()
    s = _scores(q, k, rel_h, rel_w)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds0 = p * (dp - delta)
    grid = ds0.unflatten(-1, (kh, kw))
    ds = ds0.to(dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    return (dq.to(dtype), dk.to(dtype), dv.to(dtype), grid.sum(-1),
            grid.sum(-2))


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


_PTR, _LL, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("flash_attention")
    fwd = lib.saicv_flash_attention_relpos_fwd
    bwd = lib.saicv_flash_attention_relpos_bwd
    tail = [ctypes.c_float, _INT, _PTR]
    fwd.argtypes = [_PTR] * 7 + [_LL] * 12 + [_INT] * 6 + tail
    bwd.argtypes = [_PTR] * 13 + [_LL] * 21 + [_INT] * 6 + tail
    fwd.restype = bwd.restype = _INT
    return fwd, bwd


def _launch(fn, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"flash rel-pos attention kernel launch failed: "
                           f"cudaError {err}")


class FlashAttentionRelpos(torch.autograd.Function):
    """K5 with its backward kernels; returns (out, lse), the log-sum-exp
    without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w):
        if q.device.type == "cpu":
            out, lse = flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                                        return_lse=True)
        else:
            if q.device.type != "cuda":
                raise ValueError(f"unsupported device {q.device}")
            b, h, n, d, kh, kw = check_args(q, k, v, rel_h, rel_w)
            out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
            lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
            _launch(_library()[0], q.device, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                    rel_h.data_ptr(), rel_w.data_ptr(), *q.stride()[:3],
                    n * h * d, d, h * d, *rel_h.stride()[:3],
                    *rel_w.stride()[:3], b, h, n, d, kh, kw, d ** -0.5,
                    int(q.dtype == torch.bfloat16))
            flash_attention_relpos.launches += 1
            out = out.transpose(1, 2)
        ctx.save_for_backward(q, k, v, rel_h, rel_w, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _):
        q, k, v, rel_h, rel_w, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype)
        if q.device.type == "cpu":
            return flash_attention_relpos_backward_reference(
                q, k, v, rel_h, rel_w, dout, out)
        b, h, n, d, kh, kw = check_args(q, k, v, rel_h, rel_w)
        if dout.stride(3) != 1:
            dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)       # [B, H, N]
        grads = torch.empty((3, b, h, n, d), dtype=q.dtype, device=q.device)
        # KW = 64 in bf16: every drel element is written; else accumulated
        alloc = torch.empty if kw == 64 and q.dtype == torch.bfloat16 \
            else torch.zeros
        drel_h = alloc((b, h, n, kh), dtype=torch.float32, device=q.device)
        drel_w = alloc((b, h, n, kw), dtype=torch.float32, device=q.device)
        _launch(_library()[1], q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), dout.data_ptr(),
                *(g.data_ptr() for g in grads), lse.data_ptr(),
                delta.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(),
                drel_h.data_ptr(), drel_w.data_ptr(), *q.stride()[:3],
                *dout.stride()[:3], h * n * d, n * d, d,
                *(s for t in (rel_h, rel_w, drel_h, drel_w)
                  for s in t.stride()[:3]),
                b, h, n, d, kh, kw, d ** -0.5,
                int(q.dtype == torch.bfloat16))
        flash_attention_relpos.backward_launches += 1
        return grads[0], grads[1], grads[2], drel_h, drel_w


def flash_attention_relpos(q, k, v, rel_h, rel_w, return_lse=False):
    """K5: [B, H, N, D] attention with the decomposed rel-pos bias -> out
    [B, H, N, D] (a view of a [B, N, H, D] tensor, so the attention module's
    transpose back to tokens costs no copy); with ``return_lse`` also the
    fp32 log-sum-exp [B, H, N]."""
    out, lse = FlashAttentionRelpos.apply(q, k, v, rel_h, rel_w)
    return (out, lse) if return_lse else out


flash_attention_relpos.launches = 0
flash_attention_relpos.backward_launches = 0


# ------------------------------------------------------------------- K6


def flash_attention_reference(q, k, v, bias=None, sm_scale=None,
                              return_lse=False):
    """Plain version of K6: fp32 scores times ``sm_scale`` (default D^-0.5)
    plus the fp32 key bias [B, Nk], fp32 softmax, probabilities cast to the
    input dtype, P.V -> [B, H, Nq, D]; with ``return_lse`` also the fp32
    log-sum-exp of the scores, [B, H, Nq]."""
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def flash_attention_backward_reference(q, k, v, bias, dout, sm_scale=None):
    """Plain version of K6's backward (the JAX ``_bwd_fused_kernel`` with
    delta and dS0 at fp32 precision): P = exp(s - lse) from the fp32 scores
    s = q.k * sm_scale + bias, dV = P^T.dO with P in the input dtype, dP =
    dO.V^T, delta = rowsum(P * dP) / rowsum(P) in fp32 (the bf16 kernels'
    own walk over the keys; the division cancels the rounding of lse, which
    matters where every key of a row is masked: there lse rounds to the
    bias and P to 1; the TPU kernel takes rowsum(dO * O) from the output in
    the input dtype), dS0 = P * (dP - delta) in fp32 (the kernel carries it
    as its bf16 rounding plus the bf16 residual; the TPU kernel rounds it
    to the input dtype), dK = (dS0^T.Q) * sm_scale and dQ = (dS0.K) *
    sm_scale. Returns dq, dk, dv in the input dtype; the bias gets no
    gradient."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5 if sm_scale is None else float(sm_scale)
    dof = dout.to(dtype).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()[:, None, None, :]
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.float())
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True)
              / p.sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float()) * scale
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def check_key_bias_args(q, k, v, bias):
    """Shape rule of K6; returns (b, h, nq, nk, d) or raises. Each of q, k,
    v may have its own strides, with the head dim contiguous; the bias is
    fp32 [B, Nk] with the keys contiguous."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} is not bfloat16 or "
                            "float32")
        if t.dim() != 4 or t.stride(3) != 1:
            raise ValueError(f"{name}: shape {tuple(t.shape)} is not "
                             "[B, H, N, D] with the head dim contiguous")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError("q, k, v must share one dtype")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if k.shape != (b, h, nk, d) or v.shape != k.shape:
        raise ValueError(f"k, v {tuple(k.shape)}, {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    tensors = (q, k, v) if bias is None else (q, k, v, bias)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all tensors must lie on one device")
    if bias is not None and (bias.dtype != torch.float32
                             or tuple(bias.shape) != (b, nk)
                             or bias.stride(1) != 1):
        raise ValueError(f"bias: {bias.dtype} {tuple(bias.shape)} is not a "
                         f"float32 [{b}, {nk}] with the keys contiguous")
    if d > MAX_HEAD_DIM or nq > 1 << 24 or nk > 1 << 24:
        raise ValueError(f"K6 takes D <= {MAX_HEAD_DIM} and N <= 2^24, got "
                         f"D={d}, Nq={nq}, Nk={nk}")
    return b, h, nq, nk, d


@functools.lru_cache(maxsize=None)
def _key_bias_library():
    lib = build.load("flash_attention")
    fwd, bwd = lib.saicv_flash_attention_fwd, lib.saicv_flash_attention_bwd
    tail = [ctypes.c_float, _INT, _PTR]
    fwd.argtypes = ([_PTR] * 6 + [_LL] * 13 + [_INT] * 5
                    + [ctypes.c_float, _INT, _INT, _PTR])
    bwd.argtypes = [_PTR] * 10 + [_LL] * 19 + [_INT] * 5 + tail
    fwd.restype = bwd.restype = _INT
    return fwd, bwd


@functools.lru_cache(maxsize=None)
def _key_bias_bf16_backward():
    fn = build.load("flash_keybias_bwd").saicv_flash_keybias_bwd_bf16
    fn.argtypes = [_PTR] * 13 + [_LL] * 19 + [_INT] * 7 + [ctypes.c_float,
                                                            _PTR]
    fn.restype = _INT
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def padded_head_dim(d):
    """The columns the bf16 backward computes for head dim d: 64, 128 or
    256."""
    return 64 if d <= 64 else 128 if d <= 128 else 256


def key_bias_backward_splits(b, h, nq, nk, d, sms):
    """(splits of the key walk of a query block, splits of the query walk
    of a key block) of the bf16 backward: the SMs over the blocks of all
    heads (64 rows a block, 128 at head dims up to 64), rounded down, at
    least 1 and at most the 64-row tiles walked."""
    rows = 128 if padded_head_dim(d) == 64 else 64
    q_blocks, k_blocks = -(-nq // rows), -(-nk // rows)
    return (max(1, min(-(-nk // 64), sms // (q_blocks * b * h))),
            max(1, min(-(-nq // 64), sms // (k_blocks * b * h))))


def tma_operand(t):
    """t itself where the bf16 backward's tensor maps read it in place (a
    16-byte aligned base and (batch, head, row) strides that are multiples
    of 8 elements on every axis longer than 1), else a copy with the head
    dim padded to a multiple of 8 (the maps read its first D columns)."""
    if t.data_ptr() % 16 == 0 and all(
            s % 8 == 0 or n == 1 for s, n in zip(t.stride()[:3], t.shape[:3])):
        return t
    d = t.shape[-1]
    out = t.new_zeros(*t.shape[:3], -(-d // 8) * 8)
    out[..., :d] = t
    return out


def _key_bias_backward_bf16(q, k, v, bias, dout, lse, scale):
    """The bf16 backward's launches (``csrc/flash_keybias_bwd.cu``):
    returns dq [B, H, Nq, D], dk and dv [B, H, Nk, D]."""
    b, h, nq, nk, d = *q.shape[:3], k.shape[2], q.shape[3]
    dp = padded_head_dim(d)
    sq, skv = key_bias_backward_splits(b, h, nq, nk, d,
                                       _sm_count(q.device.index or 0))
    q, k, v, dout = (tma_operand(t) for t in (q, k, v, dout))
    f32 = dict(dtype=torch.float32, device=q.device)
    stats = torch.empty((2, sq, b * h, nq), **f32)
    delta = torch.empty((b * h, nq), **f32)
    dq_part = torch.empty((sq, b * h, nq, dp), **f32) if sq > 1 else None
    dkv_part = (torch.empty((2, skv, b * h, nk, dp), **f32) if skv > 1
                else None)
    dq = torch.empty((b, h, nq, d), dtype=q.dtype, device=q.device)
    dkv = torch.empty((2, b, h, nk, d), dtype=q.dtype, device=q.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()
    _launch(_key_bias_bf16_backward(), q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), dq.data_ptr(), dkv[0].data_ptr(),
            dkv[1].data_ptr(), lse.data_ptr(), ptr(bias), stats.data_ptr(),
            delta.data_ptr(), ptr(dq_part), ptr(dkv_part), *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *dout.stride()[:3],
            *dq.stride()[:3], *dkv[0].stride()[:3],
            0 if bias is None else bias.stride(0), b, h, nq, nk, d, sq, skv,
            scale)
    return dq, dkv[0], dkv[1]


class FlashAttention(torch.autograd.Function):
    """K6 and its backward kernels on CUDA tensors; returns (out, lse), the
    log-sum-exp without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, sm_scale):
        if q.device.type != "cuda":
            raise ValueError(f"unsupported device {q.device}")
        b, h, nq, nk, d = check_key_bias_args(q, k, v, bias)
        scale = d ** -0.5 if sm_scale is None else float(sm_scale)
        bf16 = q.dtype == torch.bfloat16
        out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
        _launch(_key_bias_library()[0], q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                0 if bias is None else bias.data_ptr(), *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], nq * h * d, d, h * d,
                0 if bias is None else bias.stride(0), b, h, nq, nk, d, scale,
                int(any(ctx.needs_input_grad[:3])), int(bf16))
        flash_attention.launches += 1
        out = out.transpose(1, 2)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _):
        q, k, v, bias, out, lse = ctx.saved_tensors
        b, h, nq, nk, d = check_key_bias_args(q, k, v, bias)
        dout = dout.to(q.dtype)
        if dout.stride(3) != 1:
            dout = dout.contiguous()
        if q.dtype == torch.bfloat16:
            dq, dk, dv = _key_bias_backward_bf16(q, k, v, bias, dout, lse,
                                                 ctx.scale)
            flash_attention.backward_launches += 1
            return dq, dk, dv, None, None
        delta = (dout * out).sum(dim=-1)                       # [B, H, Nq]
        dq = torch.empty((b, h, nq, d), dtype=q.dtype, device=q.device)
        dkv = torch.empty((2, b, h, nk, d), dtype=q.dtype, device=q.device)
        _launch(_key_bias_library()[1], q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                dkv[0].data_ptr(), dkv[1].data_ptr(), lse.data_ptr(),
                delta.data_ptr(), 0 if bias is None else bias.data_ptr(),
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *dout.stride()[:3], *dq.stride()[:3], *dkv[0].stride()[:3],
                0 if bias is None else bias.stride(0), b, h, nq, nk, d,
                ctx.scale, 0)
        flash_attention.backward_launches += 1
        return dq, dkv[0], dkv[1], None, None


def flash_attention(q, k, v, bias=None, sm_scale=None, return_lse=False):
    """K6: [B, H, Nq, D] attention over [B, H, Nk, D] keys with an optional
    fp32 key bias [B, Nk] -> out [B, H, Nq, D] (on the card a view of a
    [B, Nq, H, D] tensor, so the module's transpose back to tokens costs no
    copy); with ``return_lse`` also the fp32 log-sum-exp [B, H, Nq]."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, bias, sm_scale, return_lse)
    out, lse = FlashAttention.apply(q, k, v, bias, sm_scale)
    return (out, lse) if return_lse else out


flash_attention.launches = 0
flash_attention.backward_launches = 0
