"""Short-sequence fused self-attention, forward and backward: kernels K1,
K2, their rel-pos variants K3, K4, K2 with a full score bias (K2b) and K1
on a packed [B, N, 3, H, D] qkv (K9).

Counterpart of the JAX package's ``ops/pallas/fused_attention.py``:

- ``fused_attention_dense`` (K1) attends straight over the packed qkv Dense
  output ``[B, N, 3C]`` (column order ``[3, H, D]``) and returns
  ``[B, N, C]``, ready for the proj Dense. Head dim 64 or 128; an optional
  ``sm_scale`` replaces D^-0.5 (Hiera's heads padded from 56 to 64 keep the
  56-wide scale), in the forward and the backward.
- ``fused_attention`` (K2) takes ``q, k, v`` as ``[B, H, N, D]``, D <= 128,
  read in place through their strides (head dim contiguous), so views of
  the packed qkv output need no layout copy.
- ``fused_attention_relwin_dense`` (K3) and ``fused_attention_relwin`` (K4)
  are K1 and K2 with SAM's decomposed relative-position bias: the score of
  query i and key j = jh * KW + jw gains ``rel_h[i, jh] + rel_w[i, jw]``
  (fp32, N = KH * KW). K3 takes ``rel_h [B, N, H, KH]``, ``rel_w [B, N, H,
  KW]`` beside the packed qkv; K4 takes ``[B, H, N, KH]``, ``[B, H, N, KW]``
  and an optional ``n_real``.
- ``fused_attention(q, k, v, n_real, bias=)`` (K2b, through
  ``fused_attention_bias``) adds a full score bias that broadcasts to
  ``[B, H, N, N]`` (fp32 or bf16, the key axis contiguous), read in place
  through its strides (0 on a broadcast axis); its gradient, the unscaled
  dS0 summed back to the bias's shape, comes in the bias's dtype.
- ``fused_attention_qkv`` (K9) attends over a packed ``[B, N, 3, H, D]``
  qkv (any D <= 128) and returns ``[B, N, H, D]``; its backward writes the
  packed dqkv. It is K1's launch at other strides.

The kernels never write the scores or the probabilities to device memory;
N <= 1024. Every bf16 forward is ``csrc/short_attention_fwd.cu``'s
(``wgmma`` on TMA-fed tiles, any bias staged once, one pass over the keys
where a row of up to 264 keys fits), every bf16 backward
``csrc/short_attention_bwd.cu``'s (``wgmma``, the whole score row of 64
queries in the accumulators, the bias read once by each of its two
kernels); both read q, k, v and dout in place where TMA can
(``tma_operand``). Every fp32 kernel is ``csrc/fused_attention.cu``'s. The
math is the TPU kernels':
fp32 scores scaled by D^-0.5, plus the fp32 rel-pos bias or the full bias
(read as fp32), keys at or past ``n_real`` set to -1e9, fp32 softmax,
probabilities normalised and then cast to the input dtype, P.V with fp32
accumulation.

All are ``torch.autograd.Function``s (``FusedAttentionDense``,
``FusedAttention``, ``FusedAttentionRelwinDense``, ``FusedAttentionRelwin``,
``FusedAttentionBias``, ``FusedAttentionQKV``) whose backward is a kernel
of the same source. Only the inputs are saved: the backward recomputes P,
then dV = P^T.dO with P in the input dtype, dP = dO.V^T, dS0 = P * (dP -
sum_k dP * P), dS = dS0 * scale cast to the input dtype, dQ = dS.K and dK =
dS^T.Q, all accumulated in fp32; K3 and K4 also give drel_h[i, kh] and
drel_w[i, kw], the fp32 sums of dS0[i, j] over the keys j in key-grid row
kh or column kw (the TPU kernels' unscaled dS0); K2b also gives dbias =
dS0 (written by the bf16 kernel in the bias's dtype where the bias has
the full [B, H, N, N] shape: ``dbias_buffer_dtype``). Every output row has
one owner, so the gradients are reproducible bit for bit. K1's, K3's and K9's backward write
dq, dk and dv into one packed ``[B, N, 3C]`` (K9: ``[B, N, 3, H, D]``)
tensor, which feeds the qkv Linear's backward as it is.

A CPU tensor takes the plain PyTorch version (``*_reference``); a CUDA
tensor takes the kernel, or the call raises. Each wrapper counts its
forward launches in ``<wrapper>.launches`` and its backward launches in
``<wrapper>.backward_launches``.
"""

import ctypes
import functools

import torch

from . import build

NEG_INF = -1e9
MAX_TOKENS = 1024
MAX_HEAD_DIM = 128
DENSE_HEAD_DIMS = (64, 128)
_DTYPES = (torch.bfloat16, torch.float32)


def _scale(d, sm_scale):
    return d ** -0.5 if sm_scale is None else float(sm_scale)


def fused_attention_reference(q, k, v, n_real=None, sm_scale=None,
                              bias=None):
    """Plain version of K2 (the JAX ``_reference``): [B, H, N, D] -> same;
    scores scaled by ``sm_scale`` (default D^-0.5), plus ``bias`` (any shape
    that broadcasts to [B, H, N, N], added in fp32) when given."""
    n = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * _scale(q.shape[-1], sm_scale)
    if bias is not None:
        s = s + bias.float()
    if n_real is not None and n_real < n:
        keep = torch.arange(n, device=q.device) < n_real
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(q.dtype)


def _unpack(qkv5):
    """q, k, v [B, H, N, D]: views of a packed qkv [B, N, 3, H, D]."""
    return qkv5.permute(2, 0, 3, 1, 4).unbind(0)


def _pack(dq, dk, dv):
    """dq, dk, dv [B, H, N, D] -> one packed [B, N, 3, H, D] tensor."""
    return torch.stack((dq, dk, dv)).permute(1, 3, 0, 2, 4).contiguous()


def fused_attention_dense_reference(qkv, head_nums, n_real=None,
                                    sm_scale=None):
    """Plain version of K1: [B, N, 3C] -> [B, N, C] through K2's math."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = _unpack(qkv.reshape(b, n, 3, head_nums, c // head_nums))
    out = fused_attention_reference(q, k, v, n_real, sm_scale)
    return out.transpose(1, 2).reshape(b, n, c)


def fused_attention_qkv_reference(qkv, n_real=None):
    """Plain version of K9 (the JAX ``fused_attention_qkv`` off the TPU):
    qkv [B, N, 3, H, D] -> [B, N, H, D] through K2's math."""
    out = fused_attention_reference(*_unpack(qkv), n_real)
    return out.transpose(1, 2).contiguous()


def fused_attention_bias_reference(q, k, v, bias, n_real=None):
    """Plain version of K2b (the JAX ``_reference_bias``): q, k, v [B, H, N,
    D] and a score bias that broadcasts to [B, H, N, N] -> [B, H, N, D]."""
    return fused_attention_reference(q, k, v, n_real, bias=bias)


def _backward_reference(q, k, v, dout, n_real=None, bias=None,
                        sm_scale=None):
    """The TPU backward kernels' math: q, k, v, dout [B, H, N, D] and an
    optional fp32 score bias [B, H, N, N] -> dq, dk, dv (the input dtype)
    and the fp32 dS0 = P * (dP - sum_k dP * P) [B, H, N, N]."""
    dtype = q.dtype
    n = k.shape[2]
    scale = _scale(q.shape[-1], sm_scale)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = dout.to(dtype).float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if bias is not None:
        s = s + bias
    if n_real is not None and n_real < n:
        keep = torch.arange(n, device=q.device) < n_real
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)                       # fp32
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dtype).float(), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    row = (dp * p).sum(dim=-1, keepdim=True)
    ds0 = p * (dp - row)
    ds = (ds0 * scale).to(dtype).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype), ds0


def fused_attention_backward_reference(q, k, v, dout, n_real=None,
                                       sm_scale=None):
    """Plain version of K2's backward (the JAX ``_bwd_kernel``): q, k, v,
    dout [B, H, N, D] -> dq, dk, dv of the same shape and dtype."""
    return _backward_reference(q, k, v, dout, n_real, sm_scale=sm_scale)[:3]


def fused_attention_dense_backward_reference(qkv, dout, head_nums,
                                             n_real=None, sm_scale=None):
    """Plain version of K1's backward: qkv [B, N, 3C], dout [B, N, C] ->
    packed dqkv [B, N, 3C] through K2's backward math."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // head_nums
    q, k, v = _unpack(qkv.reshape(b, n, 3, head_nums, d))
    do = dout.reshape(b, n, head_nums, d).transpose(1, 2)
    grads = fused_attention_backward_reference(q, k, v, do, n_real, sm_scale)
    return _pack(*grads).reshape(b, n, c3)


def fused_attention_qkv_backward_reference(qkv, dout, n_real=None):
    """Plain version of K9's backward (the JAX ``_bwd_kernel_packed``): qkv
    [B, N, 3, H, D], dout [B, N, H, D] -> the packed dqkv [B, N, 3, H, D]
    through K2's backward math."""
    return _pack(*fused_attention_backward_reference(
        *_unpack(qkv), dout.transpose(1, 2), n_real))


def fused_attention_bias_backward_reference(q, k, v, bias, dout,
                                            n_real=None):
    """Plain version of K2b's backward (the JAX ``_bwd_kernel_bias`` and the
    VJP of ``broadcast_to``): dq, dk, dv (the input dtype) and dbias, the
    unscaled dS0 summed over the axes the bias is broadcast over, in the
    bias's shape and dtype."""
    dq, dk, dv, ds0 = _backward_reference(q, k, v, dout, n_real, bias.float())
    return dq, dk, dv, ds0.sum_to_size(bias.shape).to(bias.dtype)


def fused_attention_relwin_reference(q, k, v, rel_h, rel_w, n_real=None):
    """Plain version of K4 (the JAX ``_reference_bias`` over the expanded
    bias): q, k, v [B, H, N, D], rel_h [B, H, N, KH], rel_w [B, H, N, KW]
    with N = KH * KW -> [B, H, N, D]."""
    return fused_attention_reference(q, k, v, n_real,
                                     bias=rel_bias(rel_h, rel_w))


def fused_attention_relwin_dense_reference(qkv, rel_h, rel_w, head_nums):
    """Plain version of K3: qkv [B, N, 3C], rel_h [B, N, H, KH], rel_w
    [B, N, H, KW] -> [B, N, C] through K4's math."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = _unpack(qkv.reshape(b, n, 3, head_nums, c // head_nums))
    out = fused_attention_relwin_reference(q, k, v, rel_h.transpose(1, 2),
                                           rel_w.transpose(1, 2))
    return out.transpose(1, 2).reshape(b, n, c)


def rel_bias(rel_h, rel_w):
    """rel_h [..., N, KH], rel_w [..., N, KW] -> the fp32 score bias
    [..., N, KH * KW]: bias[i, jh * KW + jw] = rel_h[i, jh] + rel_w[i, jw]."""
    return (rel_h.float()[..., :, None] + rel_w.float()[..., None, :]).flatten(-2)


def fused_attention_relwin_backward_reference(q, k, v, rel_h, rel_w, dout,
                                              n_real=None):
    """Plain version of K4's backward (the JAX ``_bwd_kernel_relwin``): q, k,
    v, dout [B, H, N, D], rel_h [B, H, N, KH], rel_w [B, H, N, KW] -> dq,
    dk, dv (the input dtype) and drel_h, drel_w (fp32, the sums of the
    unscaled dS0 by key-grid row and column)."""
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    dq, dk, dv, ds0 = _backward_reference(q, k, v, dout, n_real,
                                          rel_bias(rel_h, rel_w))
    grid = ds0.unflatten(-1, (kh, kw))
    return dq, dk, dv, grid.sum(-1), grid.sum(-2)


def fused_attention_relwin_dense_backward_reference(qkv, rel_h, rel_w, dout,
                                                    head_nums):
    """Plain version of K3's backward: qkv [B, N, 3C], rel_h [B, N, H, KH],
    rel_w [B, N, H, KW], dout [B, N, C] -> packed dqkv [B, N, 3C] and
    drel_h, drel_w in the layout of rel_h and rel_w, through K4's math."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // head_nums
    q, k, v = _unpack(qkv.reshape(b, n, 3, head_nums, d))
    do = dout.reshape(b, n, head_nums, d).transpose(1, 2)
    dq, dk, dv, drel_h, drel_w = fused_attention_relwin_backward_reference(
        q, k, v, rel_h.transpose(1, 2), rel_w.transpose(1, 2), do)
    dqkv = _pack(dq, dk, dv).reshape(b, n, c3)
    return (dqkv, drel_h.transpose(1, 2).contiguous(),
            drel_w.transpose(1, 2).contiguous())


def _resolve_n_real(n_real, n):
    n_real = n if n_real is None else int(n_real)
    if not 1 <= n_real <= n:
        raise ValueError(f"n_real={n_real} must lie in [1, {n}]")
    return n_real


def _check_dtype(t, name):
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype} is not bfloat16 or float32")


def check_dense_args(qkv, head_nums, n_real=None):
    """Shape rule of K1; returns (b, n, c, d, n_real) or raises."""
    _check_dtype(qkv, "qkv")
    if not qkv.is_contiguous():
        raise ValueError("qkv: the kernel takes a contiguous [B, N, 3C] tensor")
    if qkv.dim() != 3 or qkv.shape[2] % (3 * head_nums):
        raise ValueError(f"qkv shape {tuple(qkv.shape)} is not [B, N, 3*H*D] "
                         f"for H={head_nums}")
    b, n, c3 = qkv.shape
    c = c3 // 3
    d = c // head_nums
    if d not in DENSE_HEAD_DIMS:
        raise ValueError(f"K1 takes head dim 64 or 128, got {d}")
    if not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"K1 takes 1 <= N <= {MAX_TOKENS}, got {n}")
    return b, n, c, d, _resolve_n_real(n_real, n)


def check_args(q, k, v, n_real=None):
    """Shape rule of K2; returns (b, h, n, d, n_real) or raises. q, k and v
    may be strided views but must share their strides, with the head dim
    contiguous."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_dtype(t, name)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError("q, k, v must share one [B, H, N, D] shape")
    if q.stride(3) != 1 or k.stride() != q.stride() or v.stride() != q.stride():
        raise ValueError("q, k, v must share strides, with the head dim "
                         "contiguous")
    if not q.dtype == k.dtype == v.dtype or not q.device == k.device == v.device:
        raise ValueError("q, k, v must share dtype and device")
    b, h, n, d = q.shape
    if d > MAX_HEAD_DIM or not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"K2 takes D <= {MAX_HEAD_DIM} and N <= {MAX_TOKENS}, "
                         f"got D={d}, N={n}")
    return b, h, n, d, _resolve_n_real(n_real, n)


def check_qkv_args(qkv, n_real=None):
    """Shape rule of K9: a contiguous [B, N, 3, H, D] qkv, D <= 128, N <=
    1024; returns (b, n, h, d, n_real) or raises."""
    _check_dtype(qkv, "qkv")
    if qkv.dim() != 5 or qkv.shape[2] != 3:
        raise ValueError(f"qkv shape {tuple(qkv.shape)} is not [B, N, 3, H, D]")
    if not qkv.is_contiguous():
        raise ValueError("qkv: the kernel takes a contiguous [B, N, 3, H, D] "
                         "tensor")
    b, n, _, h, d = qkv.shape
    if d > MAX_HEAD_DIM or not 1 <= n <= MAX_TOKENS:
        raise ValueError(f"K9 takes D <= {MAX_HEAD_DIM} and N <= {MAX_TOKENS}, "
                         f"got D={d}, N={n}")
    return b, n, h, d, _resolve_n_real(n_real, n)


def check_bias_args(bias, shape):
    """Rule of K2b's bias: fp32 or bf16, broadcasting to ``shape`` [B, H, N,
    N] with its key axis contiguous. Returns the broadcast view, whose
    strides are 0 on the axes the bias is broadcast over, or raises."""
    _check_dtype(bias, "bias")
    try:
        full = bias.expand(shape)
    except RuntimeError as err:
        raise ValueError(f"bias shape {tuple(bias.shape)} does not broadcast "
                         f"to {tuple(shape)}") from err
    if full.stride(3) != 1:
        raise ValueError("bias: the kernel takes a bias whose key axis is "
                         "contiguous")
    return full


def check_rel_args(rel_h, rel_w, lead, n):
    """rel_h and rel_w: fp32 on one device, shapes lead + (KH,) and lead +
    (KW,) with KH * KW = n, the last axis contiguous; returns (KH, KW)."""
    for name, t in (("rel_h", rel_h), ("rel_w", rel_w)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {t.dtype} is not float32")
        if tuple(t.shape[:-1]) != tuple(lead) or t.stride(-1) != 1:
            raise ValueError(f"{name}: shape {tuple(t.shape)} is not "
                             f"{tuple(lead)} + (K,) with the last axis "
                             "contiguous")
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    if kh * kw != n:
        raise ValueError(f"KH * KW = {kh} * {kw} is not N = {n}")
    return kh, kw


_STRIDES = [ctypes.c_longlong] * 3
_SHAPE = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("fused_attention")
    fwd, bwd = lib.saicv_fused_attention_fwd, lib.saicv_fused_attention_bwd
    rel = lib.saicv_fused_attention_relpos_fwd
    rel_bwd = lib.saicv_fused_attention_relpos_bwd
    bias, bias_bwd = (lib.saicv_fused_attention_bias_fwd,
                      lib.saicv_fused_attention_bias_bwd)
    rel_shape = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                      ctypes.c_void_p]
    bias_shape = _SHAPE[:-1] + [ctypes.c_int, ctypes.c_void_p]
    fwd.argtypes = [ctypes.c_void_p] * 4 + _STRIDES * 2 + _SHAPE
    bwd.argtypes = [ctypes.c_void_p] * 8 + _STRIDES * 3 + _SHAPE
    rel.argtypes = [ctypes.c_void_p] * 6 + _STRIDES * 4 + rel_shape
    rel_bwd.argtypes = [ctypes.c_void_p] * 12 + _STRIDES * 7 + rel_shape
    bias.argtypes = [ctypes.c_void_p] * 5 + _STRIDES * 3 + bias_shape
    bias_bwd.argtypes = [ctypes.c_void_p] * 10 + _STRIDES * 4 + bias_shape
    for fn in (fwd, bwd, rel, rel_bwd, bias, bias_bwd):
        fn.restype = ctypes.c_int
    return fwd, bwd, rel, rel_bwd, bias, bias_bwd


def _call(fn, device, pointers, strides, b, h, n, d, n_real, dtype,
          rel_sizes=(), sm_scale=None, bias_dtype=None):
    """Launch on the current stream of ``device``; strides in elements;
    ``rel_sizes`` (KH, KW) for the rel-pos entry points, ``bias_dtype`` for
    the full-bias ones."""
    flags = [int(dtype == torch.bfloat16)]
    if bias_dtype is not None:
        flags.append(int(bias_dtype == torch.bfloat16))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*pointers, *strides, b, h, n, d, n_real, *rel_sizes,
                 _scale(d, sm_scale), *flags, stream)
    if err != 0:
        raise RuntimeError(f"fused attention kernel launch failed: cudaError {err}")


@functools.lru_cache(maxsize=None)
def _short_forward():
    """The bf16 forwards of K3/K4, K2b and (no bias) K1, K2, K9
    (``csrc/short_attention_fwd.cu``)."""
    lib = build.load("short_attention_fwd")
    rel = lib.saicv_short_attention_relpos_fwd
    bias = lib.saicv_short_attention_bias_fwd
    plain = lib.saicv_short_attention_fwd
    rel.argtypes = ([ctypes.c_void_p] * 6 + _STRIDES * 6 + [ctypes.c_int] * 7
                    + [ctypes.c_float, ctypes.c_void_p])
    bias.argtypes = ([ctypes.c_void_p] * 5 + _STRIDES * 5 + [ctypes.c_int] * 5
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    plain.argtypes = ([ctypes.c_void_p] * 4 + _STRIDES * 4 + [ctypes.c_int] * 5
                      + [ctypes.c_float, ctypes.c_void_p])
    rel.restype = bias.restype = plain.restype = ctypes.c_int
    return rel, bias, plain


@functools.lru_cache(maxsize=None)
def _short_backward():
    """The bf16 backwards (``csrc/short_attention_bwd.cu``): without a bias
    (K1, K2, K9), with a full bias (K2b) and with the rel-pos bias (K3,
    K4)."""
    lib = build.load("short_attention_bwd")
    plain = lib.saicv_short_attention_bwd
    bias = lib.saicv_short_attention_bias_bwd
    rel = lib.saicv_short_attention_relpos_bwd
    plain.argtypes = ([ctypes.c_void_p] * 8 + _STRIDES * 5 + [ctypes.c_int] * 5
                      + [ctypes.c_float, ctypes.c_void_p])
    bias.argtypes = ([ctypes.c_void_p] * 10 + _STRIDES * 6 + [ctypes.c_int] * 5
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p])
    rel.argtypes = ([ctypes.c_void_p] * 12 + _STRIDES * 9 + [ctypes.c_int] * 7
                    + [ctypes.c_float, ctypes.c_void_p])
    plain.restype = bias.restype = rel.restype = ctypes.c_int
    return plain, bias, rel


def tma_operand(t):
    """t itself where a TMA tensor map reads it in place (a 16-byte aligned
    base and (batch, head, row) strides that are multiples of 16 bytes on
    every axis longer than 1), else a copy with the last axis padded to a
    multiple of 16 bytes (the maps read its first D columns)."""
    step = 16 // t.element_size()   # elements in 16 bytes
    if t.data_ptr() % 16 == 0 and all(
            s % step == 0 or n == 1
            for s, n in zip(t.stride()[:3], t.shape[:3])):
        return t
    d = t.shape[-1]
    out = t.new_zeros(*t.shape[:3], -(-d // step) * step)
    out[..., :d] = t
    return out


def _launch_short(fn, q, k, v, out, out_strides, extra, extra_strides,
                   shape, after_scale=(), sm_scale=None):
    """A bf16 forward on wgmma: q, k, v [B, H, N, D] (each read in place
    where TMA can, else copied), ``extra`` the bias pointers and their
    strides (none without a bias), ``shape`` (B, H, N, D, n_real[, KH,
    KW])."""
    q, k, v = (tma_operand(t) for t in (q, k, v))
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *extra, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 *out_strides, *extra_strides, *shape,
                 _scale(shape[3], sm_scale), *after_scale, stream)
    if err != 0:
        raise RuntimeError(f"attention kernel launch failed: cudaError {err}")


def _launch(q, k, v, out, out_strides, n_real, sm_scale=None):
    """The forward without a bias: q, k, v [B, H, N, D] views sharing their
    strides (head dim contiguous), ``out`` written at ``out_strides``."""
    b, h, n, d = q.shape
    if q.dtype == torch.bfloat16:
        _launch_short(_short_forward()[2], q, k, v, out, out_strides, (), (),
                       (b, h, n, d, n_real), sm_scale=sm_scale)
        return
    _call(_library()[0], out.device,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()),
          (*q.stride()[:3], *out_strides), b, h, n, d, n_real, q.dtype,
          sm_scale=sm_scale)


def _launch_short_backward(fn, q, k, v, dout, grad_ptrs, grad_strides,
                           extra=(), extra_strides=(), shape=(),
                           after_scale=(), sm_scale=None):
    """A bf16 backward on wgmma: dq, dk, dv (``grad_ptrs``, one stride set)
    from q, k, v and dout [B, H, N, D] (each read in place where TMA can,
    else copied), ``extra`` the bias's pointers (and its gradient's) and
    their strides (none without a bias), ``shape`` (B, H, N, D, n_real[,
    KH, KW])."""
    b, h, n, _ = q.shape
    # scratch of the two launches; freed on return, which is safe because
    # the caching allocator reuses it only for later work on this stream
    stats = torch.empty((2, b, h, n), dtype=torch.float32, device=dout.device)
    ins = [tma_operand(t) for t in (q, k, v, dout)]
    with torch.cuda.device(dout.device):
        stream = torch.cuda.current_stream(dout.device).cuda_stream
        err = fn(*(t.data_ptr() for t in ins), *grad_ptrs, stats.data_ptr(),
                 *extra, *(s for t in ins for s in t.stride()[:3]),
                 *grad_strides, *extra_strides, *shape,
                 _scale(shape[3], sm_scale), *after_scale, stream)
    if err != 0:
        raise RuntimeError(
            f"attention backward kernel launch failed: cudaError {err}")


def _launch_backward(q, k, v, dout, grad_ptrs, grad_strides, n_real,
                     sm_scale=None):
    """dq, dk, dv (``grad_ptrs``, one stride set) from q, k, v [B, H, N, D]
    views sharing their strides and ``dout`` [B, H, N, D], each with its
    head dim contiguous."""
    b, h, n, d = q.shape
    if q.dtype == torch.bfloat16:
        _launch_short_backward(_short_backward()[0], q, k, v, dout, grad_ptrs,
                               grad_strides, shape=(b, h, n, d, n_real),
                               sm_scale=sm_scale)
        return
    stats = torch.empty((2, b, h, n), dtype=torch.float32, device=dout.device)
    _call(_library()[1], dout.device,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
           *grad_ptrs, stats.data_ptr()),
          (*q.stride()[:3], *dout.stride()[:3], *grad_strides), b, h, n, d,
          n_real, dout.dtype, sm_scale=sm_scale)


def _launch_relpos(q_ptr, k_ptr, v_ptr, out, rel_h, rel_w, strides, b, h,
                   n, d, n_real, kh, kw, dtype):
    """K3/K4: the forward kernel with the rel-pos bias; ``strides``: the
    (batch, head, row) strides of the inputs, the output, rel_h and rel_w."""
    _call(_library()[2], out.device,
          (q_ptr, k_ptr, v_ptr, out.data_ptr(), rel_h.data_ptr(),
           rel_w.data_ptr()), strides, b, h, n, d, n_real, dtype, (kh, kw))


def _launch_relpos_backward(q_ptr, k_ptr, v_ptr, dout, grad_ptrs, rel_h,
                            rel_w, drel_h, drel_w, strides, b, h, n, d,
                            n_real, kh, kw):
    """K3/K4 backward in fp32: dq, dk, dv (``grad_ptrs``) and drel_h,
    drel_w; ``strides``: the (batch, head, row) strides of the inputs, dout,
    the gradients, rel_h, rel_w, drel_h and drel_w."""
    stats = torch.empty((2, b, h, n), dtype=torch.float32, device=dout.device)
    _call(_library()[3], dout.device,
          (q_ptr, k_ptr, v_ptr, dout.data_ptr(), *grad_ptrs, stats.data_ptr(),
           rel_h.data_ptr(), rel_w.data_ptr(), drel_h.data_ptr(),
           drel_w.data_ptr()), strides, b, h, n, d, n_real, dout.dtype,
          (kh, kw))


def _launch_relpos_backward_short(q, k, v, dout, grad_ptrs, grad_strides,
                                  rel_h, rel_w, drel_h, drel_w, rel_strides,
                                  n_real):
    """K3/K4 backward in bf16: dq, dk, dv (``grad_ptrs``, ``grad_strides``)
    and drel_h, drel_w from q, k, v and dout [B, H, N, D] views;
    ``rel_strides`` the (batch, head, row) strides of rel_h, rel_w, drel_h
    and drel_w."""
    b, h, n, d = q.shape
    _launch_short_backward(
        _short_backward()[2], q, k, v, dout, grad_ptrs, grad_strides,
        (rel_h.data_ptr(), rel_w.data_ptr(), drel_h.data_ptr(),
         drel_w.data_ptr()), rel_strides,
        (b, h, n, d, n_real, rel_h.shape[-1], rel_w.shape[-1]))


def dbias_buffer_dtype(bias, full_shape, dtype):
    """The dtype of the [B, H, N, N] buffer that K2b's backward kernel
    writes dS0 into, for inputs of ``dtype``: the bias's own where the bf16
    kernel writes dbias whole (a bias of the full shape, rounded once from
    the fp32 dS0), else fp32 (the fp32 kernel, or a broadcast bias whose
    gradient the wrapper then sums over the broadcast axes and casts)."""
    if dtype == torch.bfloat16 and tuple(bias.shape) == tuple(full_shape):
        return bias.dtype
    return torch.float32


def _packed_strides(n, h, d):
    """(batch, head, row) strides of q, k, v in a packed [B, N, 3, H, D]."""
    return n * 3 * h * d, d, 3 * h * d


def _require_cuda(t):
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")


def _same_device(*tensors):
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all tensors must lie on one device")


class FusedAttentionDense(torch.autograd.Function):
    """K1 with its backward kernel; saves qkv only."""

    @staticmethod
    def forward(ctx, qkv, head_nums, n_real, sm_scale):
        ctx.head_nums, ctx.n_real, ctx.sm_scale = head_nums, n_real, sm_scale
        ctx.save_for_backward(qkv)
        if qkv.device.type == "cpu":
            return fused_attention_dense_reference(qkv, head_nums, n_real,
                                                   sm_scale)
        _require_cuda(qkv)
        b, n, c, d, n_real = check_dense_args(qkv, head_nums, n_real)
        out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
        _launch(*_unpack(qkv.view(b, n, 3, head_nums, d)), out, (n * c, d, c),
                n_real, sm_scale)
        fused_attention_dense.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        dout = dout.to(qkv.dtype)
        if qkv.device.type == "cpu":
            return (fused_attention_dense_backward_reference(
                qkv, dout, ctx.head_nums, ctx.n_real, ctx.sm_scale), None,
                None, None)
        b, n, c, d, n_real = check_dense_args(qkv, ctx.head_nums, ctx.n_real)
        dout = dout.contiguous().view(b, n, ctx.head_nums, d).transpose(1, 2)
        dqkv = torch.empty_like(qkv)
        es = qkv.element_size()
        grad = dqkv.data_ptr()
        _launch_backward(*_unpack(qkv.view(b, n, 3, ctx.head_nums, d)), dout,
                         (grad, grad + c * es, grad + 2 * c * es),
                         _packed_strides(n, ctx.head_nums, d), n_real,
                         ctx.sm_scale)
        fused_attention_dense.backward_launches += 1
        return dqkv, None, None, None


class FusedAttention(torch.autograd.Function):
    """K2 with its backward kernel; saves q, k, v only.

    The backward returns dq, dk, dv as contiguous [B, H, N, D] tensors.
    When q, k, v are views of one packed qkv (as the attention module makes
    them), autograd then stacks the three and copies the stack back into
    the packed [B, N, 3C] layout: two layout copies of the gradient that
    K1's route does not have."""

    @staticmethod
    def forward(ctx, q, k, v, n_real):
        ctx.n_real = n_real
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return fused_attention_reference(q, k, v, n_real)
        _require_cuda(q)
        b, h, n, d, n_real = check_args(q, k, v, n_real)
        out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
        _launch(q, k, v, out, (h * n * d, n * d, d), n_real)
        fused_attention.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dout = dout.to(q.dtype)
        if q.device.type == "cpu":
            return (*fused_attention_backward_reference(q, k, v, dout,
                                                        ctx.n_real), None)
        b, h, n, d, n_real = check_args(q, k, v, ctx.n_real)
        if dout.stride(3) != 1:
            dout = dout.contiguous()
        grads = torch.empty((3, b, h, n, d), dtype=q.dtype, device=q.device)
        _launch_backward(q, k, v, dout, [g.data_ptr() for g in grads],
                         (h * n * d, n * d, d), n_real)
        fused_attention.backward_launches += 1
        return grads[0], grads[1], grads[2], None


def fused_attention_dense(qkv, head_nums, n_real=None, sm_scale=None):
    """K1: attention over the packed qkv Dense output [B, N, 3C] -> [B, N, C];
    scores scaled by ``sm_scale`` (default D^-0.5)."""
    return FusedAttentionDense.apply(qkv, head_nums, n_real, sm_scale)


def fused_attention(q, k, v, n_real=None, bias=None):
    """K2: [B, H, N, D] self-attention fused on chip -> [B, H, N, D]; with
    ``bias``, a score bias that broadcasts to [B, H, N, N], K2b
    (``fused_attention_bias``)."""
    if bias is not None:
        return fused_attention_bias(q, k, v, bias, n_real)
    return FusedAttention.apply(q, k, v, n_real)


class FusedAttentionBias(torch.autograd.Function):
    """K2b with its backward kernel; saves q, k, v and the bias. The
    backward returns dq, dk, dv as contiguous [B, H, N, D] tensors and,
    when the bias needs one, its gradient in its own shape and dtype."""

    @staticmethod
    def forward(ctx, q, k, v, bias, n_real):
        ctx.n_real = n_real
        ctx.save_for_backward(q, k, v, bias)
        if q.device.type == "cpu":
            return fused_attention_bias_reference(q, k, v, bias, n_real)
        _require_cuda(q)
        _same_device(q, k, v, bias)
        b, h, n, d, n_real = check_args(q, k, v, n_real)
        full = check_bias_args(bias, (b, h, n, n))
        out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
        if q.dtype == torch.bfloat16:
            _launch_short(_short_forward()[1], q, k, v, out,
                           (h * n * d, n * d, d), (full.data_ptr(),),
                           full.stride()[:3], (b, h, n, d, n_real),
                           (int(bias.dtype == torch.bfloat16),))
        else:
            _call(_library()[4], q.device,
                  (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   full.data_ptr()),
                  (*q.stride()[:3], h * n * d, n * d, d, *full.stride()[:3]),
                  b, h, n, d, n_real, q.dtype, bias_dtype=bias.dtype)
        fused_attention_bias.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias = ctx.saved_tensors
        dout = dout.to(q.dtype)
        wants_dbias = ctx.needs_input_grad[3]
        if q.device.type == "cpu":
            dq, dk, dv, dbias = fused_attention_bias_backward_reference(
                q, k, v, bias, dout, ctx.n_real)
            return dq, dk, dv, dbias if wants_dbias else None, None
        b, h, n, d, n_real = check_args(q, k, v, ctx.n_real)
        full = check_bias_args(bias, (b, h, n, n))
        if dout.stride(3) != 1:
            dout = dout.contiguous()
        grads = torch.empty((3, b, h, n, d), dtype=q.dtype, device=q.device)
        grad_ptrs = [g.data_ptr() for g in grads]
        # dS0 [B, H, N, N], written unless the bias needs no gradient
        dbias = (torch.empty((b, h, n, n), device=q.device,
                             dtype=dbias_buffer_dtype(bias, (b, h, n, n),
                                                      q.dtype))
                 if wants_dbias else None)
        dbias_ptr = None if dbias is None else dbias.data_ptr()
        if q.dtype == torch.bfloat16:
            _launch_short_backward(
                _short_backward()[1], q, k, v, dout, grad_ptrs,
                (h * n * d, n * d, d), (full.data_ptr(), dbias_ptr),
                full.stride()[:3], (b, h, n, d, n_real),
                (int(bias.dtype == torch.bfloat16),
                 int(dbias is not None and dbias.dtype == torch.bfloat16)))
        else:
            stats = torch.empty((2, b, h, n), dtype=torch.float32,
                                device=q.device)
            _call(_library()[5], q.device,
                  (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                   *grad_ptrs, stats.data_ptr(), full.data_ptr(), dbias_ptr),
                  (*q.stride()[:3], *dout.stride()[:3], h * n * d, n * d, d,
                   *full.stride()[:3]), b, h, n, d, n_real, q.dtype,
                  bias_dtype=bias.dtype)
        fused_attention_bias.backward_launches += 1
        if dbias is not None:   # the VJP of the broadcast, in the bias dtype
            dbias = dbias.sum_to_size(bias.shape).to(bias.dtype)
        return grads[0], grads[1], grads[2], dbias, None


def fused_attention_bias(q, k, v, bias, n_real=None):
    """K2b: K2 (q, k, v [B, H, N, D], D <= 128, N <= 1024, shared strides,
    head dim contiguous) with a full score bias: any shape that broadcasts
    to [B, H, N, N], fp32 or bf16, its key axis contiguous, added to the
    fp32 scores before the ``n_real`` key mask -> [B, H, N, D]."""
    return FusedAttentionBias.apply(q, k, v, bias, n_real)


class FusedAttentionQKV(torch.autograd.Function):
    """K9 with its backward kernel (K1's kernels at the packed strides);
    saves qkv only."""

    @staticmethod
    def forward(ctx, qkv, n_real):
        ctx.n_real = n_real
        ctx.save_for_backward(qkv)
        if qkv.device.type == "cpu":
            return fused_attention_qkv_reference(qkv, n_real)
        _require_cuda(qkv)
        b, n, h, d, n_real = check_qkv_args(qkv, n_real)
        out = torch.empty((b, n, h, d), dtype=qkv.dtype, device=qkv.device)
        _launch(*_unpack(qkv), out, (n * h * d, d, h * d), n_real)
        fused_attention_qkv.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        dout = dout.to(qkv.dtype)
        if qkv.device.type == "cpu":
            return (fused_attention_qkv_backward_reference(qkv, dout,
                                                           ctx.n_real), None)
        b, n, h, d, n_real = check_qkv_args(qkv, ctx.n_real)
        if dout.stride(3) != 1:
            dout = dout.contiguous()
        dqkv = torch.empty_like(qkv)
        grad, step = dqkv.data_ptr(), h * d * qkv.element_size()
        _launch_backward(*_unpack(qkv), dout.transpose(1, 2),
                         (grad, grad + step, grad + 2 * step),
                         _packed_strides(n, h, d), n_real)
        fused_attention_qkv.backward_launches += 1
        return dqkv, None


def fused_attention_qkv(qkv, n_real=None):
    """K9: self-attention over a packed qkv [B, N, 3, H, D] (contiguous, D <=
    128, N <= 1024) -> [B, N, H, D]; keys at or past ``n_real`` masked. The
    backward writes the packed dqkv."""
    return FusedAttentionQKV.apply(qkv, n_real)


class FusedAttentionRelwinDense(torch.autograd.Function):
    """K3 with its backward kernel; saves qkv, rel_h and rel_w."""

    @staticmethod
    def forward(ctx, qkv, rel_h, rel_w, head_nums):
        ctx.head_nums = head_nums
        ctx.save_for_backward(qkv, rel_h, rel_w)
        if qkv.device.type == "cpu":
            return fused_attention_relwin_dense_reference(qkv, rel_h, rel_w,
                                                          head_nums)
        _require_cuda(qkv)
        _same_device(qkv, rel_h, rel_w)
        b, n, c, d, _ = check_dense_args(qkv, head_nums)
        kh, kw = check_rel_args(rel_h, rel_w, (b, n, head_nums), n)
        out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
        rel_strides = (*_dense_rel_strides(rel_h), *_dense_rel_strides(rel_w))
        if qkv.dtype == torch.bfloat16:
            q, k, v = _unpack(qkv.view(b, n, 3, head_nums, d))
            _launch_short(_short_forward()[0], q, k, v, out, (n * c, d, c),
                           (rel_h.data_ptr(), rel_w.data_ptr()), rel_strides,
                           (b, head_nums, n, d, n, kh, kw))
        else:
            es = qkv.element_size()
            base = qkv.data_ptr()
            _launch_relpos(base, base + c * es, base + 2 * c * es, out, rel_h,
                           rel_w, (*_packed_strides(n, head_nums, d), n * c, d,
                                   c, *rel_strides),
                           b, head_nums, n, d, n, kh, kw, qkv.dtype)
        fused_attention_relwin_dense.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        qkv, rel_h, rel_w = ctx.saved_tensors
        dout = dout.to(qkv.dtype)
        if qkv.device.type == "cpu":
            return (*fused_attention_relwin_dense_backward_reference(
                qkv, rel_h, rel_w, dout, ctx.head_nums), None)
        b, n, c, d, _ = check_dense_args(qkv, ctx.head_nums)
        kh, kw = rel_h.shape[-1], rel_w.shape[-1]
        dout = dout.contiguous()
        dqkv = torch.empty_like(qkv)
        drel_h = torch.empty(rel_h.shape, dtype=torch.float32,
                             device=qkv.device)
        drel_w = torch.empty(rel_w.shape, dtype=torch.float32,
                             device=qkv.device)
        es = qkv.element_size()
        base, grad = qkv.data_ptr(), dqkv.data_ptr()
        grad_ptrs = (grad, grad + c * es, grad + 2 * c * es)
        packed = _packed_strides(n, ctx.head_nums, d)
        rel_strides = tuple(s for t in (rel_h, rel_w, drel_h, drel_w)
                            for s in _dense_rel_strides(t))
        if qkv.dtype == torch.bfloat16:
            q, k, v = _unpack(qkv.view(b, n, 3, ctx.head_nums, d))
            _launch_relpos_backward_short(
                q, k, v, dout.view(b, n, ctx.head_nums, d).transpose(1, 2),
                grad_ptrs, packed, rel_h, rel_w, drel_h, drel_w, rel_strides,
                n)
        else:
            _launch_relpos_backward(
                base, base + c * es, base + 2 * c * es, dout, grad_ptrs,
                rel_h, rel_w, drel_h, drel_w,
                (*packed, n * c, d, c, *packed, *rel_strides),
                b, ctx.head_nums, n, d, n, kh, kw)
        fused_attention_relwin_dense.backward_launches += 1
        return dqkv, drel_h, drel_w, None


class FusedAttentionRelwin(torch.autograd.Function):
    """K4 with its backward kernel; saves q, k, v, rel_h and rel_w. The
    backward returns dq, dk, dv as contiguous [B, H, N, D] tensors."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, n_real):
        ctx.n_real = n_real
        ctx.save_for_backward(q, k, v, rel_h, rel_w)
        if q.device.type == "cpu":
            return fused_attention_relwin_reference(q, k, v, rel_h, rel_w,
                                                    n_real)
        _require_cuda(q)
        _same_device(q, k, v, rel_h, rel_w)
        b, h, n, d, n_real = check_args(q, k, v, n_real)
        kh, kw = check_rel_args(rel_h, rel_w, (b, h, n), n)
        out = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
        rel_strides = (*rel_h.stride()[:3], *rel_w.stride()[:3])
        if q.dtype == torch.bfloat16:
            _launch_short(_short_forward()[0], q, k, v, out,
                           (n * h * d, d, h * d),
                           (rel_h.data_ptr(), rel_w.data_ptr()), rel_strides,
                           (b, h, n, d, n_real, kh, kw))
        else:
            _launch_relpos(q.data_ptr(), k.data_ptr(), v.data_ptr(), out, rel_h,
                           rel_w, (*q.stride()[:3], n * h * d, d, h * d,
                                   *rel_strides), b, h, n, d, n_real, kh, kw,
                           q.dtype)
        fused_attention_relwin.launches += 1
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, rel_h, rel_w = ctx.saved_tensors
        dout = dout.to(q.dtype)
        if q.device.type == "cpu":
            return (*fused_attention_relwin_backward_reference(
                q, k, v, rel_h, rel_w, dout, ctx.n_real), None)
        b, h, n, d, n_real = check_args(q, k, v, ctx.n_real)
        kh, kw = rel_h.shape[-1], rel_w.shape[-1]
        if dout.stride(3) != 1:
            dout = dout.contiguous()
        grads = torch.empty((3, b, h, n, d), dtype=q.dtype, device=q.device)
        drel_h = torch.empty((b, h, n, kh), dtype=torch.float32,
                             device=q.device)
        drel_w = torch.empty((b, h, n, kw), dtype=torch.float32,
                             device=q.device)
        grad_ptrs = [g.data_ptr() for g in grads]
        rel_strides = tuple(s for t in (rel_h, rel_w, drel_h, drel_w)
                            for s in t.stride()[:3])
        if q.dtype == torch.bfloat16:
            _launch_relpos_backward_short(
                q, k, v, dout, grad_ptrs, (h * n * d, n * d, d), rel_h, rel_w,
                drel_h, drel_w, rel_strides, n_real)
        else:
            _launch_relpos_backward(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout, grad_ptrs,
                rel_h, rel_w, drel_h, drel_w,
                (*q.stride()[:3], *dout.stride()[:3], h * n * d, n * d, d,
                 *rel_strides), b, h, n, d, n_real, kh, kw)
        fused_attention_relwin.backward_launches += 1
        return grads[0], grads[1], grads[2], drel_h, drel_w, None


def _dense_rel_strides(t):
    """(batch, head, row) strides of a K3 rel term [B, N, H, K]."""
    return t.stride(0), t.stride(2), t.stride(1)


def fused_attention_relwin_dense(qkv, rel_h, rel_w, head_nums):
    """K3: windowed attention with SAM's decomposed rel-pos bias straight
    over the packed qkv [B, N, 3C] (head dim 64 or 128, N <= 1024), with
    rel_h [B, N, H, KH] and rel_w [B, N, H, KW] fp32 -> [B, N, C]."""
    return FusedAttentionRelwinDense.apply(qkv, rel_h, rel_w, head_nums)


def fused_attention_relwin(q, k, v, rel_h, rel_w, n_real=None):
    """K4: K3's math on q, k, v [B, H, N, D] (D <= 128, N <= 1024, shared
    strides, head dim contiguous) with rel_h [B, H, N, KH], rel_w [B, H, N,
    KW] fp32 and keys at or past ``n_real`` masked. Returns [B, H, N, D]: a
    view of a [B, N, H, D] tensor, so the attention module's transpose back
    to tokens costs no copy."""
    return FusedAttentionRelwin.apply(q, k, v, rel_h, rel_w, n_real)


for _wrapper in (fused_attention_dense, fused_attention,
                 fused_attention_relwin_dense, fused_attention_relwin,
                 fused_attention_bias, fused_attention_qkv):
    _wrapper.launches = 0
    _wrapper.backward_launches = 0
