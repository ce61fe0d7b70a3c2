"""Short-sequence fused self-attention (forward): kernels K1 and K2.

Counterpart of the JAX package's ``ops/pallas/fused_attention.py``:

- ``fused_attention_dense`` (K1) attends straight over the packed qkv Dense
  output ``[B, N, 3C]`` (column order ``[3, H, D]``) and returns
  ``[B, N, C]``, ready for the proj Dense. Head dim 64 or 128.
- ``fused_attention`` (K2) takes ``q, k, v`` as ``[B, H, N, D]``, D <= 128,
  read in place through their strides (head dim contiguous), so views of
  the packed qkv output need no layout copy.

Both launch one CUDA kernel (``csrc/fused_attention.cu``) that never
writes the scores or the probabilities to device memory; N <= 1024. The
math is the TPU kernels': fp32 scores scaled by D^-0.5, keys at or past
``n_real`` set to -1e9, fp32 softmax, probabilities normalised and then
cast to the input dtype, P.V with fp32 accumulation.

A CPU tensor takes the plain PyTorch version (``*_reference``); a CUDA
tensor takes the kernel, or the call raises. Each wrapper counts its kernel
launches in ``<wrapper>.launches``.
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


def fused_attention_reference(q, k, v, n_real=None):
    """Plain version of K2 (the JAX ``_reference``): [B, H, N, D] -> same."""
    n = k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s * (q.shape[-1] ** -0.5)
    if n_real is not None and n_real < n:
        keep = torch.arange(n, device=q.device) < n_real
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p.float(), v.float()).to(q.dtype)


def fused_attention_dense_reference(qkv, head_nums, n_real=None):
    """Plain version of K1: [B, N, 3C] -> [B, N, C] through K2's math."""
    b, n, c3 = qkv.shape
    c = c3 // 3
    q, k, v = qkv.reshape(b, n, 3, head_nums, c // head_nums).permute(
        2, 0, 3, 1, 4).unbind(0)
    out = fused_attention_reference(q, k, v, n_real)
    return out.transpose(1, 2).reshape(b, n, c)


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


@functools.lru_cache(maxsize=None)
def _library():
    fn = build.load("fused_attention").saicv_fused_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 6
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q_ptr, k_ptr, v_ptr, out, in_strides, out_strides, b, h, n, d,
            n_real, dtype):
    """Launch the kernel on the current stream of ``out``'s device."""
    fn = _library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(q_ptr, k_ptr, v_ptr, out.data_ptr(), *in_strides, *out_strides,
                 b, h, n, d, n_real, d ** -0.5, int(dtype == torch.bfloat16),
                 stream)
    if err != 0:
        raise RuntimeError(f"fused attention kernel launch failed: cudaError {err}")


def fused_attention_dense(qkv, head_nums, n_real=None):
    """K1: attention over the packed qkv Dense output [B, N, 3C] -> [B, N, C]."""
    if qkv.device.type == "cpu":
        return fused_attention_dense_reference(qkv, head_nums, n_real)
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    b, n, c, d, n_real = check_dense_args(qkv, head_nums, n_real)
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    es = qkv.element_size()
    base = qkv.data_ptr()
    _launch(base, base + c * es, base + 2 * c * es, out,
            (n * 3 * c, d, 3 * c), (n * c, d, c), b, head_nums, n, d, n_real,
            qkv.dtype)
    fused_attention_dense.launches += 1
    return out


fused_attention_dense.launches = 0


def fused_attention(q, k, v, n_real=None):
    """K2: [B, H, N, D] self-attention fused on chip -> [B, H, N, D]."""
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, n_real)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, n, d, n_real = check_args(q, k, v, n_real)
    out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    _launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out, q.stride()[:3],
            (h * n * d, n * d, d), b, h, n, d, n_real, q.dtype)
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
