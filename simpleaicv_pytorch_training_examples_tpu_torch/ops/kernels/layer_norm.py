"""Fused LayerNorm over the last axis, forward and backward: kernel K7.

Counterpart of the JAX package's ``ops/pallas/layer_norm.py``:
``layer_norm(x, gamma, beta, eps)`` takes ``x [..., C]`` in bf16 or fp32 and
fp32 ``gamma``/``beta`` (never rounded to bf16), computes the statistics and
the affine map in fp32 and rounds once to x's dtype. bf16 goes in and bf16
comes out with no fp32 copy of the activation in device memory.

It is a ``torch.autograd.Function`` (``FusedLayerNormFunction``): the forward
kernel also emits each row's mean and rstd, which are saved with x and
gamma; the backward kernel gives dx in dy's dtype and dgamma, dbeta in fp32,
summed over all rows through per-warp partial sums and a second small kernel
in a fixed order (no atomics, so the sums are reproducible). Both kernels
are in ``csrc/layer_norm.cu``; rows are never padded.

A CPU tensor takes the plain PyTorch version (``layer_norm_reference``,
``layer_norm_backward_reference``, two-pass variance); a CUDA tensor takes
the kernel, or the call raises. ``layer_norm.launches`` and
``layer_norm.backward_launches`` count the kernel launches.
"""

import ctypes
import functools

import torch

from . import build

_DTYPES = (torch.bfloat16, torch.float32)


def _statistics(x, eps):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    return xf, mean, torch.rsqrt(var + eps)


def layer_norm_reference(x, gamma, beta, eps=1e-6):
    """Plain version of K7's forward (the JAX ``_reference``)."""
    xf, mean, rstd = _statistics(x, eps)
    return ((xf - mean) * rstd * gamma.float() + beta.float()).to(x.dtype)


def layer_norm_backward_reference(x, gamma, dy, eps=1e-6):
    """Plain version of K7's backward (the JAX ``_bwd_kernel``): returns dx in
    dy's dtype and dgamma, dbeta in fp32 summed over all leading dims."""
    xf, mean, rstd = _statistics(x, eps)
    xhat = (xf - mean) * rstd
    dyf = dy.float()
    g = dyf * gamma.float()
    mg = g.mean(dim=-1, keepdim=True)
    mgx = (g * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd * (g - mg - xhat * mgx)).to(dy.dtype)
    lead = tuple(range(x.dim() - 1))
    return dx, (dyf * xhat).sum(dim=lead), dyf.sum(dim=lead)


def check_args(x, gamma, beta):
    """Shape rule of K7; returns (rows, c) or raises."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"x: dtype {x.dtype} is not bfloat16 or float32")
    c = x.shape[-1]
    for name, t in (("gamma", gamma), ("beta", beta)):
        if t.dtype != torch.float32 or tuple(t.shape) != (c,) \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 [{c}] "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.numel() == 0:
        raise ValueError("x is empty")
    return x.numel() // c, c


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("layer_norm")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.saicv_layer_norm_fwd.argtypes = [ptr] * 6 + [i64, i32, ctypes.c_float,
                                                    i32, ptr]
    lib.saicv_layer_norm_bwd.argtypes = [ptr] * 8 + [i64, i32, i32, ptr]
    lib.saicv_layer_norm_bwd_partial_rows.argtypes = [i64]
    for fn in (lib.saicv_layer_norm_fwd, lib.saicv_layer_norm_bwd,
               lib.saicv_layer_norm_bwd_partial_rows):
        fn.restype = i32
    return lib


def _call(fn, device, *args):
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"layer norm kernel launch failed: cudaError {err}")


class FusedLayerNormFunction(torch.autograd.Function):
    """K7 with its backward kernel; saves x, gamma, mean and rstd."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.eps = eps
        if x.device.type == "cpu":
            ctx.save_for_backward(x, gamma)
            return layer_norm_reference(x, gamma, beta, eps)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        rows, c = check_args(x, gamma, beta)
        x = x.contiguous()
        y = torch.empty_like(x)
        mean = torch.empty(rows, dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
        _call(_library().saicv_layer_norm_fwd, x.device, x.data_ptr(),
              gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
              mean.data_ptr(), rstd.data_ptr(), rows, c, eps,
              int(x.dtype == torch.bfloat16))
        layer_norm.launches += 1
        ctx.save_for_backward(x, gamma, mean, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        # saved_tensors read once: under non-reentrant checkpointing each
        # read unpacks the recomputed tensors, and a second read raises
        saved = ctx.saved_tensors
        x, gamma = saved[:2]
        dy = dy.to(x.dtype)
        if x.device.type == "cpu":
            return (*layer_norm_backward_reference(x, gamma, dy, ctx.eps),
                    None)
        mean, rstd = saved[2:]
        rows, c = mean.numel(), x.shape[-1]
        dy = dy.contiguous()
        dx = torch.empty_like(x)
        lib = _library()
        # per-warp partial sums; freed on return, which is safe because the
        # caching allocator reuses it only for later work on this stream
        partial = torch.empty(
            (lib.saicv_layer_norm_bwd_partial_rows(rows), 2 * c),
            dtype=torch.float32, device=x.device)
        sums = torch.empty((2, c), dtype=torch.float32, device=x.device)
        _call(lib.saicv_layer_norm_bwd, x.device, x.data_ptr(),
              gamma.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
              dy.data_ptr(), dx.data_ptr(), partial.data_ptr(),
              sums.data_ptr(), rows, c, int(x.dtype == torch.bfloat16))
        layer_norm.backward_launches += 1
        return dx, sums[0], sums[1], None


def layer_norm(x, gamma, beta, eps=1e-6):
    """K7: LayerNorm of x [..., C] over C with fp32 gamma, beta [C]."""
    return FusedLayerNormFunction.apply(x, gamma, beta, eps)


layer_norm.launches = 0
layer_norm.backward_launches = 0
