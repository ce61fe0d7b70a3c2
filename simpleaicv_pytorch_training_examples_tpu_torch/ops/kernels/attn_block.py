"""Fused ViT attention block, forward and backward: kernel K8.

Counterpart of the JAX package's ``ops/pallas/attn_block.py``:
``attn_block(x, wqkv, bqkv, wproj, bproj, gamma, beta, head_nums, eps)``
computes ``y = x + proj(attention(qkv(LayerNorm(x))))`` for x ``[B, N, C]``
with head dim ``C / head_nums`` in {64, 128} and N <= 1024, in bf16 or
fp32. The weights are in torch's Linear layout (``wqkv [3C, C]``, ``wproj
[C, C]``, the JAX kernel takes flax's ``[in, out]``) and in x's dtype, as the
model's block passes them; ``gamma`` and ``beta`` are fp32 and never
rounded. The qkv columns are ordered ``[3, H, D]``.

It is a ``torch.autograd.Function`` (``AttnBlock``) that saves only its
inputs: the backward computes LayerNorm, qkv and the attention output
again, as the TPU kernel does, and returns dx in x's dtype and the weight,
bias, gamma and beta gradients summed over all B*N rows in fp32 in a fixed
order, cast to each input's dtype (the model's bf16 weight copies get bf16
gradients, as in JAX). Both directions are hand-written CUDA in
``csrc/attn_block.cu``: its own LayerNorm, GEMMs, column sums and LayerNorm
backward, and the attention core by K1's device code (launched and counted
here, not on ``fused_attention_dense``'s counters). The intermediates (xn,
qkv, the attention output; in the backward also dattn, dqkv, dxn) live in a
workspace allocated for the call and freed after it.

A CPU tensor takes the plain PyTorch version (``attn_block_reference``, the
JAX ``_reference_block``, and ``attn_block_backward_reference``, autograd
of it); a CUDA tensor takes the kernel, or the call raises: a shape, dtype
or layout the kernel cannot take is refused, never sent to the plain
version. ``attn_block.launches`` and ``attn_block.backward_launches`` count
the kernel's forward and backward calls.

``gemm`` runs one bf16 product of K8's GEMM alone, at an operand layout and
epilogue of ``GEMM_PRODUCTS`` (its tests hold each product K8 runs against
``gemm_reference``, an fp32 product of the bf16 operands with the epilogue,
rounded once); ``gemm.launches`` counts its launches.
"""

import ctypes
import functools

import torch

from . import build

HEAD_DIMS = (64, 128)
MAX_TOKENS = 1024
_DTYPES = (torch.bfloat16, torch.float32)
# the GEMM's epilogues, as attn_block.cu numbers them ("weight_gradient":
# fp32 slices over K added in order)
GEMM_EPILOGUES = {"store": 0, "bias": 1, "bias_residual": 2, "store_f32": 3,
                  "weight_gradient": 4}
# (A K-major, B K-major, epilogue) of each bf16 product K8 runs; A is [M, K]
# when K-major, else [K, M]; B is [N, K] when K-major, else [K, N]
GEMM_PRODUCTS = {
    "qkv": (True, True, "bias"),               # xn . Wqkv^T + bqkv
    "proj": (True, True, "bias_residual"),     # attn . Wproj^T + bproj + x
    "dattn": (True, False, "store"),           # dy . Wproj
    "dxn": (True, False, "store_f32"),         # dqkv . Wqkv
    "dwproj": (False, False, "weight_gradient"),   # dy^T . attn
    "dwqkv": (False, False, "weight_gradient"),    # dqkv^T . xn
}


def attn_block_reference(x, wqkv, bqkv, wproj, bproj, gamma, beta, head_nums,
                         eps=1e-6):
    """Plain version of K8's forward (the JAX ``_reference_block``): LN in
    fp32 rounded to x's dtype, the qkv and proj products and their bias
    adds in x's dtype, fp32 scores and softmax, P rounded for P.V, and the
    projection rounded before the residual add."""
    b, n, c = x.shape
    d = c // head_nums
    dtype = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    xn = ((xf - mean) * torch.rsqrt(var + eps) * gamma.float()
          + beta.float()).to(dtype)
    qkv = xn @ wqkv.to(dtype).t() + bqkv.to(dtype)
    q, k, v = qkv.reshape(b, n, 3, head_nums, d).permute(2, 0, 3, 1, 4)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * d ** -0.5
    p = torch.softmax(logits, dim=-1).to(dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", p, v)
    o = o.transpose(1, 2).reshape(b, n, c)
    y = o @ wproj.to(dtype).t() + bproj.to(dtype)
    return y + x


def attn_block_backward_reference(x, wqkv, bqkv, wproj, bproj, gamma, beta,
                                  dy, head_nums, eps=1e-6):
    """Plain version of K8's backward: autograd of ``attn_block_reference``.
    Returns dx, dwqkv, dbqkv, dwproj, dbproj, dgamma, dbeta, each in its
    input's dtype."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (x, wqkv, bqkv, wproj, bproj, gamma, beta)]
        y = attn_block_reference(*leaves, head_nums, eps)
        return torch.autograd.grad(y, leaves, dy.to(y.dtype))


def gemm_reference(a, b, a_kmajor=True, b_kmajor=True, epilogue="store",
                   bias=None, resid=None):
    """Plain version of K8's GEMM: C = A.B of the operands in fp32, then the
    epilogue in fp32 (+ bias[n], + resid[m, n]), rounded once to a's dtype;
    "store_f32" and "weight_gradient" stay fp32."""
    am = a.float() if a_kmajor else a.float().t()
    bm = b.float().t() if b_kmajor else b.float()
    out = am @ bm
    if epilogue in ("bias", "bias_residual"):
        out = out + bias.float()
    if epilogue == "bias_residual":
        out = out + resid.float()
    if epilogue in ("store_f32", "weight_gradient"):
        return out
    return out.to(a.dtype)


def gemm_shape(a, b, a_kmajor, b_kmajor, epilogue, bias, resid):
    """(M, N, K) of one product, or raises."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"operands must be 2-D, got {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    m, k = a.shape if a_kmajor else (a.shape[1], a.shape[0])
    n, kb = b.shape if b_kmajor else (b.shape[1], b.shape[0])
    if k != kb:
        raise ValueError(f"K differs: A gives {k}, B {kb}")
    if epilogue not in GEMM_EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if epilogue in ("bias", "bias_residual") and (
            bias is None or tuple(bias.shape) != (n,)):
        raise ValueError(f"epilogue {epilogue!r} needs a bias [{n}]")
    if epilogue == "bias_residual" and (
            resid is None or tuple(resid.shape) != (m, n)):
        raise ValueError(f"epilogue 'bias_residual' needs resid [{m}, {n}]")
    return m, n, k


def gemm(a, b, a_kmajor=True, b_kmajor=True, epilogue="store", bias=None,
         resid=None):
    """One product of K8's GEMM (see ``gemm_reference``). A CPU tensor takes
    the plain version; a CUDA tensor takes the kernel (bf16, a layout and
    epilogue of ``GEMM_PRODUCTS``, every inner extent a multiple of 8) or
    the call raises."""
    m, n, k = gemm_shape(a, b, a_kmajor, b_kmajor, epilogue, bias, resid)
    if a.device.type == "cpu":
        return gemm_reference(a, b, a_kmajor, b_kmajor, epilogue, bias, resid)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if (a_kmajor, b_kmajor, epilogue) not in GEMM_PRODUCTS.values():
        raise ValueError(f"K8's GEMM does not run A K-major={a_kmajor}, B "
                         f"K-major={b_kmajor} with epilogue {epilogue!r}")
    extras = [t for t in (bias, resid) if t is not None]
    if any(t.dtype != torch.bfloat16 or t.device != a.device
           for t in [a, b] + extras):
        raise TypeError("K8's GEMM takes bfloat16 tensors on one device")
    inner = (k if a_kmajor else m, k if b_kmajor else n, n)
    if any(e % 8 for e in inner):
        raise ValueError(f"inner extents {inner} are not multiples of 8")
    a, b = _ready(a), _ready(b)
    bias = None if bias is None else _ready(bias)
    resid = None if resid is None else _ready(resid)
    f32 = epilogue in ("store_f32", "weight_gradient")
    out = torch.empty(m, n, device=a.device,
                      dtype=torch.float32 if f32 else torch.bfloat16)
    with torch.cuda.device(a.device):
        lib = _library()
        work = None
        if epilogue == "weight_gradient":
            work = torch.empty(lib.saicv_attn_block_gemm_workspace_bytes(
                m, n, k), dtype=torch.uint8, device=a.device)
        ptr = lambda t: None if t is None else t.data_ptr()
        _check(lib.saicv_attn_block_gemm(
            a.data_ptr(), int(a_kmajor), b.data_ptr(), int(b_kmajor), m, n, k,
            GEMM_EPILOGUES[epilogue], ptr(bias), ptr(resid), out.data_ptr(),
            ptr(work), _stream(a.device)))
    gemm.launches += 1
    return out


gemm.launches = 0


def supported(n, c, head_nums):
    """The shapes K8 takes (the model's gate): head dim 64 or 128, N <=
    1024."""
    return c % head_nums == 0 and c // head_nums in HEAD_DIMS \
        and n <= MAX_TOKENS


def check_args(x, wqkv, bqkv, wproj, bproj, gamma, beta, head_nums):
    """Shape rule of K8; returns (b, n, c) or raises."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"x: dtype {x.dtype} is not bfloat16 or float32")
    if x.dim() != 3:
        raise ValueError(f"x shape {tuple(x.shape)} is not [B, N, C]")
    b, n, c = x.shape
    if not (1 <= n and supported(n, c, head_nums)):
        raise ValueError(f"K8 takes head dim 64 or 128 and 1 <= N <= "
                         f"{MAX_TOKENS}, got N={n}, C={c}, H={head_nums}")
    expected = (("wqkv", wqkv, (3 * c, c), x.dtype),
                ("bqkv", bqkv, (3 * c,), x.dtype),
                ("wproj", wproj, (c, c), x.dtype),
                ("bproj", bproj, (c,), x.dtype),
                ("gamma", gamma, (c,), torch.float32),
                ("beta", beta, (c,), torch.float32))
    for name, t, shape, dtype in expected:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected "
                             f"{dtype} {shape}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return b, n, c


def _ready(t):
    """``t`` contiguous and 16-byte aligned, as the kernel's vector loads
    need (a copy only for a view that is neither)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


@functools.lru_cache(maxsize=None)
def _library():
    lib = build.load("attn_block")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.saicv_attn_block_workspace_bytes.argtypes = [i32] * 6
    lib.saicv_attn_block_workspace_bytes.restype = ctypes.c_longlong
    lib.saicv_attn_block_fwd.argtypes = ([ptr] * 9 + [i32] * 4
                                         + [ctypes.c_float, i32, ptr])
    lib.saicv_attn_block_bwd.argtypes = ([ptr] * 16 + [i32] * 4
                                         + [ctypes.c_float, i32, ptr])
    lib.saicv_attn_block_fwd.restype = i32
    lib.saicv_attn_block_bwd.restype = i32
    lib.saicv_attn_block_gemm_workspace_bytes.argtypes = [i32] * 3
    lib.saicv_attn_block_gemm_workspace_bytes.restype = ctypes.c_longlong
    lib.saicv_attn_block_gemm.argtypes = ([ptr, i32, ptr, i32] + [i32] * 4
                                          + [ptr] * 5)
    lib.saicv_attn_block_gemm.restype = i32
    return lib


def _workspace(lib, b, n, c, head_nums, is_bf16, backward, device):
    size = lib.saicv_attn_block_workspace_bytes(b, n, c, head_nums, is_bf16,
                                                int(backward))
    if size < 0:
        raise ValueError(f"K8 refuses B={b}, N={n}, C={c}, H={head_nums}")
    # freed on return, which is safe because the caching allocator reuses it
    # only for later work on this stream
    return torch.empty(size, dtype=torch.uint8, device=device)


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _check(err):
    if err != 0:
        raise RuntimeError(f"attn_block kernel launch failed: cudaError {err}")


class AttnBlock(torch.autograd.Function):
    """K8 with its backward kernel; saves the inputs only."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wproj, bproj, gamma, beta, head_nums,
                eps):
        ctx.head_nums, ctx.eps = head_nums, eps
        ctx.save_for_backward(x, wqkv, bqkv, wproj, bproj, gamma, beta)
        if x.device.type == "cpu":
            return attn_block_reference(x, wqkv, bqkv, wproj, bproj, gamma,
                                        beta, head_nums, eps)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        b, n, c = check_args(x, wqkv, bqkv, wproj, bproj, gamma, beta,
                             head_nums)
        args = [_ready(t) for t in (x, wqkv, bqkv, wproj, bproj, gamma, beta)]
        y = torch.empty_like(args[0])
        is_bf16 = int(x.dtype == torch.bfloat16)
        with torch.cuda.device(x.device):
            lib = _library()
            work = _workspace(lib, b, n, c, head_nums, is_bf16, False,
                              x.device)
            _check(lib.saicv_attn_block_fwd(
                *(t.data_ptr() for t in args), y.data_ptr(), work.data_ptr(),
                b, n, c, head_nums, eps, is_bf16, _stream(x.device)))
        attn_block.launches += 1
        return y

    @staticmethod
    def backward(ctx, dy):
        inputs = ctx.saved_tensors
        x = inputs[0]
        dy = dy.to(x.dtype)
        if x.device.type == "cpu":
            return (*attn_block_backward_reference(*inputs, dy, ctx.head_nums,
                                                   ctx.eps), None, None)
        b, n, c = check_args(*inputs, ctx.head_nums)
        args = [_ready(t) for t in inputs]
        dy = _ready(dy)
        dx = torch.empty_like(args[0])
        f32 = dict(dtype=torch.float32, device=x.device)
        sums = [torch.empty(t.shape, **f32) for t in inputs[1:]]
        is_bf16 = int(x.dtype == torch.bfloat16)
        with torch.cuda.device(x.device):
            lib = _library()
            work = _workspace(lib, b, n, c, ctx.head_nums, is_bf16, True,
                              x.device)
            _check(lib.saicv_attn_block_bwd(
                *(t.data_ptr() for t in args), dy.data_ptr(), dx.data_ptr(),
                *(s.data_ptr() for s in sums), work.data_ptr(), b, n, c,
                ctx.head_nums, ctx.eps, is_bf16, _stream(x.device)))
        attn_block.backward_launches += 1
        grads = [s.to(t.dtype) for s, t in zip(sums, inputs[1:])]
        return (dx, *grads, None, None)


def attn_block(x, wqkv, bqkv, wproj, bproj, gamma, beta, head_nums,
               eps=1e-6):
    """K8: y = x + proj(attention(qkv(LayerNorm(x)))) for x [B, N, C]."""
    return AttnBlock.apply(x, wqkv, bqkv, wproj, bproj, gamma, beta,
                           head_nums, eps)


attn_block.launches = 0
attn_block.backward_launches = 0
