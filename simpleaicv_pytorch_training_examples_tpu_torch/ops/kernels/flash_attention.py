"""Streaming attention: kernel K5 (SAM's decomposed relative-position bias)
and kernel K6 (a per-key bias), each forward and backward.

Counterpart of the JAX package's ``ops/pallas/flash_attention.py::
flash_attention_relpos``: q, k, v ``[B, H, N, D]`` (D <= 256; views of the
packed qkv are read in place through their strides), ``rel_h [B, H, N, KH]``
and ``rel_w [B, H, N, KW]`` fp32 with N = KH * KW. The score of query i and
key j = jh * KW + jw is ``q_i.k_j * D^-0.5 + rel_h[i, jh] + rel_w[i, jw]``.
The forward kernel (bf16: ``csrc/flash_attention_fwd.cu``, wgmma products
on tiles that TMA loads; fp32: ``csrc/flash_attention.cu``) walks the keys
once with an online softmax and never builds the ``[N, N]`` score matrix;
it also returns the fp32 log-sum-exp of every query row.
``FlashAttentionRelpos`` (a ``torch.autograd.Function``) saves the inputs, the output and the
log-sum-exp; its backward (``flash_attention_relpos_backward``) computes
delta = rowsum(dO * O) with one torch op (the JAX package computes it
outside its kernel as well) and launches two kernels, which recompute P
from the log-sum-exp and give dq, dk, dv and the fp32 drel_h, drel_w (the
TPU kernel's math: dS0 = P * (dP - delta) unscaled for drel, rounded to the
input dtype for dQ and dK, which are scaled after their products). In bf16
they are ``csrc/flash_relpos_bwd.cu``: wgmma products on tiles that TMA
loads, a dQ walk over the key tiles and a dK/dV walk over the query tiles,
no atomics (the same bits every run); where KW = 64 (SAM's global blocks,
``relpos_backward_grid_mode``) a 64-key tile is one key-grid row, rel_w
stays in the dQ walk's registers and drel_w accumulates there in key
order, and the dK/dV walk takes each query tile's rel_w rows by TMA (the
wrapper copies rel_w first where TMA cannot read it, and q, k, v, dO
likewise through ``tma_operand``). ``flash_attention_relpos_walk_reference``
is the plain version of that order. In fp32 they are the FMA kernels of
``csrc/flash_attention.cu``.

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
are all masked averages V, as on the TPU. The kernel (bf16: the key-bias
mode of ``csrc/flash_attention_fwd.cu``; fp32: the FMA forward of
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

The bf16 forward of both (``csrc/flash_attention_fwd.cu``) splits the keys
where the 128-row query blocks of all heads are fewer than the SMs
(``forward_splits``: SAM2's memory attention, B = H = 1): split s walks the
64-key tiles j with j mod S = s and writes its unnormalised fp32 output,
row max and row sum, and a merge kernel combines the splits in the order s
= 0 .. S-1 (no atomics: the same bits every run). K6 skips a key tile whose
every key is masked (bias <= -5e8, or past Nk) where the batch row has a
key above -5e8 (``key_tiles_kept``): such a tile's P is exactly 0, so the
output and lse are the same bit for bit, and the empty slots of SAM2's
memory cost nothing. ``flash_attention_split_reference`` is the plain
version of that walk and merge (the tests hold it against the plain
version and the TPU kernel). A forward counts one launch, its merge
included.

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
import math

import torch

from . import build
from .fused_attention import (check_rel_args, fused_attention_relwin_reference,
                              rel_bias, tma_operand)

MAX_HEAD_DIM = 256
_DTYPES = (torch.bfloat16, torch.float32)
MASKED_BIAS = -5e8   # a key with a bias at or below: masked (the skip rule)
LOG2E, LN2 = math.log2(math.e), math.log(2.0)


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


def flash_attention_relpos_walk_reference(q, k, v, rel_h, rel_w, dout,
                                          out=None, lse=None):
    """Plain version of the bf16 backward's order of sums
    (``csrc/flash_relpos_bwd.cu``): the keys in tiles of 64, in order; a
    tile's log2-domain logits s * scale * log2(e) + rel_h * log2(e) + rel_w
    * log2(e) in the key-grid mode (``relpos_backward_grid_mode``), else +
    (rel_h + rel_w) * log2(e); P = 2^(logit - lse * log2(e)) with the
    forward's ``lse`` (recomputed when None), dS0 = P * (dP - delta) in fp32,
    delta = rowsum(dO * O) from the forward's output (recomputed when None);
    drel_h and drel_w summed tile by tile in key order (in the key-grid mode
    drel_h[i, jh] is tile jh's row sum and drel_w accumulates over the
    tiles), dQ accumulated tile by tile from bf16(dS0) in fp32, each tile's
    keys' dK and dV over all queries; the scale after the products. Returns
    dq, dk, dv (the input dtype), drel_h, drel_w (fp32)."""
    dtype = q.dtype
    b, h, n, d = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    scale = d ** -0.5
    if out is None or lse is None:
        out, lse = flash_attention_relpos_reference(q, k, v, rel_h, rel_w,
                                                    return_lse=True)
    qf, kf, vf = q.float(), k.float(), v.float()
    dof = dout.to(dtype).float()
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    lse2 = lse.float()[..., None] * LOG2E
    grid = relpos_backward_grid_mode(d, kh, kw)
    rh, rw = rel_h.float(), rel_w.float()
    if grid:
        rh, rw = rh * LOG2E, rw * LOG2E
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.zeros(b, h, n, d, **f32)
    dk, dv = torch.zeros(b, h, n, d, **f32), torch.zeros(b, h, n, d, **f32)
    drel_h, drel_w = torch.zeros(b, h, n, kh, **f32), torch.zeros(
        b, h, n, kw, **f32)
    for key0 in range(0, n, 64):
        keys = torch.arange(key0, min(key0 + 64, n), device=q.device)
        jh, jw = keys // kw, keys % kw
        s = qf @ kf[:, :, keys].transpose(-1, -2)
        bias2 = (rh[..., jh] + rw[..., jw] if grid
                 else (rh[..., jh] + rw[..., jw]) * LOG2E)
        p = torch.exp2(s * (scale * LOG2E) + bias2 - lse2)
        ds0 = p * (dof @ vf[:, :, keys].transpose(-1, -2) - delta)
        drel_h.index_add_(3, jh, ds0)
        drel_w.index_add_(3, jw, ds0)
        ds = ds0.to(dtype).float()
        dq += ds @ kf[:, :, keys]
        dk[:, :, keys] = ds.transpose(-1, -2) @ qf
        dv[:, :, keys] = p.to(dtype).float().transpose(-1, -2) @ dof
    return ((dq * scale).to(dtype), (dk * scale).to(dtype), dv.to(dtype),
            drel_h, drel_w)


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


@functools.lru_cache(maxsize=None)
def _bf16_forward():
    """The C entries of ``csrc/flash_attention_fwd.cu``: (K5, K6)."""
    lib = build.load("flash_attention_fwd")
    relpos, keybias = (lib.saicv_flash_relpos_fwd_bf16,
                       lib.saicv_flash_keybias_fwd_bf16)
    relpos.argtypes = [_PTR] * 9 + [_LL] * 18 + [_INT] * 7 + [ctypes.c_float,
                                                              _PTR]
    keybias.argtypes = ([_PTR] * 8 + [_LL] * 13 + [_INT] * 6
                        + [ctypes.c_float, _INT, _PTR])
    relpos.restype = keybias.restype = _INT
    return relpos, keybias


@functools.lru_cache(maxsize=None)
def _bf16_backward():
    """The C entry of ``csrc/flash_relpos_bwd.cu`` (K5's bf16 backward)."""
    fn = build.load("flash_relpos_bwd").saicv_flash_relpos_bwd_bf16
    fn.argtypes = [_PTR] * 13 + [_LL] * 27 + [_INT] * 7 + [ctypes.c_float,
                                                            _PTR]
    fn.restype = _INT
    return fn


def relpos_backward_grid_mode(d, kh, kw):
    """Whether K5's bf16 backward takes its key-grid mode: KW = 64 (a
    64-key tile is one key-grid row), D <= 80 (the mode's kernels are built
    for one output chunk: SAM-B's and SAM-H's head dims) and KH <= 128 (the
    dQ walk's block of rel_h rows in shared memory)."""
    return kw == 64 and d <= 80 and kh <= 128


def _relpos_backward_bf16(q, k, v, rel_h, rel_w, dout, lse, delta):
    """The bf16 backward's two launches (``csrc/flash_relpos_bwd.cu``):
    returns dq, dk, dv [B, H, N, D] and drel_h, drel_w (fp32, every element
    written)."""
    b, h, n, d = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    grid = relpos_backward_grid_mode(d, kh, kw)
    q, k, v, dout = (tma_operand(t) for t in (q, k, v, dout))
    if grid:
        rel_w = tma_operand(rel_w)
    grads = torch.empty((3, b, h, n, d), dtype=q.dtype, device=q.device)
    f32 = dict(dtype=torch.float32, device=q.device)
    drel_h, drel_w = torch.empty((b, h, n, kh), **f32), torch.empty(
        (b, h, n, kw), **f32)
    _launch(_bf16_backward(), q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), *(g.data_ptr() for g in grads),
            lse.data_ptr(), delta.data_ptr(), rel_h.data_ptr(),
            rel_w.data_ptr(), drel_h.data_ptr(), drel_w.data_ptr(),
            *(s for t in (q, k, v, dout, grads[0], rel_h, rel_w, drel_h,
                          drel_w) for s in t.stride()[:3]),
            b, h, n, d, kh, kw, int(grid), d ** -0.5)
    return grads[0], grads[1], grads[2], drel_h, drel_w


def flash_attention_relpos_backward(q, k, v, rel_h, rel_w, dout, out, lse):
    """K5's backward from the forward's output and log-sum-exp: dq, dk, dv
    (the input dtype) and drel_h, drel_w (fp32). A CPU tensor takes the
    plain version; a CUDA tensor the kernels (bf16: ``flash_relpos_bwd.cu``,
    fp32: ``flash_attention.cu``), or the call raises."""
    dout = dout.to(q.dtype)
    if q.device.type == "cpu":
        return flash_attention_relpos_backward_reference(
            q, k, v, rel_h, rel_w, dout, out)
    b, h, n, d, kh, kw = check_args(q, k, v, rel_h, rel_w)
    if dout.stride(3) != 1:
        dout = dout.contiguous()
    delta = (dout.float() * out.float()).sum(dim=-1)       # [B, H, N]
    if q.dtype == torch.bfloat16:
        grads = _relpos_backward_bf16(q, k, v, rel_h, rel_w, dout, lse, delta)
    else:
        dq, dk, dv = torch.empty((3, b, h, n, d), dtype=q.dtype,
                                 device=q.device)
        # the fp32 kernels add their terms into drel
        drel_h = torch.zeros((b, h, n, kh), dtype=torch.float32,
                             device=q.device)
        drel_w = torch.zeros((b, h, n, kw), dtype=torch.float32,
                             device=q.device)
        _launch(_library()[1], q.device, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                rel_h.data_ptr(), rel_w.data_ptr(), drel_h.data_ptr(),
                drel_w.data_ptr(), *q.stride()[:3], *dout.stride()[:3],
                *dq.stride()[:3],
                *(s for t in (rel_h, rel_w, drel_h, drel_w)
                  for s in t.stride()[:3]),
                b, h, n, d, kh, kw, d ** -0.5, 0)
        grads = dq, dk, dv, drel_h, drel_w
    flash_attention_relpos.backward_launches += 1
    return grads


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def forward_splits(b, h, nq, nk, sms):
    """Key splits of the bf16 forward (K5 and K6): the SMs over the
    128-row query blocks of all heads, rounded down, at least 1 and at most
    the 64-key tiles walked."""
    blocks = -(-nq // 128) * b * h
    return max(1, min(-(-nk // 64), sms // blocks))


def forward_head_dim(d):
    """The columns of the bf16 forward's fp32 partials for head dim d: 64,
    80, 128, 192 or 256."""
    return 64 if d <= 64 else 80 if d <= 80 else -(-d // 64) * 64


def _forward_bf16(fn, q, k, v, out, lse, extra, nk, extra_strides, shape,
                  scale=None, *after):
    """One bf16 forward on ``csrc/flash_attention_fwd.cu`` (its merge
    included): q, k, v read in place where TMA can (else copied), out [B,
    Nq, H, D] and lse [B, H, Nq] filled; ``extra`` the bias pointers and
    ``extra_strides`` their strides, ``nk`` the keys (None: Nq), ``shape``
    the entry's (B, H, Nq[, Nk], D[, KH, KW])."""
    b, h, nq, d = q.shape
    nk = nq if nk is None else nk
    splits = forward_splits(b, h, nq, nk, _sm_count(q.device.index or 0))
    f32 = dict(dtype=torch.float32, device=q.device)
    part = stats = None
    if splits > 1:
        part = torch.empty((splits, b * h, nq, forward_head_dim(d)), **f32)
        stats = torch.empty((2, splits, b * h, nq), **f32)
    q, k, v = (tma_operand(t) for t in (q, k, v))
    ptr = lambda t: 0 if t is None else t.data_ptr()
    _launch(fn, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), *extra, ptr(part), ptr(stats),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], nq * h * d, d,
            h * d, *extra_strides, *shape, splits,
            d ** -0.5 if scale is None else scale, *after)


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
            rel = (*rel_h.stride()[:3], *rel_w.stride()[:3])
            if q.dtype == torch.bfloat16:
                _forward_bf16(_bf16_forward()[0], q, k, v, out, lse,
                              (rel_h.data_ptr(), rel_w.data_ptr()), None, rel,
                              (b, h, n, d, kh, kw))
            else:
                _launch(_library()[0], q.device, q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                        rel_h.data_ptr(), rel_w.data_ptr(), *q.stride()[:3],
                        n * h * d, d, h * d, *rel, b, h, n, d, kh, kw,
                        d ** -0.5, 0)
            flash_attention_relpos.launches += 1
            out = out.transpose(1, 2)
        ctx.save_for_backward(q, k, v, rel_h, rel_w, out, lse)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _):
        q, k, v, rel_h, rel_w, out, lse = ctx.saved_tensors
        return flash_attention_relpos_backward(q, k, v, rel_h, rel_w, dout,
                                               out, lse)


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


def key_tiles_kept(bias, nk, tile=64):
    """The empty-slot rule of K6's bf16 kernels: [B, tiles] bool, a key tile
    of ``tile`` keys kept unless every key of it has bias <= -5e8 (or lies
    past Nk) while its batch row has a key above -5e8; a row with no such key
    keeps every tile. ``bias``: the fp32 key bias [B, Nk]."""
    tiles = -(-nk // tile)
    real = bias > MASKED_BIAS
    padded = torch.zeros(bias.shape[0], tiles * tile, dtype=torch.bool,
                         device=bias.device)
    padded[:, :nk] = real
    return padded.view(-1, tiles, tile).any(-1) | ~real.any(-1, keepdim=True)


def flash_attention_split_reference(q, k, v, bias=None, sm_scale=None,
                                    splits=1, residual=False, skip=True,
                                    return_lse=False):
    """Plain version of the bf16 forward's walk (K6): the keys in tiles of
    64, split s taking tiles j = s, s + S, ... (``skip``: those
    ``key_tiles_kept`` keeps), each split an online softmax over its tiles
    in fp32 in the log2 domain (P = 2^(logit - running max), rounded to the
    input dtype for P.V, plus its rounded residual with ``residual``, the
    sum in fp32), then the splits merged in the order s = 0 .. S-1: weights
    2^(m_s - max m), output = sum of weighted outputs / sum of weighted row
    sums, lse = (max m + log2 of that sum) * ln 2. -> out [B, H, Nq, D] in
    the input dtype (and the fp32 lse [B, H, Nq])."""
    dtype = q.dtype
    b, h, nq, d = q.shape
    nk = k.shape[2]
    sc = (d ** -0.5 if sm_scale is None else float(sm_scale)) * LOG2E
    tiles = -(-nk // 64)
    kept = (key_tiles_kept(bias, nk) if bias is not None and skip
            else torch.ones(b, tiles, dtype=torch.bool)).tolist()
    qf, kf, vf = q.float(), k.float(), v.float()
    f32 = dict(dtype=torch.float32, device=q.device)
    outs, lses = [], []
    for bi in range(b):
        parts = []
        for s in range(splits):
            m = torch.full((h, nq), -float("inf"), **f32)
            l = torch.zeros(h, nq, **f32)
            acc = torch.zeros(h, nq, d, **f32)
            for j in range(s, tiles, splits):
                if not kept[bi][j]:
                    continue
                keys = slice(64 * j, min(64 * j + 64, nk))
                x = qf[bi] @ kf[bi, :, keys].transpose(-1, -2) * sc
                if bias is not None:
                    x = x + bias[bi, keys].float() * LOG2E
                mnew = torch.maximum(m, x.amax(-1))
                alpha = torch.exp2(m - mnew)
                p = torch.exp2(x - mnew[..., None])
                l = l * alpha + p.sum(-1)
                pv = p.to(dtype).float()
                if residual:
                    pv = pv + (p - pv).to(dtype).float()
                acc = acc * alpha[..., None] + pv @ vf[bi, :, keys]
                m = mnew
            parts.append((m, l, acc))
        mt = torch.stack([m for m, _, _ in parts]).amax(0)
        lt, ot = torch.zeros(h, nq, **f32), torch.zeros(h, nq, d, **f32)
        for m, l, acc in parts:
            w = torch.where(l > 0, torch.exp2(m - mt), torch.zeros_like(l))
            lt = lt + w * l
            ot = ot + w[..., None] * acc
        outs.append((ot / lt[..., None]).to(dtype))
        lses.append((mt + torch.log2(lt)) * LN2)
    out, lse = torch.stack(outs), torch.stack(lses)
    return (out, lse) if return_lse else out


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
    fwd.argtypes = [_PTR] * 6 + [_LL] * 13 + [_INT] * 5 + tail
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
        out = torch.empty((b, nq, h, d), dtype=q.dtype, device=q.device)
        lse = torch.empty((b, h, nq), dtype=torch.float32, device=q.device)
        bias_ptr = 0 if bias is None else bias.data_ptr()
        bias_sb = 0 if bias is None else bias.stride(0)
        if q.dtype == torch.bfloat16:
            _forward_bf16(_bf16_forward()[1], q, k, v, out, lse, (bias_ptr,),
                          nk, (bias_sb,), (b, h, nq, nk, d), scale,
                          int(any(ctx.needs_input_grad[:3])))
        else:
            _launch(_key_bias_library()[0], q.device, q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    lse.data_ptr(), bias_ptr, *q.stride()[:3],
                    *k.stride()[:3], *v.stride()[:3], nq * h * d, d, h * d,
                    bias_sb, b, h, nq, nk, d, scale, 0)
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
