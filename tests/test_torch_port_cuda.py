"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Every test here needs an NVIDIA GPU and ``nvcc``, is marked ``gpu`` and
skips where there is no card. On a machine with one, and without JAX
installed (this file imports none of it), run from the repository root

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest

It sweeps the shapes the smoke run does not: token counts around the
16-row tiles and the 64-row chunks, head dims off the multiples of 16,
``n_real`` at the edges, both layouts, unaligned tensors, LayerNorm widths
on and off the vector path; for the rel-pos kernels K3, K4 and K5 also
key grids with KH != KW, KW a multiple of 64 or not, N off the 64-key
tiles and (K5) head dims above 128, forward and backward (K5's bf16
backward, ``flash_relpos_bwd.cu``, also at D = 80 and N = 192 in its
key-grid mode, run twice for the same bits, with rel_h and rel_w as
non-contiguous views, and with KW = 96, 32, 13, where a dK/dV block's
warpgroups fall on different key-grid rows; ``flash_attention.cu``'s entry
refuses bf16); for K6 (the
per-key bias) Nq != Nk with a ragged key tail, SAM2's slot bias with
masked memory slots and pointers, a row whose keys are all masked, D = 56
(zero-padded in the kernel), 256 (two output chunks) and odd widths, each
of q, k, v with its own strides, forward and backward (masked keys get
exactly zero dk and dv; the backward is the same bit for bit when run
again); K1 with Hiera's ``sm_scale`` and K2 at Hiera's d = 56; K8 (the
fused attention block) at d = 64 and 128, ragged N and N = 1024, forward and
all seven gradients, reproducible bit for bit, and K8's GEMM alone
(``attn_block.gemm``), each product of ``GEMM_PRODUCTS`` at ViT-B/16's
micro-batch, ragged M and C = 64 to 1024, against ``gemm_reference``,
equal bit for bit on integer operands (every fp32 sum exact), the same bits
when run again; K9 (the packed [B, N, 3, H,
D] qkv) at odd and even head dims, with a strided dout and unaligned
tensors, bit for bit K1 at d = 64 and 128; K2b (the full score bias) with
fp32 and bf16 biases broadcast from [1, H, N, N], [H, N, N] and [B, 1, 1,
N], N up to 1024, dbias in the bias's shape and dtype (skipped when the
bias needs no gradient), and the shapes, dtypes and layouts both refuse;
the bf16 forward of K2b, K3 and K4 (``short_attention_fwd.cu``) where
its plan changes: N from 50 to 1024 (one pass up to 264 keys, groups of
256 past it), D = 35, 64, 80 and 128, masked key tails, every bias layout
and K3's and K4's layouts, two runs equal bit for bit; K1's, K2's and
K9's bf16 forward and backward (``short_attention_fwd.cu``,
``short_attention_bwd.cu``) at N = 256, 257, 264 and 265, the edges of the
one-pass row, two backward runs equal bit for bit; K5's and K6's bf16
forward (``flash_attention_fwd.cu``) at every head-dim shape (D = 56, 64,
80, 160, 256) with and without P's residual at a shape where the keys
split, against the plain version and the plain split walk, two runs equal
bit for bit at split shapes, the masked keys' k and v replaced by noise
without a changed bit, and K5 at N = 1050, KW = 80 and 128.
Tolerances:
attention and its gradients bf16 atol 2e-2 per unit of the reference's
scale, fp32 1e-4; the rel-pos gradients drel_h, drel_w (fp32 sums of small
terms) the same fractions of their largest value; LayerNorm y and dx
bf16 two ulps of the reference's scale, fp32 1e-4; dgamma and dbeta 1e-3 of
the largest sum. K8 is held to its plain version's floor, since the plain
version rounds twice where the kernel rounds once (qkv + bias, proj + bias
+ x): in bf16, against the plain version's computation of the same inputs
in fp32, y's and dx's RMS difference at most 1.25x the plain bf16
version's and every weight, bias, gamma and beta gradient's relative L2
difference at most the larger of 1e-2 and 1.25x the plain version's; in
fp32, max |kernel - plain| at most 1e-4 of the plain result's RMS.
K8's GEMM on operands of unit scale: fp32 outputs max |kernel - plain| at
most 1e-4 of the plain result's RMS, bf16 outputs within 2^-7 of the larger
of the two plus that at every element (an fp32 sum-order difference can
move a rounding by one bf16 ulp).
"""

import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
    attn_block as ab, flash_attention as fl, fused_attention as fa,
    layer_norm as ln)

pytestmark = pytest.mark.gpu
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, *shape, dtype):
    return torch.randn(*shape, device="cuda", generator=gen,
                       dtype=torch.float32).to(dtype)


def _close(got, want, dtype, what):
    assert torch.isfinite(got).all(), what
    scale = max(1.0, want.float().abs().max().item())
    tol = (2e-2 if dtype == torch.bfloat16 else 1e-4) * scale
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, f"{what}: max |kernel - plain| {err} > {tol}"


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,n,h,d,n_real", [
    (3, 8, 2, 64, None), (2, 15, 2, 64, None), (2, 16, 2, 64, 16),
    (2, 17, 2, 64, 1), (2, 63, 1, 128, None), (2, 64, 1, 128, 33),
    (2, 65, 3, 64, 64), (1, 129, 2, 128, 128), (2, 200, 4, 64, 199),
    (1, 577, 2, 64, None), (1, 1024, 2, 64, 700), (1, 1000, 1, 128, None),
    # the one-pass row's edges: 256 keys, 257..264 (256 + an 8-key chunk),
    # 265 (groups of 256)
    (1, 256, 2, 64, None), (1, 257, 2, 64, 200), (1, 264, 2, 128, 257),
    (1, 265, 2, 64, None),
])
def test_dense_forward_and_backward(cuda, b, n, h, d, n_real, dtype):
    dtype = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(n * d + (n_real or 0))
    qkv = _randn(gen, b, n, 3 * h * d, dtype=dtype).requires_grad_()
    dout = _randn(gen, b, n, h * d, dtype=dtype)
    counts = (fa.fused_attention_dense.launches,
              fa.fused_attention_dense.backward_launches)
    out = fa.fused_attention_dense(qkv, h, n_real)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fa.fused_attention_dense.launches,
            fa.fused_attention_dense.backward_launches) == (
                counts[0] + 1, counts[1] + 1)
    _close(out, fa.fused_attention_dense_reference(qkv.detach(), h, n_real),
           dtype, "out")
    _close(qkv.grad, fa.fused_attention_dense_backward_reference(
        qkv.detach(), dout, h, n_real), dtype, "dqkv")
    (again,) = torch.autograd.grad(fa.fused_attention_dense(qkv, h, n_real),
                                   qkv, dout)
    assert torch.equal(qkv.grad, again), "dqkv differs between two runs"


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,h,n,d,n_real,packed", [
    (2, 2, 1, 16, None, False), (2, 3, 7, 8, None, False),
    (2, 2, 31, 35, 30, False), (2, 2, 50, 80, None, True),
    (2, 2, 64, 96, 17, True), (1, 3, 100, 112, None, True),
    (1, 2, 257, 80, 256, True), (1, 2, 300, 120, None, False),
    (1, 2, 640, 128, 639, True), (1, 1, 1024, 80, None, True),
    (2, 2, 40, 17, None, False), (1, 2, 129, 48, 2, True),
    # the one-pass row's edges (ViT-H/14's 257 tokens at d = 80)
    (1, 2, 256, 56, None, True), (1, 2, 257, 80, None, False),
    (1, 2, 264, 80, 260, True), (1, 2, 265, 80, 264, True),
])
def test_forward_and_backward(cuda, b, h, n, d, n_real, packed, dtype):
    dtype = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(n * d + (n_real or 0))
    if packed:     # views of one packed qkv, as the attention module makes
        qkv = _randn(gen, b, n, 3 * h * d, dtype=dtype)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q, k, v = (_randn(gen, b, h, n, d, dtype=dtype) for _ in range(3))
    dout = _randn(gen, b, n, h, d, dtype=dtype).transpose(1, 2)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.fused_attention(*leaves, n_real)
    grads = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    again = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    _close(out, fa.fused_attention_reference(q, k, v, n_real), dtype, "out")
    want = fa.fused_attention_backward_reference(q, k, v, dout, n_real)
    for name, g, w, g2 in zip(("dq", "dk", "dv"), grads, want, again):
        _close(g, w, dtype, name)
        assert torch.equal(g, g2), f"{name} differs between two runs"
    if n_real is not None and n_real < n:       # masked keys: no gradient
        assert torch.count_nonzero(grads[1][:, :, n_real:]) == 0
        assert torch.count_nonzero(grads[2][:, :, n_real:]) == 0


def test_unaligned_tensors_take_the_element_wise_loads(cuda):
    """Views that start 2 bytes off a 16-byte boundary."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h, n, d = 2, 2, 33, 64
    flat = _randn(gen, 3 * b * h * n * d + 1, dtype=torch.bfloat16)
    q, k, v = flat[1:].view(3, b, h, n, d).unbind(0)
    dflat = _randn(gen, b * h * n * d + 1, dtype=torch.bfloat16)
    dout = dflat[1:].view(b, h, n, d)
    assert q.data_ptr() % 16 == 2
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fa.fused_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, dout)
    _close(out, fa.fused_attention_reference(q, k, v), torch.bfloat16, "out")
    for g, w in zip(grads, fa.fused_attention_backward_reference(q, k, v,
                                                                 dout)):
        _close(g, w, torch.bfloat16, "gradient")


def test_a_cuda_tensor_the_kernel_cannot_take_raises(cuda):
    with pytest.raises(ValueError):
        fa.fused_attention_dense(torch.zeros(1, 8, 3 * 80, device="cuda"), 1)
    with pytest.raises(TypeError):
        fa.fused_attention_dense(torch.zeros(1, 8, 3 * 64, device="cuda",
                                             dtype=torch.float16), 1)
    with pytest.raises(ValueError):
        ln.layer_norm(torch.zeros(4, 8, device="cuda"),
                      torch.ones(8, device="cuda", dtype=torch.bfloat16),
                      torch.zeros(8, device="cuda"))


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("shape", [
    (1, 8), (3, 64), (5, 100), (1000, 768), (7, 2, 1024), (33, 2048),
    (9, 2056), (4, 4096), (2, 3, 5, 77), (4097, 40), (12, 3),
])
def test_layer_norm_forward_and_backward(cuda, shape, dtype):
    dtype = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(sum(shape))
    c = shape[-1]
    x = (2.0 * _randn(gen, *shape, dtype=torch.float32) + 0.5).to(dtype)
    gamma = 1.0 + 0.1 * _randn(gen, c, dtype=torch.float32)
    beta = 0.1 * _randn(gen, c, dtype=torch.float32)
    dy = _randn(gen, *shape, dtype=dtype)
    leaves = [t.detach().requires_grad_() for t in (x, gamma, beta)]
    y = ln.layer_norm(*leaves)
    dx, dgamma, dbeta = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    again = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    y_ref = ln.layer_norm_reference(x, gamma, beta)
    dx_ref, dgamma_ref, dbeta_ref = ln.layer_norm_backward_reference(
        x, gamma, dy)
    assert y.shape == x.shape and y.dtype == dtype and dx.dtype == dtype
    assert dgamma.dtype == dbeta.dtype == torch.float32
    # two bf16 ulps of the reference's scale
    ulps = 2 * 2.0 ** -8 if dtype == torch.bfloat16 else 0.0
    for name, got, want in (("y", y, y_ref), ("dx", dx, dx_ref)):
        tol = max(1e-4, ulps * want.float().abs().max().item())
        err = (got.float() - want.float()).abs().max().item()
        assert torch.isfinite(got).all() and err <= tol, (name, err, tol)
    sums = max(1.0, dgamma_ref.abs().max().item(),
               dbeta_ref.abs().max().item())
    for name, got, want in (("dgamma", dgamma, dgamma_ref),
                            ("dbeta", dbeta, dbeta_ref)):
        err = (got - want).abs().max().item()
        assert err <= 1e-3 * sums, (name, err, sums)
    for a, g in zip(again, (dx, dgamma, dbeta)):
        assert torch.equal(a, g)


def test_layer_norm_takes_a_strided_input_and_unaligned_parameters(cuda):
    gen = torch.Generator(device="cuda").manual_seed(9)
    x = _randn(gen, 64, 20, dtype=torch.bfloat16).t()       # [20, 64] strided
    params = _randn(gen, 2 * 64 + 1, dtype=torch.float32)
    gamma, beta = params[1:65], params[65:]
    assert gamma.data_ptr() % 16 == 4
    y = ln.layer_norm(x, gamma, beta)
    want = ln.layer_norm_reference(x, gamma, beta)
    assert (y.float() - want.float()).abs().max().item() <= 2 ** -7 * max(
        1.0, want.float().abs().max().item())


# ------------------------------------------------ rel-pos kernels K3-K5


def _rel(gen, lead, kh, kw):
    return (_randn(gen, *lead, kh, dtype=torch.float32),
            _randn(gen, *lead, kw, dtype=torch.float32))


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,kh,kw,h,d", [
    (3, 14, 14, 12, 64), (2, 14, 14, 2, 128), (2, 3, 4, 2, 64),
    (1, 12, 16, 2, 64), (2, 32, 32, 1, 64), (1, 1, 7, 2, 128),
    (2, 5, 40, 2, 64),
])
def test_relwin_dense_forward(cuda, b, kh, kw, h, d, dtype):
    dtype = DTYPES[dtype]
    n = kh * kw
    gen = torch.Generator(device="cuda").manual_seed(n * d + h)
    qkv = _randn(gen, b, n, 3 * h * d, dtype=dtype)
    rel_h, rel_w = _rel(gen, (b, n, h), kh, kw)
    before = fa.fused_attention_relwin_dense.launches
    out = fa.fused_attention_relwin_dense(qkv, rel_h, rel_w, h)
    torch.cuda.synchronize()
    assert fa.fused_attention_relwin_dense.launches == before + 1
    assert out.shape == (b, n, h * d) and out.dtype == dtype
    _close(out, fa.fused_attention_relwin_dense_reference(qkv, rel_h, rel_w,
                                                          h), dtype, "out")


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,h,kh,kw,d,n_real,packed", [
    (2, 16, 14, 14, 80, None, True), (2, 3, 14, 14, 80, 150, True),
    (1, 2, 7, 9, 35, None, False), (2, 2, 4, 4, 16, 9, False),
    (1, 2, 32, 32, 128, 1000, True), (1, 1, 1, 1, 64, None, False),
    (1, 2, 8, 25, 96, 1, True),
])
def test_relwin_forward(cuda, b, h, kh, kw, d, n_real, packed, dtype):
    dtype = DTYPES[dtype]
    n = kh * kw
    gen = torch.Generator(device="cuda").manual_seed(n * d + (n_real or 0))
    if packed:
        qkv = _randn(gen, b, n, 3 * h * d, dtype=dtype)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q, k, v = (_randn(gen, b, h, n, d, dtype=dtype) for _ in range(3))
    rel_h, rel_w = _rel(gen, (b, h, n), kh, kw)
    before = fa.fused_attention_relwin.launches
    out = fa.fused_attention_relwin(q, k, v, rel_h, rel_w, n_real)
    torch.cuda.synchronize()
    assert fa.fused_attention_relwin.launches == before + 1
    assert out.shape == (b, h, n, d) and out.dtype == dtype
    _close(out, fa.fused_attention_relwin_reference(q, k, v, rel_h, rel_w,
                                                    n_real), dtype, "out")


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,h,kh,kw,d,packed", [
    (1, 2, 64, 64, 64, True), (1, 2, 64, 64, 80, True),
    (1, 1, 16, 24, 64, False), (1, 2, 8, 16, 160, False),
    (2, 1, 10, 13, 64, False), (1, 1, 64, 128, 64, True),
    (1, 2, 2, 64, 256, False), (1, 1, 3, 5, 8, False),
    (1, 3, 40, 33, 128, True),
])
def test_flash_relpos_forward(cuda, b, h, kh, kw, d, packed, dtype):
    dtype = DTYPES[dtype]
    n = kh * kw
    gen = torch.Generator(device="cuda").manual_seed(n + d)
    if packed:
        qkv = _randn(gen, b, n, 3 * h * d, dtype=dtype)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q, k, v = (_randn(gen, b, h, n, d, dtype=dtype) for _ in range(3))
    rel_h, rel_w = _rel(gen, (b, h, n), kh, kw)
    before = fl.flash_attention_relpos.launches
    out, lse = fl.flash_attention_relpos(q, k, v, rel_h, rel_w,
                                         return_lse=True)
    torch.cuda.synchronize()
    assert fl.flash_attention_relpos.launches == before + 1
    assert out.shape == (b, h, n, d) and out.dtype == dtype
    want, want_lse = fl.flash_attention_relpos_reference(
        q, k, v, rel_h, rel_w, return_lse=True)
    _close(out, want, dtype, "out")
    err = (lse - want_lse).abs().max().item()
    assert err <= 1e-3 * max(1.0, want_lse.abs().max().item()), err


def test_rel_kernels_take_unaligned_tensors(cuda):
    """Views that start 2 bytes off a 16-byte boundary: element-wise loads."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, h, kh, kw, d = 2, 2, 8, 8, 64
    n = kh * kw
    flat = _randn(gen, 3 * b * h * n * d + 1, dtype=torch.bfloat16)
    q, k, v = flat[1:].view(3, b, h, n, d).unbind(0)
    assert q.data_ptr() % 16 == 2
    rel_h, rel_w = _rel(gen, (b, h, n), kh, kw)
    _close(fa.fused_attention_relwin(q, k, v, rel_h, rel_w),
           fa.fused_attention_relwin_reference(q, k, v, rel_h, rel_w),
           torch.bfloat16, "K4")
    _close(fl.flash_attention_relpos(q, k, v, rel_h, rel_w),
           fl.flash_attention_relpos_reference(q, k, v, rel_h, rel_w),
           torch.bfloat16, "K5")


def test_rel_kernels_refuse_what_they_cannot_take(cuda):
    qkv = torch.zeros(1, 12, 3 * 80, device="cuda")
    rel_h, rel_w = torch.zeros(1, 12, 1, 3, device="cuda"), torch.zeros(
        1, 12, 1, 4, device="cuda")
    with pytest.raises(ValueError):          # K3 takes head dim 64 or 128
        fa.fused_attention_relwin_dense(qkv, rel_h, rel_w, 1)
    q = torch.zeros(1, 1, 12, 64, device="cuda")
    with pytest.raises(TypeError):           # rel terms must be fp32
        fl.flash_attention_relpos(q, q, q, rel_h.view(1, 1, 12, 3).half(),
                                  rel_w.view(1, 1, 12, 4))
    with pytest.raises(ValueError):          # KH * KW != N
        fl.flash_attention_relpos(q, q, q, rel_w.view(1, 1, 12, 4),
                                  rel_w.view(1, 1, 12, 4))
    leaf = q.clone().requires_grad_()
    before = fl.flash_attention_relpos.backward_launches
    fl.flash_attention_relpos(leaf, q, q, rel_h.view(1, 1, 12, 3),
                              rel_w.view(1, 1, 12, 4)).sum().backward()
    torch.cuda.synchronize()                 # a graph takes the backward kernel
    assert fl.flash_attention_relpos.backward_launches == before + 1
    assert torch.isfinite(leaf.grad).all()


# ------------------------------------------------ K3, K4, K5 backward


def _close_drel(got, want, dtype):
    """drel_h and drel_w within 2e-2 (bf16) or 1e-4 (fp32) of the largest
    reference value of the two (with KH = 1, drel_h is 0 up to rounding)."""
    scale = max(w.abs().max().item() for w in want)
    tol = (2e-2 if dtype == torch.bfloat16 else 1e-4) * scale
    for what, x, y in zip(("drel_h", "drel_w"), got, want):
        assert torch.isfinite(x).all(), what
        err = (x.float() - y.float()).abs().max().item()
        assert err <= tol, f"{what}: max |kernel - plain| {err} > {tol}"


def _grads(fn, leaves, dout):
    leaves = [t.detach().clone().requires_grad_() for t in leaves]
    fn(*leaves).backward(dout)
    torch.cuda.synchronize()
    return [t.grad for t in leaves]


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,kh,kw,h,d", [
    (3, 14, 14, 12, 64), (2, 14, 14, 2, 128), (2, 3, 4, 2, 64),
    (1, 12, 16, 2, 64), (2, 32, 32, 1, 64), (1, 1, 7, 2, 128),
    (2, 5, 40, 2, 64),
    # the bf16 kernels' plan changes: one pass up to 256 keys, 257..264
    # (an 8-key chunk), groups of 256 past that, an 8-key last chunk at
    # 64k + 1..8, rel_w rows longer than 64 keys
    (1, 16, 16, 2, 64), (1, 1, 257, 2, 64), (1, 12, 22, 2, 128),
    (1, 5, 53, 2, 64), (2, 3, 43, 2, 64), (1, 8, 25, 3, 128),
    (2, 8, 9, 2, 64),
])
def test_relwin_dense_backward(cuda, b, kh, kw, h, d, dtype):
    dtype = DTYPES[dtype]
    n = kh * kw
    gen = torch.Generator(device="cuda").manual_seed(n * d + h + 1)
    qkv = _randn(gen, b, n, 3 * h * d, dtype=dtype)
    rel_h, rel_w = _rel(gen, (b, n, h), kh, kw)
    dout = _randn(gen, b, n, h * d, dtype=dtype)
    before = fa.fused_attention_relwin_dense.backward_launches
    fn = lambda x, rh, rw: fa.fused_attention_relwin_dense(x, rh, rw, h)
    got = _grads(fn, (qkv, rel_h, rel_w), dout)
    assert fa.fused_attention_relwin_dense.backward_launches == before + 1
    want = fa.fused_attention_relwin_dense_backward_reference(
        qkv, rel_h, rel_w, dout, h)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    _close(got[0], want[0], dtype, "dqkv")
    _close_drel(got[1:], want[1:], dtype)
    again = _grads(fn, (qkv, rel_h, rel_w), dout)
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # reproducible


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,h,kh,kw,d,n_real", [
    (2, 16, 14, 14, 80, None), (2, 3, 14, 14, 80, 150), (1, 2, 8, 20, 80, 1),
    (2, 2, 7, 9, 35, None), (1, 2, 32, 32, 128, 1000), (2, 1, 3, 4, 16, 12),
    (2, 2, 14, 14, 128, None), (1, 2, 16, 16, 80, 200),
    (1, 2, 1, 257, 80, None), (1, 2, 12, 22, 80, 260), (1, 2, 5, 53, 128, None),
    (1, 2, 5, 53, 80, 100), (2, 2, 3, 43, 80, None), (1, 2, 8, 25, 128, 199),
    (1, 2, 2, 36, 64, None), (1, 1, 2, 100, 16, 150),
    # rel rows too wide for the dQ kernel's shared memory: read in place,
    # drel summed in drel itself
    (1, 1, 1, 257, 128, None),
])
def test_relwin_backward(cuda, b, h, kh, kw, d, n_real, dtype):
    dtype = DTYPES[dtype]
    n = kh * kw
    gen = torch.Generator(device="cuda").manual_seed(n * d + 7)
    q, k, v = (_randn(gen, b, h, n, d, dtype=dtype) for _ in range(3))
    rel_h, rel_w = _rel(gen, (b, h, n), kh, kw)
    dout = _randn(gen, b, h, n, d, dtype=dtype)
    before = fa.fused_attention_relwin.backward_launches
    got = _grads(lambda *a: fa.fused_attention_relwin(*a, n_real),
                 (q, k, v, rel_h, rel_w), dout)
    assert fa.fused_attention_relwin.backward_launches == before + 1
    want = fa.fused_attention_relwin_backward_reference(
        q, k, v, rel_h, rel_w, dout, n_real)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        _close(x, y, dtype, name)
    _close_drel(got[3:], want[3:], dtype)
    if n_real is not None:   # masked keys get no gradient
        assert torch.count_nonzero(got[1][:, :, n_real:]) == 0
    again = _grads(lambda *a: fa.fused_attention_relwin(*a, n_real),
                   (q, k, v, rel_h, rel_w), dout)
    assert all(torch.equal(x, y) for x, y in zip(got, again))  # reproducible


def test_relwin_backward_through_views_of_the_packed_qkv(cuda):
    """K4 over the attention module's views: the gradient lands in the
    packed [B, N, 3C] layout, equal to the plain version's."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, h, kh, kw, d = 2, 4, 14, 14, 80
    n = kh * kw
    qkv = _randn(gen, b, n, 3 * h * d, dtype=torch.bfloat16)
    rel_h, rel_w = _rel(gen, (b, h, n), kh, kw)
    dout = _randn(gen, b, h, n, d, dtype=torch.bfloat16)

    def through(attention, x):
        q, k, v = x.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
        return attention(q, k, v, rel_h, rel_w)
    got = _grads(lambda x: through(fa.fused_attention_relwin, x), (qkv,),
                 dout)[0]
    want = _grads(lambda x: through(fa.fused_attention_relwin_reference, x),
                  (qkv,), dout)[0]
    _close(got, want, torch.bfloat16, "dqkv")


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,h,kh,kw,d,packed", [
    (1, 2, 64, 64, 64, True), (1, 2, 16, 64, 80, False),
    (1, 1, 32, 32, 160, False), (1, 2, 30, 35, 64, False),
    (1, 1, 16, 128, 64, True), (2, 1, 3, 5, 8, False),
    (1, 2, 2, 64, 256, False), (1, 3, 10, 13, 128, True),
    # the key-grid mode at D = 80 on views of a packed qkv, and N a
    # multiple of 64 and not of 128 (a block's second warpgroup past N)
    (2, 2, 8, 64, 80, True), (1, 2, 3, 64, 80, True),
    (2, 1, 5, 64, 64, False),
])
def test_flash_relpos_backward(cuda, b, h, kh, kw, d, packed, dtype):
    dtype = DTYPES[dtype]
    n = kh * kw
    gen = torch.Generator(device="cuda").manual_seed(n + d + 3)
    rel_h, rel_w = _rel(gen, (b, h, n), kh, kw)
    dout = _randn(gen, b, h, n, d, dtype=dtype)
    if packed:
        qkv = _randn(gen, b, n, 3 * h * d, dtype=dtype)
        views = lambda x: x.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
        before = fl.flash_attention_relpos.backward_launches
        got = _grads(lambda x, rh, rw: fl.flash_attention_relpos(
            *views(x), rh, rw), (qkv, rel_h, rel_w), dout)
        assert fl.flash_attention_relpos.backward_launches == before + 1
        want = fl.flash_attention_relpos_backward_reference(
            *views(qkv), rel_h, rel_w, dout)
        dq, dk, dv = got[0].view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
        got = [dq, dk, dv, got[1], got[2]]
    else:
        q, k, v = (_randn(gen, b, h, n, d, dtype=dtype) for _ in range(3))
        got = _grads(fl.flash_attention_relpos, (q, k, v, rel_h, rel_w), dout)
        want = fl.flash_attention_relpos_backward_reference(
            q, k, v, rel_h, rel_w, dout)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        _close(x, y, dtype, name)
    _close_drel(got[3:], want[3:], dtype)


@pytest.mark.parametrize("b,h,kh,kw,d", [
    (2, 2, 16, 64, 64),     # the key-grid mode
    (1, 2, 16, 64, 80),
    (1, 2, 30, 35, 64),     # any KW
    (1, 1, 32, 32, 160),
])
def test_flash_relpos_bf16_backward_is_reproducible(cuda, b, h, kh, kw, d):
    """K5's bf16 backward sums in a fixed order (no atomics): two runs give
    the same bits, every gradient and drel."""
    n = kh * kw
    gen = torch.Generator(device="cuda").manual_seed(n + d + 7)
    q, k, v, dout = (_randn(gen, b, h, n, d, dtype=torch.bfloat16)
                     for _ in range(4))
    rel_h, rel_w = _rel(gen, (b, h, n), kh, kw)
    first = _grads(fl.flash_attention_relpos, (q, k, v, rel_h, rel_w), dout)
    again = _grads(fl.flash_attention_relpos, (q, k, v, rel_h, rel_w), dout)
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.parametrize("kw", [64, 35])
def test_flash_relpos_bf16_backward_with_strided_rel_terms(cuda, kw):
    """rel_h and rel_w as non-contiguous views (rel_h sliced from wider
    rows, rel_w a transposed [B, N, H, KW] tensor, as the attention module
    can hand them), in both KW modes: the same gradients as from contiguous
    copies, bit for bit, and within the tolerance of the plain version."""
    b, h, kh, d = 2, 2, 16, 64
    n = kh * kw
    gen = torch.Generator(device="cuda").manual_seed(kw + 11)
    q, k, v, dout = (_randn(gen, b, h, n, d, dtype=torch.bfloat16)
                     for _ in range(4))
    rel_h = _randn(gen, b, h, n, kh + 5, dtype=torch.float32)[..., 3:3 + kh]
    rel_w = _randn(gen, b, n, h, kw, dtype=torch.float32).transpose(1, 2)
    assert not rel_h.is_contiguous() and not rel_w.is_contiguous()
    got = _grads(fl.flash_attention_relpos, (q, k, v, rel_h, rel_w), dout)
    dense = _grads(fl.flash_attention_relpos,
                   (q, k, v, rel_h.contiguous(), rel_w.contiguous()), dout)
    assert all(torch.equal(x, y) for x, y in zip(got, dense))
    want = fl.flash_attention_relpos_backward_reference(q, k, v, rel_h,
                                                        rel_w, dout)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        _close(x, y, torch.bfloat16, name)
    _close_drel(got[3:], want[3:], torch.bfloat16)


@pytest.mark.parametrize("kh,kw", [(4, 96), (6, 32), (9, 13)])
def test_flash_relpos_bf16_backward_across_grid_rows(cuda, kh, kw):
    """KW != 64: a dK/dV block's two warpgroups (64 keys each) fall on
    different key-grid rows, and one warpgroup's keys span two rows (KW =
    96), several (KW = 32, 13); the dQ walk's tiles cross rows likewise."""
    b, h, d = 1, 2, 64
    n = kh * kw
    gen = torch.Generator(device="cuda").manual_seed(kh * kw + 5)
    q, k, v, dout = (_randn(gen, b, h, n, d, dtype=torch.bfloat16)
                     for _ in range(4))
    rel_h, rel_w = _rel(gen, (b, h, n), kh, kw)
    got = _grads(fl.flash_attention_relpos, (q, k, v, rel_h, rel_w), dout)
    want = fl.flash_attention_relpos_backward_reference(q, k, v, rel_h,
                                                        rel_w, dout)
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        _close(x, y, torch.bfloat16, name)
    _close_drel(got[3:], want[3:], torch.bfloat16)


def test_flash_relpos_fp32_backward_entry_refuses_bf16(cuda):
    """flash_attention.cu holds only fp32 kernels: its rel-pos backward
    entry refuses bf16 (cudaErrorInvalidValue) and launches nothing."""
    b, h, n, d, kh, kw = 1, 1, 64, 64, 8, 8
    q = torch.zeros(b, h, n, d, dtype=torch.bfloat16, device="cuda")
    stats = torch.zeros(b * h, n, device="cuda")
    rel = torch.zeros(b, h, n, kh, device="cuda")
    err = fl._library()[1](
        *(q.data_ptr(),) * 7, stats.data_ptr(), stats.data_ptr(),
        *(rel.data_ptr(),) * 4, *q.stride()[:3], *q.stride()[:3],
        *q.stride()[:3], *(rel.stride()[:3] * 4), b, h, n, d, kh, kw,
        d ** -0.5, 1, torch.cuda.current_stream().cuda_stream)
    assert err == 1


# ------------------------------------------------ K6, K1 sm_scale, K2 d=56


def _slot_bias(gen, b, nk, kind):
    """[B, Nk] fp32 key bias: random, SAM2's ring of memory slots and
    pointer tokens with all but one slot of each masked (-1e9), or every
    key masked."""
    if kind == "random":
        return torch.randn(b, nk, device="cuda", generator=gen)
    bias = torch.full((b, nk), -1e9, device="cuda")
    if kind == "slots":         # one valid slot of 4 and one valid pointer
        slot = (nk - 16) // 4
        bias[:, slot:2 * slot] = 0.0
        bias[:, -4:] = 0.0
    return bias


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,h,nq,nk,d,kind,layout", [
    (1, 1, 256, 4 * 64 + 16, 256, "slots", "memory"),
    (1, 1, 100, 4 * 333 + 16, 256, "slots", "contiguous"),
    (1, 2, 300, 300, 56, None, "packed"),
    (2, 3, 130, 130, 64, None, "packed"),
    (2, 2, 64, 37, 64, "random", "contiguous"),
    (1, 2, 17, 200, 160, "random", "memory"),
    (2, 1, 65, 1, 64, "masked", "contiguous"),
    (1, 3, 33, 77, 200, "masked", "contiguous"),
    (1, 2, 1000, 129, 8, None, "contiguous"),
    (1, 4, 16, 64, 40, "random", "memory"),
])
def test_key_bias_flash_forward(cuda, b, h, nq, nk, d, kind, layout, dtype):
    dtype = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(nq * nk + d)
    if layout == "packed":      # Hiera's global block: views of one qkv
        qkv = _randn(gen, b, nq, 3 * h * d, dtype=dtype)
        q, k, v = qkv.view(b, nq, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    elif layout == "memory":    # SAM2's RoPEAttention: q a transposed view
        q = _randn(gen, b, nq, h, d, dtype=dtype).transpose(1, 2)
        k = _randn(gen, b, h, nk, d, dtype=dtype)
        v = _randn(gen, b, nk, h, d, dtype=dtype).transpose(1, 2)
    else:
        q = _randn(gen, b, h, nq, d, dtype=dtype)
        k, v = (_randn(gen, b, h, nk, d, dtype=dtype) for _ in range(2))
    bias = None if kind is None else _slot_bias(gen, b, nk, kind)
    scale = 0.3 if kind == "random" else None
    before = fl.flash_attention.launches
    out, lse = fl.flash_attention(q, k, v, bias, scale, return_lse=True)
    torch.cuda.synchronize()
    assert fl.flash_attention.launches == before + 1
    assert out.shape == (b, h, nq, d) and out.dtype == dtype
    want, want_lse = fl.flash_attention_reference(q, k, v, bias, scale,
                                                  return_lse=True)
    _close(out, want, dtype, "out")
    err = (lse - want_lse).abs().max().item()
    assert err <= 1e-3 * max(1.0, want_lse.abs().max().item()), err


def test_key_bias_flash_takes_unaligned_tensors_and_refuses_the_rest(cuda):
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, h, nq, nk, d = 1, 2, 40, 70, 64
    flat = _randn(gen, b * h * (nq + 2 * nk) * d + 1, dtype=torch.bfloat16)
    q = flat[1:1 + b * h * nq * d].view(b, h, nq, d)
    k, v = flat[1 + b * h * nq * d:].view(2, b, h, nk, d).unbind(0)
    assert q.data_ptr() % 16 == 2
    bias = _slot_bias(gen, b, nk, "random")
    _close(fl.flash_attention(q, k, v, bias),
           fl.flash_attention_reference(q, k, v, bias), torch.bfloat16, "out")
    with pytest.raises(ValueError):          # the bias is [B, Nk] fp32
        fl.flash_attention(q, k, v, bias[:, :-1])
    with pytest.raises(ValueError):
        fl.flash_attention(q, k, v, bias.half())
    wide = torch.zeros(1, 1, 8, 264, device="cuda")
    with pytest.raises(ValueError):          # D <= 256
        fl.flash_attention(wide, wide, wide)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    dout = _randn(gen, b, h, nq, d, dtype=torch.bfloat16)
    out = fl.flash_attention(*leaves, bias)
    out.backward(dout)                       # the backward on unaligned views
    want = fl.flash_attention_backward_reference(q, k, v, bias, dout)
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        _close(leaf.grad, w, torch.bfloat16, name)


# ------------------------------------ K5 and K6 bf16 forward on wgmma


def _slots(b, nk, valid, slot=128):
    """[B, Nk] key bias: 0 on the 128-key slots in ``valid`` and on the last
    4 keys (a pointer in the ragged last tile), -1e9 elsewhere."""
    bias = torch.full((b, nk), -1e9, device="cuda")
    for i in valid:
        bias[:, i * slot:(i + 1) * slot] = 0.0
    bias[:, nk - 4:] = 0.0
    return bias


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("d", [56, 64, 80, 160, 256])
def test_flash_forward_head_dims_at_a_split_shape(cuda, d, residual):
    """K6's bf16 forward at each of the kernel's head-dim shapes (56 read
    as 64, 64, 80 with a 16-column tail, 160 as 192, 256), with and without
    P's residual (a gradient to come), at B = H = 1 where the keys split
    (300 queries, 3 blocks: 11 splits of one tile each), empty slots before
    and after the valid ones: against the plain version and the plain split
    walk with the kernel's splits, bf16 2e-2."""
    gen = torch.Generator(device="cuda").manual_seed(d + residual)
    b, h, nq, nk = 1, 1, 300, 5 * 128 + 60
    q, k, v = _key_bias_inputs(gen, b, h, nq, nk, d, "memory", torch.bfloat16)
    bias = _slots(b, nk, (1, 3))
    leaves = [t.detach().requires_grad_(residual) for t in (q, k, v)]
    out, lse = fl.flash_attention(*leaves, bias, return_lse=True)
    torch.cuda.synchronize()
    splits = fl.forward_splits(b, h, nq, nk, torch.cuda.get_device_properties(
        0).multi_processor_count)
    assert splits > 1
    want, want_lse = fl.flash_attention_reference(q, k, v, bias,
                                                  return_lse=True)
    walk = fl.flash_attention_split_reference(q, k, v, bias, splits=splits,
                                              residual=residual)
    _close(out.detach(), want, torch.bfloat16, "out")
    _close(out.detach(), walk, torch.bfloat16, "out against the walk")
    err = (lse - want_lse).abs().max().item()
    assert err <= 1e-3 * max(1.0, want_lse.abs().max().item()), err


@pytest.mark.parametrize("nq,nk,d,valid", [
    (512, 7 * 128 + 64, 256, (0, 2, 6)),   # SAM2's memory cross-attention, cut
    (512, 512, 256, None),                 # its self-attention
    (256, 3 * 128 + 64, 64, (1,)),
])
def test_flash_forward_is_reproducible_at_split_shapes(cuda, nq, nk, d, valid):
    """Two runs of the bf16 forward at split shapes give the same bits, out
    and lse (the splits merge in a fixed order, no atomics)."""
    gen = torch.Generator(device="cuda").manual_seed(nq + nk + d)
    q, k, v = _key_bias_inputs(gen, 1, 1, nq, nk, d, "memory", torch.bfloat16)
    bias = None if valid is None else _slots(1, nk, valid)
    first = fl.flash_attention(q, k, v, bias, return_lse=True)
    again = fl.flash_attention(q, k, v, bias, return_lse=True)
    assert all(torch.equal(x, y) for x, y in zip(first, again))
    _close(first[0], fl.flash_attention_reference(q, k, v, bias),
           torch.bfloat16, "out")


@pytest.mark.parametrize("d", [64, 256])
def test_flash_forward_ignores_masked_keys_bit_for_bit(cuda, d):
    """The masked keys' k and v replaced by large noise leave out and lse
    the same bit for bit (empty tiles skipped, masked keys of kept tiles at
    P = 0), with empty slots before the first valid one; batch row 1 has no
    valid key and averages V."""
    gen = torch.Generator(device="cuda").manual_seed(d)
    b, h, nq, nk = 2, 2, 200, 6 * 128 + 60
    q, k, v = _key_bias_inputs(gen, b, h, nq, nk, d, "contiguous",
                               torch.bfloat16)
    bias = _slots(b, nk, (2, 4))
    bias[1] = -1e9
    first = fl.flash_attention(q, k, v, bias, return_lse=True)
    masked = bias[0] < -1e8
    k2, v2 = k.clone(), v.clone()
    k2[0, :, masked] = 100 * _randn(gen, h, int(masked.sum()), d,
                                    dtype=torch.bfloat16)
    v2[0, :, masked] = 100 * _randn(gen, h, int(masked.sum()), d,
                                    dtype=torch.bfloat16)
    again = fl.flash_attention(q, k2, v2, bias, return_lse=True)
    assert torch.equal(first[0][0], again[0][0])
    assert torch.equal(first[1][0], again[1][0])
    _close(first[0], fl.flash_attention_reference(q, k, v, bias),
           torch.bfloat16, "out")


@pytest.mark.parametrize("b,h,kh,kw,d", [
    (1, 2, 30, 35, 64),      # N = 1050: a ragged last key tile
    (2, 2, 48, 80, 64),      # KW = 80: tiles across key-grid rows
    (1, 2, 32, 128, 80),     # KW = 128: rel_w reloaded every tile
    (1, 1, 32, 32, 160),
    (1, 4, 16, 64, 128),
])
def test_flash_relpos_bf16_forward_shapes(cuda, b, h, kh, kw, d):
    """K5's bf16 forward where its plan changes: KW a multiple of 64 (rel_w
    in registers, rel_h staged) or not, N off the 64-key tiles, D = 80's
    tail and D = 128, 160; against the plain version, and two runs equal
    bit for bit."""
    n = kh * kw
    gen = torch.Generator(device="cuda").manual_seed(n + d)
    qkv = _randn(gen, b, n, 3 * h * d, dtype=torch.bfloat16)
    q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    rel_h, rel_w = _rel(gen, (b, h, n), kh, kw)
    out, lse = fl.flash_attention_relpos(q, k, v, rel_h, rel_w,
                                         return_lse=True)
    want, want_lse = fl.flash_attention_relpos_reference(
        q, k, v, rel_h, rel_w, return_lse=True)
    _close(out, want, torch.bfloat16, "out")
    err = (lse - want_lse).abs().max().item()
    assert err <= 1e-3 * max(1.0, want_lse.abs().max().item()), err
    again = fl.flash_attention_relpos(q, k, v, rel_h, rel_w, return_lse=True)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])


def _key_bias_inputs(gen, b, h, nq, nk, d, layout, dtype):
    """q, k, v in one of the callers' layouts: Hiera's global block (views
    of one packed qkv), SAM2's RoPEAttention (q and v transposed views), or
    contiguous."""
    if layout == "packed":
        qkv = _randn(gen, b, nq, 3 * h * d, dtype=dtype)
        return qkv.view(b, nq, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    if layout == "memory":
        return (_randn(gen, b, nq, h, d, dtype=dtype).transpose(1, 2),
                _randn(gen, b, h, nk, d, dtype=dtype),
                _randn(gen, b, nk, h, d, dtype=dtype).transpose(1, 2))
    return (_randn(gen, b, h, nq, d, dtype=dtype),
            *(_randn(gen, b, h, nk, d, dtype=dtype) for _ in range(2)))


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,h,nq,nk,d,kind,layout", [
    (1, 1, 256, 4 * 64 + 16, 256, "slots", "memory"),
    (1, 1, 100, 4 * 333 + 16, 256, "slots", "contiguous"),
    (1, 2, 300, 300, 56, None, "packed"),
    (2, 3, 130, 130, 64, None, "packed"),
    (2, 2, 64, 37, 64, "random", "contiguous"),
    (1, 2, 17, 200, 160, "random", "memory"),
    (1, 2, 1000, 129, 8, None, "contiguous"),
    (1, 4, 16, 64, 40, "random", "memory"),
    (1, 1, 70, 4 * 449 + 16, 256, "slots", "memory"),
    (2, 2, 300, 500, 256, "slots", "contiguous"),
    (2, 3, 200, 333, 56, "slots", "memory"),
    (2, 2, 200, 200, 64, "random", "packed"),
    (1, 1, 40, 128, 256, "masked", "contiguous"),
    (2, 1, 64, 200, 64, "masked", "contiguous"),
])
def test_key_bias_flash_backward(cuda, b, h, nq, nk, d, kind, layout, dtype):
    """K6's backward kernels against the plain backward: Nq != Nk both
    ways with ragged tails, masked slots (exactly zero dk and dv), D = 56,
    64 and 256 (B * H > 1 too) and odd widths, each layout's strides, a
    transposed dout, and every key masked (each row averages V)."""
    dtype = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(nq * nk + d + 1)
    q, k, v = _key_bias_inputs(gen, b, h, nq, nk, d, layout, dtype)
    bias = None if kind is None else _slot_bias(gen, b, nk, kind)
    scale = 0.3 if kind == "random" else 56 ** -0.5 if d == 64 else None
    dout = _randn(gen, b, nq, h, d, dtype=dtype).transpose(1, 2)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (fl.flash_attention.launches, fl.flash_attention.backward_launches)
    out = fl.flash_attention(*leaves, bias, scale)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fl.flash_attention.launches,
            fl.flash_attention.backward_launches) == (before[0] + 1,
                                                      before[1] + 1)
    # with a gradient to come the forward takes P.V at fp32 precision of P
    _close(out, fl.flash_attention_reference(q, k, v, bias, scale), dtype,
           "out")
    want = fl.flash_attention_backward_reference(q, k, v, bias, dout, scale)
    for name, leaf, w in zip(("dq", "dk", "dv"), leaves, want):
        assert leaf.grad.dtype == dtype and leaf.grad.shape == w.shape
        _close(leaf.grad, w, dtype, name)
    if kind == "slots":
        masked = bias[0] < -1e8
        for leaf in leaves[1:]:
            assert not leaf.grad[:, :, masked].any()
    again = torch.autograd.grad(fl.flash_attention(*leaves, bias, scale),
                                leaves, dout)
    assert all(torch.equal(x, leaf.grad) for x, leaf in zip(again, leaves))


def _memory_slot_bias(b, valid_slots, slots=7, slot_tokens=128, pointers=16,
                      valid_pointers=1):
    """SAM2's memory bias [B, slots * slot_tokens + 4 * pointers]: 0 on the
    valid slots (any of them, empty slots before and after) and on the
    first valid_pointers pointers of 4 tokens, -1e9 elsewhere."""
    bias = torch.full((b, slots * slot_tokens + 4 * pointers), -1e9,
                      device="cuda")
    for i in valid_slots:
        bias[:, i * slot_tokens:(i + 1) * slot_tokens] = 0.0
    start = slots * slot_tokens
    bias[:, start:start + 4 * valid_pointers] = 0.0
    return bias


def _key_bias_grads(q, k, v, bias, dout, scale=None):
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    return torch.autograd.grad(fl.flash_attention(*leaves, bias, scale),
                               leaves, dout)


@pytest.mark.parametrize("valid_slots,slot_tokens", [
    ((0,), 128), ((3,), 128), ((1, 4), 128), ((0, 6), 96), ((2, 3, 5), 100)])
def test_key_bias_flash_backward_skips_empty_slots(cuda, valid_slots,
                                                    slot_tokens):
    """The bf16 backward skips the key tiles of empty memory slots: frame-1
    style biases (one or a few valid slots, empty ones before and after,
    whole 64-key runs masked or slots off the tiles) at D = 256 against the
    plain backward, masked keys' dk and dv exactly 0, and the same bit for
    bit when run again."""
    gen = torch.Generator(device="cuda").manual_seed(sum(valid_slots)
                                                     + slot_tokens)
    b, h, nq, d = 1, 1, 300, 256
    bias = _memory_slot_bias(b, valid_slots, slot_tokens=slot_tokens)
    nk = bias.shape[1]
    q, k, v = _key_bias_inputs(gen, b, h, nq, nk, d, "memory", torch.bfloat16)
    dout = _randn(gen, b, nq, h, d, dtype=torch.bfloat16).transpose(1, 2)
    got = _key_bias_grads(q, k, v, bias, dout)
    want = fl.flash_attention_backward_reference(q, k, v, bias, dout)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        _close(x, w, torch.bfloat16, name)
    masked = bias[0] < -1e8
    for x in got[1:]:
        assert not x[:, :, masked].any() and x[:, :, ~masked].any()
    again = _key_bias_grads(q, k, v, bias, dout)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("d", [64, 256])
def test_key_bias_flash_backward_all_masked_rows(cuda, d):
    """Batch 0's keys all masked (its rows average V and are never
    skipped), batch 1's in slots, through the bf16 backward against the
    plain backward."""
    gen = torch.Generator(device="cuda").manual_seed(d)
    b, h, nq = 2, 2, 150
    bias = _memory_slot_bias(b, (1,), slots=3, slot_tokens=64)
    bias[0] = -1e9
    nk = bias.shape[1]
    q, k, v = _key_bias_inputs(gen, b, h, nq, nk, d, "contiguous",
                               torch.bfloat16)
    dout = _randn(gen, b, h, nq, d, dtype=torch.bfloat16)
    got = _key_bias_grads(q, k, v, bias, dout)
    want = fl.flash_attention_backward_reference(q, k, v, bias, dout)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        _close(x, w, torch.bfloat16, name)
        assert x[0].any()


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("slot_tokens", [64, 96])
def test_key_bias_flash_backward_ignores_masked_keys_bit_for_bit(
        cuda, dtype, slot_tokens):
    """With the masked keys' k and v replaced by other finite values, the
    kernel's dq and the valid keys' dk and dv are the same bit for bit (a
    masked key's P is exactly 0; the bf16 backward skips whole masked
    tiles and multiplies the rest by exact zeros), and the masked keys' dk
    and dv stay exactly 0."""
    dtype = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(slot_tokens)
    b, h, nq, d = 2, 2, 200, 256
    bias = _memory_slot_bias(b, (1, 3), slots=5, slot_tokens=slot_tokens)
    nk = bias.shape[1]
    masked = bias[0] < -1e8
    q, k, v = _key_bias_inputs(gen, b, h, nq, nk, d, "memory", dtype)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, masked] = 3 * _randn(gen, b, h, int(masked.sum()), d, dtype=dtype)
    v2[:, :, masked] = 3 * _randn(gen, b, h, int(masked.sum()), d, dtype=dtype)
    dout = _randn(gen, b, nq, h, d, dtype=dtype).transpose(1, 2)
    got = _key_bias_grads(q, k, v, bias, dout)
    other = _key_bias_grads(q, k2, v2, bias, dout)
    assert torch.equal(got[0], other[0])
    for x, y in zip(got[1:], other[1:]):
        assert torch.equal(x[:, :, ~masked], y[:, :, ~masked])
        assert not x[:, :, masked].any() and not y[:, :, masked].any()


@pytest.mark.parametrize("nq,nk,kind", [(1024, 1024, None),
                                         (512, 4 * 200 + 16, "slots")])
def test_key_bias_flash_backward_rows_of_ds_sum_to_zero(cuda, nq, nk, kind):
    """bf16 tokens that share a mean (as projections of LayerNorm'd tokens
    with a bias are) at D = 256: each row of dS0 sums to 0, so the keys' sum
    of dk is 0 but for rounding. The kernel's residue, over the keys' sum
    of |dk|, at most 1.25x the plain backward's (which keeps delta and dS0
    in fp32)."""
    gen = torch.Generator(device="cuda").manual_seed(nq + nk)
    d = 256
    mean_q, mean_k, mean_v = _randn(gen, 3, d, dtype=torch.float32)
    q = (0.5 * _randn(gen, 1, 1, nq, d, dtype=torch.float32)
         + mean_q).to(torch.bfloat16)
    k = (0.5 * _randn(gen, 1, 1, nk, d, dtype=torch.float32)
         + mean_k).to(torch.bfloat16)
    v = (_randn(gen, 1, 1, nk, d, dtype=torch.float32)
         + mean_v).to(torch.bfloat16)
    dout = _randn(gen, 1, 1, nq, d, dtype=torch.bfloat16)
    bias = None if kind is None else _slot_bias(gen, 1, nk, kind)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    dk = torch.autograd.grad(fl.flash_attention(*leaves, bias), leaves,
                             dout)[1]
    want = fl.flash_attention_backward_reference(q, k, v, bias, dout)[1]
    key_sum = lambda x: (x.float().sum(dim=2).norm()
                         / x.float().abs().sum(dim=2).norm()).item()
    assert key_sum(dk) <= 1.25 * key_sum(want), (key_sum(dk), key_sum(want))
    _close(dk, want, torch.bfloat16, "dk")


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,n,h", [(49, 64, 2), (16, 16, 4), (4, 196, 8),
                                   (9, 49, 8)])
def test_dense_with_hiera_sm_scale(cuda, b, n, h, dtype):
    """K1 on Hiera's windows: heads padded from 56 to 64, scale 56^-0.5."""
    dtype = DTYPES[dtype]
    scale = 56 ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(n * h)
    qkv = _randn(gen, b, n, 3 * h * 64, dtype=dtype).requires_grad_()
    dout = _randn(gen, b, n, h * 64, dtype=dtype)
    out = fa.fused_attention_dense(qkv, h, sm_scale=scale)
    out.backward(dout)
    torch.cuda.synchronize()
    _close(out, fa.fused_attention_dense_reference(qkv.detach(), h,
                                                   sm_scale=scale),
           dtype, "out")
    _close(qkv.grad, fa.fused_attention_dense_backward_reference(
        qkv.detach(), dout, h, sm_scale=scale), dtype, "dqkv")
    default = fa.fused_attention_dense_reference(qkv.detach(), h)
    assert (out.float() - default.float()).abs().max() > 1e-3


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,n,h", [(49, 64, 2), (4, 196, 8), (9, 49, 8)])
def test_k2_at_hiera_head_dim_56(cuda, b, n, h, dtype):
    """K2 on views of Hiera's packed qkv at the unpadded d = 56."""
    dtype = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(n * h + 56)
    qkv = _randn(gen, b, n, 3 * h * 56, dtype=dtype)
    q, k, v = qkv.view(b, n, 3, h, 56).permute(2, 0, 3, 1, 4).unbind(0)
    out = fa.fused_attention(q, k, v)
    torch.cuda.synchronize()
    _close(out, fa.fused_attention_reference(q, k, v), dtype, "out")


def _k8_inputs(gen, b, n, h, d, dtype):
    """x of unit scale, weights that keep qkv and the scores at unit scale,
    small biases, gamma near 1: x, wqkv, bqkv, wproj, bproj, gamma, beta."""
    c = h * d
    f32 = torch.float32
    return (_randn(gen, b, n, c, dtype=dtype),
            (_randn(gen, 3 * c, c, dtype=f32) * c ** -0.5).to(dtype),
            (0.02 * _randn(gen, 3 * c, dtype=f32)).to(dtype),
            (_randn(gen, c, c, dtype=f32) * c ** -0.5).to(dtype),
            (0.02 * _randn(gen, c, dtype=f32)).to(dtype),
            1.0 + 0.1 * _randn(gen, c, dtype=f32),
            0.1 * _randn(gen, c, dtype=f32))


def _rms(t):
    return t.float().pow(2).mean().sqrt().item()


def _rel_l2(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


K8_NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dgamma", "dbeta")


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,n,h,d", [
    (2, 21, 4, 64), (3, 50, 2, 128), (2, 8, 1, 64), (4, 197, 12, 64),
    (2, 197, 6, 128), (1, 1024, 2, 64), (2, 129, 3, 64)])
def test_attn_block_forward_and_backward(cuda, b, n, h, d, dtype):
    dtype = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(b * n + h * d)
    inputs = _k8_inputs(gen, b, n, h, d, dtype)
    dy = _randn(gen, b, n, h * d, dtype=dtype)
    leaves = [t.detach().requires_grad_() for t in inputs]
    counts = (ab.attn_block.launches, ab.attn_block.backward_launches)
    y = ab.attn_block(*leaves, h)
    grads = torch.autograd.grad(y, leaves, dy, retain_graph=True)
    again = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert (ab.attn_block.launches, ab.attn_block.backward_launches) == (
        counts[0] + 1, counts[1] + 2)
    assert y.dtype == dtype and all(g.dtype == t.dtype
                                    for g, t in zip(grads, inputs))
    for name, g, g2 in zip(K8_NAMES, grads, again):
        assert torch.isfinite(g).all(), name
        assert torch.equal(g, g2), f"{name} differs between two runs"
    plain_y = ab.attn_block_reference(*inputs, h)
    plain = ab.attn_block_backward_reference(*inputs, dy, h)
    if dtype == torch.float32:
        for name, got, want in zip(("y",) + K8_NAMES, (y,) + grads,
                                   (plain_y,) + plain):
            err = (got - want).abs().max().item()
            assert err <= 1e-4 * _rms(want), f"{name}: {err} vs {_rms(want)}"
        return
    exact_in = [t.float() for t in inputs]
    exact_y = ab.attn_block_reference(*exact_in, h)
    exact = ab.attn_block_backward_reference(*exact_in, dy.float(), h)
    for name, got, want, ref in zip(("y", "dx"), (y, grads[0]),
                                    (plain_y, plain[0]),
                                    (exact_y, exact[0])):
        assert _rms(got.float() - ref) <= 1.25 * _rms(want.float() - ref), (
            name, _rms(got.float() - ref), _rms(want.float() - ref))
    for name, got, want, ref in zip(K8_NAMES[1:], grads[1:], plain[1:],
                                    exact[1:]):
        if name == "dbqkv":   # the key third's exact gradient is 0
            c = h * d
            got, want, ref = (torch.cat([t[:c], t[2 * c:]])
                              for t in (got, want, ref))
        bound = max(1e-2, 1.25 * _rel_l2(want, ref))
        assert _rel_l2(got, ref) <= bound, (name, _rel_l2(got, ref), bound)


def test_attn_block_refuses_what_it_cannot_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n, h, d, dtype in ((8, 2, 80, torch.bfloat16),     # head dim 80
                           (1025, 1, 64, torch.bfloat16),  # N > 1024
                           (8, 1, 64, torch.float16)):
        inputs = _k8_inputs(gen, 1, n, h, d, torch.float32)
        inputs = [t.to(dtype) if i < 5 else t for i, t in enumerate(inputs)]
        with pytest.raises((ValueError, TypeError)):
            ab.attn_block(*inputs, h)
    x, wqkv, bqkv, wproj, bproj, gamma, beta = _k8_inputs(
        gen, 1, 8, 1, 64, torch.bfloat16)
    with pytest.raises(ValueError):   # gamma rounded to bf16
        ab.attn_block(x, wqkv, bqkv, wproj, bproj, gamma.bfloat16(), beta, 1)


GEMM_SHAPES = [(12608, 768), (591, 192), (130, 64), (394, 1024)]


def _gemm_operands(gen, product, m, c, integers):
    """A, B (in ``GEMM_PRODUCTS``'s layouts), bias and resid of one of K8's
    products at M rows and width C, bf16: unit scale (Linear weights at
    C^-0.5), or small integers that fp32 sums exactly in any order."""
    mnk = {"qkv": (m, 3 * c, c), "proj": (m, c, c), "dattn": (m, c, c),
           "dxn": (m, c, 3 * c), "dwproj": (c, c, m), "dwqkv": (3 * c, c, m)}
    mm, n, k = mnk[product]
    a_k, b_k, _ = ab.GEMM_PRODUCTS[product]

    def draw(*shape, scale=1.0, lim=8):
        if integers:
            return torch.randint(-lim, lim + 1, shape, device="cuda",
                                 generator=gen).to(torch.bfloat16)
        return (scale * torch.randn(*shape, device="cuda", generator=gen)).to(
            torch.bfloat16)
    weight = c ** -0.5 if product in ("qkv", "proj", "dattn", "dxn") else 1.0
    return (draw(*((mm, k) if a_k else (k, mm))),
            draw(*((n, k) if b_k else (k, n)), scale=weight),
            draw(n, scale=0.02), draw(mm, n, lim=64))


def _gemm_extra(epilogue, bias, resid):
    extra = {"bias": bias} if "bias" in epilogue else {}
    if epilogue == "bias_residual":
        extra["resid"] = resid
    return extra


@pytest.mark.parametrize("m,c", GEMM_SHAPES)
@pytest.mark.parametrize("product", sorted(ab.GEMM_PRODUCTS))
def test_attn_block_gemm_products(cuda, product, m, c):
    a_k, b_k, epilogue = ab.GEMM_PRODUCTS[product]
    gen = torch.Generator(device="cuda").manual_seed(m + c)
    a, b, bias, resid = _gemm_operands(gen, product, m, c, integers=False)
    extra = _gemm_extra(epilogue, bias, resid)
    before = ab.gemm.launches
    got = ab.gemm(a, b, a_k, b_k, epilogue, **extra)
    again = ab.gemm(a, b, a_k, b_k, epilogue, **extra)
    torch.cuda.synchronize()
    assert ab.gemm.launches == before + 2
    assert torch.equal(got, again), "two runs differ"
    want = ab.gemm_reference(a, b, a_k, b_k, epilogue, **extra)
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        assert diff.max().item() <= 1e-4 * _rms(want), (diff.max().item(),
                                                         _rms(want))
    else:
        bound = (2.0 ** -7 * torch.maximum(got.float().abs(),
                                           want.float().abs())
                 + 1e-4 * _rms(want))
        assert bool((diff <= bound).all()), (diff - bound).max().item()


@pytest.mark.parametrize("m,c", GEMM_SHAPES[1:])
@pytest.mark.parametrize("product", sorted(ab.GEMM_PRODUCTS))
def test_attn_block_gemm_exact_on_integers(cuda, product, m, c):
    """Small integer operands: every fp32 sum is exact in any order, so the
    kernel equals its plain version bit for bit (a wrong tile, layout or
    slice shows at once)."""
    a_k, b_k, epilogue = ab.GEMM_PRODUCTS[product]
    gen = torch.Generator(device="cuda").manual_seed(7 * m + c)
    a, b, bias, resid = _gemm_operands(gen, product, m, c, integers=True)
    extra = _gemm_extra(epilogue, bias, resid)
    got = ab.gemm(a, b, a_k, b_k, epilogue, **extra)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ab.gemm_reference(
        a, b, a_k, b_k, epilogue, **extra), rtol=0, atol=0)


def test_attn_block_gemm_refuses_what_it_cannot_take(cuda):
    bf = dict(device="cuda", dtype=torch.bfloat16)
    a, b = torch.zeros(64, 128, **bf), torch.zeros(64, 128, **bf)
    with pytest.raises(ValueError):   # A MN-major, B K-major: no K8 product
        ab.gemm(a, b, False, True, "store")
    with pytest.raises(ValueError):   # dxn's layout with a bias
        ab.gemm(a, b, True, False, "bias", bias=torch.zeros(128, **bf))
    with pytest.raises(TypeError):
        ab.gemm(a.float(), b.float(), True, True, "bias",
                bias=torch.zeros(64, device="cuda"))
    with pytest.raises(ValueError):   # K = 60: rows not 16-byte multiples
        ab.gemm(torch.zeros(64, 60, **bf), torch.zeros(64, 60, **bf), True,
                True, "bias", bias=torch.zeros(64, **bf))


def test_vit_blocks_under_gradient_checkpoint(cuda):
    """use_gradient_checkpoint with K8 and K7 (norm2) on every block: the
    recompute unpacks each kernel's saved tensors once, and the gradients
    equal the unchecked ones bit for bit (the kernels are deterministic)."""
    from simpleaicv_pytorch_training_examples_tpu_torch.models import common
    from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones import (
        vit)
    grads = []
    for checkpointed in (False, True):
        model = vit.ViT(16, 128, 2, 2, image_size=64, num_classes=5,
                        dtype=torch.bfloat16, use_fused_attention=True,
                        use_fused_norm=True, use_fused_block=True,
                        use_gradient_checkpoint=checkpointed).cuda()
        common.init_parameters_(model,
                                torch.Generator(device="cuda").manual_seed(0))
        gen = torch.Generator(device="cuda").manual_seed(1)
        images = _randn(gen, 2, 3, 64, 64, dtype=torch.bfloat16)
        counts = (ab.attn_block.launches, ln.layer_norm.backward_launches)
        (model(images).float() ** 2).sum().backward()
        torch.cuda.synchronize()
        assert ab.attn_block.launches - counts[0] == (4 if checkpointed else 2)
        assert ln.layer_norm.backward_launches - counts[1] == 2
        grads.append([p.grad for p in model.parameters()])
    for g, g2 in zip(*grads):
        assert torch.equal(g, g2)


# -------------------------------------------------------------- K9, K2b


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,n,h,d,n_real", [
    (2, 37, 4, 32, None), (2, 37, 4, 32, 30), (1, 16, 6, 16, None),
    (2, 197, 12, 64, 150), (1, 257, 4, 80, None), (2, 50, 4, 35, None),
    (1, 1024, 2, 128, 700), (3, 1, 2, 8, None),
])
def test_qkv_forward_and_backward(cuda, b, n, h, d, n_real, dtype):
    """K9 against its plain version; masked keys get no gradient; a rerun
    is the same bit for bit; at d = 64 and 128 it is K1 bit for bit."""
    dtype = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(n * d + (n_real or 0))
    qkv = _randn(gen, b, n, 3, h, d, dtype=dtype)
    dout = _randn(gen, b, n, h, d, dtype=dtype)
    counts = (fa.fused_attention_qkv.launches,
              fa.fused_attention_qkv.backward_launches)
    leaf = qkv.clone().requires_grad_()
    out = fa.fused_attention_qkv(leaf, n_real)
    (grad,) = torch.autograd.grad(out, leaf, dout, retain_graph=True)
    (again,) = torch.autograd.grad(out, leaf, dout)
    torch.cuda.synchronize()
    assert (fa.fused_attention_qkv.launches,
            fa.fused_attention_qkv.backward_launches) == (
                counts[0] + 1, counts[1] + 2)
    assert out.shape == (b, n, h, d) and grad.shape == qkv.shape
    _close(out, fa.fused_attention_qkv_reference(qkv, n_real), dtype, "out")
    _close(grad, fa.fused_attention_qkv_backward_reference(qkv, dout, n_real),
           dtype, "dqkv")
    assert torch.equal(grad, again)
    if n_real is not None:      # masked keys: no dk, no dv
        assert torch.count_nonzero(grad[:, n_real:, 1:]) == 0
    if d in fa.DENSE_HEAD_DIMS:
        dense = qkv.view(b, n, 3 * h * d).clone().requires_grad_()
        out_dense = fa.fused_attention_dense(dense, h, n_real)
        (grad_dense,) = torch.autograd.grad(out_dense, dense,
                                            dout.view(b, n, h * d))
        assert torch.equal(out.view(b, n, h * d), out_dense)
        assert torch.equal(grad.view(b, n, 3 * h * d), grad_dense)


def test_qkv_takes_a_strided_dout_and_unaligned_tensors(cuda):
    """dout as a transposed view (head dim contiguous), and a qkv and dout
    that start 2 bytes off a 16-byte boundary (element-wise loads)."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    b, n, h, d = 2, 33, 2, 64
    flat = _randn(gen, b * n * 3 * h * d + 1, dtype=torch.bfloat16)
    qkv = flat[1:].view(b, n, 3, h, d)
    assert qkv.data_ptr() % 16 == 2 and qkv.is_contiguous()
    for dout in (_randn(gen, b, h, n, d, dtype=torch.bfloat16).transpose(1, 2),
                 _randn(gen, b * n * h * d + 1,
                        dtype=torch.bfloat16)[1:].view(b, n, h, d)):
        leaf = qkv.clone().requires_grad_()
        out = fa.fused_attention_qkv(leaf)
        out.backward(dout)
        _close(out, fa.fused_attention_qkv_reference(qkv), torch.bfloat16,
               "out")
        _close(leaf.grad, fa.fused_attention_qkv_backward_reference(
            qkv, dout), torch.bfloat16, "dqkv")
    unaligned = flat[1:].view(b, n, 3, h, d)
    _close(fa.fused_attention_qkv(unaligned),
           fa.fused_attention_qkv_reference(unaligned), torch.bfloat16,
           "unaligned out")


def _bias_shape(kind, b, h, n):
    return {"full": (b, h, n, n), "heads": (1, h, n, n), "shared": (h, n, n),
            "keys": (b, 1, 1, n)}[kind]


@pytest.mark.parametrize("dtype", ["bf16", "fp32"])
@pytest.mark.parametrize("b,h,n,d,n_real,kind,bias_dtype,packed", [
    (2, 3, 20, 16, None, "full", "fp32", False),
    (2, 3, 20, 16, 13, "shared", "fp32", False),
    (2, 2, 196, 64, None, "full", "fp32", True),
    (2, 2, 196, 64, 150, "heads", "bf16", True),
    (1, 2, 257, 80, None, "full", "bf16", True),
    (2, 2, 50, 35, None, "full", "fp32", False),
    (1, 2, 1024, 128, 1000, "full", "fp32", False),
    (2, 2, 64, 64, None, "keys", "fp32", False),
    (1, 1, 1, 8, None, "full", "fp32", False),
    # the bf16 kernels' plan changes (one pass up to 264 keys, an 8-key last
    # chunk at 64k + 1..8, groups of 256 past 264), D = 80 and 128, every
    # bias kind and dtype
    (2, 3, 196, 64, None, "full", "bf16", False),
    (2, 2, 196, 80, None, "full", "fp32", True),
    (1, 2, 196, 128, 150, "full", "bf16", False),
    (2, 2, 196, 64, None, "shared", "bf16", False),
    (2, 2, 196, 64, 190, "keys", "bf16", False),
    (1, 2, 256, 128, None, "full", "fp32", False),
    (1, 2, 256, 64, 255, "heads", "fp32", False),
    (1, 2, 257, 64, 200, "full", "fp32", False),
    (1, 2, 264, 80, None, "shared", "fp32", False),
    (1, 2, 264, 128, 263, "full", "bf16", False),
    (1, 2, 265, 80, None, "full", "bf16", False),
    (1, 2, 265, 64, 260, "keys", "fp32", False),
    (2, 2, 129, 64, None, "full", "bf16", False),
    (1, 2, 136, 80, 100, "heads", "bf16", False),
    (1, 2, 72, 128, None, "full", "fp32", False),
    (1, 2, 520, 64, 515, "full", "bf16", False),
])
def test_bias_forward_and_backward(cuda, b, h, n, d, n_real, kind, bias_dtype,
                                   packed, dtype):
    """K2b against its plain version, the bias of std 3 so that an error in
    it shows in P; dbias in the bias's shape and dtype, 0 on masked keys;
    masked keys get no dk, dv; a rerun is the same bit for bit; K2's
    counters do not move."""
    dtype = DTYPES[dtype]
    gen = torch.Generator(device="cuda").manual_seed(n * d + (n_real or 0))
    if packed:
        qkv = _randn(gen, b, n, 3 * h * d, dtype=dtype)
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q, k, v = (_randn(gen, b, h, n, d, dtype=dtype) for _ in range(3))
    bias = (3.0 * _randn(gen, *_bias_shape(kind, b, h, n),
                         dtype=torch.float32)).to(DTYPES[bias_dtype])
    dout = _randn(gen, b, n, h, d, dtype=dtype).transpose(1, 2)
    k2 = (fa.fused_attention.launches, fa.fused_attention.backward_launches)
    counts = (fa.fused_attention_bias.launches,
              fa.fused_attention_bias.backward_launches)
    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    out = fa.fused_attention(*leaves[:3], n_real, bias=leaves[3])
    grads = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    again = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert (fa.fused_attention_bias.launches,
            fa.fused_attention_bias.backward_launches) == (
                counts[0] + 1, counts[1] + 2)
    assert (fa.fused_attention.launches,
            fa.fused_attention.backward_launches) == k2
    _close(out, fa.fused_attention_bias_reference(q, k, v, bias, n_real),
           dtype, "out")
    want = fa.fused_attention_bias_backward_reference(q, k, v, bias, dout,
                                                      n_real)
    for name, g, w, g2 in zip(("dq", "dk", "dv", "dbias"), grads, want,
                              again):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        # a bf16 dbias: the fp32 dS0 sums rounded to bf16 on either side
        _close(g, w, torch.bfloat16 if torch.bfloat16 in (dtype, w.dtype)
               else dtype, name)
        assert torch.equal(g, g2), f"{name} differs between two runs"
    if n_real is not None:
        assert torch.count_nonzero(grads[1][:, :, n_real:]) == 0
        assert torch.count_nonzero(grads[2][:, :, n_real:]) == 0
        assert torch.count_nonzero(grads[3][..., n_real:]) == 0


def test_bias_without_a_gradient_skips_dbias(cuda):
    """A bias that needs no gradient: the backward writes no dbias, and dq,
    dk, dv are those of the run that writes it, bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    b, h, n, d = 2, 2, 100, 64
    q, k, v, dout = (_randn(gen, b, h, n, d, dtype=torch.bfloat16)
                     for _ in range(4))
    bias = _randn(gen, b, h, n, n, dtype=torch.float32)
    grads = []
    for bias_grad in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        b_leaf = bias.clone().requires_grad_(bias_grad)
        fa.fused_attention(*leaves, bias=b_leaf).backward(dout)
        assert (b_leaf.grad is not None) == bias_grad
        grads.append([t.grad for t in leaves])
    for g0, g1 in zip(*grads):
        assert torch.equal(g0, g1)


def test_bias_takes_unaligned_tensors(cuda):
    """q, k, v and a bf16 bias 2 bytes off a 16-byte boundary."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    b, h, n, d = 2, 2, 33, 64
    flat = _randn(gen, 3 * b * h * n * d + 1, dtype=torch.bfloat16)
    q, k, v = flat[1:].view(3, b, h, n, d).unbind(0)
    bias = _randn(gen, b * h * n * n + 1, dtype=torch.bfloat16)[1:].view(
        b, h, n, n)
    assert q.data_ptr() % 16 == 2 and bias.data_ptr() % 16 == 2
    dout = _randn(gen, b, h, n, d, dtype=torch.bfloat16)
    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    out = fa.fused_attention(*leaves[:3], bias=leaves[3])
    grads = torch.autograd.grad(out, leaves, dout)
    _close(out, fa.fused_attention_bias_reference(q, k, v, bias),
           torch.bfloat16, "out")
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), grads,
                          fa.fused_attention_bias_backward_reference(
                              q, k, v, bias, dout)):
        _close(g, w, torch.bfloat16, name)


def test_qkv_and_bias_refuse_what_they_cannot_take(cuda):
    qkv = torch.zeros(2, 8, 3, 2, 64, device="cuda")
    with pytest.raises(ValueError):          # not contiguous
        fa.fused_attention_qkv(qkv.transpose(0, 1))
    with pytest.raises(ValueError):          # D past 128
        fa.fused_attention_qkv(torch.zeros(1, 8, 3, 1, 144, device="cuda"))
    with pytest.raises(ValueError):          # N past 1024
        fa.fused_attention_qkv(torch.zeros(1, 1025, 3, 1, 64, device="cuda"))
    with pytest.raises(TypeError):
        fa.fused_attention_qkv(qkv.half())
    q = torch.zeros(1, 2, 8, 64, device="cuda")
    bias = torch.zeros(1, 2, 8, 8, device="cuda")
    with pytest.raises(TypeError):           # fp32 or bf16 only
        fa.fused_attention(q, q, q, bias=bias.half())
    with pytest.raises(ValueError):          # the key axis broadcast
        fa.fused_attention(q, q, q, bias=bias[..., :1])
    with pytest.raises(ValueError):          # the key axis strided
        fa.fused_attention(q, q, q, bias=bias.transpose(2, 3))
    with pytest.raises(ValueError):          # on another device
        fa.fused_attention(q, q, q, bias=bias.cpu())
    q = torch.zeros(1, 2, 8, 144, device="cuda")
    with pytest.raises(ValueError):          # D past 128
        fa.fused_attention(q, q, q, bias=bias)


# ------------------------- the biased forward on wgmma (K2b, K3, K4, bf16)

# N -> (KH, KW) of a key grid with KH * KW = N
KEY_GRIDS = {50: (5, 10), 63: (7, 9), 160: (10, 16), 196: (14, 14),
             256: (16, 16), 257: (1, 257), 264: (8, 33), 1024: (32, 32)}


def _twice(wrapper, run):
    """Two runs of a forward: (out, the second run's out), counting one
    launch each."""
    before = wrapper.launches
    out, again = run(), run()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    return out, again


@pytest.mark.parametrize("n", sorted(KEY_GRIDS))
@pytest.mark.parametrize("d", [35, 64, 80, 128])
def test_biased_forward_row_lengths_and_head_dims(cuda, n, d):
    """K2b's and K4's bf16 forward (``short_attention_fwd.cu``) where
    the kernel's plan changes: one pass up to 264 keys (the last 64-key
    chunk 8 to 64 keys wide, past 256 an 8-key chunk), groups of 256 keys
    past it; columns in one
    box (D = 35, zero-padded to 48, and 64), 64 + 16 (80) and 64 + 64 (128).
    Against the plain versions, two runs equal bit for bit."""
    kh, kw = KEY_GRIDS[n]
    b, h = (1, 2) if n > 256 else (2, 2)
    gen = torch.Generator(device="cuda").manual_seed(n * 131 + d)
    q, k, v = (_randn(gen, b, h, n, d, dtype=torch.bfloat16) for _ in range(3))
    bias = 3.0 * _randn(gen, b, h, n, n, dtype=torch.float32)
    rel_h, rel_w = _rel(gen, (b, h, n), kh, kw)
    out, again = _twice(fa.fused_attention_bias,
                        lambda: fa.fused_attention(q, k, v, bias=bias))
    assert torch.equal(out, again)
    _close(out, fa.fused_attention_bias_reference(q, k, v, bias),
           torch.bfloat16, f"K2b N={n} D={d}")
    out, again = _twice(fa.fused_attention_relwin, lambda: (
        fa.fused_attention_relwin(q, k, v, rel_h, rel_w)))
    assert torch.equal(out, again)
    _close(out, fa.fused_attention_relwin_reference(q, k, v, rel_h, rel_w),
           torch.bfloat16, f"K4 N={n} D={d}")


@pytest.mark.parametrize("n,n_real", [
    (196, 150), (196, 128), (196, 64), (196, 1), (63, 57), (257, 256),
    (257, 200), (1024, 256), (1024, 700)])
def test_biased_forward_masks_the_key_tail(cuda, n, n_real):
    """Keys at or past n_real: ragged, a whole 64-key chunk or 256-key
    group masked, one key left."""
    kh, kw = KEY_GRIDS[n]
    gen = torch.Generator(device="cuda").manual_seed(n + n_real)
    q, k, v = (_randn(gen, 2, 2, n, 64, dtype=torch.bfloat16)
               for _ in range(3))
    bias = 3.0 * _randn(gen, 2, 2, n, n, dtype=torch.float32)
    rel_h, rel_w = _rel(gen, (2, 2, n), kh, kw)
    _close(fa.fused_attention(q, k, v, n_real, bias=bias),
           fa.fused_attention_bias_reference(q, k, v, bias, n_real),
           torch.bfloat16, "K2b")
    _close(fa.fused_attention_relwin(q, k, v, rel_h, rel_w, n_real),
           fa.fused_attention_relwin_reference(q, k, v, rel_h, rel_w, n_real),
           torch.bfloat16, "K4")


@pytest.mark.parametrize("kind", ["full", "heads", "shared", "keys"])
@pytest.mark.parametrize("bias_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("n", [196, 63, 257])
def test_biased_forward_takes_every_bias_layout(cuda, kind, bias_dtype, n):
    """K2b's bias broadcast from [1, H, N, N], [H, N, N] and [B, 1, 1, N]
    (staged once, its rows addressed through stride 0), fp32 or bf16 (bf16
    rows of 392 bytes take 8-byte copies, of 126 bytes element loads), in
    SAM's windows' layout (views of a packed qkv)."""
    b, h, d = 2, 3, 64
    gen = torch.Generator(device="cuda").manual_seed(n * 7 + len(kind))
    qkv = _randn(gen, b, n, 3 * h * d, dtype=torch.bfloat16)
    q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    bias = (3.0 * _randn(gen, *_bias_shape(kind, b, h, n),
                         dtype=torch.float32)).to(DTYPES[bias_dtype])
    out, again = _twice(fa.fused_attention_bias,
                        lambda: fa.fused_attention(q, k, v, n - 5, bias=bias))
    assert torch.equal(out, again)
    _close(out, fa.fused_attention_bias_reference(q, k, v, bias, n - 5),
           torch.bfloat16, f"K2b {kind} {bias_dtype}")


@pytest.mark.parametrize("b,h,kh,kw,d,packed", [
    (3, 16, 14, 14, 80, True), (2, 12, 14, 14, 64, False),
    (2, 4, 14, 14, 128, True), (1, 2, 32, 32, 80, True)])
def test_biased_forward_relwin_layouts(cuda, b, h, kh, kw, d, packed):
    """K4 on q, k, v [B, H, N, D] and on views of a packed qkv (SAM-H's
    layout, read in place by the tensor maps), K3 on the packed qkv itself
    (head dim 64 or 128); the rel terms in the modules' layouts."""
    n = kh * kw
    gen = torch.Generator(device="cuda").manual_seed(n + d + h)
    qkv = _randn(gen, b, n, 3 * h * d, dtype=torch.bfloat16)
    if packed:
        q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    else:
        q, k, v = (_randn(gen, b, h, n, d, dtype=torch.bfloat16)
                   for _ in range(3))
    rel_h, rel_w = _rel(gen, (b, h, n), kh, kw)
    out, again = _twice(fa.fused_attention_relwin, lambda: (
        fa.fused_attention_relwin(q, k, v, rel_h, rel_w)))
    assert torch.equal(out, again)
    _close(out, fa.fused_attention_relwin_reference(q, k, v, rel_h, rel_w),
           torch.bfloat16, "K4")
    if d in (64, 128):
        dense_h, dense_w = _rel(gen, (b, n, h), kh, kw)
        out, again = _twice(fa.fused_attention_relwin_dense, lambda: (
            fa.fused_attention_relwin_dense(qkv, dense_h, dense_w, h)))
        assert torch.equal(out, again)
        _close(out, fa.fused_attention_relwin_dense_reference(
            qkv, dense_h, dense_w, h), torch.bfloat16, "K3")
