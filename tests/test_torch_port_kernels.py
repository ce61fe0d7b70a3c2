"""The port's kernels K1/K2 (fused attention) and K7 (fused LayerNorm), the
rel-pos attention kernels K3, K4 and K5, forward and backward, and the
key-bias streaming attention K6, forward and backward, against the JAX
package.

On the CPU each wrapper takes its plain PyTorch version; these tests hold
that version against the JAX entry points run through their Pallas kernels
in interpret mode, on the same numpy inputs, gradients through ``jax.grad``
of the kernels' custom VJPs against the port's autograd Functions. The CUDA
kernels themselves are held against the plain versions on the card by
chip_smoke.py.

K5 has no interpret mode: its plain versions are held against the JAX
package's off-TPU composition of ``flash_attention_relpos`` and that
composition's VJP. K6's plain version is held against the TPU kernel
``_flash_forward`` run in interpret mode, out and log-sum-exp, fp32 rtol
and atol 2e-5 (the JAX package's own tolerance for it), with the JAX
wrapper's padding (head dim to 64, keys and queries to the block, -1e9 on
the padded keys) done here; its plain backward against ``_flash_backward``
in interpret mode, padded the same way.

Tolerances: fp32 atol 1e-5 (same math, another summation order; the
rel-pos kernels atol 2e-5, rtol 1e-5, as the JAX package's own tests hold
its rel-pos kernels); bf16
atol 2e-2 for the attention output and its gradients (a few bf16 ulps at
|x| <= 2, from rounding P, dS and the outputs). LayerNorm: fp32 atol 1e-5
for y and 1e-4 for the gradients (the TPU kernel takes the variance as
E[x^2] - E[x]^2, the port in two passes); bf16 atol 3.2e-2 (one ulp at
|y| <= 4) for y and dx, and dgamma/dbeta, fp32 sums of bf16-rounded
products, 2e-2.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
    build, flash_attention as port_fl, fused_attention as port_fa,
    layer_norm as port_ln)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

# the JAX package's ops.pallas re-exports a function of the module's name
jax_fa = importlib.import_module(
    "simpleaicv_pytorch_training_examples_tpu.ops.pallas.fused_attention")

jax_ln = importlib.import_module(
    "simpleaicv_pytorch_training_examples_tpu.ops.pallas.layer_norm")

jax_fl = importlib.import_module(
    "simpleaicv_pytorch_training_examples_tpu.ops.pallas.flash_attention")

REL = dict(rtol=1e-5, atol=2e-5)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x, dtype):
    """numpy fp32 -> (jax array, torch tensor), both rounded to dtype."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(TORCH_DTYPE[dtype]))


def _to_np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim,n_real", [(64, None), (64, 13),
                                             (128, None), (128, 19)])
def test_dense_plain_version_matches_jax_kernel(head_dim, n_real, dtype):
    b, n, h = 2, 20, 2
    rs = np.random.RandomState(head_dim + (n_real or 0))
    x = rs.standard_normal((b, n, 3 * h * head_dim)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want = jax_fa.fused_attention_dense(jx, h, n_real=n_real, interpret=True)
    got = port_fa.fused_attention_dense(tx, h, n_real=n_real)
    assert got.dtype == tx.dtype and got.shape == (b, n, h * head_dim)
    np.testing.assert_allclose(_to_np(got), _to_np(want), rtol=0,
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim,n_real", [(64, None), (80, None), (80, 11),
                                             (128, 17)])
def test_plain_version_matches_jax_kernel(head_dim, n_real, dtype):
    b, h, n = 2, 3, 21
    rs = np.random.RandomState(head_dim + (n_real or 0) + 1)
    qkv = rs.standard_normal((3, b, h, n, head_dim)).astype(np.float32)
    jq, jk, jv = (_pair(a, dtype)[0] for a in qkv)
    tq, tk, tv = (_pair(a, dtype)[1] for a in qkv)
    want = jax_fa.fused_attention(jq, jk, jv, n_real=n_real, interpret=True)
    got = port_fa.fused_attention(tq, tk, tv, n_real=n_real)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_to_np(got), _to_np(want), rtol=0,
                               atol=TOL[dtype])


def test_cpu_tensors_take_the_plain_version_without_counting():
    rs = np.random.RandomState(0)
    qkv = torch.from_numpy(rs.standard_normal((1, 9, 3 * 128)).astype(
        np.float32))
    q, k, v = torch.from_numpy(rs.standard_normal((3, 1, 2, 9, 80)).astype(
        np.float32)).unbind(0)
    dense0, plain0 = (port_fa.fused_attention_dense.launches,
                      port_fa.fused_attention.launches)
    torch.testing.assert_close(
        port_fa.fused_attention_dense(qkv, 2),
        port_fa.fused_attention_dense_reference(qkv, 2), rtol=0, atol=0)
    torch.testing.assert_close(port_fa.fused_attention(q, k, v),
                               port_fa.fused_attention_reference(q, k, v),
                               rtol=0, atol=0)
    assert port_fa.fused_attention_dense.launches == dense0
    assert port_fa.fused_attention.launches == plain0


def test_masked_keys_get_no_weight():
    """Keys at or past n_real change nothing: the result equals attention
    over the first n_real keys alone."""
    rs = np.random.RandomState(3)
    q, k, v = torch.from_numpy(rs.standard_normal((3, 2, 2, 12, 16)).astype(
        np.float32)).unbind(0)
    got = port_fa.fused_attention_reference(q, k, v, n_real=7)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, :7]) * 16 ** -0.5
    want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v[:, :, :7])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape,heads,n_real,error", [
    ((2, 8, 3 * 2 * 80), 2, None, ValueError),     # K1 head dim 80
    ((2, 1025, 3 * 64), 1, None, ValueError),      # N past 1024
    ((2, 8, 3 * 64), 1, 9, ValueError),            # n_real past N
    ((2, 8, 3 * 64), 1, 0, ValueError),            # n_real below 1
])
def test_dense_shape_rule_rejects(shape, heads, n_real, error):
    with pytest.raises(error):
        port_fa.check_dense_args(torch.zeros(shape), heads, n_real)


def test_shape_rules_reject_dtype_layout_and_head_dim():
    x = torch.zeros(2, 8, 3 * 64)
    with pytest.raises(TypeError):
        port_fa.check_dense_args(x.half(), 1)
    with pytest.raises(ValueError):
        port_fa.check_dense_args(x.transpose(0, 1), 1)
    q = torch.zeros(1, 2, 8, 144)
    with pytest.raises(ValueError):
        port_fa.check_args(q, q, q)
    q = torch.zeros(1, 2, 8, 80)
    assert port_fa.check_args(q, q, q, 5) == (1, 2, 8, 80, 5)


def test_k2_reads_views_of_the_packed_qkv_in_place():
    qkv = torch.zeros(2, 9, 3 * 2 * 80)
    q, k, v = qkv.reshape(2, 9, 3, 2, 80).permute(2, 0, 3, 1, 4).unbind(0)
    assert not q.is_contiguous()
    assert port_fa.check_args(q, k, v) == (2, 2, 9, 80, 9)
    with pytest.raises(ValueError):       # strides differ
        port_fa.check_args(q, k.contiguous(), v)
    t = torch.zeros(2, 2, 80, 9).transpose(2, 3)
    with pytest.raises(ValueError):       # head dim not contiguous
        port_fa.check_args(t, t, t)


def test_build_targets_hopper_from_repo_sources():
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "-shared" in build.NVCC_FLAGS
    for name in build.SOURCES:
        assert (build.CSRC_DIR / f"{name}.cu").is_file()
        path = build.library_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}_") and path.suffix == ".so"
    assert build.BUILD_DIR.parent.name == "build"


# ------------------------------------------------------ K1/K2 backward


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim,n_real", [(64, None), (64, 13),
                                             (128, 19)])
def test_dense_backward_matches_jax_kernel_vjp(head_dim, n_real, dtype):
    b, n, h = 2, 20, 2
    rs = np.random.RandomState(100 + head_dim + (n_real or 0))
    x = rs.standard_normal((b, n, 3 * h * head_dim)).astype(np.float32)
    g = rs.standard_normal((b, n, h * head_dim)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jg, tg = _pair(g, dtype)
    out, vjp = jax.vjp(lambda t: jax_fa.fused_attention_dense(
        t, h, n_real=n_real, interpret=True), jx)
    (want,) = vjp(jg)
    tx.requires_grad_()
    before = port_fa.fused_attention_dense.backward_launches
    port_fa.fused_attention_dense(tx, h, n_real=n_real).backward(tg)
    assert tx.grad.dtype == tx.dtype and tx.grad.shape == tx.shape
    np.testing.assert_allclose(_to_np(tx.grad), _to_np(want), rtol=0,
                               atol=TOL[dtype])
    # CPU tensors take the plain version and count no launch
    assert port_fa.fused_attention_dense.backward_launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim,n_real", [(64, None), (80, 11),
                                             (128, 17)])
def test_backward_matches_jax_kernel_vjp(head_dim, n_real, dtype):
    b, h, n = 2, 3, 21
    rs = np.random.RandomState(200 + head_dim + (n_real or 0))
    qkv = rs.standard_normal((3, b, h, n, head_dim)).astype(np.float32)
    g = rs.standard_normal((b, h, n, head_dim)).astype(np.float32)
    jq, jk, jv = (_pair(a, dtype)[0] for a in qkv)
    tq, tk, tv = (_pair(a, dtype)[1].requires_grad_() for a in qkv)
    jg, tg = _pair(g, dtype)
    _, vjp = jax.vjp(lambda q, k, v: jax_fa.fused_attention(
        q, k, v, n_real=n_real, interpret=True), jq, jk, jv)
    want = vjp(jg)
    port_fa.fused_attention(tq, tk, tv, n_real=n_real).backward(tg)
    for got, w in zip((tq, tk, tv), want):
        assert got.grad.dtype == got.dtype
        np.testing.assert_allclose(_to_np(got.grad), _to_np(w), rtol=0,
                                   atol=TOL[dtype])


def test_backward_of_views_of_the_packed_qkv_lands_in_the_packed_layout():
    """K2 through the attention module's views: autograd maps dq, dk, dv
    back onto the packed [B, N, 3C] qkv, equal to K1's packed gradient."""
    rs = np.random.RandomState(7)
    b, n, h, d = 2, 9, 2, 64
    x = torch.from_numpy(rs.standard_normal((b, n, 3 * h * d)).astype(
        np.float32))
    g = torch.from_numpy(rs.standard_normal((b, n, h * d)).astype(np.float32))
    packed = x.clone().requires_grad_()
    port_fa.fused_attention_dense(packed, h, 7).backward(g)
    views = x.clone().requires_grad_()
    q, k, v = views.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4).unbind(0)
    out = port_fa.fused_attention(q, k, v, 7)
    out.transpose(1, 2).reshape(b, n, h * d).backward(g)
    torch.testing.assert_close(views.grad, packed.grad, rtol=0, atol=1e-6)


def test_masked_keys_get_zero_gradient():
    rs = np.random.RandomState(8)
    q, k, v, g = torch.from_numpy(rs.standard_normal(
        (4, 1, 2, 12, 16)).astype(np.float32)).unbind(0)
    dq, dk, dv = port_fa.fused_attention_backward_reference(q, k, v, g, 7)
    assert torch.count_nonzero(dk[:, :, 7:]) == 0
    assert torch.count_nonzero(dv[:, :, 7:]) == 0
    assert torch.count_nonzero(dk[:, :, :7]) > 0 and torch.isfinite(dq).all()


def test_no_grad_and_inference_mode_run_only_the_forward():
    x = torch.zeros(1, 8, 3 * 64, requires_grad=True)
    with torch.no_grad():
        assert not port_fa.fused_attention_dense(x, 1).requires_grad
    with torch.inference_mode():
        out = port_fa.fused_attention_dense(x.detach(), 1)
    assert out.shape == (1, 8, 64) and not out.requires_grad
    assert port_fa.fused_attention_dense(x, 1).requires_grad


# ------------------------------------------------------------- K7


def _ln_inputs(shape, dtype, seed):
    rs = np.random.RandomState(seed)
    x = (2.0 * rs.standard_normal(shape) + 0.5).astype(np.float32)
    gamma = (1.0 + 0.1 * rs.standard_normal(shape[-1])).astype(np.float32)
    beta = (0.1 * rs.standard_normal(shape[-1])).astype(np.float32)
    dy = rs.standard_normal(shape).astype(np.float32)
    return _pair(x, dtype), _pair(gamma, "float32"), _pair(beta, "float32"), \
        _pair(dy, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(48, 128), (2, 19, 64), (37, 100)])
def test_layer_norm_matches_jax_kernel_forward_and_vjp(shape, dtype):
    """Ragged token counts (38 and 37 rows against 16-row TPU blocks)."""
    (jx, tx), (jg, tg), (jb, tb), (jdy, tdy) = _ln_inputs(shape, dtype, 31)
    y_want, vjp = jax.vjp(lambda x, g, b: jax_ln.layer_norm(
        x, g, b, block_tokens=16, interpret=True), jx, jg, jb)
    want = vjp(jdy)
    leaves = [t.requires_grad_() for t in (tx, tg, tb)]
    y = port_ln.layer_norm(*leaves)
    y.backward(tdy)
    assert y.dtype == tx.dtype and tx.grad.dtype == tx.dtype
    assert tg.grad.dtype == tb.grad.dtype == torch.float32
    half = dtype == "bfloat16"
    np.testing.assert_allclose(_to_np(y), _to_np(y_want), rtol=0,
                               atol=3.2e-2 if half else 1e-5)
    np.testing.assert_allclose(_to_np(tx.grad), _to_np(want[0]), rtol=0,
                               atol=3.2e-2 if half else 1e-4)
    for got, w in zip((tg.grad, tb.grad), want[1:]):
        np.testing.assert_allclose(_to_np(got), _to_np(w),
                                   rtol=2e-2 if half else 1e-4,
                                   atol=2e-2 if half else 1e-4)


def test_layer_norm_plain_backward_is_the_autograd_of_its_forward():
    (_, x), (_, gamma), (_, beta), (_, dy) = _ln_inputs((5, 7, 24),
                                                        "float32", 32)
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    torch.nn.functional.layer_norm(leaves[0], (24,), leaves[1], leaves[2],
                                   1e-6).backward(dy)
    got = port_ln.layer_norm_backward_reference(x, gamma, dy)
    for g, leaf in zip(got, leaves):
        torch.testing.assert_close(g, leaf.grad, rtol=1e-5, atol=1e-5)


def test_layer_norm_never_rounds_gamma_and_beta():
    """bf16 activations with fp32 gamma/beta: the affine map is fp32."""
    x = torch.tensor([[1.0, -1.0, 3.0, -3.0]], dtype=torch.bfloat16)
    gamma = torch.full((4,), 1.0 + 2.0 ** -12)   # not a bf16 number
    beta = torch.zeros(4)
    y = port_ln.layer_norm(x, gamma, beta).float()
    y_rounded = port_ln.layer_norm(x, gamma.bfloat16().float(), beta).float()
    want = port_ln.layer_norm_reference(x.float(), gamma, beta)
    torch.testing.assert_close(y, want.bfloat16().float(), rtol=0, atol=0)
    assert y.dtype == torch.float32 and y_rounded.shape == y.shape


def test_layer_norm_shape_rule_and_cpu_counts():
    x = torch.zeros(3, 8)
    with pytest.raises(ValueError):
        port_ln.check_args(x, torch.ones(8).bfloat16(), torch.zeros(8))
    with pytest.raises(ValueError):
        port_ln.check_args(x, torch.ones(7), torch.zeros(8))
    with pytest.raises(TypeError):
        port_ln.check_args(x.half(), torch.ones(8), torch.zeros(8))
    assert port_ln.check_args(x, torch.ones(8), torch.zeros(8)) == (3, 8)
    counts = (port_ln.layer_norm.launches, port_ln.layer_norm.backward_launches)
    x.requires_grad_()
    port_ln.layer_norm(x, torch.ones(8), torch.zeros(8)).sum().backward()
    assert counts == (port_ln.layer_norm.launches,
                      port_ln.layer_norm.backward_launches)


# ------------------------------------------------------------- K3-K5


def _rel_inputs(lead, kh, kw, seed):
    rs = np.random.RandomState(seed)
    rel_h = rs.standard_normal(lead + (kh,)).astype(np.float32)
    rel_w = rs.standard_normal(lead + (kw,)).astype(np.float32)
    return (jnp.asarray(rel_h), jnp.asarray(rel_w),
            torch.from_numpy(rel_h), torch.from_numpy(rel_w))


@pytest.mark.parametrize("kh,kw,head_dim", [(3, 4, 64), (4, 4, 128),
                                            (2, 5, 64)])
def test_relwin_dense_plain_version_matches_jax_kernel(kh, kw, head_dim):
    """K3: windowed attention over the packed qkv with the rel-pos bias."""
    b, h, n = 2, 2, kh * kw
    rs = np.random.RandomState(300 + n + head_dim)
    x = rs.standard_normal((b, n, 3 * h * head_dim)).astype(np.float32)
    jh, jw, th, tw = _rel_inputs((b, n, h), kh, kw, 301 + n)
    want = jax_fa.fused_attention_relwin_dense(jnp.asarray(x), jh, jw, h,
                                               interpret=True)
    before = port_fa.fused_attention_relwin_dense.launches
    got = port_fa.fused_attention_relwin_dense(torch.from_numpy(x), th, tw, h)
    assert got.shape == (b, n, h * head_dim)
    assert port_fa.fused_attention_relwin_dense.launches == before
    np.testing.assert_allclose(_to_np(got), _to_np(want), **REL)


@pytest.mark.parametrize("kh,kw,head_dim,n_real", [(3, 4, 8, None),
                                                   (3, 4, 40, 9),
                                                   (4, 5, 80, None)])
def test_relwin_plain_version_matches_jax_kernel(kh, kw, head_dim, n_real):
    """K4: [B, H, N, D] with the rel-pos bias and a key mask."""
    b, h, n = 2, 2, kh * kw
    rs = np.random.RandomState(400 + n + head_dim)
    q, k, v = rs.standard_normal((3, b, h, n, head_dim)).astype(np.float32)
    jh, jw, th, tw = _rel_inputs((b, h, n), kh, kw, 401 + n)
    want = jax_fa.fused_attention_relwin(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jh, jw,
        n_real=n_real, interpret=True)
    got = port_fa.fused_attention_relwin(
        *(torch.from_numpy(a) for a in (q, k, v)), th, tw, n_real)
    assert got.shape == (b, h, n, head_dim)
    np.testing.assert_allclose(_to_np(got), _to_np(want), **REL)


@pytest.mark.parametrize("kh,kw,head_dim", [(8, 8, 64), (4, 6, 80),
                                            (3, 5, 160)])
def test_flash_relpos_plain_version_matches_jax(kh, kw, head_dim):
    """K5 against the JAX off-TPU composition; the LSE against numpy."""
    b, h, n = 1, 2, kh * kw
    rs = np.random.RandomState(500 + n + head_dim)
    q, k, v = rs.standard_normal((3, b, h, n, head_dim)).astype(np.float32)
    jh, jw, th, tw = _rel_inputs((b, h, n), kh, kw, 501 + n)
    want = jax_fl.flash_attention_relpos(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jh, jw,
        force_pallas=True)
    got, lse = port_fl.flash_attention_relpos(
        *(torch.from_numpy(a) for a in (q, k, v)), th, tw, return_lse=True)
    np.testing.assert_allclose(_to_np(got), _to_np(want), **REL)
    s = np.einsum("bhqd,bhkd->bhqk", q, k) * head_dim ** -0.5 + (
        th.numpy()[..., :, None] + tw.numpy()[..., None, :]).reshape(
            b, h, n, n)
    m = s.max(-1)
    np.testing.assert_allclose(
        lse.numpy(), m + np.log(np.exp(s - m[..., None]).sum(-1)), **REL)


def test_rel_kernels_in_bf16_match_jax():
    kh, kw, b, h, d = 4, 4, 2, 2, 64
    n = kh * kw
    rs = np.random.RandomState(600)
    q, k, v = rs.standard_normal((3, b, h, n, d)).astype(np.float32)
    jh, jw, th, tw = _rel_inputs((b, h, n), kh, kw, 601)
    jq, jk, jv = (_pair(a, "bfloat16")[0] for a in (q, k, v))
    tq, tk, tv = (_pair(a, "bfloat16")[1] for a in (q, k, v))
    for want, got in (
            (jax_fa.fused_attention_relwin(jq, jk, jv, jh, jw, interpret=True),
             port_fa.fused_attention_relwin(tq, tk, tv, th, tw)),
            (jax_fl.flash_attention_relpos(jq, jk, jv, jh, jw),
             port_fl.flash_attention_relpos(tq, tk, tv, th, tw))):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_to_np(got), _to_np(want), rtol=0,
                                   atol=TOL["bfloat16"])


def test_rel_kernel_shape_rules():
    q = torch.zeros(1, 2, 12, 64)
    rel_h, rel_w = torch.zeros(1, 2, 12, 3), torch.zeros(1, 2, 12, 4)
    assert port_fl.check_args(q, q, q, rel_h, rel_w) == (1, 2, 12, 64, 3, 4)
    with pytest.raises(ValueError):       # KH * KW != N
        port_fa.check_rel_args(rel_h, rel_h, (1, 2, 12), 12)
    with pytest.raises(TypeError):        # rel terms are fp32
        port_fa.check_rel_args(rel_h.bfloat16(), rel_w, (1, 2, 12), 12)
    with pytest.raises(ValueError):       # last axis contiguous
        port_fa.check_rel_args(torch.zeros(1, 2, 3, 12).transpose(2, 3),
                               rel_w, (1, 2, 12), 12)
    with pytest.raises(ValueError):       # K5 takes D <= 256
        port_fl.check_args(*[torch.zeros(1, 2, 12, 272)] * 3, rel_h, rel_w)


def test_rel_kernels_take_gradients_on_the_cpu_only_through_plain_ops():
    """On the CPU the autograd Functions of K3, K4 and K5 run the plain
    backward versions, equal to autograd through the plain forward versions,
    and count no launch."""
    gen = torch.Generator().manual_seed(0)
    rand = lambda *shape: torch.randn(*shape, generator=gen)
    q, k, v, dout = (rand(1, 2, 6, 8) for _ in range(4))
    rel_h, rel_w = rand(1, 2, 6, 2), rand(1, 2, 6, 3)
    wrappers = (port_fa.fused_attention_relwin_dense,
                port_fa.fused_attention_relwin, port_fl.flash_attention_relpos)
    before = [(w.launches, w.backward_launches) for w in wrappers]
    qkv = torch.cat([t.transpose(1, 2).reshape(1, 6, 16) for t in (q, k, v)],
                    dim=-1)
    dense_do = dout.transpose(1, 2).reshape(1, 6, 16)
    for kernel, plain, inputs, do in (
            (lambda x, rh, rw: port_fa.fused_attention_relwin_dense(
                x, rh, rw, 2),
             lambda x, rh, rw: port_fa.fused_attention_relwin_dense_reference(
                 x, rh, rw, 2),
             (qkv, rel_h.transpose(1, 2), rel_w.transpose(1, 2)), dense_do),
            (lambda *a: port_fa.fused_attention_relwin(*a, 5),
             lambda *a: port_fa.fused_attention_relwin_reference(*a, 5),
             (q, k, v, rel_h, rel_w), dout),
            (port_fl.flash_attention_relpos,
             port_fl.flash_attention_relpos_reference,
             (q, k, v, rel_h, rel_w), dout)):
        grads = []
        for fn in (kernel, plain):
            leaves = [t.clone().requires_grad_() for t in inputs]
            fn(*leaves).backward(do)
            grads.append([t.grad for t in leaves])
        for got, want in zip(*grads):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert [(w.launches, w.backward_launches) for w in wrappers] == before


# the JAX package's rel-pos kernels return fp32 drel; fp32 tolerance as
# the forward's (another summation order)
REL_GRAD = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kh,kw,head_dim", [(3, 4, 64), (4, 4, 128),
                                            (2, 5, 64)])
def test_relwin_dense_backward_matches_jax_kernel_vjp(kh, kw, head_dim):
    """K3: packed dqkv and drel through the JAX kernel's custom VJP, run in
    interpret mode."""
    b, h, n = 2, 2, kh * kw
    rs = np.random.RandomState(700 + n + head_dim)
    x = rs.standard_normal((b, n, 3 * h * head_dim)).astype(np.float32)
    g = rs.standard_normal((b, n, h * head_dim)).astype(np.float32)
    jh, jw, th, tw = _rel_inputs((b, n, h), kh, kw, 701 + n)
    _, vjp = jax.vjp(lambda t, rh, rw: jax_fa.fused_attention_relwin_dense(
        t, rh, rw, h, interpret=True), jnp.asarray(x), jh, jw)
    want = vjp(jnp.asarray(g))
    leaves = [t.clone().requires_grad_() for t in (torch.from_numpy(x), th, tw)]
    port_fa.fused_attention_relwin_dense(*leaves, h).backward(
        torch.from_numpy(g))
    for got, w in zip(leaves, want):
        assert got.grad.shape == got.shape
        np.testing.assert_allclose(_to_np(got.grad), _to_np(w), **REL_GRAD)


@pytest.mark.parametrize("kh,kw,head_dim,n_real", [(3, 4, 8, None),
                                                   (3, 4, 40, 9),
                                                   (4, 5, 80, None)])
def test_relwin_backward_matches_jax_kernel_vjp(kh, kw, head_dim, n_real):
    """K4: dq, dk, dv, drel_h, drel_w through the JAX kernel's custom VJP,
    run in interpret mode, with a key mask."""
    b, h, n = 2, 2, kh * kw
    rs = np.random.RandomState(800 + n + head_dim)
    q, k, v, g = rs.standard_normal((4, b, h, n, head_dim)).astype(np.float32)
    jh, jw, th, tw = _rel_inputs((b, h, n), kh, kw, 801 + n)
    _, vjp = jax.vjp(lambda *a: jax_fa.fused_attention_relwin(
        *a, n_real=n_real, interpret=True),
        *(jnp.asarray(a) for a in (q, k, v)), jh, jw)
    want = vjp(jnp.asarray(g))
    leaves = [t.clone().requires_grad_()
              for t in (*(torch.from_numpy(a) for a in (q, k, v)), th, tw)]
    port_fa.fused_attention_relwin(*leaves, n_real).backward(
        torch.from_numpy(g))
    for got, w in zip(leaves, want):
        np.testing.assert_allclose(_to_np(got.grad), _to_np(w), **REL_GRAD)


@pytest.mark.parametrize("kh,kw,head_dim", [(8, 8, 64), (4, 6, 80),
                                            (3, 5, 160)])
def test_flash_relpos_backward_matches_jax_vjp(kh, kw, head_dim):
    """K5: the plain backward (P from the log-sum-exp, delta from the
    output) against the VJP of the JAX package's off-TPU composition."""
    b, h, n = 1, 2, kh * kw
    rs = np.random.RandomState(900 + n + head_dim)
    q, k, v, g = rs.standard_normal((4, b, h, n, head_dim)).astype(np.float32)
    jh, jw, th, tw = _rel_inputs((b, h, n), kh, kw, 901 + n)
    _, vjp = jax.vjp(lambda *a: jax_fl.flash_attention_relpos(
        *a, force_pallas=True), *(jnp.asarray(a) for a in (q, k, v)), jh, jw)
    want = vjp(jnp.asarray(g))
    got = port_fl.flash_attention_relpos_backward_reference(
        *(torch.from_numpy(a) for a in (q, k, v)), th, tw,
        torch.from_numpy(g))
    for x, w in zip(got, want):
        np.testing.assert_allclose(_to_np(x), _to_np(w), **REL_GRAD)


def test_rel_backwards_in_bf16_match_jax():
    """K4 and K5 backward in bf16: dq, dk, dv within the bf16 tolerance,
    drel within 2e-2 of its scale."""
    kh, kw, b, h, d = 4, 4, 2, 2, 64
    n = kh * kw
    rs = np.random.RandomState(1000)
    q, k, v, g = rs.standard_normal((4, b, h, n, d)).astype(np.float32)
    jh, jw, th, tw = _rel_inputs((b, h, n), kh, kw, 1001)
    jq, jk, jv, jg = (_pair(a, "bfloat16")[0] for a in (q, k, v, g))
    tq, tk, tv, tg = (_pair(a, "bfloat16")[1] for a in (q, k, v, g))
    for jax_fn, port_fn in (
            (lambda *a: jax_fa.fused_attention_relwin(*a, interpret=True),
             port_fa.fused_attention_relwin),
            (jax_fl.flash_attention_relpos, port_fl.flash_attention_relpos)):
        _, vjp = jax.vjp(jax_fn, jq, jk, jv, jh, jw)
        want = vjp(jg)
        leaves = [t.clone().requires_grad_() for t in (tq, tk, tv, th, tw)]
        port_fn(*leaves).backward(tg)
        for got, w in zip(leaves[:3], want[:3]):
            assert got.grad.dtype == torch.bfloat16
            np.testing.assert_allclose(_to_np(got.grad), _to_np(w), rtol=0,
                                       atol=TOL["bfloat16"])
        scale = max(np.abs(_to_np(w)).max() for w in want[3:])
        for got, w in zip(leaves[3:], want[3:]):
            np.testing.assert_allclose(_to_np(got.grad), _to_np(w), rtol=0,
                                       atol=2e-2 * scale)


# ------------------------------------------------------------------- K6


def _jax_flash_forward(q, k, v, bias, sm_scale):
    """The TPU kernel ``_flash_forward`` in interpret mode, padded as the
    JAX ``flash_attention`` wrapper pads: (out [B, H, Nq, D], lse [B, H,
    Nq])."""
    from jax.experimental.pallas import tpu as pltpu
    b, h, nq, d = q.shape
    nk = k.shape[2]
    up = lambda x, m: -(-x // m) * m
    block_q, block_k = min(128, up(nq, 128)), min(128, up(nk, 128))
    pad_d, pad_q, pad_k = up(d, 64) - d, up(nq, block_q) - nq, up(nk, block_k) - nk
    q3 = jnp.pad(q.reshape(b * h, nq, d), ((0, 0), (0, pad_q), (0, pad_d)))
    k3, v3 = (jnp.pad(t.reshape(b * h, nk, d), ((0, 0), (0, pad_k),
                                                 (0, pad_d))) for t in (k, v))
    bias3 = jnp.zeros((b, nk), jnp.float32) if bias is None else bias
    bias3 = jnp.pad(jnp.repeat(bias3, h, axis=0)[:, None],
                    ((0, 0), (0, 0), (0, pad_k)), constant_values=-1e9)
    scale = d ** -0.5 if sm_scale is None else sm_scale
    with pltpu.force_tpu_interpret_mode():
        out, lse = jax_fl._flash_forward(q3, k3, v3, bias3, block_q, block_k,
                                         scale)
    return (out[:, :nq, :d].reshape(b, h, nq, d),
            lse[:, 0, :nq].reshape(b, h, nq))


@pytest.mark.parametrize("b,h,nq,nk,d,sm_scale,kind", [
    (1, 2, 100, 333, 56, None, "slots"),     # d 56 zero-padded, ragged keys
    (2, 1, 130, 200, 64, 0.3, "random"),     # sm_scale override
    (1, 1, 64, 4 * 60 + 16, 256, None, "slots"),
    (1, 2, 77, 77, 64, None, None),
    (1, 1, 40, 128, 256, 0.2, "masked"),     # every key masked: averages V
])
def test_key_bias_flash_plain_version_matches_jax_kernel(b, h, nq, nk, d,
                                                         sm_scale, kind):
    rs = np.random.RandomState(nq + nk + d)
    q = rs.standard_normal((b, h, nq, d)).astype(np.float32)
    k, v = rs.standard_normal((2, b, h, nk, d)).astype(np.float32)
    bias = None
    if kind == "random":
        bias = rs.standard_normal((b, nk)).astype(np.float32)
    elif kind is not None:
        bias = np.full((b, nk), -1e9, np.float32)
        if kind == "slots":     # one valid memory slot and one pointer
            slot = (nk - 16) // 4
            bias[:, slot:2 * slot] = 0.0
            bias[:, -4:] = 0.0
    want, want_lse = _jax_flash_forward(
        *(jnp.asarray(a) for a in (q, k, v)),
        None if bias is None else jnp.asarray(bias), sm_scale)
    got, lse = port_fl.flash_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        None if bias is None else torch.from_numpy(bias), sm_scale,
        return_lse=True)
    assert got.shape == (b, h, nq, d) and lse.shape == (b, h, nq)
    np.testing.assert_allclose(_to_np(got), _to_np(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(_to_np(lse), _to_np(want_lse), rtol=2e-5,
                               atol=2e-5)


def _jax_flash_backward(q, k, v, bias, dout, sm_scale):
    """The TPU kernel ``_flash_backward`` in interpret mode on the forward's
    output and log-sum-exp, padded as the JAX ``flash_attention`` wrapper
    pads (head dim to 64, keys and queries to the block, -1e9 on the padded
    keys, zero dout on the padded rows): (dq, dk, dv), each [B, H, N, D]."""
    from jax.experimental.pallas import tpu as pltpu
    b, h, nq, d = q.shape
    nk = k.shape[2]
    up = lambda x, m: -(-x // m) * m
    block_q, block_k = min(128, up(nq, 128)), min(128, up(nk, 128))
    pad_d, pad_q, pad_k = up(d, 64) - d, up(nq, block_q) - nq, up(nk, block_k) - nk
    q3, g3 = (jnp.pad(t.reshape(b * h, nq, d), ((0, 0), (0, pad_q),
                                                 (0, pad_d))) for t in (q, dout))
    k3, v3 = (jnp.pad(t.reshape(b * h, nk, d), ((0, 0), (0, pad_k),
                                                 (0, pad_d))) for t in (k, v))
    bias3 = jnp.zeros((b, nk), jnp.float32) if bias is None else bias
    bias3 = jnp.pad(jnp.repeat(bias3, h, axis=0)[:, None],
                    ((0, 0), (0, 0), (0, pad_k)), constant_values=-1e9)
    scale = d ** -0.5 if sm_scale is None else sm_scale
    with pltpu.force_tpu_interpret_mode():
        out, lse = jax_fl._flash_forward(q3, k3, v3, bias3, block_q, block_k,
                                         scale)
        grads = jax_fl._flash_backward(q3, k3, v3, bias3, out, lse, g3,
                                       block_q, block_k, scale)
    return tuple(g[:, :n, :d].reshape(b, h, n, d)
                 for g, n in zip(grads, (nq, nk, nk)))


def _interleaved_slot_bias(b, nk):
    """A memory of 64-key slots, valid and empty in turn from slot 0 (whole
    masked 64-key runs between valid ones), and 16 pointer keys of which the
    first 4 are valid: [B, Nk] fp32, 0 or -1e9."""
    bias = np.full((b, nk), -1e9, np.float32)
    for start in range(0, nk - 16, 128):
        bias[:, start:start + 64] = 0.0
    bias[:, nk - 16:nk - 12] = 0.0
    return bias


@pytest.mark.parametrize("b,h,nq,nk,d,sm_scale,kind,dtype", [
    (1, 2, 100, 333, 56, None, "slots", "float32"),   # d 56, ragged keys
    (2, 1, 130, 200, 64, 0.3, "random", "float32"),   # Nq > block, sm_scale
    (1, 1, 64, 4 * 60 + 16, 256, None, "slots", "float32"),
    (1, 2, 77, 77, 64, 56 ** -0.5, None, "float32"),  # Hiera's scale
    (1, 2, 60, 150, 64, None, "slots", "bfloat16"),
    (1, 1, 40, 128, 64, None, "masked", "float32"),   # every key masked
    (1, 1, 50, 5 * 64 + 16, 256, None, "interleaved", "float32"),
])
def test_key_bias_flash_plain_backward_matches_jax_kernel(b, h, nq, nk, d,
                                                          sm_scale, kind,
                                                          dtype):
    """K6's plain backward against the TPU kernel ``_flash_backward`` run in
    interpret mode: Nq != Nk, masked keys (whose dk and dv are exactly 0),
    an explicit sm_scale, d = 56, a bias with every key masked (each row
    averages V; Nk a whole key block, so the wrapper pads no key) and empty
    64-key slots between valid ones. fp32 rtol and atol 2e-5; bf16, scaled
    to each gradient: rtol 2^-7 (one bf16 ulp) and atol 2^-5 of its RMS
    (the TPU kernel rounds dS0 and takes delta from the bf16 output, the
    plain version keeps both at fp32 precision; rounding P and the
    gradients)."""
    rs = np.random.RandomState(3 * nq + nk + d)
    q, g = rs.standard_normal((2, b, h, nq, d)).astype(np.float32)
    k, v = rs.standard_normal((2, b, h, nk, d)).astype(np.float32)
    bias = None
    if kind == "random":
        bias = rs.standard_normal((b, nk)).astype(np.float32)
    elif kind == "slots":     # one valid memory slot and one pointer
        bias = np.full((b, nk), -1e9, np.float32)
        slot = (nk - 16) // 4
        bias[:, slot:2 * slot] = 0.0
        bias[:, -4:] = 0.0
    elif kind == "masked":
        bias = np.full((b, nk), -1e9, np.float32)
    elif kind == "interleaved":
        bias = _interleaved_slot_bias(b, nk)
    (jq, tq), (jk, tk), (jv, tv), (jg, tg) = (_pair(a, dtype)
                                              for a in (q, k, v, g))
    want = _jax_flash_backward(
        jq, jk, jv, None if bias is None else jnp.asarray(bias), jg, sm_scale)
    tb = None if bias is None else torch.from_numpy(bias)
    got = port_fl.flash_attention_backward_reference(tq, tk, tv, tb, tg,
                                                     sm_scale=sm_scale)
    for name, x, w in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == TORCH_DTYPE[dtype] and x.shape == w.shape
        w = _to_np(w).astype(np.float64)
        tol = (dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else
               dict(rtol=2 ** -7, atol=2 ** -5 * np.sqrt((w ** 2).mean())))
        np.testing.assert_allclose(_to_np(x), w, err_msg=name, **tol)
    if kind in ("slots", "interleaved"):
        masked = torch.from_numpy(bias[0] < -1e8)
        for x in got[1:]:
            assert not x[:, :, masked].any()
            assert x[:, :, ~masked].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_key_bias_flash_plain_backward_ignores_masked_keys_bit_for_bit(dtype):
    """The premise of the bf16 backward's skipped tiles: with the masked
    keys' k and v replaced by other finite values, dq and the valid keys'
    dk and dv are the same bit for bit (a masked key's P is exactly 0, so
    it adds exact zeros), and the masked keys' dk and dv stay exactly 0."""
    rs = np.random.RandomState(47)
    b, h, nq, nk, d = 2, 2, 70, 5 * 64 + 16, 64
    q, g = rs.standard_normal((2, b, h, nq, d)).astype(np.float32)
    k, v, k2, v2 = 3 * rs.standard_normal((4, b, h, nk, d)).astype(np.float32)
    bias = _interleaved_slot_bias(b, nk)
    masked = bias[0] < -1e8
    k2[:, :, ~masked], v2[:, :, ~masked] = k[:, :, ~masked], v[:, :, ~masked]
    tq, tg, tk, tv, tk2, tv2 = (torch.from_numpy(a).to(TORCH_DTYPE[dtype])
                                for a in (q, g, k, v, k2, v2))
    tb = torch.from_numpy(bias)
    got = port_fl.flash_attention_backward_reference(tq, tk, tv, tb, tg)
    other = port_fl.flash_attention_backward_reference(tq, tk2, tv2, tb, tg)
    valid = torch.from_numpy(~masked)
    assert not torch.equal(tk, tk2) and not torch.equal(tv, tv2)
    assert torch.equal(got[0], other[0])
    for x, y in zip(got[1:], other[1:]):
        assert torch.equal(x[:, :, valid], y[:, :, valid])
        assert not x[:, :, ~valid].any() and not y[:, :, ~valid].any()
        assert x[:, :, valid].any()


def test_key_bias_flash_plain_backward_is_the_vjp_of_the_plain_forward():
    """In fp32 the plain backward equals autograd through the plain forward,
    the CPU path of ``flash_attention`` (atol 1e-5: sums in another
    order)."""
    rs = np.random.RandomState(31)
    q = torch.from_numpy(rs.standard_normal((2, 2, 33, 24)).astype(
        np.float32)).requires_grad_()
    k, v = (torch.from_numpy(rs.standard_normal((2, 2, 50, 24)).astype(
        np.float32)).requires_grad_() for _ in range(2))
    bias = torch.from_numpy(np.where(rs.rand(2, 50) < 0.3, -1e9, 0.0).astype(
        np.float32))
    g = torch.from_numpy(rs.standard_normal((2, 2, 33, 24)).astype(np.float32))
    out = port_fl.flash_attention(q, k, v, bias, sm_scale=0.4)
    out.backward(g)
    got = port_fl.flash_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), bias, g, 0.4)
    for x, leaf in zip(got, (q, k, v)):
        torch.testing.assert_close(x, leaf.grad, rtol=1e-5, atol=1e-5)


def test_key_bias_flash_plain_backward_takes_delta_at_fp32():
    """bf16 inputs whose keys and values share a mean (as projections of
    LayerNorm'd tokens with a bias do): the plain backward, with delta =
    rowsum(P * dP) in fp32 (what K6's first backward kernel computes), stays
    within the rounding of the rest of the backward of the float64
    gradients, where delta from the output rounded to bf16 (the TPU
    kernel's choice) turns into a coherent error of dq many times larger."""
    rs = np.random.RandomState(41)
    n, d = 512, 128
    mean_k, mean_v = 3 * rs.standard_normal((2, d))
    q = 0.25 * rs.standard_normal((1, 1, n, d))
    k = 0.25 * rs.standard_normal((1, 1, n, d)) + mean_k
    v = rs.standard_normal((1, 1, n, d)) + mean_v
    g = rs.standard_normal((1, 1, n, d))
    tq, tk, tv, tg = (torch.from_numpy(a).to(torch.bfloat16)
                      for a in (q, k, v, g))
    q64, k64, v64 = (t.double().requires_grad_() for t in (tq, tk, tv))
    out = torch.softmax(q64 @ k64.transpose(-1, -2) * d ** -0.5, -1) @ v64
    out.backward(tg.double())
    dq = port_fl.flash_attention_backward_reference(tq, tk, tv, None, tg)[0]
    rel = lambda x, w: ((x.double() - w).norm() / w.norm()).item()
    err = rel(dq, q64.grad)
    assert err < 0.05, err
    # the control: delta from the bf16-rounded output
    s_ = (tq.float() @ tk.float().transpose(-1, -2)) * d ** -0.5
    p = torch.softmax(s_, -1)
    out_bf16 = (p.to(torch.bfloat16).float() @ tv.float()).to(torch.bfloat16)
    dp = tg.float() @ tv.float().transpose(-1, -2)
    delta = (tg.float() * out_bf16.float()).sum(-1, keepdim=True)
    rounded = (p * (dp - delta)) @ tk.float() * d ** -0.5
    assert rel(rounded, q64.grad) > 10 * err


@pytest.mark.parametrize("b,h,nq,nk,d,want", [
    (1, 1, 4096, 7 * 4096 + 64, 256, (2, 1)),   # SAM2's memory cross-attention
    (1, 1, 4096, 4096, 256, (2, 2)),            # its self-attention
    (4, 8, 4096, 4096, 64, (1, 1)),             # Hiera's global blocks
    (4, 8, 4096, 4096, 56, (1, 1)),
    (1, 1, 100, 70, 128, (2, 2)),               # capped by the tiles walked
    (1, 2, 300, 300, 56, (5, 5)),
])
def test_key_bias_backward_splits(b, h, nq, nk, d, want):
    """The bf16 backward's split rule on an H100's 132 SMs: the SMs over
    the blocks of all heads (64 rows a block, 128 at head dims up to 64),
    rounded down, at least 1, at most the 64-row tiles walked."""
    assert port_fl.key_bias_backward_splits(b, h, nq, nk, d, 132) == want
    assert port_fl.padded_head_dim(d) == (64 if d <= 64 else
                                          128 if d <= 128 else 256)


def test_tma_operand_reads_aligned_views_in_place_and_copies_the_rest():
    """Views that TMA can read (16-byte aligned base, strides multiples of 8
    elements on axes longer than 1) pass through; others become a copy with
    the head dim padded to a multiple of 8 and zeros past D."""
    qkv = torch.randn(2, 5, 3 * 4 * 56, dtype=torch.bfloat16)
    q = qkv.view(2, 5, 3, 4, 56).permute(2, 0, 3, 1, 4)[0]   # Hiera's views
    assert port_fl.tma_operand(q) is q
    flat = torch.randn(1 + 2 * 3 * 7 * 20, dtype=torch.bfloat16)
    odd = flat[1:].view(2, 3, 7, 20)                          # base off 16 B
    got = port_fl.tma_operand(odd)
    assert got.shape == (2, 3, 7, 24) and got.is_contiguous()
    assert torch.equal(got[..., :20], odd) and not got[..., 20:].any()
    narrow = torch.randn(1, 2, 9, 50, dtype=torch.bfloat16)   # row stride 50
    assert port_fl.tma_operand(narrow).shape[-1] == 56
    one_head = torch.randn(1, 1, 33, 40, dtype=torch.bfloat16)
    assert port_fl.tma_operand(one_head) is one_head


def test_key_bias_flash_takes_the_plain_version_on_the_cpu_only():
    rs = np.random.RandomState(21)
    q, k, v = (torch.from_numpy(rs.standard_normal((1, 2, 9, 16)).astype(
        np.float32)) for _ in range(3))
    bias = torch.zeros(1, 9)
    before = port_fl.flash_attention.launches
    out = port_fl.flash_attention(q.requires_grad_(), k, v, bias)
    out.sum().backward()                 # plain ops: autograd on the CPU
    assert port_fl.flash_attention.launches == before
    assert torch.isfinite(q.grad).all()
    with pytest.raises(ValueError):      # the autograd Function takes CUDA
        port_fl.FlashAttention.apply(q, k, v, bias, None)
    with pytest.raises(ValueError):
        port_fl.check_key_bias_args(q, k, v, torch.zeros(1, 8))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_sm_scale_matches_jax_kernel(dtype):
    """K1 with Hiera's scale on heads padded from 56 to 64, forward and
    backward, against the TPU kernel in interpret mode."""
    b, n, h, d = 2, 20, 2, 64
    scale = 56 ** -0.5
    rs = np.random.RandomState(56)
    x = rs.standard_normal((b, n, 3 * h * d)).astype(np.float32)
    g = rs.standard_normal((b, n, h * d)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jg, tg = _pair(g, dtype)
    out, vjp = jax.vjp(lambda t: jax_fa.fused_attention_dense(
        t, h, interpret=True, sm_scale=scale), jx)
    (want_grad,) = vjp(jg)
    leaf = tx.clone().requires_grad_()
    got = port_fa.fused_attention_dense(leaf, h, sm_scale=scale)
    got.backward(tg)
    np.testing.assert_allclose(_to_np(got), _to_np(out), rtol=0,
                               atol=TOL[dtype])
    np.testing.assert_allclose(_to_np(leaf.grad), _to_np(want_grad), rtol=0,
                               atol=TOL[dtype])
    if dtype == "float32":    # the default scale would be told apart
        default = port_fa.fused_attention_dense(tx, h)
        assert np.abs(_to_np(default) - _to_np(got)).max() > 10 * TOL[dtype]
