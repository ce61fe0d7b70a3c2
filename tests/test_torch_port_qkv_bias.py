"""K9 (attention over a packed [B, N, 3, H, D] qkv) and K2b (K2 with a full
score bias and its gradient) against the JAX package.

On the CPU the wrappers ``fused_attention_qkv`` and ``fused_attention(...,
bias=)`` take their plain PyTorch versions; these tests hold them against
the JAX entry points run through their Pallas kernels in interpret mode
(``fused_attention_qkv(..., interpret=True)``, ``fused_attention(...,
bias=, interpret=True)``), forward and VJP with a seeded cotangent, on the
same numpy inputs. The CUDA kernels are held against the plain versions on
the card by ``tests/test_torch_port_cuda.py`` and ``chip_smoke.py``.

Tolerances: fp32 atol 1e-5 for the output; the gradients 3e-5 (K9) and
5e-5 (K2b, dbias included), as the JAX package's own tests hold these
kernels; bf16 atol 2e-2 (a few bf16 ulps at |x| <= 2, from rounding P, dS
and the outputs) for the output and dq, dk, dv, and 2e-2 of its largest
value for dbias (JAX rounds each dS0 to the bias dtype before the
broadcast's sum, the port sums in fp32 and rounds once).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
    fused_attention as port_fa)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

# the JAX package's ops.pallas re-exports a function of the module's name
jax_fa = importlib.import_module(
    "simpleaicv_pytorch_training_examples_tpu.ops.pallas.fused_attention")

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
OUT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _pair(x, dtype):
    """numpy fp32 -> (jax array, torch tensor), both rounded to dtype."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(TORCH_DTYPE[dtype]))


def _to_np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------------- K9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h,d,n_real", [
    (2, 37, 4, 32, None), (2, 37, 4, 32, 30), (1, 16, 6, 16, None),
    (2, 33, 2, 80, None), (2, 33, 2, 80, 30),
    (1, 197, 2, 64, None)])     # ViT-B/16's tokens and head dim
def test_qkv_plain_version_and_vjp_match_jax_kernel(b, n, h, d, n_real,
                                                    dtype):
    rs = np.random.RandomState(n * d + (n_real or 0))
    x = rs.standard_normal((b, n, 3, h, d)).astype(np.float32)
    g = rs.standard_normal((b, n, h, d)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jg, tg = _pair(g, dtype)
    want, vjp = jax.vjp(lambda t: jax_fa.fused_attention_qkv(
        t, n_real=n_real, interpret=True), jx)
    (want_grad,) = vjp(jg)
    tx.requires_grad_()
    got = port_fa.fused_attention_qkv(tx, n_real)
    got.backward(tg)
    assert got.shape == (b, n, h, d) and got.dtype == tx.dtype
    assert tx.grad.shape == tx.shape and tx.grad.dtype == tx.dtype
    grad_tol = 3e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_to_np(got), _to_np(want), rtol=0,
                               atol=OUT_TOL[dtype])
    np.testing.assert_allclose(_to_np(tx.grad), _to_np(want_grad), rtol=0,
                               atol=grad_tol)


def test_qkv_equals_k1_on_the_same_packed_tensor():
    """K9 at d = 64 is K1's math on the same memory: its output and packed
    gradient, reshaped, equal K1's bit for bit."""
    rs = np.random.RandomState(11)
    b, n, h, d = 2, 19, 3, 64
    x = torch.from_numpy(rs.standard_normal((b, n, 3 * h * d)).astype(
        np.float32))
    g = torch.from_numpy(rs.standard_normal((b, n, h * d)).astype(np.float32))
    dense = x.clone().requires_grad_()
    out_dense = port_fa.fused_attention_dense(dense, h, 15)
    out_dense.backward(g)
    packed = x.view(b, n, 3, h, d).clone().requires_grad_()
    out_packed = port_fa.fused_attention_qkv(packed, 15)
    out_packed.backward(g.view(b, n, h, d))
    assert torch.equal(out_packed.reshape(b, n, h * d), out_dense)
    assert torch.equal(packed.grad.reshape(b, n, 3 * h * d), dense.grad)


# ------------------------------------------------------------------ K2b


def _bias_inputs(b, h, n, d, bias_shape, seed, spread=0.3):
    rs = np.random.RandomState(seed)
    qkv = rs.standard_normal((3, b, h, n, d)).astype(np.float32)
    bias = (spread * rs.standard_normal(bias_shape)).astype(np.float32)
    g = rs.standard_normal((b, h, n, d)).astype(np.float32)
    return qkv, bias, g


@pytest.mark.parametrize("dtype,bias_dtype", [
    ("float32", "float32"), ("bfloat16", "float32"),
    ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("bias_kind,n_real", [
    ("full", None), ("full", 13), ("heads", None), ("shared", 17)])
def test_bias_plain_version_and_vjp_match_jax_kernel(bias_kind, n_real,
                                                     dtype, bias_dtype):
    b, h, n, d = 2, 3, 20, 16
    bias_shape = {"full": (b, h, n, n), "heads": (1, h, n, n),
                  "shared": (h, n, n)}[bias_kind]
    qkv, bias, g = _bias_inputs(b, h, n, d, bias_shape,
                                len(bias_shape) + (n_real or 0))
    jq, jk, jv, jg = (_pair(a, dtype)[0] for a in (*qkv, g))
    tq, tk, tv, tg = (_pair(a, dtype)[1].requires_grad_()
                      for a in (*qkv, g))
    jb, tb = _pair(bias, bias_dtype)
    tb.requires_grad_()
    want, vjp = jax.vjp(lambda q, k, v, bb: jax_fa.fused_attention(
        q, k, v, n_real=n_real, bias=bb, interpret=True), jq, jk, jv, jb)
    want_grads = vjp(jg)
    got = port_fa.fused_attention(tq, tk, tv, n_real, bias=tb)
    got.backward(tg)
    assert got.dtype == tq.dtype
    assert tb.grad.shape == tb.shape and tb.grad.dtype == tb.dtype
    np.testing.assert_allclose(_to_np(got), _to_np(want), rtol=0,
                               atol=OUT_TOL[dtype])
    grad_tol = 5e-5 if dtype == "float32" else 2e-2
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want_grads):
        assert t.grad.dtype == t.dtype
        np.testing.assert_allclose(_to_np(t.grad), _to_np(w), rtol=0,
                                   atol=grad_tol, err_msg=name)
    want_dbias = _to_np(want_grads[3])
    dbias_tol = grad_tol if dtype == bias_dtype == "float32" else (
        2e-2 * np.abs(want_dbias).max())
    np.testing.assert_allclose(_to_np(tb.grad), want_dbias, rtol=0,
                               atol=dbias_tol, err_msg="dbias")


def test_bias_gradient_sums_over_the_broadcast_axes():
    """dbias of a bias broadcast over the batch is the sum of the full
    bias's gradient over the batch; masked keys get a zero dbias column."""
    qkv, bias, g = _bias_inputs(3, 2, 9, 8, (2, 9, 9), seed=5, spread=1.0)
    q, k, v, dout = (torch.from_numpy(a) for a in (*qkv, g))
    shared = torch.from_numpy(bias).requires_grad_()
    full = shared.detach().expand(3, 2, 9, 9).clone().requires_grad_()
    port_fa.fused_attention(q, k, v, 6, bias=shared).backward(dout)
    port_fa.fused_attention(q, k, v, 6, bias=full).backward(dout)
    torch.testing.assert_close(shared.grad, full.grad.sum(0), rtol=0,
                               atol=1e-6)
    assert torch.count_nonzero(full.grad[..., 6:]) == 0
    assert torch.count_nonzero(full.grad[..., :6]) > 0


def test_bias_none_keeps_k2_route(monkeypatch):
    """bias=None goes through K2's autograd Function, as before; a bias goes
    through K2b's."""
    calls = []
    for cls in (port_fa.FusedAttention, port_fa.FusedAttentionBias):
        original = cls.apply
        monkeypatch.setattr(cls, "apply", staticmethod(
            lambda *a, _cls=cls, _apply=original: (calls.append(_cls),
                                                   _apply(*a))[1]))
    rs = np.random.RandomState(2)
    q, k, v = torch.from_numpy(rs.standard_normal((3, 1, 2, 7, 16)).astype(
        np.float32)).unbind(0)
    out = port_fa.fused_attention(q, k, v, 5)
    assert calls == [port_fa.FusedAttention]
    assert torch.equal(out, port_fa.fused_attention_reference(q, k, v, 5))
    port_fa.fused_attention(q, k, v, 5, bias=torch.zeros(7, 7))
    assert calls == [port_fa.FusedAttention, port_fa.FusedAttentionBias]


def test_cpu_tensors_take_the_plain_versions_without_counting():
    rs = np.random.RandomState(3)
    draw = lambda *shape: torch.from_numpy(
        rs.standard_normal(shape).astype(np.float32))
    qkv, dout = draw(1, 9, 3, 2, 80), draw(1, 9, 2, 80)
    q, k, v, g = draw(4, 1, 2, 9, 24).unbind(0)
    bias = draw(2, 9, 9)
    wrappers = (port_fa.fused_attention_qkv, port_fa.fused_attention_bias,
                port_fa.fused_attention)
    before = [(w.launches, w.backward_launches) for w in wrappers]

    leaf = qkv.clone().requires_grad_()
    out = port_fa.fused_attention_qkv(leaf)
    out.backward(dout)
    assert torch.equal(out, port_fa.fused_attention_qkv_reference(qkv))
    assert torch.equal(
        leaf.grad, port_fa.fused_attention_qkv_backward_reference(qkv, dout))

    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    out = port_fa.fused_attention(*leaves[:3], 7, bias=leaves[3])
    out.backward(g)
    assert torch.equal(out, port_fa.fused_attention_bias_reference(
        q, k, v, bias, 7))
    wants = port_fa.fused_attention_bias_backward_reference(q, k, v, bias, g,
                                                            7)
    for leaf, want in zip(leaves, wants):
        assert torch.equal(leaf.grad, want)
    assert [(w.launches, w.backward_launches) for w in wrappers] == before


def test_bias_with_the_rel_pos_terms_equals_the_relwin_kernels():
    """K2b with bias = rel_bias(rel_h, rel_w) is K4's plain version, and its
    dbias summed by key-grid row and column is K4's drel_h and drel_w."""
    kh, kw, b, h, d = 3, 4, 2, 2, 16
    n = kh * kw
    rs = np.random.RandomState(9)
    q, k, v, g = torch.from_numpy(rs.standard_normal((4, b, h, n, d)).astype(
        np.float32)).unbind(0)
    rel_h = torch.from_numpy(rs.standard_normal((b, h, n, kh)).astype(
        np.float32))
    rel_w = torch.from_numpy(rs.standard_normal((b, h, n, kw)).astype(
        np.float32))
    bias = port_fa.rel_bias(rel_h, rel_w).requires_grad_()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = port_fa.fused_attention(*leaves, 10, bias=bias)
    torch.testing.assert_close(out, port_fa.fused_attention_relwin_reference(
        q, k, v, rel_h, rel_w, 10), rtol=0, atol=1e-6)
    out.backward(g)
    dq, dk, dv, drel_h, drel_w = (
        port_fa.fused_attention_relwin_backward_reference(
            q, k, v, rel_h, rel_w, g, 10))
    for leaf, want in zip(leaves, (dq, dk, dv)):
        torch.testing.assert_close(leaf.grad, want, rtol=0, atol=1e-6)
    grid = bias.grad.unflatten(-1, (kh, kw))
    torch.testing.assert_close(grid.sum(-1), drel_h, rtol=0, atol=1e-6)
    torch.testing.assert_close(grid.sum(-2), drel_w, rtol=0, atol=1e-6)


def test_qkv_shape_rule():
    x = torch.zeros(2, 9, 3, 2, 80)
    assert port_fa.check_qkv_args(x) == (2, 9, 2, 80, 9)
    assert port_fa.check_qkv_args(x, 4) == (2, 9, 2, 80, 4)
    with pytest.raises(TypeError):          # fp16
        port_fa.check_qkv_args(x.half())
    for bad in (torch.zeros(2, 9, 480),            # not [B, N, 3, H, D]
                torch.zeros(2, 9, 2, 2, 80),       # not 3 on axis 2
                x.transpose(0, 1),                 # not contiguous
                torch.zeros(1, 9, 3, 1, 144),      # D past 128
                torch.zeros(1, 1025, 3, 1, 64)):   # N past 1024
        with pytest.raises(ValueError):
            port_fa.check_qkv_args(bad)
    for n_real in (0, 10):
        with pytest.raises(ValueError):
            port_fa.check_qkv_args(x, n_real)


def test_bias_rule():
    shape = (2, 3, 5, 5)
    full = port_fa.check_bias_args(torch.zeros(3, 5, 5), shape)
    assert full.shape == shape and full.stride() == (0, 25, 5, 1)
    row = port_fa.check_bias_args(torch.zeros(2, 1, 1, 5), shape)
    assert row.stride() == (5, 0, 0, 1)
    assert port_fa.check_bias_args(torch.zeros(shape).bfloat16(),
                                   shape).dtype == torch.bfloat16
    with pytest.raises(TypeError):
        port_fa.check_bias_args(torch.zeros(shape).half(), shape)
    for bad in (torch.zeros(4, 3, 5, 5),            # does not broadcast
                torch.zeros(2, 3, 5, 1),            # the key axis broadcast
                torch.zeros(2, 3, 5, 5).transpose(2, 3),   # key axis strided
                torch.zeros(1, 2, 3, 5, 5)):        # more than four axes
        with pytest.raises(ValueError):
            port_fa.check_bias_args(bad, shape)
