"""K2b (a full score bias) and K3/K4 (SAM's decomposed rel-pos bias) at the
row lengths where the bf16 kernels (``csrc/short_attention_fwd.cu``,
``csrc/short_attention_bwd.cu``) change their plan, against the JAX
package, forward and backward.

The kernels hold a whole score row in their accumulators up to 264 keys
(the last 8 keys of 193..200 and 257..264 in an 8-wide chunk) and walk
groups of 256 keys past that; they split D = 80 into column boxes of 64
and 16; they stage a bf16 bias whose rows are not a multiple of 16 bytes
in 8-byte copies, and the backward writes a bf16 bias's gradient in bf16.
On the CPU the wrappers take their plain PyTorch versions; these tests hold
them against the JAX entry points run through their Pallas kernels in
interpret mode at those shapes (the JAX package's own tests and the port's
other CPU tests stop at N <= 20), the backward against the JAX kernels'
VJP with a seeded cotangent, so that the chain JAX -> plain version ->
kernel (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``) is closed
where the kernels split. One batch and one or two heads each (K3: two, its
TPU kernel's head pair), to keep interpret mode quick. A last test holds
the wrappers' host rules of the backward (which entry point, dbias's
buffer) without a GPU.

Tolerances: fp32 rtol 1e-5, atol 2e-5 for the outputs (the port's rel-pos
tests' fp32 tolerance: softmax over 196-265 keys summed in another order),
atol 5e-5 for every gradient (as the JAX package's own tests hold its
kernels' VJPs, dq and dk summing 196-265 fp32 products more); bf16 atol
2e-2 (a few bf16 ulps at |x| <= 2, from rounding P, dS and the outputs),
and 2e-2 of its largest value for a bf16 dbias (JAX rounds dS0 to the
bias dtype inside the kernel, the port once at the end).
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
    fused_attention as port_fa)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

jax_fa = importlib.import_module(
    "simpleaicv_pytorch_training_examples_tpu.ops.pallas.fused_attention")

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": dict(rtol=1e-5, atol=2e-5),
       "bfloat16": dict(rtol=0, atol=2e-2)}
GRAD_TOL = {"float32": dict(rtol=0, atol=5e-5),
            "bfloat16": dict(rtol=0, atol=2e-2)}


def _pair(x, dtype):
    """numpy fp32 -> (jax array, torch tensor), both rounded to dtype."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(TORCH_DTYPE[dtype]))


def _to_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("n,d,n_real,dtype,bias_dtype", [
    (196, 16, None, "float32", "float32"),     # one pass, 4-row tail tile
    (196, 80, 150, "float32", "float32"),      # D = 64 + 16 columns
    (256, 64, None, "float32", "float32"),     # the longest one-pass row
    (257, 64, 200, "float32", "float32"),      # two groups, the second masked
    (196, 64, None, "bfloat16", "bfloat16"),   # 392-byte bias rows
])
def test_bias_plain_version_matches_jax_kernel_where_the_kernel_splits(
        n, d, n_real, dtype, bias_dtype):
    rs = np.random.RandomState(n + d)
    q, k, v = rs.standard_normal((3, 1, 1, n, d)).astype(np.float32)
    bias = (3.0 * rs.standard_normal((1, 1, n, n))).astype(np.float32)
    jq, jk, jv = (_pair(a, dtype)[0] for a in (q, k, v))
    tq, tk, tv = (_pair(a, dtype)[1] for a in (q, k, v))
    jb, tb = _pair(bias, bias_dtype)
    want = jax_fa.fused_attention(jq, jk, jv, n_real=n_real, bias=jb,
                                  interpret=True)
    before = port_fa.fused_attention_bias.launches
    got = port_fa.fused_attention(tq, tk, tv, n_real, bias=tb)
    assert port_fa.fused_attention_bias.launches == before
    assert got.shape == (1, 1, n, d) and got.dtype == tq.dtype
    np.testing.assert_allclose(_to_np(got), _to_np(want), **TOL[dtype])


@pytest.mark.parametrize("d,n_real", [(16, None), (80, 150)])
def test_relwin_plain_version_matches_jax_kernel_at_sam_windows(d, n_real):
    """K4 at SAM's 14 x 14 windows, where a row of 196 keys is one pass."""
    kh = kw = 14
    n = kh * kw
    rs = np.random.RandomState(700 + d)
    q, k, v = rs.standard_normal((3, 1, 1, n, d)).astype(np.float32)
    rel_h = rs.standard_normal((1, 1, n, kh)).astype(np.float32)
    rel_w = rs.standard_normal((1, 1, n, kw)).astype(np.float32)
    want = jax_fa.fused_attention_relwin(
        *(jnp.asarray(a) for a in (q, k, v, rel_h, rel_w)), n_real=n_real,
        interpret=True)
    got = port_fa.fused_attention_relwin(
        *(torch.from_numpy(a) for a in (q, k, v, rel_h, rel_w)), n_real)
    assert got.shape == (1, 1, n, d)
    np.testing.assert_allclose(_to_np(got), _to_np(want), **TOL["float32"])


def test_relwin_dense_plain_version_matches_jax_kernel_at_sam_windows():
    """K3 over the packed qkv at SAM-B's 14 x 14 windows and head dim; two
    heads, since the TPU kernel attends to heads in pairs (one head reads a
    pair's second half past the qkv)."""
    kh = kw = 14
    n, h, d = kh * kw, 2, 64
    rs = np.random.RandomState(710)
    x = rs.standard_normal((1, n, 3 * h * d)).astype(np.float32)
    rel_h = rs.standard_normal((1, n, h, kh)).astype(np.float32)
    rel_w = rs.standard_normal((1, n, h, kw)).astype(np.float32)
    want = jax_fa.fused_attention_relwin_dense(
        *(jnp.asarray(a) for a in (x, rel_h, rel_w)), h, interpret=True)
    got = port_fa.fused_attention_relwin_dense(
        *(torch.from_numpy(a) for a in (x, rel_h, rel_w)), h)
    assert got.shape == (1, n, h * d)
    np.testing.assert_allclose(_to_np(got), _to_np(want), **TOL["float32"])


def _bias_shape(kind, h, n):
    return {"full": (1, h, n, n), "heads": (h, n, n), "keys": (1, 1, n)}[kind]


@pytest.mark.parametrize("n,d,n_real,dtype,kind,bias_dtype", [
    (196, 16, None, "float32", "full", "float32"),   # an 8-key last chunk
    (196, 80, 150, "float32", "heads", "float32"),   # D = 64 + 16, broadcast
    (257, 64, 200, "float32", "full", "float32"),    # 256 keys and an 8-key chunk
    (265, 64, None, "float32", "keys", "float32"),   # groups of 256 keys
    (196, 64, None, "bfloat16", "full", "bfloat16"),  # 392-byte bf16 rows
])
def test_bias_backward_plain_version_matches_jax_vjp_where_the_kernel_splits(
        n, d, n_real, dtype, kind, bias_dtype):
    h = 2
    rs = np.random.RandomState(3 * n + d)
    q, k, v, g = rs.standard_normal((4, 1, h, n, d)).astype(np.float32)
    bias = (3.0 * rs.standard_normal(_bias_shape(kind, h, n))).astype(
        np.float32)
    jq, jk, jv, jg = (_pair(a, dtype)[0] for a in (q, k, v, g))
    leaves = [_pair(a, dtype)[1].requires_grad_() for a in (q, k, v)]
    jb, tb = _pair(bias, bias_dtype)
    tb.requires_grad_()
    _, vjp = jax.vjp(lambda *a: jax_fa.fused_attention(
        *a[:3], n_real=n_real, bias=a[3], interpret=True), jq, jk, jv, jb)
    want = vjp(jg)
    port_fa.fused_attention(*leaves, n_real, bias=tb).backward(
        _pair(g, dtype)[1])
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want):
        assert t.grad.shape == t.shape and t.grad.dtype == t.dtype
        np.testing.assert_allclose(_to_np(t.grad), _to_np(w), err_msg=name,
                                   **GRAD_TOL[dtype])
    assert tb.grad.shape == tb.shape and tb.grad.dtype == tb.dtype
    want_dbias = _to_np(want[3])
    tol = (GRAD_TOL["float32"] if dtype == bias_dtype == "float32" else
           dict(rtol=0, atol=2e-2 * np.abs(want_dbias).max()))
    np.testing.assert_allclose(_to_np(tb.grad), want_dbias, err_msg="dbias",
                               **tol)
    if n_real is not None:   # masked keys get no gradient
        assert not _to_np(leaves[1].grad)[..., n_real:, :].any()
        assert not _to_np(tb.grad)[..., n_real:].any()


@pytest.mark.parametrize("kh,kw,d,n_real,dtype", [
    (14, 14, 16, None, "float32"),    # SAM's windows: 196 keys, one pass
    (14, 14, 80, 150, "float32"),     # D = 64 + 16, masked keys
    (1, 257, 64, 200, "float32"),     # 257 keys: an 8-key chunk, rel_w > 64
    (5, 53, 64, None, "float32"),     # 265 keys: groups of 256
    (14, 14, 64, None, "bfloat16"),
])
def test_relwin_backward_plain_version_matches_jax_vjp_where_the_kernel_splits(
        kh, kw, d, n_real, dtype):
    """K4: dq, dk, dv, drel_h, drel_w through the JAX kernel's VJP."""
    h, n = 2, kh * kw
    rs = np.random.RandomState(7 * n + d)
    q, k, v, g = rs.standard_normal((4, 1, h, n, d)).astype(np.float32)
    rel_h = rs.standard_normal((1, h, n, kh)).astype(np.float32)
    rel_w = rs.standard_normal((1, h, n, kw)).astype(np.float32)
    jq, jk, jv, jg = (_pair(a, dtype)[0] for a in (q, k, v, g))
    _, vjp = jax.vjp(lambda *a: jax_fa.fused_attention_relwin(
        *a, n_real=n_real, interpret=True), jq, jk, jv, jnp.asarray(rel_h),
        jnp.asarray(rel_w))
    want = vjp(jg)
    leaves = [*(_pair(a, dtype)[1] for a in (q, k, v)),
              torch.from_numpy(rel_h), torch.from_numpy(rel_w)]
    leaves = [t.requires_grad_() for t in leaves]
    port_fa.fused_attention_relwin(*leaves, n_real).backward(
        _pair(g, dtype)[1])
    for name, t, w in zip(("dq", "dk", "dv"), leaves, want):
        np.testing.assert_allclose(_to_np(t.grad), _to_np(w), err_msg=name,
                                   **GRAD_TOL[dtype])
    scale = max(np.abs(_to_np(w)).max() for w in want[3:])
    drel_tol = (GRAD_TOL["float32"] if dtype == "float32" else
                dict(rtol=0, atol=2e-2 * scale))
    for name, t, w in zip(("drel_h", "drel_w"), leaves[3:], want[3:]):
        assert t.grad.dtype == torch.float32
        np.testing.assert_allclose(_to_np(t.grad), _to_np(w), err_msg=name,
                                   **drel_tol)


def test_relwin_dense_backward_plain_version_matches_jax_vjp_at_sam_windows():
    """K3's packed dqkv and drel at SAM-B's 14 x 14 windows and head dim,
    two heads (the TPU kernel's head pair)."""
    kh = kw = 14
    n, h, d = kh * kw, 2, 64
    rs = np.random.RandomState(720)
    x = rs.standard_normal((1, n, 3 * h * d)).astype(np.float32)
    g = rs.standard_normal((1, n, h * d)).astype(np.float32)
    rel_h = rs.standard_normal((1, n, h, kh)).astype(np.float32)
    rel_w = rs.standard_normal((1, n, h, kw)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_fa.fused_attention_relwin_dense(
        *a, h, interpret=True), *(jnp.asarray(a) for a in (x, rel_h, rel_w)))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, rel_h, rel_w)]
    port_fa.fused_attention_relwin_dense(*leaves, h).backward(
        torch.from_numpy(g))
    for name, t, w in zip(("dqkv", "drel_h", "drel_w"), leaves, want):
        assert t.grad.shape == t.shape
        np.testing.assert_allclose(_to_np(t.grad), _to_np(w), err_msg=name,
                                   **GRAD_TOL["float32"])


@pytest.mark.parametrize("dtype,bias_shape,bias_dtype,entry,buffer", [
    # bf16: the wgmma entry; a full bias's gradient written in its dtype
    (torch.bfloat16, (2, 3, 8, 8), torch.bfloat16, "short", torch.bfloat16),
    (torch.bfloat16, (2, 3, 8, 8), torch.float32, "short", torch.float32),
    # a broadcast bias: fp32 dS0 summed back to its shape, then cast
    (torch.bfloat16, (3, 8, 8), torch.bfloat16, "short", torch.float32),
    # fp32 inputs: fused_attention.cu's entry, an fp32 buffer
    (torch.float32, (2, 3, 8, 8), torch.bfloat16, "fp32", torch.float32),
])
def test_biased_backward_routes_and_dbias_buffer(monkeypatch, dtype,
                                                 bias_shape, bias_dtype,
                                                 entry, buffer):
    """The wrappers' host rules of the biased backward, on meta tensors with
    the launches recorded instead of run: which entry point a dtype takes
    (K2b, K4 and K3), the dtype of the [B, H, N, N] buffer that K2b's
    kernel writes dbias into, and the gradient handed back in the bias's
    own shape and dtype."""
    b, h, n, d = 2, 3, 8, 16
    calls = []
    monkeypatch.setattr(port_fa, "_short_backward",
                        lambda: ("plain", "bias", "rel"))
    monkeypatch.setattr(port_fa, "_library", lambda: ("fp32",) * 6)
    monkeypatch.setattr(port_fa, "_launch_short_backward",
                        lambda fn, *a, **kw: calls.append((fn, a)))
    monkeypatch.setattr(port_fa, "_call",
                        lambda fn, *a, **kw: calls.append((fn, a)))
    monkeypatch.setattr(port_fa, "_launch_relpos_backward",
                        lambda *a: calls.append(("fp32 rel", a)))
    meta = lambda *shape, dt=dtype: torch.empty(shape, dtype=dt, device="meta")
    for wrapper in (port_fa.fused_attention_bias,
                    port_fa.fused_attention_relwin,
                    port_fa.fused_attention_relwin_dense):
        monkeypatch.setattr(wrapper, "backward_launches", 0)
    q, k, v, dout = (meta(b, h, n, d) for _ in range(4))
    bias = meta(*bias_shape, dt=bias_dtype)
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v, bias), n_real=None,
                                needs_input_grad=(True,) * 4 + (False,))
    dbias = port_fa.FusedAttentionBias.backward(ctx, dout)[3]
    assert calls[-1][0] == ("bias" if entry == "short" else "fp32")
    if entry == "short":   # the bias and dbias dtype flags the kernel gets
        assert calls[-1][1][-1] == (int(bias_dtype == torch.bfloat16),
                                    int(buffer == torch.bfloat16))
    assert port_fa.dbias_buffer_dtype(bias, (b, h, n, n), dtype) == buffer
    assert dbias.shape == bias.shape and dbias.dtype == bias_dtype
    ctx.needs_input_grad = (True,) * 3 + (False, False)
    assert port_fa.FusedAttentionBias.backward(ctx, dout)[3] is None
    rel = [meta(b, h, n, 2, dt=torch.float32),
           meta(b, h, n, 4, dt=torch.float32)]
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v, *rel), n_real=None)
    port_fa.FusedAttentionRelwin.backward(ctx, meta(b, h, n, d))
    assert calls[-1][0] == ("rel" if entry == "short" else "fp32 rel")
    qkv = meta(b, n, 3 * h * 64)
    rel = [meta(b, n, h, 2, dt=torch.float32),
           meta(b, n, h, 4, dt=torch.float32)]
    ctx = types.SimpleNamespace(saved_tensors=(qkv, *rel), head_nums=h)
    port_fa.FusedAttentionRelwinDense.backward(ctx, meta(b, n, h * 64))
    assert calls[-1][0] == ("rel" if entry == "short" else "fp32 rel")
    assert (port_fa.fused_attention_bias.backward_launches,
            port_fa.fused_attention_relwin.backward_launches,
            port_fa.fused_attention_relwin_dense.backward_launches) == (2, 1, 1)
