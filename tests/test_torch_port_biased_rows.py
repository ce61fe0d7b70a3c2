"""K2b (a full score bias) and K3/K4 (SAM's decomposed rel-pos bias) at the
row lengths where the bf16 forward kernel (``csrc/short_attention_fwd.cu``)
changes its plan, against the JAX package.

The kernel holds a whole score row in its accumulators up to 264 keys and
walks groups of 256 keys past that; it splits D = 80 into column boxes of
64 and 16; it stages a bf16 bias whose rows are not a multiple of 16 bytes
in 8-byte copies. On the CPU the wrappers take their plain PyTorch versions;
these tests hold them against the JAX entry points run through their Pallas
kernels in interpret mode at those shapes (the JAX package's own tests and
the port's other CPU tests stop at N <= 20), so that the chain JAX -> plain
version -> kernel (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``)
is closed where the kernel splits. One batch and one head each (K3: two,
its TPU kernel's head pair), to keep interpret mode quick.

Tolerances: fp32 rtol 1e-5, atol 2e-5 (the port's rel-pos tests' fp32
tolerance: softmax over 196-257 keys summed in another order); bf16 atol
2e-2 (a few bf16 ulps at |x| <= 2, from rounding P and the output).
"""

import importlib

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
