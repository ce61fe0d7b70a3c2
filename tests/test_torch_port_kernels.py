"""The port's fused-attention kernels K1/K2 against the JAX package.

On the CPU each wrapper takes its plain PyTorch version; these tests hold
that version against the JAX entry points run through their Pallas kernels
in interpret mode, on the same numpy inputs. The CUDA kernels themselves are
held against the plain versions on the card by chip_smoke.py.

Tolerances: fp32 atol 1e-5 (same math, another summation order); bf16
atol 2e-2 (a few bf16 ulps at |x| <= 2, from rounding P and the output).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
    build, fused_attention as port_fa)

# the JAX package's ops.pallas re-exports a function of the module's name
jax_fa = importlib.import_module(
    "simpleaicv_pytorch_training_examples_tpu.ops.pallas.fused_attention")

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(x, dtype):
    """numpy fp32 -> (jax array, torch tensor), both rounded to dtype."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(TORCH_DTYPE[dtype]))


def _to_np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor)
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
