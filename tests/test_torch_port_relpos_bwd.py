"""K5's bf16 backward (``csrc/flash_relpos_bwd.cu``) on the CPU: the plain
version of its order of sums and its host-side rules.

The kernel walks the keys in 64-key tiles, in order, and sums drel_h and
drel_w tile by tile (in the key-grid mode, KW = 64, drel_h[i, jh] is tile
jh's row sum and drel_w accumulates in registers over the walk);
``flash_attention_relpos_walk_reference`` is the plain version of that
order. It is held here against the port's plain backward
(``flash_attention_relpos_backward_reference``) and against the VJP of the
JAX package's ``flash_attention_relpos`` (``force_pallas=True``, its
off-TPU composition), on the same numpy inputs: fp32 rtol 1e-5, atol 2e-5
for dq, dk, dv (the JAX package's own tolerance for its rel-pos kernels)
and for drel_h, drel_w, the same sums in another order; bf16 within 2e-2
of the gradient's scale (a bf16 ulp or two where the two round P or dS0 to
another neighbour). The key-grid rule, the TMA row rule of rel_w and the
CPU route of the backward entry are pure host code, tested here too.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
    flash_attention as port_fl, fused_attention as port_fa)
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

jax_fl = importlib.import_module(
    "simpleaicv_pytorch_training_examples_tpu.ops.pallas.flash_attention")

F32 = dict(rtol=1e-5, atol=2e-5)


def _inputs(b, h, kh, kw, d, seed):
    rs = np.random.RandomState(seed)
    n = kh * kw
    q, k, v, g = rs.standard_normal((4, b, h, n, d)).astype(np.float32)
    rel_h = rs.standard_normal((b, h, n, kh)).astype(np.float32)
    rel_w = rs.standard_normal((b, h, n, kw)).astype(np.float32)
    return q, k, v, g, rel_h, rel_w


def _torch(arrays, dtype=torch.float32):
    q, k, v, g, rel_h, rel_w = (torch.from_numpy(a) for a in arrays)
    return (*(t.to(dtype) for t in (q, k, v, g)), rel_h, rel_w)


# (b, h, kh, kw, d): the key-grid mode (KW = 64 at D = 64 and 80, N a
# multiple of 64 and not of 128), KW that splits the 64-key tiles across
# grid rows, a ragged last tile, D past 80
CASES = [(1, 2, 3, 64, 64), (1, 1, 2, 64, 80), (2, 1, 5, 13, 32),
         (1, 2, 6, 35, 64), (1, 1, 4, 20, 96)]


@pytest.mark.parametrize("b,h,kh,kw,d", CASES)
def test_walk_reference_matches_plain_backward(b, h, kh, kw, d):
    """fp32: the walk's order of sums against the plain backward."""
    q, k, v, g, rel_h, rel_w = _torch(_inputs(b, h, kh, kw, d, 10 + d))
    got = port_fl.flash_attention_relpos_walk_reference(q, k, v, rel_h,
                                                        rel_w, g)
    want = port_fl.flash_attention_relpos_backward_reference(q, k, v, rel_h,
                                                            rel_w, g)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y.numpy(), **F32)


@pytest.mark.parametrize("b,h,kh,kw,d", CASES[:4])
def test_walk_reference_in_bf16(b, h, kh, kw, d):
    """bf16: dq, dk, dv within 2e-2 of their scale of the plain backward's,
    drel_h and drel_w (fp32 sums of the same fp32 dS0) within 1e-4."""
    q, k, v, g, rel_h, rel_w = _torch(_inputs(b, h, kh, kw, d, 20 + d),
                                      torch.bfloat16)
    got = port_fl.flash_attention_relpos_walk_reference(q, k, v, rel_h,
                                                        rel_w, g)
    want = port_fl.flash_attention_relpos_backward_reference(q, k, v, rel_h,
                                                            rel_w, g)
    for x, y in zip(got[:3], want[:3]):
        assert x.dtype == torch.bfloat16
        scale = max(1.0, y.float().abs().max().item())
        assert (x.float() - y.float()).abs().max().item() <= 2e-2 * scale
    for x, y in zip(got[3:], want[3:]):
        assert x.dtype == torch.float32
        scale = y.abs().max().item()
        assert (x - y).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("b,h,kh,kw,d", [(1, 2, 2, 64, 64), (1, 1, 3, 10, 80),
                                         (1, 2, 5, 7, 32)])
def test_walk_reference_matches_jax_vjp(b, h, kh, kw, d):
    """fp32: the walk's order against the VJP of the JAX package's
    flash_attention_relpos (its off-TPU composition)."""
    arrays = _inputs(b, h, kh, kw, d, 30 + d)
    q, k, v, g, rel_h, rel_w = arrays
    _, vjp = jax.vjp(lambda *a: jax_fl.flash_attention_relpos(
        *a, force_pallas=True), *(jnp.asarray(a) for a in (q, k, v, rel_h,
                                                            rel_w)))
    want = vjp(jnp.asarray(g))
    got = port_fl.flash_attention_relpos_walk_reference(*_torch(arrays)[:3],
                                                        *_torch(arrays)[4:],
                                                        _torch(arrays)[3])
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), **F32)


def test_walk_reference_takes_the_forwards_output_and_lse():
    """Given the forward's output and lse, the walk uses them: the same
    result as recomputing them."""
    q, k, v, g, rel_h, rel_w = _torch(_inputs(1, 2, 2, 64, 64, 40))
    out, lse = port_fl.flash_attention_relpos_reference(q, k, v, rel_h,
                                                        rel_w, return_lse=True)
    given = port_fl.flash_attention_relpos_walk_reference(
        q, k, v, rel_h, rel_w, g, out, lse)
    again = port_fl.flash_attention_relpos_walk_reference(q, k, v, rel_h,
                                                          rel_w, g)
    for x, y in zip(given, again):
        assert torch.equal(x, y)


@pytest.mark.parametrize("d,kh,kw,want", [
    (64, 64, 64, True),     # SAM-B's global blocks
    (80, 64, 64, True),     # SAM-H's
    (8, 2, 64, True),
    (96, 64, 64, False),    # the walks' score products past D = 80
    (64, 129, 64, False),   # rel_h rows past the dQ walk's shared memory
    (64, 64, 128, False),   # a 64-key tile is not a whole grid row
    (64, 64, 32, False),
])
def test_grid_mode_rule(d, kh, kw, want):
    assert port_fl.relpos_backward_grid_mode(d, kh, kw) is want


def test_tma_operand_reads_fp32_rel_rows_in_place_or_copies_them():
    """rel_w as the key-grid mode's TMA map reads it (fp32: strides in
    multiples of 4 elements): a transposed [B, N, H, KW] view in place, rows
    of 65 floats copied (the copy has the same values), the strides of axes
    of size 1 ignored."""
    base = torch.zeros(2, 3, 4 * 65 + 4)
    rows = base[:, :, 4:].view(2, 3, 4, 65)[..., :64]   # row stride 65
    copied = port_fa.tma_operand(rows)
    assert copied.stride()[2] % 4 == 0 and torch.equal(copied, rows)
    view = torch.zeros(2, 8, 3, 64).transpose(1, 2)     # [B, H, N, K] view
    assert port_fa.tma_operand(view) is view
    one_head = torch.zeros(1, 1, 4, 64).as_strided((1, 1, 4, 64),
                                                   (7, 7, 64, 1))
    assert port_fa.tma_operand(one_head) is one_head


def test_backward_entry_on_the_cpu_takes_the_plain_version():
    """The backward entry (which FlashAttentionRelpos.backward calls) on
    CPU tensors: the plain backward with the forward's output; no kernel
    launched, none counted."""
    q, k, v, g, rel_h, rel_w = _torch(_inputs(1, 2, 2, 64, 64, 50))
    out, lse = port_fl.flash_attention_relpos(q, k, v, rel_h, rel_w,
                                              return_lse=True)
    before = port_fl.flash_attention_relpos.backward_launches
    got = port_fl.flash_attention_relpos_backward(q, k, v, rel_h, rel_w, g,
                                                  out, lse)
    assert port_fl.flash_attention_relpos.backward_launches == before
    want = port_fl.flash_attention_relpos_backward_reference(
        q, k, v, rel_h, rel_w, g, out)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, rel_h, rel_w)]
    port_fl.flash_attention_relpos(*leaves).backward(g)
    for leaf, y in zip(leaves, want):
        assert torch.equal(leaf.grad, y)
