"""The port's ViT modules against their flax counterparts in the JAX package.

Same weights (random flax parameters, mapped by vit_state_dict_from_jax),
same numpy inputs (images NHWC for JAX, NCHW for the port). Tolerances:
fp32 logits atol 2e-3 / rtol 1e-3, as the JAX package's torch-parity tests;
fp32 layers atol 1e-4 / rtol 1e-4 (another summation order only); bf16
atol 4e-2 with equal top-1 (bf16 rounds at other places in XLA and in torch:
a bf16 ulp is 0.8% of |x| and the tiny ViT stacks a dozen rounded layers;
its logits, |x| < 2, differ by 0.016 at most).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.models import common as jax_common
from simpleaicv_pytorch_training_examples_tpu.models.backbones import vit as jax_vit
from simpleaicv_pytorch_training_examples_tpu.utils.checkpoint import (
    _resize_position_embedding)
from simpleaicv_pytorch_training_examples_tpu.utils.torch_convert import (
    convert_vit_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.models import common
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones import vit
from simpleaicv_pytorch_training_examples_tpu_torch.utils.checkpoint import (
    load_state_dict_filtered, resize_position_embedding)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    vit_state_dict_from_jax)
from torch_port_helpers import random_flat, unflatten
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

FP32 = dict(rtol=1e-3, atol=2e-3)
LAYER_FP32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=0, atol=4e-2)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def jax_and_port(jax_module, port_module, x_jax, seed=0):
    """Random weights into both modules; returns (jax out, port out)."""
    params = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0),
                            x_jax)["params"]
    flat = random_flat(params, seed)
    port_module.load_state_dict(vit_state_dict_from_jax(flat))
    port_module.eval()
    want = jax_module.apply({"params": unflatten(flat)}, x_jax)
    return want, port_module


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_flax(dtype):
    jd, td = DTYPES[dtype]
    x = np.random.RandomState(1).standard_normal((2, 17, 128)).astype(
        np.float32)
    want, port = jax_and_port(jax_common.Mlp(512, 128, dtype=jd),
                              common.Mlp(128, 512, dtype=td), jnp.asarray(x))
    got = port(torch.from_numpy(x))
    assert got.dtype == td
    tol = LAYER_FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


@pytest.mark.parametrize("planes,heads,fused,path,n", [
    (128, 2, True, "K1", 17),        # head dim 64
    (256, 2, True, "K1", 17),        # head dim 128
    (160, 2, True, "K2", 17),        # head dim 80 (ViT-H/14's)
    (128, 2, False, "eager", 17),
    (128, 2, True, "eager", 1025),   # past the kernels' N <= 1024
])
def test_attention_matches_flax(planes, heads, fused, path, n, monkeypatch):
    x = np.random.RandomState(2).standard_normal((2, n, planes)).astype(
        np.float32)
    want, port = jax_and_port(
        jax_common.MultiHeadSelfAttention(heads, use_fused_attention=fused),
        common.MultiHeadSelfAttention(planes, heads,
                                      use_fused_attention=fused),
        jnp.asarray(x))
    calls = []
    for name in ("fused_attention_dense", "fused_attention"):
        real = getattr(common, name)
        monkeypatch.setattr(common, name, lambda *a, _n=name, _f=real, **k:
                            calls.append(_n) or _f(*a, **k))
    got = port(torch.from_numpy(x))
    expected_calls = {"K1": ["fused_attention_dense"],
                      "K2": ["fused_attention"], "eager": []}[path]
    assert calls == expected_calls
    np.testing.assert_allclose(as_np(got), as_np(want), **LAYER_FP32)


def test_bf16_softmax_eager_attention_matches_flax():
    x = np.random.RandomState(3).standard_normal((2, 17, 128)).astype(
        np.float32)
    want, port = jax_and_port(
        jax_common.MultiHeadSelfAttention(2, dtype=jnp.bfloat16,
                                          softmax_dtype=jnp.bfloat16),
        common.MultiHeadSelfAttention(128, 2, dtype=torch.bfloat16,
                                      softmax_dtype=torch.bfloat16),
        jnp.asarray(x))
    np.testing.assert_allclose(as_np(port(torch.from_numpy(x))),
                               as_np(want), **BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_layer_matches_flax(dtype):
    jd, td = DTYPES[dtype]
    x = np.random.RandomState(4).standard_normal((2, 17, 128)).astype(
        np.float32)
    want, port = jax_and_port(
        jax_vit.TransformerEncoderLayer(2, dtype=jd,
                                        use_fused_attention=True),
        vit.TransformerEncoderLayer(128, 2, dtype=td,
                                    use_fused_attention=True),
        jnp.asarray(x))
    got = port(torch.from_numpy(x))
    tol = LAYER_FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)


def tiny_vits(global_pool, dtype, planes=128, heads=2):
    jd, td = DTYPES[dtype]
    kwargs = dict(image_size=64, num_classes=10, global_pool=global_pool,
                  use_fused_attention=True)
    return (jax_vit.ViT(16, planes, 2, heads, 4, dtype=jd, **kwargs),
            vit.ViT(16, planes, 2, heads, 4, dtype=td, **kwargs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("global_pool", [True, False])
def test_vit_matches_flax(global_pool, dtype):
    x = np.random.RandomState(5).standard_normal((4, 64, 64, 3)).astype(
        np.float32)
    jax_model, port_model = tiny_vits(global_pool, dtype)
    want, port = jax_and_port(jax_model, port_model, jnp.asarray(x), seed=5)
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    tol = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(as_np(got), as_np(want), **tol)
    np.testing.assert_array_equal(as_np(got).argmax(-1),
                                  as_np(want).argmax(-1))


def test_vit_h_head_dim_takes_k2_and_matches_flax():
    """A tiny ViT with ViT-H/14's head dim (80) runs K2's plain version."""
    x = np.random.RandomState(6).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    jax_model, port_model = tiny_vits(True, "float32", planes=160, heads=2)
    want, port = jax_and_port(jax_model, port_model, jnp.asarray(x), seed=6)
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(as_np(got), as_np(want), **FP32)


def test_state_dict_names_invert_the_torch_converter():
    """The port's state_dict, run through the JAX package's torch->flax ViT
    converter, gives back the flax names and values it was mapped from."""
    jax_model, port_model = tiny_vits(True, "float32")
    params = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    flat = random_flat(params, 7)
    port_model.load_state_dict(vit_state_dict_from_jax(flat))
    sd = {k: v.numpy() for k, v in port_model.state_dict().items()}
    back, _ = convert_vit_state_dict(sd)
    assert set(back) == set(flat)
    for name, value in flat.items():
        np.testing.assert_array_equal(back[name], value)


@pytest.mark.parametrize("src_tokens,dst_tokens", [
    (1 + 4 * 4, 1 + 7 * 7),      # up, cls token kept
    (1 + 7 * 7, 1 + 3 * 3),      # down (antialiased), cls token kept
    (6 * 6, 9 * 9),              # up, no cls token
    (1 + 5 * 5, 4 * 4),          # cls token dropped
])
def test_pos_embed_resize_matches_jax(src_tokens, dst_tokens):
    src = np.random.RandomState(src_tokens).standard_normal(
        (1, src_tokens, 8)).astype(np.float32)
    want = _resize_position_embedding(src, (1, dst_tokens, 8))
    got = resize_position_embedding(torch.from_numpy(src), (1, dst_tokens, 8))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_filtered_load_resizes_pos_embed_and_skips_mismatches():
    small = vit.ViT(16, 64, 1, 1, image_size=32, num_classes=3)
    big = vit.ViT(16, 64, 1, 1, image_size=64, num_classes=5)
    common.init_parameters_(small, torch.Generator().manual_seed(0))
    common.init_parameters_(big, torch.Generator().manual_seed(1))
    saved = small.state_dict()
    loaded, total = load_state_dict_filtered(big, saved)
    # everything but fc.weight / fc.bias (3 vs 5 classes) loads
    assert (loaded, total) == (len(saved) - 2, len(saved))
    torch.testing.assert_close(big.blocks[0].attn.qkv.weight,
                               small.blocks[0].attn.qkv.weight)
    torch.testing.assert_close(
        big.pos_embed, resize_position_embedding(saved["pos_embed"],
                                                 big.pos_embed.shape))


def test_trunc_normal_matches_flax_truncation():
    x = common.trunc_normal_(torch.empty(200_000), 0.02,
                             torch.Generator().manual_seed(0))
    bound = 2 * 0.02 / 0.87962566103423978
    assert x.abs().max() <= bound * (1 + 1e-6)
    assert abs(x.std().item() - 0.02) < 0.02 * 0.02
    assert abs(x.mean().item()) < 1e-3


def test_unported_fused_kernels_raise(monkeypatch):
    """Both fused kernels are ported now: K8 (the fused block) builds and
    takes the block's first half, K7 (the fused LayerNorm) gives the plain
    LayerNorm's output."""
    block = vit.TransformerEncoderLayer(128, 2, use_fused_block=True).eval()
    calls = []
    real = vit.attn_block
    monkeypatch.setattr(vit, "attn_block",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    x = torch.randn(2, 5, 128)
    plain = vit.TransformerEncoderLayer(128, 2).eval()
    plain.load_state_dict(block.state_dict())
    torch.testing.assert_close(block(x), plain(x), rtol=1e-5, atol=1e-5)
    assert calls == [1]
    fused = common.FusedLayerNorm(8, use_fused=True)
    x = torch.randn(3, 5, 8)
    torch.testing.assert_close(fused(x), common.FusedLayerNorm(8)(x),
                               rtol=1e-5, atol=1e-5)


def test_drop_path_drops_whole_samples_in_training_only():
    x = torch.ones(64, 5, 8)
    drop = common.DropPath(0.5)
    torch.manual_seed(0)
    y = drop.train()(x)
    per_sample = y.reshape(64, -1)
    assert set(per_sample.unique().tolist()) <= {0.0, 2.0}
    assert torch.all(per_sample.min(1).values == per_sample.max(1).values)
    assert 0 < (per_sample[:, 0] == 0).sum() < 64
    assert torch.equal(drop.eval()(x), x)
