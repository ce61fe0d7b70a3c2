"""The port's DINOv3 ViT backbones (RoPE, LayerScale, MLP and SwiGLU, the
pyramid neck and the multi-scale detection backbone) against the JAX
package on the CPU.

Tiny models (patch 16, width 64, 2 blocks, 2 heads of 32) on the same
weights (``dinov3_vit_state_dict_from_jax``), fp32, held at 1e-4 of the
output's scale and each gradient's largest value. In training both
packages draw the RoPE rescale from one key: the JAX model's
``rope_sincos_augmented`` is handed a fixed key, and the port gets the
uniform draw that key gives (``rope_draws``). The RoPE tables equal JAX's
(the float64 ones bit for bit). ``extra_tokens`` enter before the last
blocks. K2's route: at N = 1024 tokens with ``use_fused_attention`` every
block calls the port's ``fused_attention`` (on the CPU its plain version)
and matches JAX's; at N = 1025 none does. The weight map is the exact
inverse of the JAX package's ``convert_dinov3_vit_state_dict``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.models.backbones import (
    dinov3_vit as jax_dinov3)
from simpleaicv_pytorch_training_examples_tpu.utils.optimizers import (
    leaf_path_names)
from simpleaicv_pytorch_training_examples_tpu.utils.torch_convert import (
    convert_dinov3_vit_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones import (
    dinov3_vit)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    dinov3_vit_state_dict_from_jax)
from torch_port_helpers import random_flat, unflatten
from torch_port_helpers import (  # noqa: F401 (autouse)
    drop_work_dir_configs, one_torch_thread)

ROPE_KEY = jax.random.PRNGKey(11)
TINY = dict(patch_size=16, embedding_planes=64, block_nums=2, head_nums=2)


def rope_draws(rescale=2.0):
    """The uniform draw ``rope_sincos_augmented`` takes from ROPE_KEY."""
    k_rescale = jax.random.split(ROPE_KEY, 3)[2]
    a = math.log(rescale)
    return {"rescale": np.array(jax.random.uniform(
        k_rescale, (1,), minval=-a, maxval=a))}


@pytest.fixture()
def fixed_rope_key(monkeypatch):
    """The JAX model's train-time RoPE tables from ROPE_KEY."""
    original = jax_dinov3.rope_sincos_augmented

    def from_fixed_key(h, w, head_planes, base, rng, **kwargs):
        return original(h, w, head_planes, base, ROPE_KEY, **kwargs)
    monkeypatch.setattr(jax_dinov3, "rope_sincos_augmented", from_fixed_key)


def _flat(tree):
    return dict(zip(leaf_path_names(tree),
                    (np.asarray(l) for l in jax.tree_util.tree_leaves(tree))))


def _close(got, want, scale_rtol, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=scale_rtol * scale,
                               err_msg=name)


def _pair(jax_cls, port_cls, size, seed=1, **kwargs):
    jax_model = jax_cls(**kwargs)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    params = random_flat(shapes["params"], seed)
    for name in params:   # LayerScale of O(1), so every block matters
        if name.endswith("gamma"):
            params[name] = (0.5 + 0.1 * np.random.RandomState(seed).rand(
                *params[name].shape)).astype(np.float32)
    port = port_cls(**kwargs)
    port.load_state_dict(dinov3_vit_state_dict_from_jax(params))
    return jax_model, port, params


def _images(size, n=2, seed=5):
    return np.random.RandomState(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _nchw(images):
    return torch.from_numpy(images.transpose(0, 3, 1, 2).copy())


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_rope_tables_match_jax():
    for h, w, hd in ((4, 4, 32), (3, 5, 64)):
        got_sin, got_cos = dinov3_vit.rope_sincos(h, w, hd)
        want_sin, want_cos = jax_dinov3.rope_sincos(h, w, hd)
        np.testing.assert_array_equal(got_sin.numpy(), np.asarray(want_sin))
        np.testing.assert_array_equal(got_cos.numpy(), np.asarray(want_cos))
    key = jax.random.PRNGKey(3)
    k_shift, k_jitter, k_rescale = jax.random.split(key, 3)
    draws = {"shift": jax.random.uniform(k_shift, (2,), minval=-0.5,
                                         maxval=0.5),
             "jitter": jax.random.uniform(k_jitter, (2,), minval=-math.log(
                 1.5), maxval=math.log(1.5)),
             "rescale": jax.random.uniform(k_rescale, (1,), minval=-math.log(
                 2.0), maxval=math.log(2.0))}
    want = jax_dinov3.rope_sincos_augmented(
        6, 5, 32, 100.0, key, shift_coords=0.5, jitter_coords=1.5,
        rescale_coords=2.0)
    got = dinov3_vit.rope_sincos_augmented(
        6, 5, 32, 100.0, {k: torch.from_numpy(np.array(v))
                          for k, v in draws.items()},
        shift_coords=0.5, jitter_coords=1.5, rescale_coords=2.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-6,
                                   rtol=0)


@pytest.mark.parametrize("ffn_layer", ["mlp", "swiglu"])
def test_backbone_outputs_and_gradients_match_jax(ffn_layer, fixed_rope_key):
    jax_model, port, params = _pair(jax_dinov3.DinoVisionTransformer,
                                    dinov3_vit.DinoVisionTransformer, 64,
                                    ffn_layer=ffn_layer, **TINY)
    images = _images(64)
    weights = np.random.RandomState(7).standard_normal(
        (2, 4, 4, 64)).astype(np.float32)

    def run(p, x):
        eval_out = jax_model.apply({"params": p}, x)

        def loss_fn(p):
            out = jax_model.apply({"params": p}, x, train=True,
                                  rngs={"dropout": jax.random.PRNGKey(0)})
            return jnp.sum(out * weights), out
        (loss, train_out), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p)
        return eval_out, train_out, loss, grads
    eval_out, train_out, loss, grads = jax.jit(run)(unflatten(params),
                                                    jnp.asarray(images))
    with torch.no_grad():
        got = port.eval()(_nchw(images))
    assert got.shape == (2, 64, 4, 4)
    _close(_nhwc(got), eval_out, 1e-4, "eval")
    port.train()
    got = port(_nchw(images), rope_draws=rope_draws())
    _close(_nhwc(got), train_out, 1e-4, "train")
    # the augmented tables differ from the eval ones
    assert np.abs(np.asarray(train_out) - np.asarray(eval_out)).max() > 1e-3
    port_loss = (got * _nchw(weights)).sum()
    port_loss.backward()
    np.testing.assert_allclose(port_loss.item(), float(loss), rtol=1e-5)
    want = dinov3_vit_state_dict_from_jax(_flat(grads))
    named = dict(port.named_parameters())
    assert set(want) == set(named)
    for name, w in want.items():
        _close(named[name].grad, w.numpy(), 1e-4, name)


def test_train_draws_come_from_the_attached_generator():
    """Without ``rope_draws`` the rescale is drawn from the attached
    generator: the same seed, the same tables; another seed, others."""
    from simpleaicv_pytorch_training_examples_tpu_torch.models.common import (
        attach_mask_generator)
    port = dinov3_vit.DinoVisionTransformer(**TINY).train()
    generator = torch.Generator()
    attach_mask_generator(port, generator)
    x = torch.randn(1, 3, 64, 64)
    outs = []
    for seed in (1, 1, 2):
        generator.manual_seed(seed)
        with torch.no_grad():
            outs.append(port(x))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_extra_tokens_enter_before_the_last_blocks():
    jax_model, port, params = _pair(jax_dinov3.DinoVisionTransformer,
                                    dinov3_vit.DinoVisionTransformer, 64,
                                    **TINY)
    images = _images(64)
    tokens = np.random.RandomState(8).standard_normal(
        (2, 3, 64)).astype(np.float32)
    want = jax.jit(lambda p, x, t: jax_model.apply(
        {"params": p}, x, extra_tokens=t, extra_token_blocks=1))(
        unflatten(params), jnp.asarray(images), jnp.asarray(tokens))
    with torch.no_grad():
        got = port.eval()(_nchw(images), extra_tokens=torch.from_numpy(tokens),
                          extra_token_blocks=1)
    assert got.shape == (2, 3 + 16, 64)
    _close(got, want, 1e-4)


@pytest.fixture()
def k2_calls(monkeypatch):
    calls = []
    original = dinov3_vit.fused_attention

    def counted(q, k, v):
        calls.append(tuple(q.shape))
        return original(q, k, v)
    monkeypatch.setattr(dinov3_vit, "fused_attention", counted)
    return calls


def test_k2_route_at_1024_tokens_and_not_above(k2_calls):
    """512^2 at patch 16 is N = 1024: every block takes K2 (its plain
    version on the CPU) and matches JAX's route, which at N <= 1024 calls
    ``fused_attention`` too; one extra token (N = 1025) takes the plain
    path in every block."""
    kwargs = dict(TINY, block_nums=1, use_fused_attention=True)
    jax_model, port, params = _pair(jax_dinov3.DinoVisionTransformer,
                                    dinov3_vit.DinoVisionTransformer, 512,
                                    **kwargs)
    images = _images(512, n=1)
    want = jax.jit(lambda p, x: jax_model.apply({"params": p}, x))(
        unflatten(params), jnp.asarray(images))
    with torch.no_grad():
        got = port.eval()(_nchw(images))
    assert k2_calls == [(1, 2, 1024, 32)]
    _close(_nhwc(got), want, 1e-4)
    token = torch.zeros(1, 1, 64)
    with torch.no_grad():
        port(_nchw(images), extra_tokens=token, extra_token_blocks=1)
    assert len(k2_calls) == 1
    # without the flag no block takes K2
    port_plain = dinov3_vit.DinoVisionTransformer(**dict(kwargs,
                                                         use_fused_attention=False))
    port_plain.load_state_dict(port.state_dict())
    with torch.no_grad():
        plain = port_plain.eval()(_nchw(images))
    assert len(k2_calls) == 1
    _close(plain, got.numpy(), 1e-5)


@pytest.mark.parametrize("ffn_layer", ["mlp", "swiglu"])
def test_weight_map_is_the_inverse_of_the_jax_converter(ffn_layer):
    _, port, params = _pair(jax_dinov3.DinoVisionTransformer,
                            dinov3_vit.DinoVisionTransformer, 64,
                            ffn_layer=ffn_layer, **TINY)
    got, stats = convert_dinov3_vit_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()})
    assert stats == {} and set(got) == set(params)
    for name in params:
        np.testing.assert_array_equal(got[name], params[name], err_msg=name)


def test_multiscale_backbone_matches_jax(fixed_rope_key):
    """The detection backbone: the ViT (never fused) and the pyramid neck,
    whose ConvTranspose kernels the map flips; four maps of 16 channels."""
    kwargs = dict(embedding_planes=64, block_nums=2, head_nums=2,
                  ffn_layer="mlp", patch_size=16, planes=16)
    jax_model, port, params = _pair(jax_dinov3.DINOv3MultiScaleBackbone,
                                    dinov3_vit.DINOv3MultiScaleBackbone, 64,
                                    **kwargs)
    images = _images(64)
    want = jax.jit(lambda p, x: jax_model.apply({"params": p}, x))(
        unflatten(params), jnp.asarray(images))
    with torch.no_grad():
        got = port.eval()(_nchw(images))
    assert [tuple(g.shape) for g in got] == [(2, 16, 16, 16), (2, 16, 8, 8),
                                             (2, 16, 4, 4), (2, 16, 2, 2)]
    for g, w in zip(got, want):
        _close(_nhwc(g), w, 1e-4)
    assert not port.vit.blocks[0].attn.use_fused_attention
