"""K8, the fused ViT attention block, and the ViT's fused route, against the
JAX package.

Kernel level: the port's plain K8 (``attn_block_reference`` and
``attn_block_backward_reference``, which the wrapper runs on the CPU)
against the JAX Pallas kernel ``attn_block(..., interpret=True)`` with
``jax.grad`` through it, and against ``_reference_block``, forward and all
seven gradients, on the same numpy inputs (the port's weights are the JAX
ones transposed to torch's Linear layout). fp32 tolerances: the forward
atol 2e-5 (the JAX test holds the kernel to 2e-4), the gradients atol and
rtol 2e-4 (the JAX test: 2e-3); bf16: within one bf16 ulp of the output's
largest value of ``_reference_block`` run in bf16.

K8's GEMM: ``gemm_reference``, the plain version of one bf16 product at
each operand layout and epilogue K8 runs (``GEMM_PRODUCTS``), against numpy
float64 on operands of small integers, so that every fp32 sum is exact:
fp32 outputs equal the float64 product, bf16 outputs its one rounding (and
differ from rounding the product before the bias add); the wrapper takes it
on the CPU and refuses shapes that do not fit.

Model level: a tiny ViT with ``use_fused_block`` against the JAX ViT with
the flag (which runs ``_reference_block`` off the TPU) through
``vit_state_dict_from_jax``, logits and every parameter gradient (the JAX
gradients mapped by the same weight map); the parameter names with and
without the flag; which blocks take K8 in training, eval, with dropout and
at shapes K8 does not take; and ``use_gradient_checkpoint``, whose
gradients equal the unchecked ones, also with drop path drawn from the
train step's generator.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.models.backbones import vit as jax_vit
from simpleaicv_pytorch_training_examples_tpu.utils.optimizers import (
    leaf_path_names)
from simpleaicv_pytorch_training_examples_tpu_torch.models import common
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones import vit
from simpleaicv_pytorch_training_examples_tpu_torch.ops.kernels import (
    attn_block as ab)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    vit_state_dict_from_jax)
from torch_port_helpers import random_flat, unflatten
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

jax_ab = importlib.import_module(
    "simpleaicv_pytorch_training_examples_tpu.ops.pallas.attn_block")

FWD_ATOL = 2e-5
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
LOGITS_TOL = dict(atol=2e-4, rtol=2e-4)
MODEL_GRAD_TOL = dict(atol=1e-4, rtol=1e-3)
NAMES = ("dx", "dwqkv", "dbqkv", "dwproj", "dbproj", "dgamma", "dbeta")


def block_inputs(b, n, h, d, seed):
    """numpy x, wqkv [C, 3C] (flax layout), bqkv, wproj [C, C], bproj,
    gamma, beta, as the JAX package's own attn_block test draws them."""
    rs = np.random.RandomState(seed)
    c = h * d
    return [(rs.randn(*shape) * scale + shift).astype(np.float32)
            for shape, scale, shift in (
                ((b, n, c), 0.5, 0.0), ((c, 3 * c), 0.05, 0.0),
                ((3 * c,), 0.02, 0.0), ((c, c), 0.05, 0.0), ((c,), 0.02, 0.0),
                ((c,), 0.1, 1.0), ((c,), 0.1, 0.0))]


def to_port(args, dtype=torch.float32):
    """The numpy inputs as the port takes them: Linear weights [out, in],
    x and the weights in ``dtype``, gamma and beta fp32."""
    x, wqkv, bqkv, wproj, bproj, gamma, beta = (torch.from_numpy(a)
                                                for a in args)
    return ([t.to(dtype) for t in (x, wqkv.t(), bqkv, wproj.t(), bproj)]
            + [gamma, beta])


def port_grads_in_jax_layout(grads):
    """The port's gradients with dwqkv and dwproj back in flax's layout."""
    out = [g.float().numpy() for g in grads]
    out[1], out[3] = out[1].T, out[3].T
    return out


@pytest.mark.parametrize("h,d", [(4, 64), (2, 128)])
def test_plain_block_matches_the_tpu_kernel_and_reference(h, d):
    b, n = 2, 21
    args = block_inputs(b, n, h, d, seed=13 + d)
    jargs = [jnp.asarray(a) for a in args]
    dy = np.random.RandomState(7).randn(b, n, h * d).astype(np.float32)

    port_args = to_port(args)
    got = ab.attn_block_reference(*port_args, h).numpy()
    kernel = np.asarray(jax_ab.attn_block(*jargs, head_nums=h,
                                          interpret=True))
    reference = np.asarray(jax_ab._reference_block(*jargs, head_nums=h,
                                                   eps=1e-6))
    np.testing.assert_allclose(got, kernel, rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(got, reference, rtol=0, atol=FWD_ATOL)

    # the gradients of sum(y * dy): every one of the seven inputs
    grads = port_grads_in_jax_layout(ab.attn_block_backward_reference(
        *port_args, torch.from_numpy(dy), h))

    def loss(fn):
        return lambda *a: jnp.sum(fn(*a) * dy)
    want_kernel = jax.grad(loss(lambda *a: jax_ab.attn_block(
        *a, head_nums=h, interpret=True)), argnums=tuple(range(7)))(*jargs)
    want_reference = jax.grad(loss(lambda *a: jax_ab._reference_block(
        *a, head_nums=h, eps=1e-6)), argnums=tuple(range(7)))(*jargs)
    for name, g, wk, wr in zip(NAMES, grads, want_kernel, want_reference):
        np.testing.assert_allclose(g, np.asarray(wk), err_msg=name,
                                   **GRAD_TOL)
        np.testing.assert_allclose(g, np.asarray(wr), err_msg=name,
                                   **GRAD_TOL)


def test_plain_block_in_bf16_matches_the_reference():
    """The same roundings as ``_reference_block`` in bf16: within one bf16
    ulp of the output's largest value."""
    h, d = 4, 64
    args = block_inputs(2, 21, h, d, seed=15)
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in args[:5]] + [
        jnp.asarray(a) for a in args[5:]]
    want = np.asarray(jax_ab._reference_block(*jargs, head_nums=h, eps=1e-6)
                      .astype(jnp.float32))
    got = ab.attn_block_reference(*to_port(args, torch.bfloat16), h)
    assert got.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)


def test_the_wrapper_takes_the_plain_version_on_the_cpu():
    h, d = 2, 64
    args = to_port(block_inputs(2, 9, h, d, seed=16))
    leaves = [t.clone().requires_grad_() for t in args]
    before = (ab.attn_block.launches, ab.attn_block.backward_launches)
    y = ab.attn_block(*leaves, h)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(0))
    grads = torch.autograd.grad(y, leaves, dy)
    assert (ab.attn_block.launches, ab.attn_block.backward_launches) == before
    torch.testing.assert_close(y, ab.attn_block_reference(*args, h),
                               rtol=0, atol=0)
    for name, g, w in zip(NAMES, grads, ab.attn_block_backward_reference(
            *args, dy, h)):
        torch.testing.assert_close(g, w, rtol=0, atol=0, msg=name)


# ---------------------------------------------------------------- the GEMM

def gemm_operands(product, m, c, seed):
    """numpy float64 A, B (in the layouts of ``GEMM_PRODUCTS``), bias and
    resid of one product at M rows and width C: integers in [-8, 8] (bias)
    and [-64, 64] (resid), so that bf16 holds them and fp32 sums them
    exactly; M, N, K as K8 runs the product."""
    mnk = {"qkv": (m, 3 * c, c), "proj": (m, c, c), "dattn": (m, c, c),
           "dxn": (m, c, 3 * c), "dwproj": (c, c, m), "dwqkv": (3 * c, c, m)}
    mm, n, k = mnk[product]
    a_k, b_k, _ = ab.GEMM_PRODUCTS[product]
    rs = np.random.RandomState(seed)
    ints = lambda lim, *shape: rs.randint(-lim, lim + 1, shape).astype(
        np.float64)
    return (ints(8, *((mm, k) if a_k else (k, mm))),
            ints(8, *((n, k) if b_k else (k, n))), ints(8, n), ints(64, mm, n))


@pytest.mark.parametrize("product", sorted(ab.GEMM_PRODUCTS))
@pytest.mark.parametrize("m,c", [(21, 64), (300, 192)])
def test_gemm_reference_against_float64(product, m, c):
    a_k, b_k, epilogue = ab.GEMM_PRODUCTS[product]
    a, b, bias, resid = gemm_operands(product, m, c, seed=m + c)
    bf = lambda t: torch.from_numpy(t).to(torch.bfloat16)
    extra = {"bias": bf(bias)} if "bias" in epilogue else {}
    if epilogue == "bias_residual":
        extra["resid"] = bf(resid)
    got = ab.gemm_reference(bf(a), bf(b), a_k, b_k, epilogue, **extra)
    acc = (a if a_k else a.T) @ (b.T if b_k else b)
    want = acc + (bias if "bias" in epilogue else 0.0) + (
        resid if epilogue == "bias_residual" else 0.0)
    if epilogue in ("store_f32", "weight_gradient"):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        return
    assert got.dtype == torch.bfloat16
    once = torch.from_numpy(want).to(torch.bfloat16)
    torch.testing.assert_close(got, once, rtol=0, atol=0)
    if epilogue != "store":   # rounded once, not before the bias add
        twice = (torch.from_numpy(acc).to(torch.bfloat16).double()
                 + torch.from_numpy(want - acc)).to(torch.bfloat16)
        assert not torch.equal(twice, once)


def test_gemm_takes_the_plain_version_on_the_cpu():
    a, b, bias, resid = (torch.from_numpy(t).to(torch.bfloat16) for t in
                         gemm_operands("proj", 40, 64, seed=1))
    before = ab.gemm.launches
    got = ab.gemm(a, b, True, True, "bias_residual", bias=bias, resid=resid)
    assert ab.gemm.launches == before
    torch.testing.assert_close(got, ab.gemm_reference(
        a, b, True, True, "bias_residual", bias=bias, resid=resid),
        rtol=0, atol=0)


@pytest.mark.parametrize("case", ["k_differs", "no_bias", "resid_shape",
                                  "epilogue"])
def test_gemm_refuses_shapes_that_do_not_fit(case):
    a, b = torch.zeros(16, 64), torch.zeros(32, 64)
    kwargs = {"bias_residual": dict(bias=torch.zeros(32),
                                    resid=torch.zeros(16, 31))}
    with pytest.raises(ValueError):
        if case == "k_differs":
            ab.gemm(a, torch.zeros(32, 48))
        elif case == "no_bias":
            ab.gemm(a, b, epilogue="bias")
        elif case == "resid_shape":
            ab.gemm(a, b, epilogue="bias_residual", **kwargs["bias_residual"])
        else:
            ab.gemm(a, b, epilogue="transpose")


# ---------------------------------------------------------------- the model

def tiny_vits(planes=128, heads=2, **kwargs):
    kw = dict(image_size=32, num_classes=5, **kwargs)
    return (jax_vit.ViT(8, planes, 2, heads, 4, use_fused_block=True, **kw),
            vit.ViT(8, planes, 2, heads, 4, use_fused_block=True, **kw))


def flat_names(tree):
    return dict(zip(leaf_path_names(tree), jax.tree_util.tree_leaves(tree)))


@pytest.mark.parametrize("planes,heads", [(128, 2), (128, 1)])
@pytest.mark.parametrize("checkpointed", [False, True])
def test_fused_vit_matches_the_jax_vit(planes, heads, checkpointed,
                                      monkeypatch):
    """Logits and every parameter gradient; heads of 64 and of 128."""
    jax_model, port = tiny_vits(planes, heads,
                                use_gradient_checkpoint=checkpointed)
    images = np.random.RandomState(17).rand(2, 32, 32, 3).astype(np.float32)
    params = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.asarray(images))["params"]
    flat = random_flat(params, 18)
    port.load_state_dict(vit_state_dict_from_jax(flat))

    def jax_loss(p):
        return jnp.sum(jax_model.apply({"params": p}, jnp.asarray(images))
                       ** 2)
    jax_params = unflatten(flat)
    want = np.asarray(jax_model.apply({"params": jax_params},
                                      jnp.asarray(images)))
    jax_grads = vit_state_dict_from_jax(
        {k: np.asarray(v) for k, v in flat_names(
            jax.grad(jax_loss)(jax_params)).items()})

    port.eval()
    calls = []
    real = vit.attn_block
    monkeypatch.setattr(vit, "attn_block",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    logits = port(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()))
    (logits ** 2).sum().backward()
    # two blocks; checkpointing runs each block's forward once more
    assert len(calls) == (4 if checkpointed else 2)
    np.testing.assert_allclose(logits.detach().numpy(), want, **LOGITS_TOL)
    grads = dict(port.named_parameters())
    assert set(grads) == set(jax_grads)
    for name, g in jax_grads.items():
        np.testing.assert_allclose(grads[name].grad.numpy(), g.numpy(),
                                   err_msg=name, **MODEL_GRAD_TOL)


def test_the_flag_keeps_the_parameter_names():
    plain = vit.ViT(8, 128, 2, 2, image_size=32, num_classes=5)
    fused = vit.ViT(8, 128, 2, 2, image_size=32, num_classes=5,
                    use_fused_block=True)
    assert list(plain.state_dict()) == list(fused.state_dict())
    assert all(a.shape == b.shape for a, b in zip(
        plain.state_dict().values(), fused.state_dict().values()))
    fused.load_state_dict(plain.state_dict(), strict=True)


def fused_blocks(model, images, monkeypatch):
    """The indices of the blocks that took K8 in one forward."""
    taken = []
    real = vit.attn_block

    def spy(x, wqkv, *args, **kwargs):
        taken.extend(i for i, block in enumerate(model.blocks)
                     if block.attn.qkv.weight is wqkv)
        return real(x, wqkv, *args, **kwargs)
    monkeypatch.setattr(vit, "attn_block", spy)
    with torch.no_grad():
        model(images)
    monkeypatch.setattr(vit, "attn_block", real)
    return taken


@pytest.mark.parametrize("case,train,expected", [
    ("drop_path", True, [0]),       # block 0's own drop-path probability is 0
    ("drop_path", False, [0, 1, 2]),
    ("dropout", True, []),
    ("dropout", False, [0, 1, 2]),
    ("head_dim_80", False, []),
    ("n_1025", False, []),
])
def test_which_blocks_take_the_kernel(case, train, expected, monkeypatch):
    kwargs = dict(drop_path=dict(drop_path_prob=0.1),
                  dropout=dict(dropout_prob=0.1)).get(case, {})
    planes, image = (160, 32) if case == "head_dim_80" else (128, 32)
    if case == "n_1025":
        image = 256                 # 32 x 32 patches and the cls token
    model = vit.ViT(8, planes, 3, 2, image_size=image, num_classes=5,
                    use_fused_block=True, **kwargs)
    common.init_parameters_(model, torch.Generator().manual_seed(0))
    model.train(train)
    images = torch.randn(1, 3, image, image,
                         generator=torch.Generator().manual_seed(1))
    assert fused_blocks(model, images, monkeypatch) == expected


def checkpointed_grads(checkpointed, images, state, restore=True,
                       monkeypatch=None):
    model = vit.ViT(8, 128, 3, 2, image_size=32, num_classes=5,
                    drop_path_prob=0.5, use_fused_block=True,
                    use_gradient_checkpoint=checkpointed)
    model.load_state_dict(state)
    if not restore:
        monkeypatch.setattr(vit, "_checkpoint_contexts", lambda block: (
            vit.contextlib.nullcontext(), vit.contextlib.nullcontext()))
    common.attach_mask_generator(model, torch.Generator().manual_seed(3))
    model.train()
    (model(images) ** 2).sum().backward()
    return {n: p.grad for n, p in model.named_parameters()}


def test_gradient_checkpoint_draws_the_same_masks(monkeypatch):
    """Drop path live in training: blocks 1 and 2 draw masks from the train
    step's generator, and the recompute must draw the same ones (a
    recompute that does not restore the generator gives other gradients)."""
    model = vit.ViT(8, 128, 3, 2, image_size=32, num_classes=5)
    common.init_parameters_(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator()
                                     .manual_seed(p.numel())))
    state = model.state_dict()
    images = torch.randn(8, 3, 32, 32,
                         generator=torch.Generator().manual_seed(4))
    want = checkpointed_grads(False, images, state)
    got = checkpointed_grads(True, images, state)
    for name, g in want.items():
        torch.testing.assert_close(got[name], g, rtol=0, atol=0, msg=name)
    drifted = checkpointed_grads(True, images, state, restore=False,
                                 monkeypatch=monkeypatch)
    assert any(not torch.equal(drifted[n], g) for n, g in want.items())
