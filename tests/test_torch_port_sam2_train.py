"""The port's SAM2 video training against the JAX package: the train tool's
loss function (one encoder call on the B x T frames, frame 0 prompted, the
condition frames written to the two reserved memory slots, a
point-iteration frame refined by two more decoder passes with error
clicks and the previous mask fed back, SAM2Loss over the frames) and every
parameter's gradient, the losses, both collaters, the JAX AdamW state map,
checkpointing, and the train CLI.

A tiny SAM2 (128^2, Hiera with embedding 56 and one head, FPN 32, memory
16, 3 memory slots of which 2 are condition slots, 4 pointer slots, the
high-res skips on) with the same random weights on both sides (flax
parameters mapped by ``sam2_state_dict_from_jax``), the same clips from the
same ``np.random`` seed, T = 3, and the same Gumbel draws on both sides, fp32
on the CPU. ``_FLASH_MIN_KV`` is patched to 1 in both packages, so every
Hiera block takes K6's route (the port's plain version of it; the JAX
package's off-TPU fallback). The JAX side runs its ``nn.scan`` over the
frames (``use_scan=True``). Tolerances: the loss terms and every gradient
atol 2e-3 / rtol 1e-3, the JAX package's torch-parity tolerances (the
JAX package computes the same fp32 math in another order); the losses
1e-6; collated images 1e-4 (cv2's bilinear resize against torch's), masks,
prompts and frame roles exact; optimizer updates atol 5e-6.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.utils import (
    optimizers as jax_optimizers)
from simpleaicv_pytorch_training_examples_tpu.utils.optimizers import (
    leaf_path_names)
from simpleaicv_pytorch_training_examples_tpu.utils.torch_convert import (
    convert_sam2_state_dict)
from simpleaicv_pytorch_training_examples_tpu.video_interactive_segmentation import (
    losses as jax_losses)
from simpleaicv_pytorch_training_examples_tpu.video_interactive_segmentation.datasets import (
    sam2_video_segmentation_dataset as jax_data)
from simpleaicv_pytorch_training_examples_tpu.video_interactive_segmentation.models.segment_anything2 import (
    image_encoder as jax_enc, sam2 as jax_sam2)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    load_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
    apply_pretrained, init_model)
from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
    train_video_interactive_segmentation_model as train_tool)
from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
    build_optimizer)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    optimizer_state_from_jax, sam2_state_dict_from_jax)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation import (
    losses as port_losses)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.datasets import (
    sam2_video_segmentation_dataset as port_data)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.datasets.syntheticdataset import (
    SyntheticSAM2VideoDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models.segment_anything2 import (
    image_encoder as port_enc, sam2 as port_sam2)
from torch_port_helpers import random_flat, unflatten
from torch_port_helpers import (  # noqa: F401 (autouse)
    drop_work_dir_configs, one_torch_thread)

jax_tool = importlib.import_module(
    "tools.train_video_interactive_segmentation_model")

FP32 = dict(rtol=1e-3, atol=2e-3)
IMAGE, FRAMES, BATCH = 128, 3, 2
POINT_ITERS = 2
COLLATER_SEED = 22      # condition frames 0 and 2, frame 1 refined, points
TINY = dict(image_size=IMAGE, embedding_planes=56, head_nums=1,
            block_nums=(1, 1, 2, 1), window_specification=(4, 2, 4, 2),
            global_attention_blocks=(3,), fpn_planes=32, memory_planes=16,
            memory_mask_nums=3, memory_cond_slots=2, max_object_pointers=4,
            use_high_res_features=True, use_flash_attention=True)
OPTIMIZER = ("AdamW", {"lr": 5e-5, "global_weight_decay": False,
                       "weight_decay": 1e-4,
                       "no_weight_decay_layer_name_list": []})


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.fixture(scope="module")
def flash_min_kv_1():
    """Send every Hiera block to K6's route, in both packages."""
    saved = jax_enc._FLASH_MIN_KV, port_enc._FLASH_MIN_KV
    jax_enc._FLASH_MIN_KV = port_enc._FLASH_MIN_KV = 1
    yield
    jax_enc._FLASH_MIN_KV, port_enc._FLASH_MIN_KV = saved


def _samples(n=BATCH, frames=FRAMES, size=(96, IMAGE), seed=1):
    ds = SyntheticSAM2VideoDataset(n, frames, size, seed=seed)
    return [ds[i] for i in range(n)]


def _port_batch():
    np.random.seed(COLLATER_SEED)
    batch = port_data.SAM2VideoBatchCollater(
        resize=IMAGE, frame_nums=FRAMES, n_points=2)(_samples())
    assert batch["is_cond_frame"][0].tolist() == [1.0, 0.0, 1.0]
    assert batch["is_iter_frame"][0].tolist() == [0.0, 1.0, 0.0]
    assert (batch["prompt_point"][:, 2, :, 2] >= 0).any()
    return batch


def _jax_batch(batch):
    out = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    for key in ("image", "prompt_mask"):      # NCHW -> NHWC
        if key in batch:
            out[key] = jnp.asarray(batch[key].numpy().transpose(0, 1, 3, 4, 2))
    return out


class _Config:
    decoder_point_iters = POINT_ITERS
    use_amp = False

    def __init__(self, criterion):
        self.train_criterion = criterion


@pytest.fixture(scope="module")
def tiny_sam2(flash_min_kv_1):
    """The tiny JAX SAM2 (scan over the frames), its flat parameters and
    constants, and the port with the same weights. The JAX names and shapes
    come from the JAX package's converter of the port's state dict (the
    weight map's exact inverse, ``test_torch_port_sam2.py``), which is
    quicker than tracing flax's init."""
    jnet = jax_sam2.SAM2Video(use_scan=True, **TINY)
    port = port_sam2.SAM2Video(**TINY)
    params, constants = convert_sam2_state_dict(
        {k: v.numpy() for k, v in port.state_dict().items()})
    flat = random_flat(unflatten(params), seed=7)
    constants = random_flat(unflatten(constants), seed=8)
    port.load_state_dict(sam2_state_dict_from_jax(flat, constants))
    return jnet, flat, constants, port


def _jax_noise(rng, iter_frames, b):
    """The Gumbel draws of the JAX loss function's clicks, in the order the
    port draws them: for each refined frame t, pass i, image j, the key
    split(fold_in(split(fold_in(rng, 3), T)[t], i), b)[j]."""
    frame_rngs = jax.random.split(jax.random.fold_in(rng, 3), FRAMES)
    return [np.stack([np.asarray(jax.random.gumbel(key, (IMAGE * IMAGE,)))
                      for key in jax.random.split(
                          jax.random.fold_in(frame_rngs[t], i), b)])
            for t in iter_frames for i in range(POINT_ITERS)]


def _port_loss_and_grads(port, batch, noise, criterion, detach_prompt=False):
    draws = iter(noise)
    loss_fn = train_tool.build_loss_fn(
        port, _Config(criterion),
        click_noise=lambda shape, gen, device: torch.from_numpy(next(draws)))
    port.zero_grad(set_to_none=True)
    decode = port._decode_frame
    if detach_prompt:   # a control: the refinement's mask prompt cut off
        def cut(feat, prompts, highres=None):
            if prompts is not None and prompts.get("prompt_mask") is not None:
                prompts = dict(prompts,
                               prompt_mask=prompts["prompt_mask"].detach())
            return decode(feat, prompts, highres=highres)
        port._decode_frame = cut
    try:
        loss, metrics = loss_fn(port, batch, None)
    finally:
        port.__dict__.pop("_decode_frame", None)
    assert next(draws, None) is None
    loss.backward()
    # parameters the step never reads (the mask-as-prompt downsample, the
    # no-memory embedding) get no gradient here, and 0 from JAX
    return loss, metrics, {n: torch.zeros_like(p) if p.grad is None
                           else p.grad for n, p in port.named_parameters()}


@pytest.fixture(scope="module")
def jax_loss_and_grads(tiny_sam2):
    jnet, flat, constants, _ = tiny_sam2
    batch = _port_batch()
    rng = jax.random.PRNGKey(5)
    loss_fn = jax_tool.build_loss_fn(jnet, _Config(jax_losses.SAM2Loss()))
    variables = {"constants": unflatten(constants)}
    (loss, (_, metrics)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(unflatten(flat), variables, _jax_batch(batch),
                                rng)
    grads = dict(zip(leaf_path_names(grads),
                     (np.asarray(g) for g in jax.tree_util.tree_leaves(grads))))
    noise = _jax_noise(rng, [1], BATCH)
    return (batch, noise, float(loss), metrics,
            sam2_state_dict_from_jax(grads, {}))


def test_loss_fn_and_its_gradients_match_jax(tiny_sam2, jax_loss_and_grads):
    *_, port = tiny_sam2
    batch, noise, want_loss, want_metrics, want_grads = jax_loss_and_grads
    loss, metrics, grads = _port_loss_and_grads(port, batch, noise,
                                                port_losses.SAM2Loss())
    np.testing.assert_allclose(loss.item(), want_loss, **FP32)
    assert set(metrics) == set(want_metrics) - {"loss"}
    for name, value in metrics.items():
        np.testing.assert_allclose(value.item(), float(want_metrics[name]),
                                   err_msg=name, **FP32)
    assert set(grads) == set(want_grads)
    for name, grad in grads.items():
        np.testing.assert_allclose(as_np(grad), as_np(want_grads[name]),
                                   err_msg=name, **FP32)
    # the refinement's mask prompt, the memory encoder and the memory keys
    # carry gradient
    for name in ("prompt_encoder.mask_downscaling.0.weight",
                 "memory_encoder.out_proj.weight",
                 "memory_attention.layers.0.cross_attn_image.k_proj.weight",
                 "image_encoder.trunk.blocks.3.attn.qkv.weight"):
        assert as_np(grads[name]).any(), name


def test_a_detached_mask_prompt_would_fail_the_gradient_check(
        tiny_sam2, jax_loss_and_grads):
    """The control of the test above: in the JAX loop each refinement pass's
    loss reaches back through the mask prompt, and cutting that path moves
    some gradient past the tolerance."""
    *_, port = tiny_sam2
    batch, noise, _, _, want_grads = jax_loss_and_grads
    _, _, grads = _port_loss_and_grads(port, batch, noise,
                                       port_losses.SAM2Loss(),
                                       detach_prompt=True)
    assert any(not np.allclose(as_np(g), as_np(want_grads[n]), **FP32)
               for n, g in grads.items())


def test_checkpointing_gives_the_same_gradients(tiny_sam2,
                                                jax_loss_and_grads):
    *_, port = tiny_sam2
    batch, noise, *_ = jax_loss_and_grads
    remat = port_sam2.SAM2Video(use_gradient_checkpoint=True, use_scan=True,
                                **TINY)
    remat.load_state_dict(port.state_dict())
    loss, _, grads = _port_loss_and_grads(port, batch, noise,
                                          port_losses.SAM2Loss())
    loss_remat, _, grads_remat = _port_loss_and_grads(
        remat, batch, noise, port_losses.SAM2Loss())
    assert loss.item() == loss_remat.item()
    for name, grad in grads.items():
        torch.testing.assert_close(grads_remat[name], grad, rtol=1e-6,
                                   atol=1e-7)


def test_frame0_prompts_track_without_refinement(tiny_sam2):
    """The stage-1 recipe's batch (frame-0 points, SAM2VideoCollater): the
    same loss as the JAX tool's, with no condition frame after frame 0 and
    no click drawn."""
    jnet, flat, constants, port = tiny_sam2
    np.random.seed(3)
    batch = port_data.SAM2VideoCollater(resize=IMAGE, frame_nums=FRAMES)(
        _samples(seed=2))
    loss_fn = jax_tool.build_loss_fn(jnet, _Config(jax_losses.SAM2Loss()))
    want, _ = jax.jit(loss_fn)(unflatten(flat),
                               {"constants": unflatten(constants)},
                               _jax_batch(batch), jax.random.PRNGKey(0))
    loss, _, _ = _port_loss_and_grads(port, batch, [],
                                      port_losses.SAM2Loss())
    np.testing.assert_allclose(loss.item(), float(want), **FP32)


def test_frame_roles_must_be_host_values(tiny_sam2):
    *_, port = tiny_sam2
    flags = port_sam2._host_flags(torch.tensor([1.0, 0.0, 1.0]), 3)
    assert flags == [True, False, True]
    assert port_sam2._host_flags(None, 2) == [False, False]
    meta = torch.zeros(3, device="meta")
    with pytest.raises(ValueError):
        port_sam2._host_flags(meta, 3)


def test_only_the_hiera_encoder_is_ported():
    """Not only: a SAM2Video on a DINOv3 ViT-S/16 encoder (64^2, 16 tokens)
    equals the JAX one on two frames, frame 0 prompted with a point (masks,
    IoU predictions, object scores); and the compute dtype follows
    autocast, so ``dtype`` takes bf16 or fp32 alone."""
    kw = dict(image_size=64, fpn_planes=32, memory_planes=16,
              memory_mask_nums=3, max_object_pointers=4,
              image_encoder_type="dinov3_vit_small_patch16_backbone")
    jnet = jax_sam2.SAM2Video(**kw)
    port = port_sam2.SAM2Video(**kw)
    prompts = {"prompt_point": np.array([[[20.0, 30.0, 1.0]]] * 2,
                                        np.float32),
               "prompt_box": None, "prompt_mask": None}
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                            jnp.zeros((2, 2, 64, 64, 3)), prompts)
    flat = random_flat(shapes["params"], seed=31)
    constants = random_flat(shapes["constants"], seed=32)
    port.load_state_dict(sam2_state_dict_from_jax(flat, constants))
    x = np.random.RandomState(33).rand(2, 2, 64, 64, 3).astype(np.float32)
    want = jax.jit(jnet.apply)({"params": unflatten(flat),
                                "constants": unflatten(constants)}, x,
                               prompts)
    with torch.no_grad():
        got = port(torch.from_numpy(x.transpose(0, 1, 4, 2, 3).copy()),
                   {k: None if v is None else torch.from_numpy(v)
                    for k, v in prompts.items()})
    for g, w in zip(got, want):
        np.testing.assert_allclose(as_np(g), as_np(w), **FP32)
    assert as_np(got[0]).std() > 1e-2
    with pytest.raises(ValueError):
        port_sam2.SAM2Video(dtype=torch.float16, **TINY)
    port_sam2.SAM2Video(dtype=torch.bfloat16, use_scan=True, **TINY)


@pytest.mark.parametrize("name,kwargs", [
    ("SAM2Loss", {}), ("SAM2Loss", {"supervise_all_iou": False,
                                    "object_score_loss_weight": 0.5}),
    ("SAM2MultiLevelLoss", {}),
])
def test_sam2_losses_match_jax(name, kwargs):
    rs = np.random.RandomState(6)
    masks = 3 * rs.standard_normal((2, 3, 4, 16, 16)).astype(np.float32)
    ious = rs.rand(2, 3, 4).astype(np.float32)
    obj = 2 * rs.standard_normal((2, 3, 1)).astype(np.float32)
    target = (rs.rand(2, 3, 16, 16) > 0.6).astype(np.float32)
    target[1, 2] = 0.0                  # the object gone on one frame
    want = getattr(jax_losses, name)(**kwargs)(
        tuple(jnp.asarray(a) for a in (masks, ious, obj)), jnp.asarray(target))
    got = getattr(port_losses, name)(**kwargs)(
        tuple(torch.from_numpy(a) for a in (masks, ious, obj)),
        torch.from_numpy(target))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]),
                                   rtol=1e-6, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("seed", [0, 5, 16, 22])
def test_batch_collater_matches_jax(seed):
    """The same clips and np.random seed: the same batch as the JAX
    condition-frame collater (cv2), frames upsampled from 48 x 64; the seeds
    cover each prompt kind and frame pattern."""
    samples = _samples(3, 4, (48, 64), seed=3)
    np.random.seed(seed)
    got = port_data.SAM2VideoBatchCollater(resize=IMAGE, frame_nums=4)(samples)
    np.random.seed(seed)
    want = jax_data.SAM2VideoBatchCollater(resize=IMAGE, frame_nums=4)(samples)
    assert set(got) == set(want)
    assert got["image"].shape == (3, 4, 3, IMAGE, IMAGE)
    assert got["prompt_mask"].shape == (3, 4, 1, IMAGE // 4, IMAGE // 4)
    np.testing.assert_allclose(
        got["image"].numpy().transpose(0, 1, 3, 4, 2), want["image"], rtol=0,
        atol=1e-4)
    np.testing.assert_array_equal(
        got["prompt_mask"].numpy().transpose(0, 1, 3, 4, 2),
        want["prompt_mask"])
    for key in ("mask", "prompt_point", "prompt_box", "prompt_box_valid",
                "prompt_mask_valid", "is_cond_frame", "is_iter_frame"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)


@pytest.mark.parametrize("seed", [0, 1])
def test_frame0_collater_matches_jax(seed):
    samples = _samples(3, 2, (64, 40), seed=4)
    np.random.seed(seed)
    got = port_data.SAM2VideoCollater(resize=IMAGE, frame_nums=2,
                                      n_points=3)(samples)
    np.random.seed(seed)
    want = jax_data.SAM2VideoCollater(resize=IMAGE, frame_nums=2,
                                      n_points=3)(samples)
    np.testing.assert_allclose(
        got["image"].numpy().transpose(0, 1, 3, 4, 2), want["image"], rtol=0,
        atol=1e-4)
    for key in ("mask", "prompt_point"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], key)


def test_synthetic_clips_are_seeded_moving_discs():
    ds = SyntheticSAM2VideoDataset(3, 4, (48, 64), seed=9)
    a, b = ds[1], ds[1]
    assert a["images"].shape == (4, 48, 64, 3) and a["masks"].shape == (4, 48, 64)
    assert np.array_equal(a["images"], b["images"])
    assert not np.array_equal(ds[0]["images"], a["images"])
    assert set(np.unique(a["masks"])) <= {0.0, 1.0} and a["masks"][0].any()
    assert not np.array_equal(a["masks"][0], a["masks"][-1])   # it moves


def test_a_jax_adamw_state_of_sam2_steps_as_jax_does(tiny_sam2):
    """One AdamW update from a mid-run JAX state carried across by
    ``optimizer_state_from_jax(model="sam2")`` equals JAX's update; carried
    onto Hiera heads padded to 64, the moments' pads are 0."""
    _, flat, _, port = tiny_sam2
    rs = np.random.RandomState(10)
    like = lambda scale: {n: (scale * rs.standard_normal(v.shape)).astype(
        np.float32) for n, v in flat.items()}
    mu, nu = like(0.1), {n: v ** 2 for n, v in like(0.1).items()}
    grads = like(1.0)

    class config:
        optimizer = OPTIMIZER
        scheduler = ("CosineLR", {"warm_up_epochs": 1, "min_lr": 1e-6})
        epochs = 3
    # JAX's update on the memory attention and the mask decoder (AdamW is
    # elementwise, its rules per parameter; the tree is cut for time)
    part = {n: v for n, v in flat.items()
            if n.startswith(("memory_attention.", "mask_decoder."))}
    params = unflatten(part)
    tx, _ = jax_optimizers.build_optimizer(config, params, 2)
    state = tx.init(params)
    state = type(state)(jnp.asarray(3, jnp.int32),
                        unflatten({n: mu[n] for n in part}),
                        unflatten({n: nu[n] for n in part}))
    updates, state = jax.jit(tx.update)(
        unflatten({n: grads[n] for n in part}), state, params)
    want = sam2_state_dict_from_jax(dict(zip(
        leaf_path_names(params), (np.asarray(p + u) for p, u in zip(
            jax.tree_util.tree_leaves(params),
            jax.tree_util.tree_leaves(updates))))), {})

    model = port_sam2.SAM2Video(**TINY)
    model.load_state_dict(port.state_dict())
    optimizer, _ = build_optimizer(config, model, 2)
    optimizer.load_state_dict(optimizer_state_from_jax(3, model="sam2",
                                                       mu=mu, nu=nu))
    by_name = sam2_state_dict_from_jax(grads, {})
    optimizer.update([by_name[n] for n in optimizer.names], torch.tensor(True))
    assert int(optimizer.step) == int(state.step) == 4
    named = dict(model.named_parameters())
    assert set(want) < set(named) and len(want) > 50
    for name, value in want.items():
        np.testing.assert_allclose(as_np(named[name]), as_np(value),
                                   rtol=0, atol=5e-6, err_msg=name)
    carried = optimizer_state_from_jax(
        0, model="sam2", head_dim_padding=64,
        mu={n: np.ones_like(v) for n, v in flat.items()})["mu"]
    wide = port_sam2.SAM2Video(head_dim_padding=64, **TINY)
    qkv = "image_encoder.trunk.blocks.0.attn.qkv.weight"
    assert carried[qkv].shape == wide.state_dict()[qkv].shape
    heads = carried[qkv].reshape(3, 1, 64, -1)
    assert bool((heads[:, :, :56] == 1).all()) and not heads[:, :, 56:].any()


def test_a_config_loads_its_stage_checkpoint_when_the_file_exists(tmp_path):
    """The 14.1 configs' ``trained_model_path``: through the model type's
    own ``load_pretrained`` (``load_sam2_checkpoint``, heads padded to the
    model's width) after the seeded init when the file exists, the seeded
    init alone when not."""
    tiny = dict(TINY, head_dim_padding=64)
    source = init_model(port_sam2.SAM2Video(**TINY), 3, "cpu")
    path = tmp_path / "best.pth"
    torch.save(source.state_dict(), path)
    for checkpoint in (path, tmp_path / "missing.pth"):
        model = port_sam2.SAM2Video(**tiny)
        load_state_dict(str(checkpoint), model)
        model = apply_pretrained(init_model(model, 0, "cpu"))
        seeded = init_model(port_sam2.SAM2Video(**tiny), 0, "cpu")
        name = "mask_decoder.iou_prediction_head.layers.0.weight"
        want = source if checkpoint == path else seeded
        assert torch.equal(model.state_dict()[name], want.state_dict()[name])
    qkv = model.state_dict()["image_encoder.trunk.blocks.0.attn.qkv.weight"]
    assert qkv.shape[0] == 3 * 64


TRAIN_CONFIG = """
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation import losses
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.datasets.sam2_video_segmentation_dataset import (
    SAM2VideoBatchCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.datasets.syntheticdataset import (
    SyntheticSAM2VideoDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models import (
    sam2_hiera_tiny_video)


class config:
    model = sam2_hiera_tiny_video(
        image_size=128, block_nums=(1, 1, 2, 1),
        window_specification=(4, 2, 4, 2), global_attention_blocks=(3,),
        use_gradient_checkpoint=True, use_scan=True,
        use_high_res_features=True, use_flash_attention=True,
        head_dim_padding=64, memory_cond_slots=2)
    train_criterion = losses.SAM2Loss()
    train_dataset = SyntheticSAM2VideoDataset(n=4, frame_nums=3,
                                              image_size=(96, 128), seed=0)
    train_collater = SAM2VideoBatchCollater(resize=128, frame_nums=3,
                                            n_points=2)
    decoder_point_iters = 2
    seed = 0
    batch_size = 2
    num_workers = 0
    optimizer = ("AdamW", {{"lr": 5e-5, "global_weight_decay": False,
                           "weight_decay": 1e-4,
                           "no_weight_decay_layer_name_list": []}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 1, "min_lr": 1e-6}})
    epochs = {epochs}
    print_interval = 1
    use_amp = False
"""


def test_train_cli_runs_saves_and_resumes_on_the_cpu(tmp_path):
    (tmp_path / "train_config.py").write_text(TRAIN_CONFIG.format(epochs=2))
    first = train_tool.main(["--work-dir", str(tmp_path)], device="cpu")
    assert first["resumed_from"] is None
    assert [e["epoch"] for e in first["epochs"]] == [1, 2]
    assert all(e["skipped"] == 0 and np.isfinite(e["loss_avg"])
               and np.isfinite(e["object_score_loss_avg"])
               for e in first["epochs"])
    log = (tmp_path / "log" / "train.log").read_text()
    assert "epoch 2 iter 2/2 lr" in log and "object_score_loss" in log
    for name in ("latest.pth", "best.pth"):
        assert (tmp_path / "checkpoints" / name).is_file()
    (tmp_path / "train_config.py").write_text(TRAIN_CONFIG.format(epochs=3))
    again = train_tool.main(["--work-dir", str(tmp_path)], device="cpu")
    assert again["resumed_from"] == 2
    assert [e["epoch"] for e in again["epochs"]] == [3]
    assert "resumed from epoch 2" in (tmp_path / "log" / "train.log").read_text()
    latest = torch.load(tmp_path / "checkpoints" / "latest.pth",
                        weights_only=False)
    assert latest["epoch"] == 3 and int(
        latest["optimizer_state_dict"]["step"]) == 6


def test_train_cli_asks_for_the_card_by_default(tmp_path, monkeypatch):
    (tmp_path / "train_config.py").write_text(TRAIN_CONFIG.format(epochs=1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        train_tool.main(["--work-dir", str(tmp_path)])
