"""The port's SAM2 video tracker (inference) against the JAX package's flax
SAM2.

A tiny SAM2 (128^2, Hiera with embedding 56 and one head, so every head is
Hiera's real width 56; FPN 32, memory 16, 3 memory slots, 4 pointer slots,
the high-res skips on) with the same random weights on both sides (flax
parameters mapped by ``sam2_state_dict_from_jax``), the same numpy inputs
(NHWC for JAX, NCHW for the port), fp32 on the CPU, where the JAX package
runs its attention through its off-TPU fallbacks and the port through the
kernels' plain versions. ``_FLASH_MIN_KV`` is patched to 1 in both
packages where a test says so, so that the tiny blocks take K6's route
(JAX's own comment asks for that in tests). Tolerances: the encoder's
features and positions, memory attention, the memory encoder, IoUs, object
logits and every floating field of the carry atol 1e-4 / rtol 1e-4
(another summation order only); the upsampled mask logits atol 1e-3, as
``tests/test_sam2_stream.py`` holds the JAX stream; integer carry fields
and the weight map's round trip exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.utils.torch_convert import (
    convert_sam2_state_dict)
from simpleaicv_pytorch_training_examples_tpu.video_interactive_segmentation.models.segment_anything2 import (
    image_encoder as jax_enc, memory as jax_mem)
from simpleaicv_pytorch_training_examples_tpu.video_interactive_segmentation.models.segment_anything2.sam2_stream import (
    SAM2VideoStream as JaxStream)
from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
    predict_video_interactive_segmentation as predict_tool)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.checkpoint import (
    load_sam2_checkpoint)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    sam2_state_dict_from_jax)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models.segment_anything2 import (
    image_encoder as port_enc, memory as port_mem)
from simpleaicv_pytorch_training_examples_tpu_torch.video_interactive_segmentation.models.segment_anything2.sam2_stream import (
    SAM2VideoStream as PortStream)
from torch_port_helpers import random_flat, unflatten
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

IMAGE = 128
TINY = dict(image_size=IMAGE, embedding_planes=56, head_nums=1,
            block_nums=(1, 1, 2, 1), window_specification=(4, 2, 4, 2),
            global_attention_blocks=(3,), fpn_planes=32, memory_planes=16,
            memory_mask_nums=3, max_object_pointers=4,
            use_high_res_features=True, use_flash_attention=True)
LAYER = dict(rtol=1e-4, atol=1e-4)
MASKS = dict(rtol=0, atol=1e-3)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def nchw(x):
    return np.asarray(x).transpose(0, 3, 1, 2)


def _jit(jnet, method, **static):
    return jax.jit(functools.partial(jnet.apply, method=method, **static))


@pytest.fixture
def flash_min_kv_1(monkeypatch):
    """Send every block with a key to K6's route, in both packages."""
    monkeypatch.setattr(jax_enc, "_FLASH_MIN_KV", 1)
    monkeypatch.setattr(port_enc, "_FLASH_MIN_KV", 1)


def _frames(n, seed=0):
    return np.random.RandomState(seed).rand(n, IMAGE, IMAGE, 3).astype(
        np.float32)


def _jax_params(head_dim_padding, seed, memory_cond_slots=1):
    jnet = JaxStream(head_dim_padding=head_dim_padding,
                     memory_cond_slots=memory_cond_slots, **TINY)
    prompts = {"prompt_point": jnp.zeros((1, 1, 3)), "prompt_box": None,
               "prompt_mask": None}
    variables = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                               jnp.zeros((1, 2, IMAGE, IMAGE, 3)), prompts)
    return (jnet, random_flat(variables["params"], seed),
            random_flat(variables["constants"], seed + 1))


@functools.lru_cache(maxsize=None)
def _models(head_dim_padding, memory_cond_slots=1):
    """The tiny JAX tracker, its variables, the port with the same weights,
    and the flat JAX parameters and constants."""
    jnet, flat, consts = _jax_params(head_dim_padding, 7, memory_cond_slots)
    port = PortStream(head_dim_padding=head_dim_padding,
                      memory_cond_slots=memory_cond_slots, **TINY)
    port.load_state_dict(sam2_state_dict_from_jax(flat, consts,
                                                  head_dim_padding))
    variables = {"params": unflatten(flat), "constants": unflatten(consts)}
    return jnet, variables, port.eval(), flat, consts


@pytest.mark.parametrize("hdp", [0, 64])
def test_weight_map_is_the_exact_inverse_of_the_converter(hdp):
    _, _, port, flat, consts = _models(hdp)
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, constants = convert_sam2_state_dict(sd)
    assert set(params) == set(flat) and set(constants) == set(consts)
    for name, value in flat.items():
        assert params[name].shape == value.shape, name
        assert np.array_equal(params[name], value), name
    for name, value in consts.items():
        assert np.array_equal(constants[name], value), name
    assert set(sam2_state_dict_from_jax(flat, consts, hdp)) == set(sd)


def test_weight_map_pads_56_wide_heads_as_the_converter_does(tmp_path):
    """Reference-width (56) weights into a model with 64-wide heads: the map,
    the checkpoint loader and the JAX converter give the same tensors."""
    _, _, port0, flat0, consts0 = _models(0)
    reference = {k: v.numpy() for k, v in port0.state_dict().items()}
    padded, _ = convert_sam2_state_dict(reference, head_dim_padding=64)
    want = sam2_state_dict_from_jax(padded, consts0)
    got = sam2_state_dict_from_jax(flat0, consts0, head_dim_padding=64)
    assert set(got) == set(want)
    for name, value in want.items():
        assert torch.equal(got[name], value), name
    path = tmp_path / "sam2_tiny.pth"
    torch.save(port0.state_dict(), path)
    port64 = PortStream(head_dim_padding=64, **TINY)
    loaded, total = load_sam2_checkpoint(port64, str(path))
    assert loaded == total
    for name, value in port64.state_dict().items():
        assert torch.equal(value, want[name]), name
    with pytest.raises(FileNotFoundError):
        load_sam2_checkpoint(port64, str(tmp_path / "missing.pth"))


@pytest.mark.parametrize("hdp,min_kv_1", [
    (0, False),     # K2's route (d = 56) and the plain pooled blocks
    (0, True),      # K6's route everywhere, pooled blocks with Nq != Nk
    (64, False),    # K1's route with sm_scale = 56^-0.5, plain pooled
    (64, True),     # K1's route and K6 on the pooled blocks
])
def test_image_encoder_matches_jax(hdp, min_kv_1, request):
    if min_kv_1:
        request.getfixturevalue("flash_min_kv_1")
    jnet, variables, port, _, _ = _models(hdp)
    x = _frames(2, seed=hdp + min_kv_1)
    want = jax.jit(functools.partial(
        jnet.apply, method=jnet.encode_frame))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port.encode_frame(torch.from_numpy(nchw(x).copy()))
    (jf, jp, (j4, j8)), (pf, pp, (p4, p8)) = want, got
    assert pf.shape == (2, 32, IMAGE // 16, IMAGE // 16)
    assert p4.shape == (2, 32, IMAGE // 4, IMAGE // 4)
    for name, a, b in (("stride 16", jf, pf), ("positions", jp, pp),
                       ("stride 4", j4, p4), ("stride 8", j8, p8)):
        np.testing.assert_allclose(as_np(b), nchw(a), **LAYER, err_msg=name)


def test_memory_attention_with_key_bias_and_pointers_matches_jax():
    rs = np.random.RandomState(3)
    b, c, m, grid = 2, 32, 16, (4, 4)
    n = grid[0] * grid[1]
    n_ptr = 8                       # 4 pointers of 2 tokens, not rotated
    curr, curr_pos = (rs.standard_normal((b, n, c)).astype(np.float32)
                      for _ in range(2))
    memory, memory_pos = (rs.standard_normal((b, 2 * n + n_ptr, m)).astype(
        np.float32) for _ in range(2))
    bias = np.zeros((b, 2 * n + n_ptr), np.float32)
    bias[0, n:2 * n] = -1e9         # image 0: its second slot is empty
    bias[1, -4:] = -1e9             # image 1: its last two pointers
    jmod = jax_mem.MemoryAttention(c, 2, grid, use_flash=True)
    args = [jnp.asarray(a) for a in (curr, memory, curr_pos, memory_pos)]
    params = jax.eval_shape(functools.partial(
        jmod.init, num_obj_ptr_tokens=n_ptr), jax.random.PRNGKey(0),
        *args)["params"]
    flat = {f"memory_attention.{k}": v
            for k, v in random_flat(params, seed=4).items()}
    want = jax.jit(functools.partial(jmod.apply, num_obj_ptr_tokens=n_ptr))(
        {"params": unflatten(flat)["memory_attention"]}, *args,
        key_bias=jnp.asarray(bias))
    port = port_mem.MemoryAttention(c, 2, grid, use_flash=True,
                                    memory_planes=m)
    port.load_state_dict({k[len("memory_attention."):]: v for k, v in
                          sam2_state_dict_from_jax(flat, {}).items()})
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (curr, memory, curr_pos,
                                                   memory_pos)),
                   num_obj_ptr_tokens=n_ptr, key_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(as_np(got), as_np(want), **LAYER)
    port.layers[0].cross_attn_image.use_flash = False   # the plain route
    with torch.no_grad():
        plain = port(*(torch.from_numpy(a) for a in (curr, memory, curr_pos,
                                                     memory_pos)),
                     num_obj_ptr_tokens=n_ptr, key_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(as_np(plain), as_np(want), **LAYER)


def test_memory_encoder_matches_jax():
    rs = np.random.RandomState(5)
    pix = rs.standard_normal((2, 8, 8, 32)).astype(np.float32)
    masks = (4 * rs.standard_normal((2, 128, 128, 1))).astype(np.float32)
    jmod = jax_mem.MemoryEncoder(32, 16)
    params = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.asarray(pix), jnp.asarray(masks))["params"]
    flat = {f"memory_encoder.{k}": v
            for k, v in random_flat(params, seed=6).items()}
    feat, pos = jax.jit(jmod.apply)(
        {"params": unflatten(flat)["memory_encoder"]}, jnp.asarray(pix),
        jnp.asarray(masks))
    port = port_mem.MemoryEncoder(32, 16)
    port.load_state_dict({k[len("memory_encoder."):]: v for k, v in
                          sam2_state_dict_from_jax(flat, {}).items()})
    with torch.no_grad():
        got_feat, got_pos = port(torch.from_numpy(nchw(pix).copy()),
                                 torch.from_numpy(nchw(masks).copy()))
    np.testing.assert_allclose(as_np(got_feat), nchw(feat), **LAYER)
    np.testing.assert_allclose(as_np(got_pos), nchw(pos), **LAYER)


def _assert_carry(jc, pc, label):
    assert set(jc) == set(pc)
    for name in jc:
        want, got = np.asarray(jc[name]), pc[name].numpy()
        if np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{label}: {name}")
        else:
            np.testing.assert_allclose(got, want, **LAYER,
                                       err_msg=f"{label}: {name}")


def _assert_outputs(want, got, label):
    (jm, ji, jo), (pm, pi, po) = want, got
    assert pm.shape == (1, 4, IMAGE, IMAGE)
    np.testing.assert_allclose(as_np(pm), as_np(jm), **MASKS,
                               err_msg=f"{label}: masks")
    np.testing.assert_allclose(as_np(pi), as_np(ji), **LAYER,
                               err_msg=f"{label}: ious")
    np.testing.assert_allclose(as_np(po), as_np(jo), **LAYER,
                               err_msg=f"{label}: object logits")


@pytest.mark.parametrize("hdp,cond_slots", [(0, 1), (64, 1), (64, 2)])
def test_tracking_matches_the_jax_stream(hdp, cond_slots, flash_min_kv_1):
    """start_track on a point, three tracked frames (the ring of the slots
    left after the condition slots wraps), add_prompt_frame and
    add_mask_frame mid-stream, one more tracked frame: outputs and every
    carry field after each step. With 2 condition slots (the 14.1 stage-2
    and stage-3 configs' setting) the prompted frame fills the second one
    and the mask frame overwrites it."""
    jnet, variables, port, _, _ = _models(hdp, cond_slots)
    encode = _jit(jnet, JaxStream.encode_frame)
    steps = {name: _jit(jnet, getattr(JaxStream, name)) for name in (
        "start_track", "track_frame", "add_prompt_frame", "add_mask_frame")}
    frames = _frames(7, seed=11)
    point = np.array([[[40.0, 44.0, 1.0]]], np.float32)
    prompt = {"prompt_point": np.array([[[60.0, 70.0, 1.0],
                                         [20.0, 30.0, 0.0]]], np.float32),
              "prompt_box": np.array([[10.0, 12.0, 100.0, 90.0]], np.float32),
              "prompt_box_valid": np.ones(1, np.float32)}
    yy, xx = np.mgrid[:IMAGE, :IMAGE]
    mask = (((xx - 70) ** 2 + (yy - 50) ** 2) < 30 ** 2)[None].astype(
        np.float32)
    j_prompt = {k: jnp.asarray(v) for k, v in prompt.items()}
    j_prompt["prompt_mask"] = None
    p_prompt = {k: torch.from_numpy(v) for k, v in prompt.items()}
    plan = ["start", "track", "track", "track", "prompt", "mask", "track"]
    jc = pc = None
    with torch.no_grad():
        for t, kind in enumerate(plan):
            jf, jp, jhr = encode(variables, jnp.asarray(frames[t:t + 1]))
            pf, pp, phr = port.encode_frame(torch.from_numpy(
                nchw(frames[t:t + 1]).copy()))
            if kind == "start":
                want, jc = steps["start_track"](
                    variables, jf, {"prompt_point": jnp.asarray(point),
                                    "prompt_box": None, "prompt_mask": None},
                    highres=jhr)
                got, pc = port.start_track(
                    pf, {"prompt_point": torch.from_numpy(point)},
                    highres=phr)
            elif kind == "track":
                want, jc = steps["track_frame"](variables, jf, jp, jc,
                                                highres=jhr)
                got, pc = port.track_frame(pf, pp, pc, highres=phr)
            elif kind == "prompt":
                want, jc = steps["add_prompt_frame"](variables, jf, j_prompt,
                                                     jc, highres=jhr)
                got, pc = port.add_prompt_frame(pf, p_prompt, pc,
                                                highres=phr)
            else:
                want, jc = steps["add_mask_frame"](
                    variables, jf, jnp.asarray(mask), jc, highres=jhr)
                got, pc = port.add_mask_frame(pf, torch.from_numpy(mask), pc,
                                              highres=phr)
            _assert_outputs(want, got, f"frame {t} ({kind})")
            _assert_carry(jc, pc, f"frame {t} ({kind})")
    assert int(pc["frame_idx"]) == len(plan)
    assert int(pc["cond_count"]) == 3 and int(pc["track_count"]) == 4
    # one condition slot ends with the last prompted frame (5); two keep
    # frame 0 and the last prompted frame
    want_cond = [5] if cond_slots == 1 else [0, 5]
    assert pc["mem_frame"][:cond_slots].tolist() == want_cond


def test_a_step_leaves_the_carry_it_was_given_unchanged():
    _, _, port, _, _ = _models(0)
    x = torch.from_numpy(nchw(_frames(2, seed=2)).copy())
    with torch.no_grad():
        feat, pos, hr = port.encode_frame(x[:1])
        _, carry = port.start_track(
            feat, {"prompt_point": torch.tensor([[[40.0, 40.0, 1.0]]])},
            highres=hr)
        before = {k: v.clone() for k, v in carry.items()}
        feat, pos, hr = port.encode_frame(x[1:])
        _, after = port.track_frame(feat, pos, carry, highres=hr)
    for name, value in before.items():
        assert torch.equal(carry[name], value), name
    assert int(after["frame_idx"]) == 2


def test_nearest_resize_is_nearest_exact_and_the_pos_embed_bicubic_is_jax():
    x = np.random.RandomState(8).standard_normal((1, 1, 16, 16)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 1, 4, 4),
                                       "nearest"))
    exact = torch.nn.functional.interpolate(torch.from_numpy(x), (4, 4),
                                            mode="nearest-exact")
    np.testing.assert_array_equal(exact.numpy(), want)
    plain = torch.nn.functional.interpolate(torch.from_numpy(x), (4, 4),
                                            mode="nearest")
    assert np.abs(plain.numpy() - want).max() > 0.1   # torch's "nearest"

    trunk = port_enc.Hiera(IMAGE, 8, 1, (1, 1, 1, 1), (14, 14), (4, 2, 2, 2),
                           ())
    pe = np.random.RandomState(9).standard_normal((1, 14, 14, 8)).astype(
        np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(pe), (1, 32, 32, 8),
                                       "bicubic"))
    got = torch.einsum("chw,hH,wW->cHW", torch.from_numpy(pe[0]).permute(
        2, 0, 1), trunk.pos_resize_h, trunk.pos_resize_w)
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(), want[0],
                               rtol=0, atol=1e-5)
    keys_075 = torch.nn.functional.interpolate(
        torch.from_numpy(pe).permute(0, 3, 1, 2), (32, 32), mode="bicubic",
        align_corners=False)
    assert np.abs(keys_075[0].permute(1, 2, 0).numpy() - want[0]).max() > 1e-3


def test_predict_tool_runs_on_the_cpu(capsys):
    run = predict_tool.main(
        ["--network", "sam2_hiera_tiny_video", "--synthetic", "--device",
         "cpu", "--max-frames", "3"],
        model_kw=dict(image_size=IMAGE, block_nums=(1, 1, 2, 1),
                      window_specification=(4, 2, 4, 2),
                      global_attention_blocks=(3,)))
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert len(printed) == 3
    assert [line["frame"] for line in run["lines"]] == [0, 1, 2]
    for line in run["lines"]:
        assert np.isfinite(line["iou_predictions"]).all()
        assert len(line["iou_predictions"]) == 4
        assert 0 <= line["mask_area"] <= IMAGE * IMAGE
        assert np.isfinite(line["object_score"])
        assert line["encode_ms"] > 0 and line["track_ms"] > 0
    masks, _, _ = run["outputs"][-1]
    assert masks.shape == (1, 4, IMAGE, IMAGE)
    assert int(run["carry"]["frame_idx"]) == 3


def test_predict_tool_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        predict_tool.main(["--synthetic"])


def test_synthetic_clip_moves_two_discs():
    clip = predict_tool.synthetic_clip(3)
    assert clip.shape == (3, 512, 512, 3) and clip.dtype == np.float32
    assert np.array_equal(clip[0, 256, 128], [220.0, 180.0, 60.0])
    assert np.array_equal(clip[2, 256, 144], [220.0, 180.0, 60.0])
    assert np.array_equal(clip[2, 256, 384 - 16], [60.0, 200.0, 220.0])
    assert clip[0, 5, 5].max() < 50.0
