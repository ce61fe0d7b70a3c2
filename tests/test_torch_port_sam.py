"""The port's SAM (interactive segmentation inference) against the JAX
package's flax SAM.

Same weights (random flax parameters, mapped by sam_state_dict_from_jax),
same numpy inputs (images NHWC for JAX, NCHW for the port), fp32 on the CPU,
where the JAX package runs its rel-pos attention through the off-TPU
composition and the port through the kernels' plain versions. Tolerances:
the whole model (image embedding, mask logits, IoU predictions) atol 2e-3 /
rtol 1e-3, as the JAX package's torch-parity tests; single layers atol
1e-4 / rtol 1e-4 (another summation order only). The weight map is held
exact against the JAX package's convert_sam_state_dict.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.interactive_segmentation.models.segment_anything import (
    image_encoder as jax_enc, sam as jax_sam)
from simpleaicv_pytorch_training_examples_tpu.utils.torch_convert import (
    convert_sam_state_dict)
from simpleaicv_pytorch_training_examples_tpu_torch.interactive_segmentation.models.segment_anything import (
    image_encoder as port_enc, sam as port_sam)
from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
    predict_interactive_segmentation as predict_tool)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.checkpoint import (
    load_sam_checkpoint)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    sam_state_dict_from_jax, vit_state_dict_from_jax)
from torch_port_helpers import random_flat, unflatten
from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

FP32 = dict(rtol=1e-3, atol=2e-3)
LAYER_FP32 = dict(rtol=1e-4, atol=1e-4)
IMAGE = 128
TINY = dict(image_size=IMAGE, patch_size=16,
            image_encoder_block_nums=2, image_encoder_head_nums=2,
            image_encoder_global_attn_indexes=(1,),
            prompt_encoder_embedding_planes=64, use_flash_attention=True)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jit(jnet, method, **static):
    """One compiled program for a flax method (op-by-op dispatch of the
    tiny model costs more than its compile)."""
    return jax.jit(functools.partial(jnet.apply, method=method, **static))


def _images(b=2, seed=0):
    return np.random.RandomState(seed).rand(b, IMAGE, IMAGE, 3).astype(
        np.float32)


def _prompts(kind, b=2):
    """(JAX prompts, port prompts) of one kind; the points carry a -1 pad."""
    pts = np.array([[[40.0, 40.0, 1.0], [-1.0, -1.0, -1.0]],
                    [[80.0, 60.0, 1.0], [20.0, 20.0, 0.0]]], np.float32)[:b]
    boxes = np.array([[10, 10, 90, 90], [30, 20, 120, 100]], np.float32)[:b]
    rs = np.random.RandomState(5)
    masks = rs.standard_normal((b, IMAGE // 4, IMAGE // 4, 1)).astype(
        np.float32)
    j, p = {}, {}
    if "point" in kind:
        j["prompt_point"], p["prompt_point"] = pts, pts
    if "box" in kind:
        valid = np.array([1.0, 0.0], np.float32)[:b]
        j["prompt_box"], p["prompt_box"] = boxes, boxes
        j["prompt_box_valid"], p["prompt_box_valid"] = valid, valid
    if "mask" in kind:
        valid = np.array([1.0, 0.0], np.float32)[:b]
        j["prompt_mask"] = masks
        p["prompt_mask"] = masks.transpose(0, 3, 1, 2)
        j["prompt_mask_valid"], p["prompt_mask_valid"] = valid, valid
    j = {k: jnp.asarray(v) for k, v in j.items()}
    j.setdefault("prompt_box", None)
    j.setdefault("prompt_mask", None)
    j.setdefault("prompt_point", None)
    p = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in p.items()}
    return j, p


def _build(planes):
    """A tiny JAX SAM and its port with the same random weights."""
    jnet = jax_sam.SAM(image_encoder_embedding_planes=planes, **TINY)
    j_prompts, _ = _prompts("point")
    variables = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                               jnp.zeros((1, IMAGE, IMAGE, 3)), j_prompts)
    flat = random_flat(variables["params"], seed=planes)
    constants = random_flat(variables["constants"], seed=planes + 1)
    port = port_sam.SAM(image_encoder_embedding_planes=planes, **TINY)
    port.load_state_dict(sam_state_dict_from_jax(flat, constants))
    variables = {"params": unflatten(flat), "constants": unflatten(constants)}
    return jnet, variables, port.eval(), flat, constants


@pytest.fixture(scope="module")
def sam_k3():
    """Embedding 128, 2 heads of 64: the windowed block takes K3's route."""
    return _build(128)


@pytest.fixture(scope="module")
def embeddings(sam_k3):
    jnet, variables, port, _, _ = sam_k3
    x = _images()
    want = _jit(jnet, jax_sam.SAM.forward_image_encoder)(variables,
                                                         jnp.asarray(x))
    with torch.no_grad():
        got = port.forward_image_encoder(torch.from_numpy(
            x.transpose(0, 3, 1, 2).copy()))
    return want, got


def test_weight_map_is_the_exact_inverse_of_the_converter(sam_k3):
    _, _, port, flat, constants = sam_k3
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    params, consts = convert_sam_state_dict(sd)
    assert set(params) == set(flat) and set(consts) == set(constants)
    for name, value in flat.items():
        assert params[name].shape == value.shape, name
        assert np.array_equal(params[name], value), name
    for name, value in constants.items():
        assert np.array_equal(consts[name], value), name
    # and every port tensor came from the JAX tree
    assert set(sam_state_dict_from_jax(flat, constants)) == set(sd)


def test_image_encoder_matches_jax(embeddings):
    want, got = embeddings
    assert got.shape == (2, 64, IMAGE // 16, IMAGE // 16)
    np.testing.assert_allclose(as_np(got), as_np(want).transpose(0, 3, 1, 2),
                               **FP32)


def test_image_encoder_k4_route_matches_jax():
    """Embedding 80, 2 heads of 40: every block takes K4's route."""
    jnet, variables, port, _, _ = _build(80)
    x = _images(b=1, seed=3)
    want = _jit(jnet, jax_sam.SAM.forward_image_encoder)(variables,
                                                         jnp.asarray(x))
    with torch.no_grad():
        got = port.forward_image_encoder(torch.from_numpy(
            x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(as_np(got), as_np(want).transpose(0, 3, 1, 2),
                               **FP32)


@pytest.mark.parametrize("kind", ["point", "box", "point+box",
                                  "point+mask"])
def test_prompt_encoder_and_mask_decoder_match_jax(sam_k3, embeddings, kind):
    jnet, variables, port, _, _ = sam_k3
    j_emb, p_emb = embeddings
    j_prompts, p_prompts = _prompts(kind)
    want_masks, want_iou = _jit(
        jnet, jax_sam.SAM.forward_prompt_encoder_mask_decoder)(
            variables, j_emb, j_prompts)
    with torch.no_grad():
        masks, iou = port.forward_prompt_encoder_mask_decoder(p_emb,
                                                              p_prompts)
    assert masks.shape == (2, 4, IMAGE, IMAGE) and iou.shape == (2, 4)
    np.testing.assert_allclose(as_np(masks), as_np(want_masks), **FP32)
    np.testing.assert_allclose(as_np(iou), as_np(want_iou), **FP32)


def test_one_embedding_serves_a_batch_of_prompts_and_mask_out_idxs(sam_k3,
                                                                   embeddings):
    jnet, variables, port, _, _ = sam_k3
    j_emb, p_emb = embeddings
    j_prompts, p_prompts = _prompts("point")
    want_masks, want_iou = _jit(
        jnet, jax_sam.SAM.forward_prompt_encoder_mask_decoder,
        mask_out_idxs=(0,))(variables, j_emb[:1], j_prompts)
    with torch.no_grad():
        masks, iou = port.forward_prompt_encoder_mask_decoder(
            p_emb[:1], p_prompts, (0,))
    assert masks.shape == (2, 1, IMAGE, IMAGE)
    np.testing.assert_allclose(as_np(masks), as_np(want_masks), **FP32)
    np.testing.assert_allclose(as_np(iou), as_np(want_iou), **FP32)


@pytest.mark.parametrize("h,w,c,heads,window", [
    (14, 14, 128, 2, True),     # K3's route: head dim 64, c % 128 == 0
    (14, 14, 80, 2, True),      # K4's route: head dim 40
    (40, 32, 64, 1, False),     # K5's route: 1280 tokens, a multiple of 128
])
def test_sam_attention_routes_match_jax(h, w, c, heads, window):
    rs = np.random.RandomState(h + c)
    x = rs.standard_normal((2, h, w, c)).astype(np.float32)
    jmod = jax_enc.SAMAttention(heads, (h, w), use_flash=True)
    params = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    flat = random_flat(params, seed=1)
    want = jmod.apply({"params": unflatten(flat)}, jnp.asarray(x))
    port = port_enc.SAMAttention(c, heads, (h, w), use_flash=True)
    port.load_state_dict(vit_state_dict_from_jax(flat))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(as_np(got), as_np(want), **LAYER_FP32)


def test_window_partition_pads_after_the_norm_and_round_trips():
    x = np.random.RandomState(2).standard_normal((2, 9, 11, 3)).astype(
        np.float32)
    want, want_pad = jax_enc.window_partition(jnp.asarray(x), 4)
    got, pad = port_enc.window_partition(torch.from_numpy(x), 4)
    assert pad == tuple(want_pad) == (12, 12)
    np.testing.assert_array_equal(as_np(got), as_np(want))
    back = port_enc.window_unpartition(got, 4, pad, (9, 11))
    np.testing.assert_array_equal(back.numpy(), x)


def test_rel_pos_table_and_layer_norm_2d_match_jax():
    rs = np.random.RandomState(4)
    table = rs.standard_normal((27, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        port_enc.get_rel_pos(14, 14, torch.from_numpy(table)).numpy(),
        as_np(jax_enc.get_rel_pos(14, 14, jnp.asarray(table))))
    x = (3.0 * rs.standard_normal((2, 5, 6, 16)) + 1.0).astype(np.float32)
    weight = (1.0 + 0.1 * rs.standard_normal(16)).astype(np.float32)
    bias = (0.1 * rs.standard_normal(16)).astype(np.float32)
    want = jax_enc.LayerNorm2d().apply(
        {"params": {"weight": weight, "bias": bias}}, jnp.asarray(x))
    norm = port_enc.LayerNorm2d(16)
    norm.load_state_dict({"weight": torch.from_numpy(weight),
                          "bias": torch.from_numpy(bias)})
    got = norm(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(got.detach().numpy().transpose(0, 2, 3, 1),
                               as_np(want), **LAYER_FP32)


def test_bilinear_upsampling_matches_jax_image_resize():
    x = np.random.RandomState(6).standard_normal((2, 3, 8, 8)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 3, 32, 32), "bilinear")
    got = torch.nn.functional.interpolate(torch.from_numpy(x), (32, 32),
                                          mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got.numpy(), as_np(want), rtol=0, atol=1e-6)


def test_checkpoints_load_whole_or_encoder_only(sam_k3, tmp_path):
    _, _, port, _, _ = sam_k3
    sd = port.state_dict()
    whole, encoder = tmp_path / "whole.pth", tmp_path / "encoder.pth"
    torch.save({"model_state_dict": sd}, whole)
    enc = {k: v for k, v in sd.items() if k.startswith("image_encoder.")}
    torch.save(enc, encoder)
    total = len(sd)
    fresh = lambda: port_sam.SAM(image_encoder_embedding_planes=128, **TINY)
    model = fresh()
    assert load_sam_checkpoint(model, str(whole)) == (total, total)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    model = fresh()
    before = model.mask_decoder.iou_token.weight.clone()
    assert load_sam_checkpoint(model, str(encoder)) == (len(enc), total)
    assert torch.equal(model.image_encoder.pos_embed,
                       sd["image_encoder.pos_embed"])
    assert torch.equal(model.mask_decoder.iou_token.weight, before)
    with pytest.raises(FileNotFoundError):
        load_sam_checkpoint(fresh(), str(tmp_path / "missing.pth"))


def test_predict_tool_runs_on_the_cpu(capsys):
    run = predict_tool.main(
        ["--network", "sam_b", "--synthetic", "--device", "cpu",
         "--batch-size", "2"],
        model_kw=dict(image_size=IMAGE, image_encoder_block_nums=2,
                      image_encoder_global_attn_indexes=(1,)))
    printed = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("{")]
    assert [line["prompt"] for line in run["lines"]] == [
        "point", "box", "point+box"]
    assert len(printed) == 3
    for line in run["lines"]:
        assert np.isfinite(line["iou_predictions"]).all()
        assert np.array(line["iou_predictions"]).shape == (2, 4)
        assert np.array(line["mask_areas"]).shape == (2, 4)
        assert line["encoder_ms"] > 0 and line["decoder_ms"] > 0
    assert run["embedding"].shape == (2, 256, IMAGE // 16, IMAGE // 16)
    masks, _ = run["outputs"]["point"]
    assert masks.shape == (2, 4, IMAGE, IMAGE)


def test_predict_tool_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        predict_tool.main(["--synthetic"])


def test_synthetic_image_and_canvas():
    image = predict_tool.synthetic_image()
    assert image.shape == (640, 640, 3) and image.dtype == np.float32
    assert np.array_equal(image[320, 320], [220.0, 200.0, 60.0])
    assert image[5, 5].max() < 60.0
    canvas, factor = predict_tool.prep_canvas(image[:, :320], 128)
    assert canvas.shape == (3, 128, 128) and factor == 0.2
    assert float(canvas[:, :, 64:].abs().max()) == 0.0   # zero padding
    assert 0.0 <= float(canvas.min()) and float(canvas.max()) <= 1.0
