"""The port's eval path: eval step against the JAX package's, the
work-dir CLI on the CPU, device resolution, and the port's independence
from JAX.

Tolerance of the eval-step logits: atol 2e-3 / rtol 1e-3 (fp32 model; both
sides round the images to bf16, as the eval step's compute dtype).
"""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu.engine import (
    TrainState, make_classification_eval_step as jax_eval_step)
from simpleaicv_pytorch_training_examples_tpu.models.backbones import vit as jax_vit
from simpleaicv_pytorch_training_examples_tpu_torch import resolve_device
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.syntheticdataset import (
    SyntheticClassificationDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
    init_model, make_classification_eval_step)
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones import vit
from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
    test_classification_model as port_cli)
from simpleaicv_pytorch_training_examples_tpu_torch.utils.jax_weights import (
    vit_state_dict_from_jax)
from torch_port_helpers import random_flat, unflatten

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "simpleaicv_pytorch_training_examples_tpu_torch"


@pytest.mark.parametrize("global_pool", [True, False])
def test_eval_step_matches_jax(global_pool):
    kwargs = dict(image_size=64, num_classes=10, global_pool=global_pool,
                  use_fused_attention=True)
    jax_model = jax_vit.ViT(16, 128, 2, 2, 4, **kwargs)
    port_model = vit.ViT(16, 128, 2, 2, 4, **kwargs)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)))["params"]
    flat = random_flat(shapes, 11)
    port_model.load_state_dict(vit_state_dict_from_jax(flat))

    rs = np.random.RandomState(12)
    images = rs.standard_normal((8, 64, 64, 3)).astype(np.float32)
    labels = rs.randint(0, 10, 8)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=unflatten(flat),
                       variables={}, opt_state=(), ema_params=None)
    want = jax_eval_step(jax_model)(
        state, {"image": jnp.asarray(images),
                "label": jnp.asarray(labels, jnp.int32)})
    got = make_classification_eval_step(port_model)(
        {"image": torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
         "label": torch.from_numpy(labels)})
    for w, g in zip(want[:2], got[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].dtype == torch.float32
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-3, atol=2e-3)


TINY_CONFIG = """
import torch

from simpleaicv_pytorch_training_examples_tpu_torch.classification import backbones
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.syntheticdataset import (
    SyntheticClassificationDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones.vit import ViT


class config:
    model = ViT(16, 128, 2, 2, image_size=64, num_classes=10,
                global_pool=True, dtype=torch.bfloat16,
                use_fused_attention=True)
    test_dataset = SyntheticClassificationDataset(n=20, image_size=64,
                                                  num_classes=10, seed=3)
    test_collater = ClassificationCollater()
    seed = 0
    batch_size = 8
    num_workers = 0
"""


def test_cli_evaluates_a_work_dir_on_cpu(tmp_path):
    (tmp_path / "test_config.py").write_text(TINY_CONFIG)
    result = port_cli.main(["--work-dir", str(tmp_path)], device="cpu")
    assert result["images"] == 20
    assert 0.0 <= result["top1"] <= result["top5"] <= 100.0
    log = (tmp_path / "log" / "test.log").read_text()
    n_params = sum(p.numel() for p in vit.ViT(
        16, 128, 2, 2, image_size=64, num_classes=10).parameters())
    assert f"model params: {n_params / 1e6:.3f} M" in log
    assert re.search(r"top1 \d+\.\d{3} top5 \d+\.\d{3} images/s [\d.]+ on cpu",
                     log)


def test_cli_without_cuda_raises_unless_cpu_is_asked_for(tmp_path,
                                                         monkeypatch):
    (tmp_path / "test_config.py").write_text(TINY_CONFIG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_cli.main(["--work-dir", str(tmp_path)])
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_init_model_is_seeded():
    def params(seed):
        model = init_model(vit.ViT(16, 64, 1, 1, image_size=32,
                                   num_classes=3), seed, "cpu")
        return torch.cat([p.flatten() for p in model.parameters()])
    a, b, c = params(0), params(0), params(1)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_collater_gives_nchw_float_and_int64_labels():
    dataset = SyntheticClassificationDataset(n=3, image_size=8,
                                             num_classes=4, seed=1)
    batch = ClassificationCollater()([dataset[i] for i in range(3)])
    assert batch["image"].shape == (3, 3, 8, 8)
    assert batch["image"].dtype == torch.float32
    assert batch["image"].is_contiguous()
    assert batch["label"].dtype == torch.int64
    np.testing.assert_array_equal(batch["image"][1].permute(1, 2, 0).numpy(),
                                  dataset[1]["image"])


def test_importing_the_port_pulls_in_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import simpleaicv_pytorch_training_examples_tpu_torch as port
        for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
            importlib.import_module(info.name)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "orbax",
                                            "simpleaicv_pytorch_training_examples_tpu"))
        print("BAD", bad)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_no_port_source_names_jax_or_the_jax_package():
    """The port's sources never name the JAX package; chip_smoke.py names its
    kernel files (what each port replaces) but imports none of it."""
    jax_package = "simpleaicv_pytorch_training_examples_tpu(?!_torch)"
    jax_import = re.compile(
        rf"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax|{jax_package})\b",
        re.M)
    sources = [p for p in PORT.rglob("*") if p.suffix in (".py", ".cu")]
    assert len(sources) > 20
    for path in sources:
        text = path.read_text()
        assert not re.search(jax_package, text), path
        assert not jax_import.search(text), path
    assert not jax_import.search((REPO / "chip_smoke.py").read_text())


def test_apply_pretrained_loads_a_pth_with_exclusions(tmp_path):
    from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
        load_state_dict)
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        apply_pretrained)

    source = init_model(vit.ViT(16, 64, 1, 1, image_size=32, num_classes=3),
                        1, "cpu")
    path = tmp_path / "weights.pth"
    torch.save({"model_state_dict": source.state_dict()}, path)
    model = load_state_dict(str(path), vit.ViT(16, 64, 1, 1, image_size=32,
                                               num_classes=3), ("fc.",))
    model = apply_pretrained(init_model(model, 0, "cpu"))
    torch.testing.assert_close(model.blocks[0].mlp.fc1.weight,
                               source.blocks[0].mlp.fc1.weight)
    assert not torch.equal(model.fc.weight, source.fc.weight)
