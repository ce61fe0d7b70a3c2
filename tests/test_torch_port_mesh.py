"""Data parallelism of the port (``parallel/mesh.py``) on the CPU: two
``gloo`` processes against one process on the same global batch.

A tiny CIFAR ResNet (BasicBlock [1, 1, 1, 1], width 8, 32^2) trains 2
AdamW steps on global batches of 8 images: two processes, each on its 4
contiguous rows (``shard_batch``), must end where one process on all 8
does, at 1e-5 (fp32): every step's loss, every parameter, every BatchNorm
buffer (the statistics are the global batch's) and the gathered AdamW
moments, without and with ``use_zero1`` (moments sharded over the two
ranks, parameters all-gathered). The control keeps each rank's own
BatchNorm statistics (what plain DDP computes) and must miss by more than
1e-5. An eval of 10 images in global batches of 4 on 2 ranks counts 10,
and its top-1 equals one process's. The classification train CLI runs on
2 ranks through the runner: ``mesh: 2 devices`` logged, rank 0 alone
writing the log and the checkpoints, and a batch the world does not divide
refused. Processes rendezvous through a ``file://`` under ``tmp_path``.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from simpleaicv_pytorch_training_examples_tpu_torch.parallel import mesh
from torch_port_helpers import (  # noqa: F401 (autouse)
    drop_work_dir_configs, one_torch_thread)

REPO = Path(__file__).resolve().parents[1]
GLOBAL_BATCH, STEPS, EVAL_IMAGES = 8, 2, 10
TOL = 1e-5

CLI_CONFIG = """
from simpleaicv_pytorch_training_examples_tpu_torch.classification import losses
from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
    ClassificationCollater)
from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.syntheticdataset import (
    SyntheticClassificationDataset)
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones.resnet import (
    BasicBlock)
from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones.resnetcifar import (
    ResNetCifar)


class config:
    model = ResNetCifar(BasicBlock, [1, 1, 1, 1], 8, num_classes=10)
    train_criterion = losses.CELoss()
    train_dataset = SyntheticClassificationDataset(n=16, image_size=32,
                                                   num_classes=10, seed=2)
    test_dataset = SyntheticClassificationDataset(n=10, image_size=32,
                                                  num_classes=10, seed=3)
    train_collater = ClassificationCollater()
    test_collater = ClassificationCollater()
    seed = 0
    batch_size = {batch}
    num_workers = 0
    optimizer = ("AdamW", {{"lr": 1e-3, "weight_decay": 1e-2}})
    scheduler = ("CosineLR", {{"warm_up_epochs": 0, "min_lr": 1e-6}})
    epochs = 1
    print_interval = 1
    use_amp = False
    use_zero1 = True
"""


def _batches():
    rs = np.random.RandomState(0)
    return [{"image": torch.from_numpy(rs.standard_normal(
                 (GLOBAL_BATCH, 3, 32, 32)).astype(np.float32)),
             "label": torch.from_numpy(rs.randint(0, 10, GLOBAL_BATCH))}
            for _ in range(STEPS)]


class _Config:
    optimizer = ("AdamW", {"lr": 1e-2, "weight_decay": 1e-2})
    scheduler = ("MultiStepLR", {"warm_up_epochs": 0, "gamma": 1.0,
                                 "milestones": []})
    epochs = 1


def run(zero1=False):
    """The 2 train steps and the eval on this process's share; returns
    {'losses', 'state', 'moments', 'eval'}."""
    from simpleaicv_pytorch_training_examples_tpu_torch.classification import (
        losses)
    from simpleaicv_pytorch_training_examples_tpu_torch.classification.common import (
        ClassificationCollater)
    from simpleaicv_pytorch_training_examples_tpu_torch.classification.datasets.syntheticdataset import (
        SyntheticClassificationDataset)
    from simpleaicv_pytorch_training_examples_tpu_torch.data import (
        build_loader)
    from simpleaicv_pytorch_training_examples_tpu_torch.engine import (
        RunContext, classification_evaluator, init_model, make_train_step)
    from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones.resnet import (
        BasicBlock)
    from simpleaicv_pytorch_training_examples_tpu_torch.models.backbones.resnetcifar import (
        ResNetCifar)
    from simpleaicv_pytorch_training_examples_tpu_torch.utils import (
        build_optimizer)

    model = init_model(ResNetCifar(BasicBlock, [1, 1, 1, 1], 8,
                                   num_classes=10), 0, "cpu")
    config = _Config()
    config.use_zero1 = zero1
    optimizer, _ = build_optimizer(config, model, STEPS)
    step = make_train_step(model, losses.CELoss(), optimizer,
                           compute_dtype=torch.float32)
    out = {"losses": []}
    for i, batch in enumerate(_batches()):
        metrics = step({k: mesh.shard_batch(v) for k, v in batch.items()}, i)
        out["losses"].append(float(metrics["loss"]))
    out["state"] = {k: v.clone() for k, v in model.state_dict().items()}
    state = optimizer.state_dict()
    out["moments"] = {f"{slot}.{n}": t for slot in ("mu", "nu")
                      for n, t in state[slot].items()}
    dataset = SyntheticClassificationDataset(n=EVAL_IMAGES, image_size=32,
                                             num_classes=10, seed=3)
    loader = build_loader(dataset, 4, ClassificationCollater(), "cpu",
                          process_index=mesh.rank(),
                          process_count=mesh.world_size())
    config.use_amp = False
    evaluate = classification_evaluator(
        model, config, RunContext(loader, None, torch.device("cpu")))
    out["eval"] = evaluate()[2]
    return out


def worker(rank, world, init_file, out_path, case, cli_dir=None):
    """One rank of a run (the entry of the child processes)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    mesh.distributed_init("cpu", init_method=f"file://{init_file}")
    if case == "per_rank":   # BatchNorm sees a world of one: plain DDP's
        from simpleaicv_pytorch_training_examples_tpu_torch.models import (
            common)
        common.world_size = lambda: 1
    result = run(zero1=case == "zero1")
    if cli_dir is not None:   # batch 4, then 3 in another work dir
        from simpleaicv_pytorch_training_examples_tpu_torch.tools import (
            train_classification_model)
        result["cli"] = train_classification_model.main(
            ["--work-dir", cli_dir], device="cpu")["epochs"]
        sys.modules.pop("train_config", None)
        try:
            train_classification_model.main(["--work-dir", cli_dir + "_3"],
                                            device="cpu")
        except AssertionError as error:
            result["refused"] = str(error)
    if rank == 0:
        torch.save(result, out_path)
    torch.distributed.destroy_process_group()


def _two_ranks(tmp_path, case, cli_dir=None):
    out = tmp_path / f"{case}.pt"
    if cli_dir is not None:
        for suffix, batch in (("", 4), ("_3", 3)):
            work_dir = Path(f"{cli_dir}{suffix}")
            work_dir.mkdir()
            (work_dir / "train_config.py").write_text(
                CLI_CONFIG.format(batch=batch))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests"), os.environ.get("PYTHONPATH", "")]))
    code = ("import sys, test_torch_port_mesh as t; "
            "t.worker(int(sys.argv[1]), 2, sys.argv[2], sys.argv[3], "
            "sys.argv[4], None if sys.argv[5] == '-' else sys.argv[5])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(rank), str(tmp_path / "rdzv"),
         str(out), case, str(cli_dir) if cli_dir else "-"], env=env,
        cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(2)]
    logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return torch.load(out, weights_only=False)


@pytest.fixture(scope="module")
def one_process():
    return {zero1: run(zero1=zero1) for zero1 in (False, True)}


def _differences(got, want):
    """Largest |difference| over the losses, the state and the moments."""
    diffs = [np.abs(np.subtract(got["losses"], want["losses"])).max()]
    for key in ("state", "moments"):
        assert set(got[key]) == set(want[key])
        diffs += [(got[key][n].double() - want[key][n].double()).abs().max()
                  .item() for n in want[key]]
    return max(diffs)


@pytest.mark.parametrize("zero1", [False, True], ids=["allreduce", "zero1"])
def test_two_ranks_equal_one_process(zero1, one_process, tmp_path):
    want = one_process[zero1]
    got = _two_ranks(tmp_path, "zero1" if zero1 else "plain",
                     cli_dir=tmp_path / "cli" if zero1 else None)
    assert _differences(got, want) <= TOL
    assert got["eval"]["images"] == EVAL_IMAGES == want["eval"]["images"]
    assert got["eval"]["top1"] == want["eval"]["top1"]
    if zero1:
        log = (tmp_path / "cli" / "log" / "train.log").read_text()
        assert "mesh: 2 devices" in log
        assert "zero1: optimizer state sharded over the data axis" in log
        assert (tmp_path / "cli" / "checkpoints" / "latest.pth").exists()
        assert len(got["cli"]) == 1 and got["cli"][0]["skipped"] == 0
        assert got["refused"] == "global batch 3 % devices 2 != 0"


def test_per_rank_batch_statistics_miss_one_process(one_process, tmp_path):
    """The control: each rank normalising by its own 4 images."""
    got = _two_ranks(tmp_path, "per_rank")
    assert _differences(got, one_process[False]) > 100 * TOL


def test_zero1_alone_ends_bit_for_bit_where_adamw_does(one_process):
    """One process: ZeRO-1's layout at world size 1 moves every moment and
    parameter as the unsharded optimizer does."""
    a, b = one_process[False], one_process[True]
    assert a["losses"] == b["losses"]
    assert all(torch.equal(a["state"][n], b["state"][n]) for n in a["state"])
    assert all(torch.equal(a["moments"][n], b["moments"][n])
               for n in a["moments"])


def test_mesh_helpers_without_a_group():
    assert (mesh.world_size(), mesh.rank(), mesh.is_main_process()) == (1, 0,
                                                                       True)
    batch = {"image": torch.arange(8.0).reshape(8, 1), "label": torch.arange(8)}
    assert torch.equal(mesh.shard_batch(batch["label"], index=1, count=2),
                       torch.arange(4, 8))
    # a short last batch: the slice of the full one, fewer rows or none
    assert mesh.shard_batch(np.arange(5), 4, 1, 2).tolist() == [2, 3]
    assert mesh.shard_batch(np.arange(3), 8, 1, 2).tolist() == []
    with pytest.raises(AssertionError, match="global batch 3 % devices 2"):
        mesh.shard_batch(np.arange(3), index=0, count=2)
    padded, n = mesh.pad_batch_to_multiple({k: v[:5] for k, v in batch.items()},
                                           4)
    assert n == 5 and padded["image"].shape == (8, 1)
    assert padded["image"][5:].abs().sum() == 0
    assert mesh.zero1_shard_dims([(8, 3), (3, 3), (2, 6), ()], 2) == [
        0, None, 0, None]
    assert mesh.zero1_shard_dims([(3, 4)], 4) == [1]
    assert mesh.distributed_init("cpu") == torch.device("cpu")
