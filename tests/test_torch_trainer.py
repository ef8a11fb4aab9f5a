"""The port's ``Trainer`` on the CPU: two epochs on a synthetic NIfTI
dataset, checkpoints, mid-epoch resume, and ``freeze_for_inference``.

The model is the flagship structure at fs=12 on 32³ volumes (the synthetic
generator's size, so no resize is needed: the transform graph is not ported
yet). Tolerances: a resumed run repeats the uninterrupted run's step losses
exactly (the same ops on the same restored bits, deterministic algorithms
on); the frozen model equals slice 1's ``build_model`` with the same weights
bit for bit.
"""

import json

import numpy as np
import pytest
import torch

from multimodal_organ_segmentation_tpu_torch.data.dataloader import (
    DataLoader,
    device_prefetch,
    get_dataloader,
)
from multimodal_organ_segmentation_tpu_torch.data.dataset import get_dataset
from multimodal_organ_segmentation_tpu_torch.data.synthetic import generate_synthetic_dataset
from multimodal_organ_segmentation_tpu_torch.models.build import build_model
from multimodal_organ_segmentation_tpu_torch.train.checkpoint import (
    AsyncCheckpointWriter,
    CheckpointPolicy,
    load_checkpoint,
    save_checkpoint,
)
from multimodal_organ_segmentation_tpu_torch.train.metrics import ConfusionMatrix, DiceMetric
from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode
from multimodal_organ_segmentation_tpu_torch.utils.prng import KeyStream, set_seed
from tests.torch_port_utils import _one_thread  # noqa: F401


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic")
    generate_synthetic_dataset(root, n_train=8, n_val=2, n_test=0, shape=(32, 32, 32),
                               num_classes=8, seed=3)
    return root


def _standardise(sample):
    """Per-channel standardisation, standing in for the transform graph."""
    out = dict(sample)
    img = sample["image"]
    out["image"] = ((img - img.mean(axis=(0, 1, 2))) / (img.std(axis=(0, 1, 2)) + 1e-6)).astype(
        np.float32)
    return out


def _config(data_root, out_dir, name, **training):
    return ConfigNode({
        "experiment": {"name": name, "seed": 7, "output_dir": str(out_dir)},
        "data": {"modalities": ["CT", "PET"], "data_root": str(data_root),
                 "augmentation": {"enabled": False}},
        "model": {
            "name": "swin_unetr", "in_channels": 2, "out_channels": 8,
            "backbone": {"img_size": [32, 32, 32], "feature_size": 12, "depths": [2, 2, 2, 2],
                         "num_heads": [3, 6, 12, 24], "window_size": [6, 6, 6]},
            "fusion": {"type": "cross_attention", "stages": [1, 2, 3]},
            "head": {"type": "conv", "dropout": 0.0},
        },
        "training": {
            "epochs": 2, "batch_size": 1, "accumulation_steps": 2,
            "optimizer": {"name": "adamw", "lr": 2e-3, "weight_decay": 1e-5},
            "scheduler": {"name": "cosine", "min_lr": 1e-6},
            "loss": {"name": "dice_ce"},
            "checkpoint": {"save_best": True, "save_last": True, "save_every": 1,
                           "save_every_steps": 3},
            **training,
        },
        "parallel": {"remat": True},
        "hardware": {"mixed_precision": "fp32", "num_workers": 2, "prefetch_depth": 2},
    })


def _trainer(cfg, resume_from=None):
    train = get_dataloader(cfg, "train", transform=_standardise)
    val = get_dataloader(cfg, "val", transform=_standardise)
    return Trainer(cfg, train_loader=train, val_loader=val, resume_from=resume_from,
                   device="cpu")


@pytest.fixture(scope="module")
def full_run(data_root, tmp_path_factory):
    torch.use_deterministic_algorithms(True)
    try:
        cfg = _config(data_root, tmp_path_factory.mktemp("run"), "full")
        trainer = _trainer(cfg)
        epoch_losses = []
        orig = trainer._train_epoch

        def spy(lr):
            loss = orig(lr)
            epoch_losses.append(list(trainer.last_step_losses))
            return loss

        trainer._train_epoch = spy
        history = trainer.train()
    finally:
        torch.use_deterministic_algorithms(False)
    return trainer, history, epoch_losses


def test_two_epochs_loss_is_finite_and_falls(full_run):
    trainer, history, epoch_losses = full_run
    assert len(history["train_loss"]) == 2 and len(history["val_dice"]) == 2
    assert all(np.isfinite(v) for v in history["train_loss"] + history["val_loss"])
    assert history["train_loss"][1] < history["train_loss"][0]
    assert [len(e) for e in epoch_losses] == [4, 4]  # 8 cases / (1 x accumulation 2)
    assert trainer.state.step == 8
    assert 0.0 <= history["val_dice"][-1] <= 1.0
    assert trainer.keys.counter == 1 + 8  # one key for the init, one a step


def test_checkpoints_and_metrics_stream_are_written(full_run):
    trainer, history, _ = full_run
    out = trainer.output_dir
    for name in ("last", "best", "epoch_1", "epoch_2", "last_step"):
        assert (out / name / "tree.pt").exists() and (out / name / "meta.json").exists(), name
    assert not list(out.glob("*.tmp"))
    last = load_checkpoint(out / "last")
    assert last["epoch"] == 1 and last["history"]["train_loss"] == history["train_loss"]
    assert set(last["tree"]) == {"step", "params", "opt_state", "ema_params"}
    assert last["tree"]["step"] == 8 and last["tree"]["ema_params"] is None
    step = load_checkpoint(out / "last_step")["meta"]
    assert step["step_in_epoch"] == 3 and step["epoch"] == 1 and step["key_counter"] == 1 + 7
    lines = [json.loads(l) for l in (out / "metrics.jsonl").read_text().splitlines()]
    assert [l["epoch"] for l in lines] == [1, 2]
    assert lines[0]["lr"] == 2e-3 and lines[1]["lr"] < 2e-3


def test_resume_mid_epoch_reproduces_the_uninterrupted_losses(full_run, data_root, tmp_path):
    """The step checkpoint written after step 3 of epoch 2 re-enters that
    epoch at step 4 with the same weights, moments, batch order and key
    stream position: the one remaining step's loss is the same number."""
    trainer, history, epoch_losses = full_run
    cfg = _config(data_root, tmp_path, "resumed")
    torch.use_deterministic_algorithms(True)
    try:
        resumed = _trainer(cfg, resume_from=str(trainer.output_dir / "last_step"))
        resumed.init_state()
        assert resumed.current_epoch == 1 and resumed._resume_step_in_epoch == 3
        assert resumed.state.step == 7 and resumed.keys.counter == 1 + 7
        out = resumed.train()
    finally:
        torch.use_deterministic_algorithms(False)
    assert resumed.last_step_losses == epoch_losses[1][3:]
    assert out["train_loss"][0] == history["train_loss"][0]  # carried in the checkpoint
    assert out["val_dice"][-1] == history["val_dice"][-1]
    for (n, a), (_, b) in zip(resumed.model.named_parameters(), trainer.model.named_parameters()):
        assert torch.equal(a, b), n


def test_resume_from_an_epoch_checkpoint_starts_the_next_epoch(full_run, data_root, tmp_path):
    trainer, _, _ = full_run
    resumed = _trainer(_config(data_root, tmp_path, "resumed2", ema_decay=0.99),
                       resume_from=str(trainer.output_dir / "epoch_1"))
    resumed.init_state()
    assert resumed.current_epoch == 1 and resumed._resume_step_in_epoch == 0
    # the checkpoint has no EMA and this run wants one: restarted at the weights
    for n, p in resumed.model.named_parameters():
        assert torch.equal(resumed.state.ema_params[n], p)
    assert resumed.evaluate()["dice"] == pytest.approx(trainer.history["val_dice"][0], abs=1e-6)


def test_freeze_for_inference_is_the_serving_model(full_run, data_root, tmp_path):
    """f32 training weights → slice 1's bf16 serving model: the frozen model
    equals ``build_model`` (serving) loaded with the same weights, on a tile."""
    trainer, _, _ = full_run
    cfg = _config(data_root, tmp_path, "frozen")
    cfg.set("hardware.mixed_precision", "bf16")
    fresh = Trainer(cfg, device="cpu")
    fresh.init_state()
    fresh.load_params(trainer.output_dir / "best")
    weights = {k: v.clone() for k, v in fresh.model.state_dict().items()}
    assert all(p.dtype == torch.float32 for p in fresh.model.parameters())
    frozen = fresh.freeze_for_inference()
    assert fresh.state.optimizer is None and not frozen.training
    with pytest.raises(RuntimeError, match="frozen"):
        fresh.train_step_fn()

    serving = build_model(cfg, device="cpu")
    serving.load_state_dict(weights)
    kinds = {n: p.dtype for n, p in serving.named_parameters()}
    assert {n: p.dtype for n, p in frozen.named_parameters()} == kinds
    assert kinds["stage0_block0.attn.qkv.weight"] == torch.bfloat16
    assert kinds["out_conv.weight"] == torch.float32
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 32, 32, 32, 2)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(frozen(x), serving(x))


def test_later_slices_raise_by_name(data_root, tmp_path):
    """What later slices bring raises by name: meshes, ZeRO-1, TensorBoard,
    epoch profiles, reference-weight import, multi-process case shards. The
    evaluation slice's parts (native eval, predict, native mid-train
    validation, the transform graph) now run: ``test_torch_cli.py`` and
    ``test_torch_transforms.py`` hold them to the JAX package."""
    cfg = _config(data_root, tmp_path, "later")
    with pytest.raises(NotImplementedError, match="multi-device"):
        Trainer(cfg, device="cpu", mesh=object())
    for key, value in (("parallel.zero1", True),):
        bad = _config(data_root, tmp_path, "later2")
        bad.set(key, value)
        with pytest.raises(NotImplementedError):
            Trainer(bad, device="cpu")
    for key, value in (("experiment.tensorboard", True), ("hardware.profile_dir", str(tmp_path))):
        bad = _config(data_root, tmp_path, "later3")
        bad.set(key, value)
        with pytest.raises(NotImplementedError):
            Trainer(bad, train_loader=[], device="cpu").train()
    bad = _config(data_root, tmp_path, "later4")
    bad.set("model.pretrained", "weights.pth")
    with pytest.raises(NotImplementedError, match="checkpoint-import"):
        Trainer(bad, device="cpu").init_state()
    # dice_native needs native validation, as in the JAX trainer
    bad = _config(data_root, tmp_path, "later5", checkpoint={"monitor": "dice_native"})
    with pytest.raises(ValueError, match="native_val_every"):
        Trainer(bad, train_loader=[], device="cpu").train()
    # the repaired loader: augmentation on, no transform given → the train
    # graph runs (it raised NotImplementedError before the transforms came)
    aug = _config(data_root, tmp_path, "later6")
    aug.set("data.augmentation", {"enabled": True, "random_flip": True})
    batch = next(iter(get_dataloader(aug, "train", device="cpu")))
    assert batch["image"].shape == (1, 32, 32, 32, 2) and isinstance(batch["image"], torch.Tensor)


def test_trainer_without_a_device_needs_cuda(data_root, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_config(data_root, tmp_path, "nodevice"))


def test_dataloader_order_skip_and_prefetch(data_root, tmp_path):
    cfg = _config(data_root, tmp_path, "loader")
    ds = get_dataset(cfg, "train")
    assert len(ds) == 8 and ds[0]["image"].shape == (32, 32, 32, 2)
    loader = DataLoader(ds, batch_size=2, shuffle=True, drop_last=True, num_workers=2, seed=5)
    first = [b["patient_id"] for b in loader.epoch_iter(1)]
    again = [b["patient_id"] for b in loader.epoch_iter(1)]
    other = [b["patient_id"] for b in loader.epoch_iter(2)]
    assert first == again and first != other and len(first) == 4
    assert [b["patient_id"] for b in loader.epoch_iter(1, skip_batches=3)] == first[3:]
    batches = list(device_prefetch(loader.epoch_iter(1), "cpu"))
    assert [b["patient_id"] for b in batches] == first
    assert isinstance(batches[0]["image"], torch.Tensor)
    assert batches[0]["image"].shape == (2, 32, 32, 32, 2) and batches[0]["label"].dtype == torch.int32


def test_checkpoint_roundtrip_policy_and_async_writer(tmp_path):
    tree = {"step": 3, "params": {"w": torch.arange(6.0).reshape(2, 3)}, "opt_state": None,
            "ema_params": {"w": torch.ones(2, 3)}}
    save_checkpoint(tree, tmp_path / "a", epoch=4, best_metric=0.5, history={"val_dice": [0.5]},
                    step_in_epoch=2, key_counter=9)
    save_checkpoint(tree, tmp_path / "a", epoch=5, best_metric=0.6)  # overwrite swaps atomically
    got = load_checkpoint(tmp_path / "a")
    assert got["epoch"] == 5 and got["best_metric"] == 0.6 and got["history"] == {}
    assert torch.equal(got["tree"]["params"]["w"], tree["params"]["w"])
    assert torch.equal(got["tree"]["ema_params"]["w"], tree["ema_params"]["w"])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["a"]
    with pytest.raises(FileNotFoundError):
        load_checkpoint(tmp_path / "missing")

    cfg = ConfigNode({"training": {"checkpoint": {"save_best": True, "save_last": True,
                                                   "save_every": 2}}})
    writer = AsyncCheckpointWriter()
    policy = CheckpointPolicy(tmp_path / "p", cfg, writer=writer)
    assert policy.save(tree, epoch=0, metric=0.3, best_metric=0.0) == 0.3
    assert policy.save(tree, epoch=1, metric=0.2, best_metric=0.3) == 0.3
    tree["params"]["w"] += 1  # after submit: the writer holds its own host copy
    writer.close()
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == ["best", "epoch_2", "last"]
    assert load_checkpoint(tmp_path / "p" / "best")["epoch"] == 0
    assert load_checkpoint(tmp_path / "p" / "last")["epoch"] == 1
    assert torch.equal(load_checkpoint(tmp_path / "p" / "last")["tree"]["params"]["w"],
                       torch.arange(6.0).reshape(2, 3))
    with pytest.raises(RuntimeError, match="closed"):
        writer.submit(tree, tmp_path / "p" / "late")


def test_key_stream_is_stateless_in_seed_and_counter():
    a, b = KeyStream(42), KeyStream(42)
    draws = [torch.rand(3, generator=a.next()) for _ in range(4)]
    assert a.counter == 4
    for _ in range(2):
        b.next()
    restored = KeyStream(42, counter=2)
    assert torch.equal(torch.rand(3, generator=restored.next()), draws[2])
    assert torch.equal(torch.rand(3, generator=b.next()), draws[2])
    assert not torch.equal(draws[0], draws[1])
    assert not torch.equal(torch.rand(3, generator=KeyStream(43).next()), draws[0])
    assert len(KeyStream(1).split(3)) == 3
    assert isinstance(set_seed(5), torch.Generator)


def test_dice_metric_and_confusion_matrix_match_the_jax_package():
    from multimodal_organ_segmentation_tpu.train import metrics as jmetrics

    rng = np.random.default_rng(0)
    ours, theirs = DiceMetric(4), jmetrics.DiceMetric(4)
    cm_ours, cm_theirs = ConfusionMatrix(4), jmetrics.ConfusionMatrix(4)
    for _ in range(2):
        pred = rng.integers(0, 4, size=(2, 6, 6, 6)).astype(np.int32)
        target = rng.integers(0, 4, size=(2, 6, 6, 6)).astype(np.int32)
        ours.update(torch.from_numpy(pred), target)
        theirs.update(pred, target)
        cm_ours.update(pred, torch.from_numpy(target))
        cm_theirs.update(pred, target)
    a, b = ours.compute(), theirs.compute()
    assert a["dice"] == pytest.approx(b["dice"], abs=1e-9)
    np.testing.assert_allclose(a["dice_per_class"], b["dice_per_class"], atol=1e-9)
    ca, cb = cm_ours.compute(), cm_theirs.compute()
    assert ca["confusion_matrix"] == cb["confusion_matrix"]
    assert ca["f1"] == pytest.approx(cb["f1"], abs=1e-12)
