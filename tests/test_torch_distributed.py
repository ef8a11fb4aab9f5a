"""The port's multi-device layer in spawned gloo process groups, against the
JAX package on the suite's host devices.

Each spawn runs ``tests/torch_dist_worker.py`` once per rank (rendezvous
through a file under ``tmp_path``, so xdist workers never race for a TCP
port) and runs several checks to pay for the start once; each has its own
timeout. The JAX side runs in this process on a 2- or 4-device mesh of the
8 host devices, one reference run per check. Weights come from
``seeded_variables`` through ``convert.params_from_jax``; inputs from numpy
seeds. On the CPU the port's kernels take their plain versions.

Tolerances: the ring's forward 2e-5 against JAX's ring, its q/k/v gradients
1e-4 against dense attention's; the tile-sharded sliding window 1e-5 against
the port's one-process sliding window (the same f32 blend summed in another
order) and against JAX's with a pointwise model both compute alike (the
blend alone), and 1e-4 against the JAX runner on the mesh with the tiny
SwinUNETR (JAX's runner with a mesh and its ``sharded_sliding_window_inference``
are one ``shard_map`` body): the model alone differs from JAX's by 2.7e-5
on one 32³ tile (logits up to 6.1 in magnitude; f32 sums in another order
through four Swin stages), so the windows cannot meet 1e-5 there; the
DualEncoder's logits through the ring 1e-4, and 1e-5 against the one-process
DualEncoder where the ranks hold other tiles or cases (the ring falls back);
its train step on a batch every rank holds whole (through the ring) 1e-4
from the one-process step, loss and ``grad_norm``;
three data-parallel AdamW steps: loss 1e-4,
``grad_norm`` 1e-3 relative, running statistics 1e-5; ZeRO-1's parameters
1e-6 from the replicated run's; native eval's merged metrics 1e-6.
"""

import csv
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from multimodal_organ_segmentation_tpu.models import dual_encoder as jde
from multimodal_organ_segmentation_tpu.models import swin_unetr as jswin
from multimodal_organ_segmentation_tpu.models import unet3d as junet
from multimodal_organ_segmentation_tpu.ops import postprocess as jpp
from multimodal_organ_segmentation_tpu.ops import sliding_window as jsw
from multimodal_organ_segmentation_tpu.parallel.mesh import make_mesh as jmake_mesh
from multimodal_organ_segmentation_tpu.parallel.ring_attention import ring_attention as jring
from multimodal_organ_segmentation_tpu.train import metrics as jm
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfig
from multimodal_organ_segmentation_tpu_torch import cli
from multimodal_organ_segmentation_tpu_torch.data.synthetic import synthetic_volume
from multimodal_organ_segmentation_tpu_torch.models import convert
from multimodal_organ_segmentation_tpu_torch.ops import sliding_window as tsw
from multimodal_organ_segmentation_tpu_torch.parallel.mesh import zero1_spec
from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode as PortConfig
from multimodal_organ_segmentation_tpu_torch.utils.io import load_nifti, save_nifti
from tests.torch_port_utils import jax_train_steps, no_tf32, seeded_variables
from tests.torch_port_utils import _one_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 120
RING_TOL, RING_GRAD_TOL = 2e-5, 1e-4
BLEND_TOL, SLICE_TOL, MODEL_TOL = 1e-5, 1e-4, 1e-4
LOSS_TOL, GNORM_RTOL, STATS_TOL, ZERO1_TOL, METRIC_TOL = 1e-4, 1e-3, 1e-5, 1e-6, 1e-6
TP_LR, TP_WEIGHT_TOL, RESUME_TOL = 0.1, 1e-4, 1e-6
# adafactor's learning rates: its first step is the sign of each gradient
# (times lr × the leaf's rms), so a gradient element that rounding leaves at
# noise level moves by that much either way, and two steps from the seeded
# weights are held to JAX at AF_LR0; a step with moments in play (a resumed
# checkpoint's second) at AF_LR, where the factored conv (rms about
# 1/sqrt(27 · 128)) moves by more than ten times the weight tolerance, so
# that a wrong factored statistic shows
AF_LR0, AF_LR = 1e-4, 3e-2
K, MICRO = 3, 4  # three steps of a global micro-batch of 4, accumulation 1
CASES = {"case_a": (20, 18, 22), "case_b": (18, 20, 17), "case_c": (22, 19, 20)}
AFFINE = np.diag([1.5, 1.2, 2.0, 1.0])


def start(task: str, world: int, work: Path, inputs: dict) -> list:
    """Start ``task`` in a gloo group of ``world`` worker processes."""
    work.mkdir(parents=True, exist_ok=True)
    torch.save(inputs, work / "inputs.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dist_worker", task, str(r), str(world),
         str(work / "rendezvous"), str(work)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def join(procs: list, work: Path) -> list:
    """Wait for the workers (each within ``SPAWN_TIMEOUT``); each rank's
    results."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def _ring_inputs(seed, world):
    rng = np.random.default_rng(seed)
    return {n: rng.standard_normal((2, 24 * world, 2, 8)).astype(np.float32)
            for n in ("q", "k", "v", "do")}


def _ring_reference(inp, world):
    """JAX's ring on a ``world``-device mesh, and the q/k/v gradients of
    dense attention."""
    mesh = jmake_mesh(None, jax.devices()[:world])
    q, k, v, do = (jnp.asarray(inp[n]) for n in ("q", "k", "v", "do"))
    out = jring(q, k, v, mesh)

    def dense(q, k, v):
        s = jnp.einsum("bnhd,bmhd->bhnm", q, k) * q.shape[-1] ** -0.5
        return jnp.einsum("bhnm,bmhd->bnhd", jax.nn.softmax(s, axis=-1), v)

    _, vjp = jax.vjp(dense, q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(do)]


def _check_ring(ranks, ref):
    out, grads = ref
    for r in ranks:
        np.testing.assert_allclose(r["ring"]["out"], out, rtol=0, atol=RING_TOL)
        for g, want in zip(r["ring"]["grads"], grads):
            np.testing.assert_allclose(g, want, rtol=0, atol=RING_GRAD_TOL)


# -- the references ------------------------------------------------------------

def _swin_cfg():
    return {"experiment": {"seed": 0}, "data": {"modalities": ["CT", "PET"]},
            "model": {"name": "swin_unetr", "in_channels": 2, "out_channels": 4,
                      "backbone": {"img_size": [32, 32, 32], "feature_size": 12,
                                   "depths": [1, 1, 1, 1], "num_heads": [3, 6, 12, 24],
                                   "window_size": [4, 4, 4], "scan_blocks": False},
                      "fusion": {"type": "cross_attention", "stages": [1, 2, 3]},
                      "head": {"type": "conv", "dropout": 0.0}},
            "hardware": {"mixed_precision": "fp32"}}


def _unet_cfg(root, norm="batch", dropout=0.0):
    return {"experiment": {"name": "bn", "seed": 0, "output_dir": str(root / "out")},
            "data": {"modalities": ["CT", "PET"], "data_root": str(root / "data"),
                     "augmentation": {"enabled": False}},
            "model": {"name": "unet3d", "in_channels": 2, "out_channels": 4,
                      "backbone": {"features": [4, 8], "img_size": [16, 16, 16], "norm": norm},
                      "head": {"type": "conv", "dropout": dropout}},
            "training": {"batch_size": MICRO, "accumulation_steps": 1,
                         "optimizer": {"name": "adamw", "lr": 1e-4, "weight_decay": 1e-5},
                         "loss": {"name": "dice_ce", "dice_weight": 0.5, "ce_weight": 0.5}},
            "inference": {"sliding_window": {"roi_size": [16, 16, 16], "overlap": 0.5},
                          "batch_size": 2, "normalize": True},
            "evaluation": {"sliding_window": True},
            "hardware": {"mixed_precision": "fp32", "num_workers": 0}}


def _write_cases(root):
    """Three labelled cases of one bucket: the inference layout and a val split."""
    rng = np.random.default_rng(21)
    images, labels, rows = {}, {}, []
    for case, shape in CASES.items():
        image, label = synthetic_volume(shape, 4, rng)
        images[case], labels[case] = image, label
        for c, mod in enumerate(("ct", "pet")):
            save_nifti(image[..., c], root / "input" / mod / f"{case}.nii.gz", affine=AFFINE)
            save_nifti(image[..., c], root / "data" / "val" / case / f"{mod}.nii.gz", affine=AFFINE)
        save_nifti(label.astype(np.uint8), root / "data" / "val" / case / "label.nii.gz",
                   affine=AFFINE)
        rows.append([case, f"val/{case}/ct.nii.gz", f"val/{case}/pet.nii.gz",
                     f"val/{case}/label.nii.gz"])
    with open(root / "data" / "val.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["patient_id", "CT", "PET", "label"])
        w.writerows(rows)
    return images, labels


def _jax_eval_reference(flax_mod, variables, cfg, images, labels, spacing):
    """The JAX pipeline of native eval on one process: normalise, runner,
    argmax, postprocess, the metric classes."""
    from multimodal_organ_segmentation_tpu.data import transforms as jtr

    jcfg = JConfig(cfg)
    runner = jsw.SlidingWindowRunner(lambda v, p: flax_mod.apply(v, p, train=False),
                                     (16, 16, 16), 4, overlap=0.5, sw_batch_size=2)
    dice = jm.DiceMetric(4)
    hd, nsd, assd = jm.HausdorffDistance(95), jm.SurfaceDice(4, 2.0), jm.AverageSurfaceDistance(4)
    for case in CASES:
        norm = jtr.normalize_from_config(jnp.asarray(images[case]), jcfg)
        logits = runner(norm, variables)
        mask = jpp.postprocess_from_config(
            np.asarray(jsw.predict_labels(lambda v: logits, norm)), jcfg)
        for m in (hd, nsd, assd):
            m.update(mask[None], labels[case][None], spacing=spacing)
        dice.update(mask[None], labels[case][None])
    return {**dice.compute(), "hd95": hd.compute()["hausdorff_distance"], **nsd.compute(),
            **assd.compute()}


def _jax_dp_steps(flax_mod, cfg, variables, images, labels):
    """The JAX train step with each micro-batch sharded over a 2-device mesh
    (GSPMD: the global batch's loss, gradients and batch statistics)."""
    mesh = jmake_mesh(None, jax.devices()[:2])
    spec = lambda x: NamedSharding(mesh, P(*([None, "data"] + [None] * (x.ndim - 2))))
    put = lambda x: jax.device_put(x, spec(x))
    # the state placed as the step's outputs are: one compile for every step
    return jax_train_steps(flax_mod, cfg, variables, [put(x) for x in images],
                           [put(y) for y in labels], 1,
                           place=lambda s: jax.device_put(s, NamedSharding(mesh, P())))


@pytest.fixture(scope="module")
def models():
    """The JAX references' models and seeded weights, built once for the
    module: the tiny cross-attention SwinUNETR, the batch-norm UNet3D and
    its variant with a 128-channel block (adafactor's factored moments),
    with their port state dicts."""
    sflax = jswin.build_swin_unetr(JConfig(_swin_cfg()))
    svars = seeded_variables(sflax, np.zeros((1, 32, 32, 32, 2), np.float32), train=False, seed=7)
    bflax = junet.build_unet3d(JConfig(_unet_cfg(Path("."))))
    bvars = seeded_variables(bflax, np.zeros((1, 16, 16, 16, 2), np.float32), train=False, seed=11)
    aflax = junet.build_unet3d(JConfig(_af_cfg(Path("."), "af", AF_LR0)))
    avars = seeded_variables(aflax, np.zeros((1, 8, 8, 8, 2), np.float32), train=False, seed=19)
    return {"swin": (sflax, svars, convert.swin_unetr_params_from_jax(svars)),
            "unet": (bflax, bvars, convert.params_from_jax("unet3d", bvars["params"],
                                                           bvars["batch_stats"])),
            "af": (aflax, avars, convert.params_from_jax("unet3d", avars["params"],
                                                         avars["batch_stats"]))}


def _tp_cfg(cfg, name):
    """``cfg`` on a 2 × 2 grid (model axis 2), trained by SGD with momentum
    at lr 0.1 over a global batch of 2 (one row a data index)."""
    return {**cfg, "experiment": {**cfg.get("experiment", {}), "name": name, "seed": 0},
            "parallel": {"mesh": {"data": -1, "model": 2}},
            "training": {"batch_size": 2, "accumulation_steps": 1,
                         "optimizer": {"name": "sgd", "lr": TP_LR, "momentum": 0.9,
                                       "weight_decay": 0.0},
                         "loss": {"name": "dice_ce", "dice_weight": 0.5, "ce_weight": 0.5}}}


def _af_cfg(root, name, lr, **parallel):
    """The batch-norm UNet3D with a 128-channel block (its 3³ conv
    ``[128, 128, 3, 3, 3]`` has factored moments) on 8³ patches, trained by
    adafactor at ``lr`` over a global micro-batch of ``MICRO``."""
    cfg = _unet_cfg(root)
    cfg["experiment"]["name"] = name
    cfg["model"]["backbone"].update(features=[4, 128], img_size=[8, 8, 8])
    cfg["training"]["optimizer"] = {"name": "adafactor", "lr": lr, "weight_decay": 1e-5}
    if parallel:
        cfg["parallel"] = parallel
    return cfg


def _af_batch():
    rng = np.random.default_rng(23)
    return (rng.standard_normal((2, 1, MICRO, 8, 8, 8, 2)).astype(np.float32),
            rng.integers(0, 4, size=(2, 1, MICRO, 8, 8, 8)).astype(np.int32))


_AF_REF = {}
FACTORED = "down0.block.conv2.weight"


def _af_reference(models) -> dict:
    """JAX's two adafactor steps of the ``_af_cfg`` UNet3D with each
    micro-batch sharded over a 2-device mesh, at ``AF_LR0`` and at ``AF_LR``
    (one compiled step: the learning rate is an injected hyperparameter),
    run once for both spawns: each run's weights and batch statistics after
    each step and its metrics. The second step at ``AF_LR`` moves the
    factored conv by more than ten times the weight tolerance."""
    from multimodal_organ_segmentation_tpu.train import trainer as jtrainer
    from multimodal_organ_segmentation_tpu.train.losses import get_loss, with_deep_supervision
    from multimodal_organ_segmentation_tpu.train.optim import make_optimizer

    if _AF_REF:
        return _AF_REF
    flax_mod, variables, _ = models["af"]
    node = JConfig(_af_cfg(Path("."), "af", AF_LR0))
    tx = make_optimizer(node)
    step = jtrainer.make_train_step(flax_mod, tx, with_deep_supervision(get_loss(node)), 1)
    mesh = jmake_mesh(None, jax.devices()[:2])
    put = lambda x: jax.device_put(  # noqa: E731
        x, NamedSharding(mesh, P(*([None, "data"] + [None] * (x.ndim - 2)))))
    images, labels = _af_batch()
    to_jnp = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    for key, lr in (("slow", AF_LR0), ("fast", AF_LR)):
        params = to_jnp(variables["params"])
        state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                    opt_state=jax.jit(tx.init)(params),
                                    extra={"batch_stats": to_jnp(variables["batch_stats"])},
                                    ema_params=None)
        hyper = state.opt_state.hyperparams
        hyper["learning_rate"] = hyper["learning_rate"] * 0 + lr
        state = jax.device_put(state, NamedSharding(mesh, P()))  # as _jax_dp_steps
        run = {"params": [], "metrics": []}
        for i in range(len(images)):
            state, m = step(state, put(jnp.asarray(images[i])), put(jnp.asarray(labels[i])),
                            jax.random.key(i))
            run["params"].append(jax.device_get(state.params))
            run["metrics"].append({k: float(v) for k, v in m.items()})
        run["extra"] = jax.device_get(state.extra)
        _AF_REF[key] = run
    first, second = (convert.params_from_jax("unet3d", p)[FACTORED]
                     for p in _AF_REF["fast"]["params"])
    assert float((second - first).abs().max()) > 10 * TP_WEIGHT_TOL
    return _AF_REF


@pytest.fixture(scope="module")
def af_one_step1(tmp_path_factory, models):
    """The one-process checkpoint (whole layout, factored moments) of the
    first adafactor step at ``AF_LR``, which each spawn resumes."""
    from multimodal_organ_segmentation_tpu_torch.train.checkpoint import save_checkpoint
    from tests.torch_dist_worker import _steps, _trainer

    root = tmp_path_factory.mktemp("af_one")
    trainer = _trainer(_af_cfg(root, "af_one", AF_LR), models["af"][2], root, "af_one",
                       mesh=False)
    images, labels = _af_batch()
    _steps(trainer, images[:1], labels[:1])
    save_checkpoint(trainer.state.tree(), root / "step1", epoch=0)
    return str(root / "step1")


def _af_inputs(root, models, af_one_step1, **parallel) -> dict:
    images, labels = _af_batch()
    key = "af_tp" if "mesh" in parallel else "af_z1"
    return {f"{key}_cfg": _af_cfg(root, key, AF_LR0, **parallel),
            f"{key}_resume_cfg": _af_cfg(root, key, AF_LR, **parallel), "af_sd": models["af"][2],
            "af_images": images, "af_labels": labels, "af_one_step1": af_one_step1}


# the biases of the convs in front of a batch norm (``init_conv``'s and each
# conv block's): their gradient is 0 but for rounding, which adafactor turns
# into steps of about lr × the bias's rms either way (0.014 apart at AF_LR)
NOISE_BIAS = re.compile(r".*\['Conv_\d+'\]\['bias'\]")


def _check_unet_params(got, jparams, jstats, what, skip=None):
    """The port's UNet3D weights and batch statistics ``got`` within the
    weight tolerance of JAX's, but for the leaves whose path ``skip``
    matches."""
    back, stats = convert.params_to_jax("unet3d", got)
    for tree, jtree in ((back, jparams), (stats, jstats)):
        for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(jtree),
                                     jax.tree_util.tree_leaves_with_path(tree)):
            name = jax.tree_util.keystr(path)
            if skip is None or not skip.fullmatch(name):
                np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=TP_WEIGHT_TOL,
                                           err_msg=f"{what} {name}")


def _check_adafactor(got, ref, kept, what):
    """Two adafactor steps at ``AF_LR0`` held to JAX's (loss, ``grad_norm``,
    every weight and batch statistic after them); the one-process
    checkpoint of the first step at ``AF_LR`` resumed in this layout, its
    second step held to JAX's at ``AF_LR`` (the same, but for the biases in
    front of a batch norm); the 128-channel conv's factored moments as this
    layout keeps them."""
    slow, fast = ref["slow"], ref["fast"]
    for m, j in zip(got["metrics"] + got["resumed"], slow["metrics"] + fast["metrics"][1:]):
        assert abs(m["loss"] - j["loss"]) <= LOSS_TOL, (what, m, j)
        assert abs(m["grad_norm"] - j["grad_norm"]) <= GNORM_RTOL * j["grad_norm"], (what, m, j)
    _check_unet_params(got["params"], slow["params"][-1], slow["extra"]["batch_stats"],
                       f"{what} params")
    _check_unet_params(got["resumed_params"], fast["params"][-1], fast["extra"]["batch_stats"],
                       f"{what} resumed", skip=NOISE_BIAS)
    assert got["kept"][FACTORED] == kept, (what, got["kept"])


def _de_cfg(**parallel):
    """The tiny cross-attention DualEncoder (features 4-8-16, 8³ tiles) with
    a token budget of 256, which a ring over 2 ranks doubles: level 0's 512
    tokens attend."""
    return {"experiment": {"seed": 0}, "data": {"modalities": ["CT", "PET"]},
            "model": {"name": "dual_encoder", "in_channels": 2, "out_channels": 4,
                      "backbone": {"features": [4, 8, 16], "img_size": [8, 8, 8]},
                      "fusion": {"type": "cross_attention", "max_tokens": 256},
                      "head": {"type": "conv", "dropout": 0.0}},
            "parallel": parallel, "hardware": {"mixed_precision": "fp32"}}


def _de_case(mesh):
    """The DualEncoder's flax module with the ring over ``mesh``'s data axis,
    its seeded weights, a batch of two 8³ tiles and their labels."""
    dflax = jde.build_dual_encoder(JConfig(_de_cfg())).clone(sequence_axis="data", mesh=mesh)
    x = np.random.default_rng(9).standard_normal((2, 8, 8, 8, 2)).astype(np.float32)
    x[..., 1] = np.abs(x[..., 1]) * 2.0
    dvars = seeded_variables(dflax, x, train=False, seed=10)
    dy = np.random.default_rng(16).integers(0, 4, size=(2, 8, 8, 8)).astype(np.int64)
    return dflax, dvars, x, dy


def test_ring_attention_on_four_ranks(tmp_path, models, af_one_step1):
    """Four gloo ranks: the ring over all four; then the same group as a
    2 × 2 ``(data, model)`` grid with tensor parallelism, each check held to
    the JAX model with ``tp_axis=None`` on one device: the tiny
    cross-attention SwinUNETR (fusion at /32 with 2 heads, so kernel B's
    path splits) and the batch-norm UNet3D, their logits within 1e-4; one
    TP × DP step of each, loss 1e-4, ``grad_norm`` 1e-3 relative and the
    gathered weights (and the UNet3D's batch statistics) 1e-4 (SGD: Adam
    would turn the rounding noise of a gradient that is analytically 0, a
    conv bias in front of a norm, into steps of up to ±lr, see
    ``tests/test_torch_train_step.py``); the split layers' parameters a
    rank equal to the plan's; a one-process checkpoint
    resumed on the grid (the start of the step) and the step's gathered
    checkpoint resumed in one process, each giving the other side's logits
    within 1e-6 of the largest logit (f32: the row-parallel sums add their
    halves in another order, a few ulps). Then adafactor on the grid, ZeRO-1
    over the data groups and tensor parallelism over the model groups (the
    128-channel conv cut both ways): two steps at ``AF_LR0`` against JAX's
    2-device mesh steps, loss 1e-4, ``grad_norm`` 1e-3 relative, weights
    and batch statistics 1e-4; the one-process checkpoint of the first step
    at ``AF_LR`` resumed on the grid, its second step the same against
    JAX's at ``AF_LR`` (but for the biases in front of a batch norm); the
    grid's checkpoint resumed in one process, its second step the same at
    ``AF_LR0``. And the DualEncoder with ``sequence_axis: model``: its logits on a
    batch every rank holds within 1e-4 of JAX's model ringing over the model
    axis of a 2 × 2 mesh, and one data-parallel step (a row a data index,
    the ring over each model group) within loss 1e-4 and ``grad_norm`` 1e-3
    relative of JAX's step of the same function on one device (JAX's step
    on that mesh gets the gradient wrong, see below). Last, ``--mode tune`` of the tensor-parallel UNet3D
    on the grid, one candidate made to raise on rank 3 alone in the middle
    of its forward: every rank returns the same table and pick, the failure
    recorded on all four and the next candidate measured, and rank 0 alone
    writes the profile."""
    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.parallel.tensor_parallel import tp_plan
    from multimodal_organ_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    no_tf32()
    inp = _ring_inputs(3, 4)
    rng = np.random.default_rng(17)
    cases = {"swin": (_swin_cfg(), (2, 32, 32, 32)), "unet": (_unet_cfg(tmp_path), (2, 16, 16, 16))}
    for name, (cfg, shape) in cases.items():
        x = rng.standard_normal(shape + (2,)).astype(np.float32)
        y = rng.integers(0, 4, size=shape).astype(np.int64)
        tcfg = _tp_cfg(cfg, f"tp_{name}")
        sd = models[name][2]
        save_checkpoint({"step": 0, "params": sd, "opt_state": None, "ema_params": None},
                        tmp_path / f"one_{name}_ckpt", epoch=0)
        inp.update({f"tp_{name}_cfg": tcfg, f"tp_{name}_sd": sd, f"tp_{name}_x": x,
                    f"tp_{name}_y": y, f"one_{name}_ckpt": str(tmp_path / f"one_{name}_ckpt")})
    inp.update(_af_inputs(tmp_path, models, af_one_step1, mesh={"data": -1, "model": 2},
                          zero1=True))
    grid = JConfig({"parallel": {"mesh": {"data": -1, "model": 2}}})
    dflax, dvars, dx, dy = _de_case(jmake_mesh(None, jax.devices()[:2]))
    dcfg = _de_cfg(mesh={"data": -1, "model": 2}, sequence_axis="model")
    dcfg["training"] = {"optimizer": {"name": "adamw", "lr": 1e-4}, "loss": {"name": "dice_ce"}}
    inp.update(gde_cfg=dcfg, de_sd=convert.params_from_jax("dual_encoder", dvars["params"]),
               de_x=dx, de_y=dy)
    tune_cfg = {**_tp_cfg(_unet_cfg(tmp_path), "grid_tune"),
                "tune": {"volume_shape": [24, 24, 24], "sw_batches": [1, 2], "overlaps": [0.5],
                         "repeats": 1}}
    tune_cfg["experiment"]["log_dir"] = str(tmp_path / "work" / "logs")
    (tmp_path / "grid_tune.yaml").write_text(yaml.safe_dump(tune_cfg))
    inp.update(grid_tune_config=str(tmp_path / "grid_tune.yaml"))
    procs = start("four", 4, tmp_path / "work", inp)

    ref = _ring_reference(inp, 4)
    jref = {}
    for name in ("swin", "unet"):
        flax_mod, variables, sd = models[name]
        x, y = inp[f"tp_{name}_x"], inp[f"tp_{name}_y"]
        cfg = {**inp[f"tp_{name}_cfg"], "parallel": {}}
        logits = np.asarray(jax.jit(lambda v, a: flax_mod.apply(v, a, train=False))(
            variables, jnp.asarray(x)))
        one = build_model(cfg, device="cpu")
        one.load_state_dict(sd)
        with torch.no_grad():
            port_logits = one(torch.from_numpy(x)).numpy()
        jref[name] = {"logits": logits, "plan": tp_plan(one, 2), "port_logits": port_logits}
        params, extra, metrics = jax_train_steps(flax_mod, cfg, variables, [x[None]],
                                                 [y[None].astype(np.int32)], 1)
        jref[name].update(params=params, extra=extra, metrics=metrics)
    af_ref = _af_reference(models)
    # the DualEncoder ringing over the model axis of JAX's 2 × 2 mesh: its
    # logits; and JAX's step of the same function on one device (the doubled
    # budget's levels, no ring). JAX's own step ringing over that model axis
    # gets the gradient wrong (grad_norm 0.474 with the batch split over the
    # data axis, 0.900 with it replicated, where the one-device step and the
    # step ringing over the data axis of 2 devices read 0.395), so the port's
    # step is held to the one-device step
    gflax = dflax.clone(sequence_axis="model", mesh=jmake_mesh(grid, jax.devices()[:4]))
    de_logits = np.asarray(jax.jit(lambda v, a: gflax.apply(v, a, train=False))(
        dvars, jnp.asarray(dx)))
    one_de = {**dcfg, "parallel": {}, "model": {
        **dcfg["model"], "fusion": {**dcfg["model"]["fusion"], "max_tokens": 512}}}
    _, _, (de_step,) = jax_train_steps(jde.build_dual_encoder(JConfig(one_de)), one_de, dvars,
                                       [dx[None]], [dy[None].astype(np.int32)], 1)
    ranks = join(procs, tmp_path / "work")

    _check_ring(ranks, ref)
    for rank, r in enumerate(ranks):
        tp = r["tensor_parallel"]
        assert tp["grid"] == {"shape": {"data": 2, "model": 2}, "at": divmod(rank, 2),
                              "model_group": 2, "data_group": 2}
        for name in ("swin", "unet"):
            got, want = tp[name], jref[name]
            np.testing.assert_allclose(got["logits"], want["logits"], rtol=0, atol=MODEL_TOL)
            plan = want["plan"]
            full = models[name][2]
            assert got["split_numel"] * 2 == sum(full[k].numel() for k in plan.splits), name
            (m,), j = got["metrics"], want["metrics"][0]
            assert abs(m["loss"] - j["loss"]) <= LOSS_TOL, (name, m, j)
            assert abs(m["grad_norm"] - j["grad_norm"]) <= GNORM_RTOL * j["grad_norm"], (name, m, j)
            if name == "swin":
                stepped = convert.swin_unetr_params_from_jax({"params": want["params"]})
                assert stepped.keys() == got["params"].keys()
                for k, w in stepped.items():
                    np.testing.assert_allclose(got["params"][k].numpy(), w.numpy(), rtol=0,
                                               atol=TP_WEIGHT_TOL, err_msg=f"{name} {k}")
                assert got["kinds"].count("heads") == 3 + 1  # stages 1-3 and the /32 fusion
            else:
                back, stats = convert.params_to_jax("unet3d", got["params"])
                for tree, jtree in ((back, want["params"]),
                                    (stats, want["extra"]["batch_stats"])):
                    for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(jtree),
                                                 jax.tree_util.tree_leaves_with_path(tree)):
                        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=TP_WEIGHT_TOL,
                                                   err_msg=f"{name} {jax.tree_util.keystr(path)}")
            # the one-process checkpoint resumed on the grid gives its logits
            scale = RESUME_TOL * np.abs(want["port_logits"]).max()
            np.testing.assert_allclose(got["logits"], want["port_logits"], rtol=0, atol=scale)
    for r in ranks:
        # the 128-channel conv [128, 128, 3, 3, 3] (input channels the larger
        # axis between equals): v_row [128, 3, 3, 3] runs over its output
        # channels (sliced by ZeRO-1 on the rank's shard [128, 64, 3, 3, 3]),
        # v_col over its input channels (split over the model axis)
        _check_adafactor(r["grid_adafactor"], af_ref,
                         {"v_row": (64, 3, 3, 3), "v_col": (64, 3, 3, 3)}, "TP x ZeRO-1")
        de = r["grid_dual_encoder"]
        assert de["levels"] == [0, 1, 2]
        assert de["rings"] == [("logits", "model"), ("step", "model")], de["rings"]
        np.testing.assert_allclose(de["logits"], de_logits, rtol=0, atol=MODEL_TOL)
        assert abs(de["step"]["loss"] - de_step["loss"]) <= LOSS_TOL, (de["step"], de_step)
        assert abs(de["step"]["grad_norm"] - de_step["grad_norm"]) <= \
            GNORM_RTOL * de_step["grad_norm"], (de["step"], de_step)
    # --mode tune on the grid: one table, one pick, rank 3's failure on all four
    reports = [r["grid_tune"]["reports"] for r in ranks]
    assert len(reports[0]) == 1 and all(rep == reports[0] for rep in reports)
    by_sw = {r["sw_batch"]: r for r in reports[0][0]["results"]}
    assert by_sw[1]["error"] == "RuntimeError: CUDA out of memory (rank 3)", by_sw
    assert by_sw[2]["vol_per_min"] > 0 and reports[0][0]["best"]["sw_batch"] == 2
    # rank 3 raised at its second sum; the others stopped at the vote in front
    # of their second or third
    assert [r["grid_tune"]["sums"] for r in ranks][3] == 2, [r["grid_tune"]["sums"] for r in ranks]
    profile = tmp_path / "work" / "grid_tune_config.yaml"
    assert [r["grid_tune"]["writes"] for r in ranks] == [[str(profile)], [], [], []]
    assert yaml.safe_load(profile.read_text())["inference"]["batch_size"] == 2
    # the grid's first adafactor step (the whole layout) resumed in one process
    from tests.torch_dist_worker import _steps, _trainer

    one = _trainer(_af_cfg(tmp_path, "af_back", AF_LR0), models["af"][2], tmp_path, "af_back",
                   mesh=False, resume_from=str(tmp_path / "work" / "af_tp_step1"))
    images, labels = _af_batch()
    (m,), j = _steps(one, images[1:], labels[1:]), af_ref["slow"]["metrics"][1]
    assert abs(m["loss"] - j["loss"]) <= LOSS_TOL and \
        abs(m["grad_norm"] - j["grad_norm"]) <= GNORM_RTOL * j["grad_norm"], (m, j)
    _check_unet_params(one.model.state_dict(), af_ref["slow"]["params"][-1],
                       af_ref["slow"]["extra"]["batch_stats"],
                       "grid checkpoint resumed in one process")
    for name in ("swin", "unet"):
        # the grid's checkpoint (the whole layout, moments too) resumed in one process
        cfg = {**_tp_cfg(cases[name][0], f"one_{name}"), "parallel": {}}
        cfg["experiment"]["output_dir"] = str(tmp_path)
        one = Trainer(cfg, device="cpu", resume_from=str(tmp_path / "work" / f"tp_{name}_ckpt"))
        one.init_state()
        for p in one.model.parameters():
            assert one.state.optimizer.inner.state[p]["momentum_buffer"].shape == p.shape
        one.model.eval()
        with torch.no_grad():
            logits = one.model(torch.from_numpy(inp[f"tp_{name}_x"])).numpy()
        for r in ranks:
            after = r["tensor_parallel"][name]["after"]
            np.testing.assert_allclose(logits, after, rtol=0,
                                       atol=RESUME_TOL * np.abs(after).max(), err_msg=name)


def test_two_ranks_against_the_jax_mesh(tmp_path, models, af_one_step1):
    """One gloo group of two ranks: the ring, the tile-sharded sliding window
    and the runner's mesh, the DualEncoder's ring, data-parallel and ZeRO-1
    training with resume, dropout rows, the class-weighted cross entropy,
    ``case_shard: auto`` predict and merged native eval; each against the JAX
    package on a 2-device mesh (or one process where the JAX package runs
    one). Then the multi-rank service: rank 0 answers over HTTP with the
    one-process service's mask, stats and the stop reach both ranks, and a
    follower whose rank 0 falls silent raises at its receive's timeout.
    Adafactor under ZeRO-1 (two steps at ``AF_LR0`` against JAX's 2-device
    mesh steps; the one-process checkpoint of the first step at ``AF_LR``
    resumed, its second step against JAX's at ``AF_LR``). ``--mode tune``
    through the CLI on both ranks, one candidate made to raise on rank 1
    alone: both ranks return the same table and pick, the failure recorded
    on both with rank 1's error and the next candidate measured, and rank 0
    alone writes the profile (a hang would end at the join's time limit)."""
    from multimodal_organ_segmentation_tpu_torch.serving.server import InferenceService
    from multimodal_organ_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    no_tf32()
    root = tmp_path
    inp = _ring_inputs(2, 2)
    mesh = jmake_mesh(None, jax.devices()[:2])

    # the weights and inputs first: the ranks start while the JAX references run
    scfg = _swin_cfg()  # the tile-sharded sliding window of a tiny cross-attention SwinUNETR
    sflax, svars, ssd = models["swin"]
    vol = np.random.default_rng(8).standard_normal((40, 40, 40, 2)).astype(np.float32)
    sw = ((32, 32, 32), 4, 0.5, 3)  # 8 tiles, chunks of 3: 3 chunks padded to 4
    blend_w = np.random.default_rng(15).standard_normal((2, 4)).astype(np.float32)
    inp.update(swin_cfg=scfg, swin_sd=ssd, swin_volume=vol,
               swin_sw=sw, blend_w=blend_w)
    # the DualEncoder with sequence_axis "data": the JAX model on the mesh
    dcfg = _de_cfg(mesh={"data": -1, "model": 1}, sequence_axis="data")
    dflax, dvars, x, dy = _de_case(mesh)
    dsd = convert.params_from_jax("dual_encoder", dvars["params"])
    dvol = np.random.default_rng(14).standard_normal((12, 12, 10, 2)).astype(np.float32)
    dsw = ((8, 8, 8), 4, 0.5, 3)  # 8 tiles, chunks of 3: 3 chunks padded to 4
    inp.update(de_cfg=dcfg, de_sd=dsd, de_x=x, de_y=dy, de_volume=dvol, de_sw=dsw)
    # data-parallel training of a batch-norm UNet3D, and a dropout model
    bcfg = _unet_cfg(root)
    bflax, bvars, bsd = models["unet"]
    rng = np.random.default_rng(12)
    images = rng.standard_normal((K, 1, MICRO, 16, 16, 16, 2)).astype(np.float32)
    labels = rng.integers(0, 4, size=(K, 1, MICRO, 16, 16, 16)).astype(np.int32)
    # the class-weighted cross entropy over two row blocks of other label
    # mixes: rank 0's rows mostly background, rank 1's mostly class 3, so the
    # ranks' sums of weights differ
    wlabels = labels[:1].copy()
    wlabels[:, :, :MICRO // 2][rng.random(wlabels[:, :, :MICRO // 2].shape) < 0.8] = 0
    wlabels[:, :, MICRO // 2:][rng.random(wlabels[:, :, MICRO // 2:].shape) < 0.8] = 3
    wcfg = {**bcfg, "training": {**bcfg["training"],
                                 "loss": {**bcfg["training"]["loss"],
                                          "class_weights": [0.2, 1.0, 2.0, 4.0]}}}
    inp.update(weighted_cfg=wcfg, weighted_labels=wlabels)
    drop_cfg = _unet_cfg(root, norm="instance", dropout=0.3)
    dropvars = seeded_variables(junet.build_unet3d(JConfig(drop_cfg)),
                                np.zeros((1, 16, 16, 16, 2), np.float32), train=False, seed=13)
    inp.update(bn_cfg=bcfg, bn_sd=bsd, images=images, labels=labels, drop_cfg=drop_cfg,
               drop_sd=convert.params_from_jax("unet3d", dropvars["params"]))
    # case sharding: predict and native eval over three cases
    cases, case_labels = _write_cases(root)
    icfg = {**bcfg, "experiment": {**bcfg["experiment"], "name": "infer"}}
    inp.update(infer_cfg=icfg, predict_input=str(root / "input"))
    depcfg = {**bcfg, "experiment": {**bcfg["experiment"], "name": "de_infer"},
              "model": dcfg["model"], "parallel": dcfg["parallel"],
              "inference": {**bcfg["inference"], "save_probabilities": True, "batch_size": 4,
                            "sliding_window": {"roi_size": [8, 8, 8], "overlap": 0.5}}}
    inp.update(de_predict_cfg=depcfg)
    # the multi-rank service: the batch-norm UNet3D's checkpoint, one case
    save_checkpoint({"step": 0, "params": bsd, "opt_state": None, "ema_params": None},
                    root / "serve_ckpt", epoch=0)
    serve_cfg = {**icfg, "experiment": {**icfg["experiment"], "name": "serve"}}
    serve_case = {m: str(root / "input" / m.lower() / "case_a.nii.gz") for m in ("CT", "PET")}
    inp.update(serve_cfg=serve_cfg, serve_ckpt=str(root / "serve_ckpt"), serve_case=serve_case)
    # --mode serve through cli.main on both ranks (the CLI joins the group)
    cli_cfg = {**serve_cfg, "experiment": {**serve_cfg["experiment"], "name": "serve_cli",
                                           "log_dir": str(root / "work" / "logs")}}
    (root / "serve_cli.yaml").write_text(yaml.safe_dump(cli_cfg))
    inp.update(serve_cli_config=str(root / "serve_cli.yaml"), serve_cli_name="serve_cli")
    # adafactor under ZeRO-1; --mode tune over chunks of 1 and 2 through the CLI
    inp.update(_af_inputs(root, models, af_one_step1, zero1=True))
    tune_cfg = {**icfg, "experiment": {**icfg["experiment"], "name": "tune",
                                       "log_dir": str(root / "work" / "logs")},
                "tune": {"volume_shape": [24, 24, 24], "sw_batches": [1, 2], "overlaps": [0.5],
                         "repeats": 1}}
    (root / "tune.yaml").write_text(yaml.safe_dump(tune_cfg))
    inp.update(tune_config=str(root / "tune.yaml"))
    procs = start("main", 2, root / "work", inp)

    refs = {"ring": _ring_reference(inp, 2)}
    apply = lambda v, p: sflax.apply(v, p, train=False)  # noqa: E731
    # the JAX runner with a mesh is the shard_map of the same body as JAX's
    # sharded_sliding_window_inference: one reference for both port functions
    refs["sw"] = np.asarray(jsw.SlidingWindowRunner(
        apply, sw[0], sw[1], overlap=sw[2], sw_batch_size=sw[3], mesh=mesh)(jnp.asarray(vol), svars))
    # the blend alone, with a model both sides compute alike
    refs["blend"] = np.asarray(jsw.sharded_sliding_window_inference(
        jnp.asarray(vol), lambda p: jnp.tanh(p @ blend_w), sw[0], sw[1], mesh, overlap=sw[2],
        sw_batch_size=sw[3]))
    refs["de"] = np.asarray(jax.jit(lambda v, x: dflax.apply(v, x, train=False))(
        dvars, jnp.asarray(x)))
    _, jextra, jmetrics = _jax_dp_steps(bflax, bcfg, bvars, images, labels)
    _, _, jweighted = _jax_dp_steps(bflax, wcfg, bvars, images[:1], wlabels)
    spacing = tuple(np.sqrt((load_nifti(root / "input" / "ct" / "case_a.nii.gz",
                                        return_affine=True)[1][:3, :3] ** 2).sum(0)).tolist())
    refs["eval"] = _jax_eval_reference(bflax, bvars, bcfg, cases, case_labels, spacing)
    one = Trainer(icfg, device="cpu")
    one.model.load_state_dict(bsd)
    one.init_state()
    one.predict(root / "input", root / "pred_one")
    af_ref = _af_reference(models)
    # one process: the DualEncoder with the doubled budget's levels and no ring
    one_model = {**dcfg["model"], "fusion": {"type": "cross_attention", "max_tokens": 512}}
    one = Trainer({**depcfg, "model": one_model, "parallel": {}}, device="cpu")
    one.model.load_state_dict(dsd)
    one.init_state()
    with torch.no_grad():
        refs["de_sw"] = tsw.sliding_window_inference(
            torch.from_numpy(dvol), one.model, dsw[0], dsw[1], dsw[2], dsw[3]).numpy()
    one.predict(root / "input", root / "de_pred_one")
    served_one = InferenceService(PortConfig(serve_cfg), str(root / "serve_ckpt"),
                                  device="cpu").segment(
        serve_case, output_dir=str(root / "served_one"), case_id="served", probabilities=True)

    ranks = join(procs, root / "work")

    _check_ring(ranks, refs["ring"])
    for r in ranks:
        out = r["sliding_window"]
        np.testing.assert_allclose(out["sharded"], out["single"], rtol=0, atol=BLEND_TOL)
        np.testing.assert_allclose(out["runner"], out["single"], rtol=0, atol=BLEND_TOL)
        np.testing.assert_allclose(out["sharded"], refs["sw"], rtol=0, atol=SLICE_TOL)
        np.testing.assert_allclose(out["runner"], refs["sw"], rtol=0, atol=SLICE_TOL)
        np.testing.assert_allclose(out["blend"], refs["blend"], rtol=0, atol=BLEND_TOL)
        # the doubled budget: level 0's 512 tokens attend through the ring
        de = r["dual_encoder"]
        assert de["levels"] == [0, 1, 2]
        np.testing.assert_allclose(de["logits"], refs["de"], rtol=0, atol=MODEL_TOL)
        # the ring runs where every rank holds the batch, and only there
        assert de["rings"] == ["logits", "step"], de["rings"]
        # a batch every rank holds whole trains through the ring
        for key in ("loss", "grad_norm"):
            want = de["step_one"][key]
            assert abs(de["step_ring"][key] - want) <= MODEL_TOL * max(1.0, want), (key, de)
        # each rank's own tiles: the ring falls back, and says so
        assert de["fallback_warned"]
        np.testing.assert_allclose(de["sharded"], refs["de_sw"], rtol=0, atol=BLEND_TOL)
    # case_shard auto over three cases: each rank's own, through the fallback
    written = [Path(p).name for r in ranks for p in r["dual_encoder"]["written"]]
    assert sorted(written) == sorted(f"{c}_pred.nii.gz" for c in CASES)
    for name in written:
        case = name[:-len("_pred.nii.gz")]
        np.testing.assert_allclose(load_nifti(root / "work" / "de_pred" / f"{case}_prob.nii.gz"),
                                   load_nifti(root / "de_pred_one" / f"{case}_prob.nii.gz"),
                                   rtol=0, atol=BLEND_TOL)
        np.testing.assert_array_equal(load_nifti(root / "work" / "de_pred" / name),
                                      load_nifti(root / "de_pred_one" / name))

    train = [r["train"] for r in ranks]
    for t in train:
        assert t["dp_rows"] == MICRO // 2
        for j, got in zip(jmetrics, t["dp_metrics"]):
            assert abs(j["loss"] - got["loss"]) <= LOSS_TOL, (jmetrics, t["dp_metrics"])
            assert abs(j["grad_norm"] - got["grad_norm"]) <= GNORM_RTOL * j["grad_norm"]
        _, stats = convert.params_to_jax("unet3d", t["dp_state"])
        for (path, want), (_, got) in zip(jax.tree_util.tree_leaves_with_path(jextra["batch_stats"]),
                                          jax.tree_util.tree_leaves_with_path(stats)):
            np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=STATS_TOL,
                                       err_msg=jax.tree_util.keystr(path))
        for k, v in t["dp_state"].items():
            np.testing.assert_allclose(t["z1_state"][k].numpy(), v.numpy(), rtol=0, atol=ZERO1_TOL,
                                       err_msg=k)
        # every moment leaf with a dim divisible by 2 is held half on each
        # rank, along zero1_spec's dim; the others whole
        for shape, d, m, v in t["z1_halves"]:
            spec = zero1_spec(shape, 2)
            assert d == (spec.index("data") if spec else None), (shape, d)
            want = list(shape)
            if d is not None:
                want[d] //= 2
            assert list(m) == want == list(v), (shape, d, m)
        assert sum(d is not None for _, d, _, _ in t["z1_halves"]) >= 10
        assert t["z1_resume_exact"]
        assert t["z1_resume_step"]  # the step after a resume updates the resumed weights
        for a, b in zip(t["drop_dp"], t["drop_one"]):
            assert abs(a["loss"] - b["loss"]) <= 1e-6 and abs(a["grad_norm"] - b["grad_norm"]) <= \
                1e-5 * b["grad_norm"], (t["drop_dp"], t["drop_one"])
        # the weighted cross entropy divides the global Σw·nll by the global Σw
        (w,), (j,) = t["weighted"], jweighted
        assert abs(w["loss"] - j["loss"]) <= LOSS_TOL, (w, j)
        assert abs(w["grad_norm"] - j["grad_norm"]) <= GNORM_RTOL * j["grad_norm"], (w, j)
    for k in train[0]["dp_state"]:  # the ranks end with the same weights
        assert torch.equal(train[0]["dp_state"][k], train[1]["dp_state"][k]), k
        assert torch.equal(train[0]["z1_state"][k], train[1]["z1_state"][k]), k

    # case_shard auto: the ranks' masks are the one-process run's, together
    written = [Path(p).name for r in ranks for p in r["inference"]["written"]]
    assert sorted(written) == sorted(f"{c}_pred.nii.gz" for c in CASES)
    assert ranks[0]["inference"]["written"] != ranks[1]["inference"]["written"]
    for name in written:
        got = load_nifti(root / "work" / "pred" / name)
        np.testing.assert_array_equal(got, load_nifti(root / "pred_one" / name))
    for r in ranks:
        m = r["inference"]["metrics"]
        assert m["num_cases"] == len(CASES)
        assert [row["case"] for row in m["per_case"]] == list(CASES)
        for key in ("dice", "hd95", "surface_dice", "assd"):
            assert abs(m[key] - refs["eval"][key]) <= METRIC_TOL, (key, m[key], refs["eval"][key])
        np.testing.assert_allclose(m["dice_per_class"], refs["eval"]["dice_per_class"],
                                   rtol=0, atol=METRIC_TOL)

    # the multi-rank service: rank 0's answer is the one-process service's
    zero, one_rank = ranks[0]["serve"], ranks[1]["serve"]
    assert zero["mesh"] == one_rank["mesh"] == {"data": 2, "model": 1}
    assert {int(c): n for c, n in zero["segment"]["class_voxels"].items()} == \
        served_one["class_voxels"]
    np.testing.assert_array_equal(load_nifti(root / "work" / "served" / "served_pred.nii.gz"),
                                  load_nifti(root / "served_one" / "served_pred.nii.gz"))
    np.testing.assert_allclose(load_nifti(root / "work" / "served" / "served_prob.nii.gz"),
                               load_nifti(root / "served_one" / "served_prob.nii.gz"),
                               rtol=0, atol=BLEND_TOL)
    assert zero["stats"]["requests"] == 1 and zero["stats"]["warmups"] == 1
    assert zero["stats"]["mesh"] == {"data": 2, "model": 1}
    # the warm-up and the request reached the follower, and the stop ended it
    assert one_rank["passes"] == 2 and one_rank["stats"]["requests"] == 1
    waited, err = one_rank["timeout"]
    assert 1.5 <= waited < 30, (waited, err)
    # --mode serve through the CLI on both ranks: rank 0 answers, SIGTERM
    # drains it, and its stop ends rank 1's loop
    zero, one_rank = ranks[0]["serve_cli"], ranks[1]["serve_cli"]
    assert zero["segment"]["shape"] == list(CASES["case_a"])
    assert {int(c): n for c, n in zero["segment"]["class_voxels"].items()} == \
        served_one["class_voxels"]
    assert zero["stats"]["mesh"] == {"data": 2, "model": 1} and zero["stats"]["requests"] == 1
    assert "SIGTERM: draining" in zero["log"] and "final stats" in zero["log"]
    assert "stop after 1 passes" in one_rank["log"], one_rank["log"][-2000:]

    # adafactor under ZeRO-1: the 128-channel conv's v_row (over its output
    # channels, sliced) half a rank, v_col (over its input channels) whole
    for r in ranks:
        _check_adafactor(r["adafactor"], af_ref, {"v_row": (64, 3, 3, 3), "v_col": (128, 3, 3, 3)},
                         "ZeRO-1")
    # --mode tune on both ranks: one table, one pick, rank 1's failure on both
    reports = [r["tune"]["reports"] for r in ranks]
    assert len(reports[0]) == 1 and reports[0] == reports[1]
    by_sw = {r["sw_batch"]: r for r in reports[0][0]["results"]}
    assert by_sw[1]["error"] == "RuntimeError: CUDA out of memory (rank 1)", by_sw
    assert by_sw[2]["vol_per_min"] > 0 and reports[0][0]["best"]["sw_batch"] == 2
    profile = root / "work" / "tune_config.yaml"
    assert [r["tune"]["writes"] for r in ranks] == [[str(profile)], []]
    assert yaml.safe_load(profile.read_text())["inference"]["batch_size"] == 2


def _torchrun(root, mode, *extra):
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
           "-m", "multimodal_organ_segmentation_tpu_torch", "--mode", mode,
           "--config", str(root / "config.yaml"), "--device", "cpu", *extra]
    proc = subprocess.run(cmd, cwd=REPO, env={**os.environ, "OMP_NUM_THREADS": "1"},
                          capture_output=True, text=True, timeout=SPAWN_TIMEOUT)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])


def test_cli_modes_under_torchrun(tmp_path):
    """``torchrun --nproc_per_node 2 -m <port> --mode train|inference|eval``
    with gloo on the CPU: two data-parallel steps with a checkpoint from
    rank 0; inference with the tile chunks split over the ranks (the main
    path: ``case_shard: false``), its probabilities within 1e-5 of the
    one-process CLI's and its masks equal wherever the top-2 margin exceeds
    twice that; native eval with ``case_shard: auto`` written once, its metrics
    equal to the one-process CLI's. ``--mode serve`` over two ranks runs in
    the 2-rank spawn (``torch_dist_worker.serve_cli``), through the same
    ``cli.main``."""
    import json

    root = tmp_path
    cases, _ = _write_cases(root)
    for case in list(CASES)[:2]:  # a train split: the first two cases, batch 2
        for f in ("ct", "pet", "label"):
            src = root / "data" / "val" / case / f"{f}.nii.gz"
            (root / "data" / "train" / case).mkdir(parents=True, exist_ok=True)
            (root / "data" / "train" / case / f"{f}.nii.gz").write_bytes(src.read_bytes())
    text = (root / "data" / "val.csv").read_text().replace("val/", "train/").splitlines()
    (root / "data" / "train.csv").write_text("\n".join(text[:3]) + "\n")
    cfg = _unet_cfg(root, norm="instance")
    cfg["experiment"].update(name="cli", log_dir=str(root / "logs"))
    cfg["training"].update(batch_size=2, epochs=1,
                           scheduler={"name": "cosine", "warmup_epochs": 0})
    cfg["data"]["augmentation"] = {"enabled": False}
    cfg["inference"]["save_probabilities"] = True
    cfg["data"]["test_csv"] = "val.csv"
    (root / "config.yaml").write_text(yaml.safe_dump(cfg))

    _torchrun(root, "train")
    ckpt = root / "out" / "cli" / "last"
    assert (ckpt / "tree.pt").exists()
    records = (root / "out" / "cli" / "metrics.jsonl").read_text().splitlines()
    assert len(records) == 1  # rank 0 alone writes
    _torchrun(root, "inference", "--checkpoint", str(ckpt), "--input", str(root / "input"),
              "--output", str(root / "pred2"), "--set", "inference.case_shard=false")
    cli.main(["--mode", "inference", "--config", str(root / "config.yaml"), "--device", "cpu",
              "--checkpoint", str(ckpt), "--input", str(root / "input"),
              "--output", str(root / "pred1")])
    for case in CASES:
        p2 = load_nifti(root / "pred2" / f"{case}_prob.nii.gz")
        p1 = load_nifti(root / "pred1" / f"{case}_prob.nii.gz")
        np.testing.assert_allclose(p2, p1, rtol=0, atol=1e-5)
        top2 = np.sort(p1, axis=-1)[..., -2:]
        # a voxel whose top-2 margin exceeds twice the tolerance cannot flip
        clear = (top2[..., 1] - top2[..., 0]) > 2e-5
        assert clear.mean() > 0.95
        m2 = load_nifti(root / "pred2" / f"{case}_pred.nii.gz")
        m1 = load_nifti(root / "pred1" / f"{case}_pred.nii.gz")
        np.testing.assert_array_equal(m2[clear], m1[clear])
    _torchrun(root, "eval", "--checkpoint", str(ckpt), "--output", str(root / "eval2"))
    cli.main(["--mode", "eval", "--config", str(root / "config.yaml"), "--device", "cpu",
              "--checkpoint", str(ckpt), "--output", str(root / "eval1")])
    m2 = json.loads((root / "eval2" / "eval_native.json").read_text())
    m1 = json.loads((root / "eval1" / "eval_native.json").read_text())
    assert m2["num_cases"] == m1["num_cases"] == len(CASES)
    for key in ("dice", "hd95", "surface_dice", "assd"):
        assert abs(m2[key] - m1[key]) <= METRIC_TOL, (key, m2[key], m1[key])
