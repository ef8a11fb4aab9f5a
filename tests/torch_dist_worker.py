"""One rank of the gloo process groups that ``tests/test_torch_distributed.py``
spawns: two ranks (``main``) or four (``four``, a 2 × 2 ``(data, model)``
grid for the tensor-parallel checks, adafactor split two ways, the
DualEncoder's ring over the model axis and ``--mode tune``).

    python -m tests.torch_dist_worker TASK RANK WORLD RENDEZVOUS_FILE WORK_DIR

Reads ``WORK_DIR/inputs.pt`` (written by the test: configs, the port's state
dicts converted from the JAX references' weights, numpy inputs), joins a
gloo group of WORLD ranks through ``file://RENDEZVOUS_FILE``, runs TASK and
writes ``WORK_DIR/rank<RANK>.pt``. It imports the port only, never JAX.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def ring(inp, work):
    """Ring attention: this rank's token shard forward, gathered, and the
    q/k/v gradients of ``Σ out·do``, summed over the ranks."""
    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import all_gather_cat, make_mesh
    from multimodal_organ_segmentation_tpu_torch.parallel.ring_attention import ring_attention

    mesh = make_mesh()
    rank, size = dist.get_rank(), dist.get_world_size()
    q, k, v = (_t(inp[n]).requires_grad_() for n in ("q", "k", "v"))
    n = q.shape[1] // size
    sl = slice(rank * n, (rank + 1) * n)
    out = all_gather_cat(ring_attention(q[:, sl], k[:, sl], v[:, sl], mesh), 1, mesh)
    # every rank computes the same loss; the gather's backward sums them
    (out * _t(inp["do"])).sum().div(size).backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for g in grads:
        dist.all_reduce(g)
    return {"out": out.detach().numpy(), "grads": [g.numpy() for g in grads]}


def sliding_window(inp, work):
    """The tile-sharded sliding window and the runner with a mesh, and the
    one-process sliding window, on the tiny cross-attention SwinUNETR."""
    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.ops import sliding_window as tsw
    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import make_mesh

    cfg = inp["swin_cfg"]
    model = build_model(cfg, device="cpu")
    model.load_state_dict(inp["swin_sd"])
    vol = _t(inp["swin_volume"])
    roi, classes, ov, sw = inp["swin_sw"]
    mesh = make_mesh()
    w = _t(inp["blend_w"])
    with torch.no_grad():
        sharded = tsw.sharded_sliding_window_inference(vol, model, roi, classes, mesh,
                                                       overlap=ov, sw_batch_size=sw)
        runner = tsw.SlidingWindowRunner(lambda prm, p: model(p), roi, classes, overlap=ov,
                                         sw_batch_size=sw, mesh=mesh)(vol)
        single = tsw.sliding_window_inference(vol, model, roi, classes, ov, sw)
        blend = tsw.sharded_sliding_window_inference(vol, lambda p: torch.tanh(p @ w), roi,
                                                     classes, mesh, overlap=ov, sw_batch_size=sw)
    return {"sharded": sharded.numpy(), "runner": runner.numpy(), "single": single.numpy(),
            "blend": blend.numpy()}


def dual_encoder(inp, work):
    """The DualEncoder built in this group with ``sequence_axis: data``: its
    attention levels; its logits through the ring on one batch held by
    every rank; the tile-sharded sliding window, whose ranks hold other
    tiles (the ring falls back); ``case_shard: auto`` predict of three
    cases, each rank its own (the ring falls back); and one train step of a
    batch every rank holds whole (the replicate rule: the ring runs), with
    the same step of the doubled budget's model in this process alone."""
    import warnings

    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.ops import sliding_window as tsw
    from multimodal_organ_segmentation_tpu_torch.parallel import ring_attention as ra
    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import make_mesh, same_input
    from multimodal_organ_segmentation_tpu_torch.train.losses import get_loss
    from multimodal_organ_segmentation_tpu_torch.train.optim import make_optimizer
    from multimodal_organ_segmentation_tpu_torch.train.trainer import (
        Trainer,
        TrainState,
        make_train_step,
    )
    from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode

    rings = []  # the ring's calls, by phase
    ring = ra.ring_attention
    ra.ring_attention = lambda *a, **k: rings.append(phase) or ring(*a, **k)
    phase = "logits"
    model = build_model(inp["de_cfg"], device="cpu")
    model.load_state_dict(inp["de_sd"])
    roi, classes, ov, sw = inp["de_sw"]
    with torch.no_grad():
        with same_input():
            logits = model(_t(inp["de_x"]))
        phase = "sharded"
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sharded = tsw.sharded_sliding_window_inference(
                _t(inp["de_volume"]), model, roi, classes, make_mesh(), overlap=ov,
                sw_batch_size=sw)
    levels = [lv for lv in range(4) if hasattr(model, f"fusion_xattn{lv}")]
    cfg = {**inp["de_predict_cfg"], "experiment": {**inp["de_predict_cfg"]["experiment"],
                                                    "output_dir": str(work)}}
    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(inp["de_sd"])
    trainer.init_state()
    phase = "predict"
    written = trainer.predict(inp["predict_input"], work / "de_pred")

    def step(cfg, mesh):
        node = ConfigNode({**cfg, "training": {"optimizer": {"name": "adamw", "lr": 1e-4},
                                               "loss": {"name": "dice_ce"}}})
        m = build_model(node, device="cpu", train=True)
        m.load_state_dict(inp["de_sd"])
        opt = make_optimizer(node, m.parameters())
        fn = make_train_step(m, opt, get_loss(node), 1, mesh=mesh)
        _, metrics = fn(TrainState(step=0, model=m, optimizer=opt), _t(inp["de_x"])[None],
                        torch.from_numpy(inp["de_y"]).long()[None])
        return {k: float(v) for k, v in metrics.items()}

    one_model = {**inp["de_cfg"]["model"],
                 "fusion": {**inp["de_cfg"]["model"]["fusion"], "max_tokens": 512}}
    phase = "step"
    step_ring = step(inp["de_cfg"], make_mesh())
    phase = "step_one"
    step_one = step({**inp["de_cfg"], "model": one_model, "parallel": {}}, None)
    ra.ring_attention = ring
    return {"logits": logits.numpy(), "levels": levels, "sharded": sharded.numpy(),
            "fallback_warned": any("do not hold one batch" in str(w.message) for w in caught),
            "written": written, "step_ring": step_ring, "step_one": step_one,
            "rings": sorted(set(rings))}


def _trainer(cfg, sd, work, name, **kw):
    from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer, local_state

    cfg = {**cfg, "experiment": {**cfg["experiment"], "name": name, "output_dir": str(work)}}
    trainer = Trainer(cfg, device="cpu", **kw)
    trainer.model.load_state_dict(local_state(trainer.model, sd))  # a TP model: its shard
    trainer.init_state()
    return trainer


def _steps(trainer, images, labels):
    """Each step's global batch through the trainer's own batching (its
    rows of every micro-batch) and train step."""
    step = trainer.train_step_fn()
    metrics = []
    for i in range(len(images)):
        batches = [{"image": images[i, a], "label": labels[i, a]} for a in range(images.shape[1])]
        x, y = trainer._stack_accum(batches)
        _, m = step(trainer.state, x, y, trainer.keys.next(), rows=trainer._step_rows)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics


def train(inp, work):
    """Data-parallel AdamW steps of the batch-norm UNet3D, replicated and
    ZeRO-1; ZeRO-1's shard sizes and a save → resume round trip; a dropout
    model's DP step against the one-process step on the whole batch; a step
    of the class-weighted cross entropy whose two row blocks hold different
    label mixes."""
    from multimodal_organ_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    cfg, sd, images, labels = inp["bn_cfg"], inp["bn_sd"], inp["images"], inp["labels"]
    out = {}
    dp = _trainer(cfg, sd, work, "dp")
    out["dp_rows"] = dp._stack_accum([{"image": images[0, 0], "label": labels[0, 0]}])[0].shape[1]
    out["dp_metrics"] = _steps(dp, images, labels)
    out["dp_state"] = {k: v.clone() for k, v in dp.model.state_dict().items()}

    z1cfg = {**cfg, "parallel": {"zero1": True}}
    z1 = _trainer(z1cfg, sd, work, "z1")
    out["z1_metrics"] = _steps(z1, images, labels)
    out["z1_state"] = {k: v.clone() for k, v in z1.model.state_dict().items()}
    opt = z1.state.optimizer
    halves = []
    for p, shard, d in zip(opt.full, opt.shards, opt.dims):
        moments = opt.inner.inner.state[shard]
        halves.append((tuple(p.shape), d, tuple(moments["exp_avg"].shape),
                       tuple(moments["exp_avg_sq"].shape)))
    out["z1_halves"] = halves
    tree = z1.state.tree()  # the moments gathered on every rank
    save_checkpoint(tree, work / "z1_ckpt", epoch=0)
    resumed = _trainer(z1cfg, sd, work, "z1r", resume_from=str(work / "z1_ckpt"))
    tree2 = resumed.state.tree()
    same = all(torch.equal(tree["params"][k], tree2["params"][k]) for k in tree["params"])
    for idx, slot in tree["opt_state"]["state"].items():
        for key, val in slot.items():
            same = same and torch.equal(torch.as_tensor(val),
                                        torch.as_tensor(tree2["opt_state"]["state"][idx][key]))
    local = [tuple(resumed.state.optimizer.inner.inner.state[s]["exp_avg"].shape)
             for s in resumed.state.optimizer.shards]
    out["z1_resume_exact"] = bool(same) and local == [h[2] for h in halves]
    # one more step of the uninterrupted run and of the resumed one
    _steps(z1, images[:1], labels[:1])
    _steps(resumed, images[:1], labels[:1])
    out["z1_resume_step"] = all(torch.equal(v, resumed.model.state_dict()[k])
                                for k, v in z1.model.state_dict().items())

    dcfg, dsd = inp["drop_cfg"], inp["drop_sd"]
    drop = _trainer(dcfg, dsd, work, "drop")
    one = _trainer(dcfg, dsd, work, "drop1", mesh=False)
    out["drop_dp"] = _steps(drop, images[:1], labels[:1])
    out["drop_one"] = _steps(one, images[:1], labels[:1])
    weighted = _trainer(inp["weighted_cfg"], sd, work, "weighted")
    out["weighted"] = _steps(weighted, images[:1], inp["weighted_labels"])
    return out


def _state(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def adafactor(inp, work, name="af_z1"):
    """Adafactor on this group's mesh (``inp["af_cfg"]`` with
    ``parallel.zero1``; on the 2 × 2 grid tensor parallelism too): two steps
    of the batch-norm UNet3D whose 128-channel block has factored moments,
    from the seeded weights; the whole-layout checkpoint after the first;
    each slice's moment shapes; and the one-process checkpoint of the first
    step resumed here (``inp["af_..._resume_cfg"]``, at its learning rate),
    its second step."""
    from multimodal_organ_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    cfg, sd = inp[f"{name}_cfg"], inp["af_sd"]
    images, labels = inp["af_images"], inp["af_labels"]
    trainer = _trainer(cfg, sd, work, name)
    metrics = _steps(trainer, images[:1], labels[:1])
    save_checkpoint(trainer.state.tree(), work / f"{name}_step1", epoch=0)
    metrics += _steps(trainer, images[1:], labels[1:])
    opt = trainer.state.optimizer
    kept = {n: {k: tuple(v.shape) for k, v in opt.inner.inner.state[s].items()
                if isinstance(v, torch.Tensor)}
            for (n, _), s in zip(trainer.model.named_parameters(), opt.shards)}
    tree = trainer.state.tree()
    resumed = _trainer(inp[f"{name}_resume_cfg"], sd, work, f"{name}_r",
                       resume_from=inp["af_one_step1"])
    return {"metrics": metrics, "params": {k: v.clone() for k, v in tree["params"].items()},
            "kept": kept, "resumed": _steps(resumed, images[1:], labels[1:]),
            "resumed_params": {k: v.clone() for k, v in resumed.state.tree()["params"].items()}}


def _tune_cli(inp, work, key):
    """``--mode tune`` through ``cli.main`` on every rank (the CLI joins the
    group) with the config ``inp[key]``: each rank's report (recorded from
    ``tune_serving``) and its ``write_profile`` calls."""
    from multimodal_organ_segmentation_tpu_torch import cli
    from multimodal_organ_segmentation_tpu_torch.serving import tuner

    reports, writes = [], []
    tune_serving, write_profile = tuner.tune_serving, tuner.write_profile
    tuner.tune_serving = lambda *a, **k: reports.append(tune_serving(*a, **k)) or reports[-1]
    tuner.write_profile = lambda *a, **k: writes.append(a[1]) or write_profile(*a, **k)
    try:
        cli.main(["--mode", "tune", "--config", inp[key], "--device", "cpu",
                  "--output", str(work / f"{key}.yaml")])
    finally:
        tuner.tune_serving, tuner.write_profile = tune_serving, write_profile
    return {"reports": reports, "writes": [str(w) for w in writes]}


def tune(inp, work):
    """``--mode tune`` on both ranks over chunk sizes 1 and 2, the chunk of 1
    made to raise on rank 1 alone before its pass."""
    from multimodal_organ_segmentation_tpu_torch.ops import sliding_window as tsw

    call = tsw.SlidingWindowRunner.__call__

    def failing(self, volume, params=None):
        if dist.get_rank() == 1 and self.sw_batch_size == 1:
            raise RuntimeError("CUDA out of memory")
        return call(self, volume, params)

    tsw.SlidingWindowRunner.__call__ = failing
    try:
        return _tune_cli(inp, work, "tune_config")
    finally:
        tsw.SlidingWindowRunner.__call__ = call


def grid_tune(inp, work):
    """``--mode tune`` on the 2 × 2 grid (the tensor-parallel UNet3D, tile
    chunks over the data axis) over chunk sizes 1 and 2, the chunk of 1 made
    to raise on rank 3 alone in the middle of its forward, at its second
    row-parallel sum (its model group's other rank waits in front of that
    sum); how many sums each rank began in that candidate."""
    from multimodal_organ_segmentation_tpu_torch.ops import sliding_window as tsw
    from multimodal_organ_segmentation_tpu_torch.parallel import tensor_parallel as tp

    call, summed = tsw.SlidingWindowRunner.__call__, tp._summed
    current, sums = {}, [0]

    def tracking(self, volume, params=None):
        current["sw"] = self.sw_batch_size
        return call(self, volume, params)

    def failing(x, group):
        if current.get("sw") == 1:
            sums[0] += 1
            if dist.get_rank() == 3 and sums[0] == 2:
                raise RuntimeError("CUDA out of memory")
        return summed(x, group)

    tsw.SlidingWindowRunner.__call__, tp._summed = tracking, failing
    try:
        return {**_tune_cli(inp, work, "grid_tune_config"), "sums": sums[0]}
    finally:
        tsw.SlidingWindowRunner.__call__, tp._summed = call, summed


def serve(inp, work):
    """The multi-rank service: every rank builds ``InferenceService`` on the
    checkpoint, rank 0 answers a warm-up and a request over HTTP and reads
    ``/v1/stats``, then drains and stops the follower, whose loop returns
    the passes it ran. Then a follower whose rank 0 sends nothing (no
    heartbeat) raises at its receive's timeout."""
    import json
    import threading
    import time
    import urllib.request

    from multimodal_organ_segmentation_tpu_torch.serving import server as srv
    from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode

    cfg = inp["serve_cfg"]
    srv.FOLLOWER_TIMEOUT_S = 4.0
    service = srv.InferenceService(ConfigNode(cfg), inp["serve_ckpt"], device="cpu")
    out = {"mesh": service.mesh_shape}
    if dist.get_rank() == 0:
        httpd = srv.make_server(service, "127.0.0.1", 0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"

        def post(path, body):
            req = urllib.request.Request(url + path, json.dumps(body).encode(),
                                         {"Content-Type": "application/json"})
            return json.loads(urllib.request.urlopen(req, timeout=60).read())

        post("/v1/warmup", {"shape": [20, 18, 22]})
        time.sleep(2.5)  # idle past a heartbeat period: the follower hears pings
        out["segment"] = post("/v1/segment", {"inputs": inp["serve_case"], "case_id": "served",
                                              "output_dir": str(work / "served"),
                                              "probabilities": True})
        out["stats"] = json.loads(urllib.request.urlopen(url + "/v1/stats", timeout=60).read())
        httpd.shutdown()
        httpd.server_close()
        service.close()
    else:
        out["passes"] = service.follow()
        out["stats"] = service.stats()
    # a rank 0 that falls silent: the follower's receive times out and raises
    srv.FOLLOWER_TIMEOUT_S = 2.0
    heartbeat = srv.InferenceService._heartbeat
    srv.InferenceService._heartbeat = lambda self: None
    try:
        silent = srv.InferenceService(ConfigNode(cfg), inp["serve_ckpt"], device="cpu")
    finally:
        srv.InferenceService._heartbeat = heartbeat
    if dist.get_rank() != 0:
        t0 = time.perf_counter()
        try:
            silent.follow()
            out["timeout"] = None
        except RuntimeError as e:
            out["timeout"] = (time.perf_counter() - t0, str(e)[:200])
    dist.barrier()
    return out


def serve_cli(inp, work):
    """``--mode serve`` through ``cli.main`` on both ranks, as ``torchrun``
    runs it (the group exists, so the CLI joins it): rank 0 serves HTTP
    while a client thread reads the port from its log, asks for one
    segmentation and the stats, then sends the process SIGTERM; rank 0
    drains and stops rank 1's loop. Returns the answers and both logs."""
    import json
    import os
    import re
    import signal
    import threading
    import time
    import urllib.request

    from multimodal_organ_segmentation_tpu_torch import cli
    from multimodal_organ_segmentation_tpu_torch.serving import server as srv

    srv.FOLLOWER_TIMEOUT_S = 4.0
    rank = dist.get_rank()
    logs = work / "logs" / inp["serve_cli_name"]
    out = {}

    def client():
        try:
            deadline, port = time.monotonic() + 60, None
            while port is None and time.monotonic() < deadline:
                time.sleep(0.1)
                if (logs / "serve.log").exists():
                    m = re.search(r"on http://[\d.]+:(\d+)", (logs / "serve.log").read_text())
                    port = int(m.group(1)) if m else None
            url = f"http://127.0.0.1:{port}"
            req = urllib.request.Request(url + "/v1/segment", json.dumps(
                {"inputs": inp["serve_case"], "case_id": "cli"}).encode(),
                {"Content-Type": "application/json"})
            out["segment"] = json.loads(urllib.request.urlopen(req, timeout=60).read())
            out["stats"] = json.loads(urllib.request.urlopen(url + "/v1/stats", timeout=60).read())
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    if rank == 0:
        thread = threading.Thread(target=client, daemon=True)
        thread.start()
    try:
        cli.main(["--mode", "serve", "--config", inp["serve_cli_config"], "--device", "cpu",
                  "--checkpoint", inp["serve_ckpt"], "--port", "0"])
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    if rank == 0:
        thread.join(timeout=60)
    out["log"] = (logs / ("serve.log" if rank == 0 else f"serve.rank{rank}.log")).read_text()
    return out


def tensor_parallel(inp, work):
    """A 2 × 2 ``(data, model)`` grid: the mesh's groups; for the tiny
    cross-attention SwinUNETR and the batch-norm UNet3D, a trainer split
    over the model axis that resumes a one-process checkpoint (the logits
    of its weights, the split layers' parameter count a rank), then one
    TP × DP SGD step (its metrics, its gathered checkpoint tree, written;
    the logits after it)."""
    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import make_mesh
    from multimodal_organ_segmentation_tpu_torch.train.checkpoint import save_checkpoint
    from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer
    from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode

    out = {}
    for name in ("swin", "unet"):
        cfg = inp[f"tp_{name}_cfg"]
        x = _t(inp[f"tp_{name}_x"])
        if name == "swin":
            mesh = make_mesh(ConfigNode(cfg))
            out["grid"] = {"shape": dict(mesh.shape), "at": (mesh.axis_rank("data"),
                                                             mesh.axis_rank("model")),
                           "model_group": dist.get_world_size(mesh.group("model")),
                           "data_group": dist.get_world_size(mesh.group("data"))}
        run = {**cfg, "experiment": {**cfg["experiment"], "name": f"tp_{name}",
                                     "output_dir": str(work)}}
        # a one-process checkpoint resumed on the grid: each rank slices it
        trainer = Trainer(run, device="cpu", resume_from=inp[f"one_{name}_ckpt"])
        trainer.init_state()
        plan = trainer.model.tp_plan
        split = sum(v.numel() for k, v in trainer.model.state_dict().items() if k in plan.splits)
        trainer.model.eval()
        with torch.no_grad():
            logits = trainer.model(x)
        trainer.model.train()
        metrics = _steps(trainer, x[None, None].numpy(), inp[f"tp_{name}_y"][None, None])
        tree = trainer.state.tree()  # the whole model's, gathered over the model group
        save_checkpoint(tree, work / f"tp_{name}_ckpt", epoch=0)
        trainer.model.eval()
        with torch.no_grad():
            after = trainer.model(x)
        out[name] = {"logits": logits.numpy(), "split_numel": split, "metrics": metrics,
                     "params": {k: v.clone() for k, v in tree["params"].items()},
                     "after": after.numpy(), "kinds": [lp.kind for lp in plan.layers if lp.split]}
    return out


def grid_adafactor(inp, work):
    """``adafactor`` on the 2 × 2 grid: ZeRO-1 over the data groups and
    tensor parallelism over the model groups, one leaf cut by both."""
    return adafactor(inp, work, "af_tp")


def grid_dual_encoder(inp, work):
    """The DualEncoder with ``sequence_axis: model`` on the 2 × 2 grid: its
    logits on a batch every rank holds (the ring over the model group), and
    one data-parallel step, each data index its row of the batch, the ring
    over the model group under ``rows``; which calls went through the ring."""
    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.parallel import ring_attention as ra
    from multimodal_organ_segmentation_tpu_torch.parallel.mesh import make_mesh, same_input
    from multimodal_organ_segmentation_tpu_torch.train.losses import get_loss
    from multimodal_organ_segmentation_tpu_torch.train.optim import make_optimizer
    from multimodal_organ_segmentation_tpu_torch.train.trainer import TrainState, make_train_step
    from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode

    rings, phase = [], "logits"
    ring = ra.ring_attention
    ra.ring_attention = lambda *a, **k: rings.append((phase, a[4])) or ring(*a, **k)
    try:
        cfg = ConfigNode(inp["gde_cfg"])
        model = build_model(cfg, device="cpu")
        model.load_state_dict(inp["de_sd"])
        x, y = _t(inp["de_x"]), torch.from_numpy(inp["de_y"]).long()
        with torch.no_grad(), same_input():
            logits = model(x)
        phase = "step"
        m = build_model(cfg, device="cpu", train=True)
        m.load_state_dict(inp["de_sd"])
        opt = make_optimizer(cfg, m.parameters())
        mesh = make_mesh(cfg)
        r = mesh.axis_rank("data")
        fn = make_train_step(m, opt, get_loss(cfg), 1, mesh=mesh)
        _, metrics = fn(TrainState(step=0, model=m, optimizer=opt), x[None, r:r + 1],
                        y[None, r:r + 1], rows=(r, 1, 2))
    finally:
        ra.ring_attention = ring
    return {"logits": logits.numpy(), "rings": sorted(set(rings)),
            "levels": [lv for lv in range(4) if hasattr(model, f"fusion_xattn{lv}")],
            "step": {k: float(v) for k, v in metrics.items()}}


def inference(inp, work):
    """``case_shard: auto`` predict (each rank its cases) and native eval
    (merged over the ranks) of the batch-norm UNet3D."""
    from multimodal_organ_segmentation_tpu_torch.data.dataloader import DataLoader
    from multimodal_organ_segmentation_tpu_torch.data.dataset import get_dataset
    from multimodal_organ_segmentation_tpu_torch.data.transforms import get_transforms
    from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer

    cfg = {**inp["infer_cfg"], "experiment": {**inp["infer_cfg"]["experiment"],
                                               "output_dir": str(work)}}
    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(inp["bn_sd"])
    trainer.init_state()
    written = trainer.predict(inp["predict_input"], work / "pred")
    trainer = Trainer(cfg, device="cpu")
    trainer.model.load_state_dict(inp["bn_sd"])
    trainer.init_state()
    ds = get_dataset(trainer.config, split="val",
                     transform=get_transforms(trainer.config, mode="native", device="cpu"))
    metrics = trainer.evaluate_native(DataLoader(ds, batch_size=1, shuffle=False, num_workers=0))
    return {"written": written, "metrics": metrics}


TASKS = {"four": [ring, tensor_parallel, grid_adafactor, grid_dual_encoder, grid_tune],
         "main": [ring, sliding_window, dual_encoder, train, adafactor, inference, serve, serve_cli,
                  tune]}


def main(argv) -> None:
    task, rank, world, rdv, work = argv[0], int(argv[1]), int(argv[2]), argv[3], Path(argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=rank, world_size=world)
    inp = torch.load(work / "inputs.pt", weights_only=False)
    out = {fn.__name__: fn(inp, work) for fn in TASKS[task]}
    torch.save(out, work / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
