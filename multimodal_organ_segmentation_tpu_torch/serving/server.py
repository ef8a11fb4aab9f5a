"""HTTP segmentation service (port of the JAX package's ``serving/server.py``).

The model stays resident and serves requests over HTTP, as a clinical
pipeline or a batch farm consumes a segmentation engine: no process start,
checkpoint load or kernel build per case.

- One ``SlidingWindowRunner`` serves every shape; ``num_compiled`` counts
  the (bucket, channels, chunks) keys it has seen (eager PyTorch compiles
  nothing; ``/v1/warmup`` runs a zero volume of a shape, which builds the
  kernels on the first call and warms the allocator).
- Device work holds one lock: one card runs one sliding-window pass at a
  time. The NIfTI decode, the host copy of the mask, postprocess and the
  NIfTI writes run outside it, so one request's host work overlaps
  another's card time.
- Transport is filesystem paths in JSON, not tensors: clinical volumes are
  hundreds of MB and pipelines share storage.
- The model is a port checkpoint (``tree.pt`` directory, through the
  ``Trainer``) or an exported program (``--mode export --format pt2``, see
  ``models/program_export.py``), which calls kernels A and B through the
  port's custom ops.

Endpoints (JSON in/out):

- ``GET  /healthz``      → {status, model, compiled_buckets, requests}
- ``GET  /v1/stats``     → request/rejection/error counters + latency
                          percentiles (p50/p95/max over a sliding window)
- ``POST /v1/warmup``    {"shape": [H, W, D]} → run that shape once
- ``POST /v1/segment``   {"inputs": {MOD: path, ...}, "output_dir": ...,
                          "case_id": ..., "probabilities": bool,
                          "uncertainty": bool} → run +
                          save {case}_pred.nii.gz (+ {case}_prob.nii.gz)

The service runs on the CUDA device unless ``device="cpu"`` is asked for;
without a card it raises.

Several ranks (``torchrun``, one device each): every rank builds the service
and its model (split over the model group under tensor parallelism), and
rank 0 alone owns the HTTP server. Rank 0 admits a request, loads and
normalises the volume, then, holding the device lock, broadcasts it to every
rank (a header with the operation, shape and dtype over a gloo control
group, then the volume); every rank runs the same sliding-window pass, the
tile chunks split over the data axis (``Trainer._inference_mesh``), and rank
0 post-processes, writes and answers. The other ranks wait in
``InferenceService.follow``; while idle, rank 0 sends a heartbeat every
quarter of ``FOLLOWER_TIMEOUT_S`` (120 s), and a follower whose receive
outlasts that timeout raises instead of waiting forever. At
shutdown rank 0 drains, then sends the stop that ends every follower's
loop. ``/v1/stats`` is rank 0's, with the mesh's shape (``mesh``, only in
a job of several ranks: the one-process stats are the JAX service's).
"""

from __future__ import annotations

import collections
import datetime
import json
import threading
import time
import zipfile
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

# several ranks: how long a follower's receive waits for rank 0 before it
# raises; idle rank 0 pings every quarter of it, and during a pass the
# followers wait in the runner's collectives, not on this receive
FOLLOWER_TIMEOUT_S = 120.0


def _is_program_artifact(path) -> bool:
    """An exported program is a zip FILE; a port checkpoint is a directory."""
    p = Path(path)
    return p.is_file() and zipfile.is_zipfile(p)


class RequestError(ValueError):
    """Client-side fault (bad paths, missing modalities, malformed volume).

    The HTTP layer maps this (and ``FileNotFoundError``) to 400; every other
    exception is a genuine server fault and surfaces as a logged 500.
    """


class ServiceBusyError(RuntimeError):
    """Admission control rejected the request; maps to HTTP 503."""


class InferenceService:
    """Resident model + sliding-window engine.

    ``segment`` is thread-safe: NIfTI IO runs concurrently, device work is
    serialized. Statistics mirror what the batch CLI logs per case.
    """

    def __init__(self, config, checkpoint_path, logger=None, device=None):
        from multimodal_organ_segmentation_tpu_torch.cli import resolve_device
        from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import (
            SlidingWindowRunner,
        )

        from multimodal_organ_segmentation_tpu_torch.parallel.mesh import make_mesh, world

        self.rank, self.world = world()
        self.config = config
        self.logger = logger
        self.device = resolve_device(device)
        sw_cfg = config.get("inference.sliding_window", {}) or {}

        if _is_program_artifact(checkpoint_path):
            # the artifact is the model: weights baked in, no checkpoint and
            # no model config needed (models/program_export.py)
            from multimodal_organ_segmentation_tpu_torch.models.program_export import (
                load_program,
            )

            call, meta = load_program(checkpoint_path, device=self.device)
            shape = meta["input"]["shape"]  # ["b", H, W, D, C]
            roi = tuple(int(s) for s in shape[1:4])
            num_classes = int(meta.get("num_classes", 0) or 0)
            if num_classes <= 0:
                raise ValueError(f"{checkpoint_path}: artifact metadata lacks num_classes")
            self.modalities = list(
                meta.get("modalities") or config.get("data.modalities", ["CT", "PET"]))
            if len(self.modalities) != int(shape[4]):
                raise ValueError(
                    f"{checkpoint_path}: artifact takes {shape[4]} input "
                    f"channels but modalities are {self.modalities}")

            def predict_fn(params, patches):
                with torch.no_grad():
                    return call(patches)

            self._members: List[Any] = [None]
            model_name = f"{meta.get('model', 'unknown')} (pt2)"
            mesh = make_mesh(config) if self.world > 1 else None
            if mesh is not None and mesh.shape["model"] > 1:
                raise ValueError(f"{checkpoint_path}: an exported program holds the whole model; "
                                 "it cannot be split over a model axis > 1")
            dp_mesh = mesh if mesh is not None and mesh.shape["data"] > 1 else None
        else:
            from multimodal_organ_segmentation_tpu_torch.train.trainer import Trainer

            # the checkpoint is self-sufficient; a stale model.pretrained
            # path from the training config may not exist on the serving
            # machine (same rule as eval / inference / export)
            config.set("model.pretrained", None)
            trainer = Trainer(config, logger=logger, device=self.device)
            roi = tuple(config.get("inference.sliding_window.roi_size", [96, 96, 96]))
            self.modalities = list(config.get("data.modalities", ["CT", "PET"]))
            trainer.init_state()
            trainer.load_params(checkpoint_path)
            # the resident service never trains: drop the restored optimiser
            # moments (2x the parameters) and serve the inference weights
            # (EMA-selected) in the compute dtype
            trainer.freeze_for_inference()
            # EMA selection + inference.ensemble: the member list of batch
            # predict, so the two serving surfaces cannot diverge
            self._members = trainer._inference_members()
            num_classes = trainer.num_classes
            predict_fn = trainer._predict_fn
            model_name = str(config.get("model.name", "unknown"))
            mesh = trainer.mesh
            # the rule of batch predict: tile chunks over the data axis
            dp_mesh = trainer._inference_mesh()

        self.runner = SlidingWindowRunner(
            predict_fn,
            roi_size=roi,
            num_classes=num_classes,
            overlap=float(sw_cfg.get("overlap", 0.5)),
            sw_batch_size=config.get("inference.batch_size", 4),
            mode=str(sw_cfg.get("mode", "gaussian")),
            mesh=dp_mesh,
        )
        self.mesh_shape = (dict(mesh.shape) if mesh is not None else {"data": 1, "model": 1})
        self._variables = self._members[0]
        self.model_name = model_name
        self.normalize = bool(config.get("inference.normalize", False))
        self.tta = bool(config.get("inference.tta", False))
        self._device_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self.requests_served = 0
        # operational counters + a sliding latency window (512 requests ≈
        # hours of clinical traffic; bounded so a long-lived process never
        # grows). Guarded by _stats_lock.
        self._counters = collections.Counter()
        self._latencies = {
            k: collections.deque(maxlen=512) for k in ("total_s", "device_s", "load_s")
        }
        # admission control: each in-flight request holds a decoded clinical
        # volume (hundreds of MB) in host RAM while queued on the device
        # lock; bound that, and shed the rest with 503 instead of running
        # the long-lived process out of memory
        self.max_in_flight = max(1, int(config.get("serving.max_in_flight", 4)))
        self._admission = threading.BoundedSemaphore(self.max_in_flight)
        # cap per-request device memory: a whole-body PET/CT is ~112M voxels
        # (400×400×700); anything past this is a malformed or abusive
        # request, not a clinical volume
        self.max_volume_voxels = int(config.get("serving.max_volume_voxels", 128_000_000))
        # several ranks: a gloo control group (headers, heartbeats, stop)
        # whose receives time out, made on every rank at the same point
        self._control = None
        self._last_sent = time.monotonic()
        self._closed = threading.Event()
        self._fault: Optional[BaseException] = None
        self.follower_timeout_s = FOLLOWER_TIMEOUT_S
        if self.world > 1:
            import torch.distributed as dist

            self._control = dist.new_group(
                backend="gloo", timeout=datetime.timedelta(seconds=self.follower_timeout_s))
            if self.rank == 0:
                threading.Thread(target=self._heartbeat, name="serve-heartbeat",
                                 daemon=True).start()

    # -- several ranks ----------------------------------------------------

    def _send(self, header: Dict[str, Any], volume: Optional[torch.Tensor] = None) -> None:
        """Rank 0, under the device lock: ``header`` to every rank over the
        control group, then ``volume`` over the default group."""
        import torch.distributed as dist

        if self._control is None:
            return
        if self._closed.is_set():
            raise ServiceBusyError("the service is shutting down")
        if self._fault is not None:
            raise RuntimeError(f"a follower rank is lost: {self._fault}")
        dist.broadcast_object_list([header], src=0, group=self._control)
        if volume is not None:
            dist.broadcast(volume.contiguous(), src=0)
        self._last_sent = time.monotonic()

    def _heartbeat(self) -> None:
        """Rank 0: a ping whenever no message went out for a quarter of the
        followers' timeout, until ``close``."""
        period = self.follower_timeout_s / 4
        while not self._closed.wait(period / 4):
            if time.monotonic() - self._last_sent < period:
                continue
            with self._device_lock:
                if self._closed.is_set():
                    return
                try:
                    self._send({"op": "ping"})
                except Exception as e:  # the group is broken: requests fail from here
                    self._fault = e
                    if self.logger:
                        self.logger.error(f"serve heartbeat failed: {e}")
                    return

    def close(self) -> None:
        """Rank 0: end every follower's loop (after the HTTP server drained)."""
        with self._device_lock:
            if self._closed.is_set():
                return
            self._closed.set()
            if self._control is not None and self.rank == 0 and self._fault is None:
                import torch.distributed as dist

                dist.broadcast_object_list([{"op": "stop"}], src=0, group=self._control)

    def follow(self) -> int:
        """A rank other than 0: run every pass rank 0 broadcasts until its
        stop; returns the passes run. A receive that outlasts
        ``FOLLOWER_TIMEOUT_S`` (rank 0 gone) raises."""
        import torch.distributed as dist

        from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import (
            ensemble_run_sw,
            predict_labels,
        )

        run_sw = ensemble_run_sw(self.runner, self._members)
        passes = 0
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=0, group=self._control)
            header = box[0]
            op = header["op"]
            if op == "stop":
                self._closed.set()
                return passes
            if op == "ping":
                continue
            vol = torch.empty(header["shape"], dtype=getattr(torch, header["dtype"]),
                              device=self.device)
            dist.broadcast(vol, src=0)
            if op == "warmup":
                self.runner(vol, self._variables)
                self._count("warmups")
            else:
                predict_labels(run_sw, vol, tta=self.tta)
                with self._stats_lock:
                    self.requests_served += 1
            passes += 1

    def _count(self, key: str, n: int = 1) -> None:
        with self._stats_lock:
            self._counters[key] += n

    def _check_volume_shape(self, h: int, w: int, d: int) -> None:
        if min(h, w, d) < 1:
            raise RequestError(f"volume shape ({h}, {w}, {d}) has empty axes")
        if h * w * d > self.max_volume_voxels:
            raise RequestError(
                f"volume shape ({h}, {w}, {d}) exceeds "
                f"serving.max_volume_voxels={self.max_volume_voxels}")

    def _admit(self) -> None:
        if not self._admission.acquire(blocking=False):
            self._count("rejected")
            raise ServiceBusyError(
                f"{self.max_in_flight} requests already in flight; retry later")

    # -- operations -------------------------------------------------------

    def warmup(self, shape) -> Dict[str, Any]:
        """Run one zero volume of ``shape`` through the runner."""
        from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import bucket_shape

        try:
            h, w, d = (int(s) for s in shape)
        except (TypeError, ValueError) as e:
            raise RequestError(f"shape must be 3 ints, got {shape!r}") from e
        self._check_volume_shape(h, w, d)
        # a warm-up holds the device lock like a request: it goes through
        # the same admission gate
        self._admit()
        try:
            bucket = bucket_shape((h, w, d), self.runner.roi_size, self.runner.overlap)
            t0 = time.perf_counter()
            vol = torch.zeros((h, w, d, len(self.modalities)), dtype=torch.float32,
                              device=self.device)
            with self._device_lock:
                self._send({"op": "warmup", "shape": list(vol.shape), "dtype": "float32"}, vol)
                self.runner(vol, self._variables)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            self._count("warmups")
            return {
                "bucket": list(bucket),
                "compiled_buckets": self.runner.num_compiled,
                "warmup_s": round(time.perf_counter() - t0, 3),
            }
        finally:
            self._admission.release()

    def segment(
        self,
        inputs: Dict[str, str],
        output_dir: Optional[str] = None,
        case_id: Optional[str] = None,
        probabilities: bool = False,
        uncertainty: bool = False,
    ) -> Dict[str, Any]:
        """Segment one case given ``{modality: nifti_path}``.

        ``probabilities`` also writes ``{case}_prob.nii.gz`` (4D float32
        per-class softmax) next to the mask — the batch CLI's
        ``inference.save_probabilities``. ``uncertainty`` writes
        ``{case}_unc.nii.gz`` (3D float32 normalised predictive entropy),
        the CLI's ``inference.save_uncertainty``."""
        self._admit()
        try:
            result = self._segment(inputs, output_dir, case_id,
                                   probabilities=probabilities, uncertainty=uncertainty)
        except (RequestError, FileNotFoundError):
            self._count("client_errors")
            raise
        except Exception:
            self._count("server_errors")
            raise
        finally:
            self._admission.release()
        with self._stats_lock:
            for k, dq in self._latencies.items():
                dq.append(result[k])
        return result

    def _segment(self, inputs, output_dir, case_id, probabilities: bool = False,
                 uncertainty: bool = False) -> Dict[str, Any]:
        from multimodal_organ_segmentation_tpu_torch.ops.postprocess import (
            postprocess_from_config,
        )
        from multimodal_organ_segmentation_tpu_torch.ops.sliding_window import (
            bucket_shape,
            ensemble_run_sw,
            predict_labels,
            predictive_entropy,
        )
        from multimodal_organ_segmentation_tpu_torch.utils.io import (
            load_case_channels,
            save_nifti,
        )

        missing = [m for m in self.modalities if m not in inputs]
        if missing:
            raise RequestError(f"missing modalities {missing}; need {self.modalities}")
        if (probabilities or uncertainty) and output_dir is None:
            # these volumes only exist as saved files; computing and
            # fetching hundreds of MB just to drop them would be silent
            # waste — refuse up front
            which = "probabilities" if probabilities else "uncertainty"
            raise RequestError(f"{which}: true requires output_dir")

        t0 = time.perf_counter()
        try:
            image_np, affine = load_case_channels(inputs, self.modalities)
        except (ValueError, OSError) as e:
            # garbage/mismatched/corrupt client volumes, not our bug
            # (gzip.BadGzipFile is an OSError)
            raise RequestError(f"cannot assemble input volume: {e}") from e
        self._check_volume_shape(*image_np.shape[:3])
        image = torch.from_numpy(image_np)
        if self.device.type == "cuda":
            image = image.pin_memory()
        image = image.to(self.device, non_blocking=True)
        if self.normalize:
            from multimodal_organ_segmentation_tpu_torch.data.transforms import (
                normalize_from_config,
            )

            image = normalize_from_config(image, self.config)
        t_io = time.perf_counter()

        # only the device work holds the lock; the host copy of the mask
        # (tens of MB, which waits for the card) runs outside it, so the
        # next request's work can be queued behind this one's
        is_ensemble = len(self._members) > 1
        run_sw = ensemble_run_sw(self.runner, self._members)
        probs = unc = None
        with self._device_lock:
            self._send({"op": "segment", "shape": list(image.shape),
                        "dtype": str(image.dtype).split(".")[-1], "case_id": case_id}, image)
            if probabilities or uncertainty:
                pred_dev, probs_dev = predict_labels(
                    run_sw, image, tta=self.tta, return_probs=True, already_probs=is_ensemble)
                if uncertainty:
                    unc_dev = predictive_entropy(probs_dev)
            else:
                pred_dev = predict_labels(run_sw, image, tta=self.tta)
        pred = pred_dev.cpu().numpy().astype(np.uint8)
        if probabilities:
            probs = probs_dev.float().cpu().numpy()
        if uncertainty:
            unc = unc_dev.float().cpu().numpy()
        t_dev = time.perf_counter()
        # host-side cleanup stays OUTSIDE device_s so the /v1/stats
        # device-latency percentiles measure the card, not scipy
        pred = postprocess_from_config(pred, self.config)

        result: Dict[str, Any] = {
            "case_id": case_id,
            "shape": list(image.shape[:3]),
            "bucket": list(bucket_shape(tuple(image.shape[:3]), self.runner.roi_size,
                                        self.runner.overlap)),
            "compiled_buckets": self.runner.num_compiled,
            "class_voxels": {
                int(c): int(n)
                for c, n in zip(*(a.tolist() for a in np.unique(pred, return_counts=True)))
            },
            "load_s": round(t_io - t0, 3),
            "device_s": round(t_dev - t_io, 3),
        }
        if output_dir is not None:
            out_dir = Path(output_dir)
            out_dir.mkdir(parents=True, exist_ok=True)
            name = case_id or Path(next(iter(inputs.values()))).stem.split(".")[0]
            out_file = out_dir / f"{name}_pred.nii.gz"
            save_nifti(pred, out_file, affine=affine)
            result["output"] = str(out_file)
            if probs is not None:
                prob_file = out_dir / f"{name}_prob.nii.gz"
                save_nifti(probs, prob_file, affine=affine)
                result["probabilities"] = str(prob_file)
            if unc is not None:
                unc_file = out_dir / f"{name}_unc.nii.gz"
                save_nifti(unc, unc_file, affine=affine)
                result["uncertainty"] = str(unc_file)
        result["total_s"] = round(time.perf_counter() - t0, 3)
        with self._stats_lock:
            self.requests_served += 1
        if self.logger:
            self.logger.info(f"served case={case_id} {result['shape']} in {result['total_s']}s")
        return result

    def health(self) -> Dict[str, Any]:
        return {
            "status": "ok",
            "model": self.model_name,
            "modalities": self.modalities,
            "roi_size": list(self.runner.roi_size),
            "overlap": self.runner.overlap,
            "compiled_buckets": self.runner.num_compiled,
            "requests": self.requests_served,
        }

    def stats(self) -> Dict[str, Any]:
        """Operational counters + latency percentiles over the sliding
        512-request window: what a dashboard scrapes."""

        def pct(sorted_xs, q: float) -> float:
            i = min(len(sorted_xs) - 1, int(round(q * (len(sorted_xs) - 1))))
            return sorted_xs[i]

        with self._stats_lock:
            counters = dict(self._counters)
            lats = {k: sorted(dq) for k, dq in self._latencies.items()}
            served = self.requests_served
        out: Dict[str, Any] = {
            "requests": served,
            "rejected": counters.get("rejected", 0),
            "client_errors": counters.get("client_errors", 0),
            "server_errors": counters.get("server_errors", 0),
            "warmups": counters.get("warmups", 0),
            "compiled_buckets": self.runner.num_compiled,
            "max_in_flight": self.max_in_flight,
            "window": len(lats["total_s"]),
        }
        if getattr(self, "world", 1) > 1:  # a multi-rank service: its mesh (JAX's has none)
            out["mesh"] = dict(self.mesh_shape)
        for name, xs in lats.items():
            if xs:
                out[name] = {
                    "p50": round(pct(xs, 0.50), 3),
                    "p95": round(pct(xs, 0.95), 3),
                    "max": round(xs[-1], 3),
                }
        return out


def make_server(service: InferenceService, host: str = "127.0.0.1", port: int = 8080):
    """Build (not start) a ``ThreadingHTTPServer`` around ``service``."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through our logger
            if service.logger:
                service.logger.debug("http: " + fmt % args)

        def _reply(self, code: int, payload: Dict[str, Any]):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, service.health())
            elif self.path == "/v1/stats":
                self._reply(200, service.stats())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad request body: {e}"})
                return
            if not isinstance(req, dict):
                self._reply(400, {"error": "request body must be a JSON object"})
                return
            try:
                if self.path == "/v1/segment":
                    self._reply(200, service.segment(
                        req.get("inputs", {}),
                        output_dir=req.get("output_dir"),
                        case_id=req.get("case_id"),
                        probabilities=bool(req.get("probabilities", False)),
                        uncertainty=bool(req.get("uncertainty", False)),
                    ))
                elif self.path == "/v1/warmup":
                    self._reply(200, service.warmup(req.get("shape", [96, 96, 96])))
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except (RequestError, FileNotFoundError) as e:
                self._reply(400, {"error": str(e)})
            except ServiceBusyError as e:
                self._reply(503, {"error": str(e)})
            except Exception as e:  # keep the server alive on internal errors
                if service.logger:
                    service.logger.error(f"serve error: {e}", exc_info=True)
                self._reply(500, {"error": str(e)})

    return ThreadingHTTPServer((host, port), Handler)


def run_serve(config, logger, device=None) -> None:
    """CLI glue for ``--mode serve``: the service on ``device`` (default: the
    config's ``hardware.device``, else the card), warm-ups, then requests
    until SIGTERM, which drains in-flight requests and exits 0."""
    ckpt = config["_args"].get("checkpoint")
    if ckpt is None:
        raise ValueError(
            "--checkpoint is required for serve mode (a port checkpoint dir, or "
            "an exported program from --mode export --format pt2)")
    host = str(config.get("serving.host", "127.0.0.1"))
    p = config["_args"].get("port")  # 0 is valid: OS-assigned free port
    port = int(p) if p is not None else int(config.get("serving.port", 8080))
    device = device if device is not None else config.get("hardware.device", None)
    service = InferenceService(config, ckpt, logger=logger, device=device)
    import signal

    if service.rank != 0:
        # a follower: rank 0 owns the HTTP server and ends this loop with its
        # stop after it drained; a SIGTERM here (a launcher stopping the job)
        # waits for that stop, which the receive's timeout bounds
        try:
            signal.signal(signal.SIGTERM, lambda signum, frame: logger.info(
                "SIGTERM: waiting for rank 0's stop"))
        except ValueError:
            pass
        logger.info(f"rank {service.rank} of {service.world} follows rank 0's requests")
        passes = service.follow()
        logger.info(f"rank {service.rank}: stop after {passes} passes; final stats: "
                    f"{json.dumps(service.stats())}")
        return
    for shape in config.get("serving.warmup_shapes", []) or []:
        info = service.warmup(shape)
        logger.info(f"warmup {list(shape)} → bucket {info['bucket']} ({info['warmup_s']}s)")
    server = make_server(service, host, port)
    bound_port = server.server_address[1]  # real port when --port 0

    # a supervisor stops the service with SIGTERM: stop accepting, let
    # in-flight requests drain, exit 0 so it restarts cleanly elsewhere
    def _term(signum, frame):
        logger.info("SIGTERM: draining and shutting down")
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:  # not the main thread (embedded use)
        pass
    logger.info(f"serving {service.model_name} on http://{host}:{bound_port} "
                f"(endpoints: /healthz, /v1/stats, /v1/warmup, /v1/segment; {service.world} "
                f"rank(s), mesh {service.mesh_shape})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()  # after the last device pass: ends the followers' loops
        logger.info(f"final stats: {json.dumps(service.stats())}")
