"""Multi-process bootstrap: ``torch.distributed.init_process_group`` wiring
(port of the JAX package's ``parallel/multihost.py``).

One process runs per device. Each calls :func:`maybe_initialize_distributed`
first; afterwards the ranks form the mesh (``parallel/mesh.py``) and the
trainer, the sliding window and the ring issue their collectives over it.

Config surface (``parallel.multihost``), as in the JAX package:

- ``auto``  (default) — initialise only when the environment says the job
  has several processes (torchrun's ``RANK`` / ``WORLD_SIZE`` /
  ``MASTER_ADDR``, the JAX package's TPU-pod and coordinator variables) or a
  coordinator is configured, and raise if the rendezvous then fails (the
  JAX package's ``auto`` stays quiet there; here N processes would go on
  as N rank-0 jobs writing the same outputs). Single-process runs are
  untouched.
- ``true``  — force initialisation; raise if the rendezvous fails.
- ``false`` — never initialise.

Coordinator resolution, as in the JAX package: ``parallel.coordinator_address``
/ ``num_processes`` / ``process_id``, then ``JAX_COORDINATOR_ADDRESS`` /
``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``; they become
``init_method=tcp://<address>``, ``world_size`` and ``rank``. With none,
torchrun's environment (``init_method=env://``) stands where the JAX package
asks the TPU pod's metadata.

NCCL serves CUDA ranks and gloo CPU ranks. A CUDA rank without NCCL raises.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

_TPU_POD_ENV_VARS = (
    "TPU_WORKER_HOSTNAMES",  # Cloud TPU pod slices
    "MEGASCALE_COORDINATOR_ADDRESS",  # multislice
)
_TORCHRUN_ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")
_COORD_ENV_VARS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")


def resolve_distributed_args(config=None, env: Optional[Dict[str, str]] = None) -> Dict[str, Any]:
    """The coordinator from config + env: ``{}`` when the launcher's
    environment should be used, else ``coordinator_address`` and, when
    given, ``num_processes`` and ``process_id`` (the JAX package's dict).
    Raises ``ValueError`` if an explicit coordinator is only partially
    specified."""
    env = os.environ if env is None else env
    kwargs: Dict[str, Any] = {}

    def cfg(key):
        return config.get(key, None) if config is not None else None

    addr = cfg("parallel.coordinator_address")
    if addr is None:
        for var in _COORD_ENV_VARS:
            if env.get(var):
                addr = env[var]
                break
    nproc = cfg("parallel.num_processes")
    if nproc is None and env.get("JAX_NUM_PROCESSES"):
        nproc = env["JAX_NUM_PROCESSES"]
    pid = cfg("parallel.process_id")
    if pid is None and env.get("JAX_PROCESS_ID"):
        pid = env["JAX_PROCESS_ID"]

    if addr is None and (nproc is not None or pid is not None):
        raise ValueError(
            "parallel.num_processes/process_id set without a coordinator "
            "address (parallel.coordinator_address or "
            "JAX_COORDINATOR_ADDRESS)"
        )
    if addr is not None:
        kwargs["coordinator_address"] = str(addr)
        if nproc is not None:
            kwargs["num_processes"] = int(nproc)
        if pid is not None:
            kwargs["process_id"] = int(pid)
        if (nproc is None) != (pid is None):
            raise ValueError(
                "explicit multihost config needs BOTH parallel.num_processes "
                "and parallel.process_id (env: JAX_NUM_PROCESSES / "
                "JAX_PROCESS_ID)"
            )
    return kwargs


def multihost_env_detected(env: Optional[Dict[str, str]] = None) -> bool:
    """True when the environment indicates a multi-process run."""
    env = os.environ if env is None else env
    if any(env.get(v) for v in _TPU_POD_ENV_VARS + _TORCHRUN_ENV_VARS):
        return True
    return any(env.get(v) for v in _COORD_ENV_VARS)


def backend_for(device) -> str:
    """NCCL for a CUDA device (raises where torch has none), gloo otherwise."""
    if torch.device(device).type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA rank needs NCCL, which this torch build lacks")
        return "nccl"
    return "gloo"


def maybe_initialize_distributed(config=None, env: Optional[Dict[str, str]] = None,
                                 device="cpu") -> bool:
    """Initialise ``torch.distributed`` per ``parallel.multihost``, with
    :func:`backend_for` the ranks' ``device``; True iff a process group
    exists afterwards."""
    mode = "auto"
    if config is not None:
        value = config.get("parallel.multihost", "auto")
        # YAML's false is off (the JAX package's `value or "auto"` reads it as auto)
        mode = "false" if value is False else str(value or "auto").lower()
    if mode in ("false", "off", "none", "0"):
        return False
    if dist.is_initialized():
        return True

    explicit = mode in ("true", "on", "1", "force")
    kwargs = resolve_distributed_args(config, env)
    # a coordinator configured in YAML counts as detection too: "auto" must
    # not let N processes train as N independent jobs
    detected = multihost_env_detected(env) or bool(kwargs)
    if not explicit and not detected:
        return False
    backend = backend_for(device)
    if "coordinator_address" in kwargs:
        dist.init_process_group(
            backend, init_method=f"tcp://{kwargs['coordinator_address']}",
            world_size=kwargs.get("num_processes", 1), rank=kwargs.get("process_id", 0))
    else:
        dist.init_process_group(backend, init_method="env://")
    return True


def allgather_payloads(obj: Any) -> list:
    """One picklable host object per process, ``[payload of rank 0, ...,
    payload of rank n-1]`` on every process (``[obj]`` in one process)."""
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out
