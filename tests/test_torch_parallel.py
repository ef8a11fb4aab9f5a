"""The port's multi-device helpers that need no process group, against the
JAX package: ``make_mesh``'s shapes and errors, ``zero1_spec``, the
coordinator resolution and environment detection of ``parallel/multihost``,
the initialisation policy, and the shardings' blocks. Exact."""

import numpy as np
import pytest
import torch

import jax

from multimodal_organ_segmentation_tpu.parallel import mesh as jmesh
from multimodal_organ_segmentation_tpu.parallel import multihost as jmh
from multimodal_organ_segmentation_tpu.utils.config import ConfigNode as JConfig
from multimodal_organ_segmentation_tpu_torch import parallel as tpar
from multimodal_organ_segmentation_tpu_torch.parallel import mesh as tmesh
from multimodal_organ_segmentation_tpu_torch.parallel import multihost as tmh
from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode, load_config
from tests.torch_port_utils import _one_thread  # noqa: F401

MESHES = [None, {"data": -1, "model": 1}, {"data": -1, "model": 2}, {"data": 2, "model": 2},
          {"data": 4, "model": 2}, {"data": 3, "model": 5}, {"data": 8}, {"model": 3}]


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("ValueError", str(e))


def test_make_mesh_follows_jax_for_one_to_eight_devices():
    """Every mesh config on 1 to 8 devices: the same shape and device grid,
    or the same error; the shipped configs' meshes too."""
    import glob

    configs = [{"parallel": {"mesh": m}} if m is not None else {} for m in MESHES]
    for path in sorted(glob.glob("configs/*.yaml")):
        configs.append({"parallel": {"mesh": dict(load_config(path).get("parallel.mesh", {})
                                                  or {})}})
    checked = 0
    for n in range(1, 9):
        devices = jax.devices()[:n]
        for cfg in configs:
            want = _outcome(lambda: jmesh.make_mesh(JConfig(cfg), devices))
            got = _outcome(lambda: tmesh.make_mesh(ConfigNode(cfg), list(range(n))))
            if isinstance(want, tuple):
                assert got == want, (n, cfg)
                continue
            assert got.shape == dict(want.shape), (n, cfg)
            np.testing.assert_array_equal(got.devices, np.vectorize(lambda d: d.id)(want.devices))
            checked += 1
    assert checked > 40
    assert tpar.make_mesh is tmesh.make_mesh and tmesh.make_mesh().shape == {"data": 1, "model": 1}


def test_zero1_spec_matches_jax():
    shapes = [(3, 3, 3, 8, 16), (16,), (), (3, 5), (8, 24), (24, 8), (12, 12), (48, 2, 4, 4, 4),
              (1,), (0, 8), (7, 14, 21), (2, 3, 2, 3)]
    for shape in shapes:
        for n in (1, 2, 3, 4, 8):
            assert tmesh.zero1_spec(shape, n) == tuple(jmesh.zero1_spec(shape, n)), (shape, n)
            assert tmesh.zero1_spec(shape, n, "model") == tuple(
                jmesh.zero1_spec(shape, n, "model")), (shape, n)


RESOLVE_CASES = [
    ({}, {}),
    ({"parallel": {"coordinator_address": "10.0.0.1:8476", "num_processes": 4,
                   "process_id": 2}}, {}),
    ({}, {"JAX_COORDINATOR_ADDRESS": "host:1234", "JAX_NUM_PROCESSES": "2",
          "JAX_PROCESS_ID": "1"}),
    ({"parallel": {"coordinator_address": "cfg:1"}}, {"JAX_COORDINATOR_ADDRESS": "env:2"}),
    ({}, {"COORDINATOR_ADDRESS": "h:7"}),
    ({"parallel": {"coordinator_address": "h:1", "num_processes": 2}}, {}),
    ({"parallel": {"num_processes": 2}}, {}),
    ({}, {"JAX_PROCESS_ID": "0"}),
    ({}, {"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "localhost"}),
]


def test_resolve_distributed_args_and_detection_match_jax():
    """The JAX package's own cases (``tests/test_multihost.py``) and a few
    more: the same dict or the same error; the same detection, where
    torchrun's variables are detected by the port alone."""
    for cfg, env in RESOLVE_CASES:
        want = _outcome(lambda: jmh.resolve_distributed_args(JConfig(cfg) if cfg else None,
                                                              env=env))
        got = _outcome(lambda: tmh.resolve_distributed_args(ConfigNode(cfg) if cfg else None,
                                                             env=env))
        assert got == want, (cfg, env)
    for env in ({}, {"TPU_WORKER_HOSTNAMES": "a,b"}, {"JAX_COORDINATOR_ADDRESS": "h:1"},
                {"MEGASCALE_COORDINATOR_ADDRESS": "m:1"}, {"OTHER": "1"}):
        assert tmh.multihost_env_detected(env=env) == jmh.multihost_env_detected(env=env), env
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        assert tmh.multihost_env_detected(env={var: "1"})


def test_initialisation_policy(monkeypatch):
    """``false`` never initialises; ``auto`` does nothing alone and
    initialises for a configured coordinator (tcp://) or torchrun's
    environment (env://); a failed rendezvous raises there as under
    ``true``. NCCL for a CUDA rank, gloo for the CPU."""
    calls = []
    monkeypatch.setattr(tmh.dist, "is_initialized", lambda: False)
    monkeypatch.setattr(tmh.dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    env = {"JAX_COORDINATOR_ADDRESS": "h:1"}
    assert tmh.maybe_initialize_distributed(ConfigNode({"parallel": {"multihost": False}}),
                                            env=env) is False
    assert tmh.maybe_initialize_distributed(ConfigNode({}), env={}) is False
    cfg = ConfigNode({"parallel": {"multihost": "auto", "coordinator_address": "10.0.0.1:8476",
                                   "num_processes": 2, "process_id": 1}})
    assert tmh.maybe_initialize_distributed(cfg, env={}) is True
    assert tmh.maybe_initialize_distributed(None, env={"WORLD_SIZE": "2"}) is True
    assert calls == [("gloo", {"init_method": "tcp://10.0.0.1:8476", "world_size": 2, "rank": 1}),
                     ("gloo", {"init_method": "env://"})]

    def fail(backend, **kw):
        raise RuntimeError("no rendezvous")

    monkeypatch.setattr(tmh.dist, "init_process_group", fail)
    with pytest.raises(RuntimeError, match="no rendezvous"):
        tmh.maybe_initialize_distributed(None, env={"WORLD_SIZE": "2"})
    with pytest.raises(RuntimeError, match="no rendezvous"):
        tmh.maybe_initialize_distributed(ConfigNode({"parallel": {"multihost": True}}), env={})
    assert tmh.backend_for("cpu") == "gloo"
    monkeypatch.setattr(tmh.dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        tmh.backend_for("cuda")
    assert tmh.allgather_payloads({"a": 1}) == [{"a": 1}]


def test_shardings_give_each_rank_its_block(monkeypatch):
    """``batch_rows``: rank r of a data axis of n holds rows
    ``[r·b/n, (r+1)·b/n)``, JAX's block order; ``dropout_rows`` keeps those
    rows of the whole batch's mask; the ranks share one batch only under
    ``rows`` or ``same_input``."""
    x = torch.ones(8, 3, 5)
    torch.manual_seed(0)
    whole = torch.nn.functional.dropout(x, 0.5, True)
    for rank in range(4):
        monkeypatch.setattr(tmesh, "world", lambda rank=rank: (rank, 4))
        mesh = tmesh.make_mesh()
        assert tmesh.batch_rows(8, mesh) == (2 * rank, 2)
        assert tmesh.dropout_rows(x[:2], 0.5, False) is None
        assert not tmesh.ranks_share_batch()
        with tmesh.rows(*tmesh.batch_rows(8, mesh), 8, mesh):
            torch.manual_seed(0)
            assert torch.equal(tmesh.dropout_rows(x[:2], 0.5, False), whole[2 * rank:2 * rank + 2])
            assert tmesh.ranks_share_batch()
        with tmesh.same_input():
            assert tmesh.ranks_share_batch()
        assert not tmesh.ranks_share_batch()
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.batch_rows(6, mesh)
