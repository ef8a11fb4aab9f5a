"""Helpers for the PyTorch-port parity tests (``tests/test_torch_*.py``).

Parameters of a flax module are made without an eager ``init``: the shapes
come from ``jax.eval_shape`` and the values from a numpy seed, so the JAX
side and the port get the same weights. Data crosses between the two
packages as numpy arrays.

Every port test module imports ``_one_thread``, which pytest then applies
to each test of that module.
"""

import numpy as np
import pytest
import torch

import jax


def init_shapes(module, *args, **kwargs):
    """The module's variable shapes, via ``jax.eval_shape`` (no compute)."""
    return jax.eval_shape(lambda key: module.init(key, *args, **kwargs), jax.random.key(0))


def fill_params(shapes, seed: int = 0):
    """Seeded f32 numpy values for every leaf of a shape tree: lecun-scaled
    kernels, and biases, norm scales and relative-position tables far enough
    from their init values that a wrong mapping shows."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [str(getattr(p, "key", p)) for p in path]
        shape = leaf.shape
        if names[-1] == "kernel":
            stacked = "blocks" in names  # scan_blocks leaves lead with depth
            fan_in = int(np.prod(shape[1 if stacked else 0:-1]))
            a = rng.normal(size=shape) / np.sqrt(fan_in)
        elif names[-1] == "scale":
            a = 1.0 + 0.1 * rng.normal(size=shape)
        elif names[-1] == "rel_pos_bias":
            a = 0.5 * rng.normal(size=shape)
        elif names[-1] == "var":  # batch norm's running variance
            a = 1.0 + 0.5 * rng.random(size=shape)
        else:
            a = 0.1 * rng.normal(size=shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def seeded_variables(module, *args, seed: int = 0, **kwargs):
    """``{"params": ...}`` for ``module`` filled from ``seed`` (numpy leaves),
    and ``"batch_stats"`` (running means near 0, variances in [1, 1.5)) from
    ``seed + 1`` where the module has batch norms."""
    shapes = init_shapes(module, *args, **kwargs)
    variables = {"params": fill_params(shapes["params"], seed)}
    if "batch_stats" in shapes:
        variables["batch_stats"] = fill_params(shapes["batch_stats"], seed + 1)
    return variables


def port(a, dtype=torch.float32) -> torch.Tensor:
    """A numpy array as a CPU tensor for the port."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def as_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def no_tf32() -> None:
    """Full-f32 matmuls and convolutions, as the references compute."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs several workers on few cores: one intra-op thread per
    worker keeps the port's tests from thrashing each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_train_steps(flax_mod, cfg: dict, variables, images, labels, accum: int, place=None):
    """The JAX trainer's ``make_train_step`` over ``len(images)`` steps from
    ``variables`` (params, and batch_stats as ``state.extra``), with key i at
    step i; ``place(state)``, where given, places the first state (as the
    step's outputs lie on a mesh, so that later steps reuse the first
    compile). Returns (params, extra, per-step metrics) as numpy / floats."""
    import jax.numpy as jnp

    from multimodal_organ_segmentation_tpu.train import trainer as jtrainer
    from multimodal_organ_segmentation_tpu.train.losses import get_loss, with_deep_supervision
    from multimodal_organ_segmentation_tpu.train.optim import make_optimizer
    from multimodal_organ_segmentation_tpu.utils.config import ConfigNode

    node = ConfigNode(cfg)
    tx = make_optimizer(node)
    to_jnp = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    params = to_jnp(variables["params"])
    extra = {k: to_jnp(v) for k, v in variables.items() if k != "params"}
    state = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                opt_state=jax.jit(tx.init)(params), extra=extra,
                                ema_params=None)
    state = place(state) if place is not None else state
    step = jtrainer.make_train_step(flax_mod, tx, with_deep_supervision(get_loss(node)), accum)
    metrics = []
    for i in range(len(images)):
        state, m = step(state, jnp.asarray(images[i]), jnp.asarray(labels[i]), jax.random.key(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return jax.device_get(state.params), jax.device_get(state.extra), metrics


def torch_train_setup(name: str, cfg: dict, variables, accum: int, skip_nonfinite=False):
    """The port's model (``build_model(..., train=True)`` on the CPU) with
    ``variables`` carried across, AdamW state and ``make_train_step``."""
    from multimodal_organ_segmentation_tpu_torch.models import convert
    from multimodal_organ_segmentation_tpu_torch.models.build import build_model
    from multimodal_organ_segmentation_tpu_torch.train.losses import get_loss, with_deep_supervision
    from multimodal_organ_segmentation_tpu_torch.train.optim import make_optimizer
    from multimodal_organ_segmentation_tpu_torch.train.trainer import TrainState, make_train_step
    from multimodal_organ_segmentation_tpu_torch.utils.config import ConfigNode

    no_tf32()
    node = ConfigNode(cfg)
    model = build_model(node, device="cpu", train=True)
    model.load_state_dict(convert.params_from_jax(name, variables["params"],
                                                  variables.get("batch_stats")))
    optimizer = make_optimizer(node, model.parameters())
    state = TrainState(step=0, model=model, optimizer=optimizer)
    step = make_train_step(model, optimizer, with_deep_supervision(get_loss(node)), accum,
                           skip_nonfinite=skip_nonfinite)
    return state, step


def torch_train_steps(name: str, cfg: dict, variables, images, labels, accum: int):
    """``torch_train_setup`` stepped over ``images`` / ``labels``; returns
    (state, per-step metrics as floats)."""
    state, step = torch_train_setup(name, cfg, variables, accum)
    metrics = []
    for i in range(len(images)):
        state, m = step(state, torch.from_numpy(images[i]), torch.from_numpy(labels[i]).long())
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics
